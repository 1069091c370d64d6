"""Synthesis utilities: vocoder loading, result rendering, mel plots (JAX
counterpart: speakingstyle_tpu/synthesis.py).

Reference: utils/model.py:62-115 (get_vocoder / vocoder_infer) and
utils/tools.py:118-282 (expand / synth_samples / plot_mel). The rendered
artifacts match the reference's: wav files scaled by max_wav_value, and
mel plots with pitch and energy overlays in de-normalised units.
matplotlib is imported only when a plot is asked for.
"""

import json
import os
from typing import List, Optional

import numpy as np
import torch
from torch import nn

from speakingstyle_torch.configs.config import Config
from speakingstyle_torch.models.hifigan import DEFAULT_HIFIGAN_CONFIG, generator_from_config


def _load_params(module: nn.Module, params) -> nn.Module:
    from speakingstyle_torch.compat.from_jax import load_flax_variables

    return load_flax_variables(module, {"params": params})


def _read_msgpack_params(path: str):
    """The generator params of a Flax ``*.msgpack`` file; a full
    VocoderState file (generator, discriminators and optimizer state) is
    refused, naming the generator-only sidecar saved next to it."""
    from speakingstyle_torch.compat.flax_msgpack import msgpack_restore

    with open(path, "rb") as f:
        tree = msgpack_restore(f.read())
    if isinstance(tree, dict) and "gen_params" in tree:
        raise ValueError(
            f"{path!r} is a full VocoderState checkpoint (generator + "
            "discriminators + optimizer state). Pass the generator-only sidecar "
            "saved next to it (*.generator.msgpack), or extract state['gen_params'] "
            "yourself."
        )
    return tree


def vocoder_config(config_path: Optional[str] = None) -> dict:
    """The HiFi-GAN generator's hyperparameters: the LJSpeech V1 defaults,
    updated from a config.json where one is given."""
    hcfg = dict(DEFAULT_HIFIGAN_CONFIG)
    if config_path:
        with open(config_path) as f:
            hcfg.update(json.load(f))
    return hcfg


def get_vocoder(cfg: Config, ckpt_path: Optional[str] = None, seed: int = 0,
                config_path: Optional[str] = None) -> nn.Module:
    """The configured vocoder generator on the host, weights loaded
    (reference: utils/model.py:62-94).

    ``ckpt_path`` may be a PyTorch ``generator_*.pth.tar`` (weight norm
    folded, then converted by compat/torch_convert.py) or a Flax
    ``*.msgpack`` params file (the JAX package's generator-only sidecar,
    or ``convert --kind hifigan``'s output). Without a checkpoint the
    weights are drawn from ``seed`` (tests, Griffin-Lim comparisons).
    ``config_path``: a HiFi-GAN config.json for another topology (V2, V3)."""
    from speakingstyle_torch.models.factory import init_weights

    name = cfg.model.vocoder.model
    n_mels = cfg.preprocess.preprocessing.mel.n_mel_channels
    if name in ("MelGAN", "melgan"):
        return _get_melgan(cfg, ckpt_path, seed)
    if name not in ("HiFi-GAN", "hifigan"):
        raise NotImplementedError(
            f"vocoder {name!r}: HiFi-GAN and MelGAN are supported; "
            "use synthesize --griffin_lim for a vocoder-free fallback"
        )
    gen = generator_from_config(vocoder_config(config_path), n_mels)
    if ckpt_path and ckpt_path.endswith(".msgpack"):
        return _load_params(gen, _read_msgpack_params(ckpt_path))
    if ckpt_path:
        from speakingstyle_torch.compat.torch_convert import (
            convert_hifigan, fold_weight_norm, load_torch_state_dict,
        )

        sd = load_torch_state_dict(ckpt_path, key="generator")
        return _load_params(gen, convert_hifigan(fold_weight_norm(sd)))
    return init_weights(gen, seed)


def _get_melgan(cfg: Config, ckpt_path: Optional[str], seed: int = 0) -> nn.Module:
    """MelGAN generator (reference: utils/model.py:64-74, which pulls
    descriptinc/melgan-neurips from torch.hub at run time). ``ckpt_path``
    is a locally saved hub state-dict file (nothing is fetched) or a
    ``*.msgpack`` params file; without one the weights come from ``seed``."""
    from speakingstyle_torch.models.factory import init_weights
    from speakingstyle_torch.models.melgan import MelGANGenerator

    gen = MelGANGenerator(n_mels=cfg.preprocess.preprocessing.mel.n_mel_channels)
    if ckpt_path and ckpt_path.endswith(".msgpack"):
        return _load_params(gen, _read_msgpack_params(ckpt_path))
    if ckpt_path:
        from speakingstyle_torch.compat.torch_convert import convert_melgan

        obj = torch.load(ckpt_path, map_location="cpu", weights_only=True)
        # hub checkpoints are either the raw generator state dict or a
        # wrapper with it under a conventional key
        for key in ("model_g", "generator", "netG", "state_dict"):
            if isinstance(obj, dict) and key in obj:
                obj = obj[key]
        sd = {k: v.detach().cpu().numpy() for k, v in obj.items()}
        return _load_params(gen, convert_melgan(sd))
    return init_weights(gen, seed)


def expand(values: np.ndarray, durations: np.ndarray) -> np.ndarray:
    """Phoneme-level series -> frame level, each value repeated
    duration[i] times (reference: utils/tools.py:118-125)."""
    return np.repeat(np.asarray(values), np.asarray(durations, np.int64))


def _frame_level_overlay(batch_arr, lens, durations, level: str):
    """The [: len] slice, phoneme-level series expanded to frames."""
    if level == "phoneme_level":
        return expand(batch_arr, durations)
    return np.asarray(batch_arr)[: int(lens)]


def load_denorm_stats(cfg: Config) -> List[float]:
    """stats.json -> [p_min, p_max, p_mean, p_std, e_min, e_max]
    (reference: utils/tools.py:147-151)."""
    path = os.path.join(cfg.preprocess.path.preprocessed_path, "stats.json")
    if os.path.exists(path):
        with open(path) as f:
            stats = json.load(f)
        return list(stats["pitch"]) + list(stats["energy"][:2])
    return [-3.0, 12.0, 0.0, 1.0, -2.0, 10.0]


def plot_mel(data, stats, titles=None):
    """Stacked mel panels with F0 (left axis) and energy (right axis)
    overlays in de-normalised units (reference: utils/tools.py:233-282)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(len(data), 1, squeeze=False)
    titles = titles or [None] * len(data)
    p_min, p_max, p_mean, p_std, e_min, e_max = stats
    p_min, p_max = p_min * p_std + p_mean, p_max * p_std + p_mean

    for i, (mel, pitch, energy) in enumerate(data):
        ax = axes[i][0]
        pitch = np.asarray(pitch) * p_std + p_mean
        ax.imshow(mel, origin="lower")
        ax.set_aspect(2.5, adjustable="box")
        ax.set_ylim(0, mel.shape[0])
        ax.set_title(titles[i], fontsize="medium")
        ax.tick_params(labelsize="x-small", left=False, labelleft=False)
        ax.set_anchor("W")

        ax1 = fig.add_axes(ax.get_position(), anchor="W")
        ax1.set_facecolor("None")
        ax1.plot(pitch, color="tomato")
        ax1.set_xlim(0, mel.shape[1])
        ax1.set_ylim(0, p_max)
        ax1.set_ylabel("F0", color="tomato")
        ax1.tick_params(labelsize="x-small", colors="tomato",
                        bottom=False, labelbottom=False)

        ax2 = fig.add_axes(ax.get_position(), anchor="W")
        ax2.set_facecolor("None")
        ax2.plot(np.asarray(energy), color="darkviolet")
        ax2.set_xlim(0, mel.shape[1])
        ax2.set_ylim(e_min, e_max)
        ax2.set_ylabel("Energy", color="darkviolet")
        ax2.yaxis.set_label_position("right")
        ax2.tick_params(labelsize="x-small", colors="darkviolet",
                        bottom=False, labelbottom=False, left=False,
                        labelleft=False, right=True, labelright=True)
    return fig


def _griffin_lim_wav(cfg: Config, mel: np.ndarray, device=None) -> np.ndarray:
    """[T, n_mels] normalised log-mel -> int16 wav by Griffin-Lim over the
    mel filterbank's pseudo-inverse, its iterations on ``device`` (default
    the CPU), its initial phase drawn from a CPU generator seeded 0."""
    from speakingstyle_torch.audio.mel import mel_filterbank
    from speakingstyle_torch.audio.tools import griffin_lim

    pp = cfg.preprocess.preprocessing
    fb = mel_filterbank(pp.audio.sampling_rate, pp.stft.filter_length,
                        pp.mel.n_mel_channels, pp.mel.mel_fmin, pp.mel.mel_fmax)
    mag = np.maximum(np.linalg.pinv(fb) @ np.exp(np.asarray(mel)).T, 1e-8)
    mag = torch.from_numpy(mag[None].astype(np.float32)).to(device or "cpu")
    wav = griffin_lim(mag, pp.stft.filter_length, pp.stft.hop_length, pp.stft.win_length,
                      generator=torch.Generator().manual_seed(0))[0].cpu().numpy()
    return (np.clip(wav, -1, 1) * (pp.audio.max_wav_value - 1)).astype(np.int16)


def render_result(result, cfg: Config, path: str, plot: bool = False, device=None) -> str:
    """Write one ``SynthesisResult`` (serving/engine.py) to disk:
    ``<path>/<id>.wav`` (and ``<id>.png`` with ``plot``). Returns the wav
    path.

    A result of an engine with a vocoder arrives with ``result.wav``
    rendered (int16, trimmed); one without (``--griffin_lim``) arrives
    with ``wav=None`` and is inverted here by Griffin-Lim, on ``device``
    (the engine's; default the CPU). A prediction of 0 or 1 frames is
    below Griffin-Lim's minimum (it reflect-pads one hop) and is written as
    an empty, valid wav."""
    os.makedirs(path, exist_ok=True)
    pp = cfg.preprocess.preprocessing
    wav = result.wav
    if wav is None:
        wav = (np.zeros(0, np.int16) if result.mel_len < 2 else
               _griffin_lim_wav(cfg, result.mel, device))

    if plot and result.mel_len > 0:
        pitch = _frame_level_overlay(
            result.pitch_prediction, result.mel_len, result.durations, pp.pitch.feature)
        energy = _frame_level_overlay(
            result.energy_prediction, result.mel_len, result.durations, pp.energy.feature)
        fig = plot_mel([(result.mel.T, pitch, energy)], load_denorm_stats(cfg),
                       ["Synthetized Spectrogram"])
        fig.savefig(os.path.join(path, f"{result.id}.png"))
        import matplotlib.pyplot as plt

        plt.close(fig)

    import scipy.io.wavfile

    out = os.path.join(path, f"{result.id}.wav")
    scipy.io.wavfile.write(out, pp.audio.sampling_rate, wav)
    return out


def _vocode_one(cfg: Config, vocoder, mel: np.ndarray, device=None) -> np.ndarray:
    """[T, n_mels] normalised log-mel -> int16 wav: the vocoder (a
    HiFi-GAN or MelGAN generator) where given, else Griffin-Lim."""
    from speakingstyle_torch.models.hifigan import vocoder_infer

    if vocoder is None:
        return (np.zeros(0, np.int16) if mel.shape[0] < 2 else
                _griffin_lim_wav(cfg, mel, device))
    p = next(vocoder.parameters())
    mels = torch.from_numpy(np.ascontiguousarray(mel[None], np.float32)).to(p.device)
    return vocoder_infer(vocoder, mels, [mel.shape[0]],
                         cfg.preprocess.preprocessing.audio.max_wav_value)[0]


def synth_one_sample(batch, output, vocoder, cfg: Config, plot: bool = True, device=None):
    """The batch's first item: (figure or None, wav of the ground-truth
    mel, wav of the predicted mel, basename), for the training loop's
    validation sample (reference: utils/tools.py:128-180). ``output`` is
    the teacher-forced model's. The figure (ground truth below the
    prediction, with the pitch and energy targets) is drawn only with
    ``plot`` and where matplotlib imports."""
    pp = cfg.preprocess.preprocessing
    mel_len = int(output["mel_lens"][0])
    src_len = int(batch.src_lens[0])
    durations = np.asarray(batch.durations)[0, :src_len]
    mel_target = np.asarray(batch.mels)[0, :mel_len]
    mel_pred = output["mel_postnet"][0, :mel_len].float().cpu().numpy()
    fig = None
    if plot:
        try:
            import matplotlib  # noqa: F401
        except ImportError:
            pass
        else:
            series = {}
            for key, level in (("pitches", pp.pitch.feature), ("energies", pp.energy.feature)):
                a = np.asarray(getattr(batch, key))[0]
                series[key] = _frame_level_overlay(
                    a[:src_len] if level == "phoneme_level" else a, mel_len, durations, level)
            fig = plot_mel([(mel_pred.T, series["pitches"], series["energies"]),
                            (mel_target.T, series["pitches"], series["energies"])],
                           load_denorm_stats(cfg),
                           ["Synthetized Spectrogram", "Ground-Truth Spectrogram"])
    wav_recon = _vocode_one(cfg, vocoder, mel_target, device)
    wav_pred = _vocode_one(cfg, vocoder, mel_pred, device)
    return fig, wav_recon, wav_pred, batch.ids[0]
