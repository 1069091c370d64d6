"""PyTorch reference checkpoints -> the Flax-named parameter trees that
``compat/from_jax.load_flax_variables`` fills the port's modules from (a
copy of speakingstyle_tpu/compat/torch_convert.py).

Loads the reference framework's checkpoints: the HiFi-GAN generator
(``generator_*.pth.tar`` with weight-normed convs, reference:
hifigan/models.py:112-174), the MelGAN generator (a saved torch.hub
state dict) and, through ``convert_fastspeech2``, the acoustic-model
checkpoints (reference: train.py:155-165 format, ``{"model": state_dict,
"optimizer": ...}``).

Every function but ``load_torch_state_dict`` takes a plain
``dict[str, np.ndarray]`` state dict and returns nested dicts of numpy
arrays.
"""

from typing import Dict

import numpy as np


def load_torch_state_dict(path: str, key: str = None) -> Dict[str, np.ndarray]:
    """Unpickle a torch checkpoint to numpy on the host (tensors only:
    ``weights_only``), optionally the sub-dict under ``key``."""
    import torch

    obj = torch.load(path, map_location="cpu", weights_only=True)
    if key is not None:
        obj = obj[key]
    return {k: v.detach().cpu().numpy() for k, v in obj.items()}


def fold_weight_norm(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Collapse every (weight_g, weight_v) pair into a plain weight.

    torch weight_norm default dim=0: ||v|| is computed over all dims except
    the first (reference inference calls remove_weight_norm,
    hifigan/models.py:167-174 — this is its numpy equivalent).
    """
    out = {}
    for k, v in sd.items():
        if k.endswith("weight_g"):
            base = k[: -len("weight_g")]
            vv = sd[base + "weight_v"]
            axes = tuple(range(1, vv.ndim))
            norm = np.sqrt((vv**2).sum(axis=axes, keepdims=True))
            out[base + "weight"] = (v * vv / np.maximum(norm, 1e-12)).astype(vv.dtype)
        elif k.endswith("weight_v"):
            continue
        else:
            out[k] = v
    return out


def _conv1d(sd, prefix):
    """torch Conv1d [out, in, k] -> flax {kernel [k, in, out], bias}."""
    entry = {"kernel": sd[prefix + ".weight"].transpose(2, 1, 0)}
    if prefix + ".bias" in sd:
        entry["bias"] = sd[prefix + ".bias"]
    return entry


def _dense(sd, prefix):
    """torch Linear [out, in] -> flax {kernel [in, out], bias}."""
    entry = {"kernel": sd[prefix + ".weight"].T}
    if prefix + ".bias" in sd:
        entry["bias"] = sd[prefix + ".bias"]
    return entry


def _ln(sd, prefix):
    """torch LayerNorm/BatchNorm affine -> flax {scale, bias}."""
    return {"scale": sd[prefix + ".weight"], "bias": sd[prefix + ".bias"]}


def _embed(sd, prefix):
    return {"embedding": sd[prefix + ".weight"]}


def _film(sd, prefix):
    return {"s_gamma": sd[prefix + ".s_gamma"], "s_beta": sd[prefix + ".s_beta"]}


def _fft_block(sd, prefix):
    """FFTBlock (reference: transformer/Layers.py:11-37) -> models/layers.py
    FFTBlock params. The optional per-block FiLM maps only when present."""
    block = {
        "slf_attn": {
            "w_qs": _dense(sd, prefix + ".slf_attn.w_qs"),
            "w_ks": _dense(sd, prefix + ".slf_attn.w_ks"),
            "w_vs": _dense(sd, prefix + ".slf_attn.w_vs"),
            "fc": _dense(sd, prefix + ".slf_attn.fc"),
            "layer_norm": _ln(sd, prefix + ".slf_attn.layer_norm"),
        },
        "pos_ffn": {
            "w_1": _conv1d(sd, prefix + ".pos_ffn.w_1"),
            "w_2": _conv1d(sd, prefix + ".pos_ffn.w_2"),
            "layer_norm": _ln(sd, prefix + ".pos_ffn.layer_norm"),
        },
    }
    if prefix + ".film.s_gamma" in sd:
        block["film"] = _film(sd, prefix + ".film")
    return block


def _fft_stack(sd, prefix):
    """ModuleList of FFTBlocks -> FFTStack {layer_i: ...}."""
    stack = {}
    i = 0
    while f"{prefix}.{i}.slf_attn.w_qs.weight" in sd:
        stack[f"layer_{i}"] = _fft_block(sd, f"{prefix}.{i}")
        i += 1
    return stack


def _variance_predictor(sd, prefix, film: bool):
    """reference: model/modules.py:204-259. `film` selects whether the
    predictor's FiLM gates are live in our graph (duration predictor only —
    the torch ckpt carries unused film params for pitch/energy which our
    pitch/energy predictors never instantiate, model/modules.py:122-131)."""
    vp = {
        "conv1d_1": _conv1d(sd, prefix + ".conv_layer.conv1d_1.conv"),
        "layer_norm_1": _ln(sd, prefix + ".conv_layer.layer_norm_1"),
        "conv1d_2": _conv1d(sd, prefix + ".conv_layer.conv1d_2.conv"),
        "layer_norm_2": _ln(sd, prefix + ".conv_layer.layer_norm_2"),
        "linear_layer": _dense(sd, prefix + ".linear_layer"),
    }
    if film and prefix + ".film.s_gamma" in sd:
        # absent in vanilla ming024-style FastSpeech2 checkpoints
        vp["film"] = _film(sd, prefix + ".film")
    return vp


def convert_fastspeech2(sd: Dict[str, np.ndarray]) -> Dict:
    """Acoustic-model state_dict (``torch.load(...)["model"]``, reference:
    train.py:155-165) -> {"params", "batch_stats"} for models/fastspeech2.py.

    Non-trainable buffers that our graph bakes in as constants are skipped:
    ``*.position_enc`` (sinusoid PE recomputed at trace time) and
    ``variance_adaptor.{pitch,energy}_bins`` (compile-time constants from
    stats.json). PostNet BatchNorm running stats land in batch_stats.
    """
    # DataParallel checkpoints prefix every key with "module."
    sd = {k.removeprefix("module."): v for k, v in sd.items()}

    params: Dict = {
        "encoder": {
            "src_word_emb": _embed(sd, "encoder.src_word_emb"),
            "layer_stack": _fft_stack(sd, "encoder.layer_stack"),
        },
        "decoder": {
            "layer_stack": _fft_stack(sd, "decoder.layer_stack"),
        },
        "mel_linear": _dense(sd, "mel_linear"),
    }
    if "speaker_emb.weight" in sd:
        params["speaker_emb"] = _embed(sd, "speaker_emb")

    va = {
        "duration_predictor": _variance_predictor(
            sd, "variance_adaptor.duration_predictor", film=True
        ),
        "pitch_predictor": _variance_predictor(
            sd, "variance_adaptor.pitch_predictor", film=False
        ),
        "energy_predictor": _variance_predictor(
            sd, "variance_adaptor.energy_predictor", film=False
        ),
        "pitch_embedding": _embed(sd, "variance_adaptor.pitch_embedding"),
        "energy_embedding": _embed(sd, "variance_adaptor.energy_embedding"),
    }
    params["variance_adaptor"] = va

    if "reference_encoder.fftb_linear.linear.weight" in sd:
        re: Dict = {}
        i = 0
        while f"reference_encoder.layer_stack.{i}.0.conv.weight" in sd:
            re[f"conv_{i}"] = {
                "conv": _conv1d(sd, f"reference_encoder.layer_stack.{i}.0.conv")
            }
            re[f"ln_{i}"] = _ln(sd, f"reference_encoder.layer_stack.{i}.2")
            i += 1
        re["fftb_linear"] = {
            "linear": _dense(sd, "reference_encoder.fftb_linear.linear")
        }
        j = 0
        while f"reference_encoder.fftb_stack.{j}.slf_attn.w_qs.weight" in sd:
            re[f"fftb_{j}"] = _fft_block(sd, f"reference_encoder.fftb_stack.{j}")
            j += 1
        re["feature_wise_affine"] = {
            "linear": _dense(sd, "reference_encoder.feature_wise_affine.linear")
        }
        params["reference_encoder"] = re

    postnet: Dict = {}
    postnet_stats: Dict = {}
    i = 0
    while f"postnet.convolutions.{i}.0.conv.weight" in sd:
        postnet[f"conv_{i}"] = _conv1d(sd, f"postnet.convolutions.{i}.0.conv")
        postnet[f"bn_{i}"] = _ln(sd, f"postnet.convolutions.{i}.1")
        postnet_stats[f"bn_{i}"] = {
            "mean": sd[f"postnet.convolutions.{i}.1.running_mean"],
            "var": sd[f"postnet.convolutions.{i}.1.running_var"],
        }
        i += 1
    params["postnet"] = postnet

    return {"params": params, "batch_stats": {"postnet": postnet_stats}}


def convert_hifigan(sd: Dict[str, np.ndarray]) -> Dict:
    """Generator state_dict -> params tree for models/hifigan.py.

    Our TorchConvTranspose1d stores its kernel in torch's native
    [in, out, k] layout, so ups_* weights pass through untransposed.
    """
    sd = fold_weight_norm(sd)
    params: Dict = {}
    params["conv_pre"] = {"conv": _conv1d(sd, "conv_pre")}
    params["conv_post"] = {"conv": _conv1d(sd, "conv_post")}

    n_ups = len([k for k in sd if k.startswith("ups.") and k.endswith(".weight")])
    for i in range(n_ups):
        params[f"ups_{i}"] = {
            "kernel": sd[f"ups.{i}.weight"],
            "bias": sd[f"ups.{i}.bias"],
        }

    n_res = len(
        {k.split(".")[1] for k in sd if k.startswith("resblocks.")}
    )
    for n in range(n_res):
        block: Dict = {}
        # ResBlock1 stores dilated+plain conv pairs as convs1/convs2;
        # ResBlock2 (the public V3 config) stores a single "convs" list
        for branch in ("convs1", "convs2", "convs"):
            j = 0
            while f"resblocks.{n}.{branch}.{j}.weight" in sd:
                block[f"{branch}_{j}"] = {
                    "conv": _conv1d(sd, f"resblocks.{n}.{branch}.{j}")
                }
                j += 1
        params[f"resblocks_{n}"] = block
    return params


def convert_melgan(sd: Dict[str, np.ndarray]) -> Dict:
    """descript MelGAN generator state_dict -> params for models/melgan.py.

    The hub module is one big ``nn.Sequential`` named ``model`` (reference
    usage: utils/model.py:64-74; architecture: descriptinc/melgan-neurips
    mel2wav/modules.py), so keys are positional: ``model.<i>.weight`` for
    the plain convs / transposed convs and ``model.<i>.{block.2,block.4,
    shortcut}.weight`` inside ResnetBlocks. Conversion walks the indices in
    order and classifies by position: first plain conv = conv_pre, then
    per upsample stage one transposed conv + n residual blocks, final
    plain conv = conv_post. Weight norm is folded first.
    """
    sd = {k.removeprefix("mel2wav."): v for k, v in sd.items()}
    sd = fold_weight_norm(sd)

    idxs = sorted(
        {int(k.split(".")[1]) for k in sd if k.startswith("model.")}
    )
    plain = [i for i in idxs if f"model.{i}.weight" in sd]
    res = [i for i in idxs if f"model.{i}.block.2.weight" in sd]
    if len(plain) < 3:
        raise ValueError("not a MelGAN generator state_dict")

    def _reflect_conv(i):
        return {"conv": _conv1d(sd, f"model.{i}")}

    params: Dict = {"conv_pre": _reflect_conv(plain[0]),
                    "conv_post": _reflect_conv(plain[-1])}

    ups = plain[1:-1]  # transposed convs, in encounter order
    n_res_per_stage = len(res) // max(len(ups), 1)
    for s, i in enumerate(ups):
        # torch ConvTranspose1d weight [in, out, k] passes through
        # untransposed (TorchConvTranspose1d stores torch's native layout)
        params[f"ups_{s}"] = {
            "kernel": sd[f"model.{i}.weight"],
            "bias": sd[f"model.{i}.bias"],
        }
    for n, i in enumerate(res):
        s, j = divmod(n, n_res_per_stage)
        params[f"res_{s}_{j}"] = {
            "conv1": {"conv": _conv1d(sd, f"model.{i}.block.2")},
            "conv2": {"conv": _conv1d(sd, f"model.{i}.block.4")},
            "shortcut": {"conv": _conv1d(sd, f"model.{i}.shortcut")},
        }
    return params
