"""The synthesis engine: padded text batches -> mel -> int16 wav (JAX
counterpart: speakingstyle_tpu/serving/engine.py).

``SynthesisEngine.run`` is the port's main path, the counterpart of the
JAX engine's ``run``:

1. the batch is covered by its smallest ``(batch, L_src, T_mel)`` lattice
   point (serving/lattice.py) and padded to it;
2. requests that carry a reference mel are padded into one
   ``(batch, ref_len)`` style bucket and run through the reference encoder
   once, giving FiLM (gamma, beta); requests with precomputed vectors skip it;
3. the acoustic model runs free at ``max_mel_len = bucket.t_mel``;
4. the vocoder turns the postnet mel into audio, cut per request to
   ``mel_len * hop`` int16 samples.

``load_engine`` builds one over a checkpoint and a vocoder (the
``synthesize`` command's). PyTorch runs eagerly, so there is no
per-bucket compile. The three stages
run under ``record_function`` ranges (``synthesis.style``, ``.acoustic``,
``.vocoder``) that a ``torch.profiler`` trace attributes device time to;
they cost a few microseconds when no profiler is on. Not ported yet
(see ROADMAP): the StyleService cache, the buffer pools, streaming,
tracing and the quality gates.
"""

from dataclasses import dataclass
from typing import List, Optional, Union

import numpy as np
import torch
from torch.profiler import record_function

from speakingstyle_torch.configs.config import Config
from speakingstyle_torch.device import resolve_device
from speakingstyle_torch.models.factory import build_model, init_weights
from speakingstyle_torch.models.hifigan import to_int16
from speakingstyle_torch.ops.masking import length_to_mask
from speakingstyle_torch.serving.lattice import Bucket, BucketLattice, StyleLattice

Control = Union[float, np.ndarray]  # scalar, or per-phoneme [src_len] array


@dataclass(frozen=True)
class StyleVectors:
    """One encoded speaking style: the FiLM pair, each [d_model] float32."""

    gamma: np.ndarray
    beta: np.ndarray


@dataclass
class SynthesisRequest:
    """One utterance with G2P done: phoneme ids plus either a reference mel
    or precomputed style vectors."""

    id: str
    sequence: np.ndarray                  # [src_len] int32 phoneme ids
    ref_mel: Optional[np.ndarray] = None  # [ref_len, n_mels] float32
    style: Optional[StyleVectors] = None
    speaker: int = 0
    raw_text: str = ""
    p_control: Control = 1.0
    e_control: Control = 1.0
    d_control: Control = 1.0


@dataclass
class SynthesisResult:
    """Per-request slice of one padded dispatch."""

    id: str
    raw_text: str
    mel: np.ndarray               # [mel_len, n_mels] float32 (postnet mel)
    mel_len: int
    wav: Optional[np.ndarray]     # [mel_len * hop] int16, None without vocoder
    durations: np.ndarray         # [src_len] int32 predicted frame counts
    pitch_prediction: np.ndarray
    energy_prediction: np.ndarray
    src_len: int
    bucket: Bucket
    batch_rows: int               # real rows in the dispatch that served this
    wav_finite: bool = True       # the float wav was finite before the int16 cast


def _fill_control(rows: List[Control], out: np.ndarray) -> np.ndarray:
    """Per-request controls -> the padded [B, L] array ``out`` (pre-filled
    with the neutral 1.0)."""
    for i, c in enumerate(rows):
        if np.isscalar(c):
            out[i] = float(c)
        else:
            arr = np.asarray(c, np.float32)
            out[i, : arr.shape[0]] = arr
    return out


class SynthesisEngine:
    """Owns the acoustic model, the vocoder and the lattice, on one device.

    ``model`` / ``vocoder`` are the port's modules (weights loaded or
    initialised by the caller); without ``model`` the engine builds one from
    ``cfg`` with weights drawn from ``seed``. ``device`` defaults to
    ``cuda``; only an explicit ``"cpu"`` runs on the CPU.
    """

    def __init__(self, cfg: Config, model=None, vocoder=None,
                 lattice: Optional[BucketLattice] = None, device=None, seed: int = 0):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.lattice = lattice or BucketLattice.from_config(cfg.serve)
        self.style_lattice = StyleLattice.from_config(cfg.serve)
        if model is None:
            n_position = max(self.lattice.max_mel, self.lattice.max_src,
                             self.style_lattice.max_ref, cfg.model.max_seq_len) + 1
            model = init_weights(build_model(cfg, n_position=n_position), seed)
        self.model = model.to(self.device).eval()
        self.vocoder = None if vocoder is None else vocoder.to(self.device).eval()
        pp = cfg.preprocess.preprocessing
        self.n_mels = pp.mel.n_mel_channels
        self.max_wav_value = pp.audio.max_wav_value
        self._use_style = cfg.model.use_reference_encoder
        self._film_dim = cfg.model.reference_encoder.encoder_hidden
        self._ctl_axis = {
            "p": "src" if pp.pitch.feature == "phoneme_level" else "mel",
            "e": "src" if pp.energy.feature == "phoneme_level" else "mel",
        }
        self.dispatches = 0
        self.style_encodes = 0  # reference-encoder passes (encode_styles calls)

    def required_mel(self, req: SynthesisRequest) -> int:
        """The T_mel a request needs: its phoneme count times
        ``frames_per_phoneme`` (longer predictions are truncated)."""
        return len(req.sequence) * self.cfg.serve.frames_per_phoneme

    def cover(self, requests: List[SynthesisRequest]) -> Bucket:
        return self.lattice.cover(
            len(requests),
            max(len(r.sequence) for r in requests),
            max(self.required_mel(r) for r in requests),
        )

    def admit(self, req: SynthesisRequest) -> None:
        """Raise now (RequestTooLarge / ValueError) for a request no bucket
        can serve."""
        if req.sequence.ndim != 1:
            raise ValueError(f"request {req.id!r}: sequence must be [L], got {req.sequence.shape}")
        if self._use_style and req.style is None:
            if req.ref_mel is None or req.ref_mel.ndim != 2 \
                    or req.ref_mel.shape[1] != self.n_mels:
                raise ValueError(
                    f"request {req.id!r}: pass style vectors or a "
                    f"[T, {self.n_mels}] ref_mel"
                )
            self.style_lattice.cover(1, req.ref_mel.shape[0])
        self.lattice.cover(1, len(req.sequence), self.required_mel(req))

    @torch.inference_mode()
    def encode_styles(self, mels: List[np.ndarray]) -> torch.Tensor:
        """Reference mels -> [n, 2, d_model] float32 FiLM (gamma, beta): one
        reference-encoder pass over the mels padded to their covering
        ``(batch, ref_len)`` style bucket. The mean-pool divides by the
        padded length, so the vectors depend on that bucket, as in the JAX
        package's StyleService."""
        b, r = self.style_lattice.cover(len(mels), max(m.shape[0] for m in mels))
        padded = np.zeros((b, r, self.n_mels), np.float32)
        lens = np.zeros((b,), np.int64)
        for i, m in enumerate(mels):
            padded[i, : m.shape[0]] = m
            lens[i] = m.shape[0]
        lens_t = torch.from_numpy(lens).to(self.device)
        gammas, betas = self.model.reference_encoder(
            torch.from_numpy(padded).to(self.device), length_to_mask(lens_t, r)
        )
        self.style_encodes += 1
        return torch.cat([gammas, betas], dim=1)[: len(mels)].float()

    @torch.inference_mode()
    def run(self, requests: List[SynthesisRequest]) -> List[SynthesisResult]:
        """Pad ``requests`` into their smallest covering bucket, synthesize,
        and slice per-request results."""
        if not requests:
            return []
        for r in requests:
            self.admit(r)
        bucket = self.cover(requests)
        b, l, t = bucket.b, bucket.l_src, bucket.t_mel
        n = len(requests)
        dev = self.device

        texts = np.zeros((b, l), np.int64)
        src_lens = np.zeros((b,), np.int64)
        speakers = np.zeros((b,), np.int64)
        for i, r in enumerate(requests):
            texts[i, : len(r.sequence)] = r.sequence
            src_lens[i] = len(r.sequence)
            speakers[i] = r.speaker
        ctl_len = {"src": l, "mel": t}
        controls = {
            k: torch.from_numpy(_fill_control(
                [getattr(r, f"{k}_control") for r in requests],
                np.ones((b, ctl_len[self._ctl_axis.get(k, "src")]), np.float32),
            )).to(dev)
            for k in ("p", "e", "d")
        }
        gammas = betas = None
        if self._use_style:
            film = torch.zeros((b, 2, self._film_dim), dtype=torch.float32, device=dev)
            fresh = [i for i, r in enumerate(requests) if r.style is None]
            for i, r in enumerate(requests):
                if r.style is not None:
                    film[i, 0] = torch.from_numpy(np.asarray(r.style.gamma, np.float32))
                    film[i, 1] = torch.from_numpy(np.asarray(r.style.beta, np.float32))
            if fresh:
                with record_function("synthesis.style"):
                    film[fresh] = self.encode_styles([requests[i].ref_mel for i in fresh])
            gammas, betas = film[:, :1], film[:, 1:]

        with record_function("synthesis.acoustic"):
            out = self.model(
                torch.from_numpy(speakers).to(dev), torch.from_numpy(texts).to(dev),
                torch.from_numpy(src_lens).to(dev), max_mel_len=t,
                p_control=controls["p"], e_control=controls["e"], d_control=controls["d"],
                gammas=gammas, betas=betas,
            )
        mel = out["mel_postnet"]
        wavs, hop, finite = None, 1, np.ones((b,), bool)
        if self.vocoder is not None:
            hop = self.vocoder.hop_factor
            with record_function("synthesis.vocoder"):
                wav_f = self.vocoder(mel)
            finite = torch.isfinite(wav_f).all(dim=1).cpu().numpy()
            wavs = to_int16(torch.nan_to_num(wav_f, posinf=1.0, neginf=-1.0),
                            self.max_wav_value)
        self.dispatches += 1

        host = {k: out[k].cpu().numpy() for k in
                ("mel_lens", "durations", "pitch_prediction", "energy_prediction")}
        mel_host = mel.cpu().numpy()
        results = []
        for i, r in enumerate(requests):
            mel_len = int(host["mel_lens"][i])
            src_len = int(src_lens[i])
            p_len = src_len if self._ctl_axis["p"] == "src" else mel_len
            e_len = src_len if self._ctl_axis["e"] == "src" else mel_len
            results.append(SynthesisResult(
                id=r.id, raw_text=r.raw_text,
                mel=mel_host[i, :mel_len], mel_len=mel_len,
                wav=None if wavs is None else wavs[i, : mel_len * hop],
                durations=host["durations"][i, :src_len],
                pitch_prediction=host["pitch_prediction"][i, :p_len],
                energy_prediction=host["energy_prediction"][i, :e_len],
                src_len=src_len, bucket=bucket, batch_rows=n,
                wav_finite=bool(finite[i]),
            ))
        return results


def load_engine(cfg: Config, restore_step: int, vocoder_ckpt: Optional[str] = None,
                griffin_lim: bool = False, device=None, vocoder_seed: int = 1):
    """An engine over trained weights (JAX counterpart: ``load_engine`` of
    speakingstyle_tpu/cli/serve.py): the model built at the lattices'
    n_position, its weights restored from ``cfg.train.path.ckpt_path`` at
    ``restore_step`` (<= 0: the latest) after the manifest check, with
    ``train.ignore_layers`` keeping their values drawn from
    ``train.seed``; the vocoder from ``vocoder_ckpt`` (a ``.pth.tar`` or a
    Flax ``.msgpack``; weights from ``vocoder_seed`` without one), or none
    under ``griffin_lim``. Returns (engine, {"step", "weights_digest"})."""
    from speakingstyle_torch.synthesis import get_vocoder
    from speakingstyle_torch.training.checkpoint import CheckpointManager

    lattice = BucketLattice.from_config(cfg.serve)
    n_position = max(lattice.max_mel, lattice.max_src,
                     StyleLattice.from_config(cfg.serve).max_ref, cfg.model.max_seq_len) + 1
    model = init_weights(build_model(cfg, n_position=n_position), cfg.train.seed)
    info = CheckpointManager(cfg.train.path.ckpt_path).restore_weights(
        model, step=restore_step if restore_step > 0 else None,
        ignore_layers=cfg.train.ignore_layers)
    vocoder = None if griffin_lim else get_vocoder(cfg, vocoder_ckpt, seed=vocoder_seed)
    engine = SynthesisEngine(cfg, model=model, vocoder=vocoder, lattice=lattice, device=device)
    return engine, info
