"""Typed, validated configuration for the PyTorch port.

A copy of the JAX package's schema (speakingstyle_tpu/configs/config.py)
for the parts this package runs: the whole ``preprocess.yaml`` and
``model.yaml`` schemas, and the serve knobs of ``train.yaml`` that the
synthesis engine reads. One YAML triple drives both packages; the model
knobs keep their values and meanings:

* ``conv_impl``: ``"xla"`` is ``torch.nn.functional.conv1d``, ``"unfold"``
  an im2col matmul, ``"pallas"`` the hand-written fused conv kernel
  (ops/fused_conv.py);
* ``attention_kernel``: ``"fused"`` is the hand-written attention kernel
  (ops/fused_attention.py), ``"einsum"`` plain tensor math.

Every key is checked at load time; an unknown key raises and names itself.
The training keys of ``train.yaml`` (optimizer, steps, loss, paths) belong
to the training path, which this package does not run yet: they are read
and ignored, so the JAX package's files load unchanged.
"""

from __future__ import annotations

import dataclasses
import json
import os
import typing
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import yaml

PRESET_DIR = os.path.join(os.path.dirname(__file__), "presets")


def _build(cls, data: Dict[str, Any], path: str = ""):
    """Recursively build a dataclass from a nested dict, rejecting unknown keys."""
    if data is None:
        data = {}
    hints = typing.get_type_hints(cls)
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(data) - names
    if unknown:
        raise ValueError(f"Unknown config keys at {path or cls.__name__}: {sorted(unknown)}")
    kwargs = {}
    for name in names:
        if name not in data:
            continue
        value = data[name]
        ftype = hints.get(name)
        if dataclasses.is_dataclass(ftype) and isinstance(value, dict):
            value = _build(ftype, value, f"{path}.{name}" if path else name)
        kwargs[name] = value
    return cls(**kwargs)


# ---------------------------------------------------------------------------
# preprocess.yaml
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class PathConfig:
    corpus_path: str = ""
    lexicon_path: str = ""
    raw_path: str = ""
    preprocessed_path: str = ""


@dataclass(frozen=True)
class TextConfig:
    text_cleaners: List[str] = field(default_factory=lambda: ["english_cleaners"])
    language: str = "en"


@dataclass(frozen=True)
class AudioConfig:
    sampling_rate: int = 22050
    max_wav_value: float = 32768.0


@dataclass(frozen=True)
class STFTConfig:
    filter_length: int = 1024
    hop_length: int = 256
    win_length: int = 1024


@dataclass(frozen=True)
class MelConfig:
    n_mel_channels: int = 80
    mel_fmin: float = 0.0
    mel_fmax: Optional[float] = 8000.0


@dataclass(frozen=True)
class VarianceFeatureConfig:
    feature: str = "phoneme_level"  # or "frame_level"
    normalization: bool = True

    def __post_init__(self):
        if self.feature not in ("phoneme_level", "frame_level"):
            raise ValueError(f"feature must be phoneme_level|frame_level, got {self.feature}")


@dataclass(frozen=True)
class PreprocessingConfig:
    val_size: int = 512
    text: TextConfig = field(default_factory=TextConfig)
    audio: AudioConfig = field(default_factory=AudioConfig)
    stft: STFTConfig = field(default_factory=STFTConfig)
    mel: MelConfig = field(default_factory=MelConfig)
    pitch: VarianceFeatureConfig = field(default_factory=VarianceFeatureConfig)
    energy: VarianceFeatureConfig = field(default_factory=VarianceFeatureConfig)


@dataclass(frozen=True)
class PreprocessConfig:
    dataset: str = "LJSpeech"
    path: PathConfig = field(default_factory=PathConfig)
    preprocessing: PreprocessingConfig = field(default_factory=PreprocessingConfig)


# ---------------------------------------------------------------------------
# model.yaml
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class TransformerConfig:
    encoder_layer: int = 4
    encoder_head: int = 2
    encoder_hidden: int = 256
    decoder_layer: int = 6
    decoder_head: int = 2
    decoder_hidden: int = 256
    conv_filter_size: int = 1024
    conv_kernel_size: Tuple[int, int] = (9, 1)
    encoder_dropout: float = 0.2
    decoder_dropout: float = 0.2


@dataclass(frozen=True)
class ReferenceEncoderConfig:
    encoder_layer: int = 4
    encoder_head: int = 8
    encoder_hidden: int = 256
    conv_layer: int = 3
    conv_filter_size: int = 1024
    conv_kernel_size: int = 3
    dropout: float = 0.1


@dataclass(frozen=True)
class VariancePredictorConfig:
    filter_size: int = 256
    kernel_size: int = 3
    dropout: float = 0.5


@dataclass(frozen=True)
class VarianceEmbeddingConfig:
    pitch_quantization: str = "linear"  # "linear" | "log"
    energy_quantization: str = "linear"
    n_bins: int = 256

    def __post_init__(self):
        for q in (self.pitch_quantization, self.energy_quantization):
            if q not in ("linear", "log"):
                raise ValueError(f"quantization must be linear|log, got {q}")


@dataclass(frozen=True)
class VocoderConfig:
    model: str = "HiFi-GAN"
    speaker: str = "LJSpeech"


@dataclass(frozen=True)
class ModelConfig:
    transformer: TransformerConfig = field(default_factory=TransformerConfig)
    reference_encoder: ReferenceEncoderConfig = field(default_factory=ReferenceEncoderConfig)
    variance_predictor: VariancePredictorConfig = field(default_factory=VariancePredictorConfig)
    variance_embedding: VarianceEmbeddingConfig = field(default_factory=VarianceEmbeddingConfig)
    multi_speaker: bool = False
    max_seq_len: int = 1000
    vocoder: VocoderConfig = field(default_factory=VocoderConfig)
    postnet_embedding_dim: int = 512
    postnet_kernel_size: int = 5
    postnet_layers: int = 5
    # activations/matmul dtype ("bfloat16" | "float32"); parameters stay
    # float32 and are cast at use, as the JAX package's modules do
    compute_dtype: str = "bfloat16"
    # "xla" = F.conv1d, "unfold" = im2col matmul, "pallas" = the fused
    # conv(+bias+ReLU(+LayerNorm)) kernel of ops/fused_conv.py
    conv_impl: str = "xla"
    # "float32" is the only value the attention kernel takes; "bfloat16"
    # runs only through the plain version on the CPU
    attention_softmax_dtype: str = "float32"
    use_reference_encoder: bool = True
    # "fused" = the attention kernel of ops/fused_attention.py,
    # "einsum" = plain tensor math
    attention_kernel: str = "fused"
    # "dense" only: the sequence-parallel ring is not ported yet
    attention_impl: str = "dense"
    # read for schema parity; dropout is the identity at inference
    dropout_impl: str = "hash"

    def __post_init__(self):
        if self.attention_impl not in ("dense", "ring"):
            raise ValueError(
                f"attention_impl must be dense|ring, got {self.attention_impl}"
            )
        if self.dropout_impl not in ("bernoulli", "bits16", "hash"):
            raise ValueError(
                f"dropout_impl must be bernoulli|bits16|hash, "
                f"got {self.dropout_impl}"
            )
        if self.conv_impl not in ("xla", "unfold", "pallas"):
            raise ValueError(
                f"conv_impl must be xla|unfold|pallas, got {self.conv_impl}"
            )
        if self.attention_kernel not in ("einsum", "fused"):
            raise ValueError(
                f"attention_kernel must be einsum|fused, got {self.attention_kernel}"
            )
        if self.attention_softmax_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                "attention_softmax_dtype must be float32|bfloat16, "
                f"got {self.attention_softmax_dtype}"
            )
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"compute_dtype must be float32|bfloat16, got {self.compute_dtype}"
            )


# ---------------------------------------------------------------------------
# train.yaml: the serve block
# ---------------------------------------------------------------------------

def _check_ascending(name: str, vals: List[int]) -> None:
    if not vals:
        raise ValueError(f"{name} must be non-empty")
    if any(v <= 0 for v in vals):
        raise ValueError(f"{name} must be positive, got {vals}")
    if sorted(vals) != list(vals) or len(set(vals)) != len(vals):
        raise ValueError(f"{name} must be strictly ascending, got {vals}")


@dataclass(frozen=True)
class StyleConfig:
    # padded reference-mel lengths the style encoder runs at
    ref_buckets: List[int] = field(default_factory=lambda: [256, 512, 1000])

    def __post_init__(self):
        _check_ascending("serve.style.ref_buckets", self.ref_buckets)


@dataclass(frozen=True)
class ServeConfig:
    """The synthesis engine's shape lattice (serving/lattice.py): every
    dispatch runs at a ``(batch, L_src, T_mel)`` drawn from the cross
    product of these buckets; ``T_mel`` is the free-run output buffer."""

    batch_buckets: List[int] = field(default_factory=lambda: [1, 2, 4, 8])
    src_buckets: List[int] = field(default_factory=lambda: [32, 64, 128, 256])
    mel_buckets: List[int] = field(default_factory=lambda: [256, 512, 1000])
    # a request with n phonemes needs T_mel >= n * frames_per_phoneme
    frames_per_phoneme: int = 12
    style: StyleConfig = field(default_factory=StyleConfig)

    def __post_init__(self):
        for name in ("batch_buckets", "src_buckets", "mel_buckets"):
            _check_ascending(f"serve.{name}", getattr(self, name))
        if self.frames_per_phoneme <= 0:
            raise ValueError(
                f"serve.frames_per_phoneme must be > 0, got {self.frames_per_phoneme}"
            )


@dataclass(frozen=True)
class Config:
    """The (preprocess, model) pair plus the serve block."""

    preprocess: PreprocessConfig = field(default_factory=PreprocessConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    serve: ServeConfig = field(default_factory=ServeConfig)


def load_yaml(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return yaml.safe_load(f) or {}


def load_config(
    preprocess: Optional[str] = None,
    model: Optional[str] = None,
    train: Optional[str] = None,
    preset: Optional[str] = None,
) -> Config:
    """Load a Config from explicit YAML paths and/or a named preset."""
    if preset is not None:
        base = os.path.join(PRESET_DIR, preset)
        if not os.path.isdir(base):
            raise ValueError(
                f"Unknown preset {preset!r}; available: {sorted(os.listdir(PRESET_DIR))}"
            )
        preprocess = preprocess or os.path.join(base, "preprocess.yaml")
        model = model or os.path.join(base, "model.yaml")
        train = train or os.path.join(base, "train.yaml")
    pc = _build(PreprocessConfig, load_yaml(preprocess)) if preprocess else PreprocessConfig()
    mc = _build(ModelConfig, load_yaml(model)) if model else ModelConfig()
    train_data = load_yaml(train) if train else {}
    serve_data = train_data.get("serve") if isinstance(train_data, dict) else None
    sc = _build(ServeConfig, serve_data, "serve") if serve_data else ServeConfig()
    return Config(preprocess=pc, model=mc, serve=sc)
