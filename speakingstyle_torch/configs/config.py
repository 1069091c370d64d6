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
``train.yaml`` loads into ``TrainConfig`` (the JAX package's blocks and
defaults) plus the serve block. The trainer (training/trainer.py) reads
``path``, ``optimizer``, ``step``, ``loss``, ``seed``,
``resilience.max_to_keep`` and ``ignore_layers``. Knobs that tune only the
JAX package's compiler or runtime have no meaning here and are accepted as
they are: ``fast_prng`` (the PRNG behind dropout bits), ``fused_optimizer``
(three layouts of one update, which the port computes one way),
``obs.compilation_cache_dir`` / ``obs.program_card``, and the
``resilience`` knobs of the rollbacks and loader retries. What asks for a
path not ported yet raises ``NotImplementedError`` when training starts
(``check_train_supported``): a mesh other than one device,
``sharding.remat: true``, fault injection (``SPEAKINGSTYLE_FAULTS``), or
``resilience.nan_sentinel`` / ``keep_best`` / ``async_checkpointing``.
Those three default to false here (true in the JAX package), so a
``train.yaml`` that leaves them out loads and trains, and one that asks
for them raises.
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
    # the attention softmax's dtype: "bfloat16" rounds the scores to bf16
    # before the softmax, in the kernels as in the plain version
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
# train.yaml: the training blocks (the JAX package's schema and defaults)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class OptimizerConfig:
    batch_size: int = 16
    betas: Tuple[float, float] = (0.9, 0.98)
    eps: float = 1e-9
    weight_decay: float = 0.0
    grad_clip_thresh: float = 1.0
    grad_acc_step: int = 1
    warm_up_step: int = 4000  # vestigial in the reference; kept for config parity
    anneal_steps: List[int] = field(default_factory=lambda: [300000, 400000, 500000])
    anneal_rate: float = 0.3
    init_lr: float = 1e-4
    anneal_lr: float = 1e-3


@dataclass(frozen=True)
class StepConfig:
    total_step: int = 900000
    log_step: int = 100
    synth_step: int = 1000
    val_step: int = 1000
    save_step: int = 1000


@dataclass(frozen=True)
class LossConfig:
    lambda_f: float = 0.0  # FiLM-gate L2 weight
    anneal_steps: int = 10000  # LR ramp length


@dataclass(frozen=True)
class TrainPathConfig:
    ckpt_path: str = "./output/ckpt"
    log_path: str = "./output/log"
    result_path: str = "./output/result"


@dataclass(frozen=True)
class ShardingConfig:
    """The legacy mesh block (``train.parallel`` is the current one)."""

    data_axis: int = -1  # -1: all devices on the data axis
    model_axis: int = 1  # tensor-parallel degree (1 = pure data parallel)
    remat: bool = False  # recompute the FFT stacks in the backward


@dataclass(frozen=True)
class ParallelConfig:
    """``mesh = [dp, tp]``; ``[1, 1]`` is one device. ``dp = -1`` takes
    every device not claimed by ``tp``."""

    mesh: List[int] = field(default_factory=lambda: [1, 1])
    seq: int = 1
    partition_rules: List[List[str]] = field(default_factory=list)

    def __post_init__(self):
        if len(self.mesh) != 2:
            raise ValueError(f"parallel.mesh must be [dp, tp], got {self.mesh}")
        dp, tp = self.mesh
        if tp < 1:
            raise ValueError(f"parallel.mesh tp must be >= 1, got {tp}")
        if dp < 1 and dp != -1:
            raise ValueError(
                f"parallel.mesh dp must be >= 1 (or -1 for all remaining devices), got {dp}"
            )
        if self.seq < 1:
            raise ValueError(f"parallel.seq must be >= 1, got {self.seq}")
        for rule in self.partition_rules:
            if len(rule) != 2 or not all(isinstance(x, str) for x in rule):
                raise ValueError(
                    f"parallel.partition_rules entries must be [path_regex, axes] "
                    f"string pairs, got {rule!r}"
                )

    def is_single(self) -> bool:
        return tuple(self.mesh) == (1, 1) and self.seq == 1


@dataclass(frozen=True)
class ResilienceConfig:
    # not ported yet, so false by default (check_train_supported raises on true)
    async_checkpointing: bool = False
    max_to_keep: int = 5  # newest N step checkpoints; 0 keeps everything
    keep_best: bool = False
    nan_sentinel: bool = False
    max_rollbacks: int = 3
    loader_retries: int = 3
    loader_backoff: float = 0.05
    bad_sample_budget: int = 16

    def __post_init__(self):
        for name in ("max_to_keep", "max_rollbacks", "loader_retries", "bad_sample_budget"):
            if getattr(self, name) < 0:
                raise ValueError(f"{name} must be >= 0, got {getattr(self, name)}")


@dataclass(frozen=True)
class ObsConfig:
    events: bool = True
    events_max_bytes: int = 8_000_000
    events_keep: int = 3
    compilation_cache_dir: str = ""
    program_card: bool = True

    def __post_init__(self):
        if self.events_max_bytes <= 0:
            raise ValueError(f"events_max_bytes must be > 0, got {self.events_max_bytes}")
        if self.events_keep < 1:
            raise ValueError(f"events_keep must be >= 1, got {self.events_keep}")


@dataclass(frozen=True)
class TrainConfig:
    path: TrainPathConfig = field(default_factory=TrainPathConfig)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    step: StepConfig = field(default_factory=StepConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    sharding: ShardingConfig = field(default_factory=ShardingConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    resilience: ResilienceConfig = field(default_factory=ResilienceConfig)
    obs: ObsConfig = field(default_factory=ObsConfig)
    ignore_layers: List[str] = field(default_factory=list)
    seed: int = 1234
    fast_prng: bool = True
    fused_optimizer: object = False  # False | True | "flat" | "leaf"

    def __post_init__(self):
        if self.fused_optimizer not in (False, True, "flat", "leaf"):
            raise ValueError(
                "fused_optimizer must be False|True|'flat'|'leaf', "
                f"got {self.fused_optimizer!r}"
            )
        if self.optimizer.grad_acc_step < 1:
            raise ValueError(
                f"grad_acc_step must be >= 1, got {self.optimizer.grad_acc_step}"
            )


FAULTS_ENV = "SPEAKINGSTYLE_FAULTS"


def check_train_supported(train: TrainConfig, n_devices: int = 1) -> None:
    """Raise ``NotImplementedError`` for a training setting whose path is
    not ported yet (ROADMAP.md queue A): more than one device, remat, fault
    injection, the NaN sentinel, keep-best retention or async saves.
    ``n_devices`` is what ``sharding.data_axis = -1`` resolves to."""
    par, sh = train.parallel, train.sharding
    dp = n_devices if sh.data_axis == -1 else sh.data_axis
    if not par.is_single() or sh.model_axis != 1 or dp != 1:
        raise NotImplementedError(
            f"train.parallel.mesh {par.mesh} (seq {par.seq}) / train.sharding "
            f"data_axis {sh.data_axis}, model_axis {sh.model_axis}: the port trains "
            "on one device; multi-device training is ROADMAP.md queue A item 8"
        )
    if sh.remat:
        raise NotImplementedError(
            "train.sharding.remat: true is not ported yet (ROADMAP.md queue A item 6)"
        )
    if os.environ.get(FAULTS_ENV):
        raise NotImplementedError(
            f"{FAULTS_ENV} is set: fault injection and the resilience drills are "
            "not ported yet (ROADMAP.md queue A item 6)"
        )
    asked = [k for k in ("nan_sentinel", "keep_best", "async_checkpointing")
             if getattr(train.resilience, k)]
    if asked:
        raise NotImplementedError(
            f"train.resilience {', '.join(asked)}: true is not ported yet (the port "
            "saves synchronously, keeps the newest max_to_keep steps and has no NaN "
            "rollback; ROADMAP.md queue A item 6)"
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
    """The (preprocess, model, train) triple plus the serve block."""

    preprocess: PreprocessConfig = field(default_factory=PreprocessConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
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
    serve_data = train_data.pop("serve", None) if isinstance(train_data, dict) else None
    tc = _build(TrainConfig, train_data) if train else TrainConfig()
    sc = _build(ServeConfig, serve_data, "serve") if serve_data else ServeConfig()
    return Config(preprocess=pc, model=mc, train=tc, serve=sc)
