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
``path``, ``optimizer``, ``step``, ``loss``, ``seed``, ``resilience``,
``obs.events*``, ``obs.program_card``, ``sharding.remat`` and
``ignore_layers``. Knobs that tune only the JAX package's compiler or
runtime have no meaning here and are accepted as they are: ``fast_prng``
(the PRNG behind dropout bits), ``fused_optimizer`` (three layouts of one
update, which the port computes one way), ``obs.compilation_cache_dir``. A mesh
other than one device raises ``NotImplementedError`` when training starts
(``check_train_supported``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
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
    # "dense", or "ring": sequence-parallel exact attention
    # (parallel/ring_attention.py) in the encoder and decoder stacks, for
    # inference past max_seq_len; build the model with a seq mesh
    # (models/factory.build_model(..., seq_mesh=...)); sequence lengths
    # must divide by its seq axis
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
        if self.attention_impl == "ring" and self.attention_softmax_dtype != "float32":
            # the ring's streaming softmax is float32 by design
            # (parallel/ring_attention.py)
            raise ValueError(
                'attention_impl="ring" supports only '
                'attention_softmax_dtype="float32"'
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
            try:
                re.compile(rule[0])
            except re.error as e:
                raise ValueError(f"parallel.partition_rules regex {rule[0]!r}: {e}") from e
            for tok in rule[1].split(","):
                if tok.strip().lower() not in ("", "none", "data", "model", "seq"):
                    raise ValueError(f"parallel.partition_rules axes token {tok!r} is not "
                                     "one of none, data, model, seq")

    def is_single(self) -> bool:
        return tuple(self.mesh) == (1, 1) and self.seq == 1

    def rule_axes(self) -> List[str]:
        """The mesh axes the partition-rule overrides name."""
        return sorted({tok.strip().lower() for _, axes in self.partition_rules
                       for tok in axes.split(",")} - {"", "none"})


@dataclass(frozen=True)
class ResilienceConfig:
    """Fault-tolerance knobs (training/resilience.py); the JAX package's
    defaults."""

    # checkpoint writes run on a background thread after a host snapshot
    async_checkpointing: bool = True
    max_to_keep: int = 5  # newest N step checkpoints; 0 keeps everything
    keep_best: bool = True  # never prune the best-val-loss step
    # an all-finite flag over losses + grads each step, read at the log
    # boundary; on a trip, roll back to the last good checkpoint
    nan_sentinel: bool = True
    max_rollbacks: int = 3  # consecutive rollbacks before TrainingDivergedError
    loader_retries: int = 3
    loader_backoff: float = 0.05  # seconds; doubles per attempt
    bad_sample_budget: int = 16  # quarantined samples before the run fails

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


SEQ_MISSING = ("serving across devices (serve.parallel past mesh [1, 1]: one replica over "
               "several devices, and a replica spanning hosts) is ROADMAP.md queue A item 6c-ii")
DATA_RULE_MISSING = ("parameters sharded over the mesh's data axis (a partition rule naming "
                     "'data', which GSPMD takes) are ROADMAP.md queue A item 6d; the port "
                     "splits parameters over the model axis only")


def check_train_supported(train: TrainConfig, n_devices: int = 1) -> None:
    """Raise ``NotImplementedError`` for a mesh the port does not train on:
    data parallelism (``dp > 1``) and tensor parallelism (``tp > 1``, the
    partition rules over the ``model`` axis) run as rank processes over
    ``torch.distributed``; a partition rule naming ``data`` (ROADMAP.md
    queue A item 6d) does not. ``seq > 1`` trains as the JAX trainer does,
    on the ``(dp, tp)`` mesh of ``parallel.mesh`` with dense attention (the
    trainer builds no sequence axis), and a rule naming ``seq`` raises where
    the JAX trainer's sharding does, at tp > 1
    (``parallel/partition.py::tp_layout``).
    ``n_devices`` is what ``sharding.data_axis = -1`` ("every device")
    resolves to."""
    par, sh = train.parallel, train.sharding
    axes = par.rule_axes()
    if "data" in axes:
        raise NotImplementedError(f"train.parallel.partition_rules: {DATA_RULE_MISSING}")
    if sh.model_axis < 1:
        raise ValueError(f"train.sharding.model_axis must be >= 1, got {sh.model_axis}")
    dp = n_devices if sh.data_axis == -1 else sh.data_axis
    if dp < 1:
        raise ValueError(f"train.sharding.data_axis must be >= 1 or -1, got {sh.data_axis}")


def check_serve_supported(serve) -> None:
    """Raise ``NotImplementedError`` for a replica mesh the port does not
    serve on: ``serve.parallel`` past ``mesh: [1, 1]``, ``seq: 1`` is one
    replica across devices (``SEQ_MISSING``). The ring long-form tier
    (``serve.longform.mesh_seq > 1``) is served."""
    par = serve.parallel
    if not par.is_single():
        raise NotImplementedError(
            f"serve.parallel (mesh {par.mesh}, seq {par.seq}): {SEQ_MISSING}; the port serves "
            "a replica on one device (mesh [1, 1])")


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
    """The StyleService's knobs (serving/style.py): its ``(batch, ref_len)``
    lattice and its content-addressed cache."""

    # padded reference-mel lengths the style encoder runs at
    ref_buckets: List[int] = field(default_factory=lambda: [256, 512, 1000])
    # encode batch sizes; empty = inherit serve.batch_buckets
    batch_buckets: List[int] = field(default_factory=list)
    # (gamma, beta) entries the LRU cache keeps
    cache_capacity: int = 512
    # allowlist directory for server-side "ref_audio" request paths; ""
    # refuses path-based references (uploads go through POST /styles)
    ref_dir: str = ""

    def __post_init__(self):
        _check_ascending("serve.style.ref_buckets", self.ref_buckets)
        if self.batch_buckets:
            _check_ascending("serve.style.batch_buckets", self.batch_buckets)
        if self.cache_capacity <= 0:
            raise ValueError(
                f"serve.style.cache_capacity must be > 0, got {self.cache_capacity}"
            )


TIER_PRECISIONS = ("f32", "bf16", "int8")


@dataclass(frozen=True)
class TiersConfig:
    """Quality tiers (copied whole from the JAX package): precision
    variants of the acoustic lattice. A tier name is
    ``<model>-<precision>`` (``teacher-f32``, ``student-int8``); the
    engine reads ``enabled`` and ``precisions``, serving/tiers.py the
    routing, the gate's tolerance and the golden set, which the golden
    prober (serving/probes.py) replays too."""

    enabled: bool = False
    # precision tiers the lattice prepares; the first is the default
    precisions: List[str] = field(default_factory=lambda: ["f32"])
    # traffic class -> tier name; classes absent here ride default_tier
    class_tier: Dict[str, str] = field(default_factory=dict)
    default_tier: str = "teacher-f32"
    # golden-set mel-L2 ceiling vs the teacher-f32 engine for a tier to ship
    tier_tolerance: float = 1e3
    golden_set_size: int = 4
    golden_seed: int = 0
    # the distilled student checkpoint; empty = no student tiers
    student_ckpt_path: str = ""

    def __post_init__(self):
        if not self.precisions:
            raise ValueError("serve.tiers.precisions must be non-empty")
        for p in self.precisions:
            if p not in TIER_PRECISIONS:
                raise ValueError(
                    f"serve.tiers.precisions entries must be in {TIER_PRECISIONS}, got {p!r}"
                )
        if len(set(self.precisions)) != len(self.precisions):
            raise ValueError(f"serve.tiers.precisions must be unique, got {self.precisions}")
        for name in [self.default_tier, *self.class_tier.values()]:
            model, sep, prec = name.partition("-")
            if not sep or model not in ("teacher", "student") or prec not in TIER_PRECISIONS:
                raise ValueError(
                    "tier names must be '<model>-<precision>' with model in "
                    f"(teacher, student) and precision in {TIER_PRECISIONS}, got {name!r}"
                )
        if self.tier_tolerance <= 0:
            raise ValueError(f"serve.tiers.tier_tolerance must be > 0, got {self.tier_tolerance}")
        if self.golden_set_size <= 0:
            raise ValueError(
                f"serve.tiers.golden_set_size must be > 0, got {self.golden_set_size}"
            )


@dataclass(frozen=True)
class QualityConfig:
    """The audio-quality gate's thresholds (obs/quality.py), and the golden
    prober's knobs (serving/probes.py): its traffic class, which the fleet
    keeps out of its shed, SLO and autoscaler accounting, its deadline,
    cadence, drift tolerances and anchor directory."""

    enabled: bool = True
    # fraction of samples at >= 99.9% full scale before a wav fails
    clip_fraction_max: float = 0.5
    # longest exact-zero run (digital silence) a wav may carry
    silence_run_ms_max: float = 500.0
    # |mean| of the normalised wav (full scale = 1.0)
    dc_offset_max: float = 0.5
    # spectral flatness above this is a stuck signal (constant ~1.0,
    # white noise ~0.56, speech far below)
    flatness_max: float = 0.9
    # no flatness check below this many samples
    flatness_min_samples: int = 256
    probe_class: str = "probe"
    probe_deadline_ms: float = 30_000.0
    probe_interval_s: float = 30.0
    probe_mel_tolerance: float = 10.0
    probe_style_tolerance: float = 10.0
    anchor_dir: str = ""

    def __post_init__(self):
        for name in ("clip_fraction_max", "flatness_max"):
            v = getattr(self, name)
            if not (0.0 < v <= 1.0):
                raise ValueError(f"serve.quality.{name} must be in (0, 1], got {v}")
        for name in ("silence_run_ms_max", "dc_offset_max", "probe_deadline_ms",
                     "probe_interval_s", "probe_mel_tolerance", "probe_style_tolerance"):
            v = getattr(self, name)
            if v <= 0:
                raise ValueError(f"serve.quality.{name} must be > 0, got {v}")
        if self.flatness_min_samples < 2:
            raise ValueError(
                "serve.quality.flatness_min_samples must be >= 2, got "
                f"{self.flatness_min_samples}"
            )
        if not self.probe_class:
            raise ValueError("serve.quality.probe_class must be non-empty")


@dataclass(frozen=True)
class FleetConfig:
    """The fleet's knobs (copied whole from the JAX package, so a YAML with
    a ``fleet:`` block loads and validates as there). The single-engine
    path reads the shed watermarks and Retry-After (serving/batcher.py),
    the stream window, overlap and depth and ``drain_timeout_s``
    (serving/server.py). ``replicas`` > 1 serves through the fleet router
    (cli/serve.py, serving/fleet.py), which reads the rest: the queue depth
    and watermarks of its EDF heap, the class deadlines (also the server's
    wait behind a router, plus ``deadline_grace_ms``), the hang watchdog,
    the retry budgets and the breaker's re-warm backoff."""

    replicas: int = 1
    queue_depth: int = 256
    # shed from high * depth pending, readmit at low * depth
    shed_high_watermark: float = 0.9
    shed_low_watermark: float = 0.5
    # Retry-After of a 429 before a drain rate is measured
    shed_retry_after_s: float = 1.0
    # traffic class -> completion budget (ms)
    class_deadline_ms: Dict[str, float] = field(
        default_factory=lambda: {"interactive": 250.0, "batch": 2000.0})
    default_class: str = "interactive"
    # streaming: mel frames a window, context a side (0 = the vocoder's
    # receptive field), windows in flight
    stream_window: int = 64
    stream_overlap: int = 0
    stream_depth: int = 2
    # shutdown waits this long for in-flight streams
    drain_timeout_s: float = 10.0
    hang_watchdog_s: float = 10.0
    retry_budget: Dict[str, int] = field(
        default_factory=lambda: {"interactive": 1, "batch": 2})
    rewarm_backoff_s: float = 0.5
    rewarm_backoff_max_s: float = 30.0
    # grace on top of a class deadline when the HTTP layer bounds its wait
    deadline_grace_ms: float = 500.0
    # ceiling of a per-request deadline override; 0.0 derives
    # max(120000.0, largest class deadline)
    max_deadline_ms: float = 0.0

    def __post_init__(self):
        if self.replicas < 1:
            raise ValueError(f"fleet.replicas must be >= 1, got {self.replicas}")
        if self.queue_depth <= 0:
            raise ValueError(f"fleet.queue_depth must be > 0, got {self.queue_depth}")
        if not (0.0 < self.shed_low_watermark <= self.shed_high_watermark <= 1.0):
            raise ValueError(
                "fleet watermarks must satisfy 0 < low <= high <= 1, got "
                f"low={self.shed_low_watermark} high={self.shed_high_watermark}")
        if not self.class_deadline_ms:
            raise ValueError("fleet.class_deadline_ms must be non-empty")
        for name, ms in self.class_deadline_ms.items():
            if ms <= 0:
                raise ValueError(f"fleet.class_deadline_ms[{name!r}] must be > 0, got {ms}")
        if self.default_class not in self.class_deadline_ms:
            raise ValueError(
                f"fleet.default_class {self.default_class!r} is not a key of "
                f"class_deadline_ms {sorted(self.class_deadline_ms)}")
        if self.stream_window <= 0:
            raise ValueError(f"fleet.stream_window must be > 0, got {self.stream_window}")
        if self.stream_overlap < 0:
            raise ValueError(f"fleet.stream_overlap must be >= 0, got {self.stream_overlap}")
        if self.stream_depth < 1:
            raise ValueError(f"fleet.stream_depth must be >= 1, got {self.stream_depth}")
        if self.drain_timeout_s < 0:
            raise ValueError(f"fleet.drain_timeout_s must be >= 0, got {self.drain_timeout_s}")
        if self.hang_watchdog_s < 0:
            raise ValueError(
                f"fleet.hang_watchdog_s must be >= 0 (0 disables), got {self.hang_watchdog_s}")
        for name, n in self.retry_budget.items():
            if n < 0:
                raise ValueError(f"fleet.retry_budget[{name!r}] must be >= 0, got {n}")
        if self.rewarm_backoff_s <= 0:
            raise ValueError(f"fleet.rewarm_backoff_s must be > 0, got {self.rewarm_backoff_s}")
        if self.rewarm_backoff_max_s < self.rewarm_backoff_s:
            raise ValueError(
                "fleet.rewarm_backoff_max_s must be >= rewarm_backoff_s, got "
                f"{self.rewarm_backoff_max_s} < {self.rewarm_backoff_s}")
        if self.deadline_grace_ms < 0:
            raise ValueError(
                f"fleet.deadline_grace_ms must be >= 0, got {self.deadline_grace_ms}")
        if self.max_deadline_ms < 0:
            raise ValueError(
                f"fleet.max_deadline_ms must be >= 0 (0 = derive), got {self.max_deadline_ms}")
        if self.max_deadline_ms == 0.0:
            object.__setattr__(self, "max_deadline_ms",
                               max(120000.0, max(self.class_deadline_ms.values())))
        elif self.max_deadline_ms < max(self.class_deadline_ms.values()):
            raise ValueError(
                "fleet.max_deadline_ms must be >= every class deadline "
                f"(it is the override ceiling), got {self.max_deadline_ms} "
                f"< max of {self.class_deadline_ms}")


@dataclass(frozen=True)
class AutoscaleConfig:
    """Closed-loop fleet autoscaler knobs (serving/autoscale.py; copied from
    the JAX package's ``AutoscaleConfig``). Disabled by default: with
    ``enabled: false`` nothing constructs one and the replica count stays
    wherever ``scale_to()`` last put it. Enabled, a policy thread reads the
    router's pending depth, dispatch occupancy and shed / deadline-miss
    rate and drives ``scale_to()`` inside ``[min_replicas, max_replicas]``
    with hysteresis and cooldowns; the calm window before a scale-down is
    stretched by the measured warm-up cost (``serve_replica_warmup_seconds``)."""

    enabled: bool = False
    min_replicas: int = 1
    max_replicas: int = 4
    # policy tick period (a stop-aware Event.wait)
    interval_s: float = 0.25
    # scale-up triggers (any one fires): pending depth as a fraction of
    # fleet.queue_depth (below the shed watermark on purpose); busy share of
    # READY replicas, with a backlog of one a live replica (floor 2) held a
    # full tick; shed + deadline-miss events a second
    up_queue_fraction: float = 0.5
    up_occupancy: float = 0.9
    up_pressure_rate: float = 1.0
    # scale-down: all must hold, for max(down_stable_s, warmup_cost_factor x
    # the measured warm-up)
    down_queue_fraction: float = 0.05
    down_occupancy: float = 0.5
    down_stable_s: float = 5.0
    cooldown_up_s: float = 2.0
    cooldown_down_s: float = 10.0
    # replicas added at extreme pressure (depth past twice the up watermark)
    max_step: int = 2
    # warm-up seconds assumed until the first one is measured
    assumed_warmup_s: float = 10.0
    warmup_cost_factor: float = 1.0

    def __post_init__(self):
        if self.min_replicas < 1:
            raise ValueError(f"autoscale.min_replicas must be >= 1, got {self.min_replicas}")
        if self.max_replicas < self.min_replicas:
            raise ValueError(
                "autoscale.max_replicas must be >= min_replicas, got "
                f"{self.max_replicas} < {self.min_replicas}")
        if self.interval_s <= 0:
            raise ValueError(f"autoscale.interval_s must be > 0, got {self.interval_s}")
        if not (0.0 < self.up_queue_fraction <= 1.0):
            raise ValueError(
                f"autoscale.up_queue_fraction must be in (0, 1], got {self.up_queue_fraction}")
        if not (0.0 <= self.down_queue_fraction < self.up_queue_fraction):
            raise ValueError(
                "autoscale.down_queue_fraction must satisfy 0 <= down < "
                f"up_queue_fraction, got {self.down_queue_fraction}")
        if not (0.0 < self.up_occupancy <= 1.0):
            raise ValueError(f"autoscale.up_occupancy must be in (0, 1], got {self.up_occupancy}")
        if not (0.0 <= self.down_occupancy < self.up_occupancy):
            raise ValueError(
                "autoscale.down_occupancy must satisfy 0 <= down < "
                f"up_occupancy, got {self.down_occupancy}")
        if self.up_pressure_rate < 0:
            raise ValueError(
                f"autoscale.up_pressure_rate must be >= 0, got {self.up_pressure_rate}")
        for name in ("down_stable_s", "cooldown_up_s", "cooldown_down_s",
                     "warmup_cost_factor"):
            if getattr(self, name) < 0:
                raise ValueError(f"autoscale.{name} must be >= 0, got {getattr(self, name)}")
        if self.max_step < 1:
            raise ValueError(f"autoscale.max_step must be >= 1, got {self.max_step}")
        if self.assumed_warmup_s <= 0:
            raise ValueError(
                f"autoscale.assumed_warmup_s must be > 0, got {self.assumed_warmup_s}")


@dataclass(frozen=True)
class RolloutConfig:
    """Canary-gated rolling model rollout knobs (serving/lifecycle.py;
    copied from the JAX package's ``RolloutConfig``): verify the candidate
    checkpoint, warm one canary replica on it, replay a seeded golden set
    through the canary and the live version (all-finite, mean |dmel|
    within ``canary_tolerance``), then drain-replace the old replicas one
    at a time. Any failure before commit aborts with the fleet untouched."""

    # gates POST /admin/rollout: a mutating admin surface is opted into
    enabled: bool = False
    golden_set_size: int = 4
    canary_seed: int = 0
    # against broken weights (NaN, garbage), not intended retraining deltas
    canary_tolerance: float = 1e3
    # per-replica warm / drain wait during the canary and the roll
    replica_timeout_s: float = 600.0

    def __post_init__(self):
        if self.golden_set_size <= 0:
            raise ValueError(
                f"serve.rollout.golden_set_size must be > 0, got {self.golden_set_size}")
        if self.canary_tolerance < 0:
            raise ValueError(
                f"serve.rollout.canary_tolerance must be >= 0, got {self.canary_tolerance}")
        if self.replica_timeout_s <= 0:
            raise ValueError(
                f"serve.rollout.replica_timeout_s must be > 0, got {self.replica_timeout_s}")


@dataclass(frozen=True)
class TraceConfig:
    """Span recording (obs/trace.py): the per-process ring and the
    keep-store of pinned traces."""

    enabled: bool = True
    ring_capacity: int = 4096
    keep_traces: int = 256
    # the share of healthy traces the fleet router's tail sampler pins
    # (obs/trace.py TailSampler); shed / 504 / miss traces are always pinned
    sample_rate: float = 0.1

    def __post_init__(self):
        if self.ring_capacity < 1:
            raise ValueError(
                f"serve.trace.ring_capacity must be >= 1, got {self.ring_capacity}")
        if self.keep_traces < 1:
            raise ValueError(f"serve.trace.keep_traces must be >= 1, got {self.keep_traces}")
        if not (0.0 <= self.sample_rate <= 1.0):
            raise ValueError(
                f"serve.trace.sample_rate must be in [0, 1], got {self.sample_rate}")


@dataclass(frozen=True)
class SloConfig:
    """Multi-window burn-rate accounting per traffic class (obs/slo.py):
    burn = (bad / total) / (1 - objective) over a fast and a slow window;
    an alert fires when both pass their thresholds."""

    enabled: bool = True
    objectives: Dict[str, float] = field(
        default_factory=lambda: {"interactive": 0.999, "batch": 0.99})
    fast_window_s: float = 60.0
    slow_window_s: float = 600.0
    fast_burn_threshold: float = 14.4
    slow_burn_threshold: float = 6.0
    tick_s: float = 5.0
    # traffic class -> share of validated wavs that must pass the gate
    quality_objectives: Dict[str, float] = field(
        default_factory=lambda: {"interactive": 0.99, "batch": 0.99, "probe": 0.99})

    def __post_init__(self):
        for klass, obj in self.objectives.items():
            if not (0.0 < obj < 1.0):
                raise ValueError(
                    f"serve.slo.objectives[{klass!r}] must be in (0, 1), got {obj}")
        for klass, obj in self.quality_objectives.items():
            if not (0.0 < obj < 1.0):
                raise ValueError(
                    f"serve.slo.quality_objectives[{klass!r}] must be in (0, 1), got {obj}")
        if self.fast_window_s <= 0:
            raise ValueError(f"serve.slo.fast_window_s must be > 0, got {self.fast_window_s}")
        if self.slow_window_s <= self.fast_window_s:
            raise ValueError(
                "serve.slo.slow_window_s must be > fast_window_s, got "
                f"{self.slow_window_s} <= {self.fast_window_s}")
        if self.fast_burn_threshold <= 0 or self.slow_burn_threshold <= 0:
            raise ValueError(
                "serve.slo burn thresholds must be > 0, got "
                f"{self.fast_burn_threshold}/{self.slow_burn_threshold}")
        if self.tick_s <= 0:
            raise ValueError(f"serve.slo.tick_s must be > 0, got {self.tick_s}")


@dataclass(frozen=True)
class LongformConfig:
    """Long-form (chapter-length) synthesis (copied whole from the JAX
    package; serving/longform.py). The chunked tier splits a chapter at
    sentence boundaries into utterances that each fit the interactive
    lattice, synthesizes them as one deadline-sharing group of requests
    through the batcher or the fleet, and joins them with an equal-power
    crossfade, streamed chunk by chunk in bounded memory. The ring tier
    (``mesh_seq > 1``: one chapter-length utterance as one ring-attention
    program over a sequence mesh of ``mesh_seq`` ranks, at ``src_buckets``
    / ``mel_buckets``) is ``RingTier``; ``serve`` builds it on one engine
    and serves the chunked tier only behind a fleet, as the JAX command
    does."""

    # sequence-mesh size of the ring tier; 0 or 1 = the chunked tier only
    mesh_seq: int = 0
    # padded text / mel lengths of the ring tier, above the interactive
    # lattice; each divisible by mesh_seq
    src_buckets: List[int] = field(default_factory=lambda: [512, 1024])
    mel_buckets: List[int] = field(default_factory=lambda: [6144, 12288])
    # mel frames of equal-power crossfade at each chunk seam (times the
    # vocoder hop in samples)
    crossfade_frames: int = 8
    # admission cap on a chapter, in chunks after sentence packing
    max_chunks: int = 64
    # chunk requests in flight ahead of the stitch point
    group_depth: int = 4
    # the chapter's group budget is n_chunks * this, clamped to
    # fleet.max_deadline_ms
    deadline_ms_per_chunk: float = 2000.0
    # "auto" rings when a ring tier is up and the chapter fits it, else
    # chunks; "chunked" / "ring" force a tier ("ring" degrades to chunked)
    tier: str = "auto"

    def __post_init__(self):
        if self.mesh_seq < 0:
            raise ValueError(f"serve.longform.mesh_seq must be >= 0, got {self.mesh_seq}")
        for name in ("src_buckets", "mel_buckets"):
            vals = getattr(self, name)
            if not vals:
                raise ValueError(f"serve.longform.{name} must be non-empty")
            if any(v <= 0 for v in vals):
                raise ValueError(f"serve.longform.{name} must be positive, got {vals}")
            if sorted(vals) != list(vals) or len(set(vals)) != len(vals):
                raise ValueError(f"serve.longform.{name} must be strictly ascending, got {vals}")
            if self.mesh_seq > 1 and any(v % self.mesh_seq for v in vals):
                raise ValueError(
                    f"serve.longform.{name} must be divisible by mesh_seq={self.mesh_seq} "
                    f"(ring shards the length axis evenly), got {vals}")
        if self.crossfade_frames < 0:
            raise ValueError(
                f"serve.longform.crossfade_frames must be >= 0, got {self.crossfade_frames}")
        if self.max_chunks <= 0:
            raise ValueError(f"serve.longform.max_chunks must be > 0, got {self.max_chunks}")
        if self.group_depth < 1:
            raise ValueError(f"serve.longform.group_depth must be >= 1, got {self.group_depth}")
        if self.deadline_ms_per_chunk <= 0:
            raise ValueError(
                "serve.longform.deadline_ms_per_chunk must be > 0, got "
                f"{self.deadline_ms_per_chunk}")
        if self.tier not in ("auto", "chunked", "ring"):
            raise ValueError(
                f"serve.longform.tier must be 'auto'|'chunked'|'ring', got {self.tier!r}")


@dataclass(frozen=True)
class ClusterConfig:
    """The cluster: replica processes behind the fleet router (copied whole
    from the JAX package; serving/cluster.py). Disabled by default: the
    fleet keeps its in-process replicas. Enabled (or ``serve --cluster``),
    every replica is a ``python -m speakingstyle_torch replica`` process that
    owns a whole engine and registers with the router over HTTP; liveness
    is a heartbeat lease, dispatch is hedged within the class budgets."""

    enabled: bool = False
    # the router's /register + /heartbeat server (port 0: a free one, passed
    # to the spawned replicas as --router)
    control_host: str = "127.0.0.1"
    control_port: int = 0
    # heartbeat cadence; a lease lasts heartbeat_interval_s *
    # (lease_miss_budget + 1) and every beat renews it
    heartbeat_interval_s: float = 0.5
    lease_miss_budget: int = 3
    # a hedge leg goes to another host once the first has been out longer
    # than this quantile of the class's wire latency, clamped into
    # [hedge_min_ms, hedge_max_ms]; 0 disables hedging
    hedge_quantile: float = 0.95
    hedge_min_ms: float = 50.0
    hedge_max_ms: float = 2000.0
    # connect timeout of every control and dispatch connection (a dispatch's
    # read timeout comes from its class deadline)
    connect_timeout_s: float = 2.0
    # a spawned replica must hold a live, ready lease within this budget
    spawn_grace_s: float = 120.0
    # /healthz answers 503 until this many replicas are READY
    quorum: int = 1
    # executed dispatch batches a replica keeps for duplicate legs (LRU)
    idempotency_cache: int = 256

    def __post_init__(self):
        if self.heartbeat_interval_s <= 0:
            raise ValueError(f"serve.cluster.heartbeat_interval_s must be > 0, got "
                             f"{self.heartbeat_interval_s}")
        if self.lease_miss_budget < 1:
            raise ValueError(f"serve.cluster.lease_miss_budget must be >= 1, got "
                             f"{self.lease_miss_budget}")
        if not 0.0 <= self.hedge_quantile < 1.0:
            raise ValueError(f"serve.cluster.hedge_quantile must be in [0, 1) (0 disables "
                             f"hedging), got {self.hedge_quantile}")
        if self.hedge_min_ms < 0:
            raise ValueError(f"serve.cluster.hedge_min_ms must be >= 0, got {self.hedge_min_ms}")
        if self.hedge_max_ms < self.hedge_min_ms:
            raise ValueError("serve.cluster.hedge_max_ms must be >= hedge_min_ms, got "
                             f"{self.hedge_max_ms} < {self.hedge_min_ms}")
        if self.connect_timeout_s <= 0:
            raise ValueError(f"serve.cluster.connect_timeout_s must be > 0, got "
                             f"{self.connect_timeout_s}")
        if self.spawn_grace_s <= 0:
            raise ValueError(f"serve.cluster.spawn_grace_s must be > 0, got {self.spawn_grace_s}")
        if self.quorum < 1:
            raise ValueError(f"serve.cluster.quorum must be >= 1, got {self.quorum}")
        if self.idempotency_cache < 1:
            raise ValueError(f"serve.cluster.idempotency_cache must be >= 1, got "
                             f"{self.idempotency_cache}")

    @property
    def lease_ttl_s(self) -> float:
        """A lease's duration: ``lease_miss_budget`` beats may be missed."""
        return self.heartbeat_interval_s * (self.lease_miss_budget + 1)


@dataclass(frozen=True)
class ServeConfig:
    """The synthesis engine's shape lattice (serving/lattice.py): every
    dispatch runs at a ``(batch, L_src, T_mel)`` drawn from the cross
    product of these buckets; ``T_mel`` is the free-run output buffer.
    The HTTP server's and the fleet's keys follow (serving/batcher.py,
    serving/server.py, serving/fleet.py, serving/autoscale.py,
    serving/lifecycle.py, serving/longform.py, serving/cluster.py,
    cli/serve.py). ``parallel`` is one replica's mesh: ``[1, 1]`` (the
    default) is the one-device engine; ``serve`` and ``replica`` refuse
    more, which is serving across devices (ROADMAP.md queue A item
    6c-ii)."""

    batch_buckets: List[int] = field(default_factory=lambda: [1, 2, 4, 8])
    src_buckets: List[int] = field(default_factory=lambda: [32, 64, 128, 256])
    mel_buckets: List[int] = field(default_factory=lambda: [256, 512, 1000])
    # a request is dispatched at most this long after arrival (sooner when
    # a full batch_buckets[-1] coalesces first)
    max_wait_ms: float = 10.0
    # bounded admission queue; submit blocks (stop-aware) when full
    queue_depth: int = 64
    # a request with n phonemes needs T_mel >= n * frames_per_phoneme
    frames_per_phoneme: int = 12
    # accepted for the JAX package's YAMLs and without effect here: the
    # engine's pool already reuses its staging buffers (serving/pool.py)
    donate_buffers: bool = True
    # host -> device copy retries with backoff (seconds, doubling)
    transfer_retries: int = 0
    transfer_backoff: float = 0.05
    host: str = "127.0.0.1"
    port: int = 8400
    # POST /debug/profile?seconds=N captures a torch.profiler trace
    debug_profile: bool = True
    # serve_dispatch / http_request JSONL events under train.path.log_path
    log_events: bool = False
    # G2P threads overlapped with the batcher's coalescing wait; 0 = inline
    frontend_workers: int = 2
    fleet: FleetConfig = field(default_factory=FleetConfig)
    cluster: ClusterConfig = field(default_factory=ClusterConfig)
    style: StyleConfig = field(default_factory=StyleConfig)
    tiers: TiersConfig = field(default_factory=TiersConfig)
    trace: TraceConfig = field(default_factory=TraceConfig)
    slo: SloConfig = field(default_factory=SloConfig)
    quality: QualityConfig = field(default_factory=QualityConfig)
    autoscale: AutoscaleConfig = field(default_factory=AutoscaleConfig)
    rollout: RolloutConfig = field(default_factory=RolloutConfig)
    longform: LongformConfig = field(default_factory=LongformConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)

    def __post_init__(self):
        for name in ("batch_buckets", "src_buckets", "mel_buckets"):
            _check_ascending(f"serve.{name}", getattr(self, name))
        if self.max_wait_ms < 0:
            raise ValueError(f"serve.max_wait_ms must be >= 0, got {self.max_wait_ms}")
        if self.queue_depth <= 0:
            raise ValueError(f"serve.queue_depth must be > 0, got {self.queue_depth}")
        if self.frontend_workers < 0:
            raise ValueError(
                f"serve.frontend_workers must be >= 0 (0 = inline), got {self.frontend_workers}")
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


def config_from_dict(data: Dict[str, Any]) -> Config:
    """The ``Config`` of a nested dict (``dataclasses.asdict`` of one, sent
    as JSON to another process), validated as a loaded one is."""
    return _build(Config, data)


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
