"""The train step, the eval step and the step loop (JAX counterpart:
speakingstyle_tpu/training/trainer.py, single device).

``make_train_step`` is the JAX package's jitted step run eagerly: the
teacher-forced forward in training mode (dropout on, the postnet's
BatchNorm on batch statistics), the loss, ``torch.autograd.grad`` of
``total_loss`` over the model's parameters, and one optimizer update. The
dropout masks of step s come from ``DropoutRNG`` seeded by (seed, s), so a
resumed run draws what an uninterrupted one would. With
``train.resilience.nan_sentinel`` the step also returns
``losses["_finite"]``, an all-finite flag over the losses and the
gradients before the update, left on the device.

``run_training`` is the JAX loop: bucketed batches from the same seeds
through a ``DevicePrefetcher`` (a worker thread and a side CUDA stream), a
log line every ``log_step`` in ``<log_path>/log.txt`` and a structured
record in ``<log_path>/events.jsonl`` (``obs/events.py``), TensorBoard
scalars where ``torch.utils.tensorboard`` imports, validation every
``val_step``, a checkpoint every ``save_step`` (async, keep-best;
``training/checkpoint.py``) and a final blocking one, and ``restore_step``
resume. Resilience (``train.resilience``): at a log boundary a false
``_finite`` rolls the run back to the latest checkpoint (or a fresh init)
with a data stream seeded apart, and ``max_rollbacks`` consecutive trips
raise ``TrainingDivergedError``; SIGTERM/SIGINT end the loop after the
current step with a flushed checkpoint; loader errors are retried and the
failing samples quarantined. ``SPEAKINGSTYLE_FAULTS`` (``faults.py``)
drills each path: ``nan_grads@N`` poisons the batch of step N,
``sigterm@N`` delivers a real SIGTERM after step N, ``loader_ioerror@N``
fails the Nth feature load once. The registry counts
``train_steps_total``, ``train_rollbacks_total``,
``checkpoint_saves_total``, ``faults_fired_total`` and times
``train_step_seconds`` / ``train_data_wait_seconds``; a last ``train_end``
event carries those counters and the run's launches of each hand-written
kernel. ``train_start`` carries the build identity (``obs.build_info()``)
and the restored checkpoint's ``weights_digest``. With
``train.obs.program_card`` the first step runs under the flop counter
(``build_train_step_card``): a one-time ``program_card`` event records its
card, whose FLOPs over each step's wall time feed
``train_achieved_flops_per_sec``.

Data parallelism (``mesh``: a joined ``parallel.mesh.Mesh`` with ``dp > 1``,
one rank a process; ``parallel/launch.py`` starts them) computes what the
one-process step computes on the global batch, as the JAX package's GSPMD
step does: every rank cuts the same global batch (padded to a multiple of
``dp``) and copies its rows; each masked mean is divided by the global
count (``models/loss.py::loss_counts``) and the FiLM term enters on rank 0
only, so the SUM all-reduce of the ranks' gradients (flat buckets) is the
global gradient; the postnet's BatchNorm takes global statistics; the hash
dropout masks are the global batch's rows. The initial state is broadcast
from rank 0, rank 0 alone logs, writes events, TensorBoard, the program
card and checkpoints (``CheckpointManager(mesh=...)``), and the ranks agree
over the group on the losses they log, the sentinel's flag (MIN) and a
SIGTERM stop, so every rank rolls back or flushes at the same step. Rank 0's
registry carries ``train_achieved_flops_per_sec`` and
``device_memory_watermark_bytes`` with a ``device`` label a rank.

Tensor parallelism (``mesh.tp > 1``; ranks ``dp_rank = rank // tp``,
``tp_rank = rank % tp``) computes the same step with the parameters split
by ``parallel/partition.py``'s layout (``train.parallel.partition_rules``
over the defaults): each rank keeps its shard of every split leaf and of
its Adam moments, the modules run their column / row pairs on the shards
and gather the rest (``parallel/tensor.py``), every tp rank of a
data-parallel group takes the same rows, draws the same dropout bits and
computes the same replicated gradients. So the data-parallel machinery
above runs over the ``dp`` group (the gradient and BatchNorm all-reduces,
the loss shares, the FiLM term on the ranks of data-parallel rank 0), the
clip's norm counts each logical parameter once (``Optimizer.shard``), the
sentinel, stops and rollbacks agree over the world, and a checkpoint is
gathered whole (rank 0 writes it) and cut to any layout on restore.
"""

import math
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.profiler import record_function

from speakingstyle_torch import obs
from speakingstyle_torch.configs.config import Config, check_train_supported
from speakingstyle_torch.data.prefetch import host_tensors
from speakingstyle_torch.models.loss import fastspeech2_loss, loss_counts
from speakingstyle_torch.obs.cost import FLOPS_PER_SEC_BUCKETS
from speakingstyle_torch.ops.dropout import DropoutRNG
from speakingstyle_torch.training import faults, resilience
from speakingstyle_torch.training.state import TrainState

# keys of the step's losses that are bookkeeping, not losses
_INTERNAL_LOSS_KEYS = ("_finite",)


def public_losses(losses: Dict) -> Dict:
    return {k: v for k, v in losses.items() if k not in _INTERNAL_LOSS_KEYS}


def to_device(arrays: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A batch's numpy arrays on ``device`` in the calling thread: ids and
    lengths as int64, the rest float32; through pinned host memory with a
    non-blocking copy when the device is a card. (The step loop's copies
    run on ``data/prefetch.py``'s worker instead.)"""
    device = torch.device(device)
    host = host_tensors(arrays, pin=device.type == "cuda")
    if device.type != "cuda":
        return host
    return {k: t.to(device, non_blocking=True) for k, t in host.items()}


def model_kwargs(arrays: Dict) -> Dict:
    """The teacher-forced forward's arguments (the targets are the batch's)."""
    return dict(speakers=arrays["speakers"], texts=arrays["texts"],
                src_lens=arrays["src_lens"], mels=arrays["mels"],
                mel_lens=arrays["mel_lens"], max_mel_len=arrays["mels"].shape[1],
                p_targets=arrays["pitches"], e_targets=arrays["energies"],
                d_targets=arrays["durations"])


def compute_losses(model, cfg: Config, arrays: Dict, deterministic: bool,
                   rng: Optional[DropoutRNG] = None, counts: Optional[Dict] = None,
                   param_terms: bool = True) -> Dict[str, torch.Tensor]:
    """The teacher-forced forward and the loss dict (``counts`` and
    ``param_terms``: a data-parallel rank's share, ``models/loss.py``)."""
    pp = cfg.preprocess.preprocessing
    out = model(**model_kwargs(arrays), deterministic=deterministic, rng=rng)
    return fastspeech2_loss(
        out, arrays["mels"], arrays["pitches"], arrays["energies"], arrays["durations"],
        model, lambda_f=cfg.train.loss.lambda_f,
        pitch_feature_level=pp.pitch.feature, energy_feature_level=pp.energy.feature,
        counts=counts, param_terms=param_terms,
    )


def _dp(mesh) -> bool:
    return mesh is not None and mesh.dp > 1


def _multi(mesh) -> bool:
    return mesh is not None and mesh.world > 1


def _first_dp(mesh) -> bool:
    """This rank holds data-parallel rank 0's rows (every tp rank of it)."""
    return not _dp(mesh) or mesh.dp_rank == 0


def rank_rng(seed: int, arrays: Dict, mesh=None) -> DropoutRNG:
    """A step's dropout draws: seeded alike on every rank, offset to this
    rank's first row of the global batch (the tp ranks of a data-parallel
    group draw the same bits)."""
    rank = mesh.dp_rank if _dp(mesh) else 0
    return DropoutRNG(seed, arrays["texts"].device, rank=rank,
                      row_offset=rank * arrays["texts"].shape[0])


def trainable(model) -> List[torch.nn.Parameter]:
    return [p for p in model.parameters() if p.requires_grad]


def apply_gradients(state: TrainState, losses: Dict, nan_sentinel: bool, mesh=None):
    """The gradients of ``losses["total_loss"]`` over
    ``trainable(state.model)``, one optimizer update and the step count, in
    place; returns (the detached losses, with ``_finite`` under
    ``nan_sentinel``, the gradients). A parameter the loss does not reach
    (a distilled student's grafted reference encoder) gets a zero
    gradient, as JAX's ``value_and_grad`` gives it. On a mesh the
    gradients go through ``gradient_sync`` before the update (at the last
    micro-step under gradient accumulation), and the losses stay this
    rank's shares (``global_losses`` sums them)."""
    grads = torch.autograd.grad(losses["total_loss"], trainable(state.model),
                                materialize_grads=True)
    reduce = gradient_sync(state, mesh)
    if reduce is not None and state.optimizer.k == 1:
        reduce(grads)
        reduce = None
    losses = {k: v.detach() for k, v in losses.items()}
    if nan_sentinel:
        losses["_finite"] = resilience.all_finite(losses, grads)
    state.optimizer.update(grads, reduce=reduce)
    state.step += 1
    return losses, grads


def gradient_sync(state: TrainState, mesh=None):
    """fn(grads) in place, or None on one rank: the SUM over the ``dp``
    group, then, under tensor parallelism, the replicated leaves' gradients
    broadcast from tp rank 0. Every tp rank computes those from the same
    activations, but the card's backward is not bitwise deterministic
    (atomics in the embedding and scatter backward, cuDNN's weight
    gradients), and a replicated leaf must stay one value on every rank."""
    if not _multi(mesh):
        return None
    tp_replicated = [] if state.layout is None else \
        [i for i, d in enumerate(state.layout.opt_dims) if d is None]

    def sync(grads):
        if _dp(mesh):
            mesh.all_reduce_(grads)
        if tp_replicated:
            mesh.broadcast_([grads[i] for i in tp_replicated], group="tp")

    return sync


def global_losses(losses: Dict, mesh=None):
    """(the logged losses as host floats, the sentinel's flag) of a step's
    losses; under data parallelism the ranks' shares summed over the ``dp``
    group, and the flag's MIN over every rank (one rank's non-finite value
    trips every rank). The one host synchronisation of a log boundary."""
    finite = bool(losses.get("_finite", True))
    host = {k: float(v) for k, v in public_losses(losses).items()}
    if _dp(mesh):
        keys = [k for k in host if k != "film_gate_l2"]  # a value, not a share
        host.update(zip(keys, mesh.host_all_reduce([host[k] for k in keys], "sum", "dp")))
    if _multi(mesh):
        finite = mesh.host_all_reduce([1.0 if finite else 0.0], "min")[0] > 0
    return host, finite


def make_train_step(cfg: Config, mesh=None):
    """fn(state, arrays, counts=None) -> (losses, grads): one step in place
    on ``state``. The losses stay on the device (no host sync); the
    gradients, in ``trainable(state.model)`` order, are the ones the
    update applied. Under ``nan_sentinel`` the losses carry ``_finite``,
    computed from the losses and the gradients the update applied. With a
    data-parallel ``mesh``, ``arrays`` are this rank's rows and ``counts``
    (``loss_counts`` of the global batch) is required."""
    seed = cfg.train.seed + 1
    nan_sentinel = cfg.train.resilience.nan_sentinel

    def step(state: TrainState, arrays: Dict, counts: Optional[Dict] = None):
        if _dp(mesh) and counts is None:
            raise ValueError("a data-parallel step needs the global batch's loss counts")
        rng = rank_rng(seed * 1_000_003 + state.step, arrays, mesh)
        losses = compute_losses(state.model, cfg, arrays, deterministic=False, rng=rng,
                                counts=counts if _dp(mesh) else None,
                                param_terms=_first_dp(mesh))
        return apply_gradients(state, losses, nan_sentinel, mesh)

    return step


def make_eval_step(cfg: Config, mesh=None):
    """fn(state, arrays, counts=None) -> losses: the teacher-forced loss,
    deterministic (a rank's shares under data parallelism)."""

    @torch.no_grad()
    def step(state: TrainState, arrays: Dict, counts: Optional[Dict] = None):
        return compute_losses(state.model, cfg, arrays, deterministic=True,
                              counts=counts if _dp(mesh) else None,
                              param_terms=_first_dp(mesh))

    return step


def evaluate(eval_step, state, batches, mesh=None) -> Dict[str, float]:
    """Batch-size-weighted mean of every loss over a val pass of
    (Batch, tensors) pairs (reference: evaluate.py:39-58); under data
    parallelism over the global val batches (the ranks' sums added)."""
    sums: Dict[str, torch.Tensor] = {}
    count = 0
    for batch, arrays in batches:
        losses = eval_step(state, arrays, loss_counts(batch.arrays()) if _dp(mesh) else None)
        count += batch.n_real
        for k, v in losses.items():
            sums[k] = sums.get(k, 0.0) + v * batch.n_real
    if _dp(mesh):
        keys = sorted(sums)
        local = [0.0 if (k == "film_gate_l2" and not _first_dp(mesh)) else float(sums[k])
                 for k in keys]
        sums = dict(zip(keys, mesh.host_all_reduce(local, "sum", "dp")))
    return {k: float(v) / count for k, v in sums.items()} if count else {}


def train_batcher(cfg: Config, start_step: int = 0, retry: int = 0, dataset=None,
                  quarantine=None, pad_multiple: int = 1):
    """The training batches (``train.txt``, sorted, last partial batch
    dropped), cut as the JAX package's loop cuts them, from the seed
    ``train.seed + start_step + 7919 * retry``: a resumed run does not
    replay its stream from the start, and a rolled-back run diverges past
    the batches that tripped the sentinel. ``pad_multiple``: the batch
    rows padded to a multiple of the data-parallel ranks."""
    from speakingstyle_torch.data.dataset import BucketedBatcher, SpeechDataset

    max_len = cfg.model.max_seq_len
    dataset = dataset or SpeechDataset("train.txt", cfg, sort=True, drop_last=True)
    return BucketedBatcher(dataset, max_src=max_len, max_mel=max_len,
                           batch_pad_multiple=pad_multiple,
                           seed=cfg.train.seed + start_step + 7919 * retry,
                           quarantine=quarantine)


def val_batcher(cfg: Config, pad_multiple: int = 1):
    from speakingstyle_torch.data.dataset import BucketedBatcher, SpeechDataset

    max_len = cfg.model.max_seq_len
    return BucketedBatcher(SpeechDataset("val.txt", cfg, sort=False, drop_last=False),
                           max_src=max_len, max_mel=max_len, batch_pad_multiple=pad_multiple,
                           seed=0)


def batch_streams(cfg: Config, start_step: int = 0, pad_multiple: int = 1):
    """(the endless stream of training batches from ``start_step``, the val
    batcher), as ``run_training`` cuts them before any rollback."""
    return (iter(train_batcher(cfg, start_step, pad_multiple=pad_multiple)),
            val_batcher(cfg, pad_multiple))


def broadcast_state(state: TrainState, mesh) -> None:
    """Data-parallel rank 0's parameters, buffers and Adam moments (its
    shards, under tensor parallelism) on every rank of its ``dp`` group
    (flat buckets). A rank's gradient accumulator stays its own."""
    if not _dp(mesh):
        return
    opt = state.optimizer
    with torch.no_grad():
        mesh.broadcast_(list(state.model.parameters()) + list(state.model.buffers())
                        + opt.mu + opt.nu)


def local_accumulator(state: TrainState, mesh) -> None:
    """After a restore: the checkpoint's accumulator (the global one) stays
    on rank 0 and the other ranks' start at 0, so the ranks' accumulators
    still sum to the global one."""
    if not _first_dp(mesh) and state.optimizer.acc is not None:
        for a in state.optimizer.acc:
            a.zero_()


class _SavedState:
    """What a checkpoint stores: the state with the data-parallel ranks'
    accumulators summed (between micro-steps under gradient accumulation)
    and, under tensor parallelism, every split leaf and moment gathered
    whole over ``tp`` (on every rank, in the constructor: a collective), so
    that it restores at any (dp, tp)."""

    def __init__(self, state: TrainState, mesh):
        self.state, self.acc, self.whole = state, None, None
        opt = state.optimizer
        if _dp(mesh) and opt.acc is not None and opt.mini_step:
            self.acc = [a.clone() for a in opt.acc]
            mesh.all_reduce_(self.acc)
        if state.layout is not None:
            self.whole = self._gathered(mesh)

    def _local(self, copy: bool) -> Dict:
        d = self.state.state_dict(copy)
        if self.acc is not None:
            d["optimizer"]["acc"] = self.acc
        return d

    @torch.no_grad()
    def _gathered(self, mesh) -> Dict:
        from speakingstyle_torch.parallel.tensor import gather_whole

        lay, d = self.state.layout, self._local(copy=False)
        whole = lambda t, dim: t if dim is None else gather_whole(t, dim, mesh)  # noqa: E731
        d["model"] = {k: whole(v, lay.dim(k)) for k, v in d["model"].items()}
        for key in ("mu", "nu", "acc"):
            if d["optimizer"].get(key) is not None:
                d["optimizer"][key] = [whole(t, dim) for t, dim in
                                       zip(d["optimizer"][key], lay.opt_dims)]
        return d

    def state_dict(self, copy: bool = True) -> Dict:
        return self.whole if self.whole is not None else self._local(copy)


def build_state(cfg: Config, device, mesh=None) -> TrainState:
    """The model from the config and the corpus stats, seeded random
    weights (``train.seed``), on ``device``, and its optimizer; with a
    tensor-parallel ``mesh``, this rank's shards (``shard_model``)."""
    from speakingstyle_torch.models.factory import build_model, init_weights

    model = init_weights(build_model(cfg), cfg.train.seed).to(device)
    return shard_model(model, cfg, mesh)


def shard_model(model, cfg: Config, mesh=None) -> TrainState:
    """A TrainState of ``model`` (whole weights) and a fresh optimizer; on
    a mesh of tp > 1 the layout of ``train.parallel.partition_rules`` over
    the defaults is applied first (the model keeps this rank's slices) and
    the optimizer's clip counts each split leaf once over ``tp``."""
    from speakingstyle_torch.parallel.partition import (
        TPLayout, apply_layout, parse_rule_overrides, tp_layout,
    )
    from speakingstyle_torch.training.optim import Optimizer

    layout = None
    if mesh is not None and mesh.tp > 1:
        dims = tp_layout(model, mesh.tp, parse_rule_overrides(cfg.train.parallel.partition_rules))
        apply_layout(model, dims, mesh)
        names = [n for n, p in model.named_parameters() if p.requires_grad]
        layout = TPLayout(dims, mesh.tp, mesh.tp_rank, names)
    optimizer = Optimizer(trainable(model), cfg.train)
    if layout is not None:
        optimizer.shard([d is not None for d in layout.opt_dims],
                        lambda t: mesh.all_reduce_([t], group="tp"))
    return TrainState(step=0, model=model, optimizer=optimizer, layout=layout)


def check_state_replicas(state: TrainState, mesh, what: str) -> None:
    """Raise unless the replicated leaves are equal on every rank and, under
    tensor parallelism, each shard on every rank of its ``dp`` group."""
    from speakingstyle_torch.obs.buildinfo import weights_digest
    from speakingstyle_torch.parallel.mesh import check_replicas

    if not _multi(mesh):
        return
    sd = state.model.state_dict()
    dims = state.layout.dims if state.layout is not None else {}
    check_replicas(weights_digest({k: v for k, v in sd.items() if dims.get(k) is None}),
                   mesh, what)
    if dims:
        check_replicas(weights_digest({k: v for k, v in sd.items() if dims.get(k) is not None}),
                       mesh, f"{what} (shards)", "dp")


def _summary_writer(log_dir: str):
    """A ``torch.utils.tensorboard`` writer, or None where TensorBoard does
    not import (it is optional, as tensorboardX is in the JAX package)."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        return None
    return SummaryWriter(log_dir)


class TrainLogger:
    """Append-only ``log.txt``, TensorBoard scalars, figures and audio
    (where it imports), and with ``registry`` / ``events`` the loss gauges
    and one JSONL record per ``log()`` (``train_step`` / ``val``), written by
    the same call from the same values so the two cannot drift. Unlike the
    JAX package's, a ``log.txt`` line also carries the timing fields."""

    def __init__(self, log_dir: str, use_tensorboard: bool = True,
                 registry: Optional[obs.MetricsRegistry] = None,
                 events: Optional[obs.JsonlEventLog] = None):
        os.makedirs(log_dir, exist_ok=True)
        self.txt = open(os.path.join(log_dir, "log.txt"), "a")
        self.registry, self.events = registry, events
        self.tb = _summary_writer(log_dir) if use_tensorboard else None

    def _write(self, line: str) -> None:
        self.txt.write(line + "\n")
        self.txt.flush()

    def log(self, step: int, losses: Dict[str, float], lr: Optional[float] = None,
            prefix: str = "train", timing: Optional[Dict[str, float]] = None):
        msg = f"[{prefix}] Step {step}, " + ", ".join(f"{k}: {v:.4f}" for k, v in losses.items())
        if lr is not None:
            msg += f", lr: {lr:.6f}"
        for k, v in (timing or {}).items():
            msg += f", {k}: {v:.6g}"
        self._write(msg)
        if self.tb is not None:
            for k, v in losses.items():
                self.tb.add_scalar(f"{prefix}/{k}", v, step)
            if lr is not None:
                self.tb.add_scalar(f"{prefix}/lr", lr, step)
        if self.registry is not None:
            self.registry.gauge("train_step", help="last logged step").set(step)
            for k, v in losses.items():
                self.registry.gauge("train_loss", labels={"loss": k, "split": prefix}).set(v)
        self.event("train_step" if prefix == "train" else prefix, step=step, **losses,
                   **({"lr": lr} if lr is not None else {}), **(timing or {}))

    def event(self, name: str, /, **fields):
        """Append one record to events.jsonl (a no-op without an event log)."""
        if self.events is not None:
            self.events.emit(name, **fields)

    def note(self, msg: str):
        """A raw line into log.txt (rollbacks, SIGTERM flushes, quarantine
        summaries), and a ``note`` event."""
        self._write(msg)
        self.event("note", msg=msg)

    def log_throughput(self, step: int, steps_per_sec: float, frames_per_sec: float):
        self._write(f"[perf] Step {step}, steps/s: {steps_per_sec:.2f}, "
                    f"mel-frames/s: {frames_per_sec:.0f}")
        if self.tb is not None:
            self.tb.add_scalar("perf/steps_per_sec", steps_per_sec, step)
            self.tb.add_scalar("perf/mel_frames_per_sec", frames_per_sec, step)

    def log_figure(self, step: int, tag: str, fig):
        if self.tb is not None and fig is not None:
            self.tb.add_figure(tag, fig, step)

    def log_audio(self, step: int, tag: str, wav, sampling_rate: int,
                  max_wav_value: float = 32768.0):
        if self.tb is not None:
            wav = torch.from_numpy(np.asarray(wav, np.float32) / max_wav_value)
            self.tb.add_audio(tag, wav[None], step, sample_rate=sampling_rate)

    def close(self):
        self.txt.close()
        if self.events is not None:
            self.events.close()
        if self.tb is not None:
            self.tb.close()


def kernel_launches() -> Dict[str, int]:
    """The hand-written kernels' launch counts so far in this process
    (each wrapper counts its own launches; ops/fused_attention.py,
    ops/fused_conv.py)."""
    from speakingstyle_torch.ops.fused_attention import attention_delta, fused_mha, fused_mha_bwd
    from speakingstyle_torch.ops.fused_conv import fused_conv1d

    return {"fused_attention_fwd": fused_mha.launches,
            "fused_attention_fwd_bf16sm": fused_mha.launches_bf16sm,
            "fused_attention_bwd": fused_mha_bwd.launches,
            "fused_attention_bwd_bf16sm": fused_mha_bwd.launches_bf16sm,
            "fused_attention_bwd_delta": attention_delta.launches,
            "fused_conv1d_fwd": fused_conv1d.launches,
            "fused_conv1d_fwd_act": fused_conv1d.act_launches}


def build_train_step_card(train_step, state, arrays, device):
    """Run one train step under ``torch.utils.flop_counter`` and the
    hand-written kernels' tally (``ops.kernels.counting_flops``): returns
    (the step's losses, its ``ProgramCard``). The step is the run's own,
    not an extra one. On the card ``peak_bytes`` is the allocation peak
    the step reached above what was allocated before it, when it raised
    the process's peak (else None)."""
    from torch.utils.flop_counter import FlopCounterMode

    from speakingstyle_torch.obs.cost import ProgramCard
    from speakingstyle_torch.ops import kernels

    cuda = device.type == "cuda"
    if cuda:
        allocated0, peak0 = torch.cuda.memory_allocated(device), \
            torch.cuda.max_memory_allocated(device)
    with kernels.counting_flops() as tally, FlopCounterMode(display=False) as counter:
        losses, grads = train_step(state, arrays)
    peak = None
    if cuda:
        peak1 = torch.cuda.max_memory_allocated(device)
        peak = float(peak1 - allocated0) if peak1 > peak0 else None
    card = ProgramCard(name="train_step", flops=float(counter.get_total_flops() + tally[0]),
                       peak_bytes=peak,
                       argument_bytes=float(sum(t.numel() * t.element_size()
                                                for t in arrays.values())))
    return (losses, grads), card


def _profile_start(profile_dir: str):
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(profile_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    prof = profile(activities=acts)
    prof.start()
    return prof


def _profile_stop(prof, profile_dir: str, step: int) -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()
    prof.export_chrome_trace(os.path.join(profile_dir, f"trace_to_step{step}.json"))


def resolve_run_mesh(cfg: Config, device):
    """The mesh a run on ``device`` trains on: ``train.parallel`` resolved
    (the batch gate first, before any process group), then joined. A mesh
    of dp x tp > 1 needs rank processes: this process joins the rendezvous
    of its environment (``torchrun``, or the workers ``parallel/launch.py``
    starts) or the group already started."""
    from speakingstyle_torch.parallel.mesh import (
        init_distributed, local_batch_size, resolve_mesh, visible_devices,
    )

    n_devices = visible_devices(device)
    check_train_supported(cfg.train, n_devices)
    mesh = resolve_mesh(cfg.train.parallel, n_devices=n_devices)
    if mesh is None:
        return None
    # the startup gate: the batch and the nearest valid sizes named,
    # before any transfer or collective
    local_batch_size(cfg.train.optimizer.batch_size, mesh)
    if mesh.world == 1:
        return None
    if not os.environ.get("WORLD_SIZE"):
        raise RuntimeError(
            f"a mesh of dp={mesh.dp} x tp={mesh.tp} trains as {mesh.world} rank processes: "
            f"run `python -m speakingstyle_torch train ... --data_parallel {mesh.dp} "
            f"--model_parallel {mesh.tp}` (which starts them), or start them with torchrun "
            "(under SPEAKINGSTYLE_MULTIHOST the environment must name the rendezvous: RANK, "
            "WORLD_SIZE, MASTER_ADDR, MASTER_PORT)")
    return init_distributed(device, dp=mesh.dp, tp=mesh.tp)


def run_training(cfg: Config, device=None, restore_step: Optional[int] = None,
                 max_steps: Optional[int] = None, synth_callback=None, log: bool = True,
                 vocoder=None, profile_dir: Optional[str] = None,
                 profile_steps: tuple = (10, 20),
                 registry: Optional[obs.MetricsRegistry] = None) -> TrainState:
    """The step loop; returns the final TrainState. ``max_steps`` overrides
    ``total_step``; ``restore_step`` -1 (or None after a 0 from the CLI)
    resumes from the latest checkpoint, N > 0 from step N.
    ``synth_callback(state, batch, arrays, step, model)`` runs every
    ``synth_step`` ("default": the ground-truth vs predicted sample of
    ``default_synth_callback``). ``profile_dir``: a ``torch.profiler`` trace
    of steps [profile_steps) of this run, exported as a chrome trace. Each
    train step runs inside a ``train.step`` profiler range. The mesh is
    ``train.parallel`` resolved (``resolve_run_mesh``): with dp x tp > 1
    this process trains as the rank its environment names."""
    from speakingstyle_torch.data.dataset import SpeechDataset
    from speakingstyle_torch.data.prefetch import DevicePrefetcher
    from speakingstyle_torch.device import resolve_device
    from speakingstyle_torch.models.postnet import sync_batch_stats
    from speakingstyle_torch.training.checkpoint import CheckpointManager

    device = resolve_device(device)
    mesh = resolve_run_mesh(cfg, device)
    if mesh is not None:
        device = mesh.device
    main = mesh is None or mesh.is_main
    pad_mult = mesh.dp if mesh is not None else 1
    steps, res = cfg.train.step, cfg.train.resilience
    total_step = max_steps if max_steps is not None else steps.total_step
    plan = faults.FaultPlan.from_env()
    registry = registry if registry is not None else obs.get_registry()
    step_hist = registry.histogram(
        "train_step_seconds", help="per-step wall time excluding data wait (host "
        "dispatch; device-honest at log boundaries where the loop syncs)")
    wait_hist = registry.histogram("train_data_wait_seconds",
                                   help="per-step time blocked on the prefetcher")
    steps_ctr = registry.counter("train_steps_total", help="optimizer steps run")
    rollback_ctr = registry.counter("train_rollbacks_total", help="NaN-sentinel rollbacks taken")
    save_ctr = registry.counter("checkpoint_saves_total", help="checkpoints enqueued/flushed")
    fault_ctr = registry.counter("faults_fired_total", help="injected faults fired (drills)")
    flops_hist = registry.histogram(
        "train_achieved_flops_per_sec", edges=FLOPS_PER_SEC_BUCKETS,
        help="ProgramCard train-step FLOPs / per-step wall time (host-dispatch-based)")
    launches0 = kernel_launches()

    log = log and main
    events = (obs.JsonlEventLog(cfg.train.path.log_path, max_bytes=cfg.train.obs.events_max_bytes,
                                keep=cfg.train.obs.events_keep)
              if log and cfg.train.obs.events else None)
    logger = TrainLogger(cfg.train.path.log_path, registry=registry, events=events) if log else None
    state = build_state(cfg, device)
    if mesh is not None and mesh.tp > 1:  # this rank's shards, a fresh optimizer
        state = shard_model(state.model, cfg, mesh)
    sync_batch_stats(state.model, mesh)
    ckpt = CheckpointManager(cfg.train.path.ckpt_path, max_to_keep=res.max_to_keep or None,
                             async_save=res.async_checkpointing, keep_best=res.keep_best,
                             fault_plan=plan, events=events, registry=registry, mesh=mesh)
    if restore_step is not None:
        ckpt.restore(state, step=restore_step if restore_step > 0 else None,
                     ignore_layers=cfg.train.ignore_layers)
    broadcast_state(state, mesh)
    local_accumulator(state, mesh)
    train_step, eval_step = make_train_step(cfg, mesh), make_eval_step(cfg, mesh)
    train_ds = SpeechDataset("train.txt", cfg, sort=True, drop_last=True,
                             retries=res.loader_retries, backoff=res.loader_backoff,
                             fault_plan=plan, registry=registry)
    quarantine = resilience.Quarantine(budget=res.bad_sample_budget)
    step = start_step = state.step  # the profile window is relative to start_step

    def make_stream(retry: int) -> DevicePrefetcher:
        batcher = train_batcher(cfg, start_step, retry, train_ds, quarantine, pad_mult)
        return DevicePrefetcher(iter(batcher), device, transfer_retries=res.loader_retries,
                                transfer_backoff=res.loader_backoff, registry=registry,
                                mesh=mesh)

    def save(step: int, **kw) -> None:
        ckpt.save(step, _SavedState(state, mesh), val_loss=last_val, **kw)

    prefetch = make_stream(0)
    val_batches = val_batcher(cfg, pad_mult)
    if logger:
        logger.event("train_start", **dict(
            obs.build_info(), step=step, total_step=total_step, device=str(device),
            device_name=(torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"),
            device_count=mesh.world if mesh is not None else 1,
            mesh_shape={"data": pad_mult, "model": mesh.tp if mesh is not None else 1},
            dp_backend=mesh.backend if mesh is not None else None,
            checkpoint_step=ckpt.last_restored_step, weights_digest=ckpt.last_weights_digest))
    # the train step's card is built once, on the first step (one
    # attempt, success or not)
    program_card, card_pending = None, cfg.train.obs.program_card
    if synth_callback == "default":
        synth_callback = default_synth_callback(cfg, logger, vocoder=vocoder)
    guard = resilience.RollbackGuard(res.max_rollbacks)
    last_val: Optional[float] = None
    last_saved: Optional[int] = None
    window_t0, window_step0, window_frames = time.perf_counter(), step, 0
    window_wait = window_compute = 0.0
    step_time = 0.0
    prof = None
    profile_dir = profile_dir if main else None
    shutdown = resilience.GracefulShutdown()

    def stop_requested() -> bool:
        # every rank stops at the same step: a signal seen by one is seen by all
        return mesh.any(shutdown.requested) if mesh is not None else shutdown.requested

    try:
        with shutdown:
            while step < total_step and not stop_requested():
                t_iter = time.perf_counter()
                try:
                    batch, arrays = next(prefetch)
                except StopIteration:
                    break
                data_wait = time.perf_counter() - t_iter
                wait_hist.observe(data_wait)
                window_wait += data_wait
                if plan.fire("nan_grads", step + 1):
                    # under data parallelism one shard's rows only (rank 0's):
                    # the sentinel's MIN over the ranks must trip them all
                    arrays = faults.poison_batch(arrays, rank=mesh.dp_rank if mesh else None)
                    fault_ctr.inc()
                    if logger:
                        logger.event("fault_fire", kind="nan_grads", step=step + 1)
                if (profile_dir is not None and prof is None
                        and profile_steps[0] <= step - start_step < profile_steps[1]):
                    prof = _profile_start(profile_dir)
                lr = state.optimizer.lr()
                counts = loss_counts(batch.arrays()) if mesh is not None else None
                with record_function("train.step"):
                    if card_pending:
                        card_pending = False
                        (losses, _), program_card = build_train_step_card(
                            lambda st, a: train_step(st, a, counts), state, arrays, device)
                        if logger:
                            logger.event("program_card", **program_card.as_dict())
                    else:
                        losses, _ = train_step(state, arrays, counts)
                step = state.step
                steps_ctr.inc()
                step_time = time.perf_counter() - t_iter - data_wait
                step_hist.observe(step_time)
                if program_card is not None and program_card.flops and step_time > 0:
                    flops_hist.observe(program_card.flops / step_time)
                window_compute += step_time
                window_frames += int(batch.mel_lens.sum())  # host-side, no sync
                if prof is not None and step - start_step >= profile_steps[1]:
                    _profile_stop(prof, profile_dir, step)
                    prof = None
                if plan.fire("sigterm", step):
                    fault_ctr.inc()
                    if logger:
                        logger.event("fault_fire", kind="sigterm", step=step)
                    faults.deliver_sigterm()

                if step % steps.log_step == 0:
                    # the loop's one synchronisation: the sentinel's flag and
                    # the losses come to the host together (and are agreed
                    # over the ranks)
                    t_sync = time.perf_counter()
                    host, finite = global_losses(losses, mesh)
                    window_compute += time.perf_counter() - t_sync
                    if not finite:
                        n = guard.trip(step)  # raises past max_rollbacks
                        ckpt.wait()
                        if mesh is not None:
                            mesh.barrier()  # rank 0's last write is in place
                        good = ckpt.latest_step()
                        if mesh is not None:
                            good = int(mesh.host_broadcast(-1 if good is None else good))
                            good = None if good < 0 else good
                        rollback_ctr.inc()
                        msg = (f"[resilience] non-finite losses/grads at step {step}; "
                               f"rollback {n}/{res.max_rollbacks} to "
                               + (f"checkpoint step {good}" if good is not None
                                  else "fresh init (no checkpoint yet)"))
                        # every rank says it rolls back (rank 0 alone logs it)
                        print(msg if mesh is None else f"[rank {mesh.rank}] {msg}", flush=True)
                        if logger:
                            logger.note(msg)
                            logger.event("rollback", step=step, rollback_n=n, restore_step=good)
                        prefetch.stop()
                        if good is not None:
                            ckpt.restore(state, step=good)
                        else:  # deterministic re-init: the same seed
                            state.load_state_dict(build_state(cfg, device).state_dict())
                        local_accumulator(state, mesh)
                        step = state.step
                        prefetch = make_stream(guard.count)
                        window_t0, window_step0, window_frames = time.perf_counter(), step, 0
                        window_wait = window_compute = 0.0
                        continue
                    guard.ok()
                    device_gauges(registry, program_card, step_time, device, mesh)
                    if logger:
                        n_window = step - window_step0
                        dt = time.perf_counter() - window_t0
                        timing = {"step_time_s": window_compute / n_window,
                                  "data_wait_s": window_wait / n_window,
                                  "steps_per_sec": n_window / dt,
                                  "mel_frames_per_sec": window_frames / dt}
                        logger.log(step, host, lr=lr, timing=timing)
                        logger.log_throughput(step, timing["steps_per_sec"],
                                              timing["mel_frames_per_sec"])
                    window_t0, window_step0, window_frames = time.perf_counter(), step, 0
                    window_wait = window_compute = 0.0
                # every tp rank of the first data-parallel group runs the
                # model (its collectives); rank 0 alone has a logger
                if _first_dp(mesh) and synth_callback is not None \
                        and step % steps.synth_step == 0:
                    synth_callback(state, batch, arrays, step, state.model)
                if step % steps.val_step == 0:
                    with DevicePrefetcher(val_batches.epoch(shuffle=False), device,
                                          registry=registry, mesh=mesh) as val_prefetch:
                        val = evaluate(eval_step, state, val_prefetch, mesh)
                    last_val = val.get("total_loss", last_val)
                    if logger:
                        logger.log(step, val, prefix="val")
                if step % steps.save_step == 0:
                    save(step)
                    save_ctr.inc()
                    if logger:
                        logger.event("checkpoint_save", step=step)
                    last_saved = step

            # always flush a final checkpoint: the tail steps past the last
            # save_step, and the SIGTERM/SIGINT preemption path
            if step > start_step and last_saved != step:
                save(step, block=True)
                save_ctr.inc()
                if logger:
                    logger.event("checkpoint_save", step=step, final=True)
                last_saved = step
            if stop_requested():
                signame = shutdown.signame or "SIGTERM"
                msg = f"[resilience] {signame}: checkpoint flushed at step {step}; exiting"
                print(msg if mesh is None else f"[rank {mesh.rank}] "
                      + (msg if main else f"stopped at step {step}"), flush=True)
                if logger:
                    logger.note(msg)
                    logger.event("preempt_flush", signal=signame, step=step)
    finally:
        if prof is not None:  # the run ended inside the profile window
            _profile_stop(prof, profile_dir, step)
        prefetch.stop()
        if quarantine.bad and logger:
            logger.note(f"[resilience] {len(quarantine.bad)} quarantined sample(s): "
                        f"{sorted(quarantine.bad)}")
            logger.event("quarantine", samples=sorted(quarantine.bad))
        if logger:
            launches = {k: v - launches0[k] for k, v in kernel_launches().items()}
            logger.event("train_end", step=step, counters=registry.snapshot()["counters"],
                         kernel_launches=launches)
            logger.close()
        ckpt.close()
    check_state_replicas(state, mesh, f"train step {step}")
    return state


def device_gauges(registry, program_card, step_time: float, device, mesh=None) -> None:
    """``train_achieved_flops_per_sec`` (the step card's FLOPs over the last
    step's wall time) and ``device_memory_watermark_bytes``
    (``obs.cost.device_memory_watermark``: the card's allocation peak, on
    the CPU the step card's argument and temp bytes), with a
    ``device`` label; under data parallelism every rank's values land in
    rank 0's registry (a host gather at the log boundary)."""
    from speakingstyle_torch.obs.cost import device_memory_watermark

    flops = math.nan
    if program_card is not None and program_card.flops and step_time > 0:
        flops = program_card.flops / step_time
    memory = device_memory_watermark(program_card, device.index or 0) \
        if device.type == "cuda" or program_card is not None else None
    memory = math.nan if memory is None else float(memory)
    rows = {str(device): (flops, memory)}
    if _multi(mesh):  # labelled rank<r>/<device>: ranks may share a card
        ranks = mesh.host_gather([flops, memory, -1 if device.index is None else device.index])
        if not mesh.is_main:
            return
        dev = lambda i: device.type if i < 0 else f"{device.type}:{int(i)}"  # noqa: E731
        rows = {f"rank{r}/{dev(i)}": (f, m) for r, (f, m, i) in enumerate(ranks)}
    for label, (flops, memory) in rows.items():
        if math.isfinite(flops):
            registry.gauge("train_achieved_flops_per_sec", labels={"device": label},
                           help="per-device achieved FLOP/s of the train step").set(flops)
        if math.isfinite(memory):
            registry.gauge("device_memory_watermark_bytes", labels={"device": label},
                           help="per-device memory watermark").set(memory)


def default_synth_callback(cfg: Config, logger: Optional[TrainLogger], vocoder=None):
    """The periodic validation sample (reference: train.py:117-144): the
    batch's first utterance through the model teacher-forced, its
    ground-truth and predicted mels vocoded (``vocoder``, else
    Griffin-Lim) into TensorBoard audio, and the two mels plotted where a
    writer exists and matplotlib imports."""

    def callback(state, batch, arrays, step, model):
        from speakingstyle_torch.synthesis import synth_one_sample

        with torch.no_grad():
            out = model(**model_kwargs(arrays), deterministic=True)
        plot = logger is not None and logger.tb is not None
        fig, wav_recon, wav_pred, basename = synth_one_sample(
            batch, out, vocoder, cfg, plot=plot, device=arrays["mels"].device)
        if logger is not None:
            pp = cfg.preprocess.preprocessing
            sr, mw = pp.audio.sampling_rate, pp.audio.max_wav_value
            logger.log_figure(step, f"Training/{basename}", fig)
            logger.log_audio(step, f"Training/{basename}_reconstructed", wav_recon, sr, mw)
            logger.log_audio(step, f"Training/{basename}_synthesized", wav_pred, sr, mw)
        if fig is not None:
            import matplotlib.pyplot as plt

            plt.close(fig)

    return callback
