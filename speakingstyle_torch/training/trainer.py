"""The train step, the eval step and the step loop (JAX counterpart:
speakingstyle_tpu/training/trainer.py, single device).

``make_train_step`` is the JAX package's jitted step run eagerly: the
teacher-forced forward in training mode (dropout on, the postnet's
BatchNorm on batch statistics), the loss, ``torch.autograd.grad`` of
``total_loss`` over the model's parameters, and one optimizer update. The
dropout masks of step s come from ``DropoutRNG`` seeded by (seed, s), so a
resumed run draws what an uninterrupted one would.

``run_training`` is the core of the JAX loop: bucketed batches from the
same seeds, a pinned-memory non-blocking host -> device copy, a log line
every ``log_step`` in ``<log_path>/log.txt`` (losses, lr, step and data-wait
seconds, mel frames/s), validation every ``val_step``, a checkpoint every
``save_step`` and a final one, and ``restore_step`` resume. Not ported yet
(ROADMAP.md): the NaN sentinel and rollback, the SIGTERM flush, loader
quarantine, the device prefetcher thread, the event log and TensorBoard,
the synth callback and profiling flags.
"""

import os
import time
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch
from torch.profiler import record_function

from speakingstyle_torch.configs.config import Config, check_train_supported
from speakingstyle_torch.models.loss import fastspeech2_loss
from speakingstyle_torch.ops.dropout import DropoutRNG
from speakingstyle_torch.training.state import TrainState

ARRAY_KEYS = ("speakers", "texts", "src_lens", "mels", "mel_lens", "pitches", "energies",
              "durations")
_INT_KEYS = ("speakers", "texts", "src_lens", "mel_lens", "durations")


def to_device(arrays: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A batch's numpy arrays on ``device``: ids and lengths as int64, the
    rest float32; through pinned host memory with a non-blocking copy when
    the device is a card."""
    out = {}
    for k in ARRAY_KEYS:
        t = torch.from_numpy(np.ascontiguousarray(arrays[k]))
        t = t.long() if k in _INT_KEYS else t.float()
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return out


def model_kwargs(arrays: Dict) -> Dict:
    """The teacher-forced forward's arguments (the targets are the batch's)."""
    return dict(speakers=arrays["speakers"], texts=arrays["texts"],
                src_lens=arrays["src_lens"], mels=arrays["mels"],
                mel_lens=arrays["mel_lens"], max_mel_len=arrays["mels"].shape[1],
                p_targets=arrays["pitches"], e_targets=arrays["energies"],
                d_targets=arrays["durations"])


def compute_losses(model, cfg: Config, arrays: Dict, deterministic: bool,
                   rng: Optional[DropoutRNG] = None) -> Dict[str, torch.Tensor]:
    """The teacher-forced forward and the loss dict."""
    pp = cfg.preprocess.preprocessing
    out = model(**model_kwargs(arrays), deterministic=deterministic, rng=rng)
    return fastspeech2_loss(
        out, arrays["mels"], arrays["pitches"], arrays["energies"], arrays["durations"],
        model, lambda_f=cfg.train.loss.lambda_f,
        pitch_feature_level=pp.pitch.feature, energy_feature_level=pp.energy.feature,
    )


def trainable(model) -> List[torch.nn.Parameter]:
    return [p for p in model.parameters() if p.requires_grad]


def make_train_step(cfg: Config):
    """fn(state, arrays) -> (losses, grads): one step in place on
    ``state``. The losses stay on the device (no host sync); the
    gradients, in ``trainable(state.model)`` order, are the ones the
    update applied."""
    seed = cfg.train.seed + 1

    def step(state: TrainState, arrays: Dict):
        rng = DropoutRNG(seed * 1_000_003 + state.step, arrays["texts"].device)
        losses = compute_losses(state.model, cfg, arrays, deterministic=False, rng=rng)
        grads = torch.autograd.grad(losses["total_loss"], trainable(state.model))
        state.optimizer.update(grads)
        state.step += 1
        return {k: v.detach() for k, v in losses.items()}, grads

    return step


def make_eval_step(cfg: Config):
    """fn(state, arrays) -> losses: the teacher-forced loss, deterministic."""

    @torch.no_grad()
    def step(state: TrainState, arrays: Dict):
        return compute_losses(state.model, cfg, arrays, deterministic=True)

    return step


def evaluate(eval_step, state, batches: Iterator, device) -> Dict[str, float]:
    """Batch-size-weighted mean of every loss over a val pass."""
    sums: Dict[str, torch.Tensor] = {}
    count = 0
    for batch in batches:
        losses = eval_step(state, to_device(batch.arrays(), device))
        count += batch.n_real
        for k, v in losses.items():
            sums[k] = sums.get(k, 0.0) + v * batch.n_real
    return {k: float(v) / count for k, v in sums.items()} if count else {}


def batch_streams(cfg: Config, start_step: int = 0):
    """(the endless stream of training batches from ``start_step``, the val
    batcher): bucketed batches of ``train.txt`` (sorted, last partial batch
    dropped) and ``val.txt``, cut as the JAX package's loop cuts them."""
    from speakingstyle_torch.data.dataset import BucketedBatcher, SpeechDataset

    max_len = cfg.model.max_seq_len
    train = BucketedBatcher(SpeechDataset("train.txt", cfg, sort=True, drop_last=True),
                            max_src=max_len, max_mel=max_len, seed=cfg.train.seed + start_step)
    val = BucketedBatcher(SpeechDataset("val.txt", cfg, sort=False, drop_last=False),
                          max_src=max_len, max_mel=max_len, seed=0)
    return iter(train), val


def build_state(cfg: Config, device) -> TrainState:
    """The model from the config and the corpus stats, seeded random
    weights (``train.seed``), on ``device``, and its optimizer."""
    from speakingstyle_torch.models.factory import build_model, init_weights
    from speakingstyle_torch.training.optim import Optimizer

    model = init_weights(build_model(cfg), cfg.train.seed).to(device)
    return TrainState(step=0, model=model, optimizer=Optimizer(trainable(model), cfg.train))


class TrainLogger:
    """Append-only ``log.txt`` under the log path."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.txt = open(os.path.join(log_dir, "log.txt"), "a")

    def log(self, step: int, losses: Dict[str, float], prefix: str = "train",
            lr: Optional[float] = None, timing: Optional[Dict[str, float]] = None):
        msg = f"[{prefix}] Step {step}, " + ", ".join(f"{k}: {v:.4f}" for k, v in losses.items())
        if lr is not None:
            msg += f", lr: {lr:.6f}"
        for k, v in (timing or {}).items():
            msg += f", {k}: {v:.6g}"
        self.txt.write(msg + "\n")
        self.txt.flush()

    def close(self):
        self.txt.close()


def run_training(cfg: Config, device=None, restore_step: Optional[int] = None,
                 max_steps: Optional[int] = None, log: bool = True) -> TrainState:
    """The step loop; returns the final TrainState. ``max_steps`` overrides
    ``total_step``; ``restore_step`` -1 (or None after a 0 from the CLI)
    resumes from the latest checkpoint, N > 0 from step N. Each train step
    runs inside a ``train.step`` profiler range."""
    from speakingstyle_torch.device import resolve_device
    from speakingstyle_torch.training.checkpoint import CheckpointManager

    device = resolve_device(device)
    check_train_supported(cfg.train,
                          torch.cuda.device_count() if device.type == "cuda" else 1)
    steps = cfg.train.step
    total_step = max_steps if max_steps is not None else steps.total_step
    state = build_state(cfg, device)
    ckpt = CheckpointManager(cfg.train.path.ckpt_path, cfg.train.resilience.max_to_keep)
    if restore_step is not None:
        ckpt.restore(state, step=restore_step if restore_step > 0 else None,
                     ignore_layers=cfg.train.ignore_layers)
    train_step, eval_step = make_train_step(cfg), make_eval_step(cfg)
    start_step = state.step
    stream, val_batcher = batch_streams(cfg, start_step)
    logger = TrainLogger(cfg.train.path.log_path) if log else None
    last_saved = None
    window_t0, window_step0, window_frames = time.perf_counter(), state.step, 0
    window_wait = window_compute = 0.0
    try:
        while state.step < total_step:
            t_iter = time.perf_counter()
            batch = next(stream)
            arrays = to_device(batch.arrays(), device)
            data_wait = time.perf_counter() - t_iter
            lr = state.optimizer.lr()
            with record_function("train.step"):
                losses, _ = train_step(state, arrays)
            window_wait += data_wait
            window_compute += time.perf_counter() - t_iter - data_wait
            window_frames += int(batch.mel_lens.sum())
            if state.step % steps.log_step == 0 and logger:
                t_sync = time.perf_counter()
                host = {k: float(v) for k, v in losses.items()}  # the one sync
                window_compute += time.perf_counter() - t_sync
                n = state.step - window_step0
                dt = time.perf_counter() - window_t0
                logger.log(state.step, host, lr=lr, timing={
                    "train_step_seconds": window_compute / n,
                    "train_data_wait_seconds": window_wait / n,
                    "mel_frames_per_sec": window_frames / dt,
                })
                window_t0, window_step0, window_frames = time.perf_counter(), state.step, 0
                window_wait = window_compute = 0.0
            if state.step % steps.val_step == 0:
                val = evaluate(eval_step, state, val_batcher.epoch(shuffle=False), device)
                if logger:
                    logger.log(state.step, val, prefix="val")
            if state.step % steps.save_step == 0:
                ckpt.save(state.step, state)
                last_saved = state.step
        if state.step > start_step and last_saved != state.step:
            ckpt.save(state.step, state)  # the final flush
    finally:
        if logger:
            logger.close()
    return state
