"""Teacher -> student distillation of the acoustic model (JAX counterpart:
speakingstyle_tpu/training/distill.py, one device).

The fast tier's weights: a student FastSpeech2 with the encoder / decoder
depth, the FFN width and the postnet width halved (``student_config``),
trained to match a frozen teacher. Data-free: each step draws seeded
synthetic phoneme batches and FiLM vectors (``make_distill_batch``), then

1. the teacher free-runs the batch under ``torch.no_grad()``
   (``deterministic=True``), giving mel, durations, pitch and energy;
2. the student runs teacher-forced on the teacher's durations, pitch and
   energy (so both mels align frame for frame) and ``fastspeech2_loss``
   scores it against the teacher's postnet mel; one optimizer update
   (``trainer.apply_gradients``, the train step's).

The student's reference encoder is a copy of the teacher's (the loop feeds
sampled FiLM vectors, so the student never runs its own encoder: it gets
zero gradients and stays equal to the teacher's, and one style vector
serves both tiers). The resilience stack is the trainer's:
``SPEAKINGSTYLE_FAULTS`` ``nan_grads`` (the FiLM inputs poisoned) and
``sigterm``, the NaN sentinel and ``RollbackGuard``, and student
checkpoints under ``<ckpt_path>/student`` through ``CheckpointManager``.
"""

import dataclasses
import os
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from speakingstyle_torch.configs.config import Config

__all__ = ["STUDENT_SUBDIR", "make_distill_batch", "make_distill_step", "run_distillation",
           "student_config"]

# where the student checkpoints live relative to train.path.ckpt_path:
# a sibling model version, not a new step range of the teacher's
STUDENT_SUBDIR = "student"


def student_config(cfg: Config) -> Config:
    """The student's Config: encoder / decoder depth, FFN filter and
    postnet width halved (floored at 1), postnet depth halved (floored at
    2). The model dims and the variance-predictor filter stay: FiLM
    broadcasts [B, 1, d] gamma / beta onto those streams, so they are the
    style interface the student shares with the teacher."""
    tf = cfg.model.transformer

    def half(n: int) -> int:
        return max(1, n // 2)

    student_tf = dataclasses.replace(
        tf, encoder_layer=half(tf.encoder_layer), decoder_layer=half(tf.decoder_layer),
        conv_filter_size=half(tf.conv_filter_size))
    model = dataclasses.replace(
        cfg.model, transformer=student_tf,
        postnet_embedding_dim=half(cfg.model.postnet_embedding_dim),
        # floor 2: a 1-layer postnet is one mel -> mel conv, WIDER than two narrow ones
        postnet_layers=max(2, cfg.model.postnet_layers // 2))
    return dataclasses.replace(cfg, model=model)


def make_distill_batch(cfg: Config, rng: np.random.Generator, batch_size: int,
                       src_len: int, style_scale: float = 0.1) -> Dict[str, np.ndarray]:
    """One seeded synthetic batch: phoneme ids, then gamma, then beta
    drawn from ``rng`` (the JAX package's draws, in its order), every row
    full length. The shapes are the same every step."""
    d = cfg.model.reference_encoder.encoder_hidden
    return {
        "speakers": np.zeros((batch_size,), np.int32),
        "texts": rng.integers(1, 300, (batch_size, src_len)).astype(np.int32),
        "src_lens": np.full((batch_size,), src_len, np.int32),
        "gammas": (style_scale * rng.standard_normal((batch_size, 1, d))).astype(np.float32),
        "betas": (style_scale * rng.standard_normal((batch_size, 1, d))).astype(np.float32),
    }


def poison_distill_batch(arrays: Dict) -> Dict:
    """The ``nan_grads`` drill of the data-free loop: NaN FiLM inputs drive
    every loss and gradient non-finite through the real forward and
    backward (there are no mel targets to poison)."""
    out = dict(arrays)
    out["gammas"] = out["gammas"] * np.float32(np.nan)
    return out


def batch_tensors(arrays: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A distill batch on ``device``: ids and lengths int64, FiLM float32."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(
        device, torch.float32 if k in ("gammas", "betas") else torch.int64)
        for k, v in arrays.items()}


def _inputs(cfg: Config, arrays: Dict[str, torch.Tensor], max_mel_len: int) -> Dict:
    style = cfg.model.use_reference_encoder
    return dict(speakers=arrays["speakers"], texts=arrays["texts"], src_lens=arrays["src_lens"],
                mels=None, max_mel_len=max_mel_len,
                gammas=arrays["gammas"] if style else None,
                betas=arrays["betas"] if style else None)


def teacher_targets(teacher, cfg: Config, arrays: Dict[str, torch.Tensor],
                    max_mel_len: int) -> Dict[str, torch.Tensor]:
    """The frozen teacher's free-running outputs (``deterministic=True``,
    no gradient): the student's mel, duration, pitch and energy targets."""
    with torch.no_grad():
        return teacher(mel_lens=None, deterministic=True, **_inputs(cfg, arrays, max_mel_len))


def student_losses(student, cfg: Config, arrays: Dict[str, torch.Tensor], t_out: Dict,
                   max_mel_len: int, rng=None) -> Dict[str, torch.Tensor]:
    """The student teacher-forced on the teacher's durations, pitch and
    energy (so both mels align frame for frame), in training mode, scored by
    ``fastspeech2_loss`` against the teacher's postnet mel."""
    from speakingstyle_torch.models.loss import fastspeech2_loss

    pp = cfg.preprocess.preprocessing
    s_out = student(mel_lens=t_out["mel_lens"], p_targets=t_out["pitch_prediction"],
                    e_targets=t_out["energy_prediction"], d_targets=t_out["durations"],
                    deterministic=False, rng=rng, **_inputs(cfg, arrays, max_mel_len))
    return fastspeech2_loss(
        s_out, t_out["mel_postnet"], t_out["pitch_prediction"], t_out["energy_prediction"],
        t_out["durations"], student, lambda_f=cfg.train.loss.lambda_f,
        pitch_feature_level=pp.pitch.feature, energy_feature_level=pp.energy.feature)


def make_distill_step(teacher, cfg: Config, max_mel_len: int):
    """fn(state, tensors) -> losses: one distill step in place on
    ``state`` (the student's TrainState). Dropout draws from
    ``DropoutRNG((train.seed + 4) * 1_000_003 + step)``. The losses stay on
    the device and carry ``_finite`` under
    ``train.resilience.nan_sentinel``."""
    from speakingstyle_torch.ops.dropout import DropoutRNG
    from speakingstyle_torch.training.trainer import apply_gradients

    seed = cfg.train.seed + 4

    def step(state, arrays: Dict[str, torch.Tensor]):
        t_out = teacher_targets(teacher, cfg, arrays, max_mel_len)
        rng = DropoutRNG(seed * 1_000_003 + state.step, arrays["texts"].device)
        losses = student_losses(state.model, cfg, arrays, t_out, max_mel_len, rng)
        return apply_gradients(state, losses, cfg.train.resilience.nan_sentinel)[0]

    return step


def fresh_teacher(cfg: Config):
    from speakingstyle_torch.models.factory import build_model, init_weights

    return init_weights(build_model(cfg), cfg.train.seed)


def run_distillation(cfg: Config, teacher=None, max_steps: Optional[int] = None,
                     batch_size: int = 8, src_len: Optional[int] = None, log: bool = True,
                     registry=None, ckpt_dir: Optional[str] = None,
                     device=None) -> Tuple[object, Config]:
    """The distillation loop; returns (the student's TrainState, its Config).

    ``teacher=None`` restores the latest teacher checkpoint of
    ``train.path.ckpt_path`` (manifest-verified), falling back to a seeded
    fresh teacher, with a warning, where there is none. Student
    checkpoints go to ``ckpt_dir`` (default ``<ckpt_path>/student``),
    async and keep-best per ``train.resilience``, with a final blocking
    save. The registry counts ``distill_steps_total`` and
    ``train_rollbacks_total`` and times ``distill_step_seconds``;
    ``<log_path>/log.txt`` gets ``[distill]`` lines and events.jsonl
    ``distill_start``, ``fault_fire``, ``rollback`` and ``distill_end``."""
    from speakingstyle_torch import obs
    from speakingstyle_torch.device import resolve_device
    from speakingstyle_torch.models.factory import build_model, init_weights
    from speakingstyle_torch.training import faults, resilience
    from speakingstyle_torch.training.checkpoint import CheckpointManager
    from speakingstyle_torch.training.optim import Optimizer
    from speakingstyle_torch.training.state import TrainState
    from speakingstyle_torch.training.trainer import TrainLogger, public_losses, trainable

    device = resolve_device(device)
    res, steps_cfg = cfg.train.resilience, cfg.train.step
    total_step = max_steps if max_steps is not None else steps_cfg.total_step
    plan = faults.FaultPlan.from_env()
    registry = registry if registry is not None else obs.get_registry()

    if teacher is None:
        teacher = build_model(cfg)
        try:
            CheckpointManager(cfg.train.path.ckpt_path,
                              registry=registry).restore_weights(teacher)
        except FileNotFoundError:
            print(f"warning: no teacher checkpoint under {cfg.train.path.ckpt_path}; "
                  "distilling against a seeded fresh teacher (smoke mode)")
            teacher = fresh_teacher(cfg)
    teacher = teacher.to(device).requires_grad_(False)

    s_cfg = student_config(cfg)

    def fresh_student() -> TrainState:
        """Seeded student with the teacher's reference encoder grafted in,
        COPIED into the student's own tensors (never aliased or shared as
        a module)."""
        model = init_weights(build_model(s_cfg), cfg.train.seed + 2)
        if cfg.model.use_reference_encoder:
            model.reference_encoder.load_state_dict(teacher.reference_encoder.state_dict())
        model = model.to(device)
        return TrainState(step=0, model=model,
                          optimizer=Optimizer(trainable(model), s_cfg.train))

    state = fresh_student()
    src = src_len if src_len is not None else min(cfg.serve.src_buckets[0], 12)
    t_mel = min(src * cfg.serve.frames_per_phoneme, cfg.model.max_seq_len)
    distill_step = make_distill_step(teacher, cfg, t_mel)

    events = (obs.JsonlEventLog(cfg.train.path.log_path, max_bytes=cfg.train.obs.events_max_bytes,
                                keep=cfg.train.obs.events_keep)
              if log and cfg.train.obs.events else None)
    logger = TrainLogger(cfg.train.path.log_path, registry=registry, events=events) if log \
        else None
    ckpt = CheckpointManager(ckpt_dir or os.path.join(cfg.train.path.ckpt_path, STUDENT_SUBDIR),
                             max_to_keep=res.max_to_keep or None,
                             async_save=res.async_checkpointing, keep_best=res.keep_best,
                             fault_plan=plan, events=events, registry=registry)
    guard = resilience.RollbackGuard(res.max_rollbacks)
    if logger:
        logger.event("distill_start", total_step=total_step, batch_size=batch_size,
                     src_len=src, max_mel_len=t_mel, teacher_subdir="",
                     student_subdir=STUDENT_SUBDIR)
    steps_ctr = registry.counter("distill_steps_total", help="student optimizer steps run")
    rollback_ctr = registry.counter("train_rollbacks_total",
                                    help="NaN-sentinel rollbacks taken")
    step_hist = registry.histogram("distill_step_seconds",
                                   help="per-step wall time of the distill step")

    batch_rng = np.random.default_rng(cfg.train.seed + 3)
    step = state.step
    last_loss: Optional[float] = None
    shutdown = resilience.GracefulShutdown()
    try:
        with shutdown:
            while step < total_step and not shutdown.requested:
                arrays = make_distill_batch(cfg, batch_rng, batch_size, src)
                if plan.fire("nan_grads", step + 1):
                    arrays = poison_distill_batch(arrays)
                    if logger:
                        logger.note(f"[fault] nan_grads fired at step {step + 1} "
                                    "(FiLM inputs poisoned)")
                        logger.event("fault_fire", kind="nan_grads", step=step + 1)
                t0 = time.perf_counter()
                losses = distill_step(state, batch_tensors(arrays, device))
                step = state.step
                steps_ctr.inc()
                step_hist.observe(time.perf_counter() - t0)
                if plan.fire("sigterm", step):
                    if logger:
                        logger.event("fault_fire", kind="sigterm", step=step)
                    faults.deliver_sigterm()
                if step % steps_cfg.log_step == 0 or step >= total_step:
                    if "_finite" in losses and not bool(losses["_finite"]):
                        n = guard.trip(step)  # raises past max_rollbacks
                        ckpt.wait()
                        good = ckpt.latest_step()
                        rollback_ctr.inc()
                        if logger:
                            logger.note(f"[resilience] non-finite loss/grads at step {step}; "
                                        f"rollback {n}/{res.max_rollbacks} to step {good}")
                            logger.event("rollback", step=step, rollback_n=n,
                                         restore_step=good)
                        if good is not None:
                            ckpt.restore(state, step=good)
                        else:  # no good checkpoint yet: the same seed, the same graft
                            state = fresh_student()
                        step = state.step
                        continue
                    guard.ok()
                    host = {k: float(v) for k, v in public_losses(losses).items()}
                    last_loss = host["total_loss"]
                    if logger:
                        logger.log(step, host, prefix="distill")
                if step % steps_cfg.save_step == 0:
                    ckpt.save(step, state, val_loss=last_loss)
    finally:
        # the student checkpoint is the artifact: always flush a final
        # verified save, preemption included
        ckpt.save(step, state, val_loss=last_loss, block=True)
        if logger:
            logger.event("distill_end", step=step, loss=last_loss)
            logger.close()
        ckpt.close()
    return state, s_cfg
