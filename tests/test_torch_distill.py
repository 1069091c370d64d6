"""PyTorch port, teacher -> student distillation, on the CPU: the student's
config and the synthetic batches against the JAX package's, one distill
step against ``make_distill_step`` from the same weights (the tiny model of
test_torch_training.py, every dropout off, the kernels on both sides: the
JAX Pallas kernels in interpret mode, the port's plain versions), the
zero gradients of the grafted reference encoder, and ``run_distillation``'s
drills and student checkpoint.

Tolerances: losses 1e-5 relative; updated parameters and BatchNorm
statistics 1e-5 (absolute and relative), except elements whose gradient is
at rounding level, held to 2 lr (the rule of test_torch_training.py).
"""

import copy
import dataclasses
import re

import jax
import numpy as np
import pytest
import torch

from speakingstyle_torch.compat.from_jax import load_flax_variables, to_flax_tree

from test_torch_training import (  # noqa: F401 (fixtures)
    NOISE_SHARE, corpus, load_both, no_jax_postnet_dropout, write_configs,
)
from torch_threads import no_tensorflow, one_cpu_thread  # noqa: F401 (fixtures)

pytestmark = pytest.mark.usefixtures("no_tensorflow")

SRC, T_MEL, BATCH = 8, 24, 3
DURATION_BIAS = 1.1  # the JAX tests' trick: a random teacher predicts ~2 frames a phoneme


@pytest.mark.parametrize("preset", ["LJSpeech", "LJSpeech_paper", "AISHELL3", "BC2013",
                                    "LibriTTS"])
def test_student_config_matches_jax(preset):
    from speakingstyle_torch.configs.config import load_config as t_load
    from speakingstyle_torch.training.distill import student_config as t_student
    from speakingstyle_tpu.configs.config import load_config as j_load
    from speakingstyle_tpu.training.distill import student_config as j_student

    t, j = t_student(t_load(preset=preset)), j_student(j_load(preset=preset))
    t_model, j_model = dataclasses.asdict(t.model), dataclasses.asdict(j.model)
    assert set(j_model) <= set(t_model)
    for k, v in j_model.items():
        assert t_model[k] == v, k
    tf = t.model.transformer
    assert tf.conv_filter_size == j.model.transformer.conv_filter_size
    assert (tf.encoder_layer, tf.decoder_layer) == (j.model.transformer.encoder_layer,
                                                    j.model.transformer.decoder_layer)


def test_distill_batches_equal_jax():
    from speakingstyle_torch.configs.config import load_config as t_load
    from speakingstyle_torch.training.distill import make_distill_batch as t_batch
    from speakingstyle_tpu.configs.config import load_config as j_load
    from speakingstyle_tpu.training.distill import make_distill_batch as j_batch

    tcfg, jcfg = t_load(preset="LJSpeech"), j_load(preset="LJSpeech")
    tr, jr = np.random.default_rng(4), np.random.default_rng(4)
    for _ in range(3):
        t, j = t_batch(tcfg, tr, 5, 12), j_batch(jcfg, jr, 5, 12)
        assert t.keys() == j.keys()
        for k in j:
            assert t[k].dtype == j[k].dtype, k
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)


def jax_teacher_and_student(jcfg):
    """JAX variables of a biased teacher and of a student with the
    teacher's reference encoder grafted in (a copy)."""
    from speakingstyle_tpu.models.factory import build_model, init_variables
    from speakingstyle_tpu.training.distill import student_config

    t_model = build_model(jcfg)
    t_vars = jax.device_get(init_variables(t_model, jcfg, jax.random.PRNGKey(3)))
    t_vars["params"]["variance_adaptor"]["duration_predictor"]["linear_layer"]["bias"] = (
        t_vars["params"]["variance_adaptor"]["duration_predictor"]["linear_layer"]["bias"]
        + DURATION_BIAS)
    s_cfg = student_config(jcfg)
    s_model = build_model(s_cfg)
    s_vars = jax.device_get(init_variables(s_model, s_cfg, jax.random.PRNGKey(5)))
    s_vars["params"]["reference_encoder"] = copy.deepcopy(t_vars["params"]["reference_encoder"])
    return t_model, t_vars, s_model, s_vars


def recording_grads(monkeypatch):
    """Record the gradients of every ``apply_gradients`` call."""
    from speakingstyle_torch.training import trainer

    seen = []
    apply = trainer.apply_gradients

    def wrapped(state, losses, nan_sentinel):
        out = apply(state, losses, nan_sentinel)
        seen.append(out[1])
        return out

    monkeypatch.setattr(trainer, "apply_gradients", wrapped)
    return seen


def test_one_distill_step_matches_jax(tmp_path, corpus, no_jax_postnet_dropout,  # noqa: F811
                                      monkeypatch):
    """One distill step from the same teacher, student and batch: the
    losses and the student's updated parameters and BatchNorm statistics.
    The grafted encoder's gradient is zero on both sides, so it stays
    bit-equal to the teacher's."""
    from speakingstyle_torch.models.factory import build_model as t_build
    from speakingstyle_torch.training.distill import (
        batch_tensors, make_distill_batch as t_batch, make_distill_step as t_make,
        student_config as t_student,
    )
    from speakingstyle_torch.training.optim import Optimizer
    from speakingstyle_torch.training.state import TrainState as TState
    from speakingstyle_torch.training.trainer import trainable
    from speakingstyle_tpu.training.distill import (
        make_distill_batch as j_batch, make_distill_step as j_make,
    )
    from speakingstyle_tpu.training.optim import make_optimizer
    from speakingstyle_tpu.training.state import TrainState as JState

    jcfg, tcfg = load_both(write_configs(tmp_path, corpus))
    t_model, t_vars, s_model, s_vars = jax_teacher_and_student(jcfg)
    tx = make_optimizer(jcfg.train)
    j_state = JState.create(s_vars, tx)
    arrays = j_batch(jcfg, np.random.default_rng(0), BATCH, SRC)
    j_state, j_losses = j_make(s_model, t_model, t_vars, tx, jcfg, T_MEL)(
        j_state, arrays, jax.random.PRNGKey(jcfg.train.seed + 4))

    teacher = load_flax_variables(t_build(tcfg), copy.deepcopy(t_vars))
    s_cfg = t_student(tcfg)
    student = load_flax_variables(t_build(s_cfg), copy.deepcopy(s_vars))
    student.postnet.dropout = 0.0
    state = TState(0, student, Optimizer(trainable(student), s_cfg.train))
    grads = recording_grads(monkeypatch)
    t_arrays = t_batch(tcfg, np.random.default_rng(0), BATCH, SRC)
    losses = t_make(teacher, tcfg, T_MEL)(state, batch_tensors(t_arrays, "cpu"))
    assert state.step == 1 and bool(losses["_finite"])
    for k, v in j_losses.items():
        if k != "_finite":
            np.testing.assert_allclose(float(losses[k]), float(v), rtol=1e-5, err_msg=k)

    g = to_flax_tree(student, dict(zip(map(id, trainable(student)), grads[0])))["params"]
    lr = state.optimizer.schedule(0)
    got, want = to_flax_tree(student), jax.device_get({"params": j_state.params,
                                                       "batch_stats": j_state.batch_stats})
    flat = lambda tree: {jax.tree_util.keystr(p): np.asarray(v) for p, v in
                         jax.tree_util.tree_flatten_with_path(tree)[0]}
    g_flat = flat(g)
    top = max(np.abs(a).max() for a in g_flat.values())
    for coll in ("params", "batch_stats"):
        gf, wf = flat(got[coll]), flat(want[coll])
        assert gf.keys() == wf.keys()
        for k, w in wf.items():
            a = gf[k]
            if coll == "params":
                noise = np.abs(g_flat[k]) <= NOISE_SHARE * top
                np.testing.assert_allclose(a[noise], w[noise], atol=2 * lr, err_msg=k)
                a, w = a[~noise], w[~noise]
            np.testing.assert_allclose(a, w, atol=1e-5, rtol=1e-5, err_msg=f"{coll} {k}")
    ref = flat(g["reference_encoder"])
    assert ref and all((v == 0).all() for v in ref.values())
    for k, v in flat(t_vars["params"]["reference_encoder"]).items():
        np.testing.assert_array_equal(flat(got["params"]["reference_encoder"])[k], v)


def distill_cfg(tmp_path, corpus, **train):  # noqa: F811
    """The tiny model's config with a short lr ramp, a log line and a
    checkpoint every 2 steps."""
    from speakingstyle_torch.configs.config import load_config

    step = dict({"log_step": 2, "save_step": 2}, **train.pop("step", {}))
    paths = write_configs(tmp_path, corpus, step=step, loss={"anneal_steps": 5}, **train)
    return load_config(paths["preprocess"], paths["model"], paths["train"])


def biased_teacher(cfg):
    from speakingstyle_torch.models.factory import build_model, init_weights

    teacher = init_weights(build_model(cfg), 3)
    with torch.no_grad():
        teacher.variance_adaptor.duration_predictor.linear_layer.bias.add_(DURATION_BIAS)
    return teacher


def test_grafted_encoder_gets_zero_gradients_and_is_a_copy(tmp_path, corpus,  # noqa: F811
                                                           monkeypatch):
    """Through ``run_distillation``: every step's gradient of the student's
    reference encoder is zero (``apply_gradients`` materialises them), the
    encoder stays bit-equal to the teacher's, shares no storage with it,
    and the teacher's weights do not change."""
    from speakingstyle_torch.obs import MetricsRegistry
    from speakingstyle_torch.training.distill import run_distillation
    from speakingstyle_torch.training.trainer import trainable

    cfg = distill_cfg(tmp_path, corpus)
    teacher = biased_teacher(cfg)
    before = {k: v.clone() for k, v in teacher.state_dict().items()}
    grads = recording_grads(monkeypatch)
    state, s_cfg = run_distillation(cfg, teacher=teacher, max_steps=4, batch_size=BATCH,
                                    src_len=SRC, log=False, registry=MetricsRegistry(),
                                    device="cpu")
    assert state.step == 4 and len(grads) == 4
    params = trainable(state.model)
    ref_ids = {id(p) for p in state.model.reference_encoder.parameters()}
    assert ref_ids and {id(p) for p in params} >= ref_ids
    for step_grads in grads:
        for p, gr in zip(params, step_grads):
            if id(p) in ref_ids:
                assert gr.shape == p.shape and not gr.any()
    t_ref, s_ref = (m.reference_encoder.state_dict() for m in (teacher, state.model))
    assert t_ref.keys() == s_ref.keys()
    for k in t_ref:
        assert torch.equal(t_ref[k], s_ref[k]), k
        assert t_ref[k].data_ptr() != s_ref[k].data_ptr(), k
    teacher_ptrs = {t.data_ptr() for t in teacher.state_dict().values()}
    assert not teacher_ptrs & {t.data_ptr() for t in state.model.state_dict().values()}
    for k, v in teacher.state_dict().items():
        assert torch.equal(v, before[k]), k
    n = lambda m: sum(p.numel() for p in m.parameters())
    assert n(state.model) < n(teacher)
    assert s_cfg.model.transformer.conv_filter_size == cfg.model.transformer.conv_filter_size // 2


def test_run_distillation_drills_and_restores_the_student(tmp_path, corpus,  # noqa: F811
                                                          monkeypatch):
    """``nan_grads@2`` (before any checkpoint) rolls back to the fresh
    student once; ``sigterm@5`` ends the run at step 5 with a flushed
    checkpoint under <ckpt_path>/student; the counters and events record
    both; the student restores through ``CheckpointManager``; the loss
    falls over a clean run."""
    import os

    from speakingstyle_torch.models.factory import build_model
    from speakingstyle_torch.obs import MetricsRegistry, read_events
    from speakingstyle_torch.training.checkpoint import CheckpointManager
    from speakingstyle_torch.training.distill import STUDENT_SUBDIR, run_distillation
    from speakingstyle_torch.training.optim import Optimizer
    from speakingstyle_torch.training.state import TrainState
    from speakingstyle_torch.training.trainer import trainable

    cfg = distill_cfg(tmp_path, corpus)
    registry = MetricsRegistry()
    monkeypatch.setenv("SPEAKINGSTYLE_FAULTS", "nan_grads@2;sigterm@5")
    state, s_cfg = run_distillation(cfg, teacher=biased_teacher(cfg), max_steps=8,
                                    batch_size=BATCH, src_len=SRC, registry=registry,
                                    device="cpu")
    assert state.step == 5
    assert registry.counter("train_rollbacks_total").value == 1
    assert registry.counter("distill_steps_total").value == 7  # 1, 2 rolled back, then 1..5
    events = [e["event"] for e in read_events(cfg.train.path.log_path)]
    for name in ("distill_start", "fault_fire", "rollback", "distill_end"):
        assert name in events, name
    ckpt = CheckpointManager(os.path.join(cfg.train.path.ckpt_path, STUDENT_SUBDIR))
    assert ckpt.latest_step() == 5
    model = build_model(s_cfg)
    restored = TrainState(0, model, Optimizer(trainable(model), s_cfg.train))
    ckpt.restore(restored)
    assert restored.step == 5
    for (k, a), b in zip(state.model.state_dict().items(), model.state_dict().values()):
        assert torch.equal(a, b), k

    monkeypatch.delenv("SPEAKINGSTYLE_FAULTS")
    (tmp_path / "clean").mkdir()
    clean = distill_cfg(tmp_path / "clean", corpus, step={"log_step": 1, "save_step": 100})
    run_distillation(clean, teacher=biased_teacher(clean), max_steps=12, batch_size=BATCH,
                     src_len=SRC, registry=MetricsRegistry(), device="cpu")
    losses = {}
    with open(os.path.join(clean.train.path.log_path, "log.txt")) as fh:
        for line in fh:
            m = re.match(r"\[distill\] Step (\d+), total_loss: ([-\d.e+]+|nan)", line)
            if m:
                losses[int(m[1])] = float(m[2])
    assert sorted(losses) == list(range(1, 13))
    assert np.mean([losses[s] for s in (10, 11, 12)]) < np.mean([losses[s] for s in (1, 2, 3)])
