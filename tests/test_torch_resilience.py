"""PyTorch port, the training path's resilience: the twins of
tests/test_resilience.py (fault plans, retries, quarantine, the signal
flush, the NaN sentinel, the prefetcher's shutdown contract, async and
keep-best checkpoints, the restore walk, the drills through
``run_training``), and the pieces held against the JAX package on the same
inputs: ``FaultPlan.parse``, ``all_finite``, ``grad_reverse``, the plain
conv on NaN input, and a ``nan_grads`` drill through both packages'
``run_training`` (same rollback, same batches after it, losses within
1e-5 relative as in the three-step comparison of test_torch_training.py).
"""

import copy
import dataclasses
import os
import signal
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speakingstyle_torch.configs.config import load_config
from speakingstyle_torch.data.dataset import BucketedBatcher, SpeechDataset
from speakingstyle_torch.data.prefetch import DevicePrefetcher
from speakingstyle_torch.obs import JsonlEventLog, MetricsRegistry, read_events
from speakingstyle_torch.training import faults
from speakingstyle_torch.training.checkpoint import CheckpointCorruptError, CheckpointManager
from speakingstyle_torch.training.faults import FaultPlan
from speakingstyle_torch.training.resilience import (
    BadSampleBudgetError, GracefulShutdown, Quarantine, RollbackGuard, TrainingDivergedError,
    all_finite, retry_io,
)
from speakingstyle_torch.training.trainer import build_state, run_training

from test_torch_training import (  # noqa: F401 (fixtures)
    LIBRARY_MODEL, corpus, load_both, no_jax_postnet_dropout, write_configs,
)
from torch_threads import no_tensorflow, one_cpu_thread  # noqa: F401 (fixtures)

pytestmark = pytest.mark.usefixtures("no_tensorflow")
CPU = torch.device("cpu")


# ---------------------------------------------------------------- units


def test_fault_plan_grammar_matches_jax():
    from speakingstyle_tpu.faults import KINDS, FaultPlan as JPlan

    spec = "loader_ioerror@7; nan_grads@12;sigterm@20;" + ";".join(f"{k}@1" for k in KINDS)
    assert FaultPlan.parse(spec).pending() == JPlan.parse(spec).pending()
    plan = FaultPlan.parse("loader_ioerror@7; nan_grads@12;sigterm@20")
    assert not plan.fire("nan_grads", 11) and plan.fire("nan_grads", 12)
    assert not plan.fire("nan_grads", 12)  # exactly once
    assert plan.pending() == [("loader_ioerror", 7), ("sigterm", 20)]
    assert not FaultPlan.parse("")
    dup = FaultPlan.parse("nan_grads@3;nan_grads@3")  # the replay is poisoned too
    assert dup.fire("nan_grads", 3) and dup.fire("nan_grads", 3)
    assert not dup.fire("nan_grads", 3)


@pytest.mark.parametrize("bad", ["nan_grads", "nan_grads@x", "typo@3"])
def test_fault_plan_rejects_bad_specs(bad):
    from speakingstyle_tpu.faults import FaultPlan as JPlan

    for parse in (FaultPlan.parse, JPlan.parse):
        with pytest.raises(ValueError):
            parse(bad)


def test_fault_plan_from_env(monkeypatch):
    monkeypatch.setenv(faults.ENV_VAR, "sigterm@5")
    assert FaultPlan.from_env().pending() == [("sigterm", 5)]
    monkeypatch.delenv(faults.ENV_VAR)
    assert not FaultPlan.from_env()


@pytest.mark.parametrize("fails", [2, 9])
def test_retry_io_backs_off_exponentially_then_propagates(fails):
    calls, sleeps = [], []

    def flaky():
        calls.append(1)
        if len(calls) <= fails:
            raise IOError("transient")
        return "ok"

    if fails > 3:
        with pytest.raises(IOError, match="transient"):
            retry_io(flaky, retries=3, backoff=0.1, sleep=sleeps.append)
        assert len(calls) == 4 and sleeps == [0.1, 0.2, 0.4]
    else:
        assert retry_io(flaky, retries=3, backoff=0.1, sleep=sleeps.append) == "ok"
        assert len(calls) == 3 and sleeps == [0.1, 0.2]  # doubles per attempt


def test_quarantine_budget():
    q = Quarantine(budget=2)
    q.add("a", ValueError("x"))
    q.add("b", ValueError("y"))
    assert len(q) == 2 and "a" in q and "c" not in q
    with pytest.raises(BadSampleBudgetError):
        q.add("c", ValueError("z"))


def test_graceful_shutdown_catches_and_restores():
    before = signal.getsignal(signal.SIGTERM)
    with GracefulShutdown() as s:
        assert s.installed and not s.requested
        os.kill(os.getpid(), signal.SIGTERM)
        assert s.requested and s.signame == "SIGTERM"
    assert signal.getsignal(signal.SIGTERM) is before


@pytest.mark.parametrize("leaves", [
    [np.ones(3, np.float32), np.arange(4)],  # integer leaves are not checked
    [np.ones(3, np.float32), np.array([1.0, np.nan], np.float32)],
    [np.array([np.inf], np.float32)],
    [np.array([-np.inf, 0.0], np.float32), np.float32(2.0)],
    [np.array([1e30, -1e30], np.float32), np.full((3, 2), 3e38, np.float32)],
])
def test_all_finite_matches_jax(leaves):
    """The infinity norm's verdict is JAX's all(isfinite) for every leaf,
    a finite 1e30 (whose L2 norm would overflow) included."""
    from speakingstyle_tpu.training.resilience import all_finite as j_all_finite

    want = bool(j_all_finite({"l": [jnp.asarray(a) for a in leaves[:-1]]},
                             jnp.asarray(leaves[-1])))
    got = all_finite({"l": [torch.from_numpy(np.asarray(a)) for a in leaves[:-1]]},
                     torch.from_numpy(np.asarray(leaves[-1])))
    assert got.dtype == torch.bool and got.shape == () and bool(got) == want


def test_rollback_guard_consecutive_semantics():
    g = RollbackGuard(max_rollbacks=2)
    assert g.trip(10) == 1
    g.ok()  # a finite window resets the count
    assert g.trip(20) == 1 and g.trip(30) == 2
    with pytest.raises(TrainingDivergedError):
        g.trip(40)


def test_poison_batch_nans_only_mels():
    arrays = {"mels": torch.ones(2, 4, 3), "texts": torch.ones(2, 5, dtype=torch.long)}
    out = faults.poison_batch(arrays)
    assert not torch.isfinite(out["mels"]).any() and bool((out["texts"] == 1).all())
    assert torch.isfinite(arrays["mels"]).all()  # the input is untouched
    assert faults.poison_batch(arrays, dp=2)["mels"][1].isfinite().all()


def test_grad_reverse_matches_jax():
    from speakingstyle_tpu.ops.grad_reverse import grad_reverse as j_rev
    from speakingstyle_torch.ops.grad_reverse import grad_reverse

    x = np.random.default_rng(0).standard_normal((3, 4)).astype(np.float32)
    w = np.random.default_rng(1).standard_normal((3, 4)).astype(np.float32)
    want = jax.grad(lambda a: jnp.sum(j_rev(a, 0.5) * w))(jnp.asarray(x))
    t = torch.from_numpy(x).requires_grad_()
    y = grad_reverse(t, 0.5)
    (y * torch.from_numpy(w)).sum().backward()
    np.testing.assert_array_equal(y.detach().numpy(), x)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize("ln", [False, True])
def test_plain_conv_passes_nan_like_jax(ln):
    """A NaN and a +inf in the input come out of the conv's plain version
    (which the CPU runs for the kernel) where JAX's reference puts them:
    the ReLU passes NaN on (jnp.maximum, torch.clamp)."""
    from speakingstyle_tpu.ops.pallas_conv import _reference_fused
    from speakingstyle_torch.ops.fused_conv import fused_conv_plain

    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 12, 8)).astype(np.float32)
    x[0, 3, 1], x[1, 9, 5] = np.nan, np.inf
    k = rng.standard_normal((3, 8, 16)).astype(np.float32)
    b, g, s = (rng.standard_normal(16).astype(np.float32) for _ in range(3))
    ln_args = (g, s) if ln else (None, None)
    want = np.asarray(_reference_fused(*(None if a is None else jnp.asarray(a)
                                         for a in (x, k, b, *ln_args)), 1, True))
    got = fused_conv_plain(*(None if a is None else torch.from_numpy(a)
                             for a in (x, k, b, *ln_args)), relu=True).numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    assert not np.isfinite(got).all()
    np.testing.assert_allclose(got[np.isfinite(got)], want[np.isfinite(want)], atol=1e-5)


def test_event_log_rotates_and_reads_both_packages_records(tmp_path):
    from speakingstyle_tpu.obs.events import JsonlEventLog as JLog

    with JLog(str(tmp_path), max_bytes=200, keep=2) as j:
        j.emit("train_step", step=1, total_loss=np.float32(2.5))
    with JsonlEventLog(str(tmp_path), max_bytes=200, keep=2) as log:
        for i in range(2, 12):
            log.emit("train_step", step=i, total_loss=torch.tensor(1.0 / i))
    files = sorted(os.listdir(tmp_path))
    assert files == ["events.jsonl", "events.jsonl.1", "events.jsonl.2"]
    steps = [r["step"] for r in read_events(str(tmp_path), event="train_step")]
    assert steps == sorted(steps) and steps[-1] == 11 and len(steps) < 11  # oldest rotated out


# ---------------------------------------------------------------- the prefetcher


class _FakeBatch:
    def arrays(self):
        ints = np.zeros((2, 3), np.int32)
        return {"speakers": ints[:, 0], "texts": ints, "src_lens": ints[:, 0],
                "mels": np.zeros((2, 4, 2), np.float32), "mel_lens": ints[:, 0],
                "pitches": ints.astype(np.float32), "energies": ints.astype(np.float32),
                "durations": ints}


def _infinite_batches():
    while True:
        yield _FakeBatch()


def _failing_source():
    yield _FakeBatch()
    raise RuntimeError("loader died")


@pytest.mark.parametrize("case", ["stop_unblocks", "one_terminal_error", "clean_end",
                                  "context_manager"])
def test_prefetcher_shutdown_contract(case):
    if case == "stop_unblocks":  # the worker races to refill a full queue
        pf = DevicePrefetcher(_infinite_batches(), depth=1)
        next(pf)
        pf.stop()
        pf.stop()  # idempotent
    elif case == "one_terminal_error":  # the error IS the terminal item
        pf = DevicePrefetcher(_failing_source(), depth=4)
        _, arrays = next(pf)
        assert arrays["texts"].dtype == torch.int64 and arrays["mels"].dtype == torch.float32
        with pytest.raises(RuntimeError, match="loader died"):
            next(pf)
        with pytest.raises(StopIteration):
            next(pf)
        pf.thread.join(timeout=5.0)
        assert pf.queue.empty()
    elif case == "clean_end":
        pf = DevicePrefetcher(iter([_FakeBatch(), _FakeBatch()]), depth=4)
        assert len(list(pf)) == 2
        with pytest.raises(StopIteration):
            next(pf)
    else:
        with DevicePrefetcher(_infinite_batches(), depth=1) as pf:
            next(pf)
    assert not pf.thread.is_alive()


# ---------------------------------------------------------------- dataset


def _data_config(root, batch_size=8):
    cfg = load_config(preset="LJSpeech")
    pp = dataclasses.replace(cfg.preprocess, path=dataclasses.replace(
        cfg.preprocess.path, preprocessed_path=root))
    tr = dataclasses.replace(cfg.train, optimizer=dataclasses.replace(
        cfg.train.optimizer, batch_size=batch_size))
    return dataclasses.replace(cfg, preprocess=pp, train=tr)


@pytest.mark.parametrize("retries", [0, 2])
def test_loader_retries_an_injected_ioerror(synthetic_preprocessed, retries):
    plan = FaultPlan.parse("loader_ioerror@3")
    ds = SpeechDataset("train.txt", _data_config(synthetic_preprocessed), retries=retries,
                       backoff=0.0, fault_plan=plan)
    if retries:
        assert len([ds[i] for i in range(2)]) == 2 and not plan.pending()
    else:
        with pytest.raises(OSError):
            [ds[i] for i in range(2)]


@pytest.mark.parametrize("quarantine", [True, False])
def test_batcher_quarantines_a_corrupt_sample(synthetic_preprocessed, quarantine):
    with open(os.path.join(synthetic_preprocessed, "mel", "LJSpeech-mel-utt003.npy"), "wb") as f:
        f.write(b"not a numpy file")  # permanently corrupt: retries cannot help
    ds = SpeechDataset("train.txt", _data_config(synthetic_preprocessed))
    if not quarantine:
        with pytest.raises(Exception):
            list(BucketedBatcher(ds, max_src=256, max_mel=256).epoch(shuffle=False))
        return
    q = Quarantine(budget=2)
    batcher = BucketedBatcher(ds, max_src=256, max_mel=256, quarantine=q)
    assert sum(b.n_real for b in batcher.epoch(shuffle=False)) == 9  # 10 less 1
    assert len(q) == 1 and "utt003" in q
    loads = ds._feature_loads  # a second epoch does not load the bad sample again
    assert sum(b.n_real for b in batcher.epoch(shuffle=False)) == 9
    assert ds._feature_loads == loads + 9 * 4
    b0 = BucketedBatcher(ds, max_src=256, max_mel=256, quarantine=Quarantine(budget=0))
    with pytest.raises(BadSampleBudgetError):
        list(b0.epoch(shuffle=False))


# ---------------------------------------------------------------- checkpoints


@pytest.fixture(scope="module")
def tiny_cfg(tmp_path_factory, corpus):  # noqa: F811
    root = tmp_path_factory.mktemp("cfg")
    return load_both(write_configs(root, corpus))[1]


def _state(cfg, step=0, value=None):
    state = build_state(cfg, CPU)
    state.step = state.optimizer.count = step
    if value is not None:
        with torch.no_grad():
            for p in state.model.parameters():
                p.fill_(value)
    return state


def test_async_save_returns_early_and_its_snapshot_is_not_torn(tmp_path, tiny_cfg):
    """save() returns while the write is gated; the parameters and moments
    are then changed in place, as the next step would; the restored state
    is the one at save(), bit for bit."""
    ckpt = CheckpointManager(str(tmp_path / "ck"), async_save=True)
    gate, started = threading.Event(), threading.Event()
    write = ckpt._write

    def gated_write(*args):
        started.set()
        assert gate.wait(timeout=10.0)
        write(*args)

    ckpt._write = gated_write
    state = _state(tiny_cfg, step=1)
    state.optimizer.mu[0].fill_(0.25)
    want = copy.deepcopy(state.state_dict())
    ckpt.save(1, state)
    assert started.wait(timeout=10.0) and ckpt.save_in_flight()
    with torch.no_grad():
        for p in state.model.parameters():
            p.add_(1.0)
        state.optimizer.mu[0].add_(1.0)
    assert ckpt.save_in_flight()  # the loop went on while the write was held
    gate.set()
    ckpt.wait()
    assert not ckpt.save_in_flight() and ckpt.latest_step() == 1
    got = ckpt.restore(_state(tiny_cfg)).state_dict()
    for k, v in want["model"].items():
        assert torch.equal(got["model"][k], v), k
    assert torch.equal(got["optimizer"]["mu"][0], want["optimizer"]["mu"][0])
    assert got["step"] == 1 and got["optimizer"]["count"] == 1


def test_async_save_error_surfaces_on_wait(tmp_path, tiny_cfg):
    ckpt = CheckpointManager(str(tmp_path / "ck"), async_save=True)

    def boom(*args):
        raise RuntimeError("disk full")

    ckpt._write = boom
    ckpt.save(1, _state(tiny_cfg))
    with pytest.raises(RuntimeError, match="disk full"):
        ckpt.wait()


@pytest.mark.parametrize("keep_best", [True, False])
def test_retention_and_keep_best_across_a_restart(tmp_path, tiny_cfg, keep_best):
    root = str(tmp_path / "ck")
    val = {1: 0.5, 2: 0.1, 3: 0.9, 4: 0.8, 5: 0.7}  # best at step 2
    for s in (1, 2, 3):
        CheckpointManager(root, max_to_keep=2, keep_best=keep_best).save(
            s, _state(tiny_cfg, s, float(s)), val_loss=val[s])
    ckpt = CheckpointManager(root, max_to_keep=2, keep_best=keep_best)  # a new process
    for s in (4, 5):
        ckpt.save(s, _state(tiny_cfg, s, float(s)), val_loss=val[s])
    assert ckpt.all_steps() == ([2, 4, 5] if keep_best else [4, 5])
    assert ckpt.best_step() == (2 if keep_best else 5)
    if keep_best:
        restored = ckpt.restore(_state(tiny_cfg), step=2)
        assert restored.step == 2 and bool((restored.model.mel_linear.weight == 2.0).all())


def test_restore_walks_past_a_corrupt_latest_step(tmp_path, tiny_cfg):
    root, events = str(tmp_path / "ck"), JsonlEventLog(str(tmp_path))
    ckpt = CheckpointManager(root, events=events, registry=MetricsRegistry())
    for s in (2, 4, 6):
        ckpt.save(s, _state(tiny_cfg, s))
    with open(os.path.join(root, "6", "state.pt"), "wb") as f:
        f.write(b"torn")  # a crash mid-write
    for name in os.listdir(os.path.join(root, "4")):  # a gutted directory
        os.unlink(os.path.join(root, "4", name))
    assert ckpt.restore(_state(tiny_cfg)).step == 2
    assert [e.step for e in ckpt.skipped] == [6] and ckpt.skipped[0].reason == "state_unreadable"
    assert ckpt.registry.value("ckpt_corrupt_skipped_total") == 1
    events.close()
    assert [r["step"] for r in read_events(str(tmp_path), "ckpt_corrupt_skipped")] == [6]
    with pytest.raises(CheckpointCorruptError):  # an explicit step fails loudly
        ckpt.restore(_state(tiny_cfg), step=6)
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(_state(tiny_cfg))


@pytest.mark.parametrize("spec,strict,restored", [
    ("checkpoint_corrupt@1", True, 2), ("manifest_missing@1", True, 2),
    ("manifest_missing@1", False, 4),
])
def test_checkpoint_fault_kinds(tmp_path, tiny_cfg, spec, strict, restored):
    """The first verification reports step 4 corrupt, or finds its
    manifest absent: the walk falls back to step 2, but for a missing
    manifest under a restore that is not strict (loaded unverified)."""
    ckpt = CheckpointManager(str(tmp_path / "ck"), fault_plan=FaultPlan.parse(spec))
    for s in (2, 4):
        ckpt.save(s, _state(tiny_cfg, s))
    assert ckpt.restore(_state(tiny_cfg), strict=strict).step == restored
    assert ckpt.verify_count == 1 + (restored == 2)


# ---------------------------------------------------------------- drills through run_training


def _drill_cfg(root, corpus, save=2, **resilience):  # noqa: F811
    return load_both(write_configs(root, corpus, step={"save_step": save, "val_step": 1000},
                                   resilience=resilience))[1]


def _log(root):
    """(train losses by step, the other lines) of log.txt."""
    losses, other = {}, []
    for line in (root / "log" / "log.txt").read_text().splitlines():
        if line.startswith("[train] Step "):
            losses[int(line.split(",")[0][13:])] = float(line.split("total_loss: ")[1].split(",")[0])
        else:
            other.append(line)
    return losses, other


@pytest.mark.parametrize("spec,save,want", [
    ("nan_grads@3", 2, "rollback 1/2 to checkpoint step 2"),
    ("nan_grads@1", 100, "rollback 1/2 to fresh init (no checkpoint yet)"),
    ("nan_grads@3;nan_grads@3;nan_grads@3", 2, None),
])
def test_nan_drill_rolls_back_and_completes(tmp_path, corpus, monkeypatch,  # noqa: F811
                                            spec, save, want):
    monkeypatch.setenv(faults.ENV_VAR, spec)
    cfg = _drill_cfg(tmp_path, corpus, save=save, max_rollbacks=2)
    registry = MetricsRegistry()
    if want is None:  # the same poison on every replay: a diverged run
        with pytest.raises(TrainingDivergedError):
            run_training(cfg, device="cpu", max_steps=6, registry=registry)
        assert registry.value("train_rollbacks_total") == 2
        return
    assert run_training(cfg, device="cpu", max_steps=6, registry=registry).step == 6
    losses, other = _log(tmp_path)
    assert any(want in line for line in other)
    assert sorted(losses) == [1, 2, 3, 4, 5, 6] and all(np.isfinite(list(losses.values())))
    assert registry.value("train_rollbacks_total") == registry.value("faults_fired_total") == 1
    rb = list(read_events(str(tmp_path / "log"), "rollback"))
    assert [(r["step"], r["restore_step"]) for r in rb] == [(int(spec[-1]), 2 if save == 2 else None)]
    assert CheckpointManager(cfg.train.path.ckpt_path).latest_step() == 6


def test_loader_ioerror_drill_completes(tmp_path, corpus, monkeypatch):  # noqa: F811
    monkeypatch.setenv(faults.ENV_VAR, "loader_ioerror@7")
    registry = MetricsRegistry()
    cfg = _drill_cfg(tmp_path, corpus, save=4)
    assert run_training(cfg, device="cpu", max_steps=4, registry=registry).step == 4
    assert all(np.isfinite(list(_log(tmp_path)[0].values())))
    assert not registry.value("quarantined_samples_total")


def test_sigterm_flush_and_gapless_resume(tmp_path, corpus, monkeypatch):  # noqa: F811
    """A SIGTERM'd run returns after the step it arrived in with a flushed
    checkpoint; ``restore_step=-1`` resumes with no step gap."""
    monkeypatch.setenv(faults.ENV_VAR, "sigterm@3")
    cfg = _drill_cfg(tmp_path, corpus, save=100)
    assert run_training(cfg, device="cpu", max_steps=6).step == 3
    assert CheckpointManager(cfg.train.path.ckpt_path).latest_step() == 3
    assert any("SIGTERM: checkpoint flushed at step 3" in line for line in _log(tmp_path)[1])
    flush = list(read_events(str(tmp_path / "log"), "preempt_flush"))
    assert [(r["signal"], r["step"]) for r in flush] == [("SIGTERM", 3)]
    monkeypatch.delenv(faults.ENV_VAR)
    assert run_training(cfg, device="cpu", restore_step=-1, max_steps=6).step == 6
    assert sorted(_log(tmp_path)[0]) == [1, 2, 3, 4, 5, 6]  # no gap, no repeat
    assert CheckpointManager(cfg.train.path.ckpt_path).latest_step() == 6


def test_final_checkpoint_covers_tail_steps(tmp_path, corpus):  # noqa: F811
    cfg = _drill_cfg(tmp_path, corpus, save=2)
    assert run_training(cfg, device="cpu", max_steps=5).step == 5
    saves = list(read_events(str(tmp_path / "log"), "checkpoint_save"))
    assert [(r["step"], r.get("final", False)) for r in saves] == [(2, False), (4, False),
                                                                     (5, True)]
    assert set(CheckpointManager(cfg.train.path.ckpt_path).all_steps()) >= {4, 5}


def test_nan_drill_matches_the_jax_run_training(tmp_path, corpus, monkeypatch,  # noqa: F811
                                                no_jax_postnet_dropout):  # noqa: F811
    """``nan_grads@3`` with save_step 2 through both packages' loops from
    the same weights: the same rollback (step 3 to step 2), the same batch
    ids at every step after it, losses within 1e-5 relative."""
    from speakingstyle_tpu.models.factory import build_model as j_build, init_variables
    from speakingstyle_tpu.obs.events import read_events as j_read
    from speakingstyle_tpu.training.trainer import run_training as j_run
    from speakingstyle_torch.compat.from_jax import load_flax_variables
    from speakingstyle_torch.models.factory import build_model
    from speakingstyle_torch.training import trainer
    from speakingstyle_torch.training.optim import Optimizer
    from speakingstyle_torch.training.state import TrainState

    monkeypatch.setenv(faults.ENV_VAR, "nan_grads@3")
    runs = {}
    for side in ("jax", "torch"):
        root = tmp_path / side
        root.mkdir()
        jcfg, tcfg = load_both(write_configs(root, corpus, LIBRARY_MODEL, step={
            "save_step": 2, "val_step": 1000, "synth_step": 1}, obs={"program_card": False}))
        ids = runs.setdefault(side, {"ids": {}})["ids"]

        def record(state, batch, arrays, step, model, ids=ids):
            ids.setdefault(step, []).append(list(batch.ids))

        if side == "jax":
            jcfg = dataclasses.replace(jcfg, train=dataclasses.replace(jcfg.train, fast_prng=False))
            with jax.default_prng_impl("threefry2x32"):
                variables = jax.device_get(init_variables(
                    j_build(jcfg), jcfg, jax.random.PRNGKey(jcfg.train.seed)))
                j_run(jcfg, max_steps=6, synth_callback=record)
            events = list(j_read(str(root / "log")))
        else:
            def jax_weights(cfg, device):
                model = load_flax_variables(build_model(cfg), copy.deepcopy(variables))
                model.postnet.dropout = 0.0
                return TrainState(0, model, Optimizer(trainer.trainable(model), cfg.train))

            monkeypatch.setattr(trainer, "build_state", jax_weights)
            run_training(tcfg, device="cpu", max_steps=6, synth_callback=record)
            events = list(read_events(str(root / "log")))
        runs[side]["rollback"] = [(e["step"], e["restore_step"]) for e in events
                                  if e["event"] == "rollback"]
        runs[side]["losses"] = {e["step"]: e["total_loss"] for e in events
                                if e["event"] == "train_step"}
    j, t = runs["jax"], runs["torch"]
    assert j["rollback"] == t["rollback"] == [(3, 2)]
    assert j["ids"] == t["ids"] and len(t["ids"][3]) == 1  # the poisoned step 3 tripped at the log
    assert sorted(j["losses"]) == sorted(t["losses"]) == [1, 2, 3, 4, 5, 6]
    for step, v in j["losses"].items():
        np.testing.assert_allclose(t["losses"][step], v, rtol=1e-5, err_msg=f"step {step}")
