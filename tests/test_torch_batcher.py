"""PyTorch port, the continuous batcher (serving/batcher.py) against the
JAX package's ``ContinuousBatcher`` on the same scenario: coalescing,
occupancy and bucket counts, shed hysteresis and ``Retry-After``,
``ShutdownError`` after close and the flush on close, and
``DispatchError`` on every future of a batch whose bookkeeping fails.

Both batchers drive a duck-typed engine that records its dispatches. Each
scenario orders its steps with events (a gate holds the dispatch thread
inside ``run``; futures are awaited), never with a sleep, so the counters
it reads are deterministic and must be equal in both packages.
"""

import threading
from types import SimpleNamespace

import numpy as np
import pytest


def packages():
    from speakingstyle_tpu.configs import config as j_config
    from speakingstyle_tpu.serving import batcher as j_batcher
    from speakingstyle_tpu.serving import lattice as j_lattice
    from speakingstyle_torch.configs import config as t_config
    from speakingstyle_torch.serving import batcher as t_batcher
    from speakingstyle_torch.serving import lattice as t_lattice

    return {
        "jax": SimpleNamespace(config=j_config, batcher=j_batcher, lattice=j_lattice),
        "torch": SimpleNamespace(config=t_config, batcher=t_batcher, lattice=t_lattice),
    }


class FakeEngine:
    """Records dispatches; ``gate`` holds the first ``run`` until set;
    ``bad_bucket`` returns results whose bucket breaks the batcher's
    bookkeeping."""

    def __init__(self, pkg, gate=None, fail=None, bad_bucket=False, **serve):
        base = dict(batch_buckets=[1, 2, 4], src_buckets=[16], mel_buckets=[64],
                    frames_per_phoneme=2, max_wait_ms=5.0, queue_depth=64)
        base.update(serve)
        self.cfg = SimpleNamespace(serve=pkg.config.ServeConfig(**base))
        self.lattice = pkg.lattice.BucketLattice.from_config(self.cfg.serve)
        self.dispatches = []
        self.gate = gate
        self.entered = threading.Event()
        self.fail = fail
        self.bad_bucket = bad_bucket
        self._first = True

    def admit(self, request):
        self.lattice.cover(1, len(request.sequence), 1)

    def run(self, requests):
        if self.gate is not None and self._first:
            self._first = False
            self.entered.set()
            assert self.gate.wait(timeout=30)
        if self.fail is not None:
            raise self.fail
        self.dispatches.append([r.id for r in requests])
        bucket = (object() if self.bad_bucket else
                  self.lattice.cover(len(requests), max(len(r.sequence) for r in requests), 1))
        return [SimpleNamespace(id=r.id, bucket=bucket) for r in requests]


def req(i, length=8):
    return SimpleNamespace(id=f"r{i}", sequence=np.ones(length, np.int32),
                           arrival=0.0)


def observed(b, eng):
    return {"dispatches": eng.dispatches, "occupancy": dict(b.occupancy),
            "buckets": dict(b.bucket_counts), "dispatched": b.dispatched, "shed": b.shed,
            "rejected": b.rejected}


def scenario_coalesce(pkg):
    gate = threading.Event()
    eng = FakeEngine(pkg, gate=gate)
    with pkg.batcher.ContinuousBatcher(eng) as b:
        first = b.submit(req(0))
        assert eng.entered.wait(timeout=30)
        # the backlog built while a dispatch runs: one batch, at the cap
        backlog = [b.submit(req(i, length=4 + i)) for i in range(1, 7)]
        gate.set()
        results = [f.result(timeout=30).id for f in [first] + backlog]
    assert results == [f"r{i}" for i in range(7)]
    return observed(b, eng)


def scenario_shed(pkg):
    gate = threading.Event()
    eng = FakeEngine(pkg, gate=gate, queue_depth=4,
                     fleet=pkg.config.FleetConfig(shed_retry_after_s=2.5))
    b = pkg.batcher.ContinuousBatcher(eng)
    try:
        first = b.submit(req(0))
        assert eng.entered.wait(timeout=30)
        outcomes, admitted, retry = [], [], []
        for i in range(1, 8):  # high watermark 0.9 * 4, low 0.5 * 4
            try:
                admitted.append(b.submit(req(i)))
                outcomes.append("admit")
            except pkg.batcher.Overloaded as e:
                outcomes.append("shed")
                retry.append(e.retry_after_s)
        gate.set()
        for f in [first] + admitted:
            f.result(timeout=30)
        # drained below the low watermark: admission resumes
        after = b.submit(req(99))
        after.result(timeout=30)
        outcomes.append("admit")
    finally:
        b.close()
    return dict(observed(b, eng), outcomes=outcomes, retry_after=retry)


def scenario_close(pkg):
    gate = threading.Event()
    eng = FakeEngine(pkg, gate=gate)
    b = pkg.batcher.ContinuousBatcher(eng)
    first = b.submit(req(0))
    assert eng.entered.wait(timeout=30)
    queued = [b.submit(req(i)) for i in range(1, 6)]
    gate.set()
    b.close()  # flush: every admitted request resolves with a result
    results = [f.result(timeout=0).id for f in [first] + queued]
    with pytest.raises(pkg.batcher.ShutdownError):
        b.submit(req(99))
    return dict(observed(b, eng), results=results)


def scenario_close_noflush(pkg):
    gate = threading.Event()
    eng = FakeEngine(pkg, gate=gate)
    b = pkg.batcher.ContinuousBatcher(eng)
    first = b.submit(req(0))
    assert eng.entered.wait(timeout=30)
    pending = [b.submit(req(i)) for i in range(1, 4)]
    closer = threading.Thread(target=lambda: b.close(flush=False))
    closer.start()
    # close(flush=False) fails the queued futures before it waits on the
    # worker, which the gate still holds
    errors = [type(f.exception(timeout=30)).__name__ for f in pending]
    gate.set()
    closer.join(timeout=30)
    assert first.result(timeout=30).id == "r0"  # in flight: completes
    return dict(observed(b, eng), errors=errors)


def scenario_bookkeeping(pkg):
    gate = threading.Event()
    eng = FakeEngine(pkg, gate=gate, bad_bucket=True)
    with pkg.batcher.ContinuousBatcher(eng) as b:
        first = b.submit(req(0))
        assert eng.entered.wait(timeout=30)
        batch = [b.submit(req(i)) for i in range(1, 4)]
        gate.set()
        errors = [type(f.exception(timeout=30)).__name__ for f in [first] + batch]
        # the dispatch thread survived: a healthy batch still serves
        eng.bad_bucket = False
        assert b.submit(req(9)).result(timeout=30).id == "r9"
        n_errors = b.registry.value("serve_dispatch_errors_total")
    return dict(observed(b, eng), errors=errors, dispatch_errors=n_errors)


def scenario_engine_error(pkg):
    eng = FakeEngine(pkg, fail=RuntimeError("boom"))
    with pkg.batcher.ContinuousBatcher(eng) as b:
        err = b.submit(req(0)).exception(timeout=30)
        eng.fail = None
        ok = b.submit(req(1)).result(timeout=30).id
    return dict(observed(b, eng), error=str(err), ok=ok)


SCENARIOS = {
    "coalesce": scenario_coalesce,
    "shed": scenario_shed,
    "close": scenario_close,
    "close_noflush": scenario_close_noflush,
    "bookkeeping": scenario_bookkeeping,
    "engine_error": scenario_engine_error,
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_batcher_matches_jax(name):
    """The scenario's dispatches, occupancy, bucket counts, shed / rejected
    counters and outcomes are the JAX batcher's."""
    pk = packages()
    got = {k: SCENARIOS[name](p) for k, p in pk.items()}
    assert got["torch"] == got["jax"]


def test_batcher_scenarios_hold_their_semantics():
    """What each scenario must show on its own (the port's run)."""
    pkg = packages()["torch"]
    co = scenario_coalesce(pkg)
    assert co["dispatches"] == [["r0"], ["r1", "r2", "r3", "r4"], ["r5", "r6"]]
    assert co["occupancy"] == {1: 1, 4: 1, 2: 1}
    assert co["buckets"] == {"b1.s16.m64": 1, "b4.s16.m64": 1, "b2.s16.m64": 1}

    shed = scenario_shed(pkg)
    # admit until the queue holds 4 (>= 3.6), shed until it drains to 2
    assert shed["outcomes"] == ["admit"] * 4 + ["shed"] * 3 + ["admit"]
    assert shed["shed"] == 3
    # no dispatch completed before the sheds: the configured fallback
    assert shed["retry_after"] == [2.5] * 3

    close = scenario_close(pkg)
    assert close["results"] == [f"r{i}" for i in range(6)] and close["rejected"] == 1
    assert scenario_close_noflush(pkg)["errors"] == ["ShutdownError"] * 3

    book = scenario_bookkeeping(pkg)
    assert book["errors"] == ["DispatchError"] * 4 and book["dispatch_errors"] == 2

    err = scenario_engine_error(pkg)
    assert err["error"] == "boom" and err["ok"] == "r1"


def test_drain_rate_estimator_matches_jax():
    """The Retry-After estimate on an explicit clock: the rate over the
    window and the clamped seconds to drain a backlog."""
    from speakingstyle_tpu.serving.batcher import DrainRateEstimator as J
    from speakingstyle_torch.serving.batcher import DrainRateEstimator as T

    rng = np.random.default_rng(5)
    stamps = np.cumsum(rng.uniform(0.01, 0.7, 40))
    counts = rng.integers(1, 5, 40)
    j, t = J(window_s=3.0), T(window_s=3.0)
    assert t.retry_after(10, fallback=1.5) == j.retry_after(10, fallback=1.5) == 1.5
    for now, n in zip(stamps, counts):
        j.note(int(n), now=float(now))
        t.note(int(n), now=float(now))
        assert t.rate(now=float(now)) == j.rate(now=float(now))
    for backlog in (0.0, 1.0, 7.0, 500.0):
        assert t.retry_after(backlog, fallback=1.0) == j.retry_after(backlog, fallback=1.0)


def test_batcher_events_and_registry_views(tmp_path):
    """The ``serve_dispatch`` record lists the batch's request ids, and the
    attribute views agree with the registry snapshot /metrics reads."""
    from speakingstyle_torch.obs import JsonlEventLog, read_events
    from speakingstyle_torch.serving.batcher import ContinuousBatcher

    pkg = packages()["torch"]
    eng = FakeEngine(pkg)
    log = JsonlEventLog(str(tmp_path))
    with ContinuousBatcher(eng, events=log) as b:
        assert b.submit(req(0)).result(timeout=30).id == "r0"
        snap = b.registry.snapshot()
    log.close()
    (rec,) = list(read_events(str(tmp_path), event="serve_dispatch"))
    assert rec["req_ids"] == ["r0"] and rec["rows"] == 1 and rec["bucket"] == "b1.s16.m64"
    assert snap["counters"]["serve_batches_total"] == b.dispatched == 1
    assert snap["counters"]['serve_batch_occupancy_total{rows="1"}'] == 1
    assert snap["histograms"]["serve_request_latency_seconds"]["count"] == 1
