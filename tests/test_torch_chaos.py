"""PyTorch port, fleet supervision under injected faults (serving/fleet.py,
serving/resilience.py), held against the JAX package's.

* the circuit breaker's state machine, driven through the same clock on
  both packages;
* the in-process drills of ``tests/test_chaos.py`` on both routers with
  the same expectations: ``replica_raise`` loses no request and the
  replica re-warms and closes its breaker; ``replica_hang`` past the
  watchdog is stolen and its late results discarded; retry budgets end in
  ``ReplicaError``; a bookkeeping error keeps the worker alive; a stream
  continuation is never retried;
* what one card adds (port only): fake engines that take the device gate
  as the real ones do, one of them hung inside it, while the others keep
  answering and the failed replica's re-warm waits; the gate under a
  warm-up holds a dispatch back for one preparation at most; a retired
  engine gives its programs back;
* the drill on the tiny model: one of two real replicas killed under load,
  no request lost, the fleet back to two ready replicas.
"""

import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

from test_torch_fleet import (  # noqa: F401 (fixtures)
    PKGS, TIMEOUT, fleet_cfg, jax_weights, pkg, port_parts, req, tiny_requests, wait_for)
from test_torch_models import one_cpu_thread  # noqa: F401 (an autouse fixture)


def chaos_cfg(p, **fleet_kw):
    kw = dict(queue_depth=64, rewarm_backoff_s=0.05, rewarm_backoff_max_s=1.0,
              class_deadline_ms={"interactive": 10_000.0, "batch": 20_000.0})
    kw.update(fleet_kw)
    return fleet_cfg(p, **kw)


class Events:
    """In-memory stand-in for the JSONL event log."""

    def __init__(self):
        self.lock = threading.Lock()
        self.records = []

    def emit(self, event, **fields):
        with self.lock:
            self.records.append((event, fields))

    def kinds(self):
        with self.lock:
            return [k for k, _ in self.records]

    def of(self, kind):
        with self.lock:
            return [dict(f) for k, f in self.records if k == kind]


class ChaosEngine:
    """Fake replica engine recording every dispatched request id; a
    ``run_hook`` takes over the return value (or raises) when set."""

    def __init__(self, run_hook=None):
        self.dispatches = []
        self.lock = threading.Lock()
        self.run_hook = run_hook
        self.closed = False

    def precompile(self):
        return 0.0

    def run(self, requests):
        with self.lock:
            self.dispatches.extend(r.id for r in requests)
        if self.run_hook is not None:
            return self.run_hook(requests)
        return [SimpleNamespace(id=r.id, bucket=None, mel_len=1) for r in requests]

    def close(self):
        self.closed = True


def factory(engines, run_hook=None, cls=ChaosEngine):
    """An engine factory that keeps building (a re-warm calls it again) and
    records every instance."""

    def build(reg):
        eng = cls(run_hook=run_hook)
        engines.append(eng)
        return eng

    return build


def same_states(router, want):
    return wait_for(lambda: sorted(router.states().values()) == sorted(want))


def test_circuit_breaker_lifecycle_backoff_and_cap():
    """closed -> open (backoff doubling to its cap) -> half-open -> closed,
    on both packages' breakers through one clock, with the JAX test's
    expectations."""
    traces = {}
    for name in PKGS:
        b = pkg(name).resilience.CircuitBreaker(0.1, 0.4)
        t = [b.state, b.code, b.record_failure(100.0), b.state, b.consecutive_failures,
             b.ready_to_trial(100.05), b.ready_to_trial(100.1)]
        b.begin_trial()
        t += [b.state, b.code, b.ready_to_trial(500.0), b.record_failure(200.0),
              b.record_failure(300.0), b.record_failure(400.0), b.retry_at()]
        b.begin_trial()
        b.record_success()
        t += [b.state, b.consecutive_failures, b.record_failure(500.0)]
        traces[name] = t
        for bad in ((0.0, 1.0), (1.0, 0.5)):
            with pytest.raises(ValueError, match="backoff"):
                pkg(name).resilience.CircuitBreaker(*bad)
    assert traces["torch"] == traces["tpu"]
    assert traces["torch"] == ["closed", 0, 0.1, "open", 1, False, True, "half_open", 2, False,
                               0.2, 0.4, 0.4, 400.4, "closed", 0, 0.1]
    assert pkg("torch").resilience.BREAKER_CODE == pkg("tpu").resilience.BREAKER_CODE


@pytest.mark.parametrize("name", PKGS)
def test_replica_raise_zero_lost_requests_and_rewarm(name):
    """A replica killed at a set dispatch loses no request (its in-flight
    one requeues onto the healthy replica), circuit-breaks, re-warms and
    closes its breaker on its first good dispatch."""
    p = pkg(name)
    engines, plan, events, reg = [], p.faults.FaultPlan(), Events(), p.obs.MetricsRegistry()
    router = p.fleet.FleetRouter(factory(engines), chaos_cfg(p), replicas=2, registry=reg,
                                 events=events, fault_plan=plan)
    try:
        assert router.wait_ready(timeout=TIMEOUT, n=2)
        for f in [router.submit(req(p, i)) for i in range(4)]:
            assert f.result(timeout=TIMEOUT) is not None
        plan.arm("replica_raise", router.dispatch_total + 1)
        futs = [router.submit(req(p, 100 + i)) for i in range(8)]
        results = [f.result(timeout=TIMEOUT) for f in futs]
        assert sorted(r.id for r in results) == sorted(f"r{100 + i}" for i in range(8))
        fails = [i for i in (0, 1)
                 if reg.value("serve_replica_failures_total", {"replica": str(i)}) == 1]
        assert len(fails) == 1
        assert reg.value("serve_requeued_total") == 1
        assert reg.value("serve_retries_total", {"class": "interactive"}) == 1
        rf = events.of("replica_failure")
        assert len(rf) == 1 and rf[0]["kind"] == "raise" and rf[0]["error"] == "InjectedFault"
        assert rf[0]["requeued"] == rf[0]["req_ids"]
        assert same_states(router, [p.fleet.READY, p.fleet.READY])
        assert len(engines) == 3
        idx, n = str(fails[0]), 0
        deadline = time.monotonic() + TIMEOUT
        while (time.monotonic() < deadline
               and reg.value("serve_replica_breaker_state", {"replica": idx}) != 0):
            router.submit(req(p, 900 + n)).result(timeout=TIMEOUT)
            n += 1
        assert reg.value("serve_replica_breaker_state", {"replica": idx}) == 0
    finally:
        router.close()
    assert all(s == p.fleet.STOPPED for s in router.states().values())
    if name == "torch":  # the port closes what it retired: the failed engine, then all
        assert wait_for(lambda: all(e.closed for e in engines))


@pytest.mark.parametrize("name", PKGS)
def test_hang_watchdog_steals_batch_and_discards_late_results(name):
    """A dispatch stuck past the watchdog is stolen and requeued; the hung
    worker's late results are discarded, so each future resolves once."""
    p = pkg(name)
    engines, events, reg = [], Events(), p.obs.MetricsRegistry()
    router = p.fleet.FleetRouter(factory(engines), chaos_cfg(p, hang_watchdog_s=0.15),
                                 replicas=1, registry=reg, events=events,
                                 fault_plan=p.faults.FaultPlan.parse("replica_hang@1"))
    try:
        assert router.wait_ready(timeout=TIMEOUT)
        assert router.submit(req(p, 0)).result(timeout=TIMEOUT).id == "r0"
        rf = events.of("replica_failure")
        assert len(rf) == 1 and rf[0]["kind"] == "hang" and rf[0]["error"] == "TimeoutError"
        assert reg.value("serve_replica_failures_total", {"replica": "0"}) == 1
        assert wait_for(lambda: "dispatch_discarded" in events.kinds())
        assert sum(e.dispatches.count("r0") for e in engines) == 2
    finally:
        router.close()


@pytest.mark.parametrize("name", PKGS)
def test_retry_budget_exhaustion_resolves_replica_error(name):
    """A request spends one retry per replica failure; past its class's
    budget it resolves as ReplicaError (503)."""
    p = pkg(name)
    reg = p.obs.MetricsRegistry()
    router = p.fleet.FleetRouter(
        factory([]), chaos_cfg(p, retry_budget={"interactive": 1, "batch": 2}), replicas=1,
        registry=reg, fault_plan=p.faults.FaultPlan.parse("replica_raise@1;replica_raise@2"))
    try:
        assert router.wait_ready(timeout=TIMEOUT)
        exc = router.submit(req(p, 0)).exception(timeout=TIMEOUT)
        assert isinstance(exc, p.resilience.ReplicaError) and "retry budget" in str(exc)
        assert reg.value("serve_requeued_total") == 1
        assert reg.value("serve_retries_total", {"class": "interactive"}) == 1
        assert reg.value("serve_replica_failures_total", {"replica": "0"}) == 2
    finally:
        router.close()


@pytest.mark.parametrize("name", PKGS)
def test_zero_retry_budget_fails_fast(name):
    p = pkg(name)
    router = p.fleet.FleetRouter(
        factory([]), chaos_cfg(p, retry_budget={"interactive": 0, "batch": 0}), replicas=1,
        fault_plan=p.faults.FaultPlan.parse("replica_raise@1"))
    try:
        assert router.wait_ready(timeout=TIMEOUT)
        assert isinstance(router.submit(req(p, 0)).exception(timeout=TIMEOUT),
                          p.resilience.ReplicaError)
    finally:
        router.close()


@pytest.mark.parametrize("name", PKGS)
def test_fleet_dispatch_bookkeeping_error_keeps_worker_alive(name):
    """An exception in the dispatch loop's bookkeeping (the engine call
    succeeded) resolves the batch as DispatchError; the replica stays READY
    and serves on."""
    p = pkg(name)
    calls = {"n": 0}

    def hook(requests):
        calls["n"] += 1
        if calls["n"] == 1:
            return None
        return [SimpleNamespace(id=r.id, bucket=None, mel_len=1) for r in requests]

    reg = p.obs.MetricsRegistry()
    router = p.fleet.FleetRouter(factory([], run_hook=hook), chaos_cfg(p), replicas=1,
                                 registry=reg)
    try:
        assert router.wait_ready(timeout=TIMEOUT)
        exc = router.submit(req(p, 0)).exception(timeout=TIMEOUT)
        assert isinstance(exc, p.resilience.DispatchError) and "bookkeeping" in str(exc)
        assert reg.value("serve_dispatch_errors_total") == 1
        assert router.states()[0] == p.fleet.READY
        assert reg.value("serve_replica_failures_total", {"replica": "0"}) == 0
        assert router.submit(req(p, 1)).result(timeout=TIMEOUT).id == "r1"
    finally:
        router.close()


@pytest.mark.parametrize("name", PKGS)
def test_stream_continuation_lost_replica_is_not_retried(name):
    """A result whose replica failed raises ReplicaError at its stream's
    first chunk instead of moving to another replica."""
    p = pkg(name)
    plan = p.faults.FaultPlan()
    cfg = chaos_cfg(p, retry_budget={"interactive": 0, "batch": 0}, rewarm_backoff_s=30.0,
                    rewarm_backoff_max_s=60.0)
    router = p.fleet.FleetRouter(factory([]), cfg, replicas=1, fault_plan=plan)
    try:
        assert router.wait_ready(timeout=TIMEOUT)
        res = router.submit(req(p, 0)).result(timeout=TIMEOUT)
        assert res.replica == 0
        plan.arm("replica_raise", router.dispatch_total + 1)
        assert isinstance(router.submit(req(p, 1)).exception(timeout=TIMEOUT),
                          p.resilience.ReplicaError)
        assert router.states()[0] == p.fleet.FAILED
        with pytest.raises(p.resilience.ReplicaError, match="not retried"):
            next(router.stream(res))
    finally:
        router.close()


# ---------------------------------------------------------------------------
# one card: the device gate
# ---------------------------------------------------------------------------


class GateEngine(ChaosEngine):
    """A fake engine that takes DEVICE_GATE as the real ones do: a dispatch
    holds it shared, a preparation exclusively. Each instance's run blocks
    on ``hang`` (an Event) while ``hanging`` is set."""

    hang = None
    hanging = False
    hung_engine = None

    def precompile(self):
        from speakingstyle_torch.parallel.registry import DEVICE_GATE

        for _ in range(3):  # one exclusive hold a program
            with DEVICE_GATE.exclusive():
                time.sleep(0.002)
        return 0.0

    def run(self, requests):
        from speakingstyle_torch.parallel.registry import DEVICE_GATE

        with DEVICE_GATE.shared():
            if GateEngine.hanging and GateEngine.hang is not None:
                GateEngine.hanging = False  # one hang only
                GateEngine.hung_engine = self
                GateEngine.hang.wait(timeout=TIMEOUT)
            return super().run(requests)


def test_a_hang_inside_the_gate_does_not_stall_the_healthy_replicas():
    """One replica hangs inside its dispatch holding the device gate
    shared. The watchdog fails it; its re-warm (whose preparation takes the
    gate exclusively) waits until the hung dispatch returns instead of
    queueing as a writer behind it, so the healthy replica keeps answering.
    Once the hang ends the replica re-warms, and its abandoned engine is
    closed."""
    p = pkg("torch")
    engines, events, reg = [], Events(), p.obs.MetricsRegistry()
    GateEngine.hang, GateEngine.hanging = threading.Event(), False
    router = p.fleet.FleetRouter(factory(engines, cls=GateEngine),
                                 chaos_cfg(p, hang_watchdog_s=0.1, rewarm_backoff_s=0.05),
                                 replicas=2, registry=reg, events=events)
    try:
        assert router.wait_ready(timeout=TIMEOUT, n=2)
        GateEngine.hanging = True
        first = router.submit(req(p, 0))  # the hang, stolen and retried
        assert first.result(timeout=TIMEOUT).id == "r0"
        assert wait_for(lambda: "replica_warm_deferred" in events.kinds())
        states = router.states()
        hung = next(i for i, s in states.items() if s != p.fleet.READY)
        assert states[hung] == p.fleet.WARMING and len(engines) == 2
        # the healthy replica answers while the hung dispatch holds the gate
        t0 = time.monotonic()
        for i in range(20):
            assert router.submit(req(p, 10 + i)).result(timeout=5).id == f"r{10 + i}"
        assert time.monotonic() - t0 < 5
        assert router.states()[hung] == p.fleet.WARMING
        GateEngine.hang.set()
        assert same_states(router, [p.fleet.READY, p.fleet.READY])
        assert len(engines) == 3 and wait_for(lambda: GateEngine.hung_engine.closed)
        assert not any(e.closed for e in engines if e is not GateEngine.hung_engine)
        assert "dispatch_discarded" in events.kinds()
        assert router.submit(req(p, 99)).result(timeout=TIMEOUT).id == "r99"
    finally:
        GateEngine.hang.set()
        router.close()


def test_the_gate_lets_dispatches_in_between_preparations():
    """A warm-up preparing program after program (each holding the gate
    exclusively) holds a concurrent dispatch back for about one preparation,
    never for the whole warm-up: the gate is phase-fair."""
    from speakingstyle_torch.parallel.registry import DeviceGate

    gate, stop, waits = DeviceGate(), threading.Event(), []

    def warm_up():
        while not stop.is_set():
            with gate.exclusive():
                time.sleep(0.02)

    def dispatches():
        for _ in range(15):
            t = time.monotonic()
            with gate.shared():
                waits.append(time.monotonic() - t)
                time.sleep(0.003)

    writer = threading.Thread(target=warm_up)
    readers = [threading.Thread(target=dispatches) for _ in range(2)]
    writer.start()
    for t in readers:
        t.start()
    for t in readers:
        t.join(timeout=TIMEOUT)
    stop.set()
    writer.join(timeout=TIMEOUT)
    assert len(waits) == 30
    # one preparation (20 ms) plus the scheduler's slack, not the warm-up
    assert max(waits) < 0.25, max(waits)


def test_gate_shared_holds_nest_and_exclusive_excludes():
    """The gate's contract under the fairness change: nested shared holds,
    an exclusive hold that waits for the shared ones and passes its own
    thread's shared entries."""
    from speakingstyle_torch.parallel.registry import DeviceGate

    gate, order = DeviceGate(), []
    entered = threading.Event()

    def writer():
        entered.wait(timeout=TIMEOUT)
        with gate.exclusive():
            order.append("exclusive")
            with gate.shared():
                order.append("own shared")

    t = threading.Thread(target=writer)
    t.start()
    with gate.shared():
        with gate.shared():
            entered.set()
            time.sleep(0.05)
            order.append("reader")
    t.join(timeout=TIMEOUT)
    assert order == ["reader", "exclusive", "own shared"]


# ---------------------------------------------------------------------------
# the tiny model: a replica killed under load
# ---------------------------------------------------------------------------


def test_fleet_chaos_on_the_tiny_model(jax_weights, tmp_path):  # noqa: F811
    """Two real replicas over one shared model: one killed by
    ``replica_raise`` under load loses no request, the fleet comes back to
    two READY replicas whose breakers close, the failed replica's engine
    gives its programs back, and steady traffic afterwards prepares
    nothing."""
    from speakingstyle_torch.faults import FaultPlan
    from speakingstyle_torch.serving.fleet import READY, FleetRouter

    parts = port_parts(tmp_path, jax_weights)
    plan, p = FaultPlan(), pkg("torch")
    built = []

    def tracked(reg):
        built.append(parts.factory(reg))
        return built[-1]

    router = FleetRouter(tracked, parts.cfg, replicas=2, registry=parts.registry,
                         style=parts.style, fault_plan=plan)
    reg = parts.registry
    try:
        assert router.wait_ready(timeout=300, n=2)
        for f in [router.submit(r) for r in tiny_requests(p, 4)]:
            assert f.result(timeout=TIMEOUT).wav is not None
        first = {i: router.engine_at(i) for i in (0, 1)}
        plan.arm("replica_raise", router.dispatch_total + 1)
        reqs = tiny_requests(p, 6)
        for i, r in enumerate(reqs):
            r.id = f"k{i}"
        results = [f.result(timeout=TIMEOUT) for f in [router.submit(r) for r in reqs]]
        assert sorted(r.id for r in results) == sorted(r.id for r in reqs)
        fails = [i for i in (0, 1)
                 if reg.value("serve_replica_failures_total", {"replica": str(i)}) == 1]
        assert len(fails) == 1
        assert same_states(router, [READY, READY])
        assert len(built) == 3
        # the failed replica's first engine was retired and closed
        retired = first[fails[0]]
        assert wait_for(lambda: not retired.is_ready)
        assert len(retired.program_registry) == 0 and retired in built
        idx, n = str(fails[0]), 0
        while reg.value("serve_replica_breaker_state", {"replica": idx}) != 0 and n < 50:
            r = tiny_requests(p, 1)[0]
            r.id = f"b{n}"
            router.submit(r).result(timeout=TIMEOUT)
            n += 1
        assert reg.value("serve_replica_breaker_state", {"replica": idx}) == 0
        compiles = reg.value("serve_compiles_total")
        steady = [router.submit(r) for r in tiny_requests(p, 6)]
        assert all(f.result(timeout=TIMEOUT).wav is not None for f in steady)
        assert reg.value("serve_compiles_total") == compiles
        assert np.isfinite(reg.value("serve_requeued_total")) and \
            reg.value("serve_requeued_total") >= 1
    finally:
        router.close()
