"""PyTorch port, the model lifecycle (serving/lifecycle.py) and the fleet
autoscaler (serving/autoscale.py), held against the JAX package's.

* ``make_golden_set`` gives the JAX package's golden set, bit for bit;
* the rollout cases of ``tests/test_lifecycle.py`` on both packages'
  ``RolloutManager`` over their routers with fake engines, with the same
  expectations: the canary passes and commits, fails (non-finite, past
  tolerance, raising) and aborts with the fleet untouched, a verify
  failure aborts before any replica exists, the rolling replace loses no
  request under load, and a concurrent rollout raises
  ``RolloutInProgress``;
* the autoscaler cases of ``tests/test_traffic.py`` and its holds during a
  rollout, each script driven through both packages' ``Autoscaler`` with
  the same decisions;
* ``POST /admin/rollout`` on the port's server: 404 without a manager,
  400 / 409 / 200, and the version in ``/healthz``;
* ``serve.autoscale`` and ``serve.rollout`` load and validate as in JAX.
"""

import json
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import yaml

from test_torch_chaos import Events
from test_torch_fleet import PKGS, TIMEOUT, fleet_cfg, pkg, req
from test_torch_models import one_cpu_thread  # noqa: F401 (an autouse fixture)


def lifecycle(name):
    import importlib

    return importlib.import_module(f"speakingstyle_{name}.serving.lifecycle")


def rollout_cfg(p, **fleet_kw):
    kw = dict(queue_depth=64, rewarm_backoff_s=0.05, rewarm_backoff_max_s=1.0,
              class_deadline_ms={"interactive": 10_000.0, "batch": 20_000.0})
    kw.update(fleet_kw)
    return fleet_cfg(p, **kw)


class ConstMelEngine:
    """A replica engine whose every result carries a constant mel: the
    canary gate sees exactly the change dialed in."""

    def __init__(self, const):
        self.const = const

    def precompile(self):
        return 0.0

    def run(self, requests):
        mel = np.full((6, 8), self.const, np.float32)
        return [SimpleNamespace(id=r.id, bucket=None, mel_len=6, mel=mel) for r in requests]


def vfactory(const, built):
    def build(reg):
        eng = ConstMelEngine(const)
        built.append(eng)
        return eng
    return build


def rcfg(p, **kw):
    args = dict(golden_set_size=2, canary_tolerance=0.5, replica_timeout_s=20.0)
    args.update(kw)
    return p.config.RolloutConfig(**args)


def golden(p):
    return [req(p, 900), req(p, 901)]


def vab(const, built):
    """A verify_and_build stub returning a pinned-constant factory."""

    def verify_and_build(step):
        return vfactory(const, built), f"v{step}", {"step": step, "weights_digest": f"dig{const}"}

    return verify_and_build


def two_replica_router(p, built, reg=None, events=None):
    router = p.fleet.FleetRouter(vfactory(0.0, built), rollout_cfg(p), replicas=2,
                                 registry=reg if reg is not None else p.obs.MetricsRegistry(),
                                 events=events)
    assert router.wait_ready(timeout=TIMEOUT, n=2)
    return router


def test_make_golden_set_equals_jax():
    """The seeded canary corpus: the JAX package's requests bit for bit,
    sized inside the lattice, and clamped to the largest batch bucket."""
    sets = {}
    for name in PKGS:
        p = pkg(name)
        cfg = rollout_cfg(p)
        object.__setattr__(cfg.serve, "batch_buckets", [1, 4])
        a, b = (lifecycle(name).make_golden_set(cfg, 3, seed=7) for _ in range(2))
        c = lifecycle(name).make_golden_set(cfg, 3, seed=8)
        assert [r.id for r in a] == ["golden0", "golden1", "golden2"]
        for ra, rb in zip(a, b):
            np.testing.assert_array_equal(ra.sequence, rb.sequence)
            np.testing.assert_array_equal(ra.ref_mel, rb.ref_mel)
            assert ra.sequence.shape[0] <= cfg.serve.src_buckets[0]
        assert not np.array_equal(a[0].sequence, c[0].sequence)
        assert len(lifecycle(name).make_golden_set(rollout_cfg(p), 4, seed=7)) == 1
        sets[name] = a
    for t, j in zip(sets["torch"], sets["tpu"]):
        np.testing.assert_array_equal(t.sequence, j.sequence)
        np.testing.assert_array_equal(t.ref_mel, j.ref_mel)


@pytest.mark.parametrize("name", PKGS)
def test_canary_pass_commits_and_publishes_version(name):
    p, lc = pkg(name), lifecycle(name)
    built_v1, built_v2, reg, events = [], [], p.obs.MetricsRegistry(), Events()
    router = two_replica_router(p, built_v1, reg, events)
    try:
        mgr = lc.RolloutManager(router, vab(0.1, built_v2), rcfg=rcfg(p), golden=golden(p))
        result = mgr.rollout(7)
        assert result["status"] == "committed" and result["version"] == "v7"
        assert result["replicas"] == 2 and result["weights_digest"] == "dig0.1"
        assert router.model_version == "v7" and router.model_step == 7
        assert reg.value("serve_model_version") == 7
        assert reg.value("serve_rollouts_total", {"outcome": "committed"}) == 1
        assert events.kinds().count("rollout_committed") == 1
        canary = events.of("rollout_canary")
        assert len(canary) == 1 and canary[0]["passed"] is True
        ready = [i for i, s in router.states().items() if s == p.fleet.READY]
        assert len(ready) == 2
        assert all(router.engine_at(i) in built_v2 for i in ready)
        assert sorted(s for s in router.states().values()
                      if s == p.fleet.STOPPED) == [p.fleet.STOPPED] * 2
        assert router.engine_factory(reg) in built_v2
    finally:
        router.close()


@pytest.mark.parametrize("name", PKGS)
@pytest.mark.parametrize("bad_const,why", [(np.nan, "non-finite"), (10.0, "tolerance")])
def test_canary_failure_aborts_with_fleet_untouched(name, bad_const, why):
    p, lc = pkg(name), lifecycle(name)
    built_v1, built_v2, reg, events = [], [], p.obs.MetricsRegistry(), Events()
    router = two_replica_router(p, built_v1, reg, events)
    try:
        factory_before = router.engine_factory
        mgr = lc.RolloutManager(router, vab(bad_const, built_v2), rcfg=rcfg(p),
                                golden=golden(p))
        result = mgr.rollout(8)
        assert result["status"] == "aborted" and result["phase"] == "canary"
        assert why in result["reason"]
        assert router.engine_factory is factory_before and router.model_version is None
        states = router.states()
        assert [states[0], states[1], states[2]] == [p.fleet.READY, p.fleet.READY,
                                                     p.fleet.STOPPED]
        assert reg.value("serve_rollouts_total", {"outcome": "aborted"}) == 1
        aborted = events.of("rollout_aborted")
        assert len(aborted) == 1 and aborted[0]["phase"] == "canary"
        assert aborted[0]["partial"] is False and not router.rollout_active
    finally:
        router.close()


@pytest.mark.parametrize("name", PKGS)
def test_canary_exception_aborts_and_drains_canary(name):
    """A canary engine that raises in the golden replay aborts like a
    failed gate, and the canary is torn down, not left serving."""
    p, lc = pkg(name), lifecycle(name)
    reg = p.obs.MetricsRegistry()
    router = two_replica_router(p, [], reg)

    class Boom:
        def precompile(self):
            return 0.0

        def run(self, requests):
            raise RuntimeError("boom during canary replay")

    try:
        factory_before = router.engine_factory
        mgr = lc.RolloutManager(
            router, lambda step: (lambda reg: Boom(), f"v{step}", {"step": step}),
            rcfg=rcfg(p), golden=golden(p))
        result = mgr.rollout(8)
        assert result["status"] == "aborted" and result["phase"] == "canary"
        assert "RuntimeError: boom" in result["reason"]
        assert router.engine_factory is factory_before and router.model_version is None
        assert router.states()[2] == p.fleet.STOPPED
        assert reg.value("serve_rollouts_total", {"outcome": "aborted"}) == 1
    finally:
        router.close()


@pytest.mark.parametrize("name", PKGS)
def test_verify_failure_aborts_before_any_replica_exists(name):
    p, lc = pkg(name), lifecycle(name)
    router = two_replica_router(p, [])

    def bad_vab(step):
        raise ValueError("leaf_hash_mismatch: drill")

    try:
        result = lc.RolloutManager(router, bad_vab, rcfg=rcfg(p), golden=golden(p)).rollout(9)
        assert result["status"] == "aborted" and result["phase"] == "verify"
        assert "ValueError" in result["reason"]
        assert sorted(router.states().values()) == [p.fleet.READY] * 2
        assert not router.rollout_active
    finally:
        router.close()


@pytest.mark.parametrize("name", PKGS)
def test_rolling_replace_zero_lost_under_load(name):
    """A whole rollout under closed-loop load loses no request, and READY
    never dips below the pre-roll size (the canary is the +1 surge)."""
    p, lc = pkg(name), lifecycle(name)
    built_v2, reg = [], p.obs.MetricsRegistry()
    router = two_replica_router(p, [], reg)
    mgr = lc.RolloutManager(router, vab(0.1, built_v2), rcfg=rcfg(p), golden=golden(p))
    stop = threading.Event()
    per = [dict(ok=0, lost=[]) for _ in range(4)]
    min_ready = [99]

    def sampler():
        while not stop.is_set():
            min_ready[0] = min(min_ready[0],
                               sum(s == p.fleet.READY for s in router.states().values()))
            time.sleep(0.001)

    def client(cid):
        c, i = per[cid], 0
        while not stop.is_set():
            try:
                assert router.submit(req(p, cid * 100_000 + i)).result(timeout=10) is not None
                c["ok"] += 1
            except Exception as e:
                c["lost"].append(f"{type(e).__name__}: {e}")
            i += 1

    threads = [threading.Thread(target=sampler)]
    threads += [threading.Thread(target=client, args=(c,)) for c in range(4)]
    try:
        for t in threads:
            t.start()
        time.sleep(0.05)  # load flowing before the roll
        result = mgr.rollout(2)
        time.sleep(0.05)  # and on the new fleet
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=TIMEOUT)
        router.close()
    assert result["status"] == "committed"
    assert [c["lost"] for c in per] == [[], [], [], []]
    assert sum(c["ok"] for c in per) > 0 and min_ready[0] >= 2
    assert reg.value("serve_model_version") == 2


@pytest.mark.parametrize("name", PKGS)
def test_concurrent_rollout_raises_in_progress(name):
    p, lc = pkg(name), lifecycle(name)
    router = p.fleet.FleetRouter(vfactory(0.0, []), rollout_cfg(p), replicas=1)
    entered, gate = threading.Event(), threading.Event()

    def blocking_vab(step):
        entered.set()
        assert gate.wait(timeout=TIMEOUT)
        raise RuntimeError("released")

    mgr = lc.RolloutManager(router, blocking_vab, rcfg=rcfg(p), golden=golden(p))
    first = {}
    t = threading.Thread(target=lambda: first.update(mgr.rollout(2)))
    try:
        assert router.wait_ready(timeout=TIMEOUT)
        t.start()
        assert entered.wait(timeout=TIMEOUT) and router.rollout_active
        with pytest.raises(lc.RolloutInProgress):
            mgr.rollout(3)
    finally:
        gate.set()
        t.join(timeout=TIMEOUT)
        router.close()
    assert first["status"] == "aborted" and not router.rollout_active


# ---------------------------------------------------------------------------
# the autoscaler: one script, both packages, the same decisions
# ---------------------------------------------------------------------------


class FakeRouter:
    """The policy's whole view of the fleet (tests/test_traffic.py's)."""

    def __init__(self, p, queue_depth=100, replicas=1):
        self.p = p
        self.fleet = SimpleNamespace(queue_depth=queue_depth)
        self.registry = p.obs.MetricsRegistry()
        self.events = None
        self.depth, self.occ, self.live, self.warmup = 0, 0.0, replicas, None
        self.scale_calls = []
        self.closed = False
        self.rollout_active = False

    def pending_depth(self):
        return self.depth

    def live_replica_count(self):
        return self.live

    def occupancy(self):
        return self.occ

    def warmup_cost_s(self):
        return self.warmup

    def scale_to(self, n):
        if self.closed:
            raise self.p.batcher.ShutdownError("router is closed")
        self.scale_calls.append(n)
        self.live = n


def acfg(p, **kw):
    args = dict(enabled=True, min_replicas=1, max_replicas=4, interval_s=0.1,
                up_queue_fraction=0.5, up_occupancy=0.9, up_pressure_rate=1.0,
                down_queue_fraction=0.05, down_occupancy=0.5, down_stable_s=1.0,
                cooldown_up_s=2.0, cooldown_down_s=3.0, max_step=2, assumed_warmup_s=10.0,
                warmup_cost_factor=1.0)
    args.update(kw)
    return p.config.AutoscaleConfig(**args)


def run_script(script, router_kw=None, cfg_kw=None):
    """Run ``script(router, scaler, events)`` (returning its decisions) on
    both packages; assert they agree and return the port's record."""
    import importlib

    out = {}
    for name in PKGS:
        p = pkg(name)
        auto = importlib.import_module(f"speakingstyle_{name}.serving.autoscale")
        router = FakeRouter(p, **(router_kw or {}))
        events = Events()
        scaler = auto.Autoscaler(router, acfg(p, **(cfg_kw or {})), events=events, start=False)
        decisions = script(router, scaler, events)
        out[name] = (decisions, router.scale_calls, events.records)
        scaler.close()
    assert out["torch"] == out["tpu"]
    return out["torch"]


def test_autoscale_config_validation_as_jax():
    for name in PKGS:
        c = pkg(name).config
        for bad, match in ((dict(min_replicas=0), "min_replicas"),
                           (dict(min_replicas=3, max_replicas=2), "max_replicas"),
                           (dict(up_queue_fraction=0.3, down_queue_fraction=0.4),
                            "down_queue_fraction"),
                           (dict(up_occupancy=0.8, down_occupancy=0.9), "down_occupancy"),
                           (dict(max_step=0), "max_step"), (dict(interval_s=0.0), "interval_s"),
                           (dict(assumed_warmup_s=0.0), "assumed_warmup_s")):
            with pytest.raises(ValueError, match=match):
                c.AutoscaleConfig(**bad)
        assert c.ServeConfig().autoscale.enabled is False
        for bad, match in ((dict(golden_set_size=0), "golden_set_size"),
                           (dict(canary_tolerance=-1.0), "canary_tolerance"),
                           (dict(replica_timeout_s=0.0), "replica_timeout_s")):
            with pytest.raises(ValueError, match=match):
                c.RolloutConfig(**bad)
        assert c.ServeConfig().rollout.enabled is False


def test_autoscale_and_rollout_blocks_load_as_jax(tmp_path):
    """A train.yaml with ``serve.autoscale`` and ``serve.rollout`` blocks
    loads in both packages to the same values."""
    import dataclasses

    from speakingstyle_tpu.configs import config as jc
    from speakingstyle_torch.configs import config as tc

    path = tmp_path / "train.yaml"
    path.write_text(yaml.safe_dump({"serve": {
        "autoscale": {"enabled": True, "min_replicas": 2, "max_replicas": 3, "interval_s": 0.5,
                      "cooldown_down_s": 4.0},
        "rollout": {"enabled": True, "golden_set_size": 2, "canary_tolerance": 0.25}}}))
    j, t = jc.load_config(train=str(path)).serve, tc.load_config(train=str(path)).serve
    for block in ("autoscale", "rollout"):
        assert dataclasses.asdict(getattr(t, block)) == dataclasses.asdict(getattr(j, block))
        assert dataclasses.asdict(getattr(tc.ServeConfig(), block)) == \
            dataclasses.asdict(getattr(jc.ServeConfig(), block))


def test_autoscaler_scales_up_on_queue_pressure_with_cooldown():
    def script(router, scaler, events):
        router.depth = 50
        return [scaler.step(now=100.0), scaler.step(now=101.0), scaler.step(now=102.5),
                router.registry.value("serve_autoscale_target"),
                router.registry.value("serve_autoscale_decisions_total",
                                      {"reason": "queue_depth"})]

    decisions, calls, records = run_script(script)
    assert decisions == ["queue_depth", None, "queue_depth", 3, 2] and calls == [2, 3]
    assert [n for n, _ in records] == ["autoscale", "autoscale"]
    rec = records[0][1]
    assert rec["decision"] == "up" and rec["reason"] == "queue_depth"
    assert rec["depth"] == 50 and rec["target"] == 2


def test_autoscaler_max_step_at_extreme_pressure_and_max_bound():
    def script(router, scaler, events):
        router.depth = 100
        out = [scaler.step(now=100.0), scaler.step(now=103.0)]
        return out + [scaler.step(now=110.0 + 3.0 * i) for i in range(5)]

    decisions, calls, _ = run_script(script, cfg_kw=dict(max_step=2))
    assert decisions == ["queue_depth", "queue_depth"] + [None] * 5 and calls == [3, 4]


def test_autoscaler_occupancy_needs_sustained_backlog():
    def script(router, scaler, events):
        router.occ, router.depth = 1.0, 1
        out = [scaler.step(now=100.0)]
        router.depth = 2
        out += [scaler.step(now=101.0), scaler.step(now=101.6)]
        router.depth = 0
        out.append(scaler.step(now=104.0))
        router.depth = 3
        return out + [scaler.step(now=104.5), scaler.step(now=105.1)]

    decisions, calls, _ = run_script(script, dict(replicas=2), dict(interval_s=0.5))
    assert decisions == [None, None, "occupancy", None, None, "occupancy"] and calls == [3, 4]

    def solo(router, scaler, events):
        router.occ, router.depth = 1.0, 1
        return [scaler.step(now=200.0 + 0.6 * i) for i in range(4)]

    decisions, calls, _ = run_script(solo, dict(replicas=1), dict(interval_s=0.5))
    assert decisions == [None] * 4 and calls == []


def test_autoscaler_pressure_rate_trigger():
    def script(router, scaler, events):
        out = [scaler.step(now=100.0)]
        shed = router.registry.counter("serve_shed_total")
        router.registry.counter("serve_deadline_miss_total",
                                labels={"class": "interactive"}).inc(2)
        shed.inc(2)
        out.append(scaler.step(now=101.0))
        shed.inc(6)
        return out + [scaler.step(now=102.0)]

    decisions, calls, _ = run_script(script, cfg_kw=dict(up_pressure_rate=5.0))
    assert decisions == [None, None, "pressure"] and calls == [2]


def test_autoscaler_scale_down_waits_for_measured_warmup_window():
    def script(router, scaler, events):
        router.warmup = 4.0
        out = [scaler.step(now=t) for t in (100.0, 104.0, 108.5, 109.0, 117.0)]
        out += [scaler.step(now=120.0 + 9.0 * i) for i in range(4)]
        router.warmup = None
        return out + [router.live, scaler.warmup_cost_s()]

    decisions, calls, _ = run_script(
        script, dict(replicas=3),
        dict(down_stable_s=1.0, cooldown_down_s=1.0, warmup_cost_factor=2.0))
    assert decisions == [None, None, "calm", None, "calm"] + [None] * 4 + [1, 10.0]
    assert calls == [2, 1]


def test_autoscaler_pressure_resets_calm_streak():
    def script(router, scaler, events):
        out = [scaler.step(now=100.0)]
        router.depth = 60
        out.append(scaler.step(now=100.5))
        router.depth = 0
        return out + [scaler.step(now=t) for t in (101.0, 101.8, 102.1)]

    decisions, calls, _ = run_script(
        script, dict(replicas=2),
        dict(down_stable_s=1.0, cooldown_down_s=0.0, warmup_cost_factor=0.0))
    assert decisions == [None, "queue_depth", None, None, "calm"] and calls == [3, 2]


def test_autoscaler_bound_enforcement_and_closed_router():
    def script(router, scaler, events):
        out = [scaler.step(now=100.0)]
        router.live = 9
        out.append(scaler.step(now=100.1))
        router.closed, router.live = True, 0
        return out + [scaler.step(now=100.2)]

    decisions, calls, _ = run_script(script, dict(replicas=0), dict(min_replicas=2))
    assert decisions == ["min_bound", "max_bound", None] and calls == [2, 4]


def test_autoscaler_holds_calm_scaledown_during_rollout():
    def script(router, scaler, events):
        out = [scaler.step(now=100.0)]
        router.rollout_active = True
        out.append(scaler.step(now=101.5))
        router.rollout_active = False
        return out + [scaler.step(now=102.0), scaler.step(now=103.5)]

    decisions, calls, _ = run_script(script, dict(replicas=2), dict(assumed_warmup_s=0.5))
    assert decisions == [None, None, None, "calm"] and calls == [1]


def test_autoscaler_holds_max_bound_during_rollout_surge():
    def script(router, scaler, events):
        router.rollout_active = True
        out = [scaler.step(now=100.0)]
        router.rollout_active = False
        return out + [scaler.step(now=101.0)]

    decisions, calls, _ = run_script(script, dict(replicas=5), dict(assumed_warmup_s=0.5))
    assert decisions == [None, "max_bound"] and calls == [4]


def test_autoscaler_still_scales_up_during_rollout():
    def script(router, scaler, events):
        router.rollout_active, router.depth = True, 50
        return [scaler.step(now=100.0)]

    decisions, calls, _ = run_script(script, dict(replicas=2), dict(assumed_warmup_s=0.5))
    assert decisions == ["queue_depth"] and calls == [3]


def test_autoscaler_thread_is_stop_aware_on_a_real_router():
    """The policy thread over the port's router: a backlog grows the fleet,
    and close() stops the thread within a tick, leaving the size as is."""
    from speakingstyle_torch.serving.autoscale import Autoscaler

    p = pkg("torch")
    gate = threading.Event()

    class Slow:
        def precompile(self):
            return 0.0

        def run(self, requests):
            gate.wait(timeout=TIMEOUT)
            return [SimpleNamespace(id=r.id, bucket=None, mel_len=1) for r in requests]

    router = p.fleet.FleetRouter(lambda reg: Slow(), rollout_cfg(p, queue_depth=8), replicas=1)
    scaler = None
    try:
        assert router.wait_ready(timeout=TIMEOUT)
        futs = [router.submit(req(p, i)) for i in range(5)]
        scaler = Autoscaler(router, acfg(p, interval_s=0.02, cooldown_up_s=10.0))
        deadline = time.monotonic() + TIMEOUT
        while scaler.target < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert router.live_replica_count() == 2 and scaler.target == 2
        t0 = time.monotonic()
        scaler.close()
        assert time.monotonic() - t0 < 5.0 and router.live_replica_count() == 2
        gate.set()
        assert all(f.result(timeout=TIMEOUT) for f in futs)
    finally:
        gate.set()
        if scaler is not None:
            scaler.close()
        router.close()


# ---------------------------------------------------------------------------
# POST /admin/rollout on the port's server
# ---------------------------------------------------------------------------


def start_server(router, lifecycle=None):
    from speakingstyle_torch.serving.frontend import TextFrontend
    from speakingstyle_torch.serving.server import SynthesisServer

    server = SynthesisServer(frontend=TextFrontend(router.cfg, np.zeros((4, 80), np.float32)),
                             host="127.0.0.1", port=0, router=router, lifecycle=lifecycle)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


def post(server, path, body, timeout=TIMEOUT):
    import http.client

    conn = http.client.HTTPConnection(*server.address[:2], timeout=timeout)
    try:
        conn.request("POST", path, body=body)
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read() or b"{}")
    finally:
        conn.close()


def test_http_rollout_404_when_not_enabled():
    p = pkg("torch")
    router = p.fleet.FleetRouter(vfactory(0.0, []), rollout_cfg(p), replicas=1)
    server = start_server(router)
    try:
        assert router.wait_ready(timeout=TIMEOUT)
        status, body = post(server, "/admin/rollout", json.dumps({"step": 2}))
        assert status == 404 and "not enabled" in body["error"]
    finally:
        server.shutdown()


def test_http_rollout_validation_conflict_and_outcomes():
    """400 on a malformed body, 409 while a rollout runs, 200 for aborted
    and committed outcomes, and the committed version in /healthz."""
    import http.client

    from speakingstyle_torch.serving.lifecycle import RolloutManager

    p = pkg("torch")
    built = []
    router = two_replica_router(p, built)
    entered, gate = threading.Event(), threading.Event()

    def verify_and_build(step):
        if step == 2:
            entered.set()
            assert gate.wait(timeout=TIMEOUT)
            raise RuntimeError("bad checkpoint")
        return vfactory(0.1, built), f"v{step}", {"step": step, "weights_digest": "digest5"}

    server = start_server(router, RolloutManager(router, verify_and_build, rcfg=rcfg(p),
                                                 golden=golden(p)))
    first = {}
    t = threading.Thread(target=lambda: first.update(zip(
        ("status", "body"), post(server, "/admin/rollout", json.dumps({"step": 2})))))
    try:
        status, body = post(server, "/admin/rollout", "not json")
        assert status == 400 and "JSON" in body["error"]
        for payload in ({}, {"step": "2"}, {"step": True}, [2]):
            status, body = post(server, "/admin/rollout", json.dumps(payload))
            assert status == 400 and "step" in body["error"]
        t.start()
        assert entered.wait(timeout=TIMEOUT)
        status, body = post(server, "/admin/rollout", json.dumps({"step": 3}))
        assert status == 409 and "in progress" in body["error"]
        gate.set()
        t.join(timeout=TIMEOUT)
        assert first["status"] == 200
        assert first["body"]["status"] == "aborted" and first["body"]["phase"] == "verify"
        status, body = post(server, "/admin/rollout", json.dumps({"step": 5}))
        assert status == 200 and body["status"] == "committed"
        assert body["version"] == "v5" and body["step"] == 5
        conn = http.client.HTTPConnection(*server.address[:2], timeout=TIMEOUT)
        conn.request("GET", "/healthz")
        resp = conn.getresponse()
        health = json.loads(resp.read())
        conn.close()
        assert resp.status == 200
        assert health["model"] == {"version": "v5", "step": 5, "weights_digest": "digest5"}
        assert server.model_version() == "v5"
    finally:
        gate.set()
        t.join(timeout=TIMEOUT)
        server.shutdown()
