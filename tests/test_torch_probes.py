"""PyTorch port, the golden probes (serving/probes.py) and
``StyleService.encode_live``, held against the JAX package's (the probe
cases of ``tests/test_quality_plane.py``).

* Over canned routers, both packages with the same expectations: probe
  targets, the anchor layout with its digest check, the drift edge and
  the probe class's quality stream, probe errors kept out of it; the probe
  class invisible to the fleet's autoscaler signals, and the fleet's
  ``tier_poison`` fault poisoning in place while the replica serves on.
* Across the packages: each reads the anchors the other pinned (the same
  ``manifest.json``, ``.npz`` keys and sha256 digests), from canned
  outputs exactly and from real engines over the same weights (carried
  across by ``compat.from_jax``; the JAX Pallas kernels in interpret mode)
  within the f32 bars: mel drift <= 2e-4 (the engines' mel bar), style
  drift <= 1e-5 (the StyleService twin's bar).
* ``encode_live`` against the JAX ``encode_live`` within 1e-5, one encoder
  dispatch a call, and the cache's hits, misses and entries untouched.
* The drill on the port's fleet: a prober over a TierRouter of three
  one-replica tier fleets pins, reads zero drift, then pages on the tier
  poisoned through ``tier_poison`` and on no other.
"""

import importlib
import threading
from concurrent.futures import Future
from types import SimpleNamespace

import jax
import numpy as np
import pytest

from test_torch_models import one_cpu_thread  # noqa: F401 (an autouse fixture)
from test_torch_server import (  # noqa: F401 (jax_weights is a fixture)
    GEN_TOPO, SERVE_ONE, STATS, build_port_engine, jax_weights, write_configs)
from test_torch_tiers import SERVE_TIERS, tier_fleets

PKGS = ("torch", "tpu")
TIMEOUT = 60
MEL_BAR = 2e-4
STYLE_BAR = 1e-5
SERVE_PROBE = dict(SERVE_ONE, batch_buckets=[1, 2, 4])


def pkg(name):
    mod = lambda m: importlib.import_module(f"speakingstyle_{name}.{m}")  # noqa: E731
    return SimpleNamespace(config=mod("configs.config"), probes=mod("serving.probes"),
                           engine=mod("serving.engine"), fleet=mod("serving.fleet"),
                           obs=mod("obs"), faults=mod("faults"))


class EventSink:
    def __init__(self):
        self.records = []

    def emit(self, event, **fields):
        self.records.append(dict(fields, event=event))


def probe_cfg(p, **qkw):
    q = dict(probe_mel_tolerance=0.5, probe_style_tolerance=0.5, probe_interval_s=0.01)
    q.update(qkw)
    c = p.config
    return c.Config(serve=c.ServeConfig(batch_buckets=[1, 2, 4], src_buckets=[16],
                                        mel_buckets=[64], frames_per_phoneme=2, max_wait_ms=5.0,
                                        style=c.StyleConfig(ref_buckets=[32]),
                                        quality=c.QualityConfig(**q)))


class CannedRouter:
    """A one-tier router of deterministic mels by request id; ``scale``
    injects drift, ``boom`` an availability failure."""

    tier = "t0"

    def __init__(self):
        self.scale, self.boom, self.submitted = 1.0, False, []

    def submit(self, req):
        self.submitted.append(req)
        fut = Future()
        if self.boom:
            fut.set_exception(RuntimeError("replica unreachable"))
        else:
            rng = np.random.default_rng(int(req.id.replace("golden", "")) + 5)
            fut.set_result(SimpleNamespace(
                mel=rng.standard_normal((24, 80)).astype(np.float32) * self.scale, mel_len=24))
        return fut


class CannedStyle:
    """``encode_live`` only: the prober never touches the cache."""

    def __init__(self):
        self.scale = 1.0

    def encode_live(self, mel, speaker=None):
        base = np.asarray(mel, np.float32).mean(axis=0)[:8]
        return SimpleNamespace(gamma=base * self.scale, beta=-base * self.scale)


# -- canned routers, both packages --------------------------------------------------

@pytest.mark.parametrize("name", PKGS)
def test_probe_targets_shapes(name):
    probes = pkg(name).probes
    r = CannedRouter()
    assert probes.probe_targets(r) == [("t0", r)]
    tiered = SimpleNamespace(tiers=lambda: ["a", "b"], router_for=lambda t: t + "!")
    assert probes.probe_targets(tiered) == [("a", "a!"), ("b", "b!")]
    assert probes.probe_targets(SimpleNamespace(submit=None))[0][0] == "default"


@pytest.mark.parametrize("name", PKGS)
def test_anchor_pin_load_and_digest_verification(name, tmp_path):
    p = pkg(name)
    cfg, router = probe_cfg(p), CannedRouter()
    d = str(tmp_path / "anchors")
    manifest = p.probes.pin_anchors(router, cfg, d, style=CannedStyle())
    size = cfg.serve.tiers.golden_set_size
    assert len(manifest["tiers"]["t0"]) == size == len(manifest["style"])
    assert {r.priority for r in router.submitted} == {"probe"}
    _, mels, styles = p.probes.load_anchors(d)
    assert set(mels["t0"]) == set(manifest["tiers"]["t0"])
    assert all(g.shape == b.shape for g, b in styles.values())
    gid = sorted(mels["t0"])[0]
    np.savez(tmp_path / "anchors" / "t0" / f"{gid}.npz", mel=np.zeros((24, 80), np.float32))
    with pytest.raises(ValueError, match="digest mismatch"):
        p.probes.load_anchors(d)


@pytest.mark.parametrize("pinner,reader", [("torch", "tpu"), ("tpu", "torch")])
def test_each_package_reads_the_anchors_the_other_pinned(pinner, reader, tmp_path):
    """Canned outputs pinned by one package load bit-equal in the other,
    with the same manifest (bar its timestamp), and the other's prober
    reads zero drift against them."""
    d = str(tmp_path)
    manifest = pkg(pinner).probes.pin_anchors(CannedRouter(), probe_cfg(pkg(pinner)), d,
                                              style=CannedStyle())
    got = pkg(reader).probes.load_anchors(d)
    want = pkg(pinner).probes.load_anchors(d)
    assert got[0] == want[0] == manifest
    for tier in want[1]:
        for gid, mel in want[1][tier].items():
            np.testing.assert_array_equal(got[1][tier][gid], mel)
    for gid, (g, b) in want[2].items():
        np.testing.assert_array_equal(got[2][gid][0], g)
        np.testing.assert_array_equal(got[2][gid][1], b)
    p = pkg(reader)
    prober = p.probes.GoldenProber(CannedRouter(), probe_cfg(p), style=CannedStyle(),
                                   anchor_dir=d, start=False)
    s = prober.probe_once()
    assert s["tiers"]["t0"]["mel_drift"] == 0.0 and s["style_drift"] == 0.0


@pytest.mark.parametrize("name", PKGS)
def test_prober_drift_edge_and_quality_stream(name, tmp_path):
    p = pkg(name)
    cfg, reg, sink = probe_cfg(p), p.obs.MetricsRegistry(), EventSink()
    router, style = CannedRouter(), CannedStyle()
    prober = p.probes.GoldenProber(router, cfg, style=style, registry=reg, events=sink,
                                   anchor_dir=str(tmp_path), start=False)
    prober.pin()
    size = cfg.serve.tiers.golden_set_size
    s = prober.probe_once()
    assert s["tiers"]["t0"]["mel_drift"] == 0.0 and s["style_drift"] == 0.0
    assert not any(prober.alerting().values())
    assert reg.value("serve_quality_class_total", {"class": "probe"}) == 2 * size
    assert reg.value("serve_probe_total", {"tier": "t0", "outcome": "ok"}) == size
    router.scale = style.scale = 10.0
    s = prober.probe_once()
    assert s["tiers"]["t0"]["mel_drift"] > cfg.serve.quality.probe_mel_tolerance
    assert prober.alerting() == {"t0": True, "style": True}
    assert reg.value("serve_probe_drift_alerts_total", {"tier": "t0"}) == 1
    assert reg.value("serve_quality_class_fail_total", {"class": "probe"}) == 2 * size
    prober.probe_once()  # sustained: no second page
    assert reg.value("serve_probe_drift_alerts_total", {"tier": "t0"}) == 1
    assert [r["event"] for r in sink.records if r["event"].startswith("probe_drift")] == \
        ["probe_drift_alert", "probe_drift_alert"]
    router.scale = style.scale = 1.0
    prober.probe_once()
    assert prober.alerting() == {"t0": False, "style": False}
    st = prober.status()
    assert st["pinned"] and st["rounds"] == 4 and st["tiers"]["t0"]["alerting"] is False


@pytest.mark.parametrize("name", PKGS)
def test_probe_errors_stay_out_of_the_quality_stream(name, tmp_path):
    p = pkg(name)
    cfg, reg, sink, router = probe_cfg(p), p.obs.MetricsRegistry(), EventSink(), CannedRouter()
    prober = p.probes.GoldenProber(router, cfg, registry=reg, events=sink,
                                   anchor_dir=str(tmp_path), start=False)
    prober.pin()
    before = reg.value("serve_quality_class_total", {"class": "probe"})
    router.boom = True
    s = prober.probe_once()
    assert s["tiers"]["t0"]["outcomes"]["error"] == cfg.serve.tiers.golden_set_size
    assert reg.value("serve_quality_class_total", {"class": "probe"}) == before
    assert reg.value("serve_quality_class_fail_total", {"class": "probe"}) == 0
    assert prober.alerting().get("t0", False) is False
    assert all(r["stage"] == "result" for r in sink.records if r["event"] == "probe_error")


@pytest.mark.parametrize("name", PKGS)
def test_prober_requires_an_anchor_dir(name):
    p = pkg(name)
    with pytest.raises(ValueError, match="anchor_dir"):
        p.probes.GoldenProber(CannedRouter(), probe_cfg(p), start=False)


@pytest.mark.parametrize("name", PKGS)
def test_background_prober_pins_then_probes_and_stops(name, tmp_path):
    p = pkg(name)
    prober = p.probes.GoldenProber(CannedRouter(), probe_cfg(p), anchor_dir=str(tmp_path))
    try:
        deadline = threading.Event()
        for _ in range(200):
            if prober.status()["rounds"] >= 2:
                break
            deadline.wait(0.01)
        assert prober.pinned and prober.status()["rounds"] >= 2
    finally:
        prober.close()
    assert prober._thread is None


class FakeEngine:
    def __init__(self, gate=None):
        self.dispatches, self.gate, self.entered = [], gate, threading.Event()
        self._first, self.poisoned = True, False

    def precompile(self):
        return 0.0

    def poison_params(self, precision=None, scale=1e3):
        self.poisoned = True
        return precision or "f32"

    def run(self, requests):
        if self.gate is not None and self._first:
            self._first = False
            self.entered.set()
            self.gate.wait(timeout=TIMEOUT)
        self.dispatches.extend(r.id for r in requests)
        return [SimpleNamespace(id=r.id, bucket=None, mel_len=1) for r in requests]


def fleet_cfg(p):
    c = p.config
    return c.Config(serve=c.ServeConfig(batch_buckets=[1], src_buckets=[16], mel_buckets=[64],
                                        frames_per_phoneme=2, max_wait_ms=5.0,
                                        fleet=c.FleetConfig(queue_depth=32, stream_window=8)))


def freq(p, i, **kw):
    return p.engine.SynthesisRequest(id=f"r{i}", sequence=np.ones(8, np.int32),
                                     ref_mel=np.zeros((4, 80), np.float32), **kw)


@pytest.mark.parametrize("name", PKGS)
def test_probe_class_is_invisible_to_autoscaler_signals(name):
    p = pkg(name)
    reg, gate = p.obs.MetricsRegistry(), threading.Event()
    eng = FakeEngine(gate=gate)
    router = p.fleet.FleetRouter(lambda r: eng, fleet_cfg(p), replicas=1, registry=reg)
    try:
        assert router.wait_ready(timeout=TIMEOUT)
        futs = [router.submit(freq(p, 0, priority="probe"))]
        assert eng.entered.wait(timeout=TIMEOUT)
        futs += [router.submit(freq(p, 1, priority="probe")),
                 router.submit(freq(p, 2, priority="probe")),
                 router.submit(freq(p, 3, priority="interactive"))]
        assert router.pending_depth() == 1 and router.occupancy() == 0.0
        gate.set()
        for f in futs:
            f.result(timeout=TIMEOUT)
        assert reg.value("serve_probe_requests_total") == 3
        assert reg.value("serve_class_requests_total", {"class": "probe"}) == 0
        assert reg.value("serve_class_requests_total", {"class": "interactive"}) == 1
    finally:
        gate.set()
        router.close()


@pytest.mark.parametrize("name", PKGS)
def test_tier_poison_fault_poisons_in_place_and_keeps_serving(name):
    p = pkg(name)
    eng, plan = FakeEngine(), p.faults.FaultPlan()
    router = p.fleet.FleetRouter(lambda r: eng, fleet_cfg(p), replicas=1, fault_plan=plan)
    try:
        assert router.wait_ready(timeout=TIMEOUT)
        router.submit(freq(p, 0)).result(timeout=TIMEOUT)
        assert eng.poisoned is False
        plan.arm("tier_poison", router.dispatch_total + 1)
        router.submit(freq(p, 1)).result(timeout=TIMEOUT)
        assert eng.poisoned is True and router.states() == {0: "ready"}
        router.submit(freq(p, 2)).result(timeout=TIMEOUT)
        assert eng.dispatches == ["r0", "r1", "r2"]
    finally:
        router.close()


# -- real engines ---------------------------------------------------------------------

class EngineRouter:
    """A one-tier router over a bare engine (submit -> a resolved future)."""

    tier = "teacher-f32"

    def __init__(self, engine):
        self.engine = engine

    def submit(self, req):
        fut = Future()
        fut.set_result(self.engine.run([req])[0])
        return fut


@pytest.fixture(scope="module")
def engines(jax_weights, tmp_path_factory):  # noqa: F811
    """(JAX engine, port engine) over the same weights, f32, the serve
    block ``SERVE_PROBE``; the JAX kernels in interpret mode for the
    module."""
    from speakingstyle_tpu.configs.config import load_config as j_load
    from speakingstyle_tpu.models import hifigan as jh
    from speakingstyle_tpu.models.fastspeech2 import FastSpeech2 as JFS2
    from speakingstyle_tpu.ops import pallas_attention
    from speakingstyle_tpu.serving.engine import SynthesisEngine as JEngine

    tmp = tmp_path_factory.mktemp("probes")
    variables, gparams = jax_weights
    engine = build_port_engine(tmp, jax_weights, serve=SERVE_PROBE)
    engine.precompile()
    jcfg = j_load(*write_configs(tmp, serve=SERVE_PROBE))
    pallas_attention.FORCE_INTERPRET = True
    try:
        with jax.default_prng_impl("threefry2x32"):
            yield JEngine(jcfg, variables, vocoder=(jh.Generator(**GEN_TOPO), gparams),
                          model=JFS2(config=jcfg, **STATS)), engine
    finally:
        pallas_attention.FORCE_INTERPRET = False


def test_encode_live_matches_jax_and_bypasses_the_cache(engines):
    jengine, engine = engines
    style, jstyle = engine.style, jengine.style
    reg = engine.registry
    names = ("serve_style_cache_hits_total", "serve_style_cache_misses_total",
             "serve_style_cache_entries")
    before = [reg.value(n) for n in names]
    entries, d0 = len(style), style.dispatch_count
    rng = np.random.default_rng(3)
    for frames in (12, 32):
        mel = rng.standard_normal((frames, 80)).astype(np.float32)
        got, want = style.encode_live(mel), jstyle.encode_live(mel)
        np.testing.assert_allclose(got.gamma, np.asarray(want.gamma), atol=STYLE_BAR, rtol=0)
        np.testing.assert_allclose(got.beta, np.asarray(want.beta), atol=STYLE_BAR, rtol=0)
        assert got.key == want.key == style.digest_mel(mel)
        again = style.encode_live(mel)  # a repeat still dispatches
        np.testing.assert_array_equal(again.gamma, got.gamma)
        assert style.get(got.key) is None  # never inserted
    assert style.dispatch_count == d0 + 4
    assert [reg.value(n) for n in names[:2]] == before[:2] and len(style) == entries
    assert reg.value(names[2]) == before[2]


@pytest.mark.parametrize("pinner", PKGS)
def test_real_anchors_read_across_packages(engines, pinner, tmp_path):
    """One package's engine pins the golden set's mels and FiLM vectors;
    the other's prober, over its own engine on the same weights, reads them
    within the f32 bars and pages on nothing."""
    jengine, engine = engines
    eng = {"torch": engine, "tpu": jengine}
    reader = "tpu" if pinner == "torch" else "torch"
    cfg_of = {"torch": engine.cfg, "tpu": jengine.cfg}
    d = str(tmp_path)
    pkg(pinner).probes.pin_anchors(EngineRouter(eng[pinner]), cfg_of[pinner], d,
                                   style=eng[pinner].style)
    p = pkg(reader)
    cfg = cfg_of[reader]
    prober = p.probes.GoldenProber(EngineRouter(eng[reader]), cfg, style=eng[reader].style,
                                   registry=p.obs.MetricsRegistry(), anchor_dir=d, start=False)
    s = prober.probe_once()
    assert s["tiers"]["teacher-f32"]["outcomes"]["ok"] == 4
    assert s["tiers"]["teacher-f32"]["mel_drift"] <= MEL_BAR
    assert s["style_drift"] <= STYLE_BAR
    assert not any(prober.alerting().values())


def test_tier_poison_drill_pages_on_the_poisoned_tier_only(jax_weights, tmp_path):  # noqa: F811
    """A prober over a TierRouter of three port fleets: zero drift at the
    pin, then ``tier_poison`` on the int8 fleet's next dispatch; the next
    round pages on teacher-int8 alone (edge-triggered, in the events and the
    quality stream), the other tiers and the style read no drift, and
    nothing was prepared."""
    from speakingstyle_torch.faults import FaultPlan
    from speakingstyle_torch.obs import MetricsRegistry
    from speakingstyle_torch.serving.probes import GoldenProber
    from speakingstyle_torch.serving.tiers import TierRouter

    base = build_port_engine(tmp_path, jax_weights, serve=SERVE_TIERS)
    cfg, registry, plan, sink = base.cfg, MetricsRegistry(), FaultPlan(), EventSink()
    fleets = tier_fleets(cfg, base.model, base.vocoder, registry,
                         fault_plans={"teacher-int8": plan})
    router = TierRouter(cfg, registry=registry)
    for tier, fleet in fleets.items():
        router.add_tier(tier, fleet)
    style = fleets["teacher-f32"].style
    try:
        prober = GoldenProber(router, cfg, style=style, registry=registry, events=sink,
                              anchor_dir=str(tmp_path / "anchors"), start=False)
        prober.pin()
        s = prober.probe_once()
        assert all(v["mel_drift"] == 0.0 for v in s["tiers"].values()) and s["style_drift"] == 0
        compiles = registry.value("serve_compiles_total")
        fleet = fleets["teacher-int8"]
        plan.arm("tier_poison", fleet.dispatch_total + 1)
        s = prober.probe_once()  # its first dispatch poisons, and is probed
        assert plan.pending() == []
        s = prober.probe_once()
        tol = cfg.serve.quality.probe_mel_tolerance
        assert s["tiers"]["teacher-int8"]["mel_drift"] > tol
        assert s["tiers"]["teacher-f32"]["mel_drift"] == 0.0
        assert s["tiers"]["teacher-bf16"]["mel_drift"] == 0.0 and s["style_drift"] == 0.0
        assert prober.alerting() == {"teacher-int8": True}
        alerts = [r for r in sink.records if r["event"] == "probe_drift_alert"]
        assert [r["tier"] for r in alerts] == ["teacher-int8"]
        assert registry.value("serve_quality_class_fail_total", {"class": "probe"}) >= 4
        assert registry.value("serve_compiles_total") == compiles
        assert fleet.states() == {0: "ready"}
    finally:
        router.close()
