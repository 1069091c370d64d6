"""PyTorch port, the fleet router (serving/fleet.py), held against the JAX
package's ``FleetRouter``.

Two layers:

* router scheduling against fake engines (no model, milliseconds): the
  cases of ``tests/test_fleet.py`` run on both packages' routers with the
  same expectations (EDF order, shed watermarks -> 429 + Retry-After apart
  from the shutdown refusals, admission, ``scale_to`` and drain);
* the tiny model of ``tests/test_torch_server.py``: a 2-replica port fleet
  over one shared model and StyleService, and a 2-replica JAX fleet over
  the same weights (carried across by ``compat.from_jax``; the JAX Pallas
  kernels in interpret mode), answer the same requests within 2 LSB at
  f32; streams through ``router.stream`` equal the depth-1 stream; steady
  fleet traffic prepares nothing.

Every router is closed in a ``finally`` or a fixture finalizer, and every
wait has a timeout.
"""

import importlib
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

from test_torch_models import one_cpu_thread  # noqa: F401 (an autouse fixture)
from test_torch_server import GEN_TOPO, STATS, jax_weights, write_configs  # noqa: F401

PKGS = ("torch", "tpu")
TIMEOUT = 60


def pkg(name):
    """One package's fleet-facing modules, by the shared module names."""
    mod = lambda m: importlib.import_module(f"speakingstyle_{name}.{m}")  # noqa: E731
    return SimpleNamespace(
        config=mod("configs.config"), fleet=mod("serving.fleet"),
        batcher=mod("serving.batcher"), engine=mod("serving.engine"),
        lattice=mod("serving.lattice"), resilience=mod("serving.resilience"),
        obs=mod("obs"), faults=mod("faults"))


def fleet_cfg(p, **fleet_kw):
    """The fake-engine tests' config: one-point lattice, 5 ms coalescing."""
    fleet = dict(queue_depth=32, stream_window=8)
    fleet.update(fleet_kw)
    c = p.config
    return c.Config(serve=c.ServeConfig(
        batch_buckets=[1], src_buckets=[16], mel_buckets=[64], frames_per_phoneme=2,
        max_wait_ms=5.0, fleet=c.FleetConfig(**fleet)))


class FakeFleetEngine:
    """Replica stand-in: records dispatch order; ``gate`` holds the first
    dispatch until set."""

    def __init__(self, gate=None):
        self.dispatches = []
        self.gate = gate
        self.entered = threading.Event()
        self._first = True
        self.lock = threading.Lock()

    def precompile(self):
        return 0.0

    def run(self, requests):
        if self.gate is not None and self._first:
            self._first = False
            self.entered.set()
            self.gate.wait(timeout=TIMEOUT)
        with self.lock:
            self.dispatches.extend(r.id for r in requests)
        return [SimpleNamespace(id=r.id, bucket=None, mel_len=1) for r in requests]


def req(p, i, L=8, T=4, **kw):
    return p.engine.SynthesisRequest(id=f"r{i}", sequence=np.ones(L, np.int32),
                                     ref_mel=np.zeros((T, 80), np.float32), **kw)


def wait_for(pred, timeout=TIMEOUT):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.005)
    return pred()


# ---------------------------------------------------------------------------
# router scheduling (fake engines): both packages, the same expectations
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", PKGS)
def test_router_edf_ordering_under_contention(name):
    """Interactive requests admitted after a batch backlog dispatch first:
    the heap orders by SLO deadline, not arrival."""
    p = pkg(name)
    gate = threading.Event()
    eng = FakeFleetEngine(gate=gate)
    router = p.fleet.FleetRouter(lambda reg: eng, fleet_cfg(p), replicas=1)
    try:
        assert router.wait_ready(timeout=TIMEOUT)
        futs = [router.submit(req(p, 0))]
        assert eng.entered.wait(timeout=TIMEOUT)
        futs.append(router.submit(req(p, 1, priority="batch")))
        futs.append(router.submit(req(p, 2, priority="batch")))
        futs.append(router.submit(req(p, 3, priority="interactive")))
        futs.append(router.submit(req(p, 4, priority="interactive")))
        gate.set()
        for f in futs:
            f.result(timeout=TIMEOUT)
    finally:
        gate.set()
        router.close()
    assert eng.dispatches == ["r0", "r3", "r4", "r1", "r2"]


@pytest.mark.parametrize("name", PKGS)
def test_router_shed_vs_reject_counters(name):
    """Backpressure sheds count serve_shed_total and raise Overloaded with
    the configured Retry-After before a drain rate exists; shutdown
    refusals count serve_rejected_total and raise ShutdownError."""
    p = pkg(name)
    reg = p.obs.MetricsRegistry()
    gate = threading.Event()

    def factory(registry):
        gate.wait(timeout=TIMEOUT)  # hold the replica in WARMING
        return FakeFleetEngine()

    cfg = fleet_cfg(p, queue_depth=4, shed_high_watermark=0.5, shed_low_watermark=0.25,
                    shed_retry_after_s=3.0)
    router = p.fleet.FleetRouter(factory, cfg, replicas=1, registry=reg)
    futs, sheds = [], 0
    try:
        assert router.states() == {0: p.fleet.WARMING}
        for i in range(6):
            try:
                futs.append(router.submit(req(p, i)))
            except p.batcher.Overloaded as e:
                sheds += 1
                assert e.retry_after_s == 3.0
        assert sheds == 4
        assert reg.value("serve_shed_total") == 4 and reg.value("serve_rejected_total") == 0
        assert reg.value("serve_class_shed_total", {"class": "interactive"}) == 4
    finally:
        gate.set()
        router.close(flush=False)
    with pytest.raises(p.batcher.ShutdownError):
        router.submit(req(p, 99))
    assert reg.value("serve_rejected_total") == 1 and reg.value("serve_shed_total") == 4
    for f in futs:
        assert isinstance(f.exception(timeout=TIMEOUT), p.batcher.ShutdownError)


@pytest.mark.parametrize("name", PKGS)
def test_router_admission_validates_class_and_geometry(name):
    p = pkg(name)
    router = p.fleet.FleetRouter(lambda reg: FakeFleetEngine(), fleet_cfg(p), replicas=1)
    try:
        with pytest.raises(ValueError, match="priority class"):
            router.submit(req(p, 0, priority="best-effort"))
        with pytest.raises(p.lattice.RequestTooLarge):
            router.submit(req(p, 1, L=17))  # src bucket max 16
        with pytest.raises(ValueError, match="deadline_ms"):
            router.submit(req(p, 2, deadline_ms=-1.0))
    finally:
        router.close()


@pytest.mark.parametrize("name", PKGS)
def test_router_scale_to_drains_replicas(name):
    """scale_to(1) drains the newest replica; the survivor still serves;
    close() stops every replica."""
    p = pkg(name)
    engines = [FakeFleetEngine(), FakeFleetEngine()]
    router = p.fleet.FleetRouter(lambda reg: engines.pop(0), fleet_cfg(p), replicas=2)
    try:
        assert router.wait_ready(timeout=TIMEOUT, n=2)
        assert router.live_replica_count() == 2
        router.scale_to(1)
        assert wait_for(lambda: router.states()[1] in (p.fleet.DRAINING, p.fleet.STOPPED))
        assert router.states()[0] == p.fleet.READY and router.live_replica_count() == 1
        assert router.submit(req(p, 5)).result(timeout=TIMEOUT).id == "r5"
        with pytest.raises(ValueError, match="n >= 0"):
            router.scale_to(-1)
    finally:
        router.close()
    assert all(s == p.fleet.STOPPED for s in router.states().values())
    with pytest.raises(p.batcher.ShutdownError):
        router.scale_to(3)


@pytest.mark.parametrize("name", PKGS)
def test_class_deadline_resolves_deadline_exceeded(name):
    """A request that waits past its class budget resolves as
    DeadlineExceeded (504) with its class and budget, counted per class,
    even while the only replica is still warming; another class's budget
    is its own."""
    p = pkg(name)
    gate = threading.Event()

    def factory(registry):
        gate.wait(timeout=TIMEOUT)
        return FakeFleetEngine()

    reg = p.obs.MetricsRegistry()
    cfg = fleet_cfg(p, class_deadline_ms={"interactive": 60.0, "batch": 30_000.0},
                    rewarm_backoff_s=0.05)
    router = p.fleet.FleetRouter(factory, cfg, replicas=1, registry=reg)
    try:
        fast = router.submit(req(p, 0))
        slow = router.submit(req(p, 1, priority="batch"))
        exc = fast.exception(timeout=TIMEOUT)
        assert isinstance(exc, p.resilience.DeadlineExceeded)
        assert exc.klass == "interactive" and exc.budget_ms == 60.0
        assert reg.value("serve_deadline_exceeded_total", {"class": "interactive"}) == 1
        assert not slow.done()
        gate.set()
        assert slow.result(timeout=TIMEOUT).id == "r1"
    finally:
        gate.set()
        router.close()


def test_autoscaler_signals_and_model_version_match_jax():
    """The surface the autoscaler and the rollout read, on both routers
    over the same scripted state: pending depth, live count, occupancy,
    the measured warm-up cost and the model version gauge."""
    out = {}
    for name in PKGS:
        p = pkg(name)
        gate = threading.Event()
        eng = FakeFleetEngine(gate=gate)
        reg = p.obs.MetricsRegistry()
        router = p.fleet.FleetRouter(lambda r, e=eng: e, fleet_cfg(p), replicas=1, registry=reg)
        try:
            assert router.wait_ready(timeout=TIMEOUT)
            futs = [router.submit(req(p, 0))]
            assert eng.entered.wait(timeout=TIMEOUT)
            futs += [router.submit(req(p, i)) for i in (1, 2)]
            signals = (router.pending_depth(), router.live_replica_count(), router.occupancy(),
                       router.warmup_cost_s() is not None)
            router.set_model_version("7:abc", 7, "abcdef")
            gate.set()
            for f in futs:
                f.result(timeout=TIMEOUT)
            out[name] = signals + (reg.value("serve_model_version"), router.model_version,
                                   router.pending_depth(), router.dispatch_total)
        finally:
            gate.set()
            router.close()
    assert out["torch"] == out["tpu"]
    assert out["torch"][:3] == (2, 1, 1.0) and out["torch"][4] == 7


@pytest.mark.parametrize("bad", [
    dict(shed_high_watermark=0.3, shed_low_watermark=0.5), dict(replicas=0),
    dict(default_class="turbo"), dict(class_deadline_ms={"interactive": -1.0}),
    dict(stream_window=0), dict(hang_watchdog_s=-1.0), dict(retry_budget={"batch": -1}),
    dict(rewarm_backoff_s=0.0), dict(rewarm_backoff_s=2.0, rewarm_backoff_max_s=1.0),
])
def test_fleet_config_validation_as_jax(bad):
    """Each bad fleet block is refused by both packages' FleetConfig."""
    for name in PKGS:
        with pytest.raises(ValueError):
            pkg(name).config.FleetConfig(**bad)


# ---------------------------------------------------------------------------
# the tiny model: a 2-replica port fleet against a 2-replica JAX fleet
# ---------------------------------------------------------------------------

# batch 1 only, so every dispatch has the same padding in both fleets
FLEET_SERVE = {
    "batch_buckets": [1], "src_buckets": [16], "mel_buckets": [48], "frames_per_phoneme": 2,
    "max_wait_ms": 1.0, "style": {"ref_buckets": [32]},
    "fleet": {"stream_window": 4, "queue_depth": 64,
              "class_deadline_ms": {"interactive": 60_000.0, "batch": 120_000.0}},
}


def tiny_requests(p, n, stream=False):
    rng = np.random.default_rng(31)
    return [p.engine.SynthesisRequest(
        id=f"u{i}", sequence=rng.integers(1, 300, 5 + i % 4).astype(np.int32),
        ref_mel=rng.standard_normal((12 + 3 * (i % 5), 80)).astype(np.float32), stream=stream)
        for i in range(n)]


def port_parts(tmp, weights, serve=FLEET_SERVE):
    """(cfg, model, vocoder, shared StyleService, factory) of a port fleet
    over the JAX ``weights``: every replica shares the model, the vocoder
    and the StyleService."""
    from speakingstyle_torch.compat.from_jax import load_flax_variables
    from speakingstyle_torch.configs.config import load_config
    from speakingstyle_torch.models import hifigan as th
    from speakingstyle_torch.models.fastspeech2 import FastSpeech2
    from speakingstyle_torch.obs import MetricsRegistry
    from speakingstyle_torch.serving.engine import SynthesisEngine
    from speakingstyle_torch.serving.style import StyleService

    cfg = load_config(*write_configs(tmp, serve))
    variables, gparams = weights
    model = load_flax_variables(FastSpeech2(cfg, **STATS), variables).eval()
    gen = load_flax_variables(th.Generator(80, **GEN_TOPO), {"params": gparams}).eval()
    registry = MetricsRegistry()
    style = StyleService(cfg, model.reference_encoder, device="cpu", registry=registry)

    def factory(reg):
        return SynthesisEngine(cfg, model=model, vocoder=gen, device="cpu", registry=reg,
                               style=style)

    return SimpleNamespace(cfg=cfg, model=model, gen=gen, style=style, factory=factory,
                           registry=registry)


@pytest.fixture(scope="module")
def fleets(jax_weights, tmp_path_factory):  # noqa: F811
    """{"torch": router, "tpu": router}, two ready replicas each, over the
    same weights and config; closed at the module's end."""
    from speakingstyle_tpu.configs.config import load_config as j_load
    from speakingstyle_tpu.models import hifigan as jh
    from speakingstyle_tpu.models.fastspeech2 import FastSpeech2 as JFS2
    from speakingstyle_tpu.obs import MetricsRegistry as JRegistry
    from speakingstyle_tpu.ops import pallas_attention
    from speakingstyle_tpu.serving.engine import SynthesisEngine as JEngine
    from speakingstyle_tpu.serving.fleet import FleetRouter as JRouter
    from speakingstyle_tpu.serving.style import StyleService as JStyle
    from speakingstyle_torch.serving.fleet import FleetRouter

    tmp = tmp_path_factory.mktemp("fleet")
    parts = port_parts(tmp, jax_weights)
    variables, gparams = jax_weights
    jcfg = j_load(*write_configs(tmp, FLEET_SERVE))
    jmodel, jgen = JFS2(config=jcfg, **STATS), jh.Generator(**GEN_TOPO)
    jreg = JRegistry()
    jstyle = JStyle(jcfg, variables, registry=jreg)

    def jfactory(reg):
        return JEngine(jcfg, variables, vocoder=(jgen, gparams), model=jmodel, registry=reg,
                       style=jstyle)

    out = {"torch": FleetRouter(parts.factory, parts.cfg, replicas=2, registry=parts.registry,
                                style=parts.style)}
    pallas_attention.FORCE_INTERPRET = True
    try:
        out["tpu"] = JRouter(jfactory, jcfg, replicas=2, registry=jreg, style=jstyle)
        for router in out.values():
            assert router.wait_ready(timeout=600, n=2)
    finally:
        pallas_attention.FORCE_INTERPRET = False
    yield SimpleNamespace(routers=out, parts=parts)
    for router in out.values():
        router.close()


def submit_all(router, requests):
    """Submit every request at once (so both replicas dispatch) and return
    the results by id."""
    futs = [router.submit(r) for r in requests]
    return {f.result(timeout=300).id: f.result() for f in futs}


def test_two_replica_fleet_matches_jax_fleet(fleets):
    """The same 8 requests through both 2-replica fleets: every wav within
    2 int16 LSB of the JAX fleet's, both port replicas dispatch, the
    replicas' engines share one StyleService, and the port fleet's steady
    traffic prepares nothing."""
    router, jrouter = fleets.routers["torch"], fleets.routers["tpu"]
    engines = router.engines()
    assert len(engines) == 2 and engines[0].style is engines[1].style is router.style
    assert engines[0].model is engines[1].model
    compiles = router.registry.value("serve_compiles_total")
    style_compiles = router.registry.value("serve_style_compiles_total")
    got = submit_all(router, tiny_requests(pkg("torch"), 8))
    want = submit_all(jrouter, tiny_requests(pkg("tpu"), 8))
    assert sorted(got) == sorted(want) == [f"u{i}" for i in range(8)]
    for rid, r in got.items():
        w = want[rid]
        assert r.mel_len == w.mel_len and r.wav.shape == np.asarray(w.wav).shape
        assert np.abs(r.wav.astype(np.int32) - np.asarray(w.wav).astype(np.int32)).max() <= 2
        assert r.replica in (0, 1)
    served = [router.registry.value("serve_replica_requests_total", {"replica": str(i)})
              for i in (0, 1)]
    assert sum(served) >= 8
    assert router.registry.value("serve_compiles_total") == compiles
    assert router.registry.value("serve_style_compiles_total") == style_compiles


def test_both_replicas_dispatch_under_concurrent_load(fleets):
    """Enough concurrent requests that each replica takes dispatches; the
    shared StyleService resolves a repeated reference from its cache on
    either replica."""
    router = fleets.routers["torch"]
    p = pkg("torch")
    before = [router.registry.value("serve_replica_dispatches_total", {"replica": str(i)})
              for i in (0, 1)]
    ref = np.random.default_rng(5).standard_normal((20, 80)).astype(np.float32)
    encodes = router.style.dispatch_count
    reqs = [p.engine.SynthesisRequest(id=f"c{i}", sequence=np.arange(1, 7, dtype=np.int32),
                                      ref_mel=ref) for i in range(16)]
    results = submit_all(router, reqs)
    after = [router.registry.value("serve_replica_dispatches_total", {"replica": str(i)})
             for i in (0, 1)]
    assert all(a > b for a, b in zip(after, before)), (before, after)
    wavs = [results[f"c{i}"].wav for i in range(16)]
    assert all(np.array_equal(w, wavs[0]) for w in wavs)
    # the reference is encoded once, or once by each replica when both
    # missed the cache at the same time; never again after that
    assert 1 <= router.style.dispatch_count - encodes <= 2


def test_fleet_stream_equals_depth1_stream(fleets):
    """A stream through ``router.stream`` (the replica that produced the
    result, depth 2) equals the depth-1 stream of the same result, and
    records TTFA."""
    from speakingstyle_torch.serving import streaming

    router = fleets.routers["torch"]
    p = pkg("torch")
    ttfa0 = router.registry.histogram("serve_ttfa_seconds").count
    results = submit_all(router, tiny_requests(p, 4, stream=True))
    fleet = router.cfg.serve.fleet
    for r in results.values():
        assert r.wav is None and r.mel_len > fleet.stream_window
        engine = router.engine_at(r.replica)
        overlap = streaming.resolve_overlap(fleet.stream_overlap, engine.vocoder)
        got = np.concatenate(list(router.stream(r, arrival=time.monotonic())))
        want = np.concatenate(list(streaming.stream_wav(engine, r, fleet.stream_window,
                                                        overlap, depth=1)))
        np.testing.assert_array_equal(got, want)
        assert got.shape == (r.mel_len * engine.vocoder.hop_factor,)
    assert router.registry.histogram("serve_ttfa_seconds").count == ttfa0 + 4


def test_shared_style_service_holds_under_concurrent_encodes(fleets):
    """Several threads encode distinct references through the shared
    service at once (as two replicas' dispatch threads do): each style
    equals the one encoded alone, and each reference is encoded once."""
    style = fleets.parts.style
    rng = np.random.default_rng(9)
    mels = [rng.standard_normal((10 + i, 80)).astype(np.float32) for i in range(6)]
    alone = [style.encode_mels([m], eager=True)[0] for m in mels]
    style.clear()
    encodes = style.dispatch_count
    out = [None] * (2 * len(mels))
    start = threading.Event()

    def worker(k):
        start.wait(timeout=TIMEOUT)
        out[k] = style.encode_mel(mels[k % len(mels)])

    threads = [threading.Thread(target=worker, args=(k,)) for k in range(len(out))]
    for t in threads:
        t.start()
    start.set()
    for t in threads:
        t.join(timeout=TIMEOUT)
    for k, sv in enumerate(out):
        np.testing.assert_array_equal(sv.gamma, alone[k % len(mels)].gamma)
        np.testing.assert_array_equal(sv.beta, alone[k % len(mels)].beta)
    # a reference raced by two threads may be encoded by both, never more
    assert len(mels) <= style.dispatch_count - encodes <= len(out)
    assert len(style) >= len(mels)


def test_engine_refuses_a_style_without_a_reference_encoder(fleets):
    import dataclasses

    from speakingstyle_torch.serving.engine import SynthesisEngine

    parts = fleets.parts
    cfg = dataclasses.replace(parts.cfg, model=dataclasses.replace(
        parts.cfg.model, use_reference_encoder=False))
    with pytest.raises(ValueError, match="use_reference_encoder"):
        SynthesisEngine(cfg, model=parts.model, vocoder=parts.gen, device="cpu",
                        style=parts.style)


def test_engine_close_gives_its_programs_back(fleets):
    """``close()`` drops a prepared engine's programs; the next dispatch
    prepares again (and is counted), and the shared StyleService stays."""
    parts = fleets.parts
    engine = parts.factory(parts.registry.__class__())
    engine.precompile()
    assert engine.is_ready and len(engine.program_registry) > 0
    engine.close()
    assert not engine.is_ready and len(engine.program_registry) == 0
    assert parts.style.is_ready
    before = engine.compile_count
    r = engine.run(tiny_requests(pkg("torch"), 1))[0]
    assert r.wav is not None and engine.compile_count == before + 2  # acoustic + vocoder
