"""PyTorch port, the quality tiers (serving/tiers.py), held against the JAX
package's ``TierRouter`` and ``tier_gate`` (the twin of
``tests/test_tiers.py``'s routing, gate and mixed-tier cases; the casts
and the precision lattice are ``tests/test_torch_serve_core.py``'s).

* Routing, both packages' classes over stub routers: the tier grammar,
  class -> tier with the failed-gate fallback, and ``routing_table()``
  equal between the packages.
* The gate on real engines: a port engine and a JAX engine over the same
  weights (carried across by ``compat.from_jax``; the JAX Pallas kernels
  in interpret mode), tiers f32 / bf16 / int8. The same ship or fail
  verdict, and ``mel_l2`` within: 0 for f32 (the anchor against itself);
  4e-4 for int8 (both dequantize to the same f32 weights and compute in
  f32: each mel within the f32 bar of 2e-4 of the other's); 0.25 x JAX's
  own ``mel_l2`` + 4e-4 for bf16 (the two packages round bf16 at different
  places, ``BF16_SHARE`` of tests/test_torch_serve_core.py). A poisoned
  tier is refused by both.
* The mixed-tier fleet: three port ``FleetRouter``s of one replica, each
  with its own engine at its tier's precision over the shared weights and
  the one StyleService, behind one ``TierRouter`` behind the HTTP server:
  classes reach their tiers and results carry them (``X-Model-Tier``), the
  dispatch counters tally per tier, nothing is prepared in traffic, the
  teacher-f32 tier's wavs are within 2 LSB of the JAX engine's, and a tier
  poisoned through the fleet's ``tier_poison`` fault fails its gate and its
  class falls back to teacher-f32. /healthz carries the ``tiers`` block.
"""

import dataclasses
import importlib
import json
from types import SimpleNamespace

import jax
import numpy as np
import pytest

from test_torch_models import one_cpu_thread  # noqa: F401 (an autouse fixture)
from test_torch_server import (  # noqa: F401 (jax_weights is a fixture)
    GEN_TOPO, SERVE_ONE, STATS, build_port_engine, call, jax_weights, pcm, start, stop,
    write_configs)

PKGS = ("torch", "tpu")
TIMEOUT = 120
PRECISIONS = ("f32", "bf16", "int8")
TIERS = {"enabled": True, "precisions": list(PRECISIONS),
         "class_tier": {"interactive": "teacher-bf16", "batch": "teacher-int8"},
         "tier_tolerance": 2.0, "golden_set_size": 4}
# "offline": a configured class no tier claims, so it rides the default tier
SERVE_TIERS = dict(SERVE_ONE, batch_buckets=[1, 2, 4], tiers=TIERS, fleet=dict(
    SERVE_ONE["fleet"], class_deadline_ms={"interactive": 30000.0, "batch": 60000.0,
                                           "offline": 60000.0}))
# the gate's mel_l2 between the packages (module docstring)
F32_BAR = 2e-4
BF16_SHARE = 0.25


def pkg(name):
    mod = lambda m: importlib.import_module(f"speakingstyle_{name}.{m}")  # noqa: E731
    return SimpleNamespace(config=mod("configs.config"), tiers=mod("serving.tiers"),
                           engine=mod("serving.engine"), obs=mod("obs"))


def tiers_cfg(p, **tiers_kw):
    tiers = dict(TIERS, class_tier={"interactive": "student-int8", "batch": "teacher-bf16"},
                 golden_set_size=2)
    tiers.update(tiers_kw)
    c = p.config
    return c.Config(serve=c.ServeConfig(batch_buckets=[1, 2], src_buckets=[16],
                                        mel_buckets=[32], frames_per_phoneme=2,
                                        tiers=c.TiersConfig(**tiers)))


class StubRouter:
    def __init__(self):
        self.submitted = []

    def submit(self, request):
        self.submitted.append(request)
        return request

    def close(self, **kw):
        pass


def gate(p, tier, mel_l2, tol=0.5):
    return p.tiers.TierGateResult(tier=tier, mel_l2=mel_l2, tolerance=tol,
                                  shipped=mel_l2 <= tol, detail="test")


def req(p, i, priority=None, L=10, T=20):
    rng = np.random.default_rng(i)
    return p.engine.SynthesisRequest(id=f"utt{i}", sequence=rng.integers(1, 300, L).astype(
        np.int32), ref_mel=rng.standard_normal((T, 80)).astype(np.float32), priority=priority)


# -- routing over stub routers -----------------------------------------------------

@pytest.mark.parametrize("name", ["teacher-f32", "student-int8", "teacher-bf16", "studnt-int8",
                                  "teacher", "teacher-fp64", "x-y-z", ""])
def test_parse_tier_grammar_as_jax(name):
    out = {}
    for k in PKGS:
        try:
            spec = pkg(k).tiers.parse_tier(name)
            out[k] = (spec.name, spec.model, spec.precision)
        except ValueError:
            out[k] = "ValueError"
    assert out["torch"] == out["tpu"]


@pytest.mark.parametrize("name", PKGS)
def test_class_routing_and_canary_fail_fallback(name):
    p = pkg(name)
    cfg = tiers_cfg(p)
    router = p.tiers.TierRouter(cfg)
    anchor, bf16, student = StubRouter(), StubRouter(), StubRouter()
    router.add_tier("teacher-f32", anchor)
    router.add_tier("teacher-bf16", bf16, gate=gate(p, "teacher-bf16", 0.1))
    router.add_tier("student-int8", student, gate=gate(p, "student-int8", 0.2, tol=2.0))
    assert router.tier_for("interactive") == "student-int8"
    assert router.tier_for("batch") == "teacher-bf16"
    assert router.tier_for(None) == "student-int8"  # the default class
    assert router.tier_for("unmapped") == "teacher-f32"
    r = req(p, 1, priority="interactive")
    router.submit(r)
    assert student.submitted == [r] and r.precision == "int8"
    assert router.registry.value("serve_tier_dispatch_total", {"tier": "student-int8"}) == 1
    assert router.registry.value("serve_tier_canary_total",
                                 {"tier": "teacher-bf16", "outcome": "shipped"}) == 1

    failed = p.tiers.TierRouter(cfg)
    failed.add_tier("teacher-f32", anchor)
    failed.add_tier("teacher-bf16", bf16, gate=gate(p, "teacher-bf16", 0.1))
    failed.add_tier("student-int8", student, gate=gate(p, "student-int8", 3.0, tol=2.0))
    assert not failed.shipped("student-int8")
    assert failed.routing_table()["interactive"] == "teacher-f32"
    assert failed.routing_table()["batch"] == "teacher-bf16"
    r = req(p, 2, priority="interactive")
    failed.submit(r)
    assert anchor.submitted[-1] is r and r.precision == "f32"
    assert failed.registry.value("serve_tier_canary_total",
                                 {"tier": "student-int8", "outcome": "failed"}) == 1
    assert failed.registry.value("serve_tier_mel_l2", {"tier": "student-int8"}) == 3.0


ROUTINGS = {
    "all_ship": ({"interactive": "teacher-bf16", "batch": "teacher-int8"},
                 {"teacher-bf16": 0.1, "teacher-int8": 0.2}),
    "int8_fails": ({"interactive": "teacher-bf16", "batch": "teacher-int8"},
                   {"teacher-bf16": 0.1, "teacher-int8": 0.9}),
    "unregistered": ({"interactive": "student-bf16", "long_form": "teacher-int8"},
                     {"teacher-int8": 0.4}),
    "none_mapped": ({}, {"teacher-bf16": 0.1}),
}


@pytest.mark.parametrize("case", sorted(ROUTINGS))
def test_routing_table_equals_jax(case):
    """The same tiers and gate verdicts give the same effective class ->
    tier map and the same fallbacks in both packages."""
    class_tier, l2s = ROUTINGS[case]
    tables = {}
    for k in PKGS:
        p = pkg(k)
        router = p.tiers.TierRouter(tiers_cfg(p, class_tier=class_tier))
        router.add_tier("teacher-f32", StubRouter())
        for tier, l2 in l2s.items():
            router.add_tier(tier, StubRouter(), gate=gate(p, tier, l2))
        tables[k] = (router.routing_table(), router.tiers(),
                     [router.tier_for(c) for c in (None, "interactive", "batch", "long_form",
                                                   "nope")],
                     {t: router.shipped(t) for t in ("teacher-f32", "teacher-bf16",
                                                     "teacher-int8", "student-bf16")})
    assert tables["torch"] == tables["tpu"]


@pytest.mark.parametrize("name", PKGS)
def test_facade_reads_through_to_the_default_tier(name):
    p = pkg(name)
    router = p.tiers.TierRouter(tiers_cfg(p))
    anchor = StubRouter()
    anchor.model_version, anchor.lattice = "3:abc", "the-lattice"
    router.add_tier("teacher-f32", anchor)
    assert router.model_version == "3:abc" and router.lattice == "the-lattice"
    with pytest.raises(AttributeError):
        router.no_such_attribute


# -- the gate on real engines ------------------------------------------------------

@pytest.fixture(scope="module")
def gate_engines(jax_weights, tmp_path_factory):  # noqa: F811
    """(JAX engine, port engine), tiers f32 / bf16 / int8, the same weights
    and the serve block ``SERVE_TIERS``; the JAX kernels in interpret mode
    for the module."""
    from speakingstyle_tpu.configs.config import load_config as j_load
    from speakingstyle_tpu.models import hifigan as jh
    from speakingstyle_tpu.models.fastspeech2 import FastSpeech2 as JFS2
    from speakingstyle_tpu.ops import pallas_attention
    from speakingstyle_tpu.serving.engine import SynthesisEngine as JEngine

    tmp = tmp_path_factory.mktemp("tiers")
    variables, gparams = jax_weights
    engine = build_port_engine(tmp, jax_weights, serve=SERVE_TIERS)
    jcfg = j_load(*write_configs(tmp, serve=SERVE_TIERS))
    pallas_attention.FORCE_INTERPRET = True
    try:
        with jax.default_prng_impl("threefry2x32"):
            jengine = JEngine(jcfg, variables, vocoder=(jh.Generator(**GEN_TOPO), gparams),
                              model=JFS2(config=jcfg, **STATS))
            yield jengine, engine
    finally:
        pallas_attention.FORCE_INTERPRET = False


def gates(tier, jengine, engine, **kw):
    from speakingstyle_tpu.serving.tiers import tier_gate as j_gate
    from speakingstyle_torch.serving.tiers import tier_gate

    return (tier_gate(engine, engine, engine.cfg, tier, **kw),
            j_gate(jengine, jengine, jengine.cfg, tier, **kw))


@pytest.mark.parametrize("tier", ["teacher-f32", "teacher-bf16", "teacher-int8"])
def test_tier_gate_matches_jax(gate_engines, tier):
    jengine, engine = gate_engines
    got, want = gates(tier, jengine, engine)
    assert got.shipped == want.shipped is True, (got.detail, want.detail)
    bound = {"teacher-f32": 0.0, "teacher-int8": 2 * F32_BAR,
             "teacher-bf16": BF16_SHARE * want.mel_l2 + 2 * F32_BAR}[tier]
    assert abs(got.mel_l2 - want.mel_l2) <= bound, (got.mel_l2, want.mel_l2)
    assert got.tolerance == want.tolerance == 2.0 and got.gate_ms > 0
    assert got.as_dict().keys() == want.as_dict().keys()
    assert got.detail.split(",")[0] == want.detail.split(",")[0] == "4 golden requests"


@pytest.mark.parametrize("tier", ["teacher-bf16", "teacher-int8"])
def test_tier_gate_tight_tolerance_fails_both(gate_engines, tier):
    jengine, engine = gate_engines
    got, want = gates(tier, jengine, engine, tolerance=1e-9)
    assert got.shipped is want.shipped is False
    assert "EXCEEDS" in got.detail and "EXCEEDS" in want.detail


def test_tier_gate_refuses_a_poisoned_tier_as_jax(gate_engines, tmp_path):
    """The bf16 tree poisoned in place (``poison_params``, the tier_poison
    fault's action) fails the gate in both packages; nothing is prepared."""
    jengine, _ = gate_engines
    engine = build_port_engine(tmp_path, None, serve=SERVE_TIERS)
    engine.precompile()
    compiles = engine.compile_count
    saved = jengine._params_by_precision["bf16"]
    try:
        assert engine.poison_params("bf16") == jengine.poison_params("bf16") == "bf16"
        got, want = gates("teacher-bf16", jengine, engine)
    finally:
        jengine._params_by_precision["bf16"] = saved
    assert got.shipped is want.shipped is False
    assert got.mel_l2 > got.tolerance and want.mel_l2 > want.tolerance
    assert engine.compile_count == compiles


# -- the mixed-tier fleet behind the server ----------------------------------------

def tier_fleets(cfg, model, vocoder, registry, fault_plans=None):
    """{tier: FleetRouter of one ready replica} for the three teacher tiers
    (serving/tiers.py ``tier_fleets``: an engine each over the shared
    weights and one StyleService; a FaultPlan each, by name)."""
    from speakingstyle_torch.serving.tiers import tier_fleets as build

    fleets = build(cfg, model, vocoder, ("teacher-f32", "teacher-bf16", "teacher-int8"),
                   device="cpu", registry=registry, fault_plans=fault_plans)
    for f in fleets.values():
        assert f.wait_ready(timeout=TIMEOUT)
    return fleets


@pytest.fixture(scope="module")
def tier_server(jax_weights, tmp_path_factory):  # noqa: F811
    """A SynthesisServer over a TierRouter of three one-replica fleets
    (every tier's gate shipped), the int8 fleet's fault plan, the JAX
    engine over the same weights; shut down at the module's end."""
    from speakingstyle_tpu.configs.config import load_config as j_load
    from speakingstyle_tpu.models import hifigan as jh
    from speakingstyle_tpu.models.fastspeech2 import FastSpeech2 as JFS2
    from speakingstyle_tpu.ops import pallas_attention
    from speakingstyle_tpu.serving.engine import SynthesisEngine as JEngine
    from speakingstyle_torch.faults import FaultPlan
    from speakingstyle_torch.obs import MetricsRegistry
    from speakingstyle_torch.serving.frontend import TextFrontend
    from speakingstyle_torch.serving.server import SynthesisServer
    from speakingstyle_torch.serving.tiers import TierRouter, tier_gate

    tmp = tmp_path_factory.mktemp("tier_fleet")
    base = build_port_engine(tmp, jax_weights, serve=SERVE_TIERS)
    cfg, registry, plan = base.cfg, MetricsRegistry(), FaultPlan()
    fleets = tier_fleets(cfg, base.model, base.vocoder, registry,
                         fault_plans={"teacher-int8": plan})
    router = TierRouter(cfg, registry=registry)
    teacher = fleets["teacher-f32"].engines()[0]
    for tier, fleet in fleets.items():
        router.add_tier(tier, fleet, gate=None if tier == "teacher-f32" else tier_gate(
            fleet.engines()[0], teacher, cfg, tier))
    ref = np.random.default_rng(0).standard_normal((20, 80)).astype(np.float32)
    server = SynthesisServer(frontend=TextFrontend(cfg, ref), host="127.0.0.1", port=0,
                             router=router)
    thread = start(server)
    jcfg = j_load(*write_configs(tmp, serve=SERVE_TIERS))
    variables, gparams = jax_weights
    pallas_attention.FORCE_INTERPRET = True
    try:
        with jax.default_prng_impl("threefry2x32"):
            jengine = JEngine(jcfg, variables, vocoder=(jh.Generator(**GEN_TOPO), gparams),
                              model=JFS2(config=jcfg, **STATS))
            yield SimpleNamespace(server=server, router=router, fleets=fleets, plan=plan,
                                  jengine=jengine, teacher=teacher, cfg=cfg)
    finally:
        pallas_attention.FORCE_INTERPRET = False
        stop(server, thread)


def test_mixed_tiers_route_by_class_over_http(tier_server):
    """Interactive (the default class) -> bf16, batch -> int8, offline ->
    f32: every
    answer carries its class's tier, the dispatch counters tally per tier,
    nothing is prepared, and the f32 tier's wavs are within 2 LSB of the
    JAX engine's on the same request."""
    from speakingstyle_tpu.serving.engine import SynthesisRequest as JRequest

    t = tier_server
    reg = t.router.registry
    compiles = reg.value("serve_compiles_total")
    want_tier = {"interactive": "teacher-bf16", "batch": "teacher-int8",
                 "offline": "teacher-f32", None: "teacher-bf16"}
    before = {k: reg.value("serve_tier_dispatch_total", {"tier": k}) for k in t.fleets}
    texts = ("hello there", "speak softly now", "hello world")
    f32 = []
    for i in range(12):
        klass = (None, "interactive", "batch", "offline")[i % 4]
        payload = {"text": texts[i % 3]}
        if klass is not None:
            payload["priority"] = klass
        status, headers, body = call(t.server, "POST", "/synthesize", payload)
        assert status == 200, body
        assert headers["X-Model-Tier"] == want_tier[klass]
        if klass == "offline":
            f32.append((texts[i % 3], pcm(body)))
    after = {k: reg.value("serve_tier_dispatch_total", {"tier": k}) - before[k]
             for k in t.fleets}
    assert after == {"teacher-f32": 3, "teacher-bf16": 6, "teacher-int8": 3}
    assert reg.value("serve_compiles_total") == compiles
    fe = t.server.frontend
    for text, wav in f32:
        want = t.jengine.run([JRequest(id="j", sequence=fe.sequence(text),
                                       ref_mel=fe.default_ref_mel)])[0]
        assert wav.shape == want.wav.shape
        assert np.abs(wav.astype(np.int32) - want.wav.astype(np.int32)).max() <= 2


def test_healthz_carries_the_tiers_block_as_jax_routes(tier_server):
    from speakingstyle_tpu.serving.tiers import TierGateResult as JGate
    from speakingstyle_tpu.serving.tiers import TierRouter as JRouter

    t = tier_server
    status, _, body = call(t.server, "GET", "/healthz")
    health = json.loads(body)
    assert status == 200 and health["ready"]
    tiers = health["tiers"]
    assert tiers["default"] == "teacher-f32"
    assert tiers["gates"]["teacher-f32"] == {"shipped": True, "detail": "ungated anchor"}
    for name in ("teacher-bf16", "teacher-int8"):
        g = tiers["gates"][name]
        assert g["shipped"] and g["tier"] == name and g["mel_l2"] <= g["tolerance"]
    assert set(health["replicas"]) == set(t.fleets)
    jcfg = t.jengine.cfg
    jr = JRouter(jcfg)
    for name in t.fleets:
        g = t.router.gate_result(name)
        jr.add_tier(name, StubRouter(), gate=None if g is None else JGate(**dataclasses.asdict(g)))
    assert tiers["routing"] == jr.routing_table()


def test_longform_through_the_tier_router(tier_server):
    """A chapter rides the long-form class's tier (batch -> teacher-int8)."""
    t = tier_server
    status, headers, body = call(t.server, "POST", "/synthesize/longform",
                                 {"text": "hello there. speak softly now. hello world."})
    assert status == 200, body
    assert headers["X-Longform-Tier"] == "chunked"
    assert headers["X-Model-Tier"] == t.router.tier_for(t.server.longform.klass) == "teacher-int8"
    assert pcm(body).size > 0


def test_tier_poison_fails_the_gate_and_the_class_falls_back(tier_server):
    """``tier_poison`` armed on the int8 fleet's next dispatch: the dispatch
    succeeds and the replica stays ready (the drill's point: only the
    quality plane can tell), its gate against the anchor then fails,
    and re-registered with that verdict the tier leaves the routing table:
    ``batch`` falls back to teacher-f32. Runs last in the module."""
    from speakingstyle_torch.serving.tiers import tier_gate

    t = tier_server
    fleet = t.fleets["teacher-int8"]
    t.plan.arm("tier_poison", fleet.dispatch_total + 1)
    status, headers, _ = call(t.server, "POST", "/synthesize",
                              {"text": "hello there", "priority": "batch"})
    # the dispatch itself succeeds: the garbage is served (200) or the
    # server's validators catch it (500 with X-Audio-Quality)
    assert status == 200 or (status == 500 and headers["X-Audio-Quality"].startswith("fail:"))
    assert t.plan.pending() == [] and t.fleets["teacher-int8"].states() == {0: "ready"}
    g = tier_gate(fleet.engines()[0], t.teacher, t.cfg, "teacher-int8")
    assert not g.shipped and g.mel_l2 > g.tolerance
    t.router.add_tier("teacher-int8", fleet, gate=g)
    assert t.router.tier_for("batch") == "teacher-f32"
    status, headers, _ = call(t.server, "POST", "/synthesize",
                              {"text": "hello there", "priority": "batch"})
    assert status == 200 and headers["X-Model-Tier"] == "teacher-f32"
    assert t.router.registry.value("serve_tier_canary_total",
                                   {"tier": "teacher-int8", "outcome": "failed"}) == 1


def test_an_engine_built_during_a_preparation_waits_for_it(tmp_path):
    """Building a tier's engine casts its tree on the device, which would
    invalidate another engine's graph capture in flight (the card's capture
    mode is process-wide): the constructor holds the device gate shared, so
    it waits while a preparation holds it exclusively."""
    import threading

    from speakingstyle_torch.parallel.registry import DEVICE_GATE

    built, done = [], threading.Event()

    def build():
        built.append(build_port_engine(tmp_path, None, serve=SERVE_TIERS))
        done.set()

    with DEVICE_GATE.exclusive():
        thread = threading.Thread(target=build, daemon=True)
        thread.start()
        assert not done.wait(timeout=3.0)
        assert not built
    assert done.wait(timeout=TIMEOUT)
    thread.join(timeout=TIMEOUT)
    assert not thread.is_alive() and built[0].precisions == ("f32", "bf16", "int8")
