"""Quality tiers: class -> tier routing over canary-gated tiers (JAX
counterpart: speakingstyle_tpu/serving/tiers.py:52-294).

A **tier** is a (model, precision) pair named ``<model>-<precision>``:
``teacher-f32`` is the full-precision anchor, ``teacher-bf16`` /
``teacher-int8`` the engine's narrower programs over the same weights,
``student-*`` the distilled acoustic model. Each tier is a whole
``FleetRouter`` whose engines prepare the lattice at the tier's precision;
the ``TierRouter`` in front of them has the router surface, so the HTTP
server talks to it as it talks to a ``FleetRouter``.

The quality door: before a tier joins the routing table, ``tier_gate``
replays the seeded golden set (lifecycle.make_golden_set, the rollout
canary's corpus) through the candidate tier's engine and the teacher-f32
anchor's, and the tier ships only if its worst golden-set mel-L2 against
the anchor holds under ``serve.tiers.tier_tolerance`` and its output is
finite. A tier that fails its gate stays registered but out of the
routing table: its classes fall back to ``serve.tiers.default_tier``, so
routing degrades in quality, never in availability.

On one card each tier's router gets an engine of its own over the shared
weights and the one StyleService (``tier_fleets``): a replica's
``poison_params`` and ``close`` act on its engine, so two tiers must not
share one, though the program registry's replay lock would keep two
workers' replays of one graph apart. The gate's ``engine.run`` calls hold
the device gate shared like any dispatch: they replay prepared programs
while the other tiers serve.

Metrics: ``serve_tier_dispatch_total{tier}`` counts routed submits,
``serve_tier_canary_total{tier,outcome}`` the gate's verdicts and
``serve_tier_mel_l2{tier}`` each gated tier's measured distance.
"""

import time
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional

import numpy as np

from speakingstyle_torch.obs import MetricsRegistry
from speakingstyle_torch.parallel.registry import PRECISIONS
from speakingstyle_torch.serving.engine import SynthesisRequest, SynthesisResult
from speakingstyle_torch.serving.lifecycle import make_golden_set

__all__ = ["TierGateResult", "TierRouter", "TierSpec", "parse_tier", "tier_fleets", "tier_gate"]


@dataclass(frozen=True)
class TierSpec:
    """One parsed tier name: which weights, at what precision."""

    name: str        # "teacher-f32", "student-int8", ...
    model: str       # "teacher" | "student"
    precision: str   # a registry.PRECISIONS member


def parse_tier(name: str) -> TierSpec:
    """``<model>-<precision>`` -> TierSpec (``TiersConfig`` checks the same
    grammar, so names from a config never raise)."""
    model, sep, precision = name.partition("-")
    if not sep or model not in ("teacher", "student") or precision not in PRECISIONS:
        raise ValueError(
            f"tier name must be '<model>-<precision>' with model in (teacher, student) and "
            f"precision in {PRECISIONS}, got {name!r}")
    return TierSpec(name=name, model=model, precision=precision)


@dataclass
class TierGateResult:
    """The verdict of one golden-set quality gate."""

    tier: str
    mel_l2: float          # worst RMS mel distance against the teacher anchor
    tolerance: float
    shipped: bool
    detail: str
    gate_ms: float = 0.0

    def as_dict(self) -> Dict:
        return {"tier": self.tier, "mel_l2": self.mel_l2, "tolerance": self.tolerance,
                "shipped": self.shipped, "detail": self.detail,
                "gate_ms": round(self.gate_ms, 3)}


def tier_gate(candidate_engine, teacher_engine, cfg, tier: str,
              tolerance: Optional[float] = None) -> TierGateResult:
    """Replay the golden set through the candidate's and the teacher's
    engines and gate the tier on the worst golden-set mel-L2 (RMS over
    the overlapping mel prefix: a narrower tier's duration predictor may
    disagree on length; the gate measures spectral damage) and on finite
    output. Both engines run the set directly (``engine.run``, not through
    a router), at the rollout canary's batch shape, so on a prepared
    lattice the gate prepares nothing."""
    tiers = cfg.serve.tiers
    tol = float(tolerance if tolerance is not None else tiers.tier_tolerance)
    spec = parse_tier(tier)
    golden = make_golden_set(cfg, tiers.golden_set_size, tiers.golden_seed)
    t0 = time.monotonic()
    # the candidate gets its own copies: run() updates a request in place
    cand_reqs = [SynthesisRequest(id=f"{g.id}.cand", sequence=g.sequence.copy(),
                                  ref_mel=None if g.ref_mel is None else g.ref_mel.copy(),
                                  precision=spec.precision) for g in golden]
    cand = candidate_engine.run(cand_reqs)
    anchor = teacher_engine.run(list(golden))
    worst = 0.0
    for i, (c, a) in enumerate(zip(cand, anchor)):
        c_mel = np.asarray(c.mel, dtype=np.float32)
        a_mel = np.asarray(a.mel, dtype=np.float32)
        if not np.all(np.isfinite(c_mel)):
            return TierGateResult(tier=tier, mel_l2=float("inf"), tolerance=tol, shipped=False,
                                  detail=f"golden{i}: non-finite tier output",
                                  gate_ms=(time.monotonic() - t0) * 1e3)
        t = min(c_mel.shape[0], a_mel.shape[0])
        if t == 0:
            return TierGateResult(tier=tier, mel_l2=float("inf"), tolerance=tol, shipped=False,
                                  detail=f"golden{i}: empty tier output",
                                  gate_ms=(time.monotonic() - t0) * 1e3)
        worst = max(worst, float(np.sqrt(np.mean(np.square(c_mel[:t] - a_mel[:t])))))
    shipped = worst <= tol
    detail = (f"{len(golden)} golden requests, worst mel_l2 {worst:.4g} "
              f"{'within' if shipped else 'EXCEEDS'} tolerance {tol:.4g}")
    return TierGateResult(tier=tier, mel_l2=worst, tolerance=tol, shipped=shipped,
                          detail=detail, gate_ms=(time.monotonic() - t0) * 1e3)


def tier_fleets(cfg, model, vocoder, names, device=None, registry=None,
                fault_plans=None, events=None) -> Dict[str, object]:
    """{tier: FleetRouter of one replica} for teacher tiers over weights
    loaded once: each tier's replica is an engine of its own over
    ``model`` / ``vocoder`` at the tier's precision (a lattice of that one
    precision), all sharing one StyleService over the model's encoder (a
    fleet's ``style``) and ``registry``. Engines are not shared between
    tiers: a replica's ``poison_params`` and ``close`` act on its engine.
    A tier's FaultPlan comes from ``fault_plans`` by name: an ``@N`` counts
    one router's dispatches. The fleets warm in the background."""
    from speakingstyle_torch.serving.engine import SynthesisEngine
    from speakingstyle_torch.serving.fleet import FleetRouter
    from speakingstyle_torch.serving.lattice import BucketLattice
    from speakingstyle_torch.serving.style import StyleService

    serve = cfg.serve
    registry = registry if registry is not None else MetricsRegistry()
    style = None
    if cfg.model.use_reference_encoder:
        style = StyleService(cfg, model.reference_encoder, device=device, registry=registry)
    fleets: Dict[str, object] = {}
    for name in names:
        spec = parse_tier(name)
        if spec.model != "teacher":
            raise ValueError(f"tier_fleets builds teacher tiers; {name!r} serves another model")
        lattice = BucketLattice(serve.batch_buckets, serve.src_buckets, serve.mel_buckets,
                                precisions=(spec.precision,))
        plan = (fault_plans or {}).get(name)

        def factory(reg, lattice=lattice, plan=plan):
            return SynthesisEngine(cfg, model=model, vocoder=vocoder, lattice=lattice,
                                   device=device, registry=reg, style=style, fault_plan=plan)

        fleets[name] = FleetRouter(factory, cfg, replicas=1, registry=registry,
                                   events=events, style=style, fault_plan=plan, tier=name)
    return fleets


class TierRouter:
    """One router surface over N tier routers, routed by traffic class.

    ``add_tier(name, router, gate=...)`` registers a tier; a gate with
    ``shipped=False`` keeps the tier's router alive but out of the routing
    table (its classes fall back to ``default_tier``). What the facade does
    not define (the model-lifecycle surface, the autoscaler's signals,
    ``lattice``, ``fault_plan``, ...) reads through to the default tier's
    router, so the HTTP server and the RolloutManager drive a TierRouter as
    they drive a FleetRouter."""

    def __init__(self, cfg, registry: Optional[MetricsRegistry] = None):
        tiers = cfg.serve.tiers
        self.cfg = cfg
        self.tiers_cfg = tiers
        self.registry = registry if registry is not None else MetricsRegistry()
        self.default_tier = tiers.default_tier
        self._routers: Dict[str, object] = {}
        self._gates: Dict[str, TierGateResult] = {}

    # -- the tier table -----------------------------------------------------

    def add_tier(self, name: str, router, gate: Optional[TierGateResult] = None) -> None:
        """Register one tier's router; ``gate=None`` means ungated (the
        default tier: the anchor gates itself by identity)."""
        parse_tier(name)
        self._routers[name] = router
        if gate is not None:
            self._gates[name] = gate
            self.registry.counter(
                "serve_tier_canary_total",
                labels={"tier": name, "outcome": "shipped" if gate.shipped else "failed"},
                help="tier quality-gate verdicts (golden-set mel_l2 vs the teacher anchor "
                     "under serve.tiers.tier_tolerance)").inc()
            self.registry.gauge(
                "serve_tier_mel_l2", labels={"tier": name},
                help="measured golden-set mel_l2 of this tier vs the teacher-f32 anchor "
                     "(the gate's number)").set(gate.mel_l2)

    def tiers(self) -> List[str]:
        return sorted(self._routers)

    def shipped(self, name: str) -> bool:
        """A tier serves traffic only if it exists and its gate passed (no
        gate recorded: ungated, shipped)."""
        if name not in self._routers:
            return False
        gate = self._gates.get(name)
        return gate is None or gate.shipped

    def gate_result(self, name: str) -> Optional[TierGateResult]:
        return self._gates.get(name)

    def tier_for(self, klass: Optional[str]) -> str:
        """class -> shipped tier name; the default tier when the class is
        unmapped or its tier failed the gate."""
        klass = klass or self.cfg.serve.fleet.default_class
        name = self.tiers_cfg.class_tier.get(klass, self.default_tier)
        if not self.shipped(name):
            name = self.default_tier
        return name

    def routing_table(self) -> Dict[str, str]:
        """The effective class -> tier map, fallbacks applied (the
        /healthz ``tiers`` block)."""
        classes = set(self.cfg.serve.fleet.class_deadline_ms)
        classes.update(self.tiers_cfg.class_tier)
        return {k: self.tier_for(k) for k in sorted(classes)}

    def router_for(self, name: str):
        return self._routers[name]

    @property
    def _default_router(self):
        return self._routers[self.default_tier]

    # -- the router surface -------------------------------------------------

    def submit(self, request: SynthesisRequest):
        """Route one request to its class's tier: stamp the tier's
        precision on it (the engine picks the tree and program by it) and
        hand it to that tier's router."""
        tier = self.tier_for(request.priority)
        request.precision = parse_tier(tier).precision
        self.registry.counter("serve_tier_dispatch_total", labels={"tier": tier},
                              help="requests routed to each quality tier").inc()
        return self._routers[tier].submit(request)

    def stream(self, result: SynthesisResult,
               arrival: Optional[float] = None) -> Iterator[np.ndarray]:
        """A stream's windows vocode on the tier that produced the result."""
        tier = result.tier or self.default_tier
        return self._routers[tier].stream(result, arrival)

    def ready(self) -> bool:
        """Ready when the default tier is (every class's fallback); other
        tiers warming only narrow the routing."""
        return self._default_router.ready()

    def wait_ready(self, timeout: float = 120.0, n: Optional[int] = None) -> bool:
        return self._default_router.wait_ready(timeout, n)

    def states(self) -> Dict[str, Dict[int, str]]:
        """Each tier's replica states (tier -> {index: state})."""
        return {name: r.states() for name, r in sorted(self._routers.items())}

    def engines(self) -> List:
        out = []
        for _, r in sorted(self._routers.items()):
            out.extend(r.engines())
        return out

    def close(self, flush: bool = True, timeout: float = 30.0) -> None:
        for r in self._routers.values():
            r.close(flush=flush, timeout=timeout)

    def __getattr__(self, attr):
        # model_version, rollout_active, pending_depth, fault_plan,
        # lattice, ...: the default tier's router
        if attr.startswith("__") or attr in ("_routers", "_gates"):
            raise AttributeError(attr)
        return getattr(self._default_router, attr)

    def __enter__(self) -> "TierRouter":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False
