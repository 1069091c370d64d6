"""Model lifecycle: the canary-gated, zero-downtime rolling rollout (JAX
counterpart: speakingstyle_tpu/serving/lifecycle.py:67-279).

``RolloutManager.rollout(step)`` drives a live ``FleetRouter``:

  verify   ``verify_and_build(step)`` restores the candidate checkpoint
           through the manifest check (training/checkpoint.py) and returns
           its engine factory; a corrupt or manifest-less checkpoint aborts
           here, before any replica exists.
  canary   one extra replica warms on the new weights (``start_replica``
           pins it to the candidate's factory; the router's own factory
           still builds the live version). A seeded golden set replays
           through the canary's and the live version's prepared programs:
           every canary mel must be finite and within
           ``rollout.canary_tolerance`` mean |dmel| of the live output.
           Failure drains the canary and aborts; the fleet keeps serving.
  roll     the candidate factory becomes the router's, the version is
           published (``serve_model_version``, ``X-Model-Version``, the
           /healthz model block), and the old replicas are drain-replaced
           one at a time. The canary is the +1 surge, so the READY count
           never drops below the pre-roll fleet size.
  commit   a ``rollout_committed`` (or ``rollout_aborted``) event and
           ``serve_rollouts_total{outcome=}``.

While a rollout is live the router's ``rollout_active`` holds the
autoscaler's scale-downs (serving/autoscale.py). One rollout at a time: a
concurrent ``rollout`` raises ``RolloutInProgress`` (HTTP 409). The
manager owns no replica state; on the card each replaced replica's engine
gives its graphs back once its worker returns (serving/fleet.py).
"""

import time
from typing import Callable, List, Optional

import numpy as np

from speakingstyle_torch.obs import make_lock
from speakingstyle_torch.serving.engine import SynthesisRequest
from speakingstyle_torch.serving.fleet import READY, STOPPED

__all__ = ["RolloutInProgress", "RolloutManager", "make_golden_set"]


class RolloutInProgress(RuntimeError):
    """A rollout is already running (maps to HTTP 409)."""


def make_golden_set(cfg, size: int, seed: int) -> List[SynthesisRequest]:
    """The seeded canary corpus: deterministic requests sized inside the
    serving lattice (short sequences, a reference mel in the smallest
    style bucket), so the canary replay never compiles a new shape and
    the same seed reproduces the same gate bit-for-bit."""
    rng = np.random.default_rng(seed)
    # the set replays as ONE batch through the AOT lattice, so it must
    # never exceed the largest batch bucket — on a small lattice the
    # gate would otherwise die on RequestTooLarge instead of gating
    size = min(size, max(cfg.serve.batch_buckets))
    src = min(cfg.serve.src_buckets[0], 12)
    ref = cfg.serve.style.ref_buckets[0]
    reqs = []
    for i in range(size):
        reqs.append(SynthesisRequest(
            id=f"golden{i}",
            sequence=rng.integers(1, 300, src).astype(np.int32),
            ref_mel=rng.standard_normal((ref, 80)).astype(np.float32),
        ))
    return reqs


class RolloutManager:
    """Drives verify -> canary -> roll -> commit/abort over a live fleet.

    ``verify_and_build(step)`` is the trust boundary with the training
    stack: it restores the candidate checkpoint strictly (manifest
    verified) and returns ``(engine_factory, version, info)`` where
    ``info`` carries at least ``step`` and ``weights_digest``; any
    exception it raises aborts the rollout in the verify phase.
    ``golden`` optionally overrides the generated golden set (a list of
    SynthesisRequest, or a zero-arg callable producing one).
    """

    def __init__(self, router, verify_and_build: Callable,
                 autoscaler=None, events=None, registry=None,
                 rcfg=None, golden=None):
        self.router = router
        self.verify_and_build = verify_and_build
        self.autoscaler = autoscaler
        self.events = events if events is not None else router.events
        self.registry = registry if registry is not None else router.registry
        self.rcfg = rcfg if rcfg is not None else router.cfg.serve.rollout
        self.golden = golden
        self._lock = make_lock("RolloutManager._lock")

    # -- observability -------------------------------------------------------

    def _emit(self, kind: str, **fields) -> None:
        if self.events is not None:
            self.events.emit(kind, **fields)

    def _count(self, outcome: str) -> None:
        self.registry.counter(
            "serve_rollouts_total", labels={"outcome": outcome},
            help="model rollouts by outcome (committed / aborted)",
        ).inc()

    def _abort(self, phase: str, step: int, t0: float, reason: str,
               canary_ms: Optional[float] = None, partial: bool = False):
        self._emit(
            "rollout_aborted", step=step, phase=phase, reason=reason,
            partial=partial,
            duration_ms=round((time.monotonic() - t0) * 1e3, 3),
        )
        self._count("aborted")
        out = {
            "status": "aborted", "phase": phase, "step": step,
            "reason": reason, "partial": partial,
            "version": self.router.model_version,
        }
        if canary_ms is not None:
            out["canary_ms"] = round(canary_ms, 3)
        return out

    # -- the canary gate -----------------------------------------------------

    def _golden_set(self) -> List[SynthesisRequest]:
        if callable(self.golden):
            return list(self.golden())
        if self.golden is not None:
            return list(self.golden)
        return make_golden_set(
            self.router.cfg, self.rcfg.golden_set_size, self.rcfg.canary_seed
        )

    def _run_canary(self, new_engine, old_engine):
        """(ok, detail): all-finite on every canary mel, then mean
        |Δmel| parity against the live version over the overlapping
        prefix (weights-dependent duration predictions may disagree on
        length; the gate is against BROKEN weights, not retraining
        deltas)."""
        golden = self._golden_set()
        new = new_engine.run(list(golden))
        old = old_engine.run(list(golden))
        for i, (n, o) in enumerate(zip(new, old)):
            n_mel = np.asarray(n.mel, dtype=np.float32)
            o_mel = np.asarray(o.mel, dtype=np.float32)
            if not np.all(np.isfinite(n_mel)):
                return False, f"golden{i}: non-finite canary output"
            t = min(n_mel.shape[0], o_mel.shape[0])
            if t == 0:
                return False, f"golden{i}: empty canary output"
            delta = float(np.mean(np.abs(n_mel[:t] - o_mel[:t])))
            if delta > self.rcfg.canary_tolerance:
                return False, (
                    f"golden{i}: mean |dmel| {delta:.4g} exceeds "
                    f"tolerance {self.rcfg.canary_tolerance:.4g}"
                )
        return True, f"{len(golden)} golden requests within tolerance"

    # -- the operation -------------------------------------------------------

    def rollout(self, step: int) -> dict:
        """Run one full rollout to checkpoint ``step``; returns the
        outcome dict (both ``committed`` and ``aborted`` are normal
        returns — only a CONCURRENT rollout raises)."""
        if not self._lock.acquire(blocking=False):
            raise RolloutInProgress("a rollout is already in progress")
        router = self.router
        t0 = time.monotonic()
        timeout = self.rcfg.replica_timeout_s
        try:
            router.rollout_active = True  # autoscaler holds scale-downs
            self._emit("rollout_start", step=step,
                       from_version=router.model_version)
            # -- verify: strict manifest-checked restore + factory build
            try:
                factory, version, info = self.verify_and_build(step)
            except Exception as e:
                return self._abort("verify", step, t0,
                                   f"{type(e).__name__}: {e}")
            olds = sorted(i for i, s in router.states().items()
                          if s == READY)
            if not olds:
                return self._abort("canary", step, t0,
                                   "no READY replica to compare against")
            old_engine = router.engine_at(olds[0])
            # -- canary: one surge replica on the new weights
            canary_t0 = time.monotonic()
            cidx = router.start_replica(factory, version)
            if not router.wait_state(cidx, (READY, STOPPED), timeout) \
                    or router.states().get(cidx) != READY:
                router.drain_replica(cidx)
                return self._abort("canary", step, t0,
                                   "canary replica failed to warm")
            try:
                ok, detail = self._run_canary(router.engine_at(cidx),
                                              old_engine)
            except Exception as e:
                # an exception here must not escape: it would leak a
                # READY canary serving uncommitted weights (and 500 the
                # admin endpoint) — tear it down and abort like any
                # other failed gate
                router.drain_replica(cidx)
                router.wait_state(cidx, (STOPPED,), timeout)
                return self._abort(
                    "canary", step, t0, f"{type(e).__name__}: {e}",
                    canary_ms=(time.monotonic() - canary_t0) * 1e3,
                )
            canary_ms = (time.monotonic() - canary_t0) * 1e3
            self._emit("rollout_canary", step=step, passed=ok,
                       detail=detail, canary_ms=round(canary_ms, 3))
            if not ok:
                router.drain_replica(cidx)
                router.wait_state(cidx, (STOPPED,), timeout)
                return self._abort("canary", step, t0, detail,
                                   canary_ms=canary_ms)
            # -- commit the identity, then roll the old replicas one at
            # a time; the canary is the +1 surge, so READY never drops
            # below the pre-roll fleet size
            router.engine_factory = factory
            router.set_model_version(version, info.get("step"),
                                     info.get("weights_digest"))
            for k, old_idx in enumerate(olds):
                router.drain_replica(old_idx)
                if not router.wait_state(old_idx, (STOPPED,), timeout):
                    return self._abort(
                        "roll", step, t0, canary_ms=canary_ms, partial=True,
                        reason=f"replica {old_idx} failed to drain",
                    )
                if k < len(olds) - 1:
                    nidx = router.start_replica(factory, version)
                    if not router.wait_state(nidx, (READY, STOPPED),
                                             timeout) \
                            or router.states().get(nidx) != READY:
                        return self._abort(
                            "roll", step, t0, canary_ms=canary_ms,
                            partial=True,
                            reason=f"replacement {nidx} failed to warm",
                        )
            duration_ms = (time.monotonic() - t0) * 1e3
            self._emit(
                "rollout_committed", step=step, version=version,
                replicas=len(olds), canary_ms=round(canary_ms, 3),
                duration_ms=round(duration_ms, 3),
            )
            self._count("committed")
            return {
                "status": "committed", "version": version,
                "step": info.get("step"),
                "weights_digest": info.get("weights_digest"),
                "replicas": len(olds),
                "canary_ms": round(canary_ms, 3),
                "duration_ms": round(duration_ms, 3),
            }
        finally:
            router.rollout_active = False
            self._lock.release()
