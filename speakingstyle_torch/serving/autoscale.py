"""Closed-loop fleet autoscaler: the policy thread that drives
``FleetRouter.scale_to()`` from the signals the router exports (JAX
counterpart: speakingstyle_tpu/serving/autoscale.py:62-271).

Every ``interval_s`` it reads the pending-heap depth against fractions of
``fleet.queue_depth`` (below the shed watermark, so capacity grows before
the router sheds), the READY replicas' dispatch occupancy (pressure only
with a backlog of one a live replica, floor 2, held a full tick), and the
shed + deadline-miss counters differentiated into a pressure rate. It
decides up / down / hold with disjoint thresholds, cooldowns and hard
``[min_replicas, max_replicas]`` bounds: a scale-up adds one replica
(``max_step`` past twice the up watermark); a scale-down drains one, only
after every down condition held for a calm window stretched by the
measured warm-up cost (p50 of ``serve_replica_warmup_seconds``;
``assumed_warmup_s`` before the first). A live rollout
(``router.rollout_active``) holds every scale-down.

Each decision shows as the ``serve_autoscale_target`` gauge, the
``serve_autoscale_decisions_total{reason=}`` counter and an ``autoscale``
event with the signal values. The loop waits on a ``threading.Event``, so
``close()`` stops it within a tick. Probe-class traffic is invisible to
every signal (the router leaves it out). On one card a scale-up warms a
whole lattice of CUDA graphs: the warm-up cost the policy measures is that
preparation, and the memory each replica's graphs take is the bound on
``max_replicas`` (PERF.md section 5).
"""

import threading
import time
from typing import Optional

from speakingstyle_torch.serving.batcher import ShutdownError

__all__ = ["Autoscaler"]


class Autoscaler:
    """Policy thread driving ``router.scale_to()`` from router signals.

    ``acfg`` is a ``configs.config.AutoscaleConfig``. The registry and
    event log default to the router's own, so decisions land in the same
    /metrics scrape and events.jsonl as the dispatches they react to.
    Tests drive the policy synchronously: construct with ``start=False``
    and call ``step(now=...)`` with an explicit clock.
    """

    def __init__(self, router, acfg, registry=None, events=None,
                 start: bool = True):
        self.router = router
        self.acfg = acfg
        self.registry = registry if registry is not None else router.registry
        self.events = events if events is not None else router.events
        self._target_gauge = self.registry.gauge(
            "serve_autoscale_target",
            help="replica count the autoscaler last asked scale_to() for",
        )
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # no cooldown at birth: a fleet born under pressure may grow on
        # the very first tick
        self._last_up: Optional[float] = None
        self._last_scale: Optional[float] = None
        self._calm_since: Optional[float] = None
        self._occ_hot_since: Optional[float] = None
        self._last_tick: Optional[float] = None
        self._last_pressure = self._pressure_total()
        self._target = router.live_replica_count()
        self._target_gauge.set(self._target)
        if start:
            self._thread = threading.Thread(
                target=self._loop, name="fleet-autoscaler", daemon=True
            )
            self._thread.start()

    # -- signals -------------------------------------------------------------

    def _pressure_total(self) -> float:
        """Cumulative shed + deadline-miss count (the miss counter is a
        per-class family, so the family is summed)."""
        total = self.registry.value("serve_shed_total")
        for m in self.registry.metrics_named("serve_deadline_miss_total"):
            total += m.value
        return total

    def warmup_cost_s(self) -> float:
        """The scale-up cost model: measured warm-up p50 when at least
        one warm-up has been sampled, ``assumed_warmup_s`` before."""
        measured = self.router.warmup_cost_s()
        return measured if measured is not None else self.acfg.assumed_warmup_s

    # -- policy --------------------------------------------------------------

    def step(self, now: Optional[float] = None) -> Optional[str]:
        """One policy evaluation; returns the decision reason (or None
        for hold). Safe to call concurrently with traffic — every signal
        read takes the router's own locks."""
        a = self.acfg
        now = time.monotonic() if now is None else now
        depth = self.router.pending_depth()
        live = self.router.live_replica_count()
        occ = self.router.occupancy()
        cap = self.router.fleet.queue_depth
        pressure = self._pressure_total()
        dt = (now - self._last_tick) if self._last_tick is not None \
            else a.interval_s
        rate = max(0.0, pressure - self._last_pressure) / max(dt, 1e-9)
        self._last_tick = now
        self._last_pressure = pressure

        # a live rollout holds every scale-DOWN: the canary surge would
        # read as "over max_replicas" and a calm window must not drain
        # the replica about to become the fleet (serving/lifecycle.py);
        # scale-ups stay allowed — an upgrade under pressure still grows
        rolling = bool(getattr(self.router, "rollout_active", False))

        # the floor is min_replicas OR the router's own (a ClusterRouter
        # publishes its readiness quorum as scale_floor — draining below
        # it would wedge /healthz at 503 with the fleet nominally calm)
        floor = max(a.min_replicas, int(getattr(self.router,
                                                "scale_floor", 0)))

        # bound enforcement outranks hysteresis: an out-of-bounds fleet
        # (operator scale_to, config change) is corrected immediately
        if live < floor:
            return self._decide("up", "min_bound", floor, now,
                                depth=depth, live=live, occupancy=occ,
                                pressure_rate=rate)
        if live > a.max_replicas:
            if rolling:
                return None
            return self._decide("down", "max_bound", a.max_replicas, now,
                                depth=depth, live=live, occupancy=occ,
                                pressure_rate=rate)

        up_depth = a.up_queue_fraction * cap
        # occupancy is an instantaneous busy-fraction sample: it only
        # counts as pressure with a real backlog (>= one per live
        # replica, floor 2) held across consecutive ticks
        occ_hot = occ >= a.up_occupancy and depth >= max(live, 2)
        occ_sustained = (occ_hot and self._occ_hot_since is not None
                         and now - self._occ_hot_since >= a.interval_s)
        if occ_hot:
            if self._occ_hot_since is None:
                self._occ_hot_since = now
        else:
            self._occ_hot_since = None
        reason = None
        if depth >= up_depth:
            reason = "queue_depth"
        elif occ_sustained:
            reason = "occupancy"
        elif rate > 0.0 and rate >= a.up_pressure_rate:
            reason = "pressure"
        if reason is not None:
            self._calm_since = None  # pressure resets the calm streak
            if live >= a.max_replicas:
                return None  # saturated: nothing to add
            if self._last_up is not None \
                    and now - self._last_up < a.cooldown_up_s:
                return None  # within cooldown: let the last grow land
            step_n = a.max_step if depth >= 2.0 * up_depth else 1
            target = min(live + step_n, a.max_replicas)
            return self._decide("up", reason, target, now, depth=depth,
                                live=live, occupancy=occ,
                                pressure_rate=rate)

        calm = (depth <= a.down_queue_fraction * cap
                and occ <= a.down_occupancy and rate == 0.0)
        if not calm:
            self._calm_since = None
            return None
        if self._calm_since is None:
            self._calm_since = now
        if live <= floor:
            return None
        # the calm window scales with what the capacity COST to build:
        # a replica that took 30 s to warm is not shed after 5 quiet
        # seconds of a bursty curve
        required = max(a.down_stable_s,
                       a.warmup_cost_factor * self.warmup_cost_s())
        if now - self._calm_since < required:
            return None
        if self._last_scale is not None \
                and now - self._last_scale < a.cooldown_down_s:
            return None
        if rolling:
            self._calm_since = None  # the calm streak restarts post-roll
            return None
        return self._decide("down", "calm", live - 1, now, depth=depth,
                            live=live, occupancy=occ, pressure_rate=rate,
                            calm_s=now - self._calm_since,
                            required_calm_s=required)

    def _decide(self, direction: str, reason: str, target: int,
                now: float, **signals) -> Optional[str]:
        try:
            self.router.scale_to(target)
        except ShutdownError:
            return None  # router closed under us: the loop exits next tick
        self._target = target
        self._target_gauge.set(target)
        self._last_scale = now
        if direction == "up":
            self._last_up = now
        self._calm_since = None if direction == "up" else now
        self.registry.counter(
            "serve_autoscale_decisions_total",
            labels={"reason": reason},
            help="autoscaler scale_to() calls by triggering reason",
        ).inc()
        if self.events is not None:
            self.events.emit(
                "autoscale", decision=direction, reason=reason,
                target=target, warmup_cost_s=round(self.warmup_cost_s(), 3),
                queue_cap=self.router.fleet.queue_depth,
                # the most recent pressure-pinned trace: an example of
                # the traffic that tripped (or calmed) this decision
                trace_id=getattr(self.router,
                                 "last_pressure_trace_id", None),
                **{k: (round(v, 4) if isinstance(v, float) else v)
                   for k, v in signals.items()},
            )
        return reason

    # -- lifecycle -----------------------------------------------------------

    @property
    def target(self) -> int:
        return self._target

    def _loop(self) -> None:
        # stop-aware tick: Event.wait doubles as the interval timer, so
        # close() interrupts a parked policy thread immediately
        while not self._stop.wait(self.acfg.interval_s):
            try:
                self.step()
            except ShutdownError:
                return

    def close(self, timeout: float = 5.0) -> None:
        """Idempotent: stop the policy loop; the fleet stays at its
        current size (shutting the policy down never resizes)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            self._thread = None
