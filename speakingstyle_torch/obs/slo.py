"""Multi-window SLO burn-rate accounting over the fleet's counters (a copy
of speakingstyle_tpu/obs/slo.py over the port's ``MetricsRegistry``).

The serving stack already *counts* everything that matters — per-class
admissions, deadline misses, 504s, sheds, and the request-latency
histograms — but a cumulative counter answers "how many ever", not "are
we burning error budget RIGHT NOW".  ``SloEngine`` closes that gap with
the standard SRE multi-window multi-burn-rate construction:

  * every ``tick_s`` it samples the cumulative per-class totals from a
    ``MetricsRegistry`` (no new instrumentation on the hot path — the
    engine is a pure reader),
  * differentiates them over two sliding windows (fast: catches the
    page-worthy spike; slow: keeps a transient blip from paging),
  * publishes ``serve_slo_burn_rate{class=,window=}`` gauges, where

        burn = (bad / total) / (1 - objective)

    so burn 1.0 consumes budget exactly at the sustainable rate,
  * and fires one ``slo_alert`` JSONL event on the *transition* into
    the alerting state (both windows past threshold) plus one
    ``slo_resolved`` on the way out — edge-triggered, so a sustained
    burn does not spam the log every tick.

Each alert carries the most recently tail-sampled bad trace's id when a
span ring is attached — the operator jumps from the alert line straight
to an assembled trace of a request that burned the budget.

``/healthz`` exposes ``status()`` as the ``slo`` block; the autoscaler
and future multi-tenant quotas read the same gauges.  Construct with
``start=False`` and drive ``step(now=...)`` with an explicit clock for
tests (the same idiom as ``serving/autoscale.py``).

**The quality stream.** The same construction runs a second time over
the audio-quality good/bad counters the validator choke point
maintains (obs/quality.py: ``serve_quality_class_total`` /
``serve_quality_class_fail_total``), against
``serve.slo.quality_objectives`` — so a tier shipping garbage audio
pages exactly like a tier missing deadlines: two windows, burn-rate
gauges (``serve_slo_quality_burn_rate``), and edge-triggered
``slo_quality_alert`` / ``slo_quality_resolved`` events carrying the
exemplar trace id the ``quality_fail`` KEEP_REASON pinned.  The probe
class (live golden probes, serving/probes.py) exists ONLY in this
stream — probe traffic never appears in the latency objectives.

Zero dependencies: plain Python over the registry.
"""

import threading
import time
from typing import Dict, List, Optional, Tuple

__all__ = ["SloEngine"]

# classes the fleet labels its counters with ride in from config;
# bad = misses (served past the SLO stamp) + 504s + post-admission sheds
_BAD_COUNTERS = (
    "serve_deadline_miss_total",
    "serve_deadline_exceeded_total",
    "serve_class_shed_total",
)


class SloEngine:
    """Stop-aware policy thread differentiating SLO counters into
    fast/slow-window burn rates per traffic class."""

    def __init__(self, registry, scfg, events=None, trace_ring=None,
                 start: bool = True):
        self.registry = registry
        self.scfg = scfg
        self.events = events
        self.trace_ring = trace_ring
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # (t, {key: (total, bad)}) cumulative samples, oldest first;
        # trimmed to the slow window + one tick each step. Keys are the
        # class name for the latency stream and "q:<class>" for the
        # quality stream — both streams share one sample history
        self._samples: List[Tuple[float, Dict[str, Tuple[float, float]]]] = []
        self._alerting: Dict[str, bool] = {
            k: False for k in scfg.objectives
        }
        self._burn: Dict[Tuple[str, str], float] = {}
        # the audio-quality stream (obs/quality.py counters); absent
        # quality_objectives (a pared-down test config) disables it
        self.quality_objectives: Dict[str, float] = dict(
            getattr(scfg, "quality_objectives", None) or {}
        )
        self._q_alerting: Dict[str, bool] = {
            k: False for k in self.quality_objectives
        }
        self._q_burn: Dict[Tuple[str, str], float] = {}
        if start:
            self._thread = threading.Thread(
                target=self._loop, name="slo-engine", daemon=True
            )
            self._thread.start()

    # -- signal reads --------------------------------------------------------

    def _cumulative(self) -> Dict[str, Tuple[float, float]]:
        """{class: (total admitted, bad)} from the registry's cumulative
        counters right now."""
        out = {}
        for klass in self.scfg.objectives:
            labels = {"class": klass}
            total = self.registry.value(
                "serve_class_requests_total", labels)
            bad = 0.0
            for name in _BAD_COUNTERS:
                bad += self.registry.value(name, labels)
            # a post-admission shed resolved a request the admission
            # counter never saw finish — it still consumed budget AND
            # denominator
            total += self.registry.value("serve_class_shed_total", labels)
            out[klass] = (total, bad)
        for klass in self.quality_objectives:
            labels = {"class": klass}
            out[f"q:{klass}"] = (
                self.registry.value("serve_quality_class_total", labels),
                self.registry.value("serve_quality_class_fail_total", labels),
            )
        return out

    def _window_delta(self, now: float, window_s: float,
                      klass: str) -> Tuple[float, float]:
        """(total, bad) accumulated inside the trailing window — the
        newest sample minus the last sample at-or-before the window's
        left edge (so a window longer than the sample history degrades
        to 'since start', never to garbage)."""
        if not self._samples:
            return 0.0, 0.0
        latest = self._samples[-1][1].get(klass, (0.0, 0.0))
        edge = now - window_s
        base = None
        for t, sample in self._samples:
            if t <= edge:
                base = sample.get(klass, (0.0, 0.0))
            else:
                break
        if base is None:
            base = self._samples[0][1].get(klass, (0.0, 0.0))
        return (max(0.0, latest[0] - base[0]),
                max(0.0, latest[1] - base[1]))

    # -- policy --------------------------------------------------------------

    def step(self, now: Optional[float] = None) -> Dict[str, bool]:
        """One evaluation: sample counters, recompute both windows'
        burn rates, publish gauges, edge-trigger alerts. Returns the
        per-class alerting state (tests read it directly)."""
        now = time.monotonic() if now is None else now
        self._samples.append((now, self._cumulative()))
        horizon = now - self.scfg.slow_window_s - self.scfg.tick_s
        while len(self._samples) > 1 and self._samples[0][0] < horizon:
            self._samples.pop(0)
        for klass, objective in self.scfg.objectives.items():
            budget = 1.0 - objective
            burns = {}
            for window, window_s in (
                ("fast", self.scfg.fast_window_s),
                ("slow", self.scfg.slow_window_s),
            ):
                total, bad = self._window_delta(now, window_s, klass)
                ratio = (bad / total) if total > 0 else 0.0
                burn = ratio / budget
                burns[window] = burn
                self._burn[(klass, window)] = burn
                self.registry.gauge(
                    "serve_slo_burn_rate",
                    labels={"class": klass, "window": window},
                    help="error-budget burn rate per class and window "
                         "(1.0 = burning exactly at the sustainable "
                         "rate)",
                ).set(burn)
            firing = (burns["fast"] >= self.scfg.fast_burn_threshold
                      and burns["slow"] >= self.scfg.slow_burn_threshold)
            was = self._alerting[klass]
            if firing != was:
                self._alerting[klass] = firing
                if firing:
                    self.registry.counter(
                        "serve_slo_alerts_total",
                        labels={"class": klass},
                        help="slo_alert transitions fired per class",
                    ).inc()
                if self.events is not None:
                    trace_id = None
                    if self.trace_ring is not None:
                        trace_id = self.trace_ring.last_pinned_trace_id
                    self.events.emit(
                        "slo_alert" if firing else "slo_resolved",
                        klass=klass,
                        objective=objective,
                        fast_burn=round(burns["fast"], 3),
                        slow_burn=round(burns["slow"], 3),
                        fast_window_s=self.scfg.fast_window_s,
                        slow_window_s=self.scfg.slow_window_s,
                        trace_id=trace_id,
                    )
        for klass, objective in self.quality_objectives.items():
            budget = 1.0 - objective
            burns = {}
            for window, window_s in (
                ("fast", self.scfg.fast_window_s),
                ("slow", self.scfg.slow_window_s),
            ):
                total, bad = self._window_delta(now, window_s, f"q:{klass}")
                ratio = (bad / total) if total > 0 else 0.0
                burn = ratio / budget
                burns[window] = burn
                self._q_burn[(klass, window)] = burn
                self.registry.gauge(
                    "serve_slo_quality_burn_rate",
                    labels={"class": klass, "window": window},
                    help="audio-quality error-budget burn rate per class "
                         "and window (validator fail fraction over the "
                         "quality objective's budget)",
                ).set(burn)
            firing = (burns["fast"] >= self.scfg.fast_burn_threshold
                      and burns["slow"] >= self.scfg.slow_burn_threshold)
            was = self._q_alerting[klass]
            if firing != was:
                self._q_alerting[klass] = firing
                if firing:
                    self.registry.counter(
                        "serve_slo_quality_alerts_total",
                        labels={"class": klass},
                        help="slo_quality_alert transitions fired per class",
                    ).inc()
                if self.events is not None:
                    trace_id = None
                    if self.trace_ring is not None:
                        trace_id = self.trace_ring.last_pinned_trace_id
                    self.events.emit(
                        "slo_quality_alert" if firing
                        else "slo_quality_resolved",
                        klass=klass,
                        objective=objective,
                        fast_burn=round(burns["fast"], 3),
                        slow_burn=round(burns["slow"], 3),
                        fast_window_s=self.scfg.fast_window_s,
                        slow_window_s=self.scfg.slow_window_s,
                        trace_id=trace_id,
                    )
        return dict(self._alerting)

    def burn_rate(self, klass: str, window: str) -> float:
        return self._burn.get((klass, window), 0.0)

    def quality_burn_rate(self, klass: str, window: str) -> float:
        return self._q_burn.get((klass, window), 0.0)

    def quality_alerting(self) -> Dict[str, bool]:
        """Per-class alerting state of the quality stream (the tests'
        and bench drill's direct read)."""
        return dict(self._q_alerting)

    def quality_status(self) -> Dict:
        """The /healthz quality block's SLO view: per-class quality
        objective, both windows' burn, and the alerting flag."""
        return {
            klass: {
                "objective": objective,
                "fast_burn": round(
                    self._q_burn.get((klass, "fast"), 0.0), 4),
                "slow_burn": round(
                    self._q_burn.get((klass, "slow"), 0.0), 4),
                "alerting": self._q_alerting.get(klass, False),
            }
            for klass, objective in self.quality_objectives.items()
        }

    def status(self) -> Dict:
        """The /healthz ``slo`` block: per-class objective, both
        windows' burn, and the alerting flag."""
        return {
            klass: {
                "objective": objective,
                "fast_burn": round(self._burn.get((klass, "fast"), 0.0), 4),
                "slow_burn": round(self._burn.get((klass, "slow"), 0.0), 4),
                "alerting": self._alerting.get(klass, False),
            }
            for klass, objective in self.scfg.objectives.items()
        }

    # -- lifecycle -----------------------------------------------------------

    def _loop(self) -> None:
        # Event.wait doubles as the tick timer so close() interrupts a
        # parked engine immediately (JL016 — never a bare sleep)
        while not self._stop.wait(self.scfg.tick_s):
            self.step()

    def close(self, timeout: float = 5.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            self._thread = None
