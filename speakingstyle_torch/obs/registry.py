"""Zero-dependency, thread-safe metrics registry (a copy of the JAX
package's ``speakingstyle_tpu/obs/registry.py``; plain Python, no torch).

Three metric kinds, all plain Python + one lock each:

  * ``Counter`` — monotonically increasing float; ``inc()`` returns the
    new value.
  * ``Gauge`` — a settable level (queue depth, last loss).
  * ``Histogram`` — bounded buckets (a fixed edge list chosen at
    creation) with cumulative counts, sum, min/max, and percentile
    *estimates* (p50/p95/p99/p999 by linear interpolation inside the
    covering bucket — error bounded by one bucket width).

Metrics are identified by ``(name, labels)``; calling the factory again
with the same identity returns the same object. Export surfaces:
``registry.snapshot()`` (one nested plain dict) and
``registry.prometheus_text()`` (Prometheus exposition format).

Federation (the cluster, serving/cluster.py): ``registry.export_state()``
is the raw, JSON-safe state a replica process serves at ``GET /metrics``
(histograms as per-bin counts), and ``merge_states`` folds the replicas'
states into one ``fleet_``-prefixed registry: counters summed, histogram
buckets merged, gauges labeled by replica. A fleet percentile therefore
comes from merged buckets, never from an average of per-replica ones.

A process-global default registry (``get_registry()``) exists for call
sites with no natural owner (``retry_io``); a training run constructs its
own.
"""

import bisect
import threading
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

# Default histogram edges for latencies/durations in SECONDS: ~100 us to
# 60 s, roughly x2.5 spacing — fine enough that the interpolation error
# on a percentile is well under the scales the serving/training paths
# operate at.
DEFAULT_TIME_BUCKETS: Tuple[float, ...] = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)

_LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Optional[Mapping[str, str]]) -> _LabelKey:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _render_labels(labels: _LabelKey, extra: Sequence[Tuple[str, str]] = ()) -> str:
    pairs = list(labels) + list(extra)
    if not pairs:
        return ""
    body = ",".join(f'{k}="{v}"' for k, v in pairs)
    return "{" + body + "}"


class Counter:
    """Monotonic counter. ``inc`` returns the post-increment value."""

    kind = "counter"

    def __init__(self, name: str, labels: _LabelKey = (), help: str = ""):
        self.name = name
        self.labels = labels
        self.help = help
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, n: float = 1.0) -> float:
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease (inc {n})")
        with self._lock:
            self._value += n
            return self._value

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """A settable level; ``set``/``inc``/``dec``."""

    kind = "gauge"

    def __init__(self, name: str, labels: _LabelKey = (), help: str = ""):
        self.name = name
        self.labels = labels
        self.help = help
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    def dec(self, n: float = 1.0) -> None:
        with self._lock:
            self._value -= n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    """Bounded-bucket histogram with percentile estimates.

    ``edges`` are the ascending bucket upper bounds; observations above
    the last edge land in an implicit +Inf overflow bin. Percentiles are
    estimated by linear interpolation inside the covering bucket, with
    the tracked min/max tightening the first and overflow bins — the
    estimate error is at most one bucket width.
    """

    kind = "histogram"

    def __init__(
        self,
        name: str,
        edges: Sequence[float] = DEFAULT_TIME_BUCKETS,
        labels: _LabelKey = (),
        help: str = "",
    ):
        if not edges or sorted(edges) != list(edges) or len(set(edges)) != len(edges):
            raise ValueError(
                f"histogram {name}: edges must be strictly ascending, got {edges}"
            )
        self.name = name
        self.labels = labels
        self.help = help
        self.edges: Tuple[float, ...] = tuple(float(e) for e in edges)
        self._lock = threading.Lock()
        self._counts = [0] * (len(self.edges) + 1)  # last = overflow (+Inf)
        self._count = 0
        self._sum = 0.0
        self._min: Optional[float] = None
        self._max: Optional[float] = None

    def observe(self, v: float) -> None:
        v = float(v)
        i = bisect.bisect_left(self.edges, v)  # bin i covers (edge[i-1], edge[i]]
        with self._lock:
            self._counts[i] += 1
            self._count += 1
            self._sum += v
            if self._min is None or v < self._min:
                self._min = v
            if self._max is None or v > self._max:
                self._max = v

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def _state(self):
        with self._lock:
            return list(self._counts), self._count, self._sum, self._min, self._max

    def percentile(self, q: float) -> Optional[float]:
        """Estimated q-quantile (q in [0, 1]); None when empty."""
        counts, count, _, lo_seen, hi_seen = self._state()
        if count == 0:
            return None
        target = q * count
        cum = 0.0
        for i, c in enumerate(counts):
            if c == 0:
                continue
            prev_cum = cum
            cum += c
            if cum >= target:
                # tighten both ends with the observed range: values in
                # this bin lie within [max(prev_edge, min), min(edge, max)]
                lo = lo_seen if i == 0 else max(self.edges[i - 1], lo_seen)
                hi = self.edges[i] if i < len(self.edges) else hi_seen
                hi = min(hi, hi_seen)
                if hi <= lo:
                    return hi
                frac = (target - prev_cum) / c
                return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
        return hi_seen

    def export_state(self) -> Dict:
        """Raw mergeable state: per-bin (not cumulative) counts and the
        running sum, min and max, what crosses the federation wire."""
        counts, count, total, lo, hi = self._state()
        return {"edges": list(self.edges), "counts": counts, "count": count, "sum": total,
                "min": lo, "max": hi}

    def _absorb_state(self, state: Mapping) -> None:
        """Merge an exported state into this histogram (the caller checked
        that the edges are the same)."""
        counts = state.get("counts") or []
        with self._lock:
            for i, c in enumerate(counts[: len(self._counts)]):
                self._counts[i] += int(c)
            self._count += int(state.get("count") or 0)
            self._sum += float(state.get("sum") or 0.0)
            lo, hi = state.get("min"), state.get("max")
            if lo is not None:
                self._min = lo if self._min is None else min(self._min, lo)
            if hi is not None:
                self._max = hi if self._max is None else max(self._max, hi)

    def snapshot(self) -> Dict:
        counts, count, total, lo, hi = self._state()
        cum, buckets = 0, {}
        for e, c in zip(self.edges, counts):
            cum += c
            buckets[e] = cum
        return {
            "count": count,
            "sum": total,
            "mean": (total / count) if count else None,
            "min": lo,
            "max": hi,
            "p50": self.percentile(0.50),
            "p95": self.percentile(0.95),
            "p99": self.percentile(0.99),
            "p999": self.percentile(0.999),
            "buckets": buckets,
        }


class MetricsRegistry:
    """Thread-safe (name, labels) -> metric map with export surfaces."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[Tuple[str, _LabelKey], object] = {}

    def _get_or_create(self, cls, name, labels, help, **kw):
        key = (name, _label_key(labels))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = cls(name, labels=key[1], help=help, **kw)
                self._metrics[key] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {m.kind}, "
                    f"requested {cls.kind}"
                )
            return m

    def counter(
        self, name: str, labels: Optional[Mapping[str, str]] = None, help: str = ""
    ) -> Counter:
        return self._get_or_create(Counter, name, labels, help)

    def gauge(
        self, name: str, labels: Optional[Mapping[str, str]] = None, help: str = ""
    ) -> Gauge:
        return self._get_or_create(Gauge, name, labels, help)

    def histogram(
        self,
        name: str,
        edges: Sequence[float] = DEFAULT_TIME_BUCKETS,
        labels: Optional[Mapping[str, str]] = None,
        help: str = "",
    ) -> Histogram:
        return self._get_or_create(Histogram, name, labels, help, edges=edges)

    def _items(self) -> List[Tuple[Tuple[str, _LabelKey], object]]:
        with self._lock:
            return sorted(self._metrics.items(), key=lambda kv: kv[0])

    def metrics_named(self, name: str) -> List[object]:
        """Every metric instance registered under ``name`` (one per label
        set) — how a labeled family is enumerated (batch occupancy)."""
        return [m for (n, _), m in self._items() if n == name]

    def value(
        self, name: str, labels: Optional[Mapping[str, str]] = None, default=0.0
    ):
        with self._lock:
            m = self._metrics.get((name, _label_key(labels)))
        return default if m is None else m.value

    def snapshot(self) -> Dict:
        """One nested plain dict of everything: the single source both
        ``/healthz`` and ``bench.py`` consume. Labeled metrics key as
        ``name{k="v"}``."""
        out: Dict[str, Dict] = {"counters": {}, "gauges": {}, "histograms": {}}
        for (name, labels), m in self._items():
            key = name + _render_labels(labels)
            if isinstance(m, Counter):
                out["counters"][key] = m.value
            elif isinstance(m, Gauge):
                out["gauges"][key] = m.value
            else:
                out["histograms"][key] = m.snapshot()
        return out

    def prometheus_text(self) -> str:
        """Prometheus exposition format (text/plain; version=0.0.4)."""
        lines: List[str] = []
        seen_header = set()
        for (name, labels), m in self._items():
            if name not in seen_header:
                seen_header.add(name)
                if m.help:
                    lines.append(f"# HELP {name} {m.help}")
                lines.append(f"# TYPE {name} {m.kind}")
            if isinstance(m, (Counter, Gauge)):
                lines.append(f"{name}{_render_labels(labels)} {m.value:g}")
            else:
                snap = m.snapshot()
                for edge, cum in snap["buckets"].items():
                    lines.append(
                        f"{name}_bucket"
                        f"{_render_labels(labels, [('le', f'{edge:g}')])} {cum}"
                    )
                lines.append(
                    f"{name}_bucket"
                    f"{_render_labels(labels, [('le', '+Inf')])} {snap['count']}"
                )
                lines.append(
                    f"{name}_sum{_render_labels(labels)} {snap['sum']:g}"
                )
                lines.append(
                    f"{name}_count{_render_labels(labels)} {snap['count']}"
                )
                # tail summary lines: the SLO router's operating metric is
                # the tail, and the bucketed p999 a scraper would derive is
                # strictly worse than the min/max-tightened estimate the
                # registry already has — export it (and the true max)
                # directly, skipping empty histograms
                if snap["count"]:
                    lines.append(
                        f"{name}_p999{_render_labels(labels)} "
                        f"{snap['p999']:g}"
                    )
                    lines.append(
                        f"{name}_max{_render_labels(labels)} "
                        f"{snap['max']:g}"
                    )
        return "\n".join(lines) + "\n"

    def export_state(self) -> Dict:
        """JSON-safe raw state of every metric (a replica's ``GET
        /metrics``): counters and gauges their value, histograms their
        per-bin counts, so the router merges buckets."""
        metrics = []
        for (name, labels), m in self._items():
            rec: Dict = {"name": name, "kind": m.kind, "labels": [list(kv) for kv in labels]}
            if isinstance(m, (Counter, Gauge)):
                rec["value"] = m.value
            else:
                rec["hist"] = m.export_state()
            metrics.append(rec)
        return {"metrics": metrics}


def merge_states(states: Sequence[Tuple[str, Mapping]], prefix: str = "fleet_") -> MetricsRegistry:
    """Fold ``(replica_id, export_state())`` pairs into one registry whose
    families carry ``prefix``: counters summed under one (name, labels);
    histogram bucket counts added elementwise (a replica whose edges differ
    keeps a ``replica=``-labeled copy); gauges, being levels, kept per
    replica under a ``replica=`` label."""
    merged = MetricsRegistry()
    for rid, state in states:
        for rec in (state or {}).get("metrics", []):
            name = prefix + str(rec.get("name", ""))
            labels = {k: v for k, v in (rec.get("labels") or [])}
            kind = rec.get("kind")
            if kind == "counter":
                merged.counter(name, labels=labels).inc(float(rec.get("value") or 0.0))
            elif kind == "gauge":
                merged.gauge(name, labels={**labels, "replica": rid}).set(
                    float(rec.get("value") or 0.0))
            elif kind == "histogram":
                hist_state = rec.get("hist") or {}
                edges = tuple(float(e) for e in (hist_state.get("edges") or ()))
                if not edges:
                    continue
                try:
                    h = merged.histogram(name, edges=edges, labels=labels)
                except TypeError:
                    continue  # the name is another kind's: skip
                if h.edges != edges:
                    h = merged.histogram(name, edges=edges, labels={**labels, "replica": rid})
                h._absorb_state(hist_state)
    return merged


_default_lock = threading.Lock()
_default: Optional[MetricsRegistry] = None


def get_registry() -> MetricsRegistry:
    """The process-global default registry (created on first use)."""
    global _default
    with _default_lock:
        if _default is None:
            _default = MetricsRegistry()
        return _default
