"""Distributed trace spans over the metrics registry + event log (a copy
of speakingstyle_tpu/obs/trace.py; plain Python, no torch).

A ``Span`` measures one monotonic-clock duration and fans it out to the
telemetry surfaces: a registry histogram (named ``<name>_seconds`` by
default, optionally labeled), one JSONL record when an event log is
attached, and — new with the fleet observability plane — one finished
span record in the per-process **span ring** (``get_span_ring()``),
carrying a propagated trace context.

Trace context
-------------
``TraceContext(trace_id, span_id, parent_span_id)`` is the propagation
unit.  ``trace_id`` is the existing ``req_id`` join key (one request =
one trace); ``span_id`` is a cheap per-process counter.  Context flows
two ways:

  * **ambient** — ``Span.__enter__`` pushes its context onto a
    thread-local stack; a nested ``Span`` on the same thread parents
    itself automatically.
  * **explicit** — cross-thread hops pass the parent by hand:
    ``Span(..., parent=ctx)``, and ``Span.record(...)`` for spans
    reconstructed after the fact (the engine's ``engine_acoustic`` /
    ``engine_vocode`` split).

Finished spans land in a bounded ring buffer (oldest evicted first).
Interesting traces (a shed, a 504, a deadline miss, a retry exhaustion, a
quality-gate failure) are pinned into a bounded keep-store by the code
that detects them; healthy traffic is pinned at ``serve.trace.sample_rate``
by ``TailSampler``'s deterministic dice (the fleet router builds one).
``ambient(ctx)`` installs an explicit context as the thread's ambient one
(JAX counterpart ``:120-166``; ``TailSampler`` ``:303-338``).
``GET /debug/spans`` serves the ring; ``GET /debug/trace/<req_id>``
assembles one trace with ``assemble_trace`` + ``critical_path``.

Across processes (the cluster, serving/cluster.py) a context rides the
wire as ``as_dict()`` in each request's body (and ``X-Trace-Id`` /
``X-Parent-Span`` headers); the replica rebuilds it with
``TraceContext.from_dict`` and records its spans after the fact with
``Span.record(..., parent=ctx)``. A span's ``start_ts`` is the wall clock
(comparable between processes), its ``duration_s`` the monotonic clock;
span ids carry the process id, so the router's and the replicas' rings
join without collisions.

Device-side timing comes from the engine's CUDA events (the
``engine_acoustic`` / ``engine_vocode`` spans, serving/engine.py) and the
on-demand ``torch.profiler`` captures (``POST /debug/profile`` on serve,
``--profile_at`` on train).
"""

import itertools
import os
import threading
import time
import zlib
from collections import deque
from typing import Any, Deque, Dict, List, Mapping, Optional

from speakingstyle_torch.obs.events import JsonlEventLog
from speakingstyle_torch.obs.registry import (
    DEFAULT_TIME_BUCKETS,
    MetricsRegistry,
)

__all__ = [
    "Span",
    "SpanRing",
    "TailSampler",
    "TraceContext",
    "ambient",
    "assemble_trace",
    "critical_path",
    "current_context",
    "get_span_ring",
    "new_context",
    "tracing_enabled",
    "set_tracing_enabled",
]

_span_seq = itertools.count(1)


def _new_span_id() -> str:
    # pid-qualified counter: unique across the processes of one fleet
    # without paying uuid4 on the hot path
    return f"{os.getpid():x}-{next(_span_seq):x}"


class TraceContext:
    """One node of a distributed trace: which trace, which span, under
    which parent. Immutable by convention; ``child()`` mints the next
    hop."""

    __slots__ = ("trace_id", "span_id", "parent_span_id")

    def __init__(self, trace_id: str, span_id: Optional[str] = None,
                 parent_span_id: Optional[str] = None):
        self.trace_id = trace_id
        self.span_id = span_id or _new_span_id()
        self.parent_span_id = parent_span_id

    def child(self) -> "TraceContext":
        return TraceContext(self.trace_id, _new_span_id(), self.span_id)

    def as_dict(self) -> Dict[str, Optional[str]]:
        return {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_span_id": self.parent_span_id,
        }

    @classmethod
    def from_dict(cls, d: Optional[Mapping]) -> Optional["TraceContext"]:
        """The context ``as_dict()`` sent over the wire; None without a
        trace id."""
        if not d or not d.get("trace_id"):
            return None
        return cls(d["trace_id"], d.get("span_id"), d.get("parent_span_id"))

    def __repr__(self) -> str:
        return (f"TraceContext({self.trace_id!r}, {self.span_id!r}, "
                f"parent={self.parent_span_id!r})")


def new_context(trace_id: str) -> TraceContext:
    """A root context for one trace (no parent)."""
    return TraceContext(trace_id, _new_span_id(), None)


# ambient context: thread-local stack pushed/popped by Span enter/exit
_ambient = threading.local()


def _ctx_stack() -> List[TraceContext]:
    s = getattr(_ambient, "stack", None)
    if s is None:
        s = _ambient.stack = []
    return s


def current_context() -> Optional[TraceContext]:
    """The innermost open Span's context on this thread (or None)."""
    s = _ctx_stack()
    return s[-1] if s else None


class _AmbientContext:
    """Context manager installing an explicit TraceContext as the thread's
    ambient context, so spans opened inside parent under it without the
    code that opens them knowing of tracing."""

    def __init__(self, ctx: Optional[TraceContext]):
        self.ctx = ctx

    def __enter__(self):
        if self.ctx is not None:
            _ctx_stack().append(self.ctx)
        return self.ctx

    def __exit__(self, *exc) -> bool:
        if self.ctx is not None:
            stack = _ctx_stack()
            if stack and stack[-1] is self.ctx:
                stack.pop()
        return False


def ambient(ctx: Optional[TraceContext]) -> _AmbientContext:
    return _AmbientContext(ctx)


# process-wide tracing arm switch: context propagation is always on
# (it is just three strings riding the request), but span *recording*
# into the ring can be disarmed for the bench overhead ablation
_tracing_enabled = True


def tracing_enabled() -> bool:
    return _tracing_enabled


def set_tracing_enabled(on: bool) -> None:
    global _tracing_enabled
    _tracing_enabled = bool(on)


class SpanRing:
    """Bounded per-process store of finished spans, plus a bounded
    keep-store of tail-sampled (pinned) traces.

    The ring holds the most recent ``capacity`` spans of *all* traffic;
    ``pin(trace_id)`` copies that trace's spans into the keep-store the
    moment something decides the trace is interesting (error ladder,
    hedge winner, deadline miss, healthy-sample dice), so they survive
    ring churn. Thread-safe; the internal lock is obs-internal and
    deliberately plain (see obs/locks.py docstring).
    """

    def __init__(self, capacity: int = 4096, keep_traces: int = 256):
        if capacity < 1:
            raise ValueError(f"ring capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.keep_traces = int(keep_traces)
        self._lock = threading.Lock()
        self._spans: Deque[Dict[str, Any]] = deque()
        # per-trace index mirroring the ring so pin()/spans(trace_id)
        # are O(spans-of-trace), not an O(capacity) scan under the lock
        # — at tail-sample rates the scan showed up in request p50
        self._by_trace: Dict[str, List[Dict[str, Any]]] = {}
        self._kept: "Dict[str, List[Dict[str, Any]]]" = {}
        self._kept_order: List[str] = []
        self._dropped = 0
        self.last_pinned_trace_id: Optional[str] = None

    def add(self, rec: Dict[str, Any]) -> None:
        with self._lock:
            self._spans.append(rec)
            tid = rec.get("trace_id")
            if tid:
                self._by_trace.setdefault(tid, []).append(rec)
            while len(self._spans) > self.capacity:
                old = self._spans.popleft()
                self._dropped += 1
                otid = old.get("trace_id")
                bucket = self._by_trace.get(otid)
                if bucket:
                    # ring and buckets share append order: the
                    # globally-oldest record is its trace's oldest
                    if bucket[0] is old:
                        bucket.pop(0)
                    else:
                        bucket[:] = [s for s in bucket if s is not old]
                    if not bucket:
                        self._by_trace.pop(otid, None)
            if tid in self._kept:
                self._kept[tid].append(rec)

    def pin(self, trace_id: Optional[str]) -> None:
        """Tail-sampling keep: snapshot this trace's spans out of the
        ring into the keep-store; later spans of the same trace are
        appended as they finish."""
        if not trace_id:
            return
        with self._lock:
            if trace_id not in self._kept:
                self._kept[trace_id] = list(
                    self._by_trace.get(trace_id, ())
                )
                self._kept_order.append(trace_id)
                while len(self._kept_order) > self.keep_traces:
                    evict = self._kept_order.pop(0)
                    self._kept.pop(evict, None)
            self.last_pinned_trace_id = trace_id

    def spans(self, trace_id: Optional[str] = None) -> List[Dict[str, Any]]:
        with self._lock:
            if trace_id is None:
                return list(self._spans)
            kept = self._kept.get(trace_id)
            if kept is not None:
                return list(kept)
            return list(self._by_trace.get(trace_id, ()))

    def kept_trace_ids(self) -> List[str]:
        with self._lock:
            return list(self._kept_order)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "spans": len(self._spans),
                "capacity": self.capacity,
                "kept_traces": len(self._kept_order),
                "evictions": self._dropped,
            }

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self._by_trace.clear()
            self._kept.clear()
            self._kept_order.clear()
            self._dropped = 0
            self.last_pinned_trace_id = None


_process_ring: Optional[SpanRing] = None
_process_ring_lock = threading.Lock()


def get_span_ring() -> SpanRing:
    """The process-global span ring (same idiom as
    ``registry.get_registry()``)."""
    global _process_ring
    if _process_ring is None:
        with _process_ring_lock:
            if _process_ring is None:
                _process_ring = SpanRing()
    return _process_ring


def configure_span_ring(capacity: int, keep_traces: int = 256) -> SpanRing:
    """Replace the process ring with one sized from config
    (serve.trace.ring_capacity). Existing spans are discarded —
    call before serving starts."""
    global _process_ring
    with _process_ring_lock:
        _process_ring = SpanRing(capacity, keep_traces=keep_traces)
    return _process_ring


class TailSampler:
    """The healthy-traffic half of tail sampling.

    Interesting traces are pinned unconditionally by the code that detects
    them; everything else rolls deterministic dice here: crc32(trace_id)
    keeps the decision stable across processes."""

    KEEP_REASONS = (
        "shed", "deadline_exceeded", "hedge_won", "deadline_miss",
        "error", "quality_fail",
    )

    def __init__(self, sample_rate: float = 0.1):
        if not 0.0 <= sample_rate <= 1.0:
            raise ValueError(f"sample_rate must be in [0, 1], got {sample_rate}")
        self.sample_rate = float(sample_rate)
        self.kept = 0
        self.sampled_out = 0

    def keep(self, trace_id: str, reason: Optional[str] = None) -> bool:
        """True when the trace should be pinned: always for a keep reason,
        at ``sample_rate`` for healthy traffic."""
        if reason in self.KEEP_REASONS:
            self.kept += 1
            return True
        bucket = zlib.crc32(trace_id.encode("utf-8", "replace")) % 10_000
        if bucket < self.sample_rate * 10_000:
            self.kept += 1
            return True
        self.sampled_out += 1
        return False


class Span:
    """Context manager timing one operation.

    ``fields`` ride into the JSONL record verbatim; ``labels`` select the
    histogram child. On exception the event records ``ok: false`` and the error
    type; the duration is still observed.

    Tracing: ``parent`` (a TraceContext, a Span, or None) selects the
    trace; with None the ambient thread-local context is used, and with
    no ambient context either the span is trace-less (recorded nowhere
    but the histogram/event surfaces — exactly the old behavior).
    Finished traced spans are appended to
    ``ring`` (default: the process ring) unless tracing is disarmed.
    """

    def __init__(
        self,
        name: str,
        registry: Optional[MetricsRegistry] = None,
        events: Optional[JsonlEventLog] = None,
        histogram: Optional[str] = None,
        labels: Optional[Mapping[str, str]] = None,
        edges=DEFAULT_TIME_BUCKETS,
        parent=None,
        ring: Optional[SpanRing] = None,
        **fields,
    ):
        self.name = name
        self.registry = registry
        self.events = events
        self.histogram = histogram or f"{name}_seconds"
        self.labels = labels
        self.edges = edges
        self.fields: Dict = dict(fields)
        self.duration_s: Optional[float] = None
        self._t0: Optional[float] = None
        self._t0_wall: Optional[float] = None
        self._parent = parent
        self._ring = ring
        self.ctx: Optional[TraceContext] = None
        self._ambient_pushed = False

    def _resolve_parent(self) -> Optional[TraceContext]:
        p = self._parent
        if isinstance(p, Span):
            p = p.ctx
        if p is None:
            p = current_context()
        return p

    def __enter__(self) -> "Span":
        parent = self._resolve_parent()
        if parent is not None:
            self.ctx = parent.child()
        elif self.fields.get("trace_id"):
            self.ctx = new_context(str(self.fields["trace_id"]))
        if self.ctx is not None:
            _ctx_stack().append(self.ctx)
            self._ambient_pushed = True
        self._t0_wall = time.time()
        self._t0 = time.monotonic()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.duration_s = time.monotonic() - self._t0
        if self._ambient_pushed:
            stack = _ctx_stack()
            if stack and stack[-1] is self.ctx:
                stack.pop()
            self._ambient_pushed = False
        if self.registry is not None:
            self.registry.histogram(
                self.histogram, edges=self.edges, labels=self.labels
            ).observe(self.duration_s)
        if self.events is not None:
            rec = dict(self.fields)
            rec["duration_s"] = self.duration_s
            if self.labels:
                rec.update(self.labels)
            if self.ctx is not None:
                rec.update(self.ctx.as_dict())
            if exc_type is not None:
                rec["ok"] = False
                rec["error"] = exc_type.__name__
            self.events.emit(self.name, **rec)
        if self.ctx is not None and _tracing_enabled:
            ring = self._ring if self._ring is not None \
                else get_span_ring()
            ring.add(self._record(exc_type))
        return False

    def _record(self, exc_type=None) -> Dict[str, Any]:
        rec: Dict[str, Any] = {
            "name": self.name,
            "start_ts": self._t0_wall,
            "duration_s": self.duration_s,
            **self.ctx.as_dict(),
        }
        payload = {k: v for k, v in self.fields.items()
                   if k not in ("trace_id",)}
        if self.labels:
            payload.update(self.labels)
        if payload:
            rec["fields"] = payload
        if exc_type is not None:
            rec["ok"] = False
            rec["error"] = exc_type.__name__
        return rec

    @staticmethod
    def record(
        name: str,
        start_ts: float,
        duration_s: float,
        parent=None,
        ring: Optional[SpanRing] = None,
        events: Optional[List[Dict[str, Any]]] = None,
        **fields,
    ) -> Optional[TraceContext]:
        """Append an already-measured span to the ring — the path for
        stages whose timing is reconstructed after the fact (EDF queue
        wait is only known at dispatch time, on a different thread than
        submit; a replica's dispatch under a context that crossed the
        wire). ``start_ts`` is a wall-clock stamp, ``duration_s`` a
        monotonic one; ``events`` are the span's point events. Returns the
        span's context so children can chain."""
        if isinstance(parent, Span):
            parent = parent.ctx
        if parent is None or not _tracing_enabled:
            return None
        ctx = parent.child()
        rec: Dict[str, Any] = {
            "name": name,
            "start_ts": start_ts,
            "duration_s": duration_s,
            **ctx.as_dict(),
        }
        if fields:
            rec["fields"] = dict(fields)
        if events:
            rec["events"] = list(events)
        (ring if ring is not None else get_span_ring()).add(rec)
        return ctx


# ---------------------------------------------------------------------------
# assembly: spans (possibly from several processes) -> one trace tree
# ---------------------------------------------------------------------------


def _span_end(s: Mapping) -> float:
    return (s.get("start_ts") or 0.0) + (s.get("duration_s") or 0.0)


def assemble_trace(spans: List[Mapping],
                   trace_id: str) -> Dict[str, Any]:
    """Stitch one trace's spans (from any number of processes — spans
    carry wall-clock ``start_ts``, which transfers across a host,
    unlike monotonic stamps) into a tree + critical path.

    Spans whose parent never arrived (ring eviction, a replica that
    died before its ring was scraped) are promoted to roots rather than
    dropped — a partial trace is still evidence.
    """
    mine = [dict(s) for s in spans if s.get("trace_id") == trace_id]
    mine.sort(key=lambda s: (s.get("start_ts") or 0.0))
    by_id = {s["span_id"]: s for s in mine if s.get("span_id")}
    children: Dict[str, List[dict]] = {}
    roots: List[dict] = []
    for s in mine:
        parent = s.get("parent_span_id")
        if parent and parent in by_id:
            children.setdefault(parent, []).append(s)
        else:
            roots.append(s)
    cp = critical_path(roots, children)
    cp_ids = {s["span_id"] for s in cp}

    def node(s: dict) -> dict:
        return {
            "name": s.get("name"),
            "span_id": s.get("span_id"),
            "start_ts": s.get("start_ts"),
            "duration_s": s.get("duration_s"),
            "fields": s.get("fields") or {},
            "events": s.get("events") or [],
            "ok": s.get("ok", True),
            "on_critical_path": s.get("span_id") in cp_ids,
            "children": [node(c) for c in children.get(s["span_id"], [])],
        }

    start = min((s.get("start_ts") or 0.0) for s in mine) if mine else 0.0
    end = max(_span_end(s) for s in mine) if mine else 0.0
    return {
        "trace_id": trace_id,
        "span_count": len(mine),
        "total_s": max(0.0, end - start),
        "roots": [node(r) for r in roots],
        "critical_path": [
            {"name": s.get("name"), "span_id": s.get("span_id"),
             "duration_s": s.get("duration_s"),
             "fields": s.get("fields") or {}}
            for s in cp
        ],
    }


def critical_path(roots: List[dict],
                  children: Dict[str, List[dict]]) -> List[dict]:
    """The chain of spans that determined the trace's end-to-end
    latency: from the last-finishing root, repeatedly descend into the
    last-finishing child that started before the current bound — the
    standard last-exit walk over a span tree.  Between hedge siblings
    this selects the leg that actually gated completion (the winner,
    unless a straggler loser outlived it on another thread)."""
    if not roots:
        return []
    cur = max(roots, key=_span_end)
    path = [cur]
    bound = _span_end(cur)
    while True:
        kids = [c for c in children.get(cur.get("span_id"), [])
                if (c.get("start_ts") or 0.0) <= bound]
        if not kids:
            break
        nxt = max(kids, key=_span_end)
        path.append(nxt)
        bound = min(bound, _span_end(nxt))
        cur = nxt
    return path
