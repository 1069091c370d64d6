"""Continuous batcher: per-request futures over one device dispatch thread
(JAX counterpart: speakingstyle_tpu/serving/batcher.py).

Admission is a bounded ``queue.Queue`` of pending requests; a single
background worker coalesces whatever is queued into the smallest covering
lattice bucket and runs it as one engine dispatch, then scatters results
back to per-request ``concurrent.futures.Future``s. The coalescing rule:

  * the worker blocks until at least one request is pending;
  * it then keeps admitting until EITHER the oldest pending request's
    deadline (``arrival + max_wait``) expires OR a full
    ``lattice.max_batch`` has coalesced — whichever comes first;
  * while a dispatch executes on device, new arrivals queue up and form
    the next batch (continuous batching — the device never waits on a
    fixed batch boundary).

The dispatch thread is the only caller of ``engine.run``: every device
operation of a synthesis happens there, on the engine's prepared programs
(serving/engine.py).

Shutdown reuses the DevicePrefetcher discipline (data/prefetch.py):
producers only ever enqueue through a stop-aware ``bounded_put``, and
``close()`` enqueues exactly one ``Terminal`` item, so the worker drains
every admitted request (flush), resolves each future exactly once, and
exits; submits racing a close either land before the Terminal (and are
flushed) or fail fast with ``ShutdownError``. A worker crash fails all
in-flight futures rather than stranding their waiters.
"""

import queue
import threading
import time
from collections import Counter, deque
from concurrent.futures import Future
from dataclasses import dataclass
from typing import List, Optional, Tuple

from speakingstyle_torch.data.prefetch import Terminal, bounded_put
from speakingstyle_torch.obs import JsonlEventLog, MetricsRegistry, make_lock
from speakingstyle_torch.serving.engine import SynthesisEngine, SynthesisRequest, bucket_label
from speakingstyle_torch.serving.resilience import DispatchError

__all__ = ["ContinuousBatcher", "DrainRateEstimator", "Overloaded", "ShutdownError"]


class ShutdownError(RuntimeError):
    """The batcher is closed (or closing) and cannot admit the request."""


class Overloaded(RuntimeError):
    """Load shed: the pending queue crossed its high watermark.

    Distinct from ShutdownError on purpose — the two are different
    verdicts with different client advice (HTTP 429 + Retry-After
    "come back shortly" vs 503 "this instance is going away") and
    different counters (``serve_shed_total`` vs ``serve_rejected_total``).
    """

    def __init__(self, message: str, retry_after_s: float = 1.0):
        super().__init__(message)
        self.retry_after_s = float(retry_after_s)


class DrainRateEstimator:
    """Sliding-window estimate of queue drain throughput (requests/s).

    Both admission paths (batcher queue, fleet EDF heap) feed completed
    requests into one of these so a 429's Retry-After can be DERIVED —
    "seconds until the queue drains back to the low watermark at the
    current service rate" — instead of advertising a constant that makes
    every shed client retry in lockstep. The rate divides by the full
    window (not the observed span), which deliberately under-estimates
    while the window is still filling: an under-estimated rate is an
    over-estimated Retry-After, the conservative direction under load.
    """

    def __init__(self, window_s: float = 5.0):
        self.window_s = float(window_s)
        self._lock = make_lock("DrainRateEstimator._lock")
        self._events: "deque" = deque()  # (monotonic stamp, n completed)

    def note(self, n: int = 1, now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        with self._lock:
            self._events.append((now, n))
            self._trim(now)

    def _trim(self, now: float) -> None:
        horizon = now - self.window_s
        while self._events and self._events[0][0] < horizon:
            self._events.popleft()

    def rate(self, now: Optional[float] = None) -> float:
        """Completed requests per second over the window; 0.0 before any
        completion has been observed (callers fall back to the
        configured constant)."""
        now = time.monotonic() if now is None else now
        with self._lock:
            self._trim(now)
            total = sum(n for _, n in self._events)
        return total / self.window_s

    def retry_after(self, backlog: float, fallback: float,
                    lo: float = 0.1, hi: float = 30.0) -> float:
        """Seconds until ``backlog`` requests drain at the current rate,
        clamped to [lo, hi]; ``fallback`` when no rate is measured yet."""
        r = self.rate()
        if r <= 0.0:
            return fallback
        return min(max(backlog / r, lo), hi)


@dataclass
class _Pending:
    request: SynthesisRequest
    future: Future
    deadline: float  # monotonic instant the request must dispatch by


class ContinuousBatcher:
    """Single-dispatch-thread continuous batcher over a SynthesisEngine."""

    def __init__(self, engine: SynthesisEngine, events: Optional[JsonlEventLog] = None):
        serve = engine.cfg.serve
        self.engine = engine
        self.max_wait = serve.max_wait_ms / 1e3
        self.max_batch = engine.lattice.max_batch
        self._depth = serve.queue_depth
        self._queue: "queue.Queue" = queue.Queue(maxsize=self._depth)
        # load-shedding hysteresis over the admission queue (the fleet
        # router uses the same watermarks over its EDF heap): shed once
        # occupancy crosses high * depth, readmit once it drains to
        # low * depth — so the 429 boundary cannot flap per-request
        fleet = getattr(serve, "fleet", None)
        self._shed_high = (
            fleet.shed_high_watermark * self._depth if fleet else self._depth
        )
        self._shed_low = (
            fleet.shed_low_watermark * self._depth if fleet else 0
        )
        self._retry_after = fleet.shed_retry_after_s if fleet else 1.0
        self.drain_rate = DrainRateEstimator()
        self._shedding = False
        self._shed_lock = make_lock("ContinuousBatcher._shed_lock")
        self._stopped = threading.Event()
        self._closed_lock = make_lock("ContinuousBatcher._closed_lock")
        self._terminal_sent = False
        # observability: everything lives in the registry (obs/), which
        # /metrics, /healthz, and bench.py all read from one snapshot —
        # occupancy/dispatched/rejected below are VIEWS of it, not
        # parallel counters
        # engines are duck-typed in tests; fall back to a private registry
        self.registry = getattr(engine, "registry", None) or MetricsRegistry()
        self.events = events
        self._queue_gauge = self.registry.gauge(
            "serve_queue_depth", help="admission queue occupancy (pending)"
        )
        self._batches = self.registry.counter(
            "serve_batches_total", help="coalesced batches dispatched"
        )
        self._rejected_ctr = self.registry.counter(
            "serve_rejected_total", help="submits refused at/after shutdown"
        )
        self._shed_ctr = self.registry.counter(
            "serve_shed_total",
            help="submits shed by backpressure (429, NOT shutdown)",
        )
        self._latency_hist = self.registry.histogram(
            "serve_request_latency_seconds",
            help="request arrival -> result latency through the batcher",
        )
        self._queue_wait_hist = self.registry.histogram(
            "serve_queue_wait_seconds",
            help="submit -> dispatch-start wait (the coalescing window "
                 "the frontend pool overlaps with)",
        )
        self.thread = threading.Thread(
            target=self._worker, name="serve-dispatch", daemon=True
        )
        self.thread.start()

    # -- registry views (the pre-obs attribute API, minus the bookkeeping) --

    @property
    def occupancy(self) -> Counter:
        """real rows -> dispatch count, from the registry's labeled family."""
        return Counter({
            int(dict(c.labels)["rows"]): int(c.value)
            for c in self.registry.metrics_named("serve_batch_occupancy_total")
        })

    @property
    def bucket_counts(self) -> Counter:
        """bucket label (``b4.s64.m512``) -> dispatch count."""
        return Counter({
            dict(c.labels)["bucket"]: int(c.value)
            for c in self.registry.metrics_named("serve_bucket_dispatch_total")
        })

    @property
    def dispatched(self) -> int:
        return int(self._batches.value)

    @property
    def rejected(self) -> int:
        return int(self._rejected_ctr.value)

    @property
    def shed(self) -> int:
        return int(self._shed_ctr.value)

    def _check_shed(self) -> None:
        """Watermark hysteresis over queue occupancy; raises Overloaded
        while shedding is active. Occupancy is sampled (qsize is
        approximate under concurrency) — the watermark gap absorbs that."""
        depth = self._queue.qsize()
        with self._shed_lock:
            if self._shedding:
                if depth <= self._shed_low:
                    self._shedding = False
            elif depth >= self._shed_high:
                self._shedding = True
            shedding = self._shedding
        if shedding:
            self._shed_ctr.inc()
            # Retry-After derives from the measured drain rate over the
            # hysteresis gap (depth back down to the low watermark, where
            # admission resumes); the configured constant is only the
            # fallback before any dispatch has completed
            raise Overloaded(
                f"admission queue at {depth}/{self._depth} (high watermark "
                f"{self._shed_high:g}): shedding load",
                retry_after_s=self.drain_rate.retry_after(
                    max(depth - self._shed_low, 1.0), self._retry_after
                ),
            )

    def refresh_gauges(self) -> None:
        """Sample queue occupancy into the gauge (also called at scrape)."""
        self._queue_gauge.set(self._queue.qsize())

    # -- producer side ------------------------------------------------------

    def submit(self, request: SynthesisRequest) -> Future:
        """Admit a request; returns a Future resolving to SynthesisResult.

        Validates geometry now (RequestTooLarge at submit, not mid-batch),
        blocks stop-aware while the queue is full, and raises
        ShutdownError once the batcher is closed.
        """
        if self._stopped.is_set():
            self._rejected_ctr.inc()
            raise ShutdownError("batcher is closed")
        self._check_shed()          # raises Overloaded under backpressure
        if not getattr(request, "pending", False):
            self.engine.admit(request)  # raises RequestTooLarge early
        # pending frontend handles (serving/frontend.py) have no sequence
        # yet — geometry moves to _resolve_pending at dispatch, where a
        # RequestTooLarge resolves the future with the same 400 verdict
        fut: Future = Future()
        item = _Pending(
            request=request,
            future=fut,
            deadline=time.monotonic() + self.max_wait,
        )
        if not bounded_put(self._queue, item, self._stopped):
            self._rejected_ctr.inc()
            raise ShutdownError("batcher closed while request was queued")
        self.refresh_gauges()
        return fut

    # -- worker side --------------------------------------------------------

    def _collect(self) -> Tuple[List[_Pending], bool]:
        """Block for the first pending item, then coalesce: greedily drain
        everything already queued (the backlog built up while the previous
        dispatch ran — the continuous-batching case), then, if the batch
        is still short of max_batch AND the oldest request's deadline has
        not expired, keep waiting for arrivals until it does. Returns
        (batch, saw_terminal)."""
        first = self._queue.get()
        if isinstance(first, Terminal):
            return [], True
        batch = [first]
        while len(batch) < self.max_batch:
            wait = first.deadline - time.monotonic()
            try:
                # greedy while a backlog exists; timed once it drains
                item = (self._queue.get_nowait() if wait <= 0
                        else self._queue.get(timeout=wait))
            except queue.Empty:
                break
            if isinstance(item, Terminal):
                return batch, True
            batch.append(item)
        return batch, False

    def _resolve_pending(self, p: _Pending) -> bool:
        """Swap a frontend handle for its resolved SynthesisRequest in
        place. False = resolution failed; the future already carries the
        frontend's error (or TimeoutError for a wedged worker) and the
        entry must leave the batch."""
        if not getattr(p.request, "pending", False):
            return True
        try:
            request = p.request.resolve()
            self.engine.admit(request)  # geometry deferred from submit
        except BaseException as e:
            p.future.set_exception(e)
            return False
        p.request = request
        return True

    def _dispatch(self, batch: List[_Pending]) -> None:
        batch[:] = [p for p in batch if self._resolve_pending(p)]
        if not batch:
            return
        req_ids = [p.request.id for p in batch]
        t0 = time.monotonic()
        for p in batch:
            self._queue_wait_hist.observe(t0 - p.request.arrival)
        try:
            results = self.engine.run([p.request for p in batch])
        except BaseException as e:
            if self.events is not None:
                self.events.emit(
                    "serve_dispatch", req_ids=req_ids, rows=len(batch),
                    duration_s=time.monotonic() - t0, ok=False,
                    error=type(e).__name__,
                )
            for p in batch:
                p.future.set_exception(e)
            return
        now = time.monotonic()
        try:
            self._batches.inc()
            self.registry.counter(
                "serve_batch_occupancy_total",
                labels={"rows": str(len(batch))},
                help="dispatches by real-row occupancy",
            ).inc()
            bucket = getattr(results[0], "bucket", None) if results else None
            if bucket is not None:
                self.registry.counter(
                    "serve_bucket_dispatch_total",
                    labels={"bucket": bucket_label(bucket)},
                    help="dispatches by covering lattice bucket",
                ).inc()
            if self.events is not None:
                # the req_ids make this record joinable with the server's
                # per-request http_request events (satellite: end-to-end ids)
                self.events.emit(
                    "serve_dispatch", req_ids=req_ids, rows=len(batch),
                    bucket=(bucket_label(bucket) if bucket is not None
                            else None),
                    duration_s=now - t0,
                )
            for p, r in zip(batch, results):
                self._latency_hist.observe(now - p.request.arrival)
                p.future.set_result(r)
        except BaseException as e:
            # bookkeeping bug after a successful engine call: resolve the
            # affected futures with a structured error so the dispatch
            # thread survives — a raise here used to kill it and strand
            # every request queued behind this batch
            self.registry.counter(
                "serve_dispatch_errors_total",
                help="dispatch-loop bookkeeping errors resolved as "
                     "DispatchError (500) without killing the worker",
            ).inc()
            err = DispatchError(
                f"dispatch bookkeeping failed: {type(e).__name__}: {e}"
            )
            for p in batch:
                if not p.future.done():
                    p.future.set_exception(err)
            if self.events is not None:
                self.events.emit(
                    "dispatch_error", req_ids=req_ids,
                    error=type(e).__name__,
                )

    def _worker(self) -> None:
        try:
            while True:
                batch, terminal = self._collect()
                self.refresh_gauges()
                if batch:
                    self._dispatch(batch)
                    # every entry left the queue with a resolved future
                    # (result, engine error, or DispatchError): all of it
                    # is drain the Retry-After estimate should see
                    self.drain_rate.note(len(batch))
                if terminal:
                    return
        except BaseException as e:  # engine + bookkeeping errors are
            # caught per-batch inside _dispatch; anything here is a
            # harness bug — fail every waiter loudly rather than
            # stranding them, then re-raise for visibility
            self._fail_pending(e)
            raise

    def _fail_pending(self, error: BaseException) -> None:
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                return
            if not isinstance(item, Terminal):
                item.future.set_exception(
                    ShutdownError(f"dispatch worker died: {error!r}")
                )

    # -- shutdown -----------------------------------------------------------

    def close(self, flush: bool = True, timeout: float = 30.0) -> None:
        """Idempotent shutdown. ``flush=True`` (default) lets the worker
        drain every admitted request before exiting; ``flush=False``
        fails queued-but-undispatched requests with ShutdownError."""
        with self._closed_lock:
            first_close = not self._terminal_sent
            self._terminal_sent = True
        if first_close:
            if not flush:
                self._stopped.set()  # reject new submits immediately
                self._fail_pending(ShutdownError("batcher closed"))
            # exactly ONE terminal item ends the stream (prefetch
            # discipline); plain blocking put — the worker is draining,
            # and the queue has capacity again once it does
            while self.thread.is_alive():
                try:
                    self._queue.put(Terminal(), timeout=0.1)
                    break
                except queue.Full:
                    continue
        self.thread.join(timeout=timeout)
        self._stopped.set()
        if self.thread.is_alive():
            # join timed out mid-dispatch: the worker still owns the
            # stream and will drain to the Terminal when it unblocks
            return
        # The worker is gone; requests that raced past the Terminal would
        # hang forever. A bounded_put attempt already in flight when the
        # stop flag went up can still land within one poll window
        # (0.05 s) — drain, wait out that window, drain once more; no new
        # item can appear after that (every later attempt sees the flag).
        self._fail_pending(ShutdownError("batcher closed"))
        time.sleep(0.06)
        self._fail_pending(ShutdownError("batcher closed"))

    def __enter__(self) -> "ContinuousBatcher":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False
