"""Fleet router: N replica engines behind one SLO-aware admission queue
(JAX counterpart: speakingstyle_tpu/serving/fleet.py:98-1308).

A ``FleetRouter`` owns N replicas, each a whole ``SynthesisEngine`` with its
own prepared lattice, behind one admission queue that knows the service
levels:

* **Priority classes.** Every request carries a class name
  (``serve.fleet.class_deadline_ms`` keys); its SLO deadline is
  ``arrival + class budget`` (``_admit`` JAX ``:582``, ``_budget_s``
  ``:617``).
* **Earliest-deadline-first dispatch.** The pending structure is a heap
  ordered by SLO deadline, with one worker thread a replica: whichever
  replica frees next pops the most urgent work and coalesces as the
  single-engine batcher does (``_worker`` ``:1204``, ``_collect`` /
  ``_claim`` ``:741-842``, ``_dispatch`` ``:862``). A request popped past
  its deadline resolves as ``DeadlineExceeded`` (504) instead of running
  late (``:792``).
* **Backpressure.** Queue-depth watermarks of ``fleet.queue_depth`` shed
  with hysteresis by raising ``Overloaded`` (429 + Retry-After,
  ``serve_shed_total``), apart from the shutdown path's ``ShutdownError``
  (``_check_shed`` ``:637``).
* **Lifecycle.** ``scale_to(n)`` adds replicas that go cold -> warming
  (engine built and its lattice prepared on a background thread) -> ready
  -> draining -> stopped, published per replica as ``serve_replica_state``;
  ``/healthz`` answers 503 until one replica is ready (``:312``, ``_warm``
  ``:351``). A draining replica finishes its in-flight dispatch and pulls
  no more work (the JAX worker pops on while its heap is non-empty, so a
  drain under steady load may never end).
* **Supervision.** A replica whose dispatch raises, or runs past
  ``fleet.hang_watchdog_s``, goes ``failed``: its in-flight batch requeues
  onto the healthy replicas, each request spending one unit of its class's
  ``fleet.retry_budget`` before it resolves as ``ReplicaError`` (503); the
  hung worker's late results are discarded through the claim handshake.
  The replica's ``CircuitBreaker`` re-warms it after an exponential
  backoff (``_replica_failed`` ``:1064``, ``_supervise`` ``:1153``).
* **Rollouts.** ``start_replica`` / ``drain_replica`` / ``wait_state`` and
  the model-version surface (``:455-540``) are what serving/lifecycle.py
  drives; the autoscaler (serving/autoscale.py) reads ``pending_depth``,
  ``occupancy``, ``live_replica_count`` and ``warmup_cost_s``.
* **Tail sampling.** Shed, 504, deadline-miss and retry-exhausted traces
  are pinned into the span ring; healthy ones at ``serve.trace.sample_rate``.

On the card, one process drives all replicas on one device, so the port
adds what the JAX package leaves to XLA:

* every program preparation holds ``DEVICE_GATE`` exclusively for one
  program at a time (the gate is phase-fair, parallel/registry.py), so a
  replica that warms holds the ready replicas' dispatches back for one
  capture each, never for its whole warm-up;
* a dispatch hung inside ``engine.run`` holds the gate shared, and a
  preparation waiting behind it would hold back every healthy replica. So
  while a dispatch the watchdog abandoned has not returned, no warm-up
  starts (it waits, WARMING) and no engine is freed;
* a retired engine (stopped, failed, or abandoned by its worker) is closed
  once its worker returned and no stream still reads it: its graphs, their
  memory pool and its staging buffers go back to the device.

The chaos hooks of ``replica_proc_kill`` and ``net_partition`` return False
here (the dispatch raises ``InjectedFault``, as in the JAX package); the
cluster router (serving/cluster.py) overrides them to kill a replica's
process or cut its wire. ``tier=`` stamps results for a tier router.
"""

import heapq
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np

from speakingstyle_torch.faults import FaultPlan
from speakingstyle_torch.obs import JsonlEventLog, MetricsRegistry, make_lock
from speakingstyle_torch.obs.trace import Span, TailSampler, get_span_ring
from speakingstyle_torch.serving import streaming
from speakingstyle_torch.serving.batcher import DrainRateEstimator, Overloaded, ShutdownError
from speakingstyle_torch.serving.engine import (
    SynthesisEngine,
    SynthesisRequest,
    SynthesisResult,
    bucket_label,
)
from speakingstyle_torch.serving.lattice import BucketLattice, StyleLattice
from speakingstyle_torch.serving.resilience import (
    CircuitBreaker,
    DeadlineExceeded,
    DispatchError,
    InjectedFault,
    ReplicaError,
)

__all__ = ["COLD", "DRAINING", "FAILED", "READY", "STATE_CODE", "STOPPED", "WARMING",
           "FleetRouter", "Replica"]

# replica lifecycle states (serve_replica_state gauge values in parens)
COLD = "cold"          # (0) constructed, nothing prepared
WARMING = "warming"    # (1) building the engine / preparing the lattice
READY = "ready"        # (2) dispatching
DRAINING = "draining"  # (3) finishing in-flight work, admitting nothing
STOPPED = "stopped"    # (4) worker exited
FAILED = "failed"      # (5) dispatch raised / hung; circuit-broken, awaiting
#                            its breaker backoff before a re-warm trial
STATE_CODE = {COLD: 0, WARMING: 1, READY: 2, DRAINING: 3, STOPPED: 4, FAILED: 5}


@dataclass(order=True)
class _Pending:
    """One admitted request in the EDF heap (orders by SLO deadline)."""

    slo_deadline: float
    seq: int
    request: SynthesisRequest = field(compare=False)
    future: Future = field(compare=False)
    dispatch_by: float = field(compare=False)  # coalescing deadline
    klass: str = field(compare=False)
    # replica-failure requeues survived so far (bounded by the class's
    # fleet.retry_budget)
    retries: int = field(compare=False, default=0)
    # wall-clock submit stamp (span start) and its monotonic twin (duration)
    submit_wall: float = field(compare=False, default=0.0)
    submit_mono: float = field(compare=False, default=0.0)


class Replica:
    """One engine plus its lifecycle state and dispatch thread."""

    def __init__(self, index: int, breaker: CircuitBreaker):
        self.index = index
        self.engine: Optional[SynthesisEngine] = None
        self.state = COLD
        self.error: Optional[BaseException] = None
        self.worker: Optional[threading.Thread] = None
        self.breaker = breaker
        # exactly-once handshake with the hang watchdog: the batch this
        # replica is dispatching right now. The worker claims it back under
        # the router lock; if the supervisor stole it first (hang), the
        # worker finds ``inflight is not batch`` and discards. ``generation``
        # orphans a hung worker across a re-warm.
        self.inflight: Optional[List[_Pending]] = None
        self.dispatch_started: Optional[float] = None
        self.dispatch_n = 0
        self.generation = 0
        # a replica started with its own factory (a rollout's canary and
        # replacements) re-warms with that factory
        self.factory: Optional[Callable] = None
        self.version: Optional[str] = None


class FleetRouter:
    """SLO-aware admission + EDF dispatch over N replica engines.

    ``engine_factory(registry)`` builds one (unprepared) replica engine that
    shares the fleet's metrics registry; the router prepares it during
    warm-up. The router has the ``submit -> Future`` surface of
    ``ContinuousBatcher``, so the HTTP server takes either as its dispatch
    backend. ``style`` is the StyleService every replica shares (the
    factory closes over it; the server's ``/styles`` reads it), None when
    each replica owns its own. ``fault_plan`` consumes ``replica_raise@N`` /
    ``replica_hang@N`` (N = the router-wide dispatch count, 1-based).
    ``tier`` is stamped onto every result when this router serves one tier
    of a tier router."""

    def __init__(
        self,
        engine_factory: Callable[[MetricsRegistry], SynthesisEngine],
        cfg,
        replicas: Optional[int] = None,
        registry: Optional[MetricsRegistry] = None,
        events: Optional[JsonlEventLog] = None,
        style=None,
        fault_plan: Optional[FaultPlan] = None,
        tier: Optional[str] = None,
    ):
        serve = cfg.serve
        fleet = serve.fleet
        self.cfg = cfg
        self.fleet = fleet
        self.tier = tier
        self.engine_factory = engine_factory
        self.registry = registry if registry is not None else MetricsRegistry()
        self.events = events
        self.style = style
        # admission geometry is engine-free: it works while replicas warm
        self.lattice = BucketLattice.from_config(serve)
        self.style_lattice = StyleLattice.from_config(serve)
        self.max_batch = self.lattice.max_batch
        self.max_wait = serve.max_wait_ms / 1e3
        self._frames_per_phoneme = serve.frames_per_phoneme

        self._cond = make_lock("FleetRouter._cond", kind="condition")
        self._heap: List[_Pending] = []
        self._seq = 0
        self._closing = False
        self._shedding = False
        self._replicas: List[Replica] = []
        self._stream_overlap: Optional[int] = None
        self.fault_plan = fault_plan
        self._dispatch_total = 0  # router-wide, under self._cond
        self._watchdog = fleet.hang_watchdog_s
        # dispatches the watchdog abandoned whose worker has not returned:
        # such a worker may hold DEVICE_GATE shared, so no warm-up starts
        # and no engine is freed until it has
        self._orphans = 0
        # retired engines awaiting their close(), and the streams reading
        # each engine (by id)
        self._retiring: List[SynthesisEngine] = []
        self._stream_users: Dict[int, int] = {}
        # model-lifecycle surface (serving/lifecycle.py)
        self.rollout_active = False
        self.model_version: Optional[str] = None
        self.model_step: Optional[int] = None
        self.model_digest: Optional[str] = None
        # tail sampling: interesting traces are pinned the moment they are
        # detected; the latest pressure trace rides the autoscale event
        self._trace_ring = get_span_ring()
        self._tail_sampler = TailSampler(serve.trace.sample_rate)
        self.last_pressure_trace_id: Optional[str] = None
        # golden-probe class: its own budget, and out of the shed, SLO and
        # autoscaler accounting
        self._probe_class = serve.quality.probe_class
        self._probe_deadline_ms = serve.quality.probe_deadline_ms

        self._shed_ctr = self.registry.counter(
            "serve_shed_total", help="submits shed by backpressure (429, NOT shutdown)")
        self._rejected_ctr = self.registry.counter(
            "serve_rejected_total", help="submits refused at/after shutdown")
        self._pending_gauge = self.registry.gauge(
            "serve_queue_depth", help="router pending-heap occupancy")
        self._latency_hist = self.registry.histogram(
            "serve_request_latency_seconds",
            help="request arrival -> result latency through the router")
        self._queue_wait_hist = self.registry.histogram(
            "serve_queue_wait_seconds",
            help="submit -> dispatch-start wait (the coalescing window the frontend pool "
                 "overlaps with)")
        self._ttfa_hist = self.registry.histogram(
            "serve_ttfa_seconds", help="request arrival -> first streamed wav chunk ready")
        self._requeued_ctr = self.registry.counter(
            "serve_requeued_total", help="in-flight requests requeued off a failed replica")
        # measured drain throughput: a 429's Retry-After derives from it
        self.drain_rate = DrainRateEstimator()
        self._warmup_hist = self.registry.histogram(
            "serve_replica_warmup_seconds",
            help="wall seconds from scale-up to READY (engine build + lattice preparation)")
        self.scale_to(replicas if replicas is not None else fleet.replicas)
        # the supervisor owns the hang watchdog, the breaker re-warms and
        # the deferred engine closes
        self._supervise_interval = max(0.005, min(
            0.25, fleet.rewarm_backoff_s / 2.0,
            self._watchdog / 4.0 if self._watchdog > 0 else 0.25))
        self._supervisor = threading.Thread(
            target=self._supervise, name="fleet-supervisor", daemon=True)
        self._supervisor.start()

    # -- replica lifecycle --------------------------------------------------

    def _set_state(self, rep: Replica, state: str) -> None:
        """Caller holds ``self._cond``."""
        rep.state = state
        self.registry.gauge(
            "serve_replica_state", labels={"replica": str(rep.index)},
            help="replica lifecycle: 0=cold 1=warming 2=ready 3=draining 4=stopped 5=failed",
        ).set(STATE_CODE[state])
        if self.events is not None:
            self.events.emit("replica_state", replica=rep.index, state=state)
        self._cond.notify_all()

    def _set_breaker_gauge(self, rep: Replica) -> None:
        self.registry.gauge(
            "serve_replica_breaker_state", labels={"replica": str(rep.index)},
            help="replica circuit breaker: 0=closed 1=open 2=half_open",
        ).set(rep.breaker.code)

    def _new_replica(self) -> Replica:
        """Caller holds ``self._cond``."""
        rep = Replica(len(self._replicas), CircuitBreaker(
            self.fleet.rewarm_backoff_s, self.fleet.rewarm_backoff_max_s))
        self._replicas.append(rep)
        self._set_state(rep, COLD)
        self._set_breaker_gauge(rep)
        return rep

    def _start_warm(self, rep: Replica, name: str) -> None:
        threading.Thread(target=self._warm, args=(rep,), name=f"replica-{rep.index}-{name}",
                         daemon=True).start()

    def scale_to(self, n: int) -> None:
        """Grow or shrink the ready + warming replica set. Growth warms new
        replicas on background threads; shrink marks the newest replicas
        DRAINING (they finish their in-flight dispatch and stop)."""
        if n < 0:
            raise ValueError(f"scale_to requires n >= 0, got {n}")
        with self._cond:
            if self._closing:
                raise ShutdownError("router is closed")
            live = [r for r in self._replicas if r.state in (COLD, WARMING, READY, FAILED)]
            for rep in live[n:]:  # shrink newest-first
                if rep.state == READY:
                    self._set_state(rep, DRAINING)
                else:  # cold / warming / failed: nothing in flight to drain
                    self._set_state(rep, STOPPED)
            new = [self._new_replica() for _ in range(max(0, n - len(live)))]
        for rep in new:
            self._start_warm(rep, "warmup")

    def _warm(self, rep: Replica) -> None:
        """Background warm-up: build the engine, prepare its lattice, go
        READY and start the dispatch worker. Waits first while a dispatch
        the watchdog abandoned has not returned (it may hold the device
        gate, which the preparation takes exclusively)."""
        with self._cond:
            if rep.state != COLD:  # shrunk away before warm-up began
                return
            self._set_state(rep, WARMING)
            deferred = False
            while self._orphans and not self._closing and rep.state == WARMING:
                if not deferred and self.events is not None:
                    self.events.emit("replica_warm_deferred", replica=rep.index,
                                     orphans=self._orphans)
                deferred = True
                self._cond.wait(timeout=0.5)
            if rep.state != WARMING:
                return
            factory = rep.factory if rep.factory is not None else self.engine_factory
        t0 = time.monotonic()
        engine = None
        try:
            engine = factory(self.registry)
            gate = getattr(engine, "quality", None)
            if gate is not None and hasattr(gate, "bind"):
                gate.bind(tier=self.tier, trace_ring=self._trace_ring,
                          tail_sampler=self._tail_sampler, events=self.events)
            secs = engine.precompile()
            self.registry.gauge(
                "serve_replica_precompile_seconds", labels={"replica": str(rep.index)},
                help="wall seconds the replica's lattice preparation took").set(secs)
            self._warmup_hist.observe(time.monotonic() - t0)
        except BaseException as e:
            with self._cond:
                rep.error = e
                if engine is not None:
                    self._retiring.append(engine)
                if rep.breaker.state == "half_open":
                    # a re-warm trial failed: re-open with a doubled backoff
                    rep.breaker.record_failure(time.monotonic())
                    self._set_breaker_gauge(rep)
                    self._set_state(rep, FAILED)
                else:  # the first warm-up never worked: stop for good
                    self._set_state(rep, STOPPED)
            if self.events is not None:
                self.events.emit("replica_warm_failed", replica=rep.index,
                                 error=type(e).__name__)
            self._free_retired()
            return
        with self._cond:
            if rep.state != WARMING:  # shrunk away mid-warm-up
                self._retiring.append(engine)
                retired = True
            else:
                retired = False
                rep.engine = engine
                rep.generation += 1  # orphan any worker from a past life
                gen = rep.generation
                self._set_state(rep, READY)
                # publish and start the worker under the lock: close()
                # joins every published worker
                worker = threading.Thread(target=self._worker, args=(rep, gen, engine),
                                          name=f"replica-{rep.index}-dispatch", daemon=True)
                worker.start()
                rep.worker = worker
        if retired:
            self._free_retired()

    def states(self) -> Dict[int, str]:
        with self._cond:
            return {r.index: r.state for r in self._replicas}

    def ready(self) -> bool:
        with self._cond:
            return any(r.state == READY for r in self._replicas)

    def wait_ready(self, timeout: float = 120.0, n: Optional[int] = None) -> bool:
        """Block until ``n`` replicas are READY (default 1, the /healthz
        bar) or warm-up can no longer get there."""
        want = 1 if n is None else n
        deadline = time.monotonic() + timeout
        with self._cond:
            while True:
                if sum(r.state == READY for r in self._replicas) >= want:
                    return True
                if all(r.state == STOPPED for r in self._replicas):
                    return False
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cond.wait(timeout=remaining)

    def engines(self) -> List[SynthesisEngine]:
        with self._cond:
            return [r.engine for r in self._replicas if r.engine is not None]

    def engine_at(self, index: int) -> Optional[SynthesisEngine]:
        with self._cond:
            return self._replicas[index].engine

    # -- model lifecycle surface (serving/lifecycle.py drives these) ---------

    def start_replica(self, factory: Optional[Callable] = None,
                      version: Optional[str] = None) -> int:
        """Append one replica, optionally pinned to its own engine factory
        (a rollout's canary builds the candidate while the router's factory
        still builds the live version), and warm it. Returns its index."""
        with self._cond:
            if self._closing:
                raise ShutdownError("router is closed")
            rep = self._new_replica()
            rep.factory = factory
            rep.version = version
        self._start_warm(rep, "warmup")
        return rep.index

    def drain_replica(self, index: int) -> None:
        """Retire one replica: READY drains (finishes its in-flight
        dispatch and stops pulling work); cold / warming / failed stop at
        once; draining / stopped is a no-op."""
        with self._cond:
            rep = self._replicas[index]
            if rep.state == READY:
                self._set_state(rep, DRAINING)
            elif rep.state in (COLD, WARMING, FAILED):
                self._set_state(rep, STOPPED)

    def wait_state(self, index: int, states, timeout: float = 120.0) -> bool:
        """Block until replica ``index`` reaches one of ``states``."""
        want = (states,) if isinstance(states, str) else tuple(states)
        deadline = time.monotonic() + timeout
        with self._cond:
            while self._replicas[index].state not in want:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cond.wait(timeout=remaining)
            return True

    def set_model_version(self, version: Optional[str], step: Optional[int] = None,
                          digest: Optional[str] = None) -> None:
        """Publish the running model's identity: the ``serve_model_version``
        gauge (the checkpoint step), ``X-Model-Version`` and the /healthz
        model block read it."""
        self.model_version = version
        self.model_step = step
        self.model_digest = digest
        if step is not None:
            self.registry.gauge(
                "serve_model_version",
                help="checkpoint step of the model version the fleet is serving (see the "
                     "/healthz model block for the digest)").set(step)

    # -- autoscaler signal surface (serving/autoscale.py reads these) -------

    def pending_depth(self) -> int:
        """EDF heap occupancy, probe-class entries excluded."""
        with self._cond:
            return sum(p.klass != self._probe_class for p in self._heap)

    def live_replica_count(self) -> int:
        """Replicas counted by ``scale_to`` (cold / warming / ready /
        failed): warm-ups included, so one queue spike cannot buy a replica
        a tick while the first is still warming."""
        with self._cond:
            return sum(r.state in (COLD, WARMING, READY, FAILED) for r in self._replicas)

    def occupancy(self) -> float:
        """Busy share of READY replicas (a replica is busy while it holds an
        in-flight claim of other than probe-class requests); 0.0 with none
        READY."""
        with self._cond:
            ready = [r for r in self._replicas if r.state == READY]
            if not ready:
                return 0.0
            busy = sum(r.inflight is not None
                       and any(p.klass != self._probe_class for p in r.inflight)
                       for r in ready)
            return busy / len(ready)

    def warmup_cost_s(self) -> Optional[float]:
        """p50 of ``serve_replica_warmup_seconds``; None before the first."""
        if self._warmup_hist.count == 0:
            return None
        return self._warmup_hist.percentile(0.50)

    # -- tail sampling -------------------------------------------------------

    def _note_pressure(self, ctx, reason: str) -> None:
        """Pin an interesting trace (shed / 504 / retry exhaustion / miss)
        and remember it as the latest pressure signal."""
        if ctx is None:
            return
        if self._tail_sampler.keep(ctx.trace_id, reason):
            self._trace_ring.pin(ctx.trace_id)
        self.last_pressure_trace_id = ctx.trace_id

    # -- admission ----------------------------------------------------------

    def _admit(self, req: SynthesisRequest) -> str:
        """Class and geometry checks at submit (engine-free). Returns the
        resolved priority class."""
        klass = req.priority or self.fleet.default_class
        if klass not in self.fleet.class_deadline_ms and klass != self._probe_class:
            raise ValueError(
                f"unknown priority class {klass!r}; configured classes: "
                f"{sorted(self.fleet.class_deadline_ms)}")
        if getattr(req, "pending", False):
            # a frontend handle: geometry is checked at dispatch
            return klass
        if req.sequence.ndim != 1:
            raise ValueError(f"request {req.id!r}: sequence must be [L], got {req.sequence.shape}")
        if req.style is None and req.ref_mel is not None:
            if req.ref_mel.ndim != 2:
                raise ValueError(
                    f"request {req.id!r}: ref_mel must be [T, n_mels], got {req.ref_mel.shape}")
            self.style_lattice.cover(1, req.ref_mel.shape[0])
        self.lattice.cover(1, len(req.sequence), len(req.sequence) * self._frames_per_phoneme)
        return klass

    def _budget_s(self, req: SynthesisRequest, klass: str) -> float:
        """The class deadline (or the request's ``deadline_ms`` override,
        clamped to ``fleet.max_deadline_ms``) in seconds."""
        override = getattr(req, "deadline_ms", None)
        if override is None:
            if klass == self._probe_class:
                return self._probe_deadline_ms / 1e3
            return self.fleet.class_deadline_ms[klass] / 1e3
        if override <= 0:
            raise ValueError(
                f"request {getattr(req, 'id', '?')!r}: deadline_ms override must be > 0, "
                f"got {override}")
        return min(float(override), self.fleet.max_deadline_ms) / 1e3

    def _check_shed(self, count: bool = True) -> None:
        """Watermark hysteresis; caller holds ``self._cond``. ``count=False``
        (probe-class submits) sheds without counting ``serve_shed_total``."""
        depth = len(self._heap)
        cap = self.fleet.queue_depth
        if self._shedding:
            if depth <= self.fleet.shed_low_watermark * cap:
                self._shedding = False
        elif depth >= self.fleet.shed_high_watermark * cap:
            self._shedding = True
        if self._shedding:
            if count:
                self._shed_ctr.inc()
            raise Overloaded(
                f"fleet pending queue at {depth}/{cap} (high watermark "
                f"{self.fleet.shed_high_watermark:g}): shedding load",
                retry_after_s=self.drain_rate.retry_after(
                    max(depth - self.fleet.shed_low_watermark * cap, 1.0),
                    self.fleet.shed_retry_after_s))

    def submit(self, request: SynthesisRequest) -> Future:
        """Admit one request; returns a Future of its SynthesisResult.
        Raises RequestTooLarge / ValueError on geometry, Overloaded past
        the shed watermark, ShutdownError after close."""
        klass = self._admit(request)
        is_probe = klass == self._probe_class
        fut: Future = Future()
        with self._cond:
            if self._closing:
                self._rejected_ctr.inc()
                raise ShutdownError("router is closed")
            try:
                self._check_shed(count=not is_probe)
            except Overloaded:
                if is_probe:
                    self.registry.counter(
                        "serve_probe_shed_total",
                        help="probe-class submits shed by backpressure (excluded from "
                             "pressure + latency SLO)").inc()
                    raise
                self.registry.counter(
                    "serve_class_shed_total", labels={"class": klass},
                    help="submits shed by backpressure, per priority class (the SLO "
                         "engine's bad-event stream)").inc()
                self._note_pressure(getattr(request, "trace", None), "shed")
                raise
            budget = self._budget_s(request, klass)
            self._seq += 1
            heapq.heappush(self._heap, _Pending(
                slo_deadline=request.arrival + budget, seq=self._seq, request=request,
                future=fut, dispatch_by=request.arrival + self.max_wait, klass=klass,
                submit_wall=time.time(), submit_mono=time.monotonic()))
            self._pending_gauge.set(len(self._heap))
            if is_probe:
                self.registry.counter(
                    "serve_probe_requests_total",
                    help="probe-class requests admitted (the quality plane's golden replays "
                         "- not tenant traffic)").inc()
            else:
                self.registry.counter(
                    "serve_class_requests_total", labels={"class": klass},
                    help="requests admitted per priority class").inc()
            self._cond.notify_all()
        return fut

    # -- dispatch -----------------------------------------------------------

    @property
    def dispatch_total(self) -> int:
        """Router-wide dispatch count so far: the counter the
        ``replica_raise@N`` / ``replica_hang@N`` fault kinds index."""
        with self._cond:
            return self._dispatch_total

    def _collect(self, rep: Replica) -> Optional[List[_Pending]]:
        """EDF pop + coalesce for one replica; None = the worker exits. A
        request popped past its deadline resolves as DeadlineExceeded. The
        batch becomes the replica's in-flight claim, stamped with its
        router-wide dispatch number, before the lock drops."""
        expired: List[_Pending] = []
        batch: Optional[List[_Pending]] = None
        with self._cond:
            while batch is None:
                if not self._heap:
                    if rep.state != READY or self._closing:
                        break
                    self._cond.wait(timeout=0.5)
                    continue
                if rep.state != READY:
                    break
                p = heapq.heappop(self._heap)
                if time.monotonic() > p.slo_deadline:
                    expired.append(p)
                    continue
                batch = [p]
            if batch is not None:
                while len(batch) < self.max_batch:
                    if self._heap:
                        p = heapq.heappop(self._heap)
                        if time.monotonic() > p.slo_deadline:
                            expired.append(p)
                            continue
                        batch.append(p)
                        continue
                    if self._closing or rep.state != READY:
                        break
                    wait = min(q.dispatch_by for q in batch) - time.monotonic()
                    if wait <= 0:
                        break
                    self._cond.wait(timeout=wait)
                self._dispatch_total += 1
                rep.dispatch_n = self._dispatch_total
                rep.inflight = batch
                rep.dispatch_started = time.monotonic()
            self._pending_gauge.set(len(self._heap))
        for p in expired:
            self._resolve_deadline_exceeded(p)
        return batch

    def _resolve_deadline_exceeded(self, p: _Pending) -> None:
        """Resolve one pending as DeadlineExceeded (already off the heap)."""
        if p.future.done():
            return
        ctx = getattr(p.request, "trace", None)
        if p.klass == self._probe_class:
            self.registry.counter(
                "serve_probe_deadline_exceeded_total",
                help="probe-class requests resolved 504 before dispatch (excluded from the "
                     "latency SLO bad stream)").inc()
        else:
            self.registry.counter(
                "serve_deadline_exceeded_total", labels={"class": p.klass},
                help="requests resolved 504 instead of dispatched past their class deadline "
                     "budget").inc()
            self._note_pressure(ctx, "deadline_exceeded")
        if self.events is not None:
            self.events.emit("deadline_exceeded", req_id=p.request.id, klass=p.klass,
                             retries=p.retries,
                             trace_id=ctx.trace_id if ctx is not None else None)
        budget = self._budget_s(p.request, p.klass) * 1e3
        self.drain_rate.note(1)
        p.future.set_exception(DeadlineExceeded(
            f"request {p.request.id!r} exceeded its {p.klass!r} deadline budget "
            f"({budget:g} ms) before dispatch", klass=p.klass, budget_ms=budget))

    def _claim(self, rep: Replica, batch: List[_Pending]) -> bool:
        """Take the in-flight batch back from the watchdog. False: the
        supervisor stole it (hang); the caller owns nothing and discards
        what the engine returned."""
        with self._cond:
            if rep.inflight is not batch:
                self._orphan_returned()
                return False
            rep.inflight = None
            rep.dispatch_started = None
            return True

    def _orphan_returned(self) -> None:
        """A worker whose batch the watchdog stole is back (it holds no
        gate now); caller holds ``self._cond``."""
        self._orphans -= 1
        self._cond.notify_all()

    def _resolve_pending(self, p: _Pending) -> bool:
        """Swap a frontend handle for its resolved request in place, keeping
        a precision a tier router stamped on the handle (the JAX router
        drops it here). False: the frontend raised, the future carries the
        error, and the entry leaves the batch."""
        if not getattr(p.request, "pending", False):
            return True
        try:
            request = p.request.resolve()
            precision = getattr(p.request, "precision", None)
            if precision is not None:
                request.precision = precision
            self._admit(request)  # geometry deferred from submit
        except BaseException as e:
            if not p.future.done():
                p.future.set_exception(e)
            return False
        p.request = request
        return True

    def _dispatch(self, rep: Replica, engine, batch: List[_Pending]) -> bool:
        """Run one coalesced batch on the replica's engine. False when the
        replica failed (or the watchdog stole its results) and the worker
        exits: supervision owns the replica from there."""
        drop = [p for p in batch if not self._resolve_pending(p)]
        if drop:
            with self._cond:
                if rep.inflight is not batch:
                    self._orphan_returned()
                    return False  # stolen mid-resolve; the supervisor owns it
                for p in drop:
                    batch.remove(p)
        if not batch:
            return self._claim(rep, batch)
        req_ids = [p.request.id for p in batch]
        n = rep.dispatch_n  # stamped under _cond in _collect by this same worker
        t0 = time.monotonic()
        t0_wall = time.time()
        for p in batch:
            self._queue_wait_hist.observe(t0 - p.request.arrival)
            ctx = getattr(p.request, "trace", None)
            if ctx is not None and p.submit_wall:
                Span.record("serve_queue", p.submit_wall, max(0.0, t0 - p.submit_mono),
                            parent=ctx, klass=p.klass, retries=p.retries)
        try:
            if self.fault_plan is not None:
                if self.fault_plan.fire("replica_raise", n):
                    raise InjectedFault(f"injected replica_raise at dispatch {n}")
                if self.fault_plan.fire("replica_hang", n):
                    # stall past the watchdog (holding nothing), then run:
                    # exercises the stolen-results path
                    time.sleep(3.0 * self._watchdog if self._watchdog > 0 else 0.5)
                if self.fault_plan.fire("replica_proc_kill", n) and not self._chaos_proc_kill(rep):
                    raise InjectedFault(f"injected replica_proc_kill at dispatch {n}")
                if self.fault_plan.fire("net_partition", n) and not self._chaos_partition(rep):
                    raise InjectedFault(f"injected net_partition at dispatch {n}")
                if self.fault_plan.fire("tier_poison", n):
                    # the quality drill: the dispatch succeeds with garbage
                    # weights, and only the gate can tell
                    poison = getattr(engine, "poison_params", None)
                    if poison is not None:
                        poison()
            results = engine.run([p.request for p in batch])
        except BaseException as e:
            if not self._claim(rep, batch):
                return False  # the watchdog already failed us and requeued
            if self.events is not None:
                self.events.emit("fleet_dispatch", replica=rep.index, req_ids=req_ids,
                                 rows=len(batch), duration_s=time.monotonic() - t0, ok=False,
                                 error=type(e).__name__)
            self._replica_failed(rep, batch, e, kind="raise")
            return False
        if not self._claim(rep, batch):
            # hung past the watchdog, then finished: the requests were
            # requeued elsewhere, these results are orphans
            if self.events is not None:
                self.events.emit("dispatch_discarded", replica=rep.index, req_ids=req_ids,
                                 duration_s=time.monotonic() - t0)
            return False
        now = time.monotonic()
        self.drain_rate.note(len(batch), now=now)
        try:
            self.registry.counter(
                "serve_batch_occupancy_total", labels={"rows": str(len(batch))},
                help="dispatches by real-row occupancy").inc()
            self.registry.counter(
                "serve_replica_dispatches_total", labels={"replica": str(rep.index)},
                help="coalesced dispatches executed per replica").inc()
            self.registry.counter(
                "serve_replica_requests_total", labels={"replica": str(rep.index)},
                help="requests served per replica").inc(len(batch))
            bucket = getattr(results[0], "bucket", None) if results else None
            if self.events is not None:
                self.events.emit("fleet_dispatch", replica=rep.index, req_ids=req_ids,
                                 rows=len(batch),
                                 bucket=bucket_label(bucket) if bucket is not None else None,
                                 duration_s=now - t0)
            if rep.breaker.state != "closed":
                # the first good dispatch after a re-warm trial closes it
                rep.breaker.record_success()
                with self._cond:
                    self._set_breaker_gauge(rep)
            for p, r in zip(batch, results):
                r.replica = rep.index
                if self.tier is not None:
                    r.tier = self.tier
                self._latency_hist.observe(now - p.request.arrival)
                ctx = getattr(p.request, "trace", None)
                if now > p.slo_deadline:
                    if p.klass == self._probe_class:
                        self.registry.counter(
                            "serve_probe_deadline_miss_total",
                            help="probe-class requests completed past their probe deadline "
                                 "(excluded from the latency SLO bad stream)").inc()
                    else:
                        self.registry.counter(
                            "serve_deadline_miss_total", labels={"class": p.klass},
                            help="requests completed past their SLO deadline").inc()
                        self._note_pressure(ctx, "deadline_miss")
                elif ctx is not None and self._tail_sampler.keep(ctx.trace_id):
                    self._trace_ring.pin(ctx.trace_id)
                if ctx is not None:
                    Span.record("fleet_dispatch", t0_wall, max(0.0, now - t0), parent=ctx,
                                replica=rep.index, rows=len(batch))
                p.future.set_result(r)
        except BaseException as e:
            # a bookkeeping error after a good engine call resolves the
            # batch as DispatchError and keeps the worker alive
            self.registry.counter(
                "serve_dispatch_errors_total",
                help="dispatch-loop bookkeeping errors resolved as DispatchError (500) "
                     "without killing the worker").inc()
            if self.events is not None:
                self.events.emit("dispatch_error", replica=rep.index, req_ids=req_ids,
                                 error=type(e).__name__)
            err = DispatchError(f"dispatch bookkeeping failed on replica {rep.index}: "
                                f"{type(e).__name__}: {e}")
            for p in batch:
                if not p.future.done():
                    p.future.set_exception(err)
        return True

    def _chaos_proc_kill(self, rep: Replica) -> bool:
        """The ``replica_proc_kill`` drill's hook: in-process replicas have
        no process to kill, so False (the dispatch raises InjectedFault);
        ``ClusterRouter`` kills the replica's process."""
        return False

    def _chaos_partition(self, rep: Replica) -> bool:
        """The ``net_partition`` drill's hook: no wire to cut, so False;
        ``ClusterRouter`` partitions the replica."""
        return False

    def _replica_failed(self, rep: Replica, batch: List[_Pending], error: BaseException,
                        kind: str) -> None:
        """Fail one replica and requeue its in-flight batch onto the healthy
        ones. The caller owns ``batch`` exclusively (claimed or stolen)."""
        now = time.monotonic()
        expired: List[_Pending] = []
        exhausted: List[_Pending] = []
        shutdown: List[_Pending] = []
        requeued: List[_Pending] = []
        with self._cond:
            rep.error = error
            if rep.state in (READY, DRAINING):
                # a DRAINING replica was being shrunk away: stop it for good
                target = FAILED if rep.state == READY else STOPPED
                backoff = rep.breaker.record_failure(now)
                self._set_breaker_gauge(rep)
                self._set_state(rep, target)
            else:
                backoff = rep.breaker.retry_at() - now
            self.registry.counter(
                "serve_replica_failures_total", labels={"replica": str(rep.index)},
                help="dispatch failures (raise or hang) per replica").inc()
            for p in batch:
                budget = self.fleet.retry_budget.get(p.klass, 0)
                if p.future.done():
                    continue
                if self._closing:
                    shutdown.append(p)
                elif now > p.slo_deadline:
                    expired.append(p)
                elif p.retries >= budget:
                    exhausted.append(p)
                else:
                    p.retries += 1
                    requeued.append(p)
            for p in requeued:
                heapq.heappush(self._heap, p)
                self._requeued_ctr.inc()
                self.registry.counter(
                    "serve_retries_total", labels={"class": p.klass},
                    help="replica-failure retries consumed per class").inc()
            self._pending_gauge.set(len(self._heap))
            self._cond.notify_all()
        if self.events is not None:
            self.events.emit(
                "replica_failure", replica=rep.index, kind=kind, error=type(error).__name__,
                req_ids=[p.request.id for p in batch], requeued=[p.request.id for p in requeued],
                failed=[p.request.id for p in exhausted], expired=[p.request.id for p in expired],
                backoff_s=round(max(0.0, backoff), 6),
                trace_id=next((p.request.trace.trace_id for p in batch
                               if getattr(p.request, "trace", None) is not None), None))
        now_wall = time.time()
        for p in requeued:
            ctx = getattr(p.request, "trace", None)
            if ctx is not None:
                Span.record("fleet_requeue", now_wall, 0.0, parent=ctx,
                            events=[{"name": "requeue", "ts": now_wall, "replica": rep.index,
                                     "kind": kind, "retry": p.retries}])
        for p in expired:
            self._resolve_deadline_exceeded(p)
        for p in shutdown:
            p.future.set_exception(ShutdownError("router closed"))
        for p in exhausted:
            self._note_pressure(getattr(p.request, "trace", None), "error")
            p.future.set_exception(ReplicaError(
                f"request {p.request.id!r} ({p.klass!r}) exhausted its retry budget after "
                f"replica {rep.index} failed: {type(error).__name__}: {error}"))

    def _supervise(self) -> None:
        """Hang watchdog, breaker re-warm scheduler and deferred engine
        closes (one daemon thread per router)."""
        while True:
            hung, rewarm, expired = [], [], []
            with self._cond:
                if self._closing:
                    return
                self._cond.wait(timeout=self._supervise_interval)
                if self._closing:
                    return
                now = time.monotonic()
                # expired work is at the EDF front: resolve it even when no
                # worker pops (every replica failed)
                while self._heap and now > self._heap[0].slo_deadline:
                    expired.append(heapq.heappop(self._heap))
                if expired:
                    self._pending_gauge.set(len(self._heap))
                for rep in self._replicas:
                    if (self._watchdog > 0 and rep.state == READY
                            and rep.inflight is not None
                            and rep.dispatch_started is not None
                            and now - rep.dispatch_started > self._watchdog):
                        # steal the batch: the hung worker finds its claim
                        # gone and discards whatever it returns
                        batch = rep.inflight
                        rep.inflight = None
                        rep.dispatch_started = None
                        self._orphans += 1
                        hung.append((rep, batch))
                    elif rep.state == FAILED and rep.breaker.ready_to_trial(now):
                        rep.breaker.begin_trial()
                        self._set_breaker_gauge(rep)
                        self._set_state(rep, COLD)
                        rewarm.append(rep)
                pending_close = bool(self._retiring) and not self._orphans
            for p in expired:
                self._resolve_deadline_exceeded(p)
            for rep, batch in hung:
                self._replica_failed(rep, batch, TimeoutError(
                    f"replica {rep.index} dispatch exceeded the {self._watchdog:g}s hang "
                    "watchdog"), kind="hang")
            for rep in rewarm:
                self._start_warm(rep, "rewarm")
            if pending_close:
                self._free_retired()

    def _worker(self, rep: Replica, gen: int, engine) -> None:
        try:
            while True:
                batch = self._collect(rep)
                if batch is None:
                    break
                if not self._dispatch(rep, engine, batch):
                    return  # failed or orphaned; supervision owns the replica
        except BaseException as e:  # a harness bug: fail the waiters loudly
            self._fail_pending(e)
            raise
        finally:
            with self._cond:
                # do not stomp FAILED (supervision owns it) or a newer
                # generation's state after a re-warm
                if rep.generation == gen and rep.state in (READY, DRAINING):
                    self._set_state(rep, STOPPED)
                # this engine serves nothing more (a failed replica re-warms
                # into a new one): close it once no stream reads it
                if rep.engine is engine:
                    rep.engine = None
                self._retiring.append(engine)
            self._free_retired()

    def _free_retired(self) -> None:
        """Close the retired engines no stream reads, unless an abandoned
        dispatch may still hold the device gate (the supervisor retries)."""
        with self._cond:
            if self._orphans:
                return
            free = [e for e in self._retiring if not self._stream_users.get(id(e))]
            self._retiring = [e for e in self._retiring if self._stream_users.get(id(e))]
        for engine in free:
            close = getattr(engine, "close", None)
            if close is not None:
                close()
            if self.events is not None:
                self.events.emit("engine_closed", engine=type(engine).__name__)

    def _fail_pending(self, error: BaseException) -> None:
        with self._cond:
            pending, self._heap = self._heap, []
            self._pending_gauge.set(0)
        for p in pending:
            if not p.future.done():
                p.future.set_exception(ShutdownError(f"fleet router closed: {error!r}"))

    # -- streaming ----------------------------------------------------------

    def stream(self, result: SynthesisResult,
               arrival: Optional[float] = None) -> Iterator[np.ndarray]:
        """int16 wav chunks of a dispatched result, vocoded window by window
        on the replica that produced it (prepared vocoder points only).
        Observes ``serve_ttfa_seconds`` at the first chunk when ``arrival``
        (a monotonic stamp) is given. A stream continuation is never
        retried on another replica."""
        with self._cond:
            reps = {r.index: r for r in self._replicas}
            rep = reps.get(result.replica)
            if rep is not None and rep.state not in (READY, DRAINING):
                raise ReplicaError(
                    f"stream for result {result.id!r} lost replica {result.replica} "
                    f"(state={rep.state!r}); stream continuations are not retried")
            if rep is None or rep.engine is None:
                raise ValueError(f"result {result.id!r} carries no live replica "
                                 f"(replica={result.replica})")
            engine = rep.engine
            self._stream_users[id(engine)] = self._stream_users.get(id(engine), 0) + 1
        try:
            if self._stream_overlap is None:
                self._stream_overlap = streaming.resolve_overlap(self.fleet.stream_overlap,
                                                                 engine.vocoder)
            first = True
            for chunk in streaming.stream_wav(engine, result, self.fleet.stream_window,
                                              self._stream_overlap,
                                              depth=self.fleet.stream_depth):
                if first and arrival is not None:
                    self._ttfa_hist.observe(time.monotonic() - arrival)
                first = False
                yield chunk
        finally:
            with self._cond:
                users = self._stream_users[id(engine)] - 1
                if users:
                    self._stream_users[id(engine)] = users
                else:
                    del self._stream_users[id(engine)]
                retired = any(e is engine for e in self._retiring)
            if retired and not users:
                self._free_retired()

    # -- shutdown -----------------------------------------------------------

    def close(self, flush: bool = True, timeout: float = 30.0) -> None:
        """Idempotent shutdown. ``flush=True`` lets ready workers drain the
        heap; ``flush=False`` fails pending requests with ShutdownError.
        In-flight dispatches always complete."""
        with self._cond:
            self._closing = True
            for rep in self._replicas:
                if rep.state in (COLD, WARMING, FAILED):
                    self._set_state(rep, STOPPED)
            workers = [r.worker for r in self._replicas if r.worker]
            self._cond.notify_all()
        if not flush:
            self._fail_pending(ShutdownError("router closed"))
        deadline = time.monotonic() + timeout
        for w in workers:
            w.join(timeout=max(0.0, deadline - time.monotonic()))
        self._fail_pending(ShutdownError("router closed"))

    def __enter__(self) -> "FleetRouter":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False
