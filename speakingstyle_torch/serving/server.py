"""Stdlib HTTP front end over a dispatch backend (JAX counterpart:
speakingstyle_tpu/serving/server.py): the continuous batcher over one
engine (``engine=``), or the fleet router over N replica engines
(``router=``, serving/fleet.py; JAX ``:433-478``), whose replicas may be
processes (a ``ClusterRouter``, serving/cluster.py).

``ThreadingHTTPServer`` gives one thread per connection. Each handler
thread parses JSON, hands the G2P to the frontend pool (or runs it inline
with ``serve.frontend_workers: 0``), submits the request to the backend and
blocks on its future, so concurrent clients coalesce into shared
dispatches. Every synthesis runs on a dispatch thread (the batcher's one,
or one a replica), which replays the engine's prepared CUDA graphs; the
handlers prepare nothing. Style uploads encode through the StyleService (the
router's shared one in fleet mode) on the handler or pool thread, on
programs the precompile prepared. Behind a router a handler waits no longer
than its class deadline plus ``fleet.deadline_grace_ms`` (JAX ``:1152``).

API (every field of a synthesize payload but "text" optional):
  POST /synthesize     {"text", "speaker_id"/"speaker", "pitch_control",
                       "energy_control", "duration_control" (a number, or
                       a per-word list with English text), "style_id",
                       "ref_audio" (confined to serve.style.ref_dir),
                       "priority"} -> audio/wav (16-bit PCM)
  POST /synthesize/stream
                       same payload -> chunked audio/wav: a streaming RIFF
                       header, then overlap-trimmed windows as they are
                       vocoded (serving/streaming.py); serve_ttfa_seconds
                       records the first window
  POST /synthesize/longform
                       {"text" (a chapter), "speaker_id", scalar controls,
                       "style_id" / "ref_audio", "tier"} -> chunked
                       audio/wav: the chapter split at sentences into
                       lattice-sized chunks, synthesized as one
                       deadline-sharing group through the backend and
                       joined by an equal-power crossfade
                       (serving/longform.py); X-Longform-Tier,
                       X-Longform-Chunks and X-Model-Tier headers; 413
                       with "max_chunks" past serve.longform.max_chunks
  POST /styles         a reference wav (audio/wav body, or JSON
                       {"ref_audio": <ref_dir path>}, "?speaker=NAME")
                       -> {"style_id", "ref_frames", "speaker", "d_model",
                       "cached"}; content-addressed, so a repeat upload
                       runs no encoder work
  GET  /styles         -> {"styles": [...], "capacity"}
  GET  /healthz        -> the registry snapshot's view, build identity,
                       the model block, the ``slo`` block, behind a tier
                       router the ``tiers`` block (routing table, gate
                       verdicts) and with a prober ``quality.probes``;
                       503 until the engine's lattice is prepared, or
                       behind a router until one replica (of the default
                       tier) is ready (the body then carries each
                       replica's lifecycle state)
  GET  /metrics        -> Prometheus text of the same registry
  GET  /debug/programs -> one ProgramCard dict per prepared program (every
                       replica's engine in index order, then the style
                       programs once)
  GET  /debug/spans, /debug/trace/<trace_id>
                       -> the span ring, one assembled trace (in cluster
                       mode joined with the replica processes' spans)
  POST /debug/profile?seconds=N
                       -> a torch.profiler capture of the live process
                       (serve.debug_profile gates it); in cluster mode
                       fanned out to every replica process first
                       ("replicas" in the answer)
  POST /admin/rollout  {"step": N} -> the canary-gated rolling rollout
                       (serving/lifecycle.py) to checkpoint N: 404 without
                       a RolloutManager, 400 on a bad body, 409 while one
                       runs, 200 with the outcome (committed or aborted)

Status codes: 400 bad input, 413 a request past the lattice (its body
names the ceilings and ``/synthesize/longform``), 429 +
Retry-After on shed (``serve_shed_total``), 503 on shutdown
(``serve_rejected_total``), 504 on a timeout, 500 on a dispatch error or
a wav that fails the quality gate. Every synthesize response, errors
included, carries ``X-Request-Id`` and ``X-Trace-Id``.

Cluster mode (JAX ``:601-608``, ``:829-833``, ``:1113-1114``,
``:1339-1371``, ``:1444-1452``): a response names the replica process that
served it in ``X-Served-By`` (and its ``http_request`` event in
``served_by``); ``/metrics`` appends the ``fleet_*`` federation, every
replica's counters summed and histogram buckets merged; ``/healthz`` has a
``cluster`` block (quorum, control address, a lease row a replica) and
answers 503 until the quorum is READY. A stream (and so a chapter) needs a
vocoder in this process, which a cluster router has not: 400, as in JAX.
The ring long-form tier rides in when the caller attaches a ``RingTier``
to ``server.longform.ring`` (``cli/serve.py`` on one engine, as the JAX
command does).
"""

import concurrent.futures
import contextlib
import json
import os
import struct
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional
from urllib.parse import parse_qs, urlparse

import numpy as np

from speakingstyle_torch.obs import JsonlEventLog, Span, build_info, make_lock, process_rss_bytes
from speakingstyle_torch.obs.quality import QualityGate
from speakingstyle_torch.obs.quality import last_fail as quality_last_fail
from speakingstyle_torch.obs.trace import assemble_trace, get_span_ring
from speakingstyle_torch.serving import streaming
from speakingstyle_torch.serving.batcher import ContinuousBatcher, Overloaded, ShutdownError
from speakingstyle_torch.serving.engine import SynthesisEngine
from speakingstyle_torch.serving.frontend import FrontendPool, TextFrontend, confined_ref_path
from speakingstyle_torch.serving.lattice import RequestTooLarge
from speakingstyle_torch.serving.longform import LongformService
from speakingstyle_torch.serving.resilience import DeadlineExceeded, DispatchError, ReplicaError

__all__ = ["SynthesisServer", "profile_window", "wav_bytes", "wav_stream_header"]

# how long a handler waits on its request's future (behind a router, no
# longer than the class deadline and its grace either)
REQUEST_TIMEOUT_S = 60.0
# /healthz reads of a router's states around its ready predicate, at most
HEALTH_READS = 3


def wav_bytes(wav: np.ndarray, sampling_rate: int) -> bytes:
    """int16 PCM -> a complete RIFF/WAVE file in memory."""
    data = np.asarray(wav, np.int16).tobytes()
    hdr = b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE"
    hdr += b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, sampling_rate, sampling_rate * 2, 2, 16)
    hdr += b"data" + struct.pack("<I", len(data))
    return hdr + data


def wav_stream_header(sampling_rate: int) -> bytes:
    """A RIFF/WAVE header with unknown-length sizes (0xFFFFFFFF), sent
    before the first PCM chunk of a stream."""
    hdr = b"RIFF" + struct.pack("<I", 0xFFFFFFFF) + b"WAVE"
    hdr += b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, sampling_rate, sampling_rate * 2, 2, 16)
    hdr += b"data" + struct.pack("<I", 0xFFFFFFFF)
    return hdr


# plain kernels at the head of a profile window on the card: a torch.profiler
# trace on the H100 has dropped the records of its first few kernels
# (ROADMAP.md queue C item 8), and these carry no name the port's count
TRACE_PRIMER_KERNELS = 256


def profile_window(seconds: float, trace_path: str, cuda: bool, wait=None,
                   opened: Optional[threading.Event] = None) -> Dict:
    """One ``torch.profiler`` window of ``seconds`` over this process (CUDA
    activity when ``cuda``; ``wait(seconds)`` is the window, ``time.sleep``
    by default, and a stop-aware wait may end it early), its chrome trace written to ``trace_path``. Returns the window's
    summary: the trace path, the device kernels by name with their calls
    (``kernels``), and the launches the hand-written kernels' wrappers
    counted over the window (``launches``, parallel/registry.py's names),
    so that a trace is held to the credits of the process that ran it.
    ``opened`` is set once the window counts (the profiler started, the
    primer done, the first launch count read) and cleared when it ends."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from speakingstyle_torch.parallel.registry import read_launches

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    prof = profile(activities=activities)
    prof.start()
    try:
        if cuda:
            x = torch.zeros(1, dtype=torch.float64, device="cuda")
            for _ in range(TRACE_PRIMER_KERNELS):
                x.add_(1.0)
            torch.cuda.synchronize()
        before = read_launches()
        if opened is not None:
            opened.set()
        (wait or time.sleep)(seconds)
        after = read_launches()
    finally:
        if opened is not None:
            opened.clear()
        prof.stop()
    kernels: Dict[str, int] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
            kernels[e.name] = kernels.get(e.name, 0) + 1
    prof.export_chrome_trace(trace_path)
    return {"trace": trace_path, "seconds": seconds, "kernels": kernels,
            "launches": {k: v - before[k] for k, v in after.items() if v != before[k]},
            "primer_kernels": TRACE_PRIMER_KERNELS if cuda else 0}


def _error_status(e: BaseException):
    """(status, headers) of a synthesize failure, or None for an error the
    handler does not map (it propagates)."""
    if isinstance(e, RequestTooLarge):
        return 413, None
    if isinstance(e, ValueError):
        return 400, None
    if isinstance(e, Overloaded):
        return 429, {"Retry-After": str(max(1, int(e.retry_after_s)))}
    if isinstance(e, (ShutdownError, ReplicaError)):
        return 503, None
    if isinstance(e, (DeadlineExceeded, TimeoutError, concurrent.futures.TimeoutError)):
        return 504, None
    if isinstance(e, DispatchError):
        return 500, None
    return None


class _HTTPServer(ThreadingHTTPServer):
    """A thread per connection, none of which holds the process open. The
    listen backlog is the admission queue's scale, not socketserver's 5: a
    burst of concurrent clients past 5 otherwise finds its connections
    reset before the batcher could shed them with a 429."""

    daemon_threads = True
    request_queue_size = 1024


class SynthesisServer:
    """A dispatch backend served over HTTP: one engine behind the
    continuous batcher (``engine``), or a ``FleetRouter`` (``router``;
    ``engine`` may be None, the router's warm-up threads build the
    replicas). Both expose ``submit(request) -> Future`` and ``close()``.

    ``host`` / ``port`` default to ``serve.host`` / ``serve.port`` (bind
    port 0 for a free one and read ``address``). ``model_info``
    ({"version", "step", "weights_digest"}) is the single engine's
    /healthz model block and ``X-Model-Version`` header (a router publishes
    its own, ``set_model_version``); ``lifecycle`` a ``RolloutManager``
    that arms ``POST /admin/rollout``; ``slo`` an ``obs.slo.SloEngine``
    whose status is the /healthz ``slo`` block; ``probes`` a
    ``GoldenProber`` whose status is the /healthz ``quality.probes`` block.
    ``router`` may be a ``TierRouter`` (serving/tiers.py). With a frontend
    the server builds the ``LongformService`` over its backend (the
    chunked tier; a ring tier is attached to it by the caller)."""

    def __init__(self, engine: Optional[SynthesisEngine] = None,
                 frontend: Optional[TextFrontend] = None, host: Optional[str] = None,
                 port: Optional[int] = None, events: Optional[JsonlEventLog] = None,
                 profile_dir: Optional[str] = None, router=None, lifecycle=None,
                 model_info: Optional[Dict] = None, slo=None, probes=None):
        if engine is None and router is None:
            raise ValueError("SynthesisServer needs an engine or a router")
        self.engine = engine
        self.router = router
        self.lifecycle = lifecycle
        self.cfg = router.cfg if router is not None else engine.cfg
        serve = self.cfg.serve
        self.slo = slo
        self.probes = probes
        self._model_info = model_info
        self.frontend = frontend
        self.registry = router.registry if router is not None else engine.registry
        # one style service for the whole deployment: the router's shared
        # one in fleet mode, the engine's otherwise
        self.style = router.style if router is not None else engine.style
        if frontend is not None and frontend.style is None:
            frontend.style = self.style
        self.events = events
        # the HTTP boundary's gate: turns a failed verdict into a 500 with
        # X-Audio-Quality instead of shipping the bytes
        self.quality_gate = QualityGate(serve.quality, self.cfg.preprocess.preprocessing.audio
                                        .sampling_rate, registry=self.registry, events=events)
        if router is not None:
            self.batcher = None
            self.backend = router
        else:
            self.batcher = ContinuousBatcher(engine, events=events)
            self.backend = self.batcher
        # chapters (POST /synthesize/longform): the chunked tier needs only
        # the frontend and the backend, so it is built whenever a frontend is
        self.longform = (LongformService(self.cfg, frontend, self.backend, engine=engine,
                                         fault_plan=getattr(engine if engine is not None
                                                            else router, "fault_plan", None),
                                         registry=self.registry, events=events,
                                         quality=self.quality_gate)
                         if frontend is not None else None)
        self.frontend_pool = (FrontendPool(frontend, serve.frontend_workers,
                                           registry=self.registry, events=events)
                              if frontend is not None and serve.frontend_workers > 0 else None)
        self.started = time.monotonic()
        self.profile_dir = profile_dir or os.path.join(self.cfg.train.path.log_path,
                                                       "serve_profile")
        self._streams_cond = make_lock("SynthesisServer._streams_cond", kind="condition")
        self._active_streams = 0
        self._streams_gauge = self.registry.gauge(
            "serve_active_streams", help="chunked streams currently emitting")
        self._ttfa_hist = self.registry.histogram(
            "serve_ttfa_seconds", help="request arrival -> first streamed wav chunk ready")
        self._stream_overlap: Optional[int] = None
        self._shutdown_lock = make_lock("SynthesisServer._shutdown_lock")
        self._shut_down = False
        self._serving = False  # serve_forever ran (once _shut_down is set, it never will)
        self._shutdown_done = threading.Event()
        self._profile_lock = make_lock("SynthesisServer._profile_lock")
        # set while a capture's window counts (``profile_window``)
        self.profile_window_open = threading.Event()
        # the request-id sequence is the request counter
        self._requests = self.registry.counter(
            "serve_http_requests_total", help="synthesize requests admitted")
        self._http_errors = self.registry.counter(
            "serve_http_errors_total", help="synthesize requests failed")
        self.build = build_info()
        self._rss_gauge = self.registry.gauge(
            "process_rss_bytes", help="resident set size of this process")
        self._uptime_gauge = self.registry.gauge(
            "process_uptime_seconds", help="seconds since server start")
        self.httpd = _HTTPServer(
            (host if host is not None else serve.host, port if port is not None else serve.port),
            _handler(self))

    # -- request path (also called directly by tests) ------------------------

    def next_req_id(self) -> str:
        return f"req{int(self._requests.inc()):08d}"

    def too_large_body(self) -> Dict:
        """The 413 payload: the lattice's admissible ceiling per axis, and
        the endpoint that takes chapters."""
        serve = self.cfg.serve
        return {"max_src": serve.src_buckets[-1], "max_mel": serve.mel_buckets[-1],
                "max_phonemes": min(serve.src_buckets[-1],
                                    serve.mel_buckets[-1] // serve.frames_per_phoneme),
                "longform": "/synthesize/longform"}

    def _result_timeout(self, request) -> float:
        """How long a handler waits on its future: ``REQUEST_TIMEOUT_S``,
        and behind a router no longer than the request's class budget (or
        its ``deadline_ms`` override) plus ``fleet.deadline_grace_ms``, so
        the router's own DeadlineExceeded arrives first."""
        if self.router is None:
            return REQUEST_TIMEOUT_S
        fleet = self.cfg.serve.fleet
        klass = request.priority or fleet.default_class
        override = getattr(request, "deadline_ms", None)
        if override is not None:
            budget_ms = min(float(override), fleet.max_deadline_ms)
        else:
            budget_ms = fleet.class_deadline_ms.get(klass)
        if budget_ms is None:
            return REQUEST_TIMEOUT_S
        deadline = request.arrival + (budget_ms + fleet.deadline_grace_ms) / 1e3
        return max(0.001, min(REQUEST_TIMEOUT_S, deadline - time.monotonic()))

    def synthesize(self, payload: Dict, req_id: Optional[str] = None, stream: bool = False,
                   trace_id: Optional[str] = None):
        """One request through the frontend and the backend; returns its
        SynthesisResult. The ``serve_request`` span is the trace's root."""
        if req_id is None:
            req_id = self.next_req_id()
        with Span("serve_request", trace_id=trace_id or req_id, req_id=req_id,
                  stream=bool(stream)) as sp:
            if self.frontend_pool is not None:
                # submit the handle first: a shed or shutdown wastes no G2P
                pending = self.frontend_pool.prepare(req_id, payload, stream=stream)
                pending.trace = sp.ctx
                future = self.backend.submit(pending)
                self.frontend_pool.dispatch(pending)
                return future.result(timeout=self._result_timeout(pending))
            request = self.frontend.request(req_id, payload)
            request.stream = stream
            request.trace = sp.ctx
            future = self.backend.submit(request)
            return future.result(timeout=self._result_timeout(request))

    # -- streaming ------------------------------------------------------------

    def streaming_available(self) -> bool:
        """Streams need a vocoder (a --griffin_lim deployment has none)."""
        if self.router is not None:
            engines = self.router.engines()
            return not engines or engines[0].vocoder is not None
        return self.engine.vocoder is not None

    @contextlib.contextmanager
    def stream_scope(self):
        """Counts an in-flight chunked stream, so shutdown can drain it."""
        with self._streams_cond:
            self._active_streams += 1
            self._streams_gauge.set(self._active_streams)
        try:
            yield
        finally:
            with self._streams_cond:
                self._active_streams -= 1
                self._streams_gauge.set(self._active_streams)
                self._streams_cond.notify_all()

    def stream_chunks(self, result, arrival: Optional[float] = None):
        """int16 wav chunks of a dispatched result, window by window over
        the prepared vocoder lattice; observes serve_ttfa_seconds at the
        first. Behind a router the replica that produced the result vocodes
        it (``router.stream``)."""
        if self.router is not None:
            yield from self.router.stream(result, arrival=arrival)
            return
        fleet = self.cfg.serve.fleet
        if self.engine.vocoder is None:
            raise ValueError("streaming requires a vocoder engine")
        if self._stream_overlap is None:
            self._stream_overlap = streaming.resolve_overlap(fleet.stream_overlap,
                                                             self.engine.vocoder)
        first = True
        for chunk in streaming.stream_wav(self.engine, result, fleet.stream_window,
                                          self._stream_overlap, depth=fleet.stream_depth):
            if first and arrival is not None:
                self._ttfa_hist.observe(time.monotonic() - arrival)
            first = False
            yield chunk

    # -- readiness and introspection -------------------------------------------

    def is_ready(self) -> bool:
        """The /healthz predicate: the engine's lattice is prepared, or one
        replica of the router is ready."""
        if self.router is not None:
            return self.router.ready()
        return self.engine.is_ready

    def _health(self):
        """(``is_ready()``, the router's replica states or None) of one
        instant: a replica may change state between the two reads, so they
        are read until the states on either side of the predicate agree
        (each router's predicate is a function of its states), at most
        ``HEALTH_READS`` times, so the /healthz status contradicts its
        replica block only while the states keep changing."""
        if self.router is None:
            return self.is_ready(), None
        states = self.router.states()
        for _ in range(HEALTH_READS):
            ready = self.router.ready()
            after = self.router.states()
            if after == states:
                break
            states = after
        # past HEALTH_READS flapping reads: the last pair, which may disagree
        return ready, states

    def programs(self):
        """The program cards of every live engine (replicas in index
        order; a replica process keeps its own), then the shared style
        encoder's once."""
        engines = self.router.engines() if self.router is not None else [self.engine]
        out = [row for engine in engines if hasattr(engine, "programs")
               for row in engine.programs()]
        if self.style is not None:
            out.extend(self.style.programs())
        return out

    def request_done(self, req_id: str, path: str, status: int, t0: float,
                     trace_id: Optional[str] = None, served_by: Optional[str] = None) -> None:
        dur = time.monotonic() - t0
        if status >= 400:
            self._http_errors.inc()
        self.registry.histogram(
            "serve_http_request_seconds", labels={"status": str(status)},
            help="HTTP handler wall time (parse + G2P + batcher wait)").observe(dur)
        if self.events is not None:
            fields = dict(req_id=req_id, path=path, status=status, duration_s=dur)
            if served_by:
                # cluster mode: the replica process joins the req_id trail
                fields["served_by"] = served_by
            if trace_id:
                fields["trace_id"] = trace_id
            self.events.emit("http_request", **fields)

    def model_info(self) -> Optional[Dict]:
        """{version, step, weights_digest} of the serving model: the
        router's published identity (rollouts move it), else the one the
        server was started with."""
        if self.router is not None and self.router.model_version is not None:
            return {"version": self.router.model_version, "step": self.router.model_step,
                    "weights_digest": self.router.model_digest}
        return self._model_info

    def model_version(self) -> Optional[str]:
        info = self.model_info()
        return info.get("version") if info else None

    def model_tier(self, result=None, klass: Optional[str] = None) -> Optional[str]:
        """The ``X-Model-Tier`` header: the result's tier; else behind a
        tier router the tier of ``klass`` (the default class when None);
        else ``teacher-<precision>`` of the lattice's leading precision;
        None for an f32-only lattice (nothing to tell apart)."""
        tier = getattr(result, "tier", None) if result is not None else None
        if tier:
            return tier
        if self.router is not None and hasattr(self.router, "tier_for"):
            return self.router.tier_for(klass)
        lattice = self.router.lattice if self.router is not None else self.engine.lattice
        precisions = tuple(lattice.precisions)
        return None if precisions == ("f32",) else f"teacher-{precisions[0]}"

    def trace_view(self, trace_id: str) -> Dict:
        """GET /debug/trace/<id>: the ring's spans of one trace, joined in
        cluster mode with every live replica process's (best effort),
        assembled into a tree with its critical path."""
        ring = get_span_ring()
        spans = {s["span_id"]: s for s in ring.spans(trace_id) if s.get("span_id")}
        if self.router is not None and hasattr(self.router, "fetch_remote_spans"):
            for s in self.router.fetch_remote_spans(trace_id):
                spans.setdefault(s.get("span_id"), s)
        return assemble_trace(list(spans.values()), trace_id)

    def federated_text(self) -> str:
        """The ``fleet_*`` Prometheus section (cluster mode): the router's
        federation cache merged into one registry; "" otherwise. A bad
        scrape never breaks /metrics: it is counted and left out."""
        if self.router is None or not hasattr(self.router, "federated_registry"):
            return ""
        try:
            return self.router.federated_registry().prometheus_text()
        except Exception as e:
            self.registry.counter(
                "serve_federation_render_errors_total", labels={"error": type(e).__name__},
                help="federated /metrics sections dropped by error type").inc()
            return ""

    def profile_fanout(self, seconds: float) -> Optional[Dict]:
        """Start a ``torch.profiler`` capture in every live replica process
        (cluster mode); None without processes to fan out to."""
        if self.router is None or not hasattr(self.router, "profile_fanout"):
            return None
        return self.router.profile_fanout(seconds)

    def refresh_process_gauges(self) -> None:
        rss = process_rss_bytes()
        if rss is not None:
            self._rss_gauge.set(rss)
        self._uptime_gauge.set(time.monotonic() - self.started)

    def stats(self) -> Dict:
        """The /healthz payload: a view of ``registry.snapshot()``, and
        behind a router each replica's lifecycle state."""
        if self.batcher is not None:
            self.batcher.refresh_gauges()
        self.refresh_process_gauges()
        snap = self.registry.snapshot()
        counters, gauges = snap["counters"], snap["gauges"]
        occupancy = {}
        for key, count in counters.items():
            if key.startswith("serve_batch_occupancy_total{"):
                occupancy[key.split('rows="', 1)[1].split('"', 1)[0]] = int(count)

        def c(name):
            return int(counters.get(name, 0))

        ready, states = self._health()
        out = {
            "ready": ready,
            "uptime_s": round(time.monotonic() - self.started, 1),
            "build": self.build,
            "lattice_points": len(self.router.lattice if self.router is not None
                                  else self.engine.lattice),
            "compile_count": c("serve_compiles_total"),
            "dispatches": c("serve_dispatches_total"),
            "queue_depth": int(gauges.get("serve_queue_depth", 0)),
            "batch_occupancy": dict(sorted(occupancy.items())),
            "requests": c("serve_http_requests_total"),
            "errors": c("serve_http_errors_total"),
            "shed": c("serve_shed_total"),
            "rejected": c("serve_rejected_total"),
            "active_streams": int(gauges.get("serve_active_streams", 0)),
            "style": {
                "entries": int(gauges.get("serve_style_cache_entries", 0)),
                "hits": c("serve_style_cache_hits_total"),
                "misses": c("serve_style_cache_misses_total"),
                "evictions": c("serve_style_cache_evictions_total"),
                "compiles": c("serve_style_compiles_total"),
                "encodes": c("serve_style_dispatches_total"),
            },
        }
        if self.router is not None:
            out["replicas"] = {str(i): s for i, s in sorted(states.items())}
            if hasattr(self.router, "cluster_stats"):
                # the control plane's view; ready above is quorum-gated
                out["cluster"] = {"quorum": self.router.ccfg.quorum,
                                  "control_addr": self.router.control_addr,
                                  "replicas": self.router.cluster_stats()}
        model = self.model_info()
        if model:
            out["model"] = dict(model)
            tier = self.model_tier()
            if tier is not None:
                out["model"]["tier"] = tier
        if self.router is not None and hasattr(self.router, "routing_table"):
            # the effective class -> tier map and each tier's gate verdict
            out["tiers"] = {
                "default": self.router.default_tier,
                "routing": self.router.routing_table(),
                "gates": {name: (g.as_dict() if (g := self.router.gate_result(name)) is not None
                                 else {"shipped": True, "detail": "ungated anchor"})
                          for name in self.router.tiers()},
            }
        if self.slo is not None:
            out["slo"] = self.slo.status()
        quality: Dict = {"validators": dict(self.quality_gate.status())}
        last = quality_last_fail()
        if last is not None:
            quality["last_fail"] = last
        if self.probes is not None:
            quality["probes"] = self.probes.status()
        if self.slo is not None:
            quality["slo"] = self.slo.quality_status()
        out["quality"] = quality
        return out

    def capture_profile(self, seconds: float):
        """A ``torch.profiler`` window over the live process
        (``profile_window``), one at a time; the chrome trace lands in a
        numbered directory under ``profile_dir``, and the answer carries
        the window's kernels by name and the wrappers' launches. The
        profiler is stopped whatever happens."""
        if not self._profile_lock.acquire(blocking=False):
            return False, {"error": "a profile capture is already running"}
        try:
            seq = int(self.registry.counter(
                "serve_profile_captures_total", help="on-demand torch.profiler captures").inc())
            trace_dir = os.path.join(self.profile_dir, f"capture_{seq:04d}")
            os.makedirs(trace_dir, exist_ok=True)
            engines = self.router.engines() if self.router is not None else [self.engine]
            devices = [getattr(e, "device", None) for e in engines]
            if self.style is not None:
                devices.append(self.style.device)  # a cluster router's own device work
            cuda = any(d is not None and d.type == "cuda" for d in devices)
            # the wait is the capture window; a second capture is refused
            # without waiting on the lock
            summary = profile_window(seconds, os.path.join(trace_dir, "trace.json"), cuda,
                                     opened=self.profile_window_open)
        finally:
            self._profile_lock.release()
        if self.events is not None:
            self.events.emit("profile_capture", trace_dir=trace_dir, seconds=seconds)
        return True, dict(summary, trace_dir=trace_dir)

    @property
    def address(self):
        return self.httpd.server_address

    def serve_forever(self):
        with self._shutdown_lock:
            if self._shut_down:
                return
            self._serving = True
        self.httpd.serve_forever()

    def drain_streams(self, timeout: Optional[float] = None) -> bool:
        """Block until every in-flight stream finished (True) or the drain
        timeout (``serve.fleet.drain_timeout_s``) passed (False)."""
        if timeout is None:
            timeout = self.cfg.serve.fleet.drain_timeout_s
        deadline = time.monotonic() + timeout
        with self._streams_cond:
            while self._active_streams > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._streams_cond.wait(timeout=remaining)
        return True

    def shutdown(self):
        """Idempotent: stop accepting, drain in-flight streams, then close
        the backend (which flushes admitted requests) and the frontend
        pool. A second caller waits for the first to finish. A request
        that reaches a handler after this gets 503."""
        with self._shutdown_lock:
            first = not self._shut_down
            self._shut_down = True
        if not first:
            self._shutdown_done.wait()
            return
        try:
            self._shutdown()
        finally:
            self._shutdown_done.set()

    def _shutdown(self):
        # socketserver's shutdown() waits for serve_forever's loop to end,
        # so it would wait for ever on a server that never served (a start
        # that failed after the socket was bound); such a server only closes
        if self._serving:
            self.httpd.shutdown()
        self.httpd.server_close()
        if not self.drain_streams() and self.events is not None:
            self.events.emit("shutdown_drain_timeout",
                             active_streams=int(self._streams_gauge.value))
        # the backend first: its flush may still resolve pending handles
        self.backend.close()
        if self.frontend_pool is not None:
            self.frontend_pool.close()


def _handler(outer: SynthesisServer):
    class Handler(BaseHTTPRequestHandler):
        # chunked transfer needs HTTP/1.1; every other response sets
        # Content-Length, so persistent connections stay correct
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):
            pass

        def _json(self, code: int, obj: Dict, req_id: Optional[str] = None,
                  headers: Optional[Dict[str, str]] = None, trace_id: Optional[str] = None):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            if req_id is not None:
                self.send_header("X-Request-Id", req_id)
            if trace_id is not None:
                self.send_header("X-Trace-Id", trace_id)
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _text(self, code: int, text: str, content_type: str):
            body = text.encode()
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _body(self) -> bytes:
            n = int(self.headers.get("Content-Length", 0))
            return self.rfile.read(n) if n else b""

        def do_GET(self):
            path = self.path.split("?")[0]
            if path == "/healthz":
                body = outer.stats()
                return self._json(200 if body["ready"] else 503, body)
            if path == "/metrics":
                if outer.batcher is not None:
                    outer.batcher.refresh_gauges()
                outer.refresh_process_gauges()
                # cluster mode appends the fleet_* federation (merged
                # buckets, never averaged percentiles)
                return self._text(200, outer.registry.prometheus_text() + outer.federated_text(),
                                  "text/plain; version=0.0.4; charset=utf-8")
            if path == "/debug/programs":
                return self._json(200, {"programs": outer.programs(), "build": outer.build})
            if path == "/debug/spans":
                ring = get_span_ring()
                return self._json(200, {
                    "spans": ring.spans(),
                    "kept": {tid: ring.spans(tid) for tid in ring.kept_trace_ids()},
                    "stats": ring.stats()})
            if path.startswith("/debug/trace/"):
                tid = path[len("/debug/trace/"):]
                if not tid:
                    return self._json(400, {"error": "GET /debug/trace/<trace_id>"})
                return self._json(200, outer.trace_view(tid))
            if path == "/styles":
                if outer.style is None:
                    return self._json(400, {
                        "error": "no style service (the model has no reference encoder)"})
                return self._json(200, {"styles": outer.style.styles(),
                                        "capacity": outer.cfg.serve.style.cache_capacity})
            return self._json(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            parsed = urlparse(self.path)
            if parsed.path == "/debug/profile":
                return self._profile(parsed)
            if parsed.path == "/admin/rollout":
                return self._rollout()
            if parsed.path == "/styles":
                return self._post_style(parsed)
            if parsed.path == "/synthesize/longform":
                return self._synthesize_longform(parsed)
            if parsed.path == "/synthesize/stream":
                return self._synthesize(parsed, stream=True)
            if parsed.path == "/synthesize":
                return self._synthesize(parsed, stream=False)
            return self._json(404, {"error": f"no route {self.path}"})

        def _rollout(self):
            """POST /admin/rollout {"step": N}: the RolloutManager runs the
            whole state machine; this maps the request and the outcome (409
            while another runs; committed and aborted are both 200s)."""
            from speakingstyle_torch.serving.lifecycle import RolloutInProgress

            if outer.lifecycle is None:
                self._body()
                return self._json(404, {
                    "error": "rollout is not enabled on this server (start with "
                             "--enable_rollout and a fleet)"})
            try:
                payload = json.loads(self._body() or b"{}")
            except ValueError:
                return self._json(400, {"error": "body must be JSON"})
            step = payload.get("step") if isinstance(payload, dict) else None
            if not isinstance(step, int) or isinstance(step, bool):
                return self._json(400, {
                    "error": 'rollout needs an integer "step" (the checkpoint to roll to)'})
            try:
                result = outer.lifecycle.rollout(step)
            except RolloutInProgress as e:
                return self._json(409, {"error": str(e)})
            return self._json(200, result)

        def _post_style(self, parsed):
            """Register a reference style: wav bytes (audio/wav) or JSON
            {"ref_audio": <confined path>}. The style_id is the sha256 of
            the bytes, so a repeat upload does no encoder work."""
            if outer.style is None:
                return self._json(400, {
                    "error": "no style service (the model has no reference encoder)"})
            try:
                body = self._body()
                ctype = (self.headers.get("Content-Type") or "").lower()
                speaker = parse_qs(parsed.query).get("speaker", [None])[0]
                if ctype.startswith("application/json"):
                    payload = json.loads(body or b"{}")
                    speaker = payload.get("speaker", speaker)
                    ref = payload.get("ref_audio")
                    if not ref:
                        raise ValueError(
                            'JSON style registration needs "ref_audio" (a serve.style.ref_dir '
                            "path); raw wav uploads go in an audio/wav body")
                    ref_cfg = outer.frontend.cfg if outer.frontend is not None else outer.cfg
                    with open(confined_ref_path(ref_cfg, str(ref)), "rb") as f:
                        body = f.read()
                elif not body:
                    raise ValueError('empty body: POST the reference wav bytes (audio/wav) or '
                                     'JSON {"ref_audio": ...}')
                if speaker is not None and outer.frontend is not None:
                    outer.frontend.speaker(speaker)  # the registry check
                key = outer.style.digest_bytes(body)
                entry = outer.style.get(key)
                cached = entry is not None
                if entry is None:
                    entry = outer.style.encode_wav_bytes(body, speaker=speaker)
            except ValueError as e:
                return self._json(400, {"error": str(e)})
            return self._json(200, dict(entry.as_dict(), cached=cached))

        def _fail(self, req_id, parsed, t0, trace_id, status, err, headers=None, extra=None,
                  served_by=None):
            outer.request_done(req_id, parsed.path, status, t0, trace_id=trace_id,
                               served_by=served_by)
            body = {"error": err, "id": req_id}
            body.update(extra or {})
            return self._json(status, body, req_id=req_id, headers=headers, trace_id=trace_id)

        def _model_headers(self, result) -> Dict[str, str]:
            hdr = {}
            if result.style_degraded:
                hdr["X-Style-Degraded"] = "1"
            version = outer.model_version()
            if version is not None:
                hdr["X-Model-Version"] = version
            tier = outer.model_tier(result)
            if tier is not None:
                hdr["X-Model-Tier"] = tier
            # cluster mode: the replica process that served it
            if getattr(result, "served_by", None):
                hdr["X-Served-By"] = result.served_by
            return hdr

        def _synthesize(self, parsed, stream: bool):
            # the req_id rides frontend -> batcher -> engine as the request's
            # id; the trace joins on it unless a proxy forwarded its own
            req_id = outer.next_req_id()
            trace_id = self.headers.get("X-Trace-Id") or req_id
            t0 = time.monotonic()
            try:
                payload = json.loads(self._body() or b"{}")
                if not isinstance(payload, dict):
                    raise ValueError("payload must be a JSON object")
                if stream and not outer.streaming_available():
                    raise ValueError("streaming requires a vocoder engine (--griffin_lim serves "
                                     "mel JSON only)")
                result = outer.synthesize(payload, req_id=req_id, stream=stream,
                                          trace_id=trace_id)
            except Exception as e:
                mapped = _error_status(e)
                if mapped is None:
                    raise
                status, headers = mapped
                extra = outer.too_large_body() if status == 413 else None
                return self._fail(req_id, parsed, t0, trace_id, status, str(e) or
                                  "synthesis timed out", headers, extra)
            if stream:
                return self._stream_response(result, req_id, parsed, t0, trace_id)
            hdr = self._model_headers(result)
            served_by = result.served_by
            if result.wav is None:  # a vocoder-less engine: the mel as JSON
                outer.request_done(req_id, parsed.path, 200, t0, trace_id=trace_id,
                                   served_by=served_by)
                return self._json(200, {"id": result.id, "mel_len": result.mel_len,
                                        "mel": result.mel.tolist()},
                                  req_id=req_id, headers=hdr or None, trace_id=trace_id)
            verdict = outer.quality_gate.check_result(result)
            if verdict is not None and not verdict.ok:
                reasons = ",".join(verdict.reasons)
                return self._fail(req_id, parsed, t0, trace_id, 500, "audio quality check failed",
                                  {"X-Audio-Quality": f"fail:{reasons}"},
                                  {"reasons": list(verdict.reasons)}, served_by=served_by)
            body = wav_bytes(result.wav, outer.cfg.preprocess.preprocessing.audio.sampling_rate)
            outer.request_done(req_id, parsed.path, 200, t0, trace_id=trace_id,
                               served_by=served_by)
            self.send_response(200)
            self.send_header("Content-Type", "audio/wav")
            self.send_header("Content-Length", str(len(body)))
            self.send_header("X-Request-Id", result.id)
            self.send_header("X-Trace-Id", trace_id)
            self.send_header("X-Batch-Rows", str(result.batch_rows))
            for k, v in hdr.items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _stream_response(self, result, req_id, parsed, t0, trace_id):
            """Chunked audio/wav. The first window is pulled and checked
            before any header goes out, so a stream whose first chunk fails
            is a clean JSON 500."""
            sr = outer.cfg.preprocess.preprocessing.audio.sampling_rate
            chunks = outer.stream_chunks(result, arrival=t0)
            try:
                first = next(chunks, None)
            except Exception as e:
                return self._fail(req_id, parsed, t0, trace_id, 500, str(e))
            if first is not None:
                # record=False: vocode_collect already accounted this window
                verdict = outer.quality_gate.check(first, klass=result.priority,
                                                   source="server", record=False)
                if not verdict.ok:
                    reasons = ",".join(verdict.reasons)
                    chunks.close()
                    return self._fail(req_id, parsed, t0, trace_id, 500,
                                      "audio quality check failed",
                                      {"X-Audio-Quality": f"fail:{reasons}"},
                                      {"reasons": list(verdict.reasons)})

            def write_chunk(data: bytes):
                self.wfile.write(b"%X\r\n" % len(data))
                self.wfile.write(data)
                self.wfile.write(b"\r\n")

            self.send_response(200)
            self.send_header("Content-Type", "audio/wav")
            self.send_header("Transfer-Encoding", "chunked")
            self.send_header("X-Request-Id", result.id)
            self.send_header("X-Trace-Id", trace_id)
            self.send_header("X-Batch-Rows", str(result.batch_rows))
            for k, v in self._model_headers(result).items():
                self.send_header(k, v)
            self.end_headers()
            try:
                with outer.stream_scope():
                    write_chunk(wav_stream_header(sr))
                    if first is not None:
                        write_chunk(first.tobytes())
                    for wav in chunks:
                        write_chunk(wav.tobytes())
                self.wfile.write(b"0\r\n\r\n")
            except (BrokenPipeError, ConnectionResetError):
                # the client hung up mid-stream: stop vocoding for it
                self.close_connection = True
                outer.request_done(req_id, parsed.path, 499, t0, trace_id=trace_id)
                return
            except Exception as e:
                # the headers are gone: a truncated chunked body (no
                # terminal chunk) is the only honest signal
                self.close_connection = True
                outer.request_done(req_id, parsed.path, 500, t0, trace_id=trace_id)
                if outer.events is not None:
                    outer.events.emit("stream_abort", req_id=req_id, error=type(e).__name__)
                return
            finally:
                chunks.close()
            outer.request_done(req_id, parsed.path, 200, t0, trace_id=trace_id)

        def _synthesize_longform(self, parsed):
            """POST /synthesize/longform: a chapter in, one chunked audio/wav
            out. The first stitched piece is pulled before any header goes
            out, so an admission error or a failed first chunk is a clean
            JSON error."""
            req_id = outer.next_req_id()
            trace_id = self.headers.get("X-Trace-Id") or req_id
            t0 = time.monotonic()
            try:
                payload = json.loads(self._body() or b"{}")
                if not isinstance(payload, dict):
                    raise ValueError("payload must be a JSON object")
                if outer.longform is None:
                    raise ValueError("long-form synthesis needs a text frontend")
                if not outer.streaming_available():
                    raise ValueError("long-form synthesis requires a vocoder engine "
                                     "(--griffin_lim serves mel JSON only)")
                plan = outer.longform.admit(req_id, payload)
                pieces = outer.longform.stream(plan)
                first = next(pieces, None)
            except Exception as e:
                mapped = _error_status(e)
                if mapped is None:
                    raise
                status, headers = mapped
                extra = None
                if status == 413:  # past even the chapter admission cap
                    extra = dict(outer.too_large_body(),
                                 max_chunks=outer.cfg.serve.longform.max_chunks)
                return self._fail(req_id, parsed, t0, trace_id, status,
                                  str(e) or "long-form synthesis timed out", headers, extra)
            if first is not None:
                # record=False: the stitcher's check already counted it
                verdict = outer.quality_gate.check(first, klass=outer.longform.klass,
                                                   source="server", record=False)
                if not verdict.ok:
                    reasons = ",".join(verdict.reasons)
                    pieces.close()
                    return self._fail(req_id, parsed, t0, trace_id, 500,
                                      "audio quality check failed",
                                      {"X-Audio-Quality": f"fail:{reasons}"},
                                      {"reasons": list(verdict.reasons)})
            sr = outer.cfg.preprocess.preprocessing.audio.sampling_rate

            def write_chunk(data: bytes):
                self.wfile.write(b"%X\r\n" % len(data))
                self.wfile.write(data)
                self.wfile.write(b"\r\n")

            self.send_response(200)
            self.send_header("Content-Type", "audio/wav")
            self.send_header("Transfer-Encoding", "chunked")
            self.send_header("X-Request-Id", req_id)
            self.send_header("X-Trace-Id", trace_id)
            self.send_header("X-Longform-Tier", plan.tier)
            self.send_header("X-Longform-Chunks", str(len(plan.chunks)))
            if plan.style_degraded:
                self.send_header("X-Style-Degraded", "1")
            version = outer.model_version()
            if version is not None:
                self.send_header("X-Model-Version", version)
            tier = outer.model_tier(klass=outer.longform.klass)
            if tier is not None:
                self.send_header("X-Model-Tier", tier)
            self.end_headers()
            try:
                with outer.stream_scope():
                    write_chunk(wav_stream_header(sr))
                    if first is not None:
                        write_chunk(first.tobytes())
                    for wav in pieces:
                        write_chunk(wav.tobytes())
                self.wfile.write(b"0\r\n\r\n")
            except (BrokenPipeError, ConnectionResetError):
                self.close_connection = True
                outer.request_done(req_id, parsed.path, 499, t0, trace_id=trace_id)
                return
            except Exception as e:
                # the headers are gone: a chunked body without its terminal
                # chunk is the only honest signal
                self.close_connection = True
                outer.request_done(req_id, parsed.path, 500, t0, trace_id=trace_id)
                if outer.events is not None:
                    outer.events.emit("stream_abort", req_id=req_id, error=type(e).__name__)
                return
            finally:
                pieces.close()
            outer.request_done(req_id, parsed.path, 200, t0, trace_id=trace_id)

        def _profile(self, parsed):
            if not outer.cfg.serve.debug_profile:
                return self._json(403, {"error": "serve.debug_profile is disabled"})
            raw = parse_qs(parsed.query).get("seconds", ["3"])[0]
            try:
                seconds = float(raw)
            except ValueError:
                return self._json(400, {"error": f"seconds={raw!r} is not a number"})
            if not 0 < seconds <= 60:
                return self._json(400, {"error": "seconds must be in (0, 60]"})
            # the fan-out first (the replicas capture off-thread), so their
            # windows overlap the local one
            fanout = outer.profile_fanout(seconds)
            ok, out = outer.capture_profile(seconds)
            if fanout is not None:
                out["replicas"] = fanout
            return self._json(200 if ok else 409, out)

    return Handler
