"""The cluster: replica *processes* behind the fleet router (JAX
counterpart: speakingstyle_tpu/serving/cluster.py).

The router's replica surface is ``precompile()`` + ``run(requests)``, so
everything the in-process fleet does (EDF admission, breakers, the hang
watchdog's claim handshake, requeue at the original deadline, rollouts, the
autoscaler) carries over to processes once that surface crosses HTTP:

  ``ClusterRouter``   a ``FleetRouter`` whose replicas are processes. It
        runs a control server (``POST /register``, ``POST /heartbeat``),
        grants heartbeat **leases** (a replica may miss
        ``cluster.lease_miss_budget`` beats before its lease expires) and
        sweeps expired leases into the fleet's ``_replica_failed``: the
        breaker opens, the in-flight batch is stolen under the router lock
        (as the hang watchdog steals) and requeued at its original
        deadline. ``scale_to()`` spawns and drains real processes through
        the caller's ``spawn`` callable; spawn-to-lease lands in
        ``serve_replica_warmup_seconds``, which the autoscaler reads.

  ``RemoteEngine``    the router-side proxy of one replica process.
        ``precompile()`` adopts a live orphan process (how a healed
        partition re-admits a warm replica through the breaker's half-open
        trial, capturing nothing again) or spawns one and waits for its
        lease. ``run()`` is a **hedged** wire dispatch: once the first leg
        has been out past the class's wire-latency quantile a second leg
        goes to another host with the same idempotency key; the first
        answer wins and the loser's connection is torn down
        (``serve_hedge_fired_total`` / ``serve_hedge_won_total``). Every
        wire call has an explicit timeout, the dispatch's from its class
        deadline.

  ``ReplicaServer``   the replica-process side: ``/dispatch`` (one engine
        run at a time, a bounded LRU idempotency cache so that a hedge or a
        retry of an executed batch answers from the cache, and an
        in-flight claim a duplicate leg parks on), ``/healthz``, ``/drain``,
        ``/metrics`` (``export_state``), ``/debug/spans``,
        ``/debug/profile`` (one ``torch.profiler`` capture at a time) and
        the heartbeat loop. ``cli/replica.py`` wraps it around a whole
        ``SynthesisEngine``; the tests wrap toy engines.

The wire is the JAX package's JSON field for field (base64 ndarrays), so a
request or result encoded by either package decodes in the other. The
port's request and result fields the JAX wire lacks are not sent:
``precision`` and ``quality_check`` (a replica dispatches at its engine's
default precision and always runs its quality gate), and ``wav_finite``,
``quality`` and ``tier`` (a decoded result keeps their defaults; the
router's HTTP gate judges the int16 wav it received). ROADMAP.md queue C
item 9 records this.

Exactly once across the wire: the router's claim handshake is the client's
guarantee (a stolen batch's late results are discarded); idempotency keys
add the wire's half (the same dispatch sent twice runs at most once a
host). Partition (the ``net_partition`` drill): the control server refuses
the replica's heartbeats and ``RemoteEngine.run`` fails fast; the process
stays up, and after ``heal`` its next beat learns the lease expired,
re-registers with a bumped epoch (an older epoch is refused, the fence
against a zombie writer) and the next breaker trial adopts it.

On one card each replica process owns a CUDA context, its weights and its
graphs: the processes share no ``DEVICE_GATE`` and the card time-slices
between their contexts. The spawn callable must start children with
``subprocess.Popen`` (fork and exec), never a ``multiprocessing`` fork of a
process that holds a CUDA context.
"""

import base64
import hashlib
import json
import os
import queue
import subprocess
import tempfile
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass
from http.client import HTTPConnection
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from speakingstyle_torch.faults import FaultPlan
from speakingstyle_torch.obs import JsonlEventLog, MetricsRegistry, make_lock
from speakingstyle_torch.obs import trace as obstrace
from speakingstyle_torch.obs.registry import merge_states
from speakingstyle_torch.obs.trace import Span, TraceContext, get_span_ring
from speakingstyle_torch.serving.engine import SynthesisRequest, SynthesisResult
from speakingstyle_torch.serving.fleet import READY, STOPPED, FleetRouter, Replica
from speakingstyle_torch.serving.lattice import Bucket
from speakingstyle_torch.serving.resilience import LeaseExpired, WireError
from speakingstyle_torch.serving.style import StyleVectors

__all__ = ["ClusterRouter", "Lease", "LeaseTable", "RemoteEngine", "ReplicaServer", "batch_key",
           "decode_request", "decode_result", "encode_request", "encode_result"]


# ---------------------------------------------------------------------------
# the wire: JSON with base64 ndarrays
# ---------------------------------------------------------------------------


def _enc_arr(a: Optional[np.ndarray]) -> Optional[Dict]:
    if a is None:
        return None
    a = np.ascontiguousarray(a)
    return {"dtype": str(a.dtype), "shape": list(a.shape),
            "b64": base64.b64encode(a.tobytes()).decode("ascii")}


def _dec_arr(d: Optional[Dict]) -> Optional[np.ndarray]:
    if d is None:
        return None
    raw = base64.b64decode(d["b64"])
    # a copy: frombuffer's view is read-only, and the pool's staging writes
    return np.frombuffer(raw, dtype=d["dtype"]).reshape(d["shape"]).copy()


def _enc_ctl(c) -> Dict:
    if np.isscalar(c):
        return {"scalar": float(c)}
    return {"array": _enc_arr(np.asarray(c, np.float32))}


def _dec_ctl(d: Dict):
    if "scalar" in d:
        return float(d["scalar"])
    return _dec_arr(d["array"])


def encode_request(r: SynthesisRequest) -> Dict:
    """One admitted request -> its JSON-ready wire form. ``arrival`` is not
    sent (monotonic stamps do not transfer between processes: the replica
    stamps its own on decode)."""
    style = None
    if r.style is not None:
        style = {"key": r.style.key, "gamma": _enc_arr(r.style.gamma),
                 "beta": _enc_arr(r.style.beta)}
    return {
        "id": r.id,
        "sequence": _enc_arr(np.asarray(r.sequence)),
        "ref_mel": _enc_arr(r.ref_mel),
        "style": style,
        "speaker": int(r.speaker),
        "raw_text": r.raw_text,
        "p_control": _enc_ctl(r.p_control),
        "e_control": _enc_ctl(r.e_control),
        "d_control": _enc_ctl(r.d_control),
        "stream": bool(r.stream),
        "style_degraded": bool(r.style_degraded),
        # one coalesced dispatch can carry several traces: each request
        # carries its own context
        "trace": r.trace.as_dict() if r.trace is not None else None,
    }


def decode_request(d: Dict) -> SynthesisRequest:
    style = None
    if d.get("style") is not None:
        s = d["style"]
        style = StyleVectors(key=s["key"], gamma=_dec_arr(s["gamma"]), beta=_dec_arr(s["beta"]))
    return SynthesisRequest(
        id=d["id"], sequence=_dec_arr(d["sequence"]), ref_mel=_dec_arr(d.get("ref_mel")),
        style=style, speaker=d.get("speaker", 0), raw_text=d.get("raw_text", ""),
        p_control=_dec_ctl(d["p_control"]), e_control=_dec_ctl(d["e_control"]),
        d_control=_dec_ctl(d["d_control"]), stream=d.get("stream", False),
        style_degraded=d.get("style_degraded", False),
        trace=TraceContext.from_dict(d.get("trace")))


def encode_result(r) -> Dict:
    """Duck-typed: toy engines return plain objects with some of the
    ``SynthesisResult`` fields."""
    bucket = getattr(r, "bucket", None)
    return {
        "id": r.id,
        "raw_text": getattr(r, "raw_text", ""),
        "mel": _enc_arr(getattr(r, "mel", None)),
        "mel_len": int(getattr(r, "mel_len", 0)),
        "wav": _enc_arr(getattr(r, "wav", None)),
        "durations": _enc_arr(getattr(r, "durations", None)),
        "pitch_prediction": _enc_arr(getattr(r, "pitch_prediction", None)),
        "energy_prediction": _enc_arr(getattr(r, "energy_prediction", None)),
        "src_len": int(getattr(r, "src_len", 0)),
        "bucket": [bucket.b, bucket.l_src, bucket.t_mel] if bucket is not None else None,
        "batch_rows": int(getattr(r, "batch_rows", 1)),
        "style_degraded": bool(getattr(r, "style_degraded", False)),
    }


_EMPTY = np.zeros((0,), np.float32)


def decode_result(d: Dict, served_by: Optional[str] = None) -> SynthesisResult:
    def arr(key):
        a = _dec_arr(d.get(key))
        return a if a is not None else _EMPTY

    b = d.get("bucket")
    return SynthesisResult(
        id=d["id"], raw_text=d.get("raw_text", ""), mel=arr("mel"), mel_len=d.get("mel_len", 0),
        wav=_dec_arr(d.get("wav")), durations=arr("durations"),
        pitch_prediction=arr("pitch_prediction"), energy_prediction=arr("energy_prediction"),
        src_len=d.get("src_len", 0), bucket=Bucket(*b) if b else None,
        batch_rows=d.get("batch_rows", 1), style_degraded=d.get("style_degraded", False),
        served_by=served_by)


def batch_key(requests: List[SynthesisRequest]) -> str:
    """The idempotency key of one coalesced wire dispatch: a hash of its
    request ids in order. Both hedge legs (and a retry) send it; a requeued
    batch regrouped by the router hashes differently, as it must."""
    h = hashlib.sha256()
    for r in requests:
        h.update(r.id.encode("utf-8", "replace"))
        h.update(b"\x00")
    return h.hexdigest()[:32]


# ---------------------------------------------------------------------------
# leases
# ---------------------------------------------------------------------------


@dataclass
class Lease:
    """One replica's liveness lease (stamps from ``time.monotonic``)."""

    replica_id: str
    host: str
    port: int
    epoch: int
    pid: int
    deadline: float          # expired strictly after this instant
    last_beat: float
    ready: bool
    registered_at: float


class LeaseTable:
    """Epoch-fenced heartbeat leases by replica id. A replica re-registers
    with a bumped epoch after it lost its lease, and a registration or beat
    with an epoch older than the table's is refused. Expiry is strict: a
    beat exactly at the deadline renews (``now <= deadline``), one tick
    later does not."""

    def __init__(self, ttl_s: float):
        self.ttl_s = float(ttl_s)
        self._lock = make_lock("LeaseTable._lock")
        self._leases: Dict[str, Lease] = {}

    def register(self, replica_id: str, host: str, port: int, epoch: int, pid: int,
                 now: float) -> Tuple[bool, int]:
        """Grant (or grant again) a lease: ``(accepted, epoch)``, a refusal
        carrying the table's epoch to register above."""
        with self._lock:
            cur = self._leases.get(replica_id)
            if cur is not None and epoch < cur.epoch:
                return False, cur.epoch
            self._leases[replica_id] = Lease(
                replica_id=replica_id, host=host, port=port, epoch=epoch, pid=pid,
                deadline=now + self.ttl_s, last_beat=now, ready=False, registered_at=now)
            return True, epoch

    def heartbeat(self, replica_id: str, epoch: int, ready: bool, now: float) -> str:
        """Renew one lease: ``renewed``, ``unknown`` (never registered or
        dropped), ``stale`` (an older epoch) or ``expired`` (the beat came
        after the deadline: re-register with a bumped epoch)."""
        with self._lock:
            lease = self._leases.get(replica_id)
            if lease is None:
                return "unknown"
            if epoch < lease.epoch:
                return "stale"
            if now > lease.deadline:
                return "expired"
            lease.epoch = epoch
            lease.deadline = now + self.ttl_s
            lease.last_beat = now
            lease.ready = bool(ready)
            return "renewed"

    def get(self, replica_id: str) -> Optional[Lease]:
        with self._lock:
            lease = self._leases.get(replica_id)
            return None if lease is None else Lease(**vars(lease))  # a snapshot

    def alive(self, replica_id: str, now: float) -> bool:
        with self._lock:
            lease = self._leases.get(replica_id)
            return lease is not None and now <= lease.deadline

    def drop(self, replica_id: str) -> None:
        with self._lock:
            self._leases.pop(replica_id, None)

    def snapshot(self, now: float) -> List[Dict]:
        """JSON-ready lease rows (the /healthz cluster block)."""
        with self._lock:
            return [{
                "replica_id": lease.replica_id,
                "host": f"{lease.host}:{lease.port}",
                "pid": lease.pid,
                "epoch": lease.epoch,
                "ready": lease.ready,
                "lease_age_s": round(now - lease.registered_at, 3),
                "last_heartbeat_s": round(now - lease.last_beat, 3),
                "expired": now > lease.deadline,
            } for lease in sorted(self._leases.values(), key=lambda l: l.replica_id)]


# ---------------------------------------------------------------------------
# HTTP plumbing of both sides
# ---------------------------------------------------------------------------


def _post_json(host: str, port: int, path: str, payload: Dict, timeout: float,
               headers: Optional[Dict[str, str]] = None) -> Tuple[int, Dict]:
    """One JSON round trip, bounded by ``timeout``."""
    conn = HTTPConnection(host, port, timeout=timeout)
    try:
        hdrs = {"Content-Type": "application/json"}
        hdrs.update(headers or {})
        conn.request("POST", path, body=json.dumps(payload).encode("utf-8"), headers=hdrs)
        resp = conn.getresponse()
        data = resp.read()
        try:
            parsed = json.loads(data) if data else {}
        except ValueError:
            parsed = {}
        return resp.status, parsed
    finally:
        conn.close()


def _get_json(host: str, port: int, path: str, timeout: float) -> Tuple[int, Dict]:
    conn = HTTPConnection(host, port, timeout=timeout)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        data = resp.read()
        try:
            parsed = json.loads(data) if data else {}
        except ValueError:
            parsed = {}
        return resp.status, parsed
    finally:
        conn.close()


class _JsonHandler(BaseHTTPRequestHandler):
    """Maps (method, path) to a callable ``(body, headers) -> (status,
    payload)``; the headers carry the ``X-Trace-*`` and ``X-Hedge-Leg``
    fields."""

    protocol_version = "HTTP/1.1"
    timeout = 30.0  # a wedged peer does not pin a handler thread forever

    def log_message(self, fmt, *args):
        pass

    def _read_body(self) -> Dict:
        length = int(self.headers.get("Content-Length", 0) or 0)
        raw = self.rfile.read(length) if length else b""
        try:
            return json.loads(raw) if raw else {}
        except ValueError:
            return {}

    def _reply(self, status: int, payload: Dict) -> None:
        body = json.dumps(payload).encode("utf-8")
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _route(self, method: str) -> None:
        handler = self.server.routes.get((method, self.path.split("?")[0]))
        if handler is None:
            self._reply(404, {"error": f"no route {method} {self.path}"})
            return
        try:
            body = self._read_body() if method == "POST" else {}
            status, payload = handler(body, self.headers)
        except BrokenPipeError:
            raise
        except Exception as e:  # a handler's fault answers 500, not a hang
            status, payload = 500, {"error": f"{type(e).__name__}: {e}"}
        self._reply(status, payload)

    def do_GET(self):
        self._route("GET")

    def do_POST(self):
        self._route("POST")


class _JsonServer(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True

    def __init__(self, addr, routes: Dict):
        self.routes = routes
        super().__init__(addr, _JsonHandler)


# ---------------------------------------------------------------------------
# the replica process's side
# ---------------------------------------------------------------------------


class ReplicaServer:
    """The serving half inside one replica process: the dispatch endpoint,
    the bounded idempotency cache and the heartbeat loop against the
    router's control server. The engine is duck-typed as the router's:
    ``precompile()`` + ``run(requests)``. ``engine.run`` runs one batch at
    a time (as a fleet worker runs its replica), outside the cache's
    lock."""

    def __init__(self, engine, replica_id: str, router: str, cluster_cfg,
                 registry: Optional[MetricsRegistry] = None,
                 events: Optional[JsonlEventLog] = None, host: str = "127.0.0.1", port: int = 0,
                 pid: int = 0):
        self.engine = engine
        self.replica_id = replica_id
        rhost, _, rport = router.rpartition(":")
        self.router_host = rhost
        self.router_port = int(rport)
        self.ccfg = cluster_cfg
        self.registry = registry if registry is not None else MetricsRegistry()
        self.events = events
        self.pid = pid
        self._epoch = 1
        self._draining = False
        self._stop = threading.Event()
        # guards the cache, the in-flight claims and the admitted count,
        # never engine.run
        self._dispatch_lock = make_lock("ReplicaServer._dispatch_lock", kind="condition")
        self._run_lock = make_lock("ReplicaServer._run_lock")
        self._active = 0  # dispatches admitted and not yet answered
        # key -> encoded answer, LRU (move to the end on a hit, evict the
        # oldest on insert); a key whose batch is running sits in _inflight,
        # and a duplicate leg parks on its event, then reads the cache
        self._idem: "OrderedDict[str, Dict]" = OrderedDict()
        self._inflight: Dict[str, threading.Event] = {}
        self._idem_cap = int(cluster_cfg.idempotency_cache)
        self._idem_hits = self.registry.counter(
            "serve_idempotent_hits_total",
            help="duplicate wire dispatches (hedges/retries) answered from the idempotency "
                 "cache without re-running the lattice")
        self._idem_evict = self.registry.counter(
            "serve_idempotent_evictions_total", help="idempotency-cache LRU evictions")
        self._dispatch_ctr = self.registry.counter(
            "serve_wire_dispatches_total", help="wire dispatches executed by this replica process")
        self._profiling = threading.Event()  # the profile endpoint's single-flight latch
        self._window_open = threading.Event()  # set while a capture's window counts
        self.last_profile: Optional[Dict] = None
        self._httpd = _JsonServer((host, port), {
            ("GET", "/healthz"): self._handle_healthz,
            ("POST", "/dispatch"): self._handle_dispatch,
            ("POST", "/drain"): self._handle_drain,
            ("GET", "/metrics"): self._handle_metrics,
            ("GET", "/debug/spans"): self._handle_spans,
            ("POST", "/debug/profile"): self._handle_profile,
        })
        self.host = host
        self.port = self._httpd.server_address[1]
        self._http_thread = threading.Thread(target=self._httpd.serve_forever,
                                             name=f"replica-{replica_id}-http", daemon=True)
        self._beat_thread = threading.Thread(target=self._beat_loop,
                                             name=f"replica-{replica_id}-heartbeat", daemon=True)

    # -- lifecycle ----------------------------------------------------------

    def start(self, register_timeout: Optional[float] = None) -> None:
        """Serve, register, beat. Call once the engine is prepared: the
        router measures warm-up as spawn-to-lease."""
        self._http_thread.start()
        deadline = time.monotonic() + (register_timeout if register_timeout is not None
                                       else self.ccfg.spawn_grace_s)
        if not self._register(deadline):
            raise WireError(f"replica {self.replica_id} could not register with "
                            f"{self.router_host}:{self.router_port}")
        self._beat_thread.start()

    def drain(self) -> None:
        """Stop admitting: heartbeats report not-ready and ``/dispatch``
        answers 503; the dispatches already admitted finish."""
        with self._dispatch_lock:
            self._draining = True

    def wait_idle(self, timeout: float) -> bool:
        """Block until no admitted dispatch is left (True) or ``timeout``
        passed (False)."""
        deadline = time.monotonic() + timeout
        with self._dispatch_lock:
            while self._active:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._dispatch_lock.wait(timeout=remaining)
        return True

    def close(self) -> None:
        self._stop.set()
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._http_thread.is_alive():
            self._http_thread.join(timeout=5.0)
        if self._beat_thread.is_alive():
            self._beat_thread.join(timeout=5.0)

    # -- the control plane's client ------------------------------------------

    def _register(self, deadline: float) -> bool:
        while not self._stop.is_set():
            if time.monotonic() >= deadline:
                return False
            try:
                status, body = _post_json(
                    self.router_host, self.router_port, "/register",
                    {"replica_id": self.replica_id, "host": self.host, "port": self.port,
                     "epoch": self._epoch, "pid": self.pid, "ready": self._ready()},
                    timeout=self.ccfg.connect_timeout_s)
            except OSError:
                status, body = 0, {}
            if status == 200:
                return True
            if status == 409:  # a stale epoch: jump past the table's
                self._epoch = max(self._epoch, int(body.get("epoch", self._epoch))) + 1
            # 503 = partitioned, 0 = unreachable: keep trying
            if self._stop.wait(min(0.2, self.ccfg.heartbeat_interval_s)):
                return False
        return False

    def _ready(self) -> bool:
        return bool(getattr(self.engine, "is_ready", True)) and not self._draining

    def _beat_loop(self) -> None:
        interval = self.ccfg.heartbeat_interval_s
        while not self._stop.wait(interval):
            try:
                status, body = _post_json(
                    self.router_host, self.router_port, "/heartbeat",
                    {"replica_id": self.replica_id, "epoch": self._epoch,
                     "ready": self._ready()},
                    timeout=self.ccfg.connect_timeout_s)
            except OSError:
                continue  # unreachable or partitioned: the lease ages
            if status in (409, 410):
                # this incarnation lost its lease (a healed partition, a new
                # router): register above the table's epoch and carry on
                self._epoch = max(self._epoch, int(body.get("epoch", self._epoch))) + 1
                self._register(time.monotonic() + interval)

    # -- endpoints ------------------------------------------------------------

    def _handle_healthz(self, body: Dict, headers=None) -> Tuple[int, Dict]:
        ready = self._ready()
        out = {
            "ready": ready,
            "replica_id": self.replica_id,
            "pid": self.pid,
            "epoch": self._epoch,
            "draining": self._draining,
            "active_dispatches": self._active,
            "compile_count": int(getattr(self.engine, "compile_count", 0)),
            "dispatch_count": int(getattr(self.engine, "dispatch_count", 0)),
            "wire_dispatches": int(self._dispatch_ctr.value),
            "idempotent_hits": int(self._idem_hits.value),
            "profiling": self._profiling.is_set(),
            "profile_window_open": self._window_open.is_set(),
            "last_profile": self.last_profile,
        }
        device = getattr(self.engine, "device", None)
        if device is not None and getattr(device, "type", None) == "cuda":
            import torch

            from speakingstyle_torch.ops import kernels

            out["memory_reserved_bytes"] = int(torch.cuda.memory_reserved(device))
            out["memory_allocated_bytes"] = int(torch.cuda.memory_allocated(device))
            # 0.0 a library: this process found it built
            out["build_seconds"] = dict(kernels.build_seconds)
        return (200 if ready else 503), out

    def _handle_drain(self, body: Dict, headers=None) -> Tuple[int, Dict]:
        self.drain()
        return 200, {"ok": True, "replica_id": self.replica_id}

    def _handle_metrics(self, body: Dict, headers=None) -> Tuple[int, Dict]:
        """The registry's raw state for the router's federation scraper."""
        return 200, self.registry.export_state()

    def _handle_spans(self, body: Dict, headers=None) -> Tuple[int, Dict]:
        """This process's span ring and keep-store, for the router's trace
        assembly."""
        ring = get_span_ring()
        return 200, {"replica_id": self.replica_id, "spans": ring.spans(),
                     "kept": {tid: ring.spans(tid) for tid in ring.kept_trace_ids()},
                     "stats": ring.stats()}

    def _handle_profile(self, body: Dict, headers=None) -> Tuple[int, Dict]:
        """One bounded ``torch.profiler`` capture (CUDA activity on the
        card) on a thread of its own: the handler answers at once, so a
        fan-out reaches every replica together. One at a time: a capture
        already running answers 409. The capture's summary (the device
        kernels by name, the kernel wrappers' launches over the window)
        becomes ``/healthz``'s ``last_profile``."""
        from speakingstyle_torch.serving.server import profile_window

        secs = min(60.0, max(0.05, float(body.get("seconds", 1.0) or 1.0)))
        out_dir = str(body.get("dir") or os.path.join(tempfile.gettempdir(),
                                                      f"torch-profile-{self.replica_id}"))
        if self._profiling.is_set():
            return 409, {"error": "profile already running", "replica_id": self.replica_id}
        self._profiling.set()
        device = getattr(self.engine, "device", None)
        cuda = device is not None and getattr(device, "type", None) == "cuda"

        def capture() -> None:
            try:
                os.makedirs(out_dir, exist_ok=True)
                summary = profile_window(secs, os.path.join(out_dir, "trace.json"), cuda,
                                         wait=self._stop.wait, opened=self._window_open)
                self.last_profile = dict(summary, replica_id=self.replica_id)
            except Exception as e:
                # profiling never takes a replica down; a failed capture is
                # counted, so a dead fan-out shows
                self.registry.counter(
                    "replica_profile_errors_total", labels={"error": type(e).__name__},
                    help="failed torch.profiler captures by error type").inc()
            finally:
                self._profiling.clear()

        threading.Thread(target=capture, name=f"replica-{self.replica_id}-profile",
                         daemon=True).start()
        return 200, {"ok": True, "replica_id": self.replica_id, "dir": out_dir, "seconds": secs}

    def _handle_dispatch(self, body: Dict, headers=None) -> Tuple[int, Dict]:
        with self._dispatch_lock:
            if self._draining:
                return 503, {"error": "draining"}
            self._active += 1
        try:
            return self._dispatch(body, headers)
        finally:
            with self._dispatch_lock:
                self._active -= 1
                self._dispatch_lock.notify_all()

    def _dispatch(self, body: Dict, headers=None) -> Tuple[int, Dict]:
        key = body.get("key", "")
        reqs = body.get("requests") or []
        if not reqs:
            # a torn-down leg can arrive with its body cut short
            return 400, {"error": "a dispatch carries no requests"}
        hedge_leg = (headers.get("X-Hedge-Leg") if headers is not None else None) or "primary"
        served_by = f"{self.host}:{self.port}"
        # check, claim, run, store: the lock covers the cache and the claims
        # only. A duplicate leg hits the cache or parks on the running leg's
        # event; a failed leg clears its claim with no entry, so the
        # duplicate runs (at-least-once delivery, at-most-once success)
        while True:
            wait_for = None
            with self._dispatch_lock:
                if key and key in self._idem:
                    self._idem.move_to_end(key)
                    self._idem_hits.inc()
                    cached = dict(self._idem[key])
                    cached["idempotent"] = True
                    return 200, cached
                if key and key in self._inflight:
                    wait_for = self._inflight[key]
                else:
                    if key:
                        self._inflight[key] = threading.Event()
                    break
            wait_for.wait(timeout=1.0)
            if self._stop.is_set():
                return 503, {"error": "stopping"}
        try:
            requests = [decode_request(d) for d in reqs]
            with self._run_lock:
                t0_wall = time.time()      # a span's start: the wall clock
                t0 = time.monotonic()      # its duration: the monotonic one
                results = self.engine.run(requests)
                dt = time.monotonic() - t0
            payload = {"served_by": served_by, "replica_id": self.replica_id,
                       "results": [encode_result(r) for r in results], "idempotent": False}
            # one replica_dispatch span a trace in the batch, recorded after
            # the fact; the engine's engine_run spans land beside it
            seen = set()
            for r in requests:
                ctx = r.trace
                if ctx is None or ctx.trace_id in seen:
                    continue
                seen.add(ctx.trace_id)
                Span.record("replica_dispatch", t0_wall, dt, parent=ctx,
                            replica=self.replica_id, rows=len(requests), hedge_leg=hedge_leg)
        except BaseException:
            if key:
                with self._dispatch_lock:
                    ev = self._inflight.pop(key, None)
                if ev is not None:
                    ev.set()
            raise
        if key:
            with self._dispatch_lock:
                self._idem[key] = payload
                while len(self._idem) > self._idem_cap:
                    self._idem.popitem(last=False)
                    self._idem_evict.inc()
                ev = self._inflight.pop(key, None)
            if ev is not None:
                ev.set()
        self._dispatch_ctr.inc()
        self.registry.counter(
            "serve_wire_legs_total", labels={"leg": hedge_leg},
            help="wire dispatches executed by this replica process, by hedge leg "
                 "(primary, retry, hedge)").inc()
        return 200, payload


# ---------------------------------------------------------------------------
# the router's side: the remote replica proxy
# ---------------------------------------------------------------------------


class RemoteEngine:
    """One replica process behind the router's duck-typed engine surface
    (``precompile()`` + ``run()``), which rollouts, the autoscaler and the
    breaker's re-warms drive. ``vocoder = None``: a stream's windows are
    vocoded on the replica that made the result, which the wire does not
    reach, so the HTTP layer answers 400 to a stream in cluster mode."""

    vocoder = None

    def __init__(self, cluster: "ClusterRouter", registry: Optional[MetricsRegistry] = None,
                 spawn_extra: Optional[Dict] = None):
        self._cluster = cluster
        self._registry = registry if registry is not None else cluster.registry
        self._spawn_extra = spawn_extra
        # bound by precompile() (the warm-up thread) before the dispatch
        # worker starts
        self.replica_id: str = ""
        self.host: str = ""
        self.port: int = 0

    # -- warm-up ------------------------------------------------------------

    def precompile(self) -> float:
        """Adopt or spawn, then wait for a live, ready lease. The wall time
        (spawn, the child's preparation, registration; an adoption measures
        cheap) feeds ``serve_replica_warmup_seconds``."""
        t0 = time.monotonic()
        rid, host, port = self._cluster._acquire_replica(self._spawn_extra, owner=self)
        self.replica_id, self.host, self.port = rid, host, port
        return time.monotonic() - t0

    @property
    def is_ready(self) -> bool:
        lease = self._cluster.leases.get(self.replica_id)
        return lease is not None and lease.ready and time.monotonic() <= lease.deadline

    @property
    def compile_count(self) -> int:
        """The replica's compile counter from its /healthz; -1 unreachable."""
        try:
            _, body = _get_json(self.host, self.port, "/healthz",
                                timeout=self._cluster.ccfg.connect_timeout_s)
        except OSError:
            return -1
        return int(body.get("compile_count", -1))

    def close(self) -> None:
        """The fleet retired this engine: its process is drained and
        stopped (off this thread), unless it is an orphan a breaker trial
        may adopt or another engine adopted it."""
        if self._cluster._owns(self.replica_id, self):
            self._cluster._retire_later(self.replica_id)

    # -- hedged dispatch ----------------------------------------------------

    def _wire_hist(self, klass: str):
        return self._registry.histogram(
            "serve_wire_latency_seconds", labels={"class": klass},
            help="winning wire dispatch round-trip per priority class (the hedge-delay "
                 "quantile source)")

    def _hedge_delay_s(self, klass: str) -> float:
        ccfg = self._cluster.ccfg
        hist = self._wire_hist(klass)
        q = hist.percentile(ccfg.hedge_quantile) if hist.count else None
        delay = q if q is not None else ccfg.hedge_max_ms / 1e3
        return min(max(delay, ccfg.hedge_min_ms / 1e3), ccfg.hedge_max_ms / 1e3)

    def run(self, requests: List[SynthesisRequest]) -> List[SynthesisResult]:
        """One coalesced dispatch over the wire, hedged. The whole call is
        bounded by the class's deadline budget plus its grace; a failed
        first leg retries once after a backoff; a slow first leg fires a
        hedge to another host after the class's hedge quantile. The legs
        carry one idempotency key; the first success wins and the losers'
        connections are closed. Total failure raises ``WireError`` into the
        worker, and the router requeues the batch at its original
        deadline."""
        if not requests:
            return []
        c = self._cluster
        if c.is_partitioned(self.replica_id):
            raise WireError(f"replica {self.replica_id} is partitioned from the router")
        fleet = c.fleet
        klass = requests[0].priority or fleet.default_class
        budget_s = (fleet.class_deadline_ms.get(klass, max(fleet.class_deadline_ms.values()))
                    + fleet.deadline_grace_ms) / 1e3
        key = batch_key(requests)
        payload = json.dumps({"key": key,
                              "requests": [encode_request(r) for r in requests]}).encode("utf-8")
        # the distinct trace contexts of the dispatch: each leg records one
        # remote_dispatch span a trace, so hedge legs are siblings under the
        # request's span, one of them with winner=True
        traces: List[TraceContext] = []
        seen: set = set()
        for r in requests:
            if r.trace is not None and r.trace.trace_id not in seen:
                seen.add(r.trace.trace_id)
                traces.append(r.trace)
        wire_headers = {}
        if traces:
            wire_headers["X-Trace-Id"] = traces[0].trace_id
            wire_headers["X-Parent-Span"] = traces[0].span_id or ""

        hedge_enabled = c.ccfg.hedge_quantile > 0.0
        hedge_delay = self._hedge_delay_s(klass)
        deadline = time.monotonic() + budget_s
        # at most 3 legs (primary, one retry, one hedge): 4 slots never block
        out_q: "queue.Queue" = queue.Queue(maxsize=4)
        conns: Dict[str, HTTPConnection] = {}
        threads: List[threading.Thread] = []
        leg_recs: Dict[str, List[Dict]] = {}

        def record_leg(tag, host, port, t0_wall, dt, err) -> None:
            """One remote_dispatch span a trace; the ring keeps the dicts,
            so the winner flag is set in place once the race is decided."""
            if not traces or not obstrace.tracing_enabled():
                return
            ring = get_span_ring()
            recs = []
            for ctx in traces:
                rec: Dict = {"name": "remote_dispatch", "start_ts": t0_wall, "duration_s": dt,
                             **ctx.child().as_dict(),
                             "fields": {"hedge_leg": tag, "target": f"{host}:{port}"}}
                if err is not None:
                    rec["ok"] = False
                    rec["error"] = f"{type(err).__name__}: {err}"
                ring.add(rec)
                recs.append(rec)
            leg_recs[tag] = recs

        def leg(host: str, port: int, tag: str) -> None:
            t0 = time.monotonic()
            t0_wall = time.time()
            hdrs = {"Content-Type": "application/json", "X-Hedge-Leg": tag}
            hdrs.update(wire_headers)
            conn = HTTPConnection(host, port, timeout=max(0.05, deadline - t0))
            conns[tag] = conn
            err_out: Optional[BaseException] = None
            try:
                conn.request("POST", "/dispatch", body=payload, headers=hdrs)
                resp = conn.getresponse()
                data = resp.read()
                if resp.status != 200:
                    raise WireError(f"dispatch to {host}:{port} answered {resp.status}")
                body = json.loads(data)
                try:
                    out_q.put((tag, time.monotonic() - t0, body, None), timeout=1.0)
                except queue.Full:
                    pass
            except BaseException as e:
                err_out = e
                try:
                    out_q.put((tag, time.monotonic() - t0, None, e), timeout=1.0)
                except queue.Full:
                    pass
            finally:
                record_leg(tag, host, port, t0_wall, time.monotonic() - t0, err_out)
                conn.close()

        def fire(host: str, port: int, tag: str) -> None:
            t = threading.Thread(target=leg, args=(host, port, tag),
                                 name=f"wire-{self.replica_id}-{tag}", daemon=True)
            threads.append(t)
            t.start()

        def fire_hedge() -> bool:
            target = c.hedge_target(self.replica_id)
            if target is None:
                return False
            h_host, h_port, _ = target
            self._registry.counter(
                "serve_hedge_fired_total", labels={"class": klass},
                help="hedge legs fired (slow or failed first leg)").inc()
            fire(h_host, h_port, "hedge")
            return True

        fire(self.host, self.port, "primary")
        outstanding, hedge_fired, retried = 1, False, False
        winner = None
        last_err: Optional[BaseException] = None
        hedge_due = time.monotonic() + hedge_delay
        while winner is None:
            now = time.monotonic()
            if now >= deadline:
                break
            if hedge_enabled and not hedge_fired and now >= hedge_due:
                hedge_fired = True  # one hedge a dispatch, target or not
                if fire_hedge():
                    outstanding += 1
                continue
            wait = deadline - now
            if hedge_enabled and not hedge_fired:
                wait = min(wait, hedge_due - now)
            try:
                tag, dt, body, err = out_q.get(timeout=max(0.01, wait))
            except queue.Empty:
                continue
            outstanding -= 1
            if err is None:
                winner = (tag, dt, body)
                break
            last_err = err
            if c.is_partitioned(self.replica_id) and outstanding == 0 and not hedge_fired:
                break  # partitioned mid-dispatch: fail fast, requeue
            if tag in ("primary", "retry") and hedge_enabled and not hedge_fired:
                hedge_fired = True  # a failed (not only slow) first leg hedges at once
                if fire_hedge():
                    outstanding += 1
                    continue
            if not retried and time.monotonic() < deadline and outstanding == 0:
                # one retry after a backoff scaled to the class budget
                retried = True
                backoff = min(budget_s / 20.0, max(0.0, deadline - time.monotonic()))
                if backoff > 0 and c.stopped.wait(backoff):
                    break
                fire(self.host, self.port, "retry")
                outstanding += 1
                continue
            if outstanding == 0:
                break

        # first wins: closing the losers' connections unblocks their threads
        for tag, conn in list(conns.items()):
            if winner is not None and tag == winner[0]:
                continue
            try:
                conn.close()
            except OSError:
                pass
        for t in threads:
            t.join(timeout=1.0)
        if winner is None:
            raise WireError(
                f"dispatch to replica {self.replica_id} failed within its {klass!r} budget "
                f"({budget_s:.3f}s): {type(last_err).__name__ if last_err else 'timeout'}: "
                f"{last_err}") from last_err
        tag, dt, body = winner
        for rec in leg_recs.get(tag, []):  # every leg joined: the records are final
            rec.setdefault("fields", {})["winner"] = True
        self._wire_hist(klass).observe(dt)
        if tag == "hedge":
            self._registry.counter(
                "serve_hedge_won_total", labels={"class": klass},
                help="dispatches won by the hedge leg").inc()
            for ctx in traces:  # a hedge win is a tail event: pin its traces
                c._note_pressure(ctx, "hedge_won")
        served_by = body.get("served_by") or f"{self.host}:{self.port}"
        return [decode_result(d, served_by=served_by) for d in body.get("results", [])]


# ---------------------------------------------------------------------------
# the cluster router
# ---------------------------------------------------------------------------


class ClusterRouter(FleetRouter):
    """A ``FleetRouter`` whose replicas are processes with heartbeat leases.

    ``spawn(replica_id, router_addr, extra)`` starts one replica process
    and returns a Popen-shaped handle (``poll`` / ``terminate`` / ``kill``
    / ``wait``); the process must serve a ``ReplicaServer`` pointed at
    ``router_addr`` under ``replica_id``. Everything else is the base
    router's: a ``RemoteEngine`` is an engine to it. The StyleService
    (``style``) stays here: styles resolve to (gamma, beta) before a
    dispatch and cross the wire, so the replicas run no reference
    encoder."""

    def __init__(self, spawn: Callable, cfg, replicas: Optional[int] = None,
                 registry: Optional[MetricsRegistry] = None,
                 events: Optional[JsonlEventLog] = None, style=None,
                 fault_plan: Optional[FaultPlan] = None, tier: Optional[str] = None):
        ccfg = cfg.serve.cluster
        self.ccfg = ccfg
        self._spawn = spawn
        self.leases = LeaseTable(ccfg.lease_ttl_s)
        self._proc_lock = make_lock("ClusterRouter._proc_lock")
        self._procs: Dict[str, object] = {}   # replica id -> process
        # warm processes a breaker trial may adopt (the base router's
        # ``_orphans`` counts abandoned dispatches)
        self._orphan_ids: List[str] = []
        self._owner: Dict[str, RemoteEngine] = {}  # replica id -> the engine that adopted it
        self._retirers: List[threading.Thread] = []
        self._partitioned: set = set()
        self._id_seq = 0
        # the stop signal of waits that cannot ride the router's condition
        self.stopped = threading.Event()
        # the quorum is the autoscaler's floor too
        self.scale_floor = ccfg.quorum
        # the control server listens before the first spawn: children
        # register during the base constructor's warm-ups
        self._control = _JsonServer((ccfg.control_host, ccfg.control_port), {
            ("POST", "/register"): self._handle_register,
            ("POST", "/heartbeat"): self._handle_heartbeat,
            ("GET", "/cluster"): lambda body, headers=None: (
                200, {"replicas": self.cluster_stats()}),
        })
        self.control_host = ccfg.control_host
        self.control_port = self._control.server_address[1]
        self._control_thread = threading.Thread(target=self._control.serve_forever,
                                                name="cluster-control-http", daemon=True)
        self._control_thread.start()
        self._fed_lock = make_lock("ClusterRouter._fed_lock")
        self._fed_states: Dict[str, Dict] = {}
        super().__init__(self._remote_factory, cfg, replicas=replicas, registry=registry,
                         events=events, style=style, fault_plan=fault_plan, tier=tier)
        self._lease_requeue_hist = self.registry.histogram(
            "serve_lease_requeue_seconds",
            help="lease expiry instant -> in-flight work requeued (the failover latency the "
                 "lease sweeper adds)")
        self._lease_expired_ctr = self.registry.counter(
            "serve_lease_expired_total", help="leases the sweeper expired into _replica_failed")
        self._cluster_thread = threading.Thread(target=self._cluster_supervise,
                                                name="cluster-lease-sweeper", daemon=True)
        self._cluster_thread.start()
        # federation: each live replica's /metrics scraped into a cache the
        # router's /metrics merges (merge_states)
        self._fed_scrapes = self.registry.counter(
            "serve_federation_scrapes_total",
            help="replica /metrics scrapes the federator completed")
        self._fed_errors = self.registry.counter(
            "serve_federation_errors_total",
            help="replica /metrics scrapes that failed (unreachable, partitioned, bad payload)")
        self._fed_thread = threading.Thread(target=self._federate,
                                            name="cluster-metrics-federator", daemon=True)
        self._fed_thread.start()

    @property
    def control_addr(self) -> str:
        return f"{self.control_host}:{self.control_port}"

    def _remote_factory(self, registry: MetricsRegistry) -> RemoteEngine:
        return RemoteEngine(self, registry)

    def remote_factory(self, spawn_extra: Optional[Dict] = None) -> Callable:
        """A replica factory for ``start_replica``: the rollout's canary
        passes ``spawn_extra`` (``{"restore_step": N}``) so its process
        restores the candidate while the default factory spawns the live
        version."""
        def factory(registry: MetricsRegistry) -> RemoteEngine:
            return RemoteEngine(self, registry, spawn_extra=spawn_extra)
        return factory

    # -- control-plane endpoints -----------------------------------------------

    def _handle_register(self, body: Dict, headers=None) -> Tuple[int, Dict]:
        rid = str(body.get("replica_id", ""))
        if not rid:
            return 400, {"error": "missing replica_id"}
        if self.is_partitioned(rid):
            return 503, {"error": "partitioned"}
        now = time.monotonic()
        ok, epoch = self.leases.register(
            rid, str(body.get("host", "127.0.0.1")), int(body.get("port", 0)),
            int(body.get("epoch", 1)), int(body.get("pid", 0)), now)
        if not ok:
            return 409, {"error": "stale_epoch", "epoch": epoch}
        if body.get("ready"):
            self.leases.heartbeat(rid, int(body.get("epoch", 1)), True, now)
        if self.events is not None:
            self.events.emit("replica_register", replica_id=rid, epoch=epoch,
                             host=f"{body.get('host')}:{body.get('port')}")
        return 200, {"epoch": epoch, "lease_ttl_s": self.leases.ttl_s,
                     "heartbeat_interval_s": self.ccfg.heartbeat_interval_s}

    def _handle_heartbeat(self, body: Dict, headers=None) -> Tuple[int, Dict]:
        rid = str(body.get("replica_id", ""))
        if self.is_partitioned(rid):
            return 503, {"error": "partitioned"}
        status = self.leases.heartbeat(rid, int(body.get("epoch", 0)), bool(body.get("ready")),
                                       time.monotonic())
        code = {"renewed": 200, "stale": 409, "expired": 410, "unknown": 410}[status]
        payload: Dict = {"status": status}
        if status in ("stale", "expired"):
            lease = self.leases.get(rid)
            if lease is not None:
                payload["epoch"] = lease.epoch
        return code, payload

    # -- the partition drill ----------------------------------------------------

    def is_partitioned(self, replica_id: str) -> bool:
        with self._proc_lock:
            return replica_id in self._partitioned

    def partition(self, replica_id: str) -> None:
        """Drop every router <-> replica packet of one replica until
        ``heal``: its heartbeats stop renewing (503), its dispatches fail
        fast, adoption refuses it."""
        with self._proc_lock:
            self._partitioned.add(replica_id)
        if self.events is not None:
            self.events.emit("net_partition", replica_id=replica_id)

    def heal(self, replica_id: str) -> None:
        with self._proc_lock:
            self._partitioned.discard(replica_id)
        if self.events is not None:
            self.events.emit("net_partition_heal", replica_id=replica_id)

    # -- chaos hooks (the fleet's _dispatch fires them) ---------------------------

    def _chaos_proc_kill(self, rep: Replica) -> bool:
        eng = rep.engine
        if not isinstance(eng, RemoteEngine):
            return False
        with self._proc_lock:
            proc = self._procs.get(eng.replica_id)
        if proc is None:
            return False
        try:
            proc.kill()
        except OSError:
            return False
        if self.events is not None:
            self.events.emit("chaos_proc_kill", replica_id=eng.replica_id, replica=rep.index)
        return True  # the wire call that follows fails on its own

    def _chaos_partition(self, rep: Replica) -> bool:
        eng = rep.engine
        if not isinstance(eng, RemoteEngine):
            return False
        self.partition(eng.replica_id)
        return True

    # -- the process pool -------------------------------------------------------

    def _new_id(self) -> str:
        with self._proc_lock:
            self._id_seq += 1
            return f"r{self._id_seq}"

    def processes(self) -> Dict[str, object]:
        """The live process handles by replica id (a copy)."""
        with self._proc_lock:
            return dict(self._procs)

    def _take_orphan(self) -> Optional[str]:
        """Pop one adoptable orphan (a live process); dead ones are reaped
        on the way."""
        with self._proc_lock:
            while self._orphan_ids:
                rid = self._orphan_ids.pop(0)
                proc = self._procs.get(rid)
                if proc is None:
                    continue
                if proc.poll() is not None:
                    self._procs.pop(rid, None)
                    self.leases.drop(rid)
                    continue
                return rid
        return None

    def _stash_orphan(self, replica_id: str) -> None:
        """A failed replica's live process becomes adoptable (the partition
        heal re-admits it warm); a dead one is reaped."""
        if not replica_id:
            return
        with self._proc_lock:
            proc = self._procs.get(replica_id)
            if proc is None:
                return
            if proc.poll() is not None:
                self._procs.pop(replica_id, None)
                self.leases.drop(replica_id)
                return
            if replica_id not in self._orphan_ids:
                self._orphan_ids.append(replica_id)

    def _acquire_replica(self, spawn_extra: Optional[Dict] = None,
                         owner: Optional[RemoteEngine] = None) -> Tuple[str, str, int]:
        """Adopt or spawn one replica process and wait for its live, ready
        lease; ``owner`` (the adopting engine) owns the process from then
        on. Raises ``WireError`` on a partition, the process's death, the
        spawn grace or the router closing (the caller is the fleet's warm-up,
        whose failure path keeps the breaker's books)."""
        rid = self._take_orphan() if spawn_extra is None else None
        spawned = False
        if rid is None:
            rid = self._new_id()
            proc = self._spawn(rid, self.control_addr, spawn_extra)
            with self._proc_lock:
                closing = self.stopped.is_set()
                if not closing:
                    self._procs[rid] = proc
            if closing:  # close() took its snapshot: this child is ours to stop
                _stop_process(proc, 5.0)
                raise WireError("router is closing")
            spawned = True
        if self.is_partitioned(rid):
            self._stash_orphan(rid)
            raise WireError(f"replica {rid} is partitioned from the router")
        deadline = time.monotonic() + self.ccfg.spawn_grace_s
        poll_s = min(0.05, self.ccfg.heartbeat_interval_s / 2.0)
        while True:
            if self.stopped.is_set():
                self._stash_orphan(rid)
                raise WireError("router is closing")
            if self.is_partitioned(rid):
                self._stash_orphan(rid)
                raise WireError(f"replica {rid} partitioned during warm-up")
            with self._proc_lock:
                proc = self._procs.get(rid)
            rc = proc.poll() if proc is not None else -1
            if rc is not None:
                with self._proc_lock:
                    self._procs.pop(rid, None)
                self.leases.drop(rid)
                raise WireError(f"replica {rid} process exited (rc={rc}) before READY")
            now = time.monotonic()
            lease = self.leases.get(rid)
            if lease is not None and lease.ready and now <= lease.deadline:
                try:
                    status, _ = _get_json(lease.host, lease.port, "/healthz",
                                          timeout=self.ccfg.connect_timeout_s)
                except OSError:
                    status = 0
                if status == 200:
                    with self._proc_lock:
                        self._owner[rid] = owner
                    return rid, lease.host, lease.port
            if now >= deadline:
                if spawned:
                    with self._proc_lock:
                        self._procs.pop(rid, None)
                    _stop_process(proc, 5.0, kill=True)
                    self.leases.drop(rid)
                else:
                    self._stash_orphan(rid)
                raise WireError(f"replica {rid} missed the {self.ccfg.spawn_grace_s:g}s spawn "
                                "grace (no live+ready lease)")
            self.stopped.wait(poll_s)

    def hedge_target(self, exclude: str) -> Optional[Tuple[str, int, str]]:
        """Another host for a hedge leg: a live, ready, unpartitioned lease
        other than ``exclude``."""
        for row in self.leases.snapshot(time.monotonic()):
            rid = row["replica_id"]
            if rid == exclude or row["expired"] or not row["ready"] or self.is_partitioned(rid):
                continue
            host, _, port = row["host"].rpartition(":")
            return host, int(port), rid
        return None

    # -- metrics federation and the trace fan-in ----------------------------------

    def _live_hosts(self):
        """(replica id, host, port) of every unexpired, unpartitioned lease."""
        for row in self.leases.snapshot(time.monotonic()):
            rid = row["replica_id"]
            if row["expired"] or self.is_partitioned(rid):
                continue
            host, _, port = row["host"].rpartition(":")
            yield rid, host, int(port)

    def _federate(self) -> None:
        """Scrape the live replicas' /metrics into the federation cache
        every heartbeat interval. The wire calls run with no lock held; an
        expired or partitioned replica drops out of the cache, so its frozen
        counters leave the merged view until it registers again."""
        interval = max(0.05, self.ccfg.heartbeat_interval_s)
        while not self.stopped.wait(interval):
            fresh: Dict[str, Dict] = {}
            live = set()
            for rid, host, port in self._live_hosts():
                live.add(rid)
                try:
                    status, state = _get_json(host, port, "/metrics",
                                              timeout=self.ccfg.connect_timeout_s)
                except OSError:
                    status, state = 0, {}
                if status == 200 and isinstance(state.get("metrics"), list):
                    fresh[rid] = state
                    self._fed_scrapes.inc()
                else:
                    self._fed_errors.inc()
            with self._fed_lock:
                self._fed_states.update(fresh)
                for rid in list(self._fed_states):
                    if rid not in live:
                        self._fed_states.pop(rid)

    def federated_states(self) -> List[Tuple[str, Dict]]:
        """The latest scraped ``(replica_id, export_state)`` pairs."""
        with self._fed_lock:
            return sorted(self._fed_states.items())

    def federated_registry(self) -> MetricsRegistry:
        """The fleet-merged view (``merge_states``): the ``fleet_*`` series
        the router's /metrics appends."""
        return merge_states(self.federated_states())

    def fetch_remote_spans(self, trace_id: Optional[str] = None) -> List[Dict]:
        """The replicas' spans (ring and keep-store, deduplicated by span
        id) for the cross-process trace assembly of ``GET
        /debug/trace/<id>``; an unreachable or partitioned replica gives
        nothing."""
        out: Dict[str, Dict] = {}
        for _, host, port in self._live_hosts():
            try:
                status, payload = _get_json(host, port, "/debug/spans",
                                            timeout=self.ccfg.connect_timeout_s)
            except OSError:
                continue
            if status != 200:
                continue
            cand = list(payload.get("spans", []))
            for kept in (payload.get("kept") or {}).values():
                cand.extend(kept)
            for s in cand:
                if trace_id is not None and s.get("trace_id") != trace_id:
                    continue
                if s.get("span_id"):
                    out[s["span_id"]] = s
        return list(out.values())

    def profile_fanout(self, seconds: float = 1.0) -> Dict[str, bool]:
        """``POST /debug/profile`` to every live replica at once: one
        fleet-wide ``torch.profiler`` window."""
        out: Dict[str, bool] = {}
        for rid, host, port in self._live_hosts():
            try:
                status, _ = _post_json(host, port, "/debug/profile", {"seconds": seconds},
                                       timeout=self.ccfg.connect_timeout_s)
                out[rid] = status == 200
            except OSError:
                out[rid] = False
        return out

    # -- the lease sweep and the reaper ---------------------------------------------

    def _cluster_supervise(self) -> None:
        """Expire leases into ``_replica_failed`` and reap the processes of
        replicas the router stopped. Leases are read outside the router's
        condition; the in-flight steal then takes it again and re-checks the
        replica's state, as the hang watchdog does. A stolen batch counts as
        an abandoned dispatch (the base router's ``_orphans``) until its
        worker returns."""
        interval = max(0.02, self.ccfg.heartbeat_interval_s / 2.0)
        while True:
            candidates, reap = [], []
            with self._cond:
                if self._closing:
                    return
                self._cond.wait(timeout=interval)
                if self._closing:
                    return
                for rep in self._replicas:
                    eng = rep.engine
                    if not isinstance(eng, RemoteEngine):
                        continue
                    if rep.state == READY:
                        candidates.append((rep, eng))
                    elif rep.state == STOPPED and self._owns(eng.replica_id, eng):
                        reap.append(eng.replica_id)
            now = time.monotonic()
            for rep, eng in candidates:
                lease = self.leases.get(eng.replica_id)
                if lease is not None and now <= lease.deadline:
                    continue
                t_exp = lease.deadline if lease else now
                with self._cond:
                    if rep.state != READY or rep.engine is not eng:
                        continue  # failed, drained or re-warmed since the scan
                    # the worker's late wire result fails its claim and is
                    # discarded
                    batch = rep.inflight
                    rep.inflight = None
                    rep.dispatch_started = None
                    if batch is not None:
                        self._orphans += 1
                age = time.monotonic() - t_exp
                self._lease_expired_ctr.inc()
                self._replica_failed(rep, batch or [], LeaseExpired(
                    f"replica {eng.replica_id} lease expired {age:.3f}s ago (miss budget "
                    f"{self.ccfg.lease_miss_budget} exceeded)",
                    replica_id=eng.replica_id, age_s=age), kind="lease")
                self._lease_requeue_hist.observe(time.monotonic() - t_exp)
            for rid in reap:
                self._retire_process(rid)

    def _replica_failed(self, rep: Replica, batch, error, kind) -> None:
        eng = rep.engine
        super()._replica_failed(rep, batch, error, kind)
        # a failed replica's live process becomes an adoptable orphan: the
        # breaker's next trial re-admits it warm instead of spawning
        if isinstance(eng, RemoteEngine):
            self._stash_orphan(eng.replica_id)

    def _owns(self, replica_id: str, engine: RemoteEngine) -> bool:
        """True while ``engine`` owns the live, non-orphan process
        ``replica_id``."""
        with self._proc_lock:
            return (bool(replica_id) and replica_id in self._procs
                    and replica_id not in self._orphan_ids
                    and self._owner.get(replica_id) is engine)

    def _retire_later(self, replica_id: str) -> None:
        """Retire a process off the calling thread (the fleet closes a
        retired engine on its worker or supervisor thread); ``close()``
        joins these threads."""
        t = threading.Thread(target=self._retire_process, args=(replica_id,),
                             name=f"cluster-retire-{replica_id}", daemon=True)
        with self._proc_lock:
            self._retirers = [r for r in self._retirers if r.is_alive()] + [t]
        t.start()

    def _retire_process(self, replica_id: str) -> None:
        """Drain and stop one retired replica's process (SIGTERM, then
        SIGKILL past ``fleet.drain_timeout_s``)."""
        with self._proc_lock:
            proc = self._procs.pop(replica_id, None)
            self._owner.pop(replica_id, None)
            if replica_id in self._orphan_ids:
                self._orphan_ids.remove(replica_id)
        self.leases.drop(replica_id)
        if proc is not None:
            _stop_process(proc, self.fleet.drain_timeout_s)

    # -- readiness and stats ----------------------------------------------------

    def ready(self) -> bool:
        """Quorum readiness: /healthz answers 503 until ``cluster.quorum``
        replicas are READY."""
        with self._cond:
            return sum(r.state == READY for r in self._replicas) >= self.ccfg.quorum

    def cluster_stats(self) -> List[Dict]:
        """One lease row a replica (host, pid, epoch, age, last heartbeat,
        partition flag): the /healthz cluster block."""
        rows = self.leases.snapshot(time.monotonic())
        for row in rows:
            row["partitioned"] = self.is_partitioned(row["replica_id"])
        return rows

    # -- shutdown ---------------------------------------------------------------

    def close(self, flush: bool = True, timeout: float = 30.0) -> None:
        """Idempotent: the base router's close, then every replica process
        stopped (SIGTERM, SIGKILL after 5 s) and reaped, then the control
        server."""
        self.stopped.set()
        super().close(flush=flush, timeout=timeout)
        if self._cluster_thread.is_alive():
            self._cluster_thread.join(timeout=5.0)
        if self._fed_thread.is_alive():
            self._fed_thread.join(timeout=5.0)
        with self._proc_lock:
            procs = dict(self._procs)
            self._procs = {}
            self._orphan_ids = []
            self._owner = {}
            retirers = list(self._retirers)
        for proc in procs.values():
            try:
                proc.terminate()
            except OSError:
                pass
        for proc in procs.values():
            _stop_process(proc, 5.0)
        for t in retirers:
            t.join(timeout=self.fleet.drain_timeout_s + 10.0)
        self._control.shutdown()
        self._control.server_close()
        if self._control_thread.is_alive():
            self._control_thread.join(timeout=5.0)


def _stop_process(proc, grace_s: float, kill: bool = False) -> None:
    """SIGTERM (or SIGKILL with ``kill``), wait up to ``grace_s``, then
    SIGKILL and reap."""
    if proc.poll() is not None:
        return
    try:
        proc.kill() if kill else proc.terminate()
    except OSError:
        pass
    try:
        proc.wait(timeout=grace_s)
    except (OSError, subprocess.TimeoutExpired):
        try:
            proc.kill()
            proc.wait(timeout=5.0)
        except (OSError, subprocess.TimeoutExpired):
            pass
