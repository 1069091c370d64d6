"""PyTorch port, the cluster (serving/cluster.py), held against the JAX
package's.

Four layers, as ``tests/test_cluster.py``, each case run on both packages'
classes with the same expectations (``pkg("torch")`` / ``pkg("tpu")``):

1. the lease table (epoch fencing, strict expiry) against an explicit clock;
2. the wire codec and the replica's idempotency cache, no router;
3. the cluster end to end over in-process replica "processes" (a
   ``FakeProc`` wraps a real ``ReplicaServer`` and a toy engine, so
   registration, heartbeats, dispatch and chaos cross real HTTP): lease
   expiry mid-dispatch requeues without duplicating, a partition's heal
   re-admits the same process through the breaker's half-open, a process
   kill loses no request, a slow primary is hedged to a second host;
4. what other parts read: the quorum-gated ``/healthz`` cluster block, the
   autoscaler's floor, the ``RemoteEngine`` surface.

Then the port alone against the JAX package: the wire across packages
(arrays byte-equal, ``batch_key`` equal), a request through a port
``ClusterRouter`` and a ``ReplicaServer`` around a real port engine on the
CPU (weights carried from JAX by ``compat.from_jax``) equal to that engine's
``run`` bit for bit and within the f32 bar of
``tests/test_torch_serve_core.py`` (durations equal, mel 2e-4, wav 2 LSB)
of the JAX engine's ``run``; a real ``python -m speakingstyle_torch replica
--device cpu`` process; the port's own retirement and drain of a process.

Every router is closed in a ``finally`` and every wait has a timeout.
"""

import importlib
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

from test_torch_models import one_cpu_thread  # noqa: F401 (an autouse fixture)
from test_torch_synthesis import jax_weights  # noqa: F401 (a fixture)
from test_torch_training import corpus  # noqa: F401 (a fixture)

PKGS = ("torch", "tpu")
TIMEOUT = 30.0


def pkg(name):
    """One package's cluster-facing modules, by the shared module names."""
    mod = lambda m: importlib.import_module(f"speakingstyle_{name}.{m}")  # noqa: E731
    return SimpleNamespace(
        name=name, config=mod("configs.config"), cluster=mod("serving.cluster"),
        engine=mod("serving.engine"), fleet=mod("serving.fleet"), obs=mod("obs"),
        faults=mod("faults"), autoscale=mod("serving.autoscale"), server=mod("serving.server"),
        registry=mod("obs.registry"), trace=mod("obs.trace"), style=mod("serving.style"))


def wait_for(pred, timeout=20.0, interval=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return pred()


def req(p, i, L=8, T=4, **kw):
    return p.engine.SynthesisRequest(
        id=f"q{i}", sequence=np.arange(1, L + 1, dtype=np.int32),
        ref_mel=np.random.default_rng(i).standard_normal((T, 80)).astype(np.float32), **kw)


class CountingEngine:
    """A replica's toy engine: records the ids it ran; requests named in
    ``stall_ids`` wait for ``unstall`` (at most ``stall_s``)."""

    is_ready = True

    def __init__(self, stall_s=0.0, stall_ids=()):
        self.runs = []
        self.stall_s = stall_s
        self.stall_ids = set(stall_ids)
        self.unstall = threading.Event()
        self._lock = threading.Lock()

    def precompile(self):
        return 0.0

    def run(self, requests):
        if any(r.id in self.stall_ids for r in requests):
            self.unstall.wait(timeout=self.stall_s)
        with self._lock:
            self.runs.extend(r.id for r in requests)
        return [SimpleNamespace(id=r.id, mel_len=1) for r in requests]


class StallOnce(CountingEngine):
    """Stalls the first engine (of all sharing ``armed``) to see ``rid``."""

    def __init__(self, rid, armed, stall_s):
        super().__init__()
        self.rid, self.armed, self.stall_s_once = rid, armed, stall_s

    def run(self, requests):
        if any(r.id == self.rid for r in requests):
            with self.armed["lock"]:
                hit, self.armed["on"] = self.armed["on"], False
            if hit:
                self.unstall.wait(timeout=self.stall_s_once)
        return super().run(requests)


class FakeProc:
    """One replica "process" in this process: a real ReplicaServer (its own
    socket, registration and heartbeat thread) behind the subprocess surface
    the router drives."""

    def __init__(self, p, rid, router_addr, ccfg, engine=None):
        self.engine = engine if engine is not None else CountingEngine()
        self.server = p.cluster.ReplicaServer(self.engine, rid, router_addr, ccfg)
        self._rc = None
        self.server.start()

    def poll(self):
        return self._rc

    def terminate(self):
        if self._rc is None:
            self._rc = 0
            getattr(self.engine, "unstall", threading.Event()).set()
            self.server.close()

    kill = terminate

    def wait(self, timeout=None):
        return self._rc


def cluster_cfg(p, **cluster_kw):
    """The toy cluster's config: one-point lattice, 0.1 s heartbeats (a
    0.4 s lease), hedging off unless asked."""
    c = p.config
    ckw = dict(enabled=True, heartbeat_interval_s=0.1, lease_miss_budget=3, spawn_grace_s=10.0,
               quorum=1, hedge_quantile=0.0)
    ckw.update(cluster_kw)
    return c.Config(serve=c.ServeConfig(
        batch_buckets=[1], src_buckets=[16], mel_buckets=[64], frames_per_phoneme=2,
        max_wait_ms=5.0,
        fleet=c.FleetConfig(queue_depth=64, stream_window=8, rewarm_backoff_s=0.05,
                            rewarm_backoff_max_s=0.5,
                            class_deadline_ms={"interactive": 10_000.0, "batch": 20_000.0}),
        cluster=c.ClusterConfig(**ckw)))


def make_cluster(p, replicas, engine_factory=None, **cluster_kw):
    """(router, {replica id: FakeProc}, registry)."""
    cfg = cluster_cfg(p, **cluster_kw)
    procs = {}

    def spawn(rid, router_addr, extra):
        eng = engine_factory(rid) if engine_factory is not None else None
        procs[rid] = FakeProc(p, rid, router_addr, cfg.serve.cluster, engine=eng)
        return procs[rid]

    reg = p.obs.MetricsRegistry()
    router = p.cluster.ClusterRouter(spawn, cfg, replicas=replicas, registry=reg,
                                     fault_plan=p.faults.FaultPlan())
    return router, procs, reg


def ready_count(p, router):
    return sum(s == p.fleet.READY for s in router.states().values())


# ---------------------------------------------------------------------------
# 1. the lease table
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", PKGS)
def test_lease_heartbeat_exactly_at_expiry_renews(name):
    """A beat exactly on the deadline renews (the deadline slides); one
    tick past it is expired and leaves the lease as it was."""
    t = pkg(name).cluster.LeaseTable(ttl_s=1.0)
    assert t.register("r1", "127.0.0.1", 9999, 1, 42, now=100.0) == (True, 1)
    assert t.heartbeat("r1", 1, True, now=101.0) == "renewed"
    lease = t.get("r1")
    assert lease.deadline == 102.0 and lease.ready
    assert t.heartbeat("r1", 1, True, now=102.0 + 1e-9) == "expired"
    assert not t.alive("r1", now=102.0 + 1e-9)
    assert t.alive("r1", now=102.0)


@pytest.mark.parametrize("name", PKGS)
def test_lease_epoch_fencing(name):
    """An older epoch's register or beat is refused with the table's epoch;
    an unknown replica's beat is told to register."""
    t = pkg(name).cluster.LeaseTable(ttl_s=1.0)
    assert t.register("r1", "h", 1, 3, 0, now=0.0) == (True, 3)
    assert t.register("r1", "h", 1, 2, 0, now=0.5) == (False, 3)
    assert t.heartbeat("r1", 2, True, now=0.5) == "stale"
    assert t.register("r1", "h", 1, 4, 0, now=0.5) == (True, 4)
    assert t.heartbeat("r1", 4, True, now=0.9) == "renewed"
    assert t.heartbeat("ghost", 1, True, now=0.9) == "unknown"
    t.drop("r1")
    assert t.heartbeat("r1", 4, True, now=1.0) == "unknown"
    rows = t.snapshot(now=1.0)
    assert rows == []


# ---------------------------------------------------------------------------
# 2. the wire codec and the idempotency cache
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", PKGS)
def test_wire_codec_request_roundtrip(name):
    p = pkg(name)
    r = req(p, 0, p_control=1.25, d_control=np.linspace(0.5, 2.0, 8).astype(np.float32))
    d = p.cluster.encode_request(r)
    assert "arrival" not in d  # monotonic stamps do not transfer
    back = p.cluster.decode_request(d)
    assert back.id == r.id and back.p_control == 1.25
    np.testing.assert_array_equal(back.sequence, r.sequence)
    np.testing.assert_array_equal(back.ref_mel, r.ref_mel)
    np.testing.assert_array_equal(back.d_control, r.d_control)
    back.ref_mel[0, 0] = 7.0  # writable (the pool's staging writes)


@pytest.mark.parametrize("name", PKGS)
def test_wire_codec_result_roundtrip_duck_typed(name):
    p = pkg(name)
    mel = np.random.default_rng(1).standard_normal((6, 80)).astype(np.float32)
    full = SimpleNamespace(id="a", mel=mel, mel_len=6, src_len=3,
                           bucket=SimpleNamespace(b=1, l_src=8, t_mel=16))
    out_full = p.cluster.decode_result(p.cluster.encode_result(full), served_by="h:1")
    out_sparse = p.cluster.decode_result(p.cluster.encode_result(SimpleNamespace(id="b")))
    np.testing.assert_array_equal(out_full.mel, mel)
    assert out_full.mel_len == 6 and out_full.served_by == "h:1"
    assert (out_full.bucket.b, out_full.bucket.l_src, out_full.bucket.t_mel) == (1, 8, 16)
    assert out_sparse.id == "b" and out_sparse.bucket is None
    assert out_sparse.mel.size == 0 and out_sparse.wav is None


@pytest.mark.parametrize("name", PKGS)
def test_batch_key_stable_and_membership_sensitive(name):
    p = pkg(name)
    a = [req(p, 1), req(p, 2)]
    key = p.cluster.batch_key
    assert key(a) == key(list(a)) and len(key(a)) == 32
    assert key(a) != key([req(p, 1)])
    assert key(a) != key([req(p, 2), req(p, 1)])


@pytest.mark.parametrize("name", PKGS)
def test_idempotency_cache_dedupes_and_evicts(name):
    """The duplicate leg is a cache lookup, never a second run; the LRU
    cache is bounded."""
    p = pkg(name)
    eng = CountingEngine()
    srv = p.cluster.ReplicaServer(eng, "r1", "127.0.0.1:9",
                                  p.config.ClusterConfig(idempotency_cache=2))
    try:
        body = {"key": "k1", "requests": [p.cluster.encode_request(req(p, 1))]}
        code, first = srv._handle_dispatch(body)
        assert code == 200 and first["idempotent"] is False
        code, dup = srv._handle_dispatch(body)
        assert code == 200 and dup["idempotent"] is True and dup["results"][0]["id"] == "q1"
        assert eng.runs == ["q1"] and srv._idem_hits.value == 1
        for k, i in (("k2", 2), ("k3", 3)):
            srv._handle_dispatch({"key": k, "requests": [p.cluster.encode_request(req(p, i))]})
        assert srv._idem_evict.value == 1
        code, rerun = srv._handle_dispatch(body)
        assert rerun["idempotent"] is False and eng.runs.count("q1") == 2
    finally:
        srv._httpd.server_close()


@pytest.mark.parametrize("name", PKGS)
def test_idempotency_duplicate_leg_parks_during_execution(name):
    """A duplicate leg arriving while the first still runs parks on the
    in-flight claim and answers from the cache: one run."""
    p = pkg(name)
    eng = CountingEngine(stall_s=5.0, stall_ids=("q1",))
    srv = p.cluster.ReplicaServer(eng, "r1", "127.0.0.1:9", p.config.ClusterConfig())
    try:
        body = {"key": "k1", "requests": [p.cluster.encode_request(req(p, 1))]}
        out = {}
        t = threading.Thread(target=lambda: out.update(first=srv._handle_dispatch(body)))
        t.start()
        assert wait_for(lambda: "k1" in srv._inflight, 2.0)
        t2 = threading.Thread(target=lambda: out.update(dup=srv._handle_dispatch(body)))
        t2.start()
        time.sleep(0.05)
        eng.unstall.set()
        t.join(timeout=5)
        t2.join(timeout=5)
        assert out["first"][1]["idempotent"] is False and out["dup"][1]["idempotent"] is True
        assert eng.runs == ["q1"] and srv._inflight == {}
    finally:
        eng.unstall.set()
        srv._httpd.server_close()


# ---------------------------------------------------------------------------
# 3. the cluster end to end over real HTTP
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", PKGS)
def test_cluster_dispatch_quorum_and_stale_register(name):
    """Dispatches cross the wire with ``served_by`` stamped; ``ready()`` is
    quorum-gated; a stale-epoch registration is answered 409 with the
    fencing epoch."""
    p = pkg(name)
    router, procs, _ = make_cluster(p, replicas=1, quorum=2)
    try:
        assert router.wait_ready(timeout=TIMEOUT, n=1)
        assert router.ready() is False
        router.scale_to(2)
        assert router.wait_ready(timeout=TIMEOUT, n=2)
        assert router.ready() is True
        futs = [router.submit(req(p, i)) for i in range(4)]
        assert all(f.result(timeout=TIMEOUT).served_by for f in futs)
        rows = router.cluster_stats()
        assert len(rows) == 2
        for row in rows:
            assert row["ready"] and not row["expired"] and not row["partitioned"]
            assert "lease_age_s" in row and "last_heartbeat_s" in row
        host, _, port = router.control_addr.rpartition(":")
        code, body = p.cluster._post_json(host, int(port), "/register", {
            "replica_id": rows[0]["replica_id"], "host": "127.0.0.1", "port": 1, "epoch": 0,
            "pid": 0}, timeout=2.0)
        assert code == 409 and body["epoch"] >= 1
    finally:
        router.close()
    assert all(proc.poll() is not None for proc in procs.values())


@pytest.mark.parametrize("name", PKGS)
def test_lease_expiry_mid_dispatch_requeues_not_duplicates(name):
    """A lease expiring under an in-flight dispatch steals the batch and
    requeues it; the stalled replica's late answer is discarded, so the
    client gets one result, from the other replica."""
    p = pkg(name)
    armed = {"on": True, "lock": threading.Lock()}
    engines = {}

    def factory(rid):
        engines[rid] = StallOnce("q100", armed, 30.0)
        return engines[rid]

    router, procs, reg = make_cluster(p, replicas=2, engine_factory=factory)
    try:
        assert router.wait_ready(timeout=TIMEOUT, n=2)
        fut = router.submit(req(p, 100))
        assert wait_for(lambda: any(r.inflight for r in router._replicas), 5)
        stalled = next(r.engine.replica_id for r in router._replicas if r.inflight)
        addr = f"{procs[stalled].server.host}:{procs[stalled].server.port}"
        router.partition(stalled)
        result = fut.result(timeout=TIMEOUT)
        assert result.served_by != addr
        assert reg.value("serve_lease_expired_total") == 1
        assert reg.histogram("serve_lease_requeue_seconds").count >= 1
        procs[stalled].engine.unstall.set()
        time.sleep(0.3)
        assert fut.result(timeout=1).served_by != addr
        assert sum(e.runs.count("q100") for r, e in engines.items() if r != stalled) == 1
    finally:
        for proc in procs.values():
            proc.engine.unstall.set()
        router.close()


@pytest.mark.parametrize("name", PKGS)
def test_partition_heal_readmits_same_process_via_half_open(name):
    """A partitioned replica fails on its lease, its live process becomes
    an orphan, and after the heal the breaker's trial adopts it: no new
    process, a higher epoch."""
    p = pkg(name)
    router, procs, _ = make_cluster(p, replicas=2, quorum=2)
    try:
        assert router.wait_ready(timeout=TIMEOUT, n=2)
        target = router._replicas[0].engine.replica_id
        epoch_before = router.leases.get(target).epoch
        router.partition(target)
        assert wait_for(lambda: p.fleet.FAILED in router.states().values(), TIMEOUT)
        assert router.ready() is False
        spawned = len(procs)
        router.heal(target)
        assert wait_for(lambda: ready_count(p, router) >= 2, TIMEOUT)
        assert router.ready() is True
        assert len(procs) == spawned
        assert router.leases.get(target).epoch > epoch_before
        futs = [router.submit(req(p, 200 + i)) for i in range(3)]
        assert all(f.result(timeout=TIMEOUT).served_by for f in futs)
    finally:
        router.close()


@pytest.mark.parametrize("name", PKGS)
def test_chaos_proc_kill_loses_zero_requests(name):
    """``replica_proc_kill`` kills a process mid-dispatch; every request
    still completes, and the fleet comes back to strength through one
    respawn."""
    p = pkg(name)
    router, procs, _ = make_cluster(p, replicas=2, quorum=2)
    try:
        assert router.wait_ready(timeout=TIMEOUT, n=2)
        for f in [router.submit(req(p, i)) for i in range(4)]:
            f.result(timeout=TIMEOUT)
        router.fault_plan.arm("replica_proc_kill", router.dispatch_total + 1)
        futs = [router.submit(req(p, 100 + i)) for i in range(8)]
        assert all(f.result(timeout=TIMEOUT).served_by for f in futs)
        assert sum(proc.poll() is not None for proc in procs.values()) == 1
        assert wait_for(lambda: ready_count(p, router) >= 2, TIMEOUT)
        assert len(procs) == 3
    finally:
        router.close()


@pytest.mark.parametrize("name", PKGS)
def test_hedge_fires_on_slow_primary_and_second_host_wins(name):
    """A slow first leg is hedged to another host after the hedge delay;
    the hedge wins and both counters show it."""
    p = pkg(name)
    armed = {"on": True, "lock": threading.Lock()}
    engines = {}

    def factory(rid):
        engines[rid] = StallOnce("q500", armed, 5.0)
        return engines[rid]

    router, procs, reg = make_cluster(p, replicas=2, engine_factory=factory, hedge_quantile=0.95,
                                      hedge_min_ms=50.0, hedge_max_ms=150.0)
    try:
        assert router.wait_ready(timeout=TIMEOUT, n=2)
        fut = router.submit(p.engine.SynthesisRequest(
            id="q500", sequence=np.ones(8, np.int32), ref_mel=np.zeros((4, 80), np.float32)))
        assert fut.result(timeout=TIMEOUT).served_by
        assert reg.value("serve_hedge_fired_total", {"class": "interactive"}) == 1
        assert reg.value("serve_hedge_won_total", {"class": "interactive"}) == 1
    finally:
        for proc in procs.values():
            proc.engine.unstall.set()
        router.close()


# ---------------------------------------------------------------------------
# 4. what other parts read
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", PKGS)
def test_server_stats_aggregates_cluster_block(name):
    p = pkg(name)
    router, procs, _ = make_cluster(p, replicas=1, quorum=1)
    server = None
    try:
        assert router.wait_ready(timeout=TIMEOUT, n=1)
        server = p.server.SynthesisServer(router=router, host="127.0.0.1", port=0)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        stats = server.stats()
        assert stats["ready"] is True
        cluster = stats["cluster"]
        assert cluster["quorum"] == 1 and cluster["control_addr"] == router.control_addr
        row = cluster["replicas"][0]
        assert row["ready"] and not row["partitioned"] and ":" in row["host"]
    finally:
        if server is not None:
            server.shutdown()
        else:
            router.close()


@pytest.mark.parametrize("name", PKGS)
def test_autoscaler_respects_cluster_scale_floor(name):
    """The router's quorum is the autoscaler's hard floor: an under-quorum
    fleet is corrected up at once, and calm never drains below it."""
    p = pkg(name)
    calls = []
    fake = SimpleNamespace(
        registry=p.obs.MetricsRegistry(), events=None, fleet=SimpleNamespace(queue_depth=64),
        scale_floor=2, rollout_active=False, live_replica_count=lambda: 1,
        pending_depth=lambda: 0, occupancy=lambda: 0.0, warmup_cost_s=lambda: None,
        scale_to=lambda n: calls.append(n))
    a = p.autoscale.Autoscaler(fake, p.config.AutoscaleConfig(enabled=True, min_replicas=1,
                                                              max_replicas=4), start=False)
    assert a.step(now=100.0) == "min_bound" and calls == [2]
    fake.live_replica_count = lambda: 2
    for t in range(200, 2000, 100):
        assert a.step(now=float(t)) is None
    assert calls == [2]


@pytest.mark.parametrize("name", PKGS)
def test_remote_engine_surface_matches_router_contract(name):
    """No vocoder (streams stay in-process), compile_count from /healthz,
    is_ready tied to the lease."""
    p = pkg(name)
    router, procs, _ = make_cluster(p, replicas=1, quorum=1)
    try:
        assert router.wait_ready(timeout=TIMEOUT, n=1)
        eng = router._replicas[0].engine
        assert eng.vocoder is None and eng.is_ready is True and eng.compile_count == 0
        router.partition(eng.replica_id)
        assert wait_for(lambda: not eng.is_ready, 5)
    finally:
        router.close()


# ---------------------------------------------------------------------------
# the port against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("direction", ["tpu_to_torch", "torch_to_tpu"])
def test_the_wire_crosses_packages(direction):
    """A request and a result encoded by one package decode in the other:
    arrays byte-equal (dtype and shape kept), scalars, the style vectors and
    the trace context the same, ``batch_key`` the same string, and the JSON
    the same bytes."""
    import json

    src, dst = (pkg("tpu"), pkg("torch")) if direction == "tpu_to_torch" else \
        (pkg("torch"), pkg("tpu"))
    rng = np.random.default_rng(7)
    reqs = []
    for i, (L, T) in enumerate(((7, 20), (5, 12))):
        sv = src.trace.new_context(f"t{i}")
        reqs.append(src.engine.SynthesisRequest(
            id=f"w{i}", sequence=rng.integers(1, 300, L).astype(np.int32),
            ref_mel=rng.standard_normal((T, 80)).astype(np.float32), speaker=i, raw_text="hi",
            p_control=1.5, d_control=rng.uniform(0.5, 2.0, L).astype(np.float32),
            style_degraded=bool(i), trace=sv))
    reqs[1].ref_mel = None
    reqs[1].style = src.style.StyleVectors(key="k", gamma=rng.standard_normal(16).astype(np.float32),
                                           beta=rng.standard_normal(16).astype(np.float32))
    wire = json.loads(json.dumps([src.cluster.encode_request(r) for r in reqs]))
    got = [dst.cluster.decode_request(d) for d in wire]
    assert src.cluster.batch_key(reqs) == dst.cluster.batch_key(got)
    for a, b in zip(reqs, got):
        assert (b.id, b.speaker, b.raw_text, b.style_degraded) == \
            (a.id, a.speaker, a.raw_text, a.style_degraded)
        for field in ("sequence", "ref_mel", "d_control"):
            x, y = getattr(a, field), getattr(b, field)
            assert (x is None) == (y is None)
            if x is not None:
                assert x.dtype == y.dtype and x.shape == y.shape and x.tobytes() == y.tobytes()
        assert b.p_control == a.p_control and b.e_control == a.e_control
        assert b.trace.as_dict() == a.trace.as_dict()
        assert (a.style is None) == (b.style is None)
        if a.style is not None:
            assert b.style.key == a.style.key
            assert b.style.gamma.tobytes() == a.style.gamma.tobytes()
            assert b.style.beta.tobytes() == a.style.beta.tobytes()
    # the wire forms the receiver writes back are the sender's
    assert json.dumps([dst.cluster.encode_request(r) for r in got], sort_keys=True) == \
        json.dumps(wire, sort_keys=True)
    # a result
    res = SimpleNamespace(
        id="w0", raw_text="hi", mel=rng.standard_normal((6, 80)).astype(np.float32), mel_len=6,
        wav=rng.integers(-3000, 3000, 24).astype(np.int16),
        durations=np.array([1, 2, 3], np.int32),
        pitch_prediction=rng.standard_normal(3).astype(np.float32),
        energy_prediction=rng.standard_normal(3).astype(np.float32), src_len=3,
        bucket=SimpleNamespace(b=4, l_src=16, t_mel=48), batch_rows=2, style_degraded=True)
    rwire = json.loads(json.dumps(src.cluster.encode_result(res)))
    out = dst.cluster.decode_result(rwire, served_by="h:9")
    for field in ("mel", "wav", "durations", "pitch_prediction", "energy_prediction"):
        x, y = getattr(res, field), getattr(out, field)
        assert x.dtype == y.dtype and x.shape == y.shape and x.tobytes() == y.tobytes()
    assert (out.mel_len, out.src_len, out.batch_rows, out.style_degraded, out.served_by) == \
        (6, 3, 2, True, "h:9")
    assert (out.bucket.b, out.bucket.l_src, out.bucket.t_mel) == (4, 16, 48)
    assert json.dumps(dst.cluster.encode_result(out), sort_keys=True) == \
        json.dumps(rwire, sort_keys=True)


@pytest.fixture(scope="module")
def real_engines(jax_weights, tmp_path_factory):  # noqa: F811
    """A port engine on the CPU over the JAX weights (the one-point lattice
    of ``tests/test_torch_server.py``) and the JAX engine over the same
    weights, with its Pallas kernels in interpret mode."""
    import jax

    from speakingstyle_tpu.configs.config import load_config as j_load
    from speakingstyle_tpu.models import hifigan as jh
    from speakingstyle_tpu.models.fastspeech2 import FastSpeech2 as JFS2
    from speakingstyle_tpu.ops import pallas_attention
    from speakingstyle_tpu.serving.engine import SynthesisEngine as JEngine
    from test_torch_server import GEN_TOPO, STATS, build_port_engine, write_configs

    tmp = tmp_path_factory.mktemp("cluster_engine")
    engine = build_port_engine(tmp, jax_weights)
    engine.precompile()
    variables, gparams = jax_weights
    jcfg = j_load(*write_configs(tmp))
    pallas_attention.FORCE_INTERPRET = True
    try:
        with jax.default_prng_impl("threefry2x32"):
            jengine = JEngine(jcfg, variables, vocoder=(jh.Generator(**GEN_TOPO), gparams),
                              model=JFS2(config=jcfg, **STATS))
            jengine.precompile()
    finally:
        pallas_attention.FORCE_INTERPRET = False
    return engine, jengine



def test_a_request_through_the_cluster_equals_the_engine_and_the_jax_engine(real_engines):
    """Three requests through a port ``ClusterRouter`` to a ``ReplicaServer``
    around a real port engine (in this process, over HTTP): each result
    equals that engine's ``run`` of the same request bit for bit (the wire
    is lossless), and is within the f32 bar of the JAX engine's ``run``
    (durations equal, mel 2e-4, wav 2 LSB)."""
    from speakingstyle_tpu.ops import pallas_attention
    from speakingstyle_tpu.serving.engine import SynthesisRequest as JRequest

    p = pkg("torch")
    engine, jengine = real_engines
    rng = np.random.default_rng(11)
    inputs = [(rng.integers(1, 300, L).astype(np.int32),
               rng.standard_normal((T, 80)).astype(np.float32)) for L, T in ((7, 20), (5, 12),
                                                                             (8, 30))]

    def port_req(i):
        s, r = inputs[i]
        return p.engine.SynthesisRequest(id=f"u{i}", sequence=s, ref_mel=r)

    want = [engine.run([port_req(i)])[0] for i in range(3)]
    pallas_attention.FORCE_INTERPRET = True
    try:
        jwant = [jengine.run([JRequest(id=f"u{i}", sequence=s, ref_mel=r)])[0]
                 for i, (s, r) in enumerate(inputs)]
    finally:
        pallas_attention.FORCE_INTERPRET = False
    cfg = engine.cfg
    ccfg = p.config.ClusterConfig(enabled=True, heartbeat_interval_s=0.1, hedge_quantile=0.0)
    import dataclasses

    cfg = dataclasses.replace(cfg, serve=dataclasses.replace(cfg.serve, cluster=ccfg))
    procs = {}

    def spawn(rid, router_addr, extra):
        procs[rid] = FakeProc(p, rid, router_addr, ccfg, engine=engine)
        return procs[rid]

    router = p.cluster.ClusterRouter(spawn, cfg, replicas=1)
    try:
        assert router.wait_ready(timeout=TIMEOUT, n=1)
        got = [router.submit(port_req(i)).result(timeout=120) for i in range(3)]
    finally:
        router.close()
    for g, w, jw in zip(got, want, jwant):
        addr = f"{procs['r1'].server.host}:{procs['r1'].server.port}"
        assert g.served_by == addr and g.replica == 0
        assert g.mel_len == w.mel_len > 0
        for field in ("mel", "wav", "durations", "pitch_prediction", "energy_prediction"):
            x, y = getattr(g, field), getattr(w, field)
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), field
        np.testing.assert_array_equal(g.durations, jw.durations)
        assert np.abs(g.mel - jw.mel).max() <= 2e-4
        assert np.abs(g.wav.astype(np.int32) - jw.wav.astype(np.int32)).max() <= 2


def test_a_replica_process_answers_and_drains_on_sigterm(tmp_path, corpus, monkeypatch):  # noqa: F811
    """``python -m speakingstyle_torch replica --device cpu`` spawned by the
    serve command's spawner against a port ``ClusterRouter``: it prepares
    its lattice, registers, answers a request over the wire, and on SIGTERM
    drains and exits 0 (the whole test within ``LIMIT_S``)."""
    import argparse
    import signal

    from speakingstyle_torch.cli.serve import replica_spawner
    from speakingstyle_torch.configs.config import load_config
    from test_torch_cli import seeded_checkpoint

    limit_s, t0 = 240.0, time.monotonic()
    left = lambda: max(1.0, limit_s - (time.monotonic() - t0))  # noqa: E731
    paths, model = seeded_checkpoint(tmp_path, corpus, 3)
    args = argparse.Namespace(preset=None, preprocess_config=paths["preprocess"],
                              model_config=paths["model"], train_config=paths["train"],
                              restore_step=3, device="cpu", seed=0, vocoder_ckpt=None,
                              griffin_lim=True)
    cfg = load_config(paths["preprocess"], paths["model"], paths["train"])
    import dataclasses

    p = pkg("torch")
    ccfg = p.config.ClusterConfig(enabled=True, heartbeat_interval_s=0.2, hedge_quantile=0.0,
                                  spawn_grace_s=limit_s)
    cfg = dataclasses.replace(cfg, serve=dataclasses.replace(
        cfg.serve, cluster=ccfg, fleet=dataclasses.replace(cfg.serve.fleet, drain_timeout_s=30.0)))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    router = p.cluster.ClusterRouter(replica_spawner(args), cfg, replicas=1)
    try:
        assert router.wait_ready(timeout=left(), n=1), router.states()
        (rid, proc), = router.processes().items()
        row = router.cluster_stats()[0]
        assert row["pid"] == proc.pid and row["ready"]
        r = p.engine.SynthesisRequest(id="p0", sequence=np.arange(1, 9, dtype=np.int32),
                                      ref_mel=np.random.default_rng(0).standard_normal(
                                          (40, 80)).astype(np.float32))
        got = router.submit(r).result(timeout=left())
        assert got.served_by == row["host"] and got.mel_len > 0 and got.wav is None
        assert np.isfinite(got.mel).all() and got.mel.shape == (got.mel_len, 80)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=left()) == 0
    finally:
        router.close()
    assert all(proc.poll() is not None for proc in router.processes().values())


def test_a_drained_replica_process_is_stopped_and_an_orphan_kept():
    """The port retires a replica's process when the fleet retires its
    engine (``scale_to`` shrinking it away), and keeps a failed replica's
    live process for adoption."""
    p = pkg("torch")
    router, procs, _ = make_cluster(p, replicas=2, quorum=1)
    try:
        assert router.wait_ready(timeout=TIMEOUT, n=2)
        ids = sorted(procs)
        router.scale_to(1)
        assert wait_for(lambda: procs[ids[1]].poll() is not None, TIMEOUT)
        assert procs[ids[0]].poll() is None and ids[1] not in router.processes()
        # a failed replica's live process stays, an orphan to adopt
        router.partition(ids[0])
        assert wait_for(lambda: p.fleet.FAILED in router.states().values(), TIMEOUT)
        time.sleep(0.3)
        assert procs[ids[0]].poll() is None and ids[0] in router._orphan_ids
    finally:
        router.close()
    assert all(proc.poll() is not None for proc in procs.values())


def test_a_sigterm_drain_lets_the_dispatch_in_flight_finish():
    """``drain()`` refuses new dispatches (503, not ready) while the one in
    flight finishes; ``wait_idle`` returns once it has."""
    p = pkg("torch")
    eng = CountingEngine(stall_s=5.0, stall_ids=("q1",))
    srv = p.cluster.ReplicaServer(eng, "r1", "127.0.0.1:9", p.config.ClusterConfig())
    try:
        out = {}
        body = {"key": "k1", "requests": [p.cluster.encode_request(req(p, 1))]}
        t = threading.Thread(target=lambda: out.update(first=srv._handle_dispatch(body)))
        t.start()
        assert wait_for(lambda: "k1" in srv._inflight, 2.0)
        srv.drain()
        code, _ = srv._handle_dispatch({"key": "k2",
                                        "requests": [p.cluster.encode_request(req(p, 2))]})
        assert code == 503 and srv._handle_healthz({})[0] == 503
        assert srv.wait_idle(0.05) is False
        eng.unstall.set()
        assert srv.wait_idle(5.0) is True
        t.join(timeout=5)
        assert out["first"][0] == 200 and eng.runs == ["q1"]
        assert srv._handle_dispatch({"key": "k3", "requests": []})[0] == 503
    finally:
        eng.unstall.set()
        srv._httpd.server_close()


def test_the_serve_command_serves_the_cluster_and_stops_its_replicas(tmp_path, corpus):  # noqa: F811
    """``python -m speakingstyle_torch serve --replicas 2 --cluster --device
    cpu``: /healthz answers 503 until the quorum and then carries the
    cluster block (a lease row a replica process, with its pid), a request
    answers 200 with ``X-Served-By`` naming a replica, the federated
    ``fleet_*`` section rides /metrics, a stream answers 400, and on SIGTERM
    the command exits 0 with every replica process it spawned gone. The
    command runs in a session of its own, killed whole if the test fails."""
    import http.client
    import json
    import os
    import queue
    import signal
    import subprocess
    import sys

    from test_torch_cli import _ref_wav, seeded_checkpoint

    paths, _ = seeded_checkpoint(tmp_path, corpus, 3)
    ref = _ref_wav(tmp_path / "ref.wav", seconds=0.3)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen(
        [sys.executable, "-m", "speakingstyle_torch", "serve", "-p", paths["preprocess"],
         "-m", paths["model"], "-t", paths["train"], "--restore_step", "3", "--device", "cpu",
         "--griffin_lim", "--ref_audio", ref, "--host", "127.0.0.1", "--port", "0",
         "--replicas", "2", "--cluster"],
        cwd=repo, env=dict(os.environ, PYTHONPATH=repo, OMP_NUM_THREADS="1"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, start_new_session=True)
    lines = queue.Queue()
    reader = threading.Thread(target=lambda: [lines.put(l) for l in proc.stdout], daemon=True)
    reader.start()
    out, pids, address = [], set(), None

    def call(method, path, body=None):
        conn = http.client.HTTPConnection(*address, timeout=120)
        try:
            conn.request(method, path, body=json.dumps(body) if body is not None else None)
            resp = conn.getresponse()
            return resp.status, dict(resp.getheaders()), resp.read()
        finally:
            conn.close()

    try:
        deadline = time.monotonic() + 180
        while address is None and time.monotonic() < deadline and proc.poll() is None:
            try:
                line = lines.get(timeout=1.0)
            except queue.Empty:
                continue
            out.append(line)
            if line.startswith("serving on http://"):
                host, port = line.split("http://", 1)[1].split(" ", 1)[0].rsplit(":", 1)
                address = (host, int(port))
        assert address is not None, "".join(out)
        statuses = []
        assert wait_for(lambda: statuses.append(call("GET", "/healthz")) or
                        statuses[-1][0] == 200, 180, 0.2)
        health = json.loads(statuses[-1][2])
        rows = health["cluster"]["replicas"]
        pids = {r["pid"] for r in rows}
        assert health["cluster"]["quorum"] == 1 and pids
        assert all(st == 503 for st, _, _ in statuses[:-1])
        status, headers, body = call("POST", "/synthesize",
                                     {"text": "hello world", "priority": "batch"})
        assert status == 200, body
        assert headers["X-Served-By"] in {r["host"] for r in rows}
        assert json.loads(body)["mel_len"] > 0
        assert call("POST", "/synthesize/stream", {"text": "hello world"})[0] == 400
        assert wait_for(lambda: b"fleet_serve_wire_dispatches_total" in
                        call("GET", "/metrics")[2], 30)
        rows = json.loads(call("GET", "/healthz")[2])["cluster"]["replicas"]
        pids |= {r["pid"] for r in rows}
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=120) == 0
        reader.join(timeout=60)
        while not lines.empty():
            out.append(lines.get())
    finally:
        if proc.poll() is None or not wait_for(lambda: not any(_alive(p) for p in pids), 30):
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            proc.wait(timeout=60)
    text = "".join(out)
    assert "cluster control plane on http://" in text and "warming 2 replica processes" in text
    assert not any(_alive(p) for p in pids)


def _alive(pid):
    """True while ``pid`` runs (a zombie counts as gone)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] not in ("Z", "X")
    except OSError:
        return False
