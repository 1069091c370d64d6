"""PyTorch port, the tracing and SLO planes (obs/trace.py, obs/slo.py,
obs/buildinfo.py) against the JAX package's modules on identical inputs:
the span ring, trace assembly and its critical path, and
the SLO engine's burn rates, gauges, alerts and events. Then a request's
span tree through the port's server and engine at a tiny size, and
nothing recorded while tracing is disarmed.
"""

import json
import threading

import numpy as np
import pytest
import torch


def span_records(seed, n_traces=4, per_trace=9):
    """Span dicts of a few traces: each span parents a random earlier one
    of its trace (some parents missing), wall starts and durations drawn
    from a seed."""
    rng = np.random.default_rng(seed)
    out = []
    for t in range(n_traces):
        ids = []
        for i in range(per_trace):
            sid = f"s{t}-{i}"
            parent = None
            if ids and rng.random() < 0.85:
                parent = ids[int(rng.integers(0, len(ids)))]
            elif ids:
                parent = "gone"  # a parent evicted from the ring
            rec = {"name": f"op{int(rng.integers(0, 5))}", "trace_id": f"t{t}", "span_id": sid,
                   "parent_span_id": parent, "start_ts": float(rng.uniform(0, 10)),
                   "duration_s": float(rng.uniform(0, 3))}
            if rng.random() < 0.3:
                rec["fields"] = {"rows": int(rng.integers(1, 5))}
            if rng.random() < 0.2:
                rec["ok"] = False
            out.append(rec)
            ids.append(sid)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_assemble_trace_and_critical_path_match_jax(seed):
    from speakingstyle_tpu.obs import trace as jt
    from speakingstyle_torch.obs import trace as tt

    spans = span_records(seed)
    for tid in ("t0", "t1", "t2", "t3", "absent"):
        assert tt.assemble_trace(spans, tid) == jt.assemble_trace(spans, tid)
    roots = [s for s in spans if s["trace_id"] == "t1" and s["parent_span_id"] in (None, "gone")]
    children = {}
    for s in spans:
        if s["trace_id"] == "t1" and s["parent_span_id"] not in (None, "gone"):
            children.setdefault(s["parent_span_id"], []).append(s)
    assert tt.critical_path(roots, children) == jt.critical_path(roots, children)


def test_span_ring_matches_jax():
    """The same adds, pins and reads on both rings (capacity 7, keep 2):
    the spans per trace, the kept traces, the stats."""
    from speakingstyle_tpu.obs import trace as jt
    from speakingstyle_torch.obs import trace as tt

    spans = span_records(3, n_traces=5, per_trace=4)
    rings = {"jax": jt.SpanRing(capacity=7, keep_traces=2),
             "torch": tt.SpanRing(capacity=7, keep_traces=2)}
    reads = {k: [] for k in rings}
    for i, rec in enumerate(spans):
        for k, ring in rings.items():
            ring.add(dict(rec))
            if i % 5 == 4:
                ring.pin(rec["trace_id"])
            reads[k].append((ring.spans(rec["trace_id"]), ring.kept_trace_ids(), ring.stats(),
                             ring.last_pinned_trace_id))
    assert reads["torch"] == reads["jax"]
    assert rings["torch"].spans() == rings["jax"].spans()
    with pytest.raises(ValueError):
        tt.SpanRing(capacity=0)


class Recorder:
    """A stand-in event log: the emitted (event, fields) in order."""

    def __init__(self):
        self.records = []

    def emit(self, event, **fields):
        self.records.append((event, fields))


def test_slo_engine_matches_jax():
    """Both SLO engines over the same counter history (per class:
    admissions, misses, 504s, sheds, quality checks and failures) and
    the same explicit clock: equal alerting states, burn rates, status
    blocks, gauges, alert counters and events, through an alert and its
    resolution."""
    from speakingstyle_tpu.configs.config import SloConfig as JCfg
    from speakingstyle_tpu.obs import MetricsRegistry as JReg
    from speakingstyle_tpu.obs.slo import SloEngine as JSlo
    from speakingstyle_tpu.obs.trace import SpanRing as JRing
    from speakingstyle_torch.configs.config import SloConfig as TCfg
    from speakingstyle_torch.obs import MetricsRegistry as TReg
    from speakingstyle_torch.obs.slo import SloEngine as TSlo
    from speakingstyle_torch.obs.trace import SpanRing as TRing

    kw = dict(fast_window_s=30.0, slow_window_s=120.0, tick_s=5.0)
    sides = {}
    for name, (cfg, reg, slo, ring) in {"jax": (JCfg, JReg, JSlo, JRing),
                                        "torch": (TCfg, TReg, TSlo, TRing)}.items():
        r, events, trace_ring = reg(), Recorder(), ring()
        trace_ring.add({"trace_id": "bad-1", "span_id": "x"})
        trace_ring.pin("bad-1")
        sides[name] = (r, events, slo(r, cfg(**kw), events=events, trace_ring=trace_ring,
                                      start=False))
    rng = np.random.default_rng(9)
    history = {k: [] for k in sides}
    for tick in range(60):
        # a burst of misses and quality failures in the middle
        bad = 8 < tick < 30
        deltas = {
            "serve_class_requests_total": rng.integers(20, 40),
            "serve_deadline_miss_total": rng.integers(3, 9) if bad else rng.integers(0, 2),
            "serve_deadline_exceeded_total": rng.integers(0, 3) if bad else 0,
            "serve_class_shed_total": rng.integers(0, 2),
            "serve_quality_class_total": rng.integers(10, 20),
            "serve_quality_class_fail_total": rng.integers(1, 4) if bad else 0,
        }
        klass = ["interactive", "batch", "probe"][tick % 3]
        for name, (r, _, engine) in sides.items():
            for metric, d in deltas.items():
                r.counter(metric, labels={"class": klass}).inc(float(d))
            alerting = engine.step(now=1000.0 + 5.0 * tick)
            history[name].append((alerting, engine.status(), engine.quality_status(),
                                   engine.quality_alerting(),
                                   engine.burn_rate("interactive", "fast"),
                                   engine.quality_burn_rate("batch", "slow")))
    assert history["torch"] == history["jax"]
    (jr, je, _), (tr, te, _) = sides["jax"], sides["torch"]
    assert te.records == je.records
    assert {e for e, _ in te.records} >= {"slo_alert", "slo_resolved", "slo_quality_alert"}
    assert te.records[0][1]["trace_id"] == "bad-1"
    for family in ("serve_slo_burn_rate", "serve_slo_quality_burn_rate", "serve_slo_alerts_total",
                   "serve_slo_quality_alerts_total"):
        got = sorted((m.labels, m.value) for m in tr.metrics_named(family))
        want = sorted((m.labels, m.value) for m in jr.metrics_named(family))
        assert got == want and got


def test_slo_engine_thread_closes():
    """The engine's own loop thread stops on close."""
    from speakingstyle_torch.configs.config import SloConfig
    from speakingstyle_torch.obs import MetricsRegistry
    from speakingstyle_torch.obs.slo import SloEngine

    engine = SloEngine(MetricsRegistry(), SloConfig(tick_s=0.01, fast_window_s=1.0,
                                                    slow_window_s=2.0))
    thread = engine._thread
    engine.close()
    assert thread is not None and not thread.is_alive()


def test_buildinfo_identity():
    """``array_sha256`` of float32 leaves equals the JAX package's for the
    same values; the state-dict digest is stable across a save and
    restore and moves when any single element changes; build_info names
    the torch stack."""
    from speakingstyle_tpu.obs.buildinfo import array_sha256 as j_sha
    from speakingstyle_torch.obs import array_sha256, build_info, process_rss_bytes, weights_digest

    rng = np.random.default_rng(1)
    for shape in [(3,), (4, 5), (2, 3, 4)]:
        a = rng.standard_normal(shape).astype(np.float32)
        assert array_sha256(torch.from_numpy(a)) == array_sha256(a) == j_sha(a)
    scalar = np.array(2.5, np.float32)
    assert array_sha256(torch.from_numpy(scalar)) == array_sha256(scalar)

    torch.manual_seed(0)
    block = torch.nn.Sequential(torch.nn.Linear(6, 5), torch.nn.LayerNorm(5),
                                torch.nn.BatchNorm1d(5))
    state = block.state_dict()
    digest = weights_digest(state)
    import io

    buf = io.BytesIO()
    torch.save(state, buf)
    buf.seek(0)
    assert weights_digest(torch.load(buf, weights_only=True)) == digest
    assert weights_digest(dict(reversed(list(state.items())))) == digest
    for name, t in state.items():
        if not t.is_floating_point() or t.numel() == 0:
            continue
        changed = {k: v.clone() for k, v in state.items()}
        flat = changed[name].view(-1)
        flat[int(rng.integers(0, flat.numel()))] += 1.0
        assert weights_digest(changed) != digest, name
    info = build_info()
    assert info["torch"] == torch.__version__ and info["backend"] in ("cpu", "cuda")
    assert info["device_count"] >= 1 and "jax" not in info
    assert process_rss_bytes() > 0


# -- a request's span tree through the server ----------------------------------

@pytest.fixture(scope="module")
def tiny_server():
    """A port server on a tiny engine (CPU, random weights, one-point
    lattice), frontend pool of 2, bound to port 0."""
    from test_torch_server import build_port_engine
    from speakingstyle_torch.serving.frontend import TextFrontend
    from speakingstyle_torch.serving.server import SynthesisServer

    engine = build_port_engine()
    engine.precompile()
    ref = np.random.default_rng(0).standard_normal((20, 80)).astype(np.float32)
    server = SynthesisServer(engine, TextFrontend(engine.cfg, ref), host="127.0.0.1", port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield server
    server.shutdown()
    thread.join(timeout=30)


def _post(server, path, payload, headers=None):
    import http.client

    host, port = server.address[:2]
    conn = http.client.HTTPConnection(host, port, timeout=60)
    try:
        conn.request("POST", path, body=json.dumps(payload), headers=headers or {})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def _tree(node):
    return (node["name"], sorted(_tree(c) for c in node["children"]))


def test_request_span_tree(tiny_server):
    """One /synthesize request's spans: the ``serve_request`` root with the
    frontend and the engine's run under it, the acoustic and vocode split
    under the run (host clock on the CPU); a stream adds one
    ``vocode_window`` per window."""
    from speakingstyle_torch.obs.trace import get_span_ring, set_tracing_enabled

    set_tracing_enabled(True)
    status, headers, _ = _post(tiny_server, "/synthesize", {"text": "hello there"},
                               {"X-Trace-Id": "trace-a"})
    assert status == 200 and headers["X-Trace-Id"] == "trace-a"
    view = tiny_server.trace_view("trace-a")
    assert [_tree(r) for r in view["roots"]] == [
        ("serve_request", [("engine_run", [("engine_acoustic", []), ("engine_vocode", [])]),
                           ("serve_frontend", [])])]
    spans = {s["name"]: s for s in get_span_ring().spans("trace-a")}
    run = spans["engine_run"]
    assert spans["engine_acoustic"]["parent_span_id"] == run["span_id"]
    assert spans["engine_acoustic"]["fields"]["clock"] == "host"
    # the children start at host times inside the run: the vocoder's when
    # it was enqueued, after the acoustic model's readback
    acoustic, vocode = spans["engine_acoustic"], spans["engine_vocode"]
    assert run["start_ts"] <= acoustic["start_ts"] < vocode["start_ts"] \
        <= run["start_ts"] + run["duration_s"]
    assert run["fields"]["rows"] == 1 and run["fields"]["bucket"].startswith("b1.")
    assert view["critical_path"][0]["name"] == "serve_request"

    status, _, _ = _post(tiny_server, "/synthesize/stream", {"text": "hello there"},
                         {"X-Trace-Id": "trace-b"})
    assert status == 200
    names = [s["name"] for s in get_span_ring().spans("trace-b")]
    assert names.count("vocode_window") >= 1 and "engine_vocode" not in names

    import http.client

    host, port = tiny_server.address[:2]
    conn = http.client.HTTPConnection(host, port, timeout=60)
    try:
        conn.request("GET", "/debug/spans")
        ring = json.loads(conn.getresponse().read())
        conn.request("GET", "/debug/trace/trace-a")
        assembled = json.loads(conn.getresponse().read())
    finally:
        conn.close()
    assert {"trace-a", "trace-b"} <= {s["trace_id"] for s in ring["spans"]}
    assert ring["stats"]["spans"] == len(ring["spans"])
    assert assembled == json.loads(json.dumps(view))


def test_nested_spans_parent_on_their_thread():
    """A Span opened with a trace id roots a trace; a Span opened inside it
    on the same thread parents under it; another thread sees no context."""
    from speakingstyle_torch.obs.trace import Span, SpanRing, current_context

    ring = SpanRing(capacity=16)
    seen = []
    with Span("outer", ring=ring, trace_id="t-nest") as outer:
        assert current_context() is outer.ctx
        with Span("inner", ring=ring) as inner:
            other = threading.Thread(target=lambda: seen.append(current_context()))
            other.start()
            other.join(timeout=30)
    assert current_context() is None and seen == [None]
    assert outer.ctx.parent_span_id is None and outer.ctx.trace_id == "t-nest"
    assert inner.ctx.parent_span_id == outer.ctx.span_id
    assert [s["name"] for s in ring.spans("t-nest")] == ["inner", "outer"]


def test_git_sha_stays_inside_its_tree():
    """``git_sha`` answers only for a tree with its own ``.git``: a
    directory inside a repository (as an exported copy would sit) gets
    None, not the enclosing repository's HEAD."""
    import os
    import subprocess

    from speakingstyle_torch.obs.buildinfo import git_sha

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    inner = os.path.join(root, "speakingstyle_torch")
    assert git_sha(inner) is None
    if os.path.exists(os.path.join(root, ".git")):
        head = subprocess.run(["git", "rev-parse", "HEAD"], capture_output=True, text=True,
                              cwd=root, timeout=30)
        assert git_sha(root) == (head.stdout.strip() if head.returncode == 0 else None)
    else:
        assert git_sha(root) is None


def test_nothing_recorded_when_disarmed(tiny_server, monkeypatch):
    """Disarmed, a request adds no span to the ring and the engine records
    no stage marks."""
    from speakingstyle_torch.obs import trace

    ring = trace.get_span_ring()
    trace.set_tracing_enabled(False)
    try:
        before = ring.stats()["spans"] + ring.stats()["evictions"]
        calls = []
        monkeypatch.setattr(type(tiny_server.engine), "_record_spans",
                            staticmethod(lambda *a, **k: calls.append(a)))
        status, _, _ = _post(tiny_server, "/synthesize", {"text": "quiet please"},
                             {"X-Trace-Id": "trace-off"})
        assert status == 200
        assert ring.stats()["spans"] + ring.stats()["evictions"] == before
        assert ring.spans("trace-off") == [] and calls == []
    finally:
        trace.set_tracing_enabled(True)


@pytest.mark.parametrize("rate", [0.0, 0.1, 0.37, 1.0])
def test_tail_sampler_matches_jax(rate):
    """The healthy-traffic dice (crc32 of the trace id) keep the same
    traces as the JAX sampler at each rate, every keep reason is kept, and
    the counts agree; a rate outside [0, 1] is refused by both."""
    from speakingstyle_tpu.obs import trace as jt
    from speakingstyle_torch.obs import trace as tt

    ids = [f"req{i:08d}" for i in range(400)] + ["é-trace", ""]
    j, t = jt.TailSampler(rate), tt.TailSampler(rate)
    assert [t.keep(i) for i in ids] == [j.keep(i) for i in ids]
    for reason in jt.TailSampler.KEEP_REASONS + ("healthy", None):
        assert t.keep("req00000001", reason) == j.keep("req00000001", reason)
    assert (t.kept, t.sampled_out) == (j.kept, j.sampled_out)
    assert tt.TailSampler.KEEP_REASONS == jt.TailSampler.KEEP_REASONS
    for bad in (-0.1, 1.5):
        for mod in (jt, tt):
            with pytest.raises(ValueError, match="sample_rate"):
                mod.TailSampler(bad)


def test_ambient_context_matches_jax():
    """``ambient(ctx)`` installs an explicit context as the thread's
    ambient one: a span opened inside parents under it, the stack is
    restored on exit (also after an exception), ``None`` installs nothing,
    and another thread does not see it, in both packages."""
    from speakingstyle_tpu.obs import trace as jt
    from speakingstyle_torch.obs import trace as tt

    for mod in (jt, tt):
        ring = mod.SpanRing(64)
        ctx = mod.new_context("amb")
        seen = {}
        with mod.ambient(ctx) as got:
            assert got is ctx and mod.current_context() is ctx
            with mod.Span("inner", ring=ring) as sp:
                assert sp.ctx.parent_span_id == ctx.span_id and sp.ctx.trace_id == "amb"
            t = threading.Thread(target=lambda: seen.update(other=mod.current_context()))
            t.start()
            t.join(timeout=30)
        assert mod.current_context() is None and seen == {"other": None}
        with pytest.raises(RuntimeError):
            with mod.ambient(ctx):
                raise RuntimeError("boom")
        assert mod.current_context() is None
        with mod.ambient(None) as none:
            assert none is None and mod.current_context() is None
        assert [s["trace_id"] for s in ring.spans()] == ["amb"]


def test_fleet_router_reads_the_sample_rate():
    """``serve.trace.sample_rate`` now sets the fleet router's tail
    sampler (healthy traces pinned at that rate; a shed is always pinned)."""
    import dataclasses

    from speakingstyle_torch.configs.config import Config, ServeConfig, TraceConfig
    from speakingstyle_torch.serving.fleet import FleetRouter

    cfg = Config(serve=ServeConfig(batch_buckets=[1], src_buckets=[16], mel_buckets=[64],
                                   frames_per_phoneme=2, trace=TraceConfig(sample_rate=0.0)))
    gate = threading.Event()

    def factory(reg):
        gate.wait(timeout=30)
        raise RuntimeError("never warms")

    router = FleetRouter(factory, cfg, replicas=1)
    try:
        assert router._tail_sampler.sample_rate == 0.0
        assert not router._tail_sampler.keep("req00000001")
        assert router._tail_sampler.keep("req00000001", "shed")
    finally:
        gate.set()
        router.close()
    cfg = dataclasses.replace(cfg, serve=dataclasses.replace(
        cfg.serve, trace=TraceConfig(sample_rate=1.0)))
    router = FleetRouter(factory, cfg, replicas=0)
    try:
        assert router._tail_sampler.keep("any")
    finally:
        router.close()
