"""PyTorch port, the cluster's observability (obs/trace.py across processes,
obs/registry.py's federation, obs/cli.py), held against the JAX package's.

Twins of the cluster cases of ``tests/test_trace_plane.py`` and of the event
CLI cases of ``tests/test_obs.py``, each run on both packages' classes with
the same expectations:

1. a trace context rides the wire: one traced request through the cluster
   assembles into one trace holding the router's spans and the replica's;
2. hedge legs are sibling spans under the request's context, one of them
   the winner;
3. ``merge_states`` merges histogram buckets (a fleet percentile equals one
   registry's over the union of observations), sums counters, labels gauges
   by replica, keeps a replica with other edges apart, and the port's merge
   of given states renders the same Prometheus text as the JAX package's;
4. the federation scraper outlives a replica whose lease expired;
5. ``python -m speakingstyle_torch.obs.cli`` prints the JAX CLI's text for
   the same events file (the summary, ``--event``, ``--tail``,
   ``programs``, ``trace``, ``quality``).
"""

import io
import json
import threading

import pytest

from test_torch_cluster import PKGS, StallOnce, make_cluster, pkg, req, wait_for

TIMEOUT = 30.0


@pytest.fixture(autouse=True)
def armed_rings():
    """Recording armed and fresh span rings in both packages."""
    saved = []
    for name in PKGS:
        trace = pkg(name).trace
        saved.append((trace, trace.tracing_enabled()))
        trace.set_tracing_enabled(True)
        trace.get_span_ring().clear()
    yield
    for trace, was in saved:
        trace.get_span_ring().clear()
        trace.set_tracing_enabled(was)


def tree_names(view):
    names = set()

    def walk(node):
        names.add(node["name"])
        for child in node["children"]:
            walk(child)

    for root in view["roots"]:
        walk(root)
    return names


# ---------------------------------------------------------------------------
# 1. propagation across the wire, 2. hedge legs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", PKGS)
def test_trace_propagates_router_to_replica_and_assembles(name):
    """The context crosses the wire (body and X-Trace-* headers), the
    replica's spans come back over GET /debug/spans, and the assembled tree
    holds both sides under one trace id with a critical path; remote_dispatch
    and replica_dispatch are children of the request's span."""
    p = pkg(name)
    router, procs, _ = make_cluster(p, replicas=1)
    try:
        assert router.wait_ready(timeout=TIMEOUT, n=1)
        r = req(p, 1)
        with p.trace.Span("serve_request", trace_id="t-prop", req_id="q1") as sp:
            r.trace = sp.ctx
            assert router.submit(r).result(timeout=TIMEOUT) is not None
        assert wait_for(lambda: any(s.get("name") == "replica_dispatch"
                                    for s in router.fetch_remote_spans("t-prop")), 10)
        spans = {s["span_id"]: s for s in p.trace.get_span_ring().spans("t-prop")}
        for s in router.fetch_remote_spans("t-prop"):
            spans.setdefault(s["span_id"], s)
        assert all(s["trace_id"] == "t-prop" for s in spans.values())
        view = p.trace.assemble_trace(list(spans.values()), "t-prop")
        assert {"serve_request", "serve_queue", "fleet_dispatch", "remote_dispatch",
                "replica_dispatch"} <= tree_names(view)
        assert view["span_count"] == len(spans) and view["critical_path"]
        by_name = {s["name"]: s for s in spans.values()}
        assert by_name["remote_dispatch"]["parent_span_id"] == sp.ctx.span_id
        assert by_name["replica_dispatch"]["parent_span_id"] == sp.ctx.span_id
        assert by_name["replica_dispatch"]["fields"]["hedge_leg"] == "primary"
    finally:
        router.close()


@pytest.mark.parametrize("name", PKGS)
def test_hedge_legs_are_siblings_with_exactly_one_winner(name):
    p = pkg(name)
    armed = {"on": True, "lock": threading.Lock()}
    router, procs, _ = make_cluster(p, replicas=2,
                                    engine_factory=lambda rid: StallOnce("q500", armed, 5.0),
                                    hedge_quantile=0.95, hedge_min_ms=50.0, hedge_max_ms=150.0)
    try:
        assert router.wait_ready(timeout=TIMEOUT, n=2)
        r = req(p, 500)
        r.trace = p.trace.new_context("t-hedge")
        assert router.submit(r).result(timeout=TIMEOUT) is not None
        for proc in procs.values():
            proc.engine.unstall.set()

        def legs():
            return [s for s in p.trace.get_span_ring().spans("t-hedge")
                    if s.get("name") == "remote_dispatch"]

        assert wait_for(lambda: len(legs()) == 2, 10)
        got = legs()
        assert {s["parent_span_id"] for s in got} == {r.trace.span_id}
        assert {s["fields"]["hedge_leg"] for s in got} == {"primary", "hedge"}
        winners = [s for s in got if s["fields"].get("winner")]
        assert len(winners) == 1 and winners[0]["fields"]["hedge_leg"] == "hedge"
        assert "t-hedge" in p.trace.get_span_ring().kept_trace_ids()
        assert router.last_pressure_trace_id == "t-hedge"
    finally:
        for proc in procs.values():
            proc.engine.unstall.set()
        router.close()


# ---------------------------------------------------------------------------
# 3. federation: merged buckets
# ---------------------------------------------------------------------------


def _two_registries(p):
    edges = (0.01, 0.1, 1.0)
    a, b, single = p.obs.MetricsRegistry(), p.obs.MetricsRegistry(), p.obs.MetricsRegistry()
    for reg_i, values in ((a, [0.005] * 40 + [0.5] * 2), (b, [0.05] * 30 + [2.0] * 8)):
        for v in values:
            reg_i.histogram("serve_latency_seconds", edges=edges).observe(v)
            single.histogram("serve_latency_seconds", edges=edges).observe(v)
    a.counter("serve_requests_total").inc(5)
    b.counter("serve_requests_total").inc(7)
    a.counter("serve_wire_legs_total", labels={"leg": "hedge"}).inc(2)
    a.gauge("serve_inflight").set(2)
    b.gauge("serve_inflight").set(3)
    return a, b, single


@pytest.mark.parametrize("name", PKGS)
def test_merge_states_bucket_merge_matches_single_registry(name):
    p = pkg(name)
    a, b, single = _two_registries(p)
    merged = p.registry.merge_states([("r0", a.export_state()), ("r1", b.export_state())])
    assert merged.value("fleet_serve_requests_total") == 12
    assert merged.value("fleet_serve_inflight", {"replica": "r0"}) == 2
    assert merged.value("fleet_serve_inflight", {"replica": "r1"}) == 3
    mh = merged.metrics_named("fleet_serve_latency_seconds")[0]
    sh = single.metrics_named("serve_latency_seconds")[0]
    for q in (0.5, 0.99, 0.999):
        assert mh.percentile(q) == sh.percentile(q)
    c = p.obs.MetricsRegistry()
    c.histogram("serve_latency_seconds", edges=(1.0, 2.0)).observe(1.5)
    merged2 = p.registry.merge_states([("r0", a.export_state()), ("rX", c.export_state())])
    assert [rec for rec in merged2.export_state()["metrics"]
            if rec["name"] == "fleet_serve_latency_seconds"
            and ["replica", "rX"] in [list(kv) for kv in rec["labels"]]]


def test_merge_states_equals_the_jax_merge():
    """The same exported states (written by the JAX registry, read as JSON)
    merged by both packages: the same state and the same Prometheus text,
    percentiles included; and each package's export of the same
    observations is the same JSON."""
    jp, tp = pkg("tpu"), pkg("torch")
    ja, jb, _ = _two_registries(jp)
    ta, tb, _ = _two_registries(tp)
    for j, t in ((ja, ta), (jb, tb)):
        assert json.dumps(j.export_state(), sort_keys=True) == \
            json.dumps(t.export_state(), sort_keys=True)
    states = json.loads(json.dumps([("r0", ja.export_state()), ("r1", jb.export_state()),
                                    ("rX", {"metrics": [{"name": "serve_latency_seconds",
                                                         "kind": "histogram", "labels": [],
                                                         "hist": {"edges": [1.0, 2.0],
                                                                  "counts": [0, 1, 0],
                                                                  "count": 1, "sum": 1.5,
                                                                  "min": 1.5, "max": 1.5}}]})]))
    jm = jp.registry.merge_states([tuple(s) for s in states])
    tm = tp.registry.merge_states([tuple(s) for s in states])
    assert tm.prometheus_text() == jm.prometheus_text()
    assert json.dumps(tm.export_state(), sort_keys=True) == \
        json.dumps(jm.export_state(), sort_keys=True)


# ---------------------------------------------------------------------------
# 4. the scraper outlives an expired lease
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", PKGS)
def test_federation_scrape_survives_lease_expired_replica(name):
    p = pkg(name)
    router, procs, reg = make_cluster(p, replicas=2)
    try:
        assert router.wait_ready(timeout=TIMEOUT, n=2)
        assert wait_for(lambda: len(router.federated_states()) == 2, 10)
        assert router.submit(req(p, 7)).result(timeout=TIMEOUT) is not None
        assert wait_for(lambda: router.federated_registry().value(
            "fleet_serve_wire_dispatches_total") == 1, 10)
        assert "fleet_serve_wire_dispatches_total" in \
            router.federated_registry().prometheus_text()
        victim = sorted(procs)[0]
        procs[victim].server.close()  # silent, not dead: its lease expires
        assert wait_for(lambda: all(rid != victim for rid, _ in router.federated_states()), 20)
        scrapes = reg.value("serve_federation_scrapes_total")
        assert wait_for(lambda: reg.value("serve_federation_scrapes_total") > scrapes, 10)
        assert reg.value("serve_federation_errors_total") >= 0
        assert "fleet_" in router.federated_registry().prometheus_text()
        assert router.submit(req(p, 9)).result(timeout=TIMEOUT) is not None
    finally:
        router.close()


# ---------------------------------------------------------------------------
# 5. the events CLI prints the JAX CLI's text
# ---------------------------------------------------------------------------


def _events_dir(tmp_path):
    """One events file with training, program-card, span and quality-plane
    records, written by the port's event log (the JAX log's format)."""
    from speakingstyle_torch.obs import JsonlEventLog

    log = JsonlEventLog(str(tmp_path))
    for s in (1, 2):
        log.emit("train_step", step=s, total_loss=2.0 / s, mel_loss=1.0 / s, step_time_s=0.5,
                 data_wait_s=0.001)
    log.emit("checkpoint_save", step=2)
    log.emit("program_card", name="train_step", flops=1.0e12, transcendentals=1e6,
             bytes_accessed=5.0e9, argument_bytes=100.0, output_bytes=50.0, temp_bytes=200.0,
             peak_bytes=350.0, arithmetic_intensity=200.0, partial=False)
    log.emit("quality_fail", tier="teacher-int8", reasons=["rms_low", "clipped"],
             klass="batch", source="engine", req_id="req1", trace_id="t1")
    log.emit("probe_round", tiers={"teacher-f32": 0.0, "teacher-int8": 0.3}, style_drift=0.01)
    log.emit("probe_round", tiers={"teacher-f32": 0.0, "teacher-int8": 3.1e9}, style_drift=0.02)
    log.emit("probe_drift_alert", tier="teacher-int8", mel_drift=3.1e9, tolerance=1.0)
    log.emit("probe_error", tier="teacher-f32", stage="submit")
    log.emit("slo_quality_alert", klass="batch", fast_burn=20.0, slow_burn=7.0, trace_id="t1")
    log.close()
    return str(tmp_path)


def _spans_file(tmp_path):
    """A GET /debug/spans dump of one router-and-replica trace (ring and
    keep-store overlapping) and a second trace."""
    spans = [
        {"name": "serve_request", "trace_id": "t1", "span_id": "a", "parent_span_id": None,
         "start_ts": 100.0, "duration_s": 0.2, "fields": {"req_id": "req1"}},
        {"name": "remote_dispatch", "trace_id": "t1", "span_id": "b", "parent_span_id": "a",
         "start_ts": 100.05, "duration_s": 0.1, "fields": {"hedge_leg": "primary",
                                                           "winner": True}},
        {"name": "replica_dispatch", "trace_id": "t1", "span_id": "c", "parent_span_id": "a",
         "start_ts": 100.06, "duration_s": 0.08, "fields": {"rows": 2}},
        {"name": "fleet_requeue", "trace_id": "t1", "span_id": "d", "parent_span_id": "a",
         "start_ts": 100.01, "duration_s": 0.0, "ok": False, "error": "WireError",
         "events": [{"name": "requeue", "ts": 100.01, "replica": 0, "kind": "lease"}]},
        {"name": "serve_request", "trace_id": "t2", "span_id": "e", "parent_span_id": None,
         "start_ts": 101.0, "duration_s": 0.05},
    ]
    path = tmp_path / "spans.json"
    path.write_text(json.dumps({"spans": spans[:3], "kept": {"t1": spans[:4]},
                                "stats": {}}))
    return str(path)


def _run(package, argv):
    """(exit code, standard output) of ``python -m <package>.obs.cli``."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-m", f"{package}.obs.cli", *argv], cwd=repo,
                         env=dict(os.environ, PYTHONPATH=repo), capture_output=True, text=True,
                         timeout=120)
    return out.returncode, out.stdout


@pytest.mark.parametrize("argv", [
    ["{d}"], ["{d}", "--event", "checkpoint_save"], ["{d}", "--tail", "2"],
    ["programs", "{d}"], ["programs", "{d}", "--peak-flops", "989e12"],
    ["quality", "{d}"], ["trace", "{s}"], ["trace", "{s}", "t1"], ["trace", "{s}", "nope"],
    ["programs", "{e}"], ["quality", "{e}"], ["{e}"],
], ids=["summary", "event", "tail", "programs", "programs_peak", "quality", "trace_list",
        "trace_tree", "trace_missing", "programs_empty", "quality_empty", "summary_empty"])
def test_events_cli_prints_the_jax_clis_text(tmp_path, argv):
    """The two packages' CLIs, each in a process of its own, on the same
    files: the same exit code and the same standard output."""
    d = _events_dir(tmp_path / "log")
    s = _spans_file(tmp_path)
    (tmp_path / "empty").mkdir()
    args = [a.format(d=d, s=s, e=str(tmp_path / "empty")) for a in argv]
    want = _run("speakingstyle_tpu", args)
    got = _run("speakingstyle_torch", args)
    assert got == want
    assert got[1].strip()


def test_events_cli_summarize_and_filter(tmp_path, capsys):
    """The port's CLI on its own (the JAX test's checks): counts and the
    last step, ``--event`` and ``--tail`` as JSONL."""
    from speakingstyle_torch.obs import JsonlEventLog
    from speakingstyle_torch.obs import cli as obs_cli

    log = JsonlEventLog(str(tmp_path))
    for s in (1, 2):
        log.emit("train_step", step=s, total_loss=2.0 / s, step_time_s=0.01, data_wait_s=0.001)
    log.emit("checkpoint_save", step=2)
    log.close()
    buf = io.StringIO()
    assert obs_cli.summarize(str(tmp_path), out=buf) == 0
    text = buf.getvalue()
    assert "train_step" in text and "step=2" in text and "total_loss" in text
    assert obs_cli.main([str(tmp_path), "--event", "checkpoint_save"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1 and json.loads(out[0])["step"] == 2
    assert obs_cli.main([str(tmp_path), "--tail", "2"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert [json.loads(ln)["event"] for ln in out] == ["train_step", "checkpoint_save"]


def test_events_cli_programs_pretty_prints_and_rooflines(tmp_path, capsys):
    """``programs``: the card's FLOPs, achieved FLOP/s from the mean step,
    the intensity, ``--peak-flops`` utilization; rc 1 on an empty log."""
    from speakingstyle_torch.obs import JsonlEventLog
    from speakingstyle_torch.obs import cli as obs_cli

    log = JsonlEventLog(str(tmp_path))
    log.emit("program_card", name="train_step", flops=1.0e12, transcendentals=1e6,
             bytes_accessed=5.0e9, argument_bytes=100.0, output_bytes=50.0, temp_bytes=200.0,
             peak_bytes=350.0, arithmetic_intensity=200.0, partial=False)
    for s in (1, 2):
        log.emit("train_step", step=s, total_loss=1.0, step_time_s=0.5, data_wait_s=0.0)
    log.close()
    assert obs_cli.main(["programs", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "train_step" in out and "1.00 TFLOP" in out and "2.00 TFLOP/s" in out
    assert "intensity" in out and "200.0 FLOP/B" in out
    assert obs_cli.main(["programs", str(tmp_path), "--peak-flops", "4e12"]) == 0
    assert "50.0%" in capsys.readouterr().out
    empty = tmp_path / "empty"
    empty.mkdir()
    assert obs_cli.main(["programs", str(empty)]) == 1
    capsys.readouterr()
