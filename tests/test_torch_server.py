"""PyTorch port, the HTTP server (serving/server.py, serving/frontend.py)
over HTTP on port 0, held against the JAX package's ``SynthesisServer``.

Both servers run one engine on the same weights (the JAX variables carried
across by ``compat.from_jax``) at a one-point lattice (batch 1, 16
phonemes, 48 frames, references of 32 frames), each built once for the
module; the JAX engine's Pallas kernels run in interpret mode, as in the
JAX package's own tests. Both configs read one tiny lexicon, so the G2P
gives real phonemes. Held:

* ``/synthesize`` int16 wavs within 2 LSB of the JAX server's for the same
  payloads at f32 (the bar of the port's f32 engine test), per-word
  controls, ``style_id`` and ``ref_audio`` included;
* every 400 of the JAX package's server tests answers 400 in both;
* ``/styles`` content addressing (the same style_id as JAX, a repeat does
  no encoder work) and the speaker binding;
* ``/healthz`` 503 before the precompile, 200 after; ``/metrics`` families
  and ``/debug/programs``; ``/debug/profile``;
* 429 + ``Retry-After`` under shed, 503 after shutdown, ``X-Request-Id``
  and ``X-Trace-Id`` on every synthesize response;
* the stream's PCM equal to the depth-1 stream of the same request;
* ``/synthesize/longform``: a chapter answered 200 by both servers (the
  stitched wavs within 4 LSB), a bad one 400; the 413 body's pointer to it.

Every server is shut down in a fixture finalizer or a ``finally``, and
every client call has a timeout.
"""

import http.client
import io
import json
import threading
import time
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
import yaml

from test_torch_models import MODEL_YAML, one_cpu_thread  # noqa: F401 (an autouse fixture)
from test_torch_synthesis import GEN_TOPO, STATS, jax_weights  # noqa: F401 (a fixture)

LEXICON = """\
hello HH AH0 L OW1
there DH EH1 R
world W ER1 L D
speak S P IY1 K
softly S AO1 F T L IY0
now N AW1
"""
SERVE_ONE = {
    "batch_buckets": [1], "src_buckets": [16], "mel_buckets": [48], "frames_per_phoneme": 2,
    "max_wait_ms": 1.0, "style": {"ref_buckets": [32]}, "fleet": {"stream_window": 8},
}
TIMEOUT = 120


def write_configs(tmp, serve=SERVE_ONE, ref_dir=""):
    """preprocess.yaml (the lexicon), model.yaml (fused attention, the fused
    conv) and train.yaml (the serve block) for both packages."""
    lex = tmp / "lexicon.txt"
    lex.write_text(LEXICON)
    pre = tmp / "preprocess.yaml"
    pre.write_text(yaml.safe_dump({"path": {"lexicon_path": str(lex)}}))
    model = tmp / "model.yaml"
    model.write_text(yaml.safe_dump(dict(MODEL_YAML, attention_kernel="fused",
                                         conv_impl="pallas")))
    train = tmp / "train.yaml"
    train.write_text(yaml.safe_dump({"serve": dict(serve, style=dict(serve["style"],
                                                                      ref_dir=ref_dir))}))
    return str(pre), str(model), str(train)


def build_port_engine(tmp=None, weights=None, serve=SERVE_ONE, ref_dir=""):
    """A port engine on the CPU: the JAX ``weights`` carried across, or
    weights drawn from seed 0 with the duration bias raised by 1.1 (so
    random weights predict real frames)."""
    import tempfile
    from pathlib import Path

    from speakingstyle_torch.compat.from_jax import load_flax_variables
    from speakingstyle_torch.configs.config import load_config
    from speakingstyle_torch.models import hifigan as th
    from speakingstyle_torch.models.factory import init_weights
    from speakingstyle_torch.models.fastspeech2 import FastSpeech2
    from speakingstyle_torch.serving.engine import SynthesisEngine

    tmp = Path(tempfile.mkdtemp()) if tmp is None else tmp
    cfg = load_config(*write_configs(tmp, serve, ref_dir))
    model = FastSpeech2(cfg, **STATS)
    gen = th.Generator(80, **GEN_TOPO)
    if weights is not None:
        variables, gparams = weights
        model = load_flax_variables(model, variables)
        gen = load_flax_variables(gen, {"params": gparams})
    else:
        init_weights(model, 0)
        init_weights(gen, 1)
        with torch.no_grad():
            model.variance_adaptor.duration_predictor.linear_layer.bias += 1.1
    return SynthesisEngine(cfg, model=model, vocoder=gen, device="cpu")


def start(server):
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return thread


def stop(server, thread):
    server.shutdown()
    thread.join(timeout=TIMEOUT)


def call(server, method, path, body=None, headers=None, conn=None):
    """(status, headers, body bytes) of one request (a new connection unless
    ``conn`` is given)."""
    own = conn is None
    if own:
        host, port = server.address[:2]
        conn = http.client.HTTPConnection(host, port, timeout=TIMEOUT)
    try:
        if isinstance(body, (dict, list)):
            body = json.dumps(body)
        conn.request(method, path, body=body, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        if own:
            conn.close()


def ref_wav_bytes(seed=0, seconds=0.3, sr=22050):
    """A small deterministic wav file (the upload body): < 32 mel frames."""
    import scipy.io.wavfile

    rng = np.random.default_rng(seed)
    t = np.arange(int(sr * seconds)) / sr
    wav = 0.3 * np.sin(2 * np.pi * (180 + 40 * seed) * t) + 0.01 * rng.standard_normal(t.shape)
    buf = io.BytesIO()
    scipy.io.wavfile.write(buf, sr, (wav * 32000).astype(np.int16))
    return buf.getvalue()


def pcm(body: bytes) -> np.ndarray:
    assert body[:4] == b"RIFF" and body[8:12] == b"WAVE"
    return np.frombuffer(body[44:], np.int16)


@pytest.fixture(scope="module")
def servers(jax_weights, tmp_path_factory):  # noqa: F811
    """{"jax": server, "torch": server} over the same weights, config and
    default reference, each with ``serve.style.ref_dir`` holding
    ``house.wav``; shut down at the module's end."""
    from speakingstyle_tpu.configs.config import load_config as j_load
    from speakingstyle_tpu.models import hifigan as jh
    from speakingstyle_tpu.models.fastspeech2 import FastSpeech2 as JFS2
    from speakingstyle_tpu.ops import pallas_attention
    from speakingstyle_tpu.serving.engine import SynthesisEngine as JEngine
    from speakingstyle_tpu.serving.server import SynthesisServer as JServer
    from speakingstyle_tpu.serving.server import TextFrontend as JFrontend
    from speakingstyle_torch.serving.frontend import TextFrontend
    from speakingstyle_torch.serving.server import SynthesisServer

    tmp = tmp_path_factory.mktemp("server")
    ref_dir = tmp / "refs"
    ref_dir.mkdir()
    (ref_dir / "house.wav").write_bytes(ref_wav_bytes(20))
    variables, gparams = jax_weights
    ref = np.random.default_rng(0).standard_normal((20, 80)).astype(np.float32)
    engine = build_port_engine(tmp, jax_weights, ref_dir=str(ref_dir))
    engine.precompile()
    jcfg = j_load(*write_configs(tmp, ref_dir=str(ref_dir)))
    pallas_attention.FORCE_INTERPRET = True
    try:
        with jax.default_prng_impl("threefry2x32"):
            jengine = JEngine(jcfg, variables, vocoder=(jh.Generator(**GEN_TOPO), gparams),
                              model=JFS2(config=jcfg, **STATS))
            jengine.precompile()
    finally:
        pallas_attention.FORCE_INTERPRET = False
    out = {"jax": JServer(jengine, JFrontend(jcfg, ref), host="127.0.0.1", port=0,
                          profile_dir=str(tmp / "jprof")),
           "torch": SynthesisServer(engine, TextFrontend(engine.cfg, ref), host="127.0.0.1",
                                    port=0, profile_dir=str(tmp / "prof"))}
    threads = {k: start(s) for k, s in out.items()}
    yield out
    for k, s in out.items():
        stop(s, threads[k])


def upload(server, data, query=""):
    status, headers, body = call(server, "POST", "/styles" + query, data,
                                 {"Content-Type": "audio/wav"})
    assert status == 200, body
    return json.loads(body)


PAYLOADS = {
    "default_style": {"text": "hello there"},
    "scalar_controls": {"text": "hello world", "pitch_control": 1.2, "energy_control": 0.8,
                        "duration_control": 1.5},
    "per_word_controls": {"text": "speak softly now", "duration_control": [1.0, 2.5, 1.0],
                          "pitch_control": [1.1, 0.9, 1.0]},
    "ref_audio": {"text": "speak now", "ref_audio": "house.wav"},
    "style_id": {"text": "speak now"},
}


@pytest.mark.parametrize("case", sorted(PAYLOADS))
def test_synthesize_matches_jax_server(servers, case):
    """The same payload through both servers: 200, equal lengths, int16
    samples within 2 LSB, and the port's response carries X-Request-Id and
    X-Trace-Id (a forwarded trace id is kept)."""
    payload = dict(PAYLOADS[case])
    if case == "style_id":
        ids = {k: upload(s, ref_wav_bytes(19))["style_id"] for k, s in servers.items()}
        assert ids["torch"] == ids["jax"]
        payload["style_id"] = ids["torch"]
    got = {}
    for k, s in servers.items():
        status, headers, body = call(s, "POST", "/synthesize", payload,
                                     {"X-Trace-Id": f"trace-{case}"})
        assert status == 200, (k, body)
        got[k] = (pcm(body), headers)
    (want, _), (wav, headers) = got["jax"], got["torch"]
    assert headers["X-Request-Id"].startswith("req") and headers["X-Trace-Id"] == f"trace-{case}"
    assert headers["Content-Type"] == "audio/wav" and headers["X-Batch-Rows"] == "1"
    assert wav.shape == want.shape and wav.size > 0
    assert np.abs(wav.astype(np.int32) - want.astype(np.int32)).max() <= 2


BAD = {
    "no_text": ("/synthesize", {}),
    "empty_text": ("/synthesize", {"text": ""}),
    "not_json": ("/synthesize", b"{not json"),
    "unknown_style_id": ("/synthesize", {"text": "hello", "style_id": "f" * 64}),
    "ref_escape": ("/synthesize", {"text": "hello", "ref_audio": "../../etc/passwd"}),
    "ref_absolute": ("/synthesize", {"text": "hello", "ref_audio": "/etc/passwd"}),
    "ref_missing": ("/synthesize", {"text": "hello", "ref_audio": "nowhere.wav"}),
    "style_and_ref": ("/synthesize", {"text": "hello", "style_id": "ab", "ref_audio": "a.wav"}),
    "word_count": ("/synthesize", {"text": "hello there", "duration_control": [1.0, 2.0, 3.0]}),
    "control_type": ("/synthesize", {"text": "hello", "pitch_control": "fast"}),
    "control_bool": ("/synthesize", {"text": "hello", "energy_control": True}),
    "unknown_speaker": ("/synthesize", {"text": "hello", "speaker_id": "ghost"}),
    "priority_type": ("/synthesize", {"text": "hello", "priority": 3}),
    "stream_no_text": ("/synthesize/stream", {}),
    "style_json_no_ref": ("/styles", {}),
    "style_empty_body": ("/styles", b""),
    "profile_not_number": ("/debug/profile?seconds=bogus", None),
    "profile_out_of_range": ("/debug/profile?seconds=999", None),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_bad_requests_answer_400_as_jax(servers, case):
    """Each malformed request is a 400 in both servers; a synthesize 400
    carries the request id in its body and headers."""
    path, body = BAD[case]
    headers = {"Content-Type": "application/json"} if case == "style_json_no_ref" else {}
    got = {k: call(s, "POST", path, body, headers) for k, s in servers.items()}
    assert got["torch"][0] == got["jax"][0] == 400, {k: v[2] for k, v in got.items()}
    status, hdr, raw = got["torch"]
    if path.startswith("/synthesize"):
        err = json.loads(raw)
        assert err["id"] == hdr["X-Request-Id"] and hdr["X-Trace-Id"] == err["id"]


def test_styles_idempotent_and_speaker_binding(servers):
    """An upload is content-addressed: a repeat is a cache hit with no
    encoder dispatch, GET /styles lists it, a ref_dir JSON registration
    works; a style bound to a speaker drives it and refuses another."""
    server = servers["torch"]
    style = server.engine.style
    data = ref_wav_bytes(21)
    first = upload(server, data)
    assert first["cached"] is False and first["ref_frames"] > 0
    d0 = style.dispatch_count
    again = upload(server, data)
    assert again == dict(first, cached=True) and style.dispatch_count == d0
    status, _, body = call(server, "GET", "/styles")
    listing = json.loads(body)
    assert status == 200 and first["style_id"] in [e["style_id"] for e in listing["styles"]]
    assert listing["capacity"] == server.cfg.serve.style.cache_capacity
    status, _, body = call(server, "POST", "/styles", {"ref_audio": "house.wav"},
                           {"Content-Type": "application/json"})
    assert status == 200, body
    d1 = style.dispatch_count
    status, _, body = call(server, "POST", "/synthesize",
                           {"text": "hello", "style_id": first["style_id"]})
    assert status == 200 and style.dispatch_count == d1

    fe = server.frontend
    fe.speaker_map = {"mary": 0, "john": 1}
    try:
        bound = upload(server, ref_wav_bytes(31), "?speaker=john")
        assert bound["speaker"] == "john"
        req = fe.request("r1", {"text": "hello", "style_id": bound["style_id"]})
        assert req.speaker == 1
        status, _, body = call(server, "POST", "/synthesize", {
            "text": "hello", "style_id": bound["style_id"], "speaker_id": "mary"})
        assert status == 400 and b"bound to speaker" in body
        status, _, body = call(server, "POST", "/styles?speaker=ghost", ref_wav_bytes(41),
                               {"Content-Type": "audio/wav"})
        assert status == 400 and b"unknown speaker" in body
    finally:
        fe.speaker_map = {}


def test_metrics_and_debug_programs(servers):
    """/metrics exports the JAX server's families (bar those named below)
    and the per-bucket series; /debug/programs lists the engine's then the
    style encoder's cards; /healthz is a view of the registry."""
    for s in servers.values():
        assert call(s, "POST", "/synthesize", {"text": "hello there"})[0] == 200

    def families(text):
        return {line.split("{")[0].split(" ")[0] for line in text.splitlines()
                if line and not line.startswith("#")}

    texts = {k: call(s, "GET", "/metrics")[2].decode() for k, s in servers.items()}
    # not the port's here: XLA's own counters, and the programs' peak
    # bytes, which the port measures from the card's graph capture only
    want = {f for f in families(texts["jax"]) if not f.startswith("jax_")
            and f != "serve_program_peak_bytes"}
    assert want - families(texts["torch"]) == set()
    text = texts["torch"]
    for series in ('serve_dispatch_seconds_bucket{bucket="b1.s16.m48"',
                   'serve_program_flops{bucket="b1.s16.m48",kind="acoustic"}',
                   'serve_achieved_flops_per_sec_count{bucket="b1.s16.m48"}',
                   "serve_request_latency_seconds_count", "process_rss_bytes",
                   "process_uptime_seconds"):
        assert series in text, series

    server = servers["torch"]
    status, _, body = call(server, "GET", "/debug/programs")
    progs = json.loads(body)
    assert status == 200 and progs["build"]["torch"] == torch.__version__
    assert progs["programs"] == json.loads(json.dumps(server.engine.programs()
                                                      + server.engine.style.programs()))
    assert len(progs["programs"]) == (server.engine.compile_count
                                      + server.engine.style.compile_count) == 3
    status, _, body = call(server, "GET", "/healthz")
    health = json.loads(body)
    snap = server.registry.snapshot()["counters"]
    assert status == 200 and health["ready"] is True
    assert health["compile_count"] == snap["serve_compiles_total"] == 2
    assert health["requests"] == snap["serve_http_requests_total"]
    assert health["style"]["compiles"] == 1 and health["build"]["backend"] == "cpu"


def test_debug_profile_captures_a_torch_trace(servers):
    """POST /debug/profile captures a torch.profiler window and writes its
    chrome trace; the profiler is stopped even when the capture fails."""
    import os

    server = servers["torch"]
    status, _, body = call(server, "POST", "/debug/profile?seconds=0.2")
    out = json.loads(body)
    assert status == 200, out
    assert out["seconds"] == 0.2 and os.path.isfile(out["trace"])
    assert json.load(open(out["trace"]))["traceEvents"] is not None

    # a capture that fails inside its window, or at its export, still
    # stops the profiler and frees the capture for the next request
    import types

    import torch.profiler

    from speakingstyle_torch.serving import server as server_module

    stopped = []
    real = torch.profiler.profile

    class Watched(real):
        def stop(self):
            stopped.append(True)
            return super().stop()

    def broken_sleep(seconds):
        raise KeyboardInterrupt

    class FailingExport(Watched):
        def export_chrome_trace(self, path):
            raise OSError("disk full")

    clock = types.SimpleNamespace(sleep=broken_sleep, monotonic=time.monotonic, time=time.time)
    for profiler, patch_time, error in ((Watched, True, KeyboardInterrupt),
                                        (FailingExport, False, OSError)):
        torch.profiler.profile = profiler
        if patch_time:
            server_module.time = clock
        try:
            with pytest.raises(error):
                server.capture_profile(0.05)
        finally:
            torch.profiler.profile = real
            server_module.time = time
    assert stopped == [True, True]
    assert call(server, "POST", "/debug/profile?seconds=0.05")[0] == 200


def test_stream_equals_depth1_stream(servers):
    """The chunked /synthesize/stream response (depth 2) is the depth-1
    stream of the same request, byte for byte, and records TTFA."""
    from speakingstyle_torch.serving import streaming
    from speakingstyle_torch.serving.server import wav_stream_header

    server = servers["torch"]
    payload = {"text": "speak softly now"}
    ttfa0 = server.registry.histogram("serve_ttfa_seconds").count
    status, headers, body = call(server, "POST", "/synthesize/stream", payload)
    assert status == 200 and headers["Transfer-Encoding"] == "chunked"
    assert headers["X-Request-Id"] and headers["X-Trace-Id"] == headers["X-Request-Id"]
    sr = server.cfg.preprocess.preprocessing.audio.sampling_rate
    assert body[:44] == wav_stream_header(sr)
    result = server.synthesize(payload, stream=True)
    fleet = server.cfg.serve.fleet
    assert result.mel_len > fleet.stream_window  # more than one window
    overlap = streaming.resolve_overlap(fleet.stream_overlap, server.engine.vocoder)
    depth1 = b"".join(c.tobytes() for c in streaming.stream_wav(
        server.engine, result, fleet.stream_window, overlap, depth=1))
    assert body[44:] == depth1
    assert len(depth1) == 2 * result.mel_len * server.engine.vocoder.hop_factor
    assert server.registry.histogram("serve_ttfa_seconds").count == ttfa0 + 1


def test_request_past_the_lattice_is_413_as_jax(servers):
    """A text longer than the largest src bucket answers 413 in both
    servers, the body stating the lattice's ceilings and the endpoint that
    takes chapters."""
    payload = {"text": " ".join(["hello there world"] * 4)}
    got = {k: call(s, "POST", "/synthesize", payload) for k, s in servers.items()}
    assert got["torch"][0] == got["jax"][0] == 413
    body, want = json.loads(got["torch"][2]), json.loads(got["jax"][2])
    for key in ("max_src", "max_mel", "max_phonemes", "longform"):
        assert body[key] == want[key]
    assert body["longform"] == "/synthesize/longform"
    assert body["id"] == got["torch"][1]["X-Request-Id"]


def test_longform_is_refused_until_5b(servers):
    """Since the chunked long-form tier is ported (queue A item 5b-ii) the
    endpoint is refused only a bad chapter: a chapter answers 200 in both
    servers, chunked the same way, the stitched wavs within 4 LSB (the
    engines' 2 LSB through the crossfade's sin + cos <= sqrt(2) and its
    rounding); an empty payload answers 400 with the request id. The name
    is kept from when the whole endpoint was refused."""
    chapter = {"text": "hello there. speak softly now. hello world. speak now."}
    got = {k: call(s, "POST", "/synthesize/longform", chapter) for k, s in servers.items()}
    assert got["torch"][0] == got["jax"][0] == 200, {k: v[2][:200] for k, v in got.items()}
    (_, want_h, want_b), (_, headers, body) = got["jax"], got["torch"]
    assert headers["X-Longform-Tier"] == want_h["X-Longform-Tier"] == "chunked"
    assert headers["X-Longform-Chunks"] == want_h["X-Longform-Chunks"]
    wav, want = pcm(body), pcm(want_b)
    assert wav.shape == want.shape and wav.size > 0
    assert np.abs(wav.astype(np.int32) - want.astype(np.int32)).max() <= 4
    status, headers, body = call(servers["torch"], "POST", "/synthesize/longform", {})
    err = json.loads(body)
    assert status == 400 and "text" in err["error"]
    assert err["id"] == headers["X-Request-Id"] and headers["X-Trace-Id"]


def test_router_is_refused():
    """The fleet router is a backend now (the tests below); what is refused
    is a server with neither an engine nor a router."""
    from speakingstyle_torch.serving.server import SynthesisServer

    with pytest.raises(ValueError, match="needs an engine or a router"):
        SynthesisServer()


def test_healthz_503_until_precompiled(tmp_path):
    """Readiness: 503 while the lattice is unprepared, 200 after
    ``precompile()``, with no request served in between."""
    from speakingstyle_torch.serving.frontend import TextFrontend
    from speakingstyle_torch.serving.server import SynthesisServer

    engine = build_port_engine(tmp_path)
    server = SynthesisServer(engine, TextFrontend(engine.cfg), host="127.0.0.1", port=0)
    thread = start(server)
    try:
        status, _, body = call(server, "GET", "/healthz")
        assert status == 503 and json.loads(body)["ready"] is False
        engine.precompile()
        status, _, body = call(server, "GET", "/healthz")
        assert status == 200 and json.loads(body)["ready"] is True
    finally:
        stop(server, thread)


def test_a_server_that_never_served_shuts_down_at_once(tmp_path):
    """``shutdown()`` before ``serve_forever()`` ever ran (a start-up that
    failed after the socket was bound) closes the socket and the backend
    without waiting for a serve loop, and a ``serve_forever()`` after it
    returns at once."""
    import socket

    from speakingstyle_torch.serving.frontend import TextFrontend
    from speakingstyle_torch.serving.server import SynthesisServer

    engine = build_port_engine(tmp_path)
    server = SynthesisServer(engine, TextFrontend(engine.cfg), host="127.0.0.1", port=0)
    host, port = server.address[:2]
    done = threading.Thread(target=server.shutdown, daemon=True)
    done.start()
    done.join(timeout=30)
    assert not done.is_alive()
    with pytest.raises(OSError):  # the port is closed
        socket.create_connection((host, port), timeout=5).close()
    assert not server.batcher.thread.is_alive()
    loop = threading.Thread(target=server.serve_forever, daemon=True)
    loop.start()
    loop.join(timeout=5)
    assert not loop.is_alive()


def test_healthz_reads_a_flapping_router_a_bounded_number_of_times():
    """/healthz reads a router's states around its ready predicate until
    two reads agree, and at most ``HEALTH_READS`` times when they keep
    changing (then the last pair)."""
    from speakingstyle_torch.serving.server import HEALTH_READS, SynthesisServer

    class Router:
        def __init__(self, flap):
            self.flap, self.reads = flap, 0

        def states(self):
            self.reads += 1
            return {0: "ready" if not self.flap or self.reads % 2 else "draining"}

        def ready(self):
            return True

    steady = Router(flap=False)
    assert SynthesisServer._health(SimpleNamespace(router=steady)) == (True, {0: "ready"})
    assert steady.reads == 2
    flapping = Router(flap=True)
    ready, states = SynthesisServer._health(SimpleNamespace(router=flapping))
    assert ready is True and states in ({0: "ready"}, {0: "draining"})
    assert flapping.reads == HEALTH_READS + 1


def test_shed_429_then_shutdown_503(tmp_path):
    """With the dispatch thread held and the queue at its high watermark,
    a request is shed: 429 with Retry-After; once released every admitted
    request answers 200. After shutdown a request on a kept-alive
    connection answers 503. Each carries X-Request-Id and X-Trace-Id."""
    from speakingstyle_torch.serving.frontend import TextFrontend
    from speakingstyle_torch.serving.server import SynthesisServer

    serve = dict(SERVE_ONE, queue_depth=4, fleet={"stream_window": 8, "shed_retry_after_s": 2.5})
    engine = build_port_engine(tmp_path, serve=serve)
    engine.precompile()
    gate, entered = threading.Event(), threading.Event()
    run = engine.run

    def held_run(requests, **kw):
        if not gate.is_set():
            entered.set()
            assert gate.wait(timeout=TIMEOUT)
        return run(requests, **kw)

    engine.run = held_run
    ref = np.random.default_rng(0).standard_normal((20, 80)).astype(np.float32)
    server = SynthesisServer(engine, TextFrontend(engine.cfg, ref), host="127.0.0.1", port=0)
    thread = start(server)
    host, port = server.address[:2]
    keep = http.client.HTTPConnection(host, port, timeout=TIMEOUT)
    results = []
    try:
        clients = [threading.Thread(target=lambda: results.append(
            call(server, "POST", "/synthesize", {"text": "hello there"}))) for _ in range(5)]
        for c in clients:
            c.start()
        assert entered.wait(timeout=TIMEOUT)
        deadline = time.monotonic() + TIMEOUT
        while server.batcher._queue.qsize() < 4 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert server.batcher._queue.qsize() == 4
        status, headers, body = call(server, "POST", "/synthesize", {"text": "hello"})
        # no dispatch has completed yet: the configured Retry-After
        assert status == 429 and headers["Retry-After"] == "2"
        assert json.loads(body)["id"] == headers["X-Request-Id"] and headers["X-Trace-Id"]
        gate.set()
        for c in clients:
            c.join(timeout=TIMEOUT)
        assert sorted(r[0] for r in results) == [200] * 5
        assert server.registry.value("serve_shed_total") == 1
        # a kept-alive connection, used again after the shutdown below
        assert call(server, "POST", "/synthesize", {"text": "hello"}, conn=keep)[0] == 200
    finally:
        gate.set()
        stop(server, thread)
    try:
        status, headers, body = call(server, "POST", "/synthesize", {"text": "hello"}, conn=keep)
    finally:
        keep.close()
    assert status == 503 and json.loads(body)["id"] == headers["X-Request-Id"]
    assert server.registry.value("serve_rejected_total") == 1


def _fields(obj):
    import dataclasses

    return {f.name: (_fields(getattr(obj, f.name))
                     if dataclasses.is_dataclass(getattr(obj, f.name)) else getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def test_serve_keys_load_with_the_jax_defaults(tmp_path):
    """A train.yaml with the HTTP path's serve keys and whole ``fleet``,
    ``cluster``, ``trace`` and ``slo`` blocks loads in both packages to the
    same values;
    the port's defaults of every key it shares with the JAX package are
    the JAX package's, and since ``serve.parallel`` it has every key."""
    from speakingstyle_tpu.configs import config as jc
    from speakingstyle_torch.configs import config as tc

    serve = {"max_wait_ms": 3.5, "queue_depth": 17, "donate_buffers": False, "host": "0.0.0.0",
             "port": 9000, "debug_profile": False, "log_events": True, "frontend_workers": 0,
             "style": {"ref_dir": str(tmp_path)},
             "fleet": {"replicas": 1, "shed_high_watermark": 0.8, "shed_low_watermark": 0.4,
                       "shed_retry_after_s": 3.0, "class_deadline_ms": {"a": 100.0},
                       "default_class": "a", "stream_window": 16, "stream_depth": 1,
                       "drain_timeout_s": 2.0},
             "cluster": {"enabled": True, "control_host": "0.0.0.0", "control_port": 7100,
                         "heartbeat_interval_s": 0.25, "lease_miss_budget": 5,
                         "hedge_quantile": 0.9, "hedge_min_ms": 10.0, "hedge_max_ms": 500.0,
                         "connect_timeout_s": 1.5, "spawn_grace_s": 60.0, "quorum": 2,
                         "idempotency_cache": 32},
             "trace": {"enabled": False, "ring_capacity": 64, "sample_rate": 0.5},
             "slo": {"objectives": {"a": 0.9}, "fast_window_s": 10.0, "slow_window_s": 50.0}}
    path = tmp_path / "train.yaml"
    path.write_text(yaml.safe_dump({"serve": serve}))
    j, t = jc.load_config(train=str(path)).serve, tc.load_config(train=str(path)).serve
    shared = set(_fields(t)) & set(_fields(j))
    assert {k: _fields(t)[k] for k in shared} == {k: _fields(j)[k] for k in shared}
    assert set(_fields(t)) - set(_fields(j)) == set()
    assert set(_fields(j)) - set(_fields(t)) == set()
    assert t.cluster.lease_ttl_s == j.cluster.lease_ttl_s == 1.5
    for name in ("fleet", "cluster", "trace", "slo", "autoscale", "rollout", "longform",
                 "parallel"):
        assert _fields(getattr(tc.ServeConfig(), name)) == _fields(getattr(jc.ServeConfig(), name))


@pytest.mark.parametrize("bad", [
    {"max_wait_ms": -1.0}, {"queue_depth": 0}, {"frontend_workers": -1},
    {"fleet": {"shed_high_watermark": 0.3, "shed_low_watermark": 0.5}},
    {"fleet": {"default_class": "turbo"}}, {"fleet": {"stream_depth": 0}},
    {"fleet": {"max_deadline_ms": 10.0}}, {"trace": {"sample_rate": 1.5}},
    {"trace": {"ring_capacity": 0}}, {"slo": {"objectives": {"a": 1.0}}},
    {"slo": {"fast_window_s": 60.0, "slow_window_s": 30.0}}, {"fleet": {"bogus": 1}},
    {"cluster": {"quorum": 0}}, {"cluster": {"hedge_quantile": 1.0}},
    {"cluster": {"hedge_min_ms": 10.0, "hedge_max_ms": 5.0}}, {"cluster": {"bogus": 1}},
    {"cluster": {"heartbeat_interval_s": 0.0}}, {"cluster": {"lease_miss_budget": 0}},
    {"cluster": {"hedge_min_ms": -1.0}}, {"cluster": {"connect_timeout_s": 0.0}},
    {"cluster": {"spawn_grace_s": 0.0}}, {"cluster": {"idempotency_cache": 0}},
])
def test_serve_keys_are_validated_as_jax(tmp_path, bad):
    """Each bad value (or unknown key) is refused by both packages."""
    from speakingstyle_tpu.configs import config as jc
    from speakingstyle_torch.configs import config as tc

    path = tmp_path / "train.yaml"
    path.write_text(yaml.safe_dump({"serve": bad}))
    for load in (jc.load_config, tc.load_config):
        with pytest.raises((ValueError, TypeError)):
            load(train=str(path))


def port_fleet(tmp, gate=None, replicas=2, serve=SERVE_ONE):
    """A port FleetRouter of ``replicas`` CPU engines over one model (seed-0
    weights, the duration bias raised by 1.1), one vocoder and one shared
    StyleService; ``gate`` (an Event) holds every warm-up until set."""
    from speakingstyle_torch.obs import MetricsRegistry
    from speakingstyle_torch.serving.engine import SynthesisEngine
    from speakingstyle_torch.serving.fleet import FleetRouter
    from speakingstyle_torch.serving.style import StyleService

    base = build_port_engine(tmp, serve=serve)
    registry = MetricsRegistry()
    style = StyleService(base.cfg, base.model.reference_encoder, device="cpu",
                         registry=registry)

    def factory(reg):
        if gate is not None:
            gate.wait(timeout=TIMEOUT)
        return SynthesisEngine(base.cfg, model=base.model, vocoder=base.vocoder, device="cpu",
                               registry=reg, style=style)

    return FleetRouter(factory, base.cfg, replicas=replicas, registry=registry, style=style)


def test_router_backend_healthz_states_programs_and_streams(tmp_path):
    """A server over a 2-replica router: /healthz answers 503 with each
    replica's lifecycle state while they warm, 200 once one is ready;
    /synthesize answers through the router (X-Model-Version from the
    router), /debug/programs covers every replica's engine and the shared
    style programs once, a stream goes through ``router.stream`` and equals
    the depth-1 stream of its result, and shutdown closes the router."""
    from speakingstyle_torch.serving import streaming
    from speakingstyle_torch.serving.frontend import TextFrontend
    from speakingstyle_torch.serving.server import SynthesisServer

    gate = threading.Event()
    router = port_fleet(tmp_path, gate)
    router.set_model_version("3:abcdef", 3, "abcdef0123")
    ref = np.random.default_rng(0).standard_normal((20, 80)).astype(np.float32)
    server = SynthesisServer(frontend=TextFrontend(router.cfg, ref), host="127.0.0.1", port=0,
                             router=router)
    thread = start(server)
    try:
        status, _, body = call(server, "GET", "/healthz")
        health = json.loads(body)
        assert status == 503 and health["ready"] is False
        assert health["replicas"] == {"0": "warming", "1": "warming"}
        gate.set()
        assert router.wait_ready(timeout=TIMEOUT, n=2)
        status, _, body = call(server, "GET", "/healthz")
        health = json.loads(body)
        assert status == 200 and health["replicas"] == {"0": "ready", "1": "ready"}
        assert health["model"] == {"version": "3:abcdef", "step": 3,
                                   "weights_digest": "abcdef0123"}
        assert health["lattice_points"] == len(router.lattice)
        status, headers, body = call(server, "POST", "/synthesize", {"text": "hello there"})
        assert status == 200 and pcm(body).size > 0
        assert headers["X-Model-Version"] == "3:abcdef"
        status, _, body = call(server, "GET", "/debug/programs")
        rows = json.loads(body)["programs"]
        kinds = [r.get("label_kind") for r in rows]
        assert kinds.count("acoustic") == 2 and kinds.count("vocoder") == 2
        assert kinds.count("style") == len(router.style.lattice)
        payload = {"text": "speak softly now"}
        status, headers, body = call(server, "POST", "/synthesize/stream", payload)
        assert status == 200 and headers["Transfer-Encoding"] == "chunked"
        result = server.synthesize(payload, stream=True)
        engine = router.engine_at(result.replica)
        fleet = router.cfg.serve.fleet
        overlap = streaming.resolve_overlap(fleet.stream_overlap, engine.vocoder)
        depth1 = b"".join(c.tobytes() for c in streaming.stream_wav(
            engine, result, fleet.stream_window, overlap, depth=1))
        assert body[44:] == depth1
        status, _, body = call(server, "POST", "/admin/rollout", {"step": 4})
        assert status == 404
    finally:
        gate.set()
        stop(server, thread)
    assert all(s == "stopped" for s in router.states().values())


def test_router_backend_waits_no_longer_than_the_class_deadline(tmp_path):
    """Behind a router a handler waits for its request no longer than its
    class budget plus the grace: with no replica ever ready, a request
    answers 504 within about that."""
    from speakingstyle_torch.serving.frontend import TextFrontend
    from speakingstyle_torch.serving.server import SynthesisServer

    gate = threading.Event()
    serve = dict(SERVE_ONE, fleet={"stream_window": 8, "deadline_grace_ms": 50.0,
                                   "class_deadline_ms": {"interactive": 100.0,
                                                         "batch": 200.0}})
    router = port_fleet(tmp_path, gate, replicas=1, serve=serve)
    server = SynthesisServer(frontend=TextFrontend(router.cfg), host="127.0.0.1", port=0,
                             router=router)
    thread = start(server)
    try:
        t0 = time.monotonic()
        status, headers, body = call(server, "POST", "/synthesize", {"text": "hello"})
        # the router's DeadlineExceeded or the handler's own bound, a 504
        # either way, long before REQUEST_TIMEOUT_S
        assert status == 504 and json.loads(body)["id"] == headers["X-Request-Id"]
        assert time.monotonic() - t0 < 5.0
        assert server._result_timeout(SimpleNamespace(priority="batch", arrival=time.monotonic())) \
            <= 0.25 + 1e-6
    finally:
        gate.set()
        stop(server, thread)
