"""PyTorch port, the chunked long-form tier (serving/longform.py) and
``POST /synthesize/longform``, held against the JAX package's
``LongformService``.

Four layers, the chunked cases of ``tests/test_longform.py``:

* the chunker: ``split_sentences`` and ``plan_chunks`` give the JAX
  package's chunk sequences exactly, on the same texts and encoders;
* the stitcher: bit-identical output to the JAX ``Stitcher`` on identical
  pieces (fades 0 to past a chunk), the same seam meters, and a tail never
  longer than the fade;
* the service over a fake backend, both packages with the same
  expectations: the deadline-sharing group, the in-flight bound, the
  cancelled tail of an abandoned chapter, admission checks; and the
  chapter's group in the port's fleet router's EDF heap;
* a whole chapter over HTTP: a port server and a JAX server on one engine
  each over the same weights (carried across by ``compat.from_jax``; the JAX
  Pallas kernels in interpret mode) answer a chapter with the same chunk
  plan and stitched wavs within 4 LSB (each engine's wav within 2 LSB of
  the other's at f32, through the crossfade's sin + cos <= sqrt(2) and its
  int16 rounding); the 413 body's pointer and the ``max_chunks`` 413.

The ring tier's cases (``tests/test_longform.py:318``, ``:617``, ``:680``)
are in ``tests/test_torch_ring.py``; here a service without a ring admits
every tier as chunked, as the JAX service does.
"""

import importlib
import json
import threading
import time
from concurrent.futures import Future
from types import SimpleNamespace

import jax
import numpy as np
import pytest

from test_torch_models import one_cpu_thread  # noqa: F401 (an autouse fixture)
from test_torch_server import (  # noqa: F401 (jax_weights is a fixture)
    GEN_TOPO, SERVE_ONE, STATS, build_port_engine, call, jax_weights, pcm, start, stop,
    write_configs)

PKGS = ("torch", "tpu")
TIMEOUT = 60
# the chapter endpoint's LSB bound between the packages (module docstring)
CHAPTER_LSB = 4


def pkg(name):
    mod = lambda m: importlib.import_module(f"speakingstyle_{name}.{m}")  # noqa: E731
    return SimpleNamespace(config=mod("configs.config"), longform=mod("serving.longform"),
                           lattice=mod("serving.lattice"), engine=mod("serving.engine"),
                           fleet=mod("serving.fleet"), obs=mod("obs"))


def enc(ids_per_word=3):
    """A deterministic fake G2P: ``ids_per_word`` ids a whitespace word."""
    def encode(text):
        return (np.arange(len(text.split()) * ids_per_word, dtype=np.int32) % 61) + 1
    return encode


# -- the chunker --------------------------------------------------------------

TEXTS = {
    "unicode": "こんにちは。\n今日は良い天気です。 Bonjour! Ça va? Fin…  ok.",
    "no_punctuation": "no punctuation at all",
    "empty": "",
    "blank": "   \n\t ",
    "sentences": " ".join(f"alpha beta s{i}." for i in range(7)),
    "uneven": "One. Two words here! A much longer third sentence follows it? End.",
}


@pytest.mark.parametrize("case", sorted(TEXTS))
def test_split_sentences_equals_jax(case):
    got = pkg("torch").longform.split_sentences(TEXTS[case])
    assert got == pkg("tpu").longform.split_sentences(TEXTS[case])


PLANS = {
    "packed": (TEXTS["sentences"], 3, 20, 0),
    "one_a_chunk": (TEXTS["sentences"], 3, 9, 0),
    "uneven": (TEXTS["uneven"], 2, 7, 0),
    "giant": ("one giant sentence no punct " * 4, 1, 5, 0),
    "unicode": (TEXTS["unicode"], 4, 6, 0),
    "empty": ("", 3, 10, 0),
    "capped_fits": (TEXTS["sentences"], 3, 9, 7),
}


@pytest.mark.parametrize("case", sorted(PLANS))
def test_plan_chunks_equals_jax(case):
    """The same chunks: index, text, sentence count and the id sequence,
    exactly; and the sequences concatenate to the chapter's."""
    text, per_word, cap, max_chunks = PLANS[case]
    got = pkg("torch").longform.plan_chunks(text, enc(per_word), cap, max_chunks)
    want = pkg("tpu").longform.plan_chunks(text, enc(per_word), cap, max_chunks)
    assert [(c.index, c.text, c.n_sentences) for c in got] == \
        [(c.index, c.text, c.n_sentences) for c in want]
    for g, w in zip(got, want):
        assert g.sequence.dtype == np.int32 and 0 < g.sequence.size <= cap
        np.testing.assert_array_equal(g.sequence, w.sequence)
    split = pkg("torch").longform.split_sentences(text)
    whole = np.concatenate([enc(per_word)(s) for s in split] or [np.empty(0, np.int32)])
    np.testing.assert_array_equal(
        np.concatenate([c.sequence for c in got] or [np.empty(0, np.int32)]), whole)


@pytest.mark.parametrize("name", PKGS)
def test_plan_chunks_admission_cap_and_bad_cap(name):
    p = pkg(name)
    text = " ".join(f"w{i}." for i in range(30))
    with pytest.raises(p.lattice.RequestTooLarge, match="max_chunks"):
        p.longform.plan_chunks(text, enc(), max_phonemes=3, max_chunks=8)
    assert len(p.longform.plan_chunks(text, enc(), max_phonemes=3)) == 30
    assert p.longform.plan_chunks("... ...", lambda s: np.empty(0, np.int32), 10) == []
    with pytest.raises(ValueError):
        p.longform.plan_chunks("x", enc(), 0)


# -- the stitcher ---------------------------------------------------------------

def stitch(name, wavs, fade):
    st = pkg(name).longform.Stitcher(fade)
    pieces, tails = [], []
    for w in wavs:
        pieces.extend(st.feed(w))
        tails.append(0 if st._tail is None else st._tail.size)
    pieces.extend(st.finish())
    return np.concatenate(pieces), st.seam_rms, tails


@pytest.mark.parametrize("fade", [0, 1, 16, 50, 200])
def test_stitcher_bit_identical_to_jax(fade):
    """Identical int16 pieces (lengths 3-150 samples, some shorter than the
    fade) stitch to the JAX package's samples bit for bit, with the same
    seam meters; the tail held between chunks never exceeds the fade."""
    rng = np.random.default_rng(fade + 7)
    wavs = [rng.integers(-20000, 20000, int(n)).astype(np.int16)
            for n in rng.integers(3, 150, 9)]
    got, rms, tails = stitch("torch", wavs, fade)
    want, want_rms, _ = stitch("tpu", wavs, fade)
    assert got.dtype == np.int16
    np.testing.assert_array_equal(got, want)
    assert rms == want_rms and len(rms) == len(wavs) - 1
    assert max(tails) <= fade


@pytest.mark.parametrize("name", PKGS)
def test_stitcher_memory_is_bounded_by_the_fade(name):
    st = pkg(name).longform.Stitcher(8)
    rng = np.random.default_rng(2)
    for _ in range(50):
        st.feed(rng.integers(-5, 5, 64).astype(np.int16))
        assert st._tail is not None and st._tail.size <= 8
    assert st.feed(np.empty(0, np.int16)) == []
    with pytest.raises(ValueError):
        pkg(name).longform.Stitcher(-1)


# -- the service over a fake backend ---------------------------------------------

class FakeFrontend:
    """3 ids a word, no style, numeric speakers."""

    def sequence(self, text):
        return enc()(text)

    def resolve_style(self, payload):
        return None, None, False

    def speaker(self, spec):
        return int(spec)


class FakeBackend:
    """submit() returns lazily resolving futures of deterministic wavs and
    records the most futures ever outstanding (the memory bound)."""

    def __init__(self):
        self.requests, self.outstanding, self.max_outstanding, self.cancelled = [], 0, 0, 0

    def submit(self, req):
        self.requests.append(req)
        self.outstanding += 1
        self.max_outstanding = max(self.max_outstanding, self.outstanding)
        backend = self
        rng = np.random.default_rng(req.sequence.size + len(self.requests))
        wav = rng.integers(-3000, 3000, req.sequence.size * 4).astype(np.int16)

        class Fut:
            def result(self, timeout=None):
                backend.outstanding -= 1
                return SimpleNamespace(id=req.id, wav=wav)

            def cancel(self):
                backend.cancelled += 1
                return True

        return Fut()


def svc_cfg(p, **lf_kw):
    lf = dict(crossfade_frames=0, group_depth=2, max_chunks=16, deadline_ms_per_chunk=30_000.0)
    lf.update(lf_kw)
    c = p.config
    return c.Config(serve=c.ServeConfig(batch_buckets=[1, 2], src_buckets=[16],
                                        mel_buckets=[64], frames_per_phoneme=2,
                                        longform=c.LongformConfig(**lf)))


def chapter(n_sent=6):
    # 4 words = 12 ids a sentence; cap 16 -> one sentence a chunk
    return {"text": " ".join(f"alpha beta gamma s{i}." for i in range(n_sent))}


def service(p, backend, **lf_kw):
    return p.longform.LongformService(svc_cfg(p, **lf_kw), FakeFrontend(), backend,
                                      registry=p.obs.MetricsRegistry())


@pytest.mark.parametrize("name", PKGS)
def test_service_plans_a_deadline_sharing_group(name):
    p = pkg(name)
    be = FakeBackend()
    svc = service(p, be)
    assert svc.chunk_phoneme_cap == 16
    plan = svc.admit("lf1", chapter(6))
    assert plan.tier == "chunked" and len(plan.chunks) == 6 and plan.total_phonemes == 72
    assert plan.deadline_ms == 120_000.0  # 6 x 30 s clamped to fleet.max_deadline_ms
    assert svc.admit("lf2", chapter(2)).deadline_ms == 60_000.0
    wav = np.concatenate(list(svc.stream(plan)))
    assert [r.id for r in be.requests] == [f"lf1.c{i:03d}" for i in range(6)]
    assert all(r.priority == "batch" and r.arrival == plan.arrival
               and r.deadline_ms == plan.deadline_ms for r in be.requests)
    assert wav.size == 72 * 4
    assert svc.registry.value("serve_longform_requests_total", {"tier": "chunked"}) == 2.0
    assert svc.registry.value("serve_longform_chunks_total") == 6.0


@pytest.mark.parametrize("name", PKGS)
def test_service_in_flight_depth_is_bounded(name):
    be = FakeBackend()
    svc = service(pkg(name), be, group_depth=2)
    for _ in svc.stream(svc.admit("lf1", chapter(7))):
        pass
    assert be.max_outstanding == 2


@pytest.mark.parametrize("name", PKGS)
def test_service_abandoned_stream_cancels_pending_chunks(name):
    be = FakeBackend()
    svc = service(pkg(name), be, group_depth=3)
    gen = svc.stream(svc.admit("lf1", chapter(6)))
    next(gen)
    gen.close()
    assert be.cancelled >= 1 and len(be.requests) < 6


BAD_CHAPTERS = {
    "no_text": ({}, ValueError, "text"),
    "tier": ({"text": "hi there.", "tier": "warp"}, ValueError, "tier"),
    "list_control": ({"text": "hi there.", "duration_control": [1.0, 2.0]}, ValueError,
                     "scalar"),
    "bool_control": ({"text": "hi there.", "pitch_control": True}, ValueError, "scalar"),
    "too_many_chunks": (chapter(40), "RequestTooLarge", "max_chunks"),
}


@pytest.mark.parametrize("case", sorted(BAD_CHAPTERS))
def test_service_admission_refuses_as_jax(case):
    payload, exc, match = BAD_CHAPTERS[case]
    for name in PKGS:
        p = pkg(name)
        err = p.lattice.RequestTooLarge if exc == "RequestTooLarge" else exc
        with pytest.raises(err, match=match):
            service(p, FakeBackend()).admit("x", payload)


@pytest.mark.parametrize("name", PKGS)
def test_service_without_a_ring_admits_every_tier_as_chunked(name):
    svc = service(pkg(name), FakeBackend())
    for tier in ("auto", "chunked", "ring"):
        assert svc.admit("x", {"text": "hi there.", "tier": tier}).tier == "chunked"


def test_a_ring_tier_is_refused_naming_queue_a_item_6():
    """A ring tier is accepted since ROADMAP queue A item 6c-i (the name is
    kept from when it was refused): without an engine that vocodes, or
    past its buckets, a chapter is still admitted chunked, in both
    packages; the ring keys are validated alike."""
    for name in PKGS:
        p = pkg(name)
        ring = SimpleNamespace(max_src=12, max_mel=24)
        without_vocoder = p.longform.LongformService(svc_cfg(p), FakeFrontend(), FakeBackend(),
                                                     ring=ring)
        assert without_vocoder.admit("x", {"text": "hi there."}).tier == "chunked"
        vocoder = ("gen", "params") if name == "tpu" else object()
        svc = p.longform.LongformService(svc_cfg(p), FakeFrontend(), FakeBackend(),
                                         engine=SimpleNamespace(vocoder=vocoder), ring=ring,
                                         registry=p.obs.MetricsRegistry())
        assert svc.admit("x", {"text": "hi there."}).tier == "ring"  # 6 ids, 12 frames
        assert svc.admit("x", {"text": "hi there.", "tier": "chunked"}).tier == "chunked"
        assert svc.admit("x", chapter(2)).tier == "chunked"  # 24 ids: past max_src
        cfg = p.config.LongformConfig(mesh_seq=2, src_buckets=[512], mel_buckets=[6144])
        assert cfg.mesh_seq == 2
        with pytest.raises(ValueError, match="divisible"):
            p.config.LongformConfig(mesh_seq=3, src_buckets=[512], mel_buckets=[6144])


class GatedEngine:
    def __init__(self, gate):
        self.dispatches, self.gate, self.entered, self._first = [], gate, threading.Event(), True

    def precompile(self):
        return 0.0

    def run(self, requests):
        if self._first:
            self._first = False
            self.entered.set()
            self.gate.wait(timeout=TIMEOUT)
        self.dispatches.extend(r.id for r in requests)
        return [SimpleNamespace(id=r.id, bucket=None, mel_len=1) for r in requests]


@pytest.mark.parametrize("name", PKGS)
def test_chapter_group_rides_the_edf_heap_as_one_late_unit(name):
    """Chunks sharing one arrival and one deadline override dispatch after
    plain batch work, in submission order among themselves."""
    p = pkg(name)
    c = p.config
    cfg = c.Config(serve=c.ServeConfig(batch_buckets=[1], src_buckets=[16], mel_buckets=[64],
                                       frames_per_phoneme=2, max_wait_ms=5.0,
                                       fleet=c.FleetConfig(queue_depth=32)))
    gate = threading.Event()
    eng = GatedEngine(gate)
    router = p.fleet.FleetRouter(lambda reg: eng, cfg, replicas=1)
    try:
        assert router.wait_ready(timeout=TIMEOUT)

        def r(rid, **kw):
            return p.engine.SynthesisRequest(id=rid, sequence=np.ones(8, np.int32),
                                             ref_mel=np.zeros((4, 80), np.float32), **kw)

        futs = [router.submit(r("r0"))]
        assert eng.entered.wait(timeout=TIMEOUT)
        t0 = time.monotonic()
        for cid in ("lf.c000", "lf.c001"):
            futs.append(router.submit(r(cid, priority="batch", arrival=t0,
                                        deadline_ms=50_000.0)))
        futs.append(router.submit(r("b1", priority="batch")))
        futs.append(router.submit(r("i1", priority="interactive")))
        gate.set()
        for f in futs:
            f.result(timeout=TIMEOUT)
    finally:
        gate.set()
        router.close()
    assert eng.dispatches == ["r0", "i1", "b1", "lf.c000", "lf.c001"]


# -- a whole chapter over HTTP, both packages -------------------------------------

SERVE_LF = dict(SERVE_ONE, longform={"crossfade_frames": 1, "group_depth": 2, "max_chunks": 6,
                                     "deadline_ms_per_chunk": 30_000.0})
CHAPTER = ("hello there. speak softly now. hello world. speak now. hello there world. "
           "softly now. speak softly. hello.")


@pytest.fixture(scope="module")
def lf_servers(jax_weights, tmp_path_factory):  # noqa: F811
    """{"jax": server, "torch": server}: one engine each over the same
    weights, the serve block with a ``longform`` block (one YAML loads in
    both packages)."""
    from speakingstyle_tpu.configs.config import load_config as j_load
    from speakingstyle_tpu.models import hifigan as jh
    from speakingstyle_tpu.models.fastspeech2 import FastSpeech2 as JFS2
    from speakingstyle_tpu.ops import pallas_attention
    from speakingstyle_tpu.serving.engine import SynthesisEngine as JEngine
    from speakingstyle_tpu.serving.server import SynthesisServer as JServer
    from speakingstyle_tpu.serving.server import TextFrontend as JFrontend
    from speakingstyle_torch.serving.frontend import TextFrontend
    from speakingstyle_torch.serving.server import SynthesisServer

    tmp = tmp_path_factory.mktemp("longform")
    variables, gparams = jax_weights
    ref = np.random.default_rng(0).standard_normal((20, 80)).astype(np.float32)
    engine = build_port_engine(tmp, jax_weights, serve=SERVE_LF)
    engine.precompile()
    jcfg = j_load(*write_configs(tmp, serve=SERVE_LF))
    pallas_attention.FORCE_INTERPRET = True
    try:
        with jax.default_prng_impl("threefry2x32"):
            jengine = JEngine(jcfg, variables, vocoder=(jh.Generator(**GEN_TOPO), gparams),
                              model=JFS2(config=jcfg, **STATS))
            jengine.precompile()
    finally:
        pallas_attention.FORCE_INTERPRET = False
    out = {"jax": JServer(jengine, JFrontend(jcfg, ref), host="127.0.0.1", port=0),
           "torch": SynthesisServer(engine, TextFrontend(engine.cfg, ref), host="127.0.0.1",
                                    port=0)}
    threads = {k: start(s) for k, s in out.items()}
    yield out
    for k, s in out.items():
        stop(s, threads[k])


def test_chapter_over_http_matches_the_jax_service(lf_servers):
    """A chapter of 8 sentences: 200 in both, the same chunk plan in the
    headers, the stitched wavs within ``CHAPTER_LSB``; the port prepared
    nothing for it and counted each chunk and seam."""
    server = lf_servers["torch"]
    compiles = server.engine.compile_count
    got = {k: call(s, "POST", "/synthesize/longform", {"text": CHAPTER},
                   {"X-Trace-Id": "chapter"}) for k, s in lf_servers.items()}
    assert got["torch"][0] == got["jax"][0] == 200, {k: v[2][:200] for k, v in got.items()}
    (_, want_h, want_b), (_, headers, body) = got["jax"], got["torch"]
    assert headers["Content-Type"] == "audio/wav"
    assert headers["X-Longform-Tier"] == want_h["X-Longform-Tier"] == "chunked"
    n = int(headers["X-Longform-Chunks"])
    assert n == int(want_h["X-Longform-Chunks"]) >= 3
    assert headers["X-Request-Id"].startswith("req") and headers["X-Trace-Id"] == "chapter"
    wav, want = pcm(body), pcm(want_b)
    assert wav.shape == want.shape and wav.size > 0
    assert np.abs(wav.astype(np.int32) - want.astype(np.int32)).max() <= CHAPTER_LSB
    reg = server.registry
    assert server.engine.compile_count == compiles
    assert reg.value("serve_longform_chunks_total") >= n
    assert reg.histogram("serve_longform_seam_rms").count >= n - 1
    assert reg.histogram("serve_longform_ttfa_seconds").count >= 1


def test_chapter_past_max_chunks_is_a_413_with_max_chunks(lf_servers):
    """Past ``serve.longform.max_chunks`` both servers answer 413, the body
    naming the interactive ceilings, the endpoint and ``max_chunks``."""
    text = " ".join(["hello there world."] * 12)
    got = {k: call(s, "POST", "/synthesize/longform", {"text": text})
           for k, s in lf_servers.items()}
    assert got["torch"][0] == got["jax"][0] == 413
    body, want = json.loads(got["torch"][2]), json.loads(got["jax"][2])
    for key in ("max_src", "max_mel", "max_phonemes", "longform", "max_chunks"):
        assert body[key] == want[key]
    assert body["max_chunks"] == 6 and body["id"] == got["torch"][1]["X-Request-Id"]


def test_past_the_lattice_points_to_the_longform_endpoint(lf_servers):
    got = {k: call(s, "POST", "/synthesize", {"text": CHAPTER}) for k, s in lf_servers.items()}
    assert got["torch"][0] == got["jax"][0] == 413
    body = json.loads(got["torch"][2])
    assert body["longform"] == json.loads(got["jax"][2])["longform"] == "/synthesize/longform"


def test_chapter_behind_a_two_replica_fleet(tmp_path):
    """Behind a 2-replica port fleet (one model, one StyleService) the
    chapter answers 200, its chunks spread over the replicas as one
    deadline-sharing group, and the stitched wav equals the same plan run
    chunk by chunk on one replica's engine, bit for bit (the replicas share
    the weights; the CPU computes deterministically)."""
    from speakingstyle_torch.serving.frontend import TextFrontend
    from speakingstyle_torch.serving.longform import LongformService
    from speakingstyle_torch.serving.server import SynthesisServer
    from test_torch_server import port_fleet

    router = port_fleet(tmp_path, serve=SERVE_LF)
    assert router.wait_ready(timeout=TIMEOUT, n=2)
    ref = np.random.default_rng(0).standard_normal((20, 80)).astype(np.float32)
    frontend = TextFrontend(router.cfg, ref)
    server = SynthesisServer(frontend=frontend, host="127.0.0.1", port=0, router=router)
    thread = start(server)
    try:
        reg = router.registry
        before = [reg.value("serve_replica_requests_total", {"replica": str(i)})
                  for i in range(2)]
        status, headers, body = call(server, "POST", "/synthesize/longform", {"text": CHAPTER})
        assert status == 200, body
        n = int(headers["X-Longform-Chunks"])
        served = [reg.value("serve_replica_requests_total", {"replica": str(i)}) - before[i]
                  for i in range(2)]
        assert sum(served) == n >= 3

        class OneEngine:
            def submit(self, request):
                fut = Future()
                fut.set_result(router.engine_at(0).run([request])[0])
                return fut

        alone = LongformService(router.cfg, frontend, OneEngine())
        want = np.concatenate(list(alone.stream(alone.admit("one", {"text": CHAPTER}))))
        np.testing.assert_array_equal(pcm(body), want)
    finally:
        stop(server, thread)


BAD_HTTP = {
    "no_text": {},
    "list_control": {"text": "hello there.", "duration_control": [1.0, 2.0]},
    "unknown_speaker": {"text": "hello there.", "speaker_id": "ghost"},
    "tier": {"text": "hello there.", "tier": "warp"},
}


@pytest.mark.parametrize("case", sorted(BAD_HTTP))
def test_bad_chapters_answer_400_as_jax(lf_servers, case):
    got = {k: call(s, "POST", "/synthesize/longform", BAD_HTTP[case])
           for k, s in lf_servers.items()}
    assert got["torch"][0] == got["jax"][0] == 400
    err = json.loads(got["torch"][2])
    assert err["id"] == got["torch"][1]["X-Request-Id"]

