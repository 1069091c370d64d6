"""PyTorch port, the sequence axis: ring attention (parallel/ring_attention.py),
``attention_impl="ring"`` and the ring long-form tier (serving/longform.py's
``RingTier`` and ``LongformService``'s ring path), held against the JAX
package on the CPU.

The ranks of a ring are threads of this process over one ``HashStore``,
each with its own gloo group (the server's helper rank processes run the
same ``ring_ranks.run_helper``). The twins:

* ``tests/test_parallel.py:48``: the port's 2- and 4-rank ring equals its
  plain one-process version ``ring_attention_reference`` bit for bit, and
  both are within 1e-5 of the JAX ring on the 8-device CPU mesh and of
  dense attention (f32), with and without a key-pad bias;
* ``tests/test_parallel.py:195``: the port's ring model on 2 ranks at T =
  1280 (past ``max_seq_len``), teacher forced, within 2e-4 of the JAX
  dense model on the same weights (JAX's own bound); ``build_model``
  without a seq mesh raises the JAX package's error;
* ``tests/test_longform.py:617``: the port's 2-rank ``RingTier`` at
  ``b1.s32.m64`` (the ``:537`` config) within 2e-4 of the JAX ``RingTier``
  on the same weights and style vector, and of the port's dense free run;
  a repeat chapter prepares nothing and equals the first; the program
  card's labels;
* ``tests/test_longform.py:318``: ``longform_ring_error@1`` degrades the
  chapter to chunked, counted, in both packages;
* ``tests/test_longform.py:680``: over HTTP a chapter that fits is admitted
  to the ring and answered with ``X-Longform-Tier: ring``;
* a helper that stops: the chapter then is degraded to chunked within the
  group's timeout, and the next one is admitted chunked.
"""

import dataclasses
import threading
import time
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import yaml

from test_torch_longform import FakeBackend, FakeFrontend, chapter, pkg, svc_cfg
from test_torch_models import numpy_variables, one_cpu_thread  # noqa: F401 (an autouse fixture)
from test_torch_server import LEXICON, call, start, stop
from test_torch_synthesis import GEN_TOPO, STATS

# seconds a thread rank's collective waits in these tests
TIMEOUT_S = 20.0
# the JAX package's own bounds: ring against dense (f32)
RING_ATOL = 1e-5
MODEL_ATOL = 2e-4
NEG = -1e9  # the key-pad bias of tests/test_parallel.py:48


def thread_ranks(n, fn, timeout_s=TIMEOUT_S):
    """``fn(mesh)`` on ``n`` thread ranks of one sequence group; the
    results by rank (a rank's exception is raised here)."""
    from speakingstyle_torch.parallel.mesh import make_seq_mesh

    store = dist.HashStore()
    out, errors = {}, []

    def rank(r):
        try:
            out[r] = fn(make_seq_mesh(n, store, r, timeout_s=timeout_s))
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors.append(e)

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    if errors:
        raise errors[0]
    return [out[r] for r in range(n)]


# -- ring attention ---------------------------------------------------------------

def dense_attention(q, k, v, bias):
    logits = np.einsum("bhqd,bhkd->bhqk", q, k) * q.shape[-1] ** -0.5
    if bias is not None:
        logits = logits + bias
    p = np.exp(logits - logits.max(-1, keepdims=True))
    return np.einsum("bhqk,bhkd->bhqd", p / p.sum(-1, keepdims=True), v)


@pytest.mark.parametrize("with_bias", [False, True])
def test_ring_attention_matches_the_jax_ring_and_dense(with_bias):
    from speakingstyle_torch.parallel.ring_attention import (
        BACKWARD_MISSING, ring_attention_reference, ring_self_attention)
    from speakingstyle_tpu.parallel.mesh import make_seq_mesh as j_seq_mesh
    from speakingstyle_tpu.parallel.ring_attention import ring_self_attention as j_ring

    B, H, L, D = 2, 4, 64, 16
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((B, H, L, D)).astype(np.float32) for _ in range(3))
    bias = None
    if with_bias:  # the last 10 keys of row 1 padded
        bias = np.zeros((B, 1, 1, L), np.float32)
        bias[1, :, :, -10:] = NEG
    want = np.asarray(j_ring(q, k, v, None if bias is None else jnp.asarray(bias),
                             mesh=j_seq_mesh()))  # 8-way
    dense = dense_attention(q, k, v, bias)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    tb = None if bias is None else torch.from_numpy(bias)
    for n in (2, 4):
        ref = ring_attention_reference(*t, tb, n).numpy()
        for got in thread_ranks(n, lambda mesh: ring_self_attention(*t, tb, mesh)):
            np.testing.assert_array_equal(got.numpy(), ref)
        np.testing.assert_allclose(ref, want, atol=RING_ATOL)
        np.testing.assert_allclose(ref, dense, atol=RING_ATOL)
    # inference only: autograd through the ring names ROADMAP item 6c-ii
    with pytest.raises(NotImplementedError, match="6c-ii"):
        thread_ranks(2, lambda mesh: ring_self_attention(
            t[0].clone().requires_grad_(), t[1], t[2], tb, mesh))
    assert "6c-ii" in BACKWARD_MISSING


# -- the ring model ---------------------------------------------------------------

# tests/test_parallel.py::_tiny_cfg
PARALLEL_MODEL = {
    "transformer": {"encoder_layer": 1, "decoder_layer": 1, "encoder_hidden": 16,
                    "decoder_hidden": 16, "encoder_head": 2, "decoder_head": 2,
                    "conv_filter_size": 32},
    "reference_encoder": {"encoder_layer": 1, "conv_layer": 1, "encoder_hidden": 16,
                          "encoder_head": 2, "conv_filter_size": 16},
    "variance_predictor": {"filter_size": 16},
    "compute_dtype": "float32",
}


def load_model_yaml(tmp_path, model, train=None):
    """(port cfg, JAX cfg) of one model.yaml (and train.yaml)."""
    from speakingstyle_torch.configs.config import load_config
    from speakingstyle_tpu.configs.config import load_config as j_load

    (tmp_path / "model.yaml").write_text(yaml.safe_dump(model))
    paths = {"model": str(tmp_path / "model.yaml")}
    if train is not None:
        (tmp_path / "train.yaml").write_text(yaml.safe_dump(train))
        paths["train"] = str(tmp_path / "train.yaml")
    return load_config(**paths), j_load(**paths)


def test_ring_model_past_max_seq_len_matches_the_jax_dense_model(tmp_path):
    """T = 1280 frames (max_seq_len 1000), teacher forced: the port's ring
    model on 2 ranks against the JAX dense model, the same weights."""
    from speakingstyle_torch.compat.from_jax import load_flax_variables
    from speakingstyle_torch.models.factory import build_model
    from speakingstyle_tpu.models.factory import build_model as j_build

    cfg, jcfg = load_model_yaml(tmp_path, PARALLEL_MODEL)
    B, L, T = 2, 64, 1280
    d = T // L
    rng = np.random.default_rng(0)
    kw = dict(
        speakers=np.zeros((B,), np.int32), texts=rng.integers(1, 300, (B, L)).astype(np.int32),
        src_lens=np.asarray([L, L - 8], np.int32),
        mels=rng.standard_normal((B, T, 80)).astype(np.float32),
        mel_lens=np.asarray([T, T - 8 * d], np.int32), max_mel_len=T,
        p_targets=rng.standard_normal((B, L)).astype(np.float32),
        e_targets=rng.standard_normal((B, L)).astype(np.float32),
        d_targets=np.full((B, L), d, np.int32))
    dense = j_build(jcfg, n_position=T + 1)
    variables = numpy_variables(dense, *(jnp.asarray(kw[k]) for k in ("speakers", "texts",
                                                                       "src_lens")),
                                mels=jnp.zeros((B, 8, 80)), mel_lens=jnp.full((B,), 8),
                                max_mel_len=8, p_targets=jnp.zeros((B, L)),
                                e_targets=jnp.zeros((B, L)),
                                d_targets=jnp.ones((B, L), jnp.int32), seed=3)
    want = np.asarray(dense.apply(variables, deterministic=True,
                                  **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                                     for k, v in kw.items()})["mel_postnet"])

    ring_cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model,
                                                                  attention_impl="ring"))
    targs = {k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v)
             for k, v in kw.items() if isinstance(v, np.ndarray)}

    def ring_rank(mesh):
        model = load_flax_variables(build_model(ring_cfg, n_position=T + 1, seq_mesh=mesh),
                                    variables).eval()
        with torch.no_grad():
            return model(max_mel_len=T, **targs)["mel_postnet"].numpy()

    for got in thread_ranks(2, ring_rank):
        np.testing.assert_allclose(got, want, atol=MODEL_ATOL)
    # a ring model refuses to build without a mesh, in both packages alike
    j_ring_cfg = dataclasses.replace(jcfg, model=dataclasses.replace(jcfg.model,
                                                                     attention_impl="ring"))
    with pytest.raises(ValueError) as j_err:
        j_build(j_ring_cfg)
    with pytest.raises(ValueError) as t_err:
        build_model(ring_cfg)
    assert str(t_err.value) == str(j_err.value)
    # and a ring config asks for the f32 softmax, as the JAX config does
    with pytest.raises(ValueError, match="float32"):
        dataclasses.replace(ring_cfg.model, attention_softmax_dtype="bfloat16")


# -- the ring long-form tier --------------------------------------------------------

# tests/test_longform.py::_tiny_cfg (the :537 config) with the ring tier
RING_MODEL = {
    "transformer": {"encoder_layer": 1, "decoder_layer": 1, "encoder_hidden": 16,
                    "decoder_hidden": 16, "conv_filter_size": 16, "conv_kernel_size": [3, 1]},
    "reference_encoder": {"encoder_layer": 1, "encoder_head": 2, "encoder_hidden": 16,
                          "conv_layer": 1, "conv_filter_size": 16},
    "variance_predictor": {"filter_size": 16},
    "variance_embedding": {"n_bins": 8},
    "postnet_embedding_dim": 16, "postnet_layers": 2, "max_seq_len": 48,
    "compute_dtype": "float32",
}
RING_SERVE = {
    "batch_buckets": [1, 2], "src_buckets": [16], "mel_buckets": [32], "frames_per_phoneme": 2,
    "max_wait_ms": 20.0, "style": {"ref_buckets": [32]},
    "longform": {"mesh_seq": 2, "src_buckets": [32], "mel_buckets": [64],
                 "crossfade_frames": 1, "deadline_ms_per_chunk": 30000.0},
}


@pytest.fixture(scope="module")
def ring_setup(tmp_path_factory):
    """(port cfg, JAX cfg, JAX variables, port engine): the :537 config as
    YAML loaded by both packages, seeded numpy weights (the duration bias
    raised by 1.1 so random weights predict frames), a port engine with a
    tiny HiFi-GAN on the CPU, its model built by ``build_model`` as the JAX
    ``RingTier`` builds its own (the same variance bins)."""
    from speakingstyle_torch.compat.from_jax import load_flax_variables
    from speakingstyle_torch.configs.config import load_config
    from speakingstyle_torch.models import hifigan as th
    from speakingstyle_torch.models.factory import build_model, init_weights
    from speakingstyle_torch.serving.engine import SynthesisEngine
    from speakingstyle_tpu.configs.config import load_config as j_load
    from speakingstyle_tpu.models.fastspeech2 import FastSpeech2 as JFS2

    tmp = tmp_path_factory.mktemp("ring")
    (tmp / "lexicon.txt").write_text(LEXICON)
    (tmp / "preprocess.yaml").write_text(yaml.safe_dump(
        {"path": {"lexicon_path": str(tmp / "lexicon.txt")}}))
    (tmp / "model.yaml").write_text(yaml.safe_dump(RING_MODEL))
    (tmp / "train.yaml").write_text(yaml.safe_dump({"serve": RING_SERVE}))
    paths = [str(tmp / f) for f in ("preprocess.yaml", "model.yaml", "train.yaml")]
    cfg, jcfg = load_config(*paths), j_load(*paths)
    B, L = 1, 8
    variables = numpy_variables(
        JFS2(config=jcfg, **STATS), jnp.zeros((B,), jnp.int32), jnp.ones((B, L), jnp.int32),
        jnp.full((B,), L), mels=jnp.zeros((B, 8, 80)), mel_lens=jnp.full((B,), 8),
        max_mel_len=16, p_targets=jnp.zeros((B, L)), e_targets=jnp.zeros((B, L)),
        d_targets=jnp.full((B, L), 2, jnp.int32), seed=5)
    dp = variables["params"]["variance_adaptor"]["duration_predictor"]["linear_layer"]
    dp["bias"] = dp["bias"] + 1.1
    # the dataset statistics' defaults, as the JAX RingTier's build_model
    model = load_flax_variables(build_model(cfg, n_position=49), variables)
    gen = init_weights(th.Generator(80, **GEN_TOPO), 1)
    engine = SynthesisEngine(cfg, model=model, vocoder=gen, device="cpu")
    return cfg, jcfg, variables, engine


def start_ring(cfg, engine, timeout_s=TIMEOUT_S, keep_waiting=lambda: True,
               program_registry=None):
    """A port RingTier over ``engine``'s model, its helper rank on a thread;
    returns (tier, helper thread)."""
    from speakingstyle_torch.serving.longform import RingTier
    from speakingstyle_torch.serving.ring_ranks import run_helper

    store = dist.HashStore()
    stopped = []

    def helper_rank():
        try:
            run_helper(store, 1, keep_waiting)
        except RuntimeError as e:  # told to stop waiting, or its group failed
            stopped.append(e)

    helper = threading.Thread(target=helper_rank, daemon=True)
    helper.start()
    ring = RingTier(cfg, engine.model, engine, program_registry=program_registry, store=store,
                    timeout_s=timeout_s)
    ring.precompile()
    return ring, helper


@pytest.fixture(scope="module")
def ring_tier(ring_setup):
    cfg, _, _, engine = ring_setup
    ring, helper = start_ring(cfg, engine)
    yield ring
    ring.close()
    helper.join(timeout=30)
    assert not helper.is_alive()


def style_vectors(seed=7, d=16):
    from speakingstyle_torch.serving.style import StyleVectors

    rng = np.random.default_rng(seed)
    return StyleVectors(gamma=(rng.standard_normal(d) * 0.1).astype(np.float32),
                        beta=(rng.standard_normal(d) * 0.1).astype(np.float32))


def test_ring_tier_matches_the_jax_ring_tier_and_the_dense_free_run(ring_setup, ring_tier):
    from speakingstyle_torch.models.factory import build_model
    from speakingstyle_torch.serving.engine import SynthesisRequest
    from speakingstyle_tpu.obs import MetricsRegistry as JRegistry
    from speakingstyle_tpu.parallel.registry import ProgramRegistry as JProgramRegistry
    from speakingstyle_tpu.serving.engine import SynthesisRequest as JRequest
    from speakingstyle_tpu.serving.longform import RingTier as JRingTier
    from speakingstyle_tpu.serving.pool import BufferPool as JPool

    cfg, jcfg, variables, engine = ring_setup
    rng = np.random.default_rng(3)
    n = 24  # past the interactive src bucket (16), inside the ring's 32
    seq = rng.integers(1, 300, n).astype(np.int32)
    sv = style_vectors()
    compiles = engine.compile_count
    result = ring_tier.synthesize(SynthesisRequest(id="ch0", sequence=seq, style=sv))
    assert result.bucket.l_src == 32 and result.bucket.t_mel == 64
    assert 0 < result.mel_len <= 64 and result.mel.shape == (result.mel_len, 80)
    assert result.wav is None  # mel-only: the vocoder streams it

    # the JAX RingTier on the same weights and style (2 of the 8 CPU devices)
    jreg = JRegistry()
    jengine = SimpleNamespace(registry=jreg, program_registry=JProgramRegistry(jreg),
                              pool=JPool(jreg), style=None)
    jring = JRingTier(jcfg, variables, jengine)
    want = jring.synthesize(JRequest(id="ch0", sequence=seq, ref_mel=None, style=sv))
    assert want.mel_len == result.mel_len
    np.testing.assert_array_equal(result.durations, want.durations)
    np.testing.assert_allclose(result.mel, want.mel, atol=MODEL_ATOL)

    # the port's dense free run at the same padded geometry
    dense = build_model(cfg, n_position=65)
    dense.load_state_dict(engine.model.state_dict())
    dense.variance_adaptor.pitch_bins.copy_(engine.model.variance_adaptor.pitch_bins)
    dense.variance_adaptor.energy_bins.copy_(engine.model.variance_adaptor.energy_bins)
    texts = torch.zeros((1, 32), dtype=torch.int64)
    texts[0, :n] = torch.from_numpy(seq)
    with torch.no_grad():
        out = dense.eval()(torch.zeros(1, dtype=torch.int64), texts, torch.tensor([n]),
                           max_mel_len=64, p_control=torch.ones(1, 32),
                           e_control=torch.ones(1, 32), d_control=torch.ones(1, 32),
                           gammas=torch.from_numpy(sv.gamma).reshape(1, 1, -1),
                           betas=torch.from_numpy(sv.beta).reshape(1, 1, -1))
    assert int(out["mel_lens"][0]) == result.mel_len
    np.testing.assert_allclose(result.mel, out["mel_postnet"][0, :result.mel_len].numpy(),
                               atol=MODEL_ATOL)

    # steady state: a repeat prepares nothing and equals the first
    again = ring_tier.synthesize(SynthesisRequest(id="ch1", sequence=seq, style=sv))
    assert engine.compile_count == compiles
    np.testing.assert_allclose(again.mel, result.mel, atol=1e-5)
    # the preparation minted a card on the engine's registry
    card = next(c for c in engine.programs() if c["name"] == "acoustic_ring:b1.s32.m64")
    assert card["flops"] > 0 and card["graph"] is False
    assert card["label_kind"] == "acoustic_ring" and card["label_mesh"] == "seq2"
    assert card["label_bucket"] == "b1.s32.m64"
    assert engine.registry.histogram("serve_longform_ring_seconds").count >= 2


@pytest.mark.parametrize("name", ("torch", "tpu"))
def test_a_ring_failure_degrades_to_chunked_counted(name, tmp_path):
    """``longform_ring_error@1``: the chapter admitted to the (stub) ring
    completes on the chunked tier; one degradation, counted and logged."""
    p = pkg(name)
    faults = __import__(f"speakingstyle_{name}.faults", fromlist=["FaultPlan"])
    reg = p.obs.MetricsRegistry()
    be = FakeBackend()
    vocoder = ("gen", "params") if name == "tpu" else object()
    svc = p.longform.LongformService(
        svc_cfg(p), FakeFrontend(), be, engine=SimpleNamespace(vocoder=vocoder),
        ring=SimpleNamespace(max_src=10_000, max_mel=100_000),
        fault_plan=faults.FaultPlan.parse("longform_ring_error@1"), registry=reg,
        events=p.obs.JsonlEventLog(str(tmp_path)))
    plan = svc.admit("lf1", chapter(4))
    assert plan.tier == "ring"
    wav = np.concatenate(list(svc.stream(plan)))
    assert plan.tier == "chunked"
    assert wav.size == plan.total_phonemes * 4 and len(be.requests) == 4
    assert reg.value("serve_longform_degraded_total") == 1.0
    assert reg.value("serve_longform_requests_total", {"tier": "ring"}) == 1.0
    assert reg.value("serve_longform_requests_total", {"tier": "chunked"}) == 1.0
    names = [r["event"] for r in p.obs.read_events(str(tmp_path))]
    assert names == ["longform_admit", "longform_degraded", "longform_done"]
    assert svc.fault_plan.pending() == []


def ref_mel():
    return np.random.default_rng(0).standard_normal((20, 80)).astype(np.float32)


def test_http_chapter_is_admitted_to_the_ring(ring_setup, ring_tier):
    """The ring tier attached (as ``serve`` attaches it): a chapter that
    fits is one ring free run, streamed through the engine's vocoder
    windows, and names its tier."""
    from speakingstyle_torch.serving.frontend import TextFrontend
    from speakingstyle_torch.serving.server import SynthesisServer

    cfg, _, _, engine = ring_setup
    server = SynthesisServer(engine, TextFrontend(cfg, ref_mel()), host="127.0.0.1", port=0)
    server.longform.ring = ring_tier
    thread = start(server)
    try:
        status, headers, body = call(server, "POST", "/synthesize/longform",
                                     {"text": "hello there world. speak softly now."})
        assert status == 200, body[:200]
        assert headers["X-Longform-Tier"] == "ring"
        assert body[:4] == b"RIFF" and len(body) > 44
        assert server.registry.value("serve_longform_requests_total", {"tier": "ring"}) == 1.0
    finally:
        stop(server, thread)


def test_a_stopped_helper_degrades_then_admits_chunked(ring_setup):
    """The helper rank stops: the next ring chapter fails within the
    group's timeout and is answered chunked (counted), and the chapter
    after it is admitted chunked; the server stays up."""
    from speakingstyle_torch.serving.frontend import TextFrontend
    from speakingstyle_torch.serving.server import SynthesisServer

    from speakingstyle_torch.parallel.registry import ProgramRegistry

    cfg, _, _, engine = ring_setup
    timeout_s, gone = 2.0, threading.Event()
    # a second tier on the engine: its programs in a registry of their own
    ring, helper = start_ring(cfg, engine, timeout_s, keep_waiting=lambda: not gone.is_set(),
                              program_registry=ProgramRegistry(engine.registry))
    server = SynthesisServer(engine, TextFrontend(cfg, ref_mel()), host="127.0.0.1", port=0)
    server.longform.ring = ring
    thread = start(server)
    try:
        gone.set()
        helper.join(timeout=10)
        assert not helper.is_alive()
        text = {"text": "hello there world. speak softly now."}
        reg = server.registry  # the engine's, shared with the module's other servers
        counts = lambda: (reg.value("serve_longform_degraded_total"),  # noqa: E731
                          reg.value("serve_longform_requests_total", {"tier": "ring"}),
                          reg.value("serve_longform_requests_total", {"tier": "chunked"}))
        before = counts()
        t0 = time.monotonic()
        status, headers, _ = call(server, "POST", "/synthesize/longform", text)
        assert status == 200 and headers["X-Longform-Tier"] == "chunked"
        assert time.monotonic() - t0 < timeout_s + 15
        assert not ring.available and ring.group.broken
        status, headers, _ = call(server, "POST", "/synthesize/longform", text)
        assert status == 200 and headers["X-Longform-Tier"] == "chunked"
        # one degradation: admitted ring once, served chunked twice
        assert [a - b for a, b in zip(counts(), before)] == [1.0, 1.0, 2.0]
        assert call(server, "POST", "/synthesize", {"text": "hello there."})[0] == 200
    finally:
        stop(server, thread)
        ring.close()
