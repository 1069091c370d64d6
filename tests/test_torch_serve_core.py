"""PyTorch port, the serving engine core: the buffer pool, the lattice's
precision axis, the precision casts, the program registry and its cards,
the quality gate, the StyleService and ``SynthesisEngine.run`` per
precision tier, each held against the JAX package's twin at a tiny size.

Inputs come from numpy seeds; weights are the JAX package's variables
carried across by ``compat.from_jax``. The JAX engine runs its Pallas
attention kernel in interpret mode (``pallas_attention.FORCE_INTERPRET``,
as the ``interpret_kernels`` fixture sets it) with the threefry PRNG
pinned, as the JAX package's own tests run it. Tolerances:

* f32 and int8 tiers: durations equal, postnet mel within 2e-4, int16 wav
  within 2 LSB (the bar of the port's f32 engine test; int8 dequantizes
  to the same f32 weights bit for bit, then computes in f32);
* bf16 tier: durations equal; each row's mel and wav within the distance
  the JAX engine's own bf16 tier keeps from its f32 tier on that row, and
  over the batch (largest and mean distance) within ``BF16_SHARE`` of it.
  Both packages compute in bfloat16 but round at different places (the
  port widens the bf16 weights to f32 on read, so its LayerNorm,
  BatchNorm and FiLM see f32 statistics where Flax's BatchNorm keeps bf16
  arithmetic). The share is set from readings: the port's bf16 tier sits
  at 0.036-0.056 of JAX's bf16-to-f32 distance, an f32 computation on the
  bf16-rounded weights (a tier that does not compute in bf16) at 0.80-0.96;
  ``test_bf16_bound_rejects_f32_compute_on_bf16_weights`` holds that
  planted control outside the bound;
* the StyleService's (gamma, beta): 1e-5 (f32 sums in another order).
"""

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from test_torch_models import MODEL_YAML, one_cpu_thread  # noqa: F401 (an autouse fixture)
from test_torch_synthesis import GEN_TOPO, SERVE, SHAPES, STATS, jax_weights  # noqa: F401

PRECISIONS = ("f32", "bf16", "int8")
# the bf16 tier's batch distance to JAX's bf16 tier, as a share of JAX's own
# bf16-to-f32 distance (module docstring)
BF16_SHARE = 0.25
TIERED = dict(SERVE, tiers={"enabled": True, "precisions": list(PRECISIONS)})


def write_configs(tmp_path, serve=TIERED, **model_overrides):
    model = tmp_path / "model.yaml"
    model.write_text(yaml.safe_dump(dict(MODEL_YAML, **model_overrides)))
    train = tmp_path / "train.yaml"
    train.write_text(yaml.safe_dump({"serve": serve}))
    return str(model), str(train)


def request_inputs(seed=11, shapes=SHAPES):
    """(sequence, reference mel) pairs from a numpy seed."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(1, 300, L).astype(np.int32),
             rng.standard_normal((T, 80)).astype(np.float32)) for L, T in shapes]


def port_requests(inputs, **kw):
    from speakingstyle_torch.serving.engine import SynthesisRequest

    return [SynthesisRequest(id=f"u{i}", sequence=s, ref_mel=r, **kw)
            for i, (s, r) in enumerate(inputs)]


def port_engine(tmp_path, weights, serve=TIERED, **kw):
    from speakingstyle_torch.compat.from_jax import load_flax_variables
    from speakingstyle_torch.configs.config import load_config
    from speakingstyle_torch.models import hifigan as th
    from speakingstyle_torch.models.fastspeech2 import FastSpeech2
    from speakingstyle_torch.serving.engine import SynthesisEngine

    variables, gparams = weights
    model_yaml, train_yaml = write_configs(tmp_path, serve, attention_kernel="fused",
                                           conv_impl="pallas")
    cfg = load_config(model=model_yaml, train=train_yaml)
    return SynthesisEngine(
        cfg, model=load_flax_variables(FastSpeech2(cfg, **STATS), variables),
        vocoder=load_flax_variables(th.Generator(80, **GEN_TOPO), {"params": gparams}),
        device="cpu", **kw)


@pytest.fixture(scope="module")
def tier_runs(jax_weights, tmp_path_factory):  # noqa: F811
    """Both engines (tiers f32, bf16, int8; fused attention, the fused
    conv) over the same three requests at each precision: {precision:
    (JAX results, port results)}."""
    from speakingstyle_tpu.configs.config import load_config as j_load
    from speakingstyle_tpu.models import hifigan as jh
    from speakingstyle_tpu.models.fastspeech2 import FastSpeech2 as JFS2
    from speakingstyle_tpu.ops import pallas_attention
    from speakingstyle_tpu.serving.engine import SynthesisEngine as JEngine
    from speakingstyle_tpu.serving.engine import SynthesisRequest as JRequest

    tmp = tmp_path_factory.mktemp("tiers")
    variables, gparams = jax_weights
    model_yaml, train_yaml = write_configs(tmp, attention_kernel="fused", conv_impl="pallas")
    jcfg = j_load(model=model_yaml, train=train_yaml)
    engine = port_engine(tmp, jax_weights)
    runs = {}
    pallas_attention.FORCE_INTERPRET = True
    try:
        with jax.default_prng_impl("threefry2x32"):
            jengine = JEngine(jcfg, variables, vocoder=(jh.Generator(**GEN_TOPO), gparams),
                              model=JFS2(config=jcfg, **STATS))
            for prec in PRECISIONS:
                inputs = request_inputs()
                want = jengine.run([JRequest(id=f"u{i}", sequence=s, ref_mel=r, precision=prec)
                                    for i, (s, r) in enumerate(inputs)])
                runs[prec] = (want, engine.run(port_requests(inputs, precision=prec)))
    finally:
        pallas_attention.FORCE_INTERPRET = False
    return runs, engine


# -- the buffer pool ----------------------------------------------------------

def _pool_case(case, pool):
    if case == "reuse":
        a = pool.acquire((2, 3), np.float32)
        pool.release(a)
        b = pool.acquire((2, 3), torch.float32, fill=1)
        assert b is a and torch.equal(b, torch.ones(2, 3))
        assert (pool.allocated, pool.registry.value("serve_pool_reuses_total")) == (1, 1)
        pool.release(b)
    elif case == "keys":
        bufs = [pool.acquire((4,), np.int64), pool.acquire((4,), np.float32),
                pool.acquire((5,), np.float32), pool.acquire((4,), np.float32)]
        assert [b.dtype for b in bufs] == [torch.int64] + [torch.float32] * 3
        assert len({id(b) for b in bufs}) == 4 and pool.allocated == 4
        for b in bufs:
            pool.release(b)
    elif case == "outstanding":
        bufs = [pool.acquire((3,)) for _ in range(3)]
        assert pool.outstanding == 3 == pool.registry.value("serve_pool_outstanding")
        for b in bufs:
            pool.release(b)
        assert pool.outstanding == 0 == pool.registry.value("serve_pool_outstanding")
    elif case == "double_release":
        a = pool.acquire((2,))
        pool.release(a)
        with pytest.raises(ValueError, match="double release"):
            pool.release(a)
    elif case == "foreign":
        with pytest.raises(ValueError, match="not leased"):
            pool.release(torch.zeros(2))
    else:  # steady: a lattice's closed shape set stops allocating
        for _ in range(5):
            bufs = [pool.acquire(s) for s in ((4, 16), (4, 48), (4,))]
            for b in bufs:
                pool.release(b)
        assert pool.allocated == 3 and pool.registry.value("serve_pool_reuses_total") == 12


@pytest.mark.parametrize("case", ["reuse", "keys", "outstanding", "double_release", "foreign",
                                  "steady"])
def test_buffer_pool(case):
    """Leases reuse per (shape, dtype), report through the registry, and a
    double or foreign release raises (the JAX pool's contract)."""
    from speakingstyle_torch.serving.pool import BufferPool

    _pool_case(case, BufferPool())


# -- the lattice ---------------------------------------------------------------

@pytest.mark.parametrize("axes", [
    ([1, 2, 4, 8], [32, 64, 128, 256], [256, 512, 1000], ("f32",)),
    ([1, 4], [16], [48, 96], ("f32", "bf16", "int8")),
    ([2, 3], [5, 7, 11], [4, 9], ("int8", "f32")),
])
def test_lattice_matches_jax(axes):
    """``cover``, ``cover_window``, ``points``, ``len`` and
    ``geometry_count`` of both packages' lattices over a grid of request
    geometries, misses included."""
    from speakingstyle_tpu.serving import lattice as jl
    from speakingstyle_torch.serving import lattice as tl

    batch, src, mel, precs = axes
    j = jl.BucketLattice(batch, src, mel, precisions=precs)
    t = tl.BucketLattice(batch, src, mel, precisions=precs)
    assert [(p.b, p.l_src, p.t_mel) for p in t.points()] == \
        [(p.b, p.l_src, p.t_mel) for p in j.points()]
    assert (len(t), t.geometry_count(), t.precisions) == (len(j), j.geometry_count(),
                                                          j.precisions)

    def outcome(fn, *a):
        try:
            got = fn(*a)
        except ValueError as e:
            return type(e).__name__, str(e)
        return tuple(got) if isinstance(got, tuple) else (got.b, got.l_src, got.t_mel)

    for n in range(1, batch[-1] + 2):
        for l in range(1, src[-1] + 2, max(1, src[-1] // 7)):
            for tm in range(1, mel[-1] + 2, max(1, mel[-1] // 9)):
                assert outcome(t.cover, n, l, tm) == outcome(j.cover, n, l, tm)
    for tm in range(1, mel[-1] + 2):
        assert outcome(t.cover_window, tm) == outcome(j.cover_window, tm)
    js, ts = jl.StyleLattice(batch, src), tl.StyleLattice(batch, src)
    assert ts.points() == js.points() and len(ts) == len(js)
    for n in range(1, batch[-1] + 2):
        for r in range(1, src[-1] + 2):
            assert outcome(ts.cover, n, r) == outcome(js.cover, n, r)


# -- the serve config ---------------------------------------------------------------

SERVE_KEYS = dict(
    TIERED, transfer_retries=2, transfer_backoff=0.01,
    style={"ref_buckets": [32, 64], "batch_buckets": [1, 2], "cache_capacity": 7},
    tiers={"enabled": True, "precisions": ["bf16", "f32"], "class_tier": {"bulk": "teacher-bf16"},
           "tier_tolerance": 5.0},
    quality={"clip_fraction_max": 0.25, "silence_run_ms_max": 100.0, "flatness_min_samples": 64},
)


@pytest.mark.parametrize("bad", [None, ("style", "cache_capacity", 0),
                                 ("tiers", "precisions", ["fp8"]),
                                 ("tiers", "default_tier", "teacher"),
                                 ("quality", "clip_fraction_max", 1.5),
                                 ("quality", "flatness_min_samples", 1)])
def test_serve_yaml_loads_in_both_packages(tmp_path, bad):
    """A train.yaml whose serve block sets the keys this slice reads loads
    to the same values in both packages; a value JAX refuses the port
    refuses too."""
    from speakingstyle_tpu.configs.config import load_config as j_load
    from speakingstyle_torch.configs.config import load_config as t_load

    serve = {k: (dict(v) if isinstance(v, dict) else v) for k, v in SERVE_KEYS.items()}
    if bad is not None:
        serve[bad[0]][bad[1]] = bad[2]
    model_yaml, train_yaml = write_configs(tmp_path, serve)
    if bad is not None:
        for load in (j_load, t_load):
            with pytest.raises(ValueError):
                load(model=model_yaml, train=train_yaml)
        return
    j, t = (load(model=model_yaml, train=train_yaml).serve for load in (j_load, t_load))
    assert (t.transfer_retries, t.transfer_backoff) == (j.transfer_retries, j.transfer_backoff)
    assert dataclasses.asdict(t.tiers) == dataclasses.asdict(j.tiers)
    assert dataclasses.asdict(t.quality) == dataclasses.asdict(j.quality)
    for k in ("ref_buckets", "batch_buckets", "cache_capacity"):
        assert getattr(t.style, k) == getattr(j.style, k)


# -- the precision casts -------------------------------------------------------

def _port_model(tmp_path, variables):
    from speakingstyle_torch.compat.from_jax import load_flax_variables
    from speakingstyle_torch.configs.config import load_config
    from speakingstyle_torch.models.fastspeech2 import FastSpeech2

    model_yaml, train_yaml = write_configs(tmp_path)
    cfg = load_config(model=model_yaml, train=train_yaml)
    return cfg, load_flax_variables(FastSpeech2(cfg, **STATS), variables)


def test_int8_cast_matches_jax(jax_weights, tmp_path):  # noqa: F811
    """The port's int8 tree, widened, equals bit for bit JAX's
    ``dequant_params(cast_params(v, "int8"))`` loaded through
    ``load_flax_variables``; every element within half a step of its
    original; an all-zero output channel gets scale 1."""
    from speakingstyle_tpu.parallel import registry as jreg
    from speakingstyle_torch.parallel.registry import cast_params, dequant_params

    variables, _ = jax_weights
    cfg, model = _port_model(tmp_path, variables)
    want_tree = jax.device_get(jreg.dequant_params(jreg.cast_params(variables, "int8")))
    _, want = _port_model(tmp_path, want_tree)
    tree = cast_params(model, "int8")
    got = dequant_params(tree)
    state = dict(model.named_parameters(), **dict(model.named_buffers()))
    want_state = dict(want.named_parameters(), **dict(want.named_buffers()))
    quantized = 0
    for name, w in got.items():
        assert torch.equal(w, want_state[name]), name
        if isinstance(tree[name], dict):
            quantized += 1
            scale = tree[name]["int8_scale"]
            assert tree[name]["int8_q"].dtype == torch.int8
            assert (w - state[name]).abs().le(scale / 2).all(), name
    assert quantized > 20
    # a zero output channel: Linear [out, in] row 0 of the mel projection
    with torch.no_grad():
        model.mel_linear.weight[0].zero_()
    leaf = cast_params(model, "int8")["mel_linear.weight"]
    assert leaf["int8_scale"][0].item() == 1.0 and not leaf["int8_q"][0].any()


def test_bf16_cast_matches_jax_and_keeps_constants(jax_weights, tmp_path):  # noqa: F811
    """The bf16 tree equals JAX's ``cast_params(v, "bf16")`` bit for bit;
    the position tables and the pitch / energy bins stay float32 and
    unchanged, in the tree and in the engine."""
    from speakingstyle_tpu.parallel import registry as jreg
    from speakingstyle_torch.parallel.registry import cast_params

    variables, _ = jax_weights
    _, model = _port_model(tmp_path, variables)
    jtree = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32),
                                   jax.device_get(jreg.cast_params(variables, "bf16")))
    _, want = _port_model(tmp_path, jtree)
    want_state = dict(want.named_parameters(), **dict(want.named_buffers()))
    tree = cast_params(model, "bf16")
    assert all(v.dtype == torch.bfloat16 for v in tree.values())
    for name, v in tree.items():
        assert torch.equal(v.view(torch.int16), want_state[name].to(torch.bfloat16).view(torch.int16))
    constants = {n: b.clone() for n, b in model.named_buffers()
                 if n.endswith("pe") or n.endswith("_bins")}
    assert len(constants) == 5 and not set(constants) & set(tree)
    engine = port_engine(tmp_path, jax_weights)
    for n, b in engine.model.named_buffers():
        if n in constants:
            assert b.dtype == torch.float32 and torch.equal(b, constants[n]), n
    assert set(constants) <= set(engine._constants)


# -- the quality gate ----------------------------------------------------------

def _wav_case(case):
    """(wav, finite hint) of one battery case, from a numpy seed."""
    rng = np.random.default_rng(7)
    t = np.arange(22050) / 22050
    speech = 0.3 * np.sin(2 * np.pi * 180 * t) * (1 + np.sin(2 * np.pi * 3 * t)) / 2 \
        + 0.02 * rng.standard_normal(t.shape)
    as16 = lambda x: np.clip(x * 32768, -32768, 32767).astype(np.int16)
    if case == "healthy":
        return as16(speech), True
    if case in ("nan_hint", "nan_check_here"):
        f = speech.astype(np.float32)
        f[100] = np.nan
        return (as16(np.nan_to_num(f)), False) if case == "nan_hint" else (f, None)
    if case == "clipping":
        return as16(np.sign(speech) * 1.5), True
    if case == "silence":
        w = speech.copy()
        w[2000:2000 + 22050 * 6 // 10] = 0
        return as16(w), True
    if case == "dc":
        return as16(speech * 0.1 + 0.6), True
    if case == "flat":
        return as16(np.full_like(speech, 0.3)), True
    if case == "short":
        return as16(speech[:100]), True
    return np.zeros((0,), np.int16), True


@pytest.mark.parametrize("case", ["healthy", "nan_hint", "nan_check_here", "clipping",
                                  "silence", "dc", "flat", "short", "empty"])
def test_validate_wav_matches_jax(case):
    """Both packages' ``validate_wav`` give the same verdict and evidence."""
    from speakingstyle_tpu.configs.config import QualityConfig as JQ
    from speakingstyle_tpu.obs.quality import validate_wav as j_validate
    from speakingstyle_torch.configs.config import QualityConfig as TQ
    from speakingstyle_torch.obs.quality import validate_wav as t_validate

    wav, finite = _wav_case(case)
    got = t_validate(wav, 22050, TQ(), finite=finite)
    want = j_validate(wav, 22050, JQ(), finite=finite)
    assert got.as_dict() == want.as_dict()
    assert got.ok == (case in ("healthy", "short", "empty"))


# -- the StyleService ---------------------------------------------------------

def test_style_service_matches_jax(tier_runs, jax_weights, tmp_path):  # noqa: F811
    """The same mel gets the same style_id in both packages and (gamma,
    beta) within 1e-5 of JAX's StyleService, at every style bucket the
    requests cover."""
    from speakingstyle_tpu.configs.config import load_config as j_load
    from speakingstyle_tpu.ops import pallas_attention
    from speakingstyle_tpu.serving.style import StyleService as JStyle

    variables, _ = jax_weights
    _, engine = tier_runs
    model_yaml, train_yaml = write_configs(tmp_path, attention_kernel="fused",
                                           conv_impl="pallas")
    mels = [r for _, r in request_inputs(seed=5, shapes=[(3, 32), (3, 7), (3, 19)])]
    pallas_attention.FORCE_INTERPRET = True
    try:
        jstyle = JStyle(j_load(model=model_yaml, train=train_yaml), variables)
        want = jstyle.encode_mels(mels)
    finally:
        pallas_attention.FORCE_INTERPRET = False
    got = engine.style.encode_mels(mels)
    for g, w in zip(got, want):
        assert g.key == w.key
        np.testing.assert_allclose(g.gamma, w.gamma, atol=1e-5, rtol=0)
        np.testing.assert_allclose(g.beta, w.beta, atol=1e-5, rtol=0)


def test_style_cache_repeat_costs_no_encoder_dispatch(jax_weights, tmp_path):  # noqa: F811
    """A repeated reference resolves from the cache: zero encoder
    dispatches, a hit per request, bit-equal wavs."""
    engine = port_engine(tmp_path, jax_weights)
    first = engine.run(port_requests(request_inputs()))
    dispatches, hits = engine.style.dispatch_count, engine.registry.value(
        "serve_style_cache_hits_total")
    again = engine.run(port_requests(request_inputs()))
    assert dispatches == 1 and engine.style.dispatch_count == 1
    assert engine.registry.value("serve_style_cache_hits_total") == hits + 3
    for a, b in zip(first, again):
        np.testing.assert_array_equal(a.wav, b.wav)


def test_style_lru_eviction_counters_match_jax(jax_weights, tmp_path):  # noqa: F811
    """One sequence of lookups through a 2-entry cache in both packages:
    the same hits, misses, evictions, resident entries and dispatches."""
    from speakingstyle_tpu.configs.config import load_config as j_load
    from speakingstyle_tpu.obs import MetricsRegistry as JRegistry
    from speakingstyle_tpu.serving.style import StyleService as JStyle

    variables, _ = jax_weights
    serve = dict(TIERED, style={"ref_buckets": [32], "cache_capacity": 2})
    engine = port_engine(tmp_path, jax_weights, serve=serve)
    model_yaml, train_yaml = write_configs(tmp_path, serve, attention_kernel="fused",
                                           conv_impl="pallas")
    jregistry = JRegistry()
    jstyle = JStyle(j_load(model=model_yaml, train=train_yaml), variables, registry=jregistry)
    mels = [r for _, r in request_inputs(seed=9, shapes=[(2, 8), (2, 9), (2, 10)])]
    names = ("serve_style_cache_hits_total", "serve_style_cache_misses_total",
             "serve_style_cache_evictions_total", "serve_style_cache_entries",
             "serve_style_dispatches_total")
    with jax.default_prng_impl("threefry2x32"):
        for order in ([0, 1], [0], [2], [1], [0, 2]):
            got = engine.style.encode_mels([mels[i] for i in order])
            want = jstyle.encode_mels([mels[i] for i in order])
            assert [g.key for g in got] == [w.key for w in want]
            assert [engine.registry.value(n) for n in names] == [jregistry.value(n) for n in names]
    assert engine.registry.value("serve_style_cache_evictions_total") == 3
    assert len(engine.style) == 2


def test_style_encode_error_degrades_to_the_fallback(jax_weights, tmp_path):  # noqa: F811
    """``style_encode_error@1``: the dispatch still serves, every fresh
    request flagged and synthesized with the all-zero fallback style (bit
    for bit an explicit fallback request); the failure never reached the
    cache, so the next dispatch encodes afresh."""
    from speakingstyle_torch.faults import FaultPlan

    engine = port_engine(tmp_path, jax_weights, fault_plan=FaultPlan.parse("style_encode_error@1"))
    degraded = engine.run(port_requests(request_inputs()))
    assert all(r.style_degraded for r in degraded)
    assert engine.registry.value("serve_style_degraded_total") == 3
    assert engine.registry.value("serve_style_encode_failures_total",
                                 {"error": "InjectedFault"}) == 1
    assert engine.style.dispatch_count == 0 and len(engine.style) == 0
    fallback = engine.style.fallback_style()
    explicit = engine.run([dataclasses.replace(r, ref_mel=None, style=fallback)
                           for r in port_requests(request_inputs())])
    for a, b in zip(degraded, explicit):
        np.testing.assert_array_equal(a.wav, b.wav)
    healthy = engine.run(port_requests(request_inputs()))
    assert not any(r.style_degraded for r in healthy) and engine.style.dispatch_count == 1


# -- the engine per precision ----------------------------------------------------

def bf16_distance_shares(got, want, ref_f32, hop=4):
    """{"mel_max", "mel_mean", "wav_max", "wav_mean"}: the distance of
    ``got`` from ``want`` over the batch's rows (largest, and mean over
    every frame or sample), each over the same distance of ``want`` from
    ``ref_f32``, on the frames the compared rows share."""
    sums = {"got": [0.0, 0.0, 0.0, 0.0, 0, 0], "ref": [0.0, 0.0, 0.0, 0.0, 0, 0]}
    for g, w, f in zip(got, want, ref_f32):
        n = min(g.mel_len, w.mel_len, f.mel_len)
        for tag, a in (("got", g), ("ref", f)):
            dmel = np.abs(a.mel[:n] - w.mel[:n])
            dwav = np.abs(a.wav[:n * hop].astype(np.int64) - w.wav[:n * hop].astype(np.int64))
            acc = sums[tag]
            acc[0], acc[1] = max(acc[0], float(dmel.max())), acc[1] + float(dmel.sum())
            acc[2], acc[3] = max(acc[2], float(dwav.max())), acc[3] + float(dwav.sum())
            acc[4], acc[5] = acc[4] + dmel.size, acc[5] + dwav.size
    (gm, gs, gw, gws, n_mel, n_wav), (rm, rs, rw, rws, _, _) = sums["got"], sums["ref"]
    return {"mel_max": gm / rm, "mel_mean": gs / rs, "wav_max": gw / rw, "wav_mean": gws / rws}


@pytest.mark.parametrize("precision", PRECISIONS)
def test_engine_run_matches_jax_engine_per_precision(tier_runs, precision):
    """The port's ``SynthesisEngine.run`` against the JAX engine's on the
    same weights and requests, at each precision tier (tolerances in the
    module docstring)."""
    runs, _ = tier_runs
    want, got = runs[precision]
    ref_f32 = runs["f32"][0]
    for i, (w, g) in enumerate(zip(want, got)):
        assert g.precision == precision and g.mel_len == w.mel_len > 0
        np.testing.assert_array_equal(g.durations, w.durations)
        dmel = np.abs(g.mel - w.mel).max()
        dwav = np.abs(g.wav.astype(np.int32) - w.wav.astype(np.int32)).max()
        if precision == "bf16":
            n = min(w.mel_len, ref_f32[i].mel_len)
            mel_bound = np.abs(w.mel[:n] - ref_f32[i].mel[:n]).max()
            wav_bound = np.abs(w.wav[:n * 4].astype(np.int32)
                               - ref_f32[i].wav[:n * 4].astype(np.int32)).max()
            assert dmel <= mel_bound and dwav <= wav_bound, (dmel, mel_bound, dwav, wav_bound)
        else:
            assert dmel <= 2e-4 and dwav <= 2, (dmel, dwav)
        assert g.quality is not None and g.quality.ok == w.quality.ok
    if precision == "bf16":
        shares = bf16_distance_shares(got, want, ref_f32)
        assert max(shares.values()) <= BF16_SHARE, shares


def test_bf16_bound_rejects_f32_compute_on_bf16_weights(tier_runs, jax_weights, tmp_path):  # noqa: F811
    """The planted control of the bf16 bound: a tier that runs the f32
    module on the bf16-rounded weights (rounds its weights but does not
    compute in bf16) lands outside ``BF16_SHARE`` of JAX's bf16 tier."""
    runs, _ = tier_runs
    planted = port_engine(tmp_path, jax_weights)
    planted._model_for = lambda precision: planted.model
    got = planted.run(port_requests(request_inputs(), precision="bf16"))
    shares = bf16_distance_shares(got, runs["bf16"][0], runs["f32"][0])
    assert max(shares.values()) > 2 * BF16_SHARE, shares


def test_engine_cards_and_tier_programs(tier_runs):
    """One program per (bucket, precision) and per vocoder point, each
    with a card: FLOPs counted, the precision and labels on the row, no
    graph and no peak on the CPU (a partial card, as the JAX card degrades)."""
    _, engine = tier_runs
    rows = engine.programs()
    names = [r["name"] for r in rows]
    assert names == ["acoustic:b4.s16.m48", "vocoder:b4.m48", "acoustic:b4.s16.m48@bf16",
                     "acoustic:b4.s16.m48@int8"]
    assert engine.compile_count == 4 and engine.style.compile_count == 1
    for r in rows:
        assert r["flops"] > 0 and r["partial"] and r["peak_bytes"] is None and not r["graph"]
    assert [r["precision"] for r in rows] == ["f32", "f32", "bf16", "int8"]
    # the tiers run the same shapes: the same work
    assert rows[0]["flops"] == rows[2]["flops"] == rows[3]["flops"]
    assert engine.registry.value("serve_program_flops", {"kind": "vocoder",
                                                          "bucket": "b4.m48"}) == rows[1]["flops"]


@pytest.mark.parametrize("path", [("pallas", "fused"), ("xla", "einsum"), ("unfold", "fused")])
def test_card_flops_agree_across_paths(jax_weights, tmp_path, path):  # noqa: F811
    """The acoustic card's FLOPs are the same whichever conv and attention
    implementation runs: the flop counter sees the plain versions here, and
    on the card each kernel wrapper adds its own work."""
    from speakingstyle_torch.compat.from_jax import load_flax_variables
    from speakingstyle_torch.configs.config import load_config
    from speakingstyle_torch.models.fastspeech2 import FastSpeech2
    from speakingstyle_torch.serving.engine import SynthesisEngine
    from speakingstyle_torch.serving.lattice import Bucket

    conv_impl, attention_kernel = path
    flops = []
    for cfg_path in (path, ("xla", "einsum")):
        model_yaml, train_yaml = write_configs(tmp_path, conv_impl=cfg_path[0],
                                               attention_kernel=cfg_path[1])
        cfg = load_config(model=model_yaml, train=train_yaml)
        engine = SynthesisEngine(cfg, model=load_flax_variables(FastSpeech2(cfg, **STATS),
                                                                jax_weights[0]), device="cpu")
        flops.append(engine.acoustic_program(Bucket(2, 16, 48)).card["flops"])
    assert flops[0] == flops[1] > 0


def test_counters_flat_over_steady_dispatches(jax_weights, tmp_path):  # noqa: F811
    """After ``precompile`` three rounds of dispatches at every precision
    prepare nothing (``serve_compiles_total``,
    ``serve_style_compiles_total``), allocate no staging buffer after the
    first round, and leave no lease out."""
    engine = port_engine(tmp_path, jax_weights)
    engine.precompile()
    assert engine.is_ready and engine.style.is_ready
    compiles = (engine.compile_count, engine.style.compile_count)
    assert compiles == (len(engine.lattice) + 3, 3)
    allocs = None
    for round_ in range(3):
        for prec in PRECISIONS:
            engine.run(port_requests(request_inputs(), precision=prec))
        if round_ == 0:
            allocs = engine.pool.allocated
    assert (engine.compile_count, engine.style.compile_count) == compiles
    assert engine.pool.allocated == allocs and engine.pool.outstanding == 0
    assert engine.dispatch_count == engine.dispatches == 9
    assert engine.registry.value("serve_requests_total") == 27


def test_a_miss_is_prepared_once_from_two_threads(jax_weights, tmp_path):  # noqa: F811
    """Threads that miss the same point together prepare it once: the
    others wait on the engine's condition lock, then replay it."""
    import sys

    engine = port_engine(tmp_path, jax_weights)
    start = threading.Barrier(4)
    results, errors = [], []

    def worker():
        try:
            start.wait(timeout=60)
            results.append(engine.run(port_requests(request_inputs())))
        except Exception as e:  # reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors
    assert engine.compile_count == 2 and engine.style.compile_count == 1
    assert engine.dispatch_count == 4 and engine.pool.outstanding == 0
    for res in results[1:]:
        for a, b in zip(results[0], res):
            np.testing.assert_array_equal(a.wav, b.wav)


def _gate_case(case, gate):
    """Drive one ``DeviceGate`` scenario in threads; returns the order in
    which the steps happened."""
    order, lock = [], threading.Lock()

    def note(step):
        with lock:
            order.append(step)

    held, go = threading.Event(), threading.Event()

    def reader():
        with gate.shared():
            note("reader in")
            held.set()
            go.wait(timeout=30)
            if case == "nested_shared_passes_a_waiting_writer":
                with gate.shared():
                    note("reader nested")
            note("reader out")

    def writer():
        held.wait(timeout=30)
        with gate.exclusive():
            note("writer in")
        note("writer out")

    def late_reader():
        with gate.shared():
            note("late reader in")

    if case == "exclusive_inside_shared":
        with gate.shared():
            with gate.exclusive():
                note("exclusive")
                with gate.shared():  # the writer passes its own shared entries
                    note("shared under exclusive")
            note("back to shared")
        return order
    threads = [threading.Thread(target=reader), threading.Thread(target=writer)]
    for t in threads:
        t.start()
    held.wait(timeout=30)
    while not gate._writers_waiting:  # the writer is queued behind the reader
        threading.Event().wait(0.001)
    if case == "a_waiting_writer_holds_new_readers_back":
        threads.append(threading.Thread(target=late_reader))
        threads[-1].start()
        threading.Event().wait(0.05)
    go.set()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    return order


@pytest.mark.parametrize("case", [
    "exclusive_waits_for_shared", "a_waiting_writer_holds_new_readers_back",
    "nested_shared_passes_a_waiting_writer", "exclusive_inside_shared",
    "released_lets_a_writer_through"])
def test_device_gate(case):
    """The device gate's ordering: a preparation (exclusive) waits for
    the dispatches in flight (shared) and holds new ones back, a thread's
    nested shared entry passes a waiting writer (no deadlock), a dispatch
    that prepares drops its own shared hold for the preparation and takes
    it back, and ``released`` lets another thread's preparation through."""
    from speakingstyle_torch.parallel.registry import DeviceGate

    gate = DeviceGate()
    if case == "released_lets_a_writer_through":
        order, inside = [], threading.Event()

        def writer():
            inside.wait(timeout=30)
            with gate.exclusive():
                order.append("writer in")

        t = threading.Thread(target=writer)
        t.start()
        with gate.shared():
            with gate.released():
                inside.set()
                t.join(timeout=30)
                order.append("released")
            order.append("shared again")
        assert order == ["writer in", "released", "shared again"] and gate._readers == 0
        return
    order = _gate_case(case, gate)
    want = {
        "exclusive_waits_for_shared": ["reader in", "reader out", "writer in", "writer out"],
        "a_waiting_writer_holds_new_readers_back": [
            "reader in", "reader out", "writer in", "late reader in"],
        "nested_shared_passes_a_waiting_writer": [
            "reader in", "reader nested", "reader out", "writer in", "writer out"],
        "exclusive_inside_shared": ["exclusive", "shared under exclusive", "back to shared"],
    }[case]
    assert [o for o in order if o in want] == want, order
    assert gate._readers == 0 and gate._writer is None


def test_a_miss_waits_for_the_dispatches_in_flight(jax_weights, tmp_path, monkeypatch):  # noqa: F811
    """One thread dispatches at a prepared point while another misses: the
    preparation starts with no program run in flight and holds the other
    thread's next run back until it is done; every result equals its
    single-threaded twin."""
    from speakingstyle_torch.parallel import registry as reg

    engine = port_engine(tmp_path, jax_weights)
    one = port_requests(request_inputs(seed=5, shapes=[(6, 20)]))
    three = port_requests(request_inputs())
    want_one = engine.run(one)
    active, seen, lock = [0], [], threading.Lock()
    plain_call = reg.Program.__call__.__wrapped__

    def counted_call(self, inputs, eager=False):
        with lock:
            active[0] += 1
        try:
            return plain_call(self, inputs, eager)
        finally:
            with lock:
                active[0] -= 1

    plain_read = reg.read_launches

    def read_at_preparation():
        seen.append(active[0])
        return plain_read()

    monkeypatch.setattr(reg.Program, "__call__", reg.dispatching(counted_call))
    monkeypatch.setattr(reg, "read_launches", read_at_preparation)
    done, steady, errors = threading.Event(), [], []

    def traffic():
        try:
            while not done.is_set() or len(steady) < 3:
                steady.append(engine.run(one))
        except Exception as e:  # reported below
            errors.append(e)

    t = threading.Thread(target=traffic)
    t.start()
    while len(steady) < 2:
        threading.Event().wait(0.001)
    # misses the acoustic (4, 16, 48), the vocoder (4, 48) and the style (4, 32)
    got_three = engine.run(three)
    done.set()
    t.join(timeout=300)
    assert not t.is_alive() and not errors
    assert seen and max(seen) == 0, seen
    assert engine.compile_count == 4 and engine.style.compile_count == 2
    again = engine.run(three)
    for res in steady:
        for a, b in zip(res, want_one):
            np.testing.assert_array_equal(a.wav, b.wav)
    for a, b in zip(got_three, again):
        np.testing.assert_array_equal(a.wav, b.wav)


@pytest.mark.parametrize("card", [None, "sized"])
def test_device_memory_watermarks_without_a_card(card, monkeypatch):
    """Without a CUDA device the watermark falls back to the card's
    argument + temp bytes (None without a card) and the per-device table
    is empty."""
    from speakingstyle_torch.obs.cost import (
        ProgramCard, device_memory_watermark, device_memory_watermarks,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    c = None if card is None else ProgramCard(name="p", argument_bytes=96.0, temp_bytes=32.0)
    assert device_memory_watermark(c) == (None if c is None else 128.0)
    assert device_memory_watermarks(c) == {}


def test_poisoned_tier_fails_the_quality_gate(jax_weights, tmp_path):  # noqa: F811
    """``poison_params("int8")`` scales the int8 tree in place: its wavs
    fail the quality gate, f32's still pass, and nothing is prepared again."""
    engine = port_engine(tmp_path, jax_weights)
    for prec in PRECISIONS:
        engine.run(port_requests(request_inputs(), precision=prec))
    compiles = engine.compile_count
    assert engine.poison_params("int8") == "int8"
    bad = engine.run(port_requests(request_inputs(), precision="int8"))
    good = engine.run(port_requests(request_inputs(), precision="f32"))
    assert all(not r.quality.ok for r in bad) and all(r.quality.ok for r in good)
    assert engine.compile_count == compiles
    assert engine.quality.status()["failed"] == 3


def test_predicted_durations_saturate_like_jax():
    """Non-finite and out-of-range log-durations (a diverged or poisoned
    model) give the JAX package's durations: XLA's cast saturates (NaN ->
    0, past the range -> 2^31 - 1), where torch's own cast is undefined
    (INT32_MIN on x86, so negative utterance lengths)."""
    from speakingstyle_tpu.ops.length_regulator import predicted_durations as j_durations
    from speakingstyle_torch.ops.length_regulator import predicted_durations as t_durations

    logd = np.array([[np.nan, np.inf, -np.inf, 80.0, 1.2, -3.0, 1e30, 0.7]], np.float32)
    mask = np.zeros(logd.shape, bool)
    mask[0, -1] = True
    want = np.asarray(j_durations(jnp.asarray(logd), jnp.asarray(mask), 1.5))
    got = t_durations(torch.from_numpy(logd), torch.from_numpy(mask), 1.5).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.min() == 0 and got.max() == 2 ** 31 - 1
