"""PyTorch port, model layer: each module of speakingstyle_torch/models
against its JAX twin, on weights carried across by
``compat.from_jax.load_flax_variables`` and identical numpy inputs, at
float32 and a tiny size.

The JAX side runs its Pallas kernels in interpret mode
(``pallas_attention.FORCE_INTERPRET``, the ``interpret_kernels`` fixture)
where the port runs its kernels' plain versions. Module outputs agree to
1e-5 (single layers) and 2e-4 (whole stacks: the bar the JAX package holds
against the PyTorch reference); free-running durations agree exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from speakingstyle_torch.compat.from_jax import expected_leaves, load_flax_variables

from torch_threads import one_cpu_thread  # noqa: F401 (an autouse fixture)

# The JAX trainer makes ``rbg`` the process-wide default PRNG on its first
# call (``train.fast_prng``, on by default), so in a worker that runs many
# modules the JAX package's tests drew their random weights from threefry
# or from rbg, by which modules had run there before them; the tiny
# serving fixtures of tests/test_latency.py and tests/test_fleet.py span
# several stream windows only with the rbg draw. Pinning the default once,
# as the port's test modules are collected, gives every test the same
# draw whatever the schedule. The tests that hold the port against JAX
# draws pin threefry themselves.
jax.config.update("jax_default_prng_impl", "rbg")

MODEL_YAML = {
    "transformer": {
        "encoder_layer": 2, "decoder_layer": 2, "encoder_hidden": 16,
        "decoder_hidden": 16, "encoder_head": 2, "decoder_head": 2,
        "conv_filter_size": 32,
    },
    "reference_encoder": {
        "encoder_layer": 1, "encoder_head": 2, "encoder_hidden": 16,
        "conv_layer": 2, "conv_filter_size": 32,
    },
    "variance_predictor": {"filter_size": 16},
    "variance_embedding": {"n_bins": 16},
    "postnet_embedding_dim": 16,
    "postnet_layers": 3,
    "max_seq_len": 64,
    "compute_dtype": "float32",
}


def load_both(tmp_path, **model_overrides):
    """One model.yaml, loaded by both packages' load_config."""
    from speakingstyle_tpu.configs.config import load_config as j_load
    from speakingstyle_torch.configs.config import load_config as t_load

    path = tmp_path / "model.yaml"
    path.write_text(yaml.safe_dump(dict(MODEL_YAML, **model_overrides)))
    return j_load(model=str(path)), t_load(model=str(path))


def carried(tmodule, variables):
    return load_flax_variables(tmodule, jax.device_get(variables)).eval()


def numpy_variables(module, *args, seed=0, **kwargs):
    """The module's Flax variable tree (structure from ``jax.eval_shape`` of
    its init, no compile) filled from a seeded numpy generator: scales and
    variances near 1, small biases and means, matrices N(0, 1/fan_in)."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args, **kwargs))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name in ("scale", "s_gamma", "s_beta", "var"):
            value = rng.uniform(0.5, 1.5, shape)
        elif name in ("bias", "mean"):
            value = rng.standard_normal(shape) * 0.1
        elif name == "embedding":
            value = rng.standard_normal(shape)
        else:
            value = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        return value.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture
def interpret_kernels():
    """Run the JAX package's fused-MHA Pallas kernel in interpret mode."""
    from speakingstyle_tpu.ops import pallas_attention

    pallas_attention.FORCE_INTERPRET = True
    try:
        yield
    finally:
        pallas_attention.FORCE_INTERPRET = False


def _inputs(seed, B=3, L=9, T=20, d=16):
    rng = np.random.default_rng(seed)
    lens = np.array([L, L - 3, L - 1][:B], np.int32)
    mask = np.arange(L)[None] >= lens[:, None]
    x = rng.standard_normal((B, L, d)).astype(np.float32) * (~mask)[..., None]
    film = rng.standard_normal((2, B, 1, d)).astype(np.float32) * 0.3
    mel = rng.standard_normal((B, T, 80)).astype(np.float32)
    mel_lens = np.array([T, T - 6, T - 2][:B], np.int32)
    return rng, x, mask, film, mel, mel_lens


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("attention_kernel", ["einsum", "fused"])
@pytest.mark.parametrize("conv_impl", ["xla", "pallas"])
def test_fft_block_matches_jax(interpret_kernels, attention_kernel, conv_impl):
    """MHA (both dispatches) + conv FFN (K=9 and the K=1 exception) + FiLM."""
    from speakingstyle_tpu.models.layers import FFTBlock as JBlock
    from speakingstyle_torch.models.layers import FFTBlock as TBlock

    _, x, mask, film, _, _ = _inputs(1)
    jb = JBlock(16, 2, 32, (9, 1), 0.0, film=True, conv_impl=conv_impl,
                attention_kernel=attention_kernel)
    args = (jnp.asarray(x), jnp.asarray(mask), jnp.asarray(film[0]), jnp.asarray(film[1]))
    variables = numpy_variables(jb, *args, seed=0)
    want = jax.jit(jb.apply)(variables, *args)
    tb = carried(TBlock(16, 2, 32, (9, 1), film=True, conv_impl=conv_impl,
                        attention_kernel=attention_kernel), variables)
    with torch.no_grad():
        got = tb(_t(x), _t(mask), _t(film[0]), _t(film[1]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("conv_impl", ["xla", "pallas"])
def test_reference_encoder_matches_jax(interpret_kernels, tmp_path, conv_impl):
    """conv + ReLU + LN stack (fused under pallas), PE, FFT block, the
    padded-length mean pool, gamma/beta split."""
    from speakingstyle_tpu.models.factory import reference_encoder_from_config
    from speakingstyle_torch.models.reference_encoder import ReferenceEncoder

    jcfg, tcfg = load_both(tmp_path, conv_impl=conv_impl)
    _, _, _, _, mel, mel_lens = _inputs(2)
    mask = np.arange(mel.shape[1])[None] >= mel_lens[:, None]
    jenc = reference_encoder_from_config(jcfg, n_position=65)
    variables = numpy_variables(jenc, jnp.asarray(mel), jnp.asarray(mask), seed=1)
    want = jax.jit(jenc.apply)(variables, jnp.asarray(mel), jnp.asarray(mask))
    ref = tcfg.model.reference_encoder
    tenc = carried(ReferenceEncoder(
        80, ref.conv_layer, ref.conv_filter_size, ref.conv_kernel_size,
        ref.encoder_layer, ref.encoder_head, ref.encoder_hidden, n_position=65,
        conv_impl=conv_impl, attention_kernel="fused",
    ), variables)
    with torch.no_grad():
        got = tenc(_t(mel), _t(mask))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


@pytest.mark.parametrize("free_running", [False, True])
def test_variance_adaptor_matches_jax(free_running):
    """Predictors (FiLM on the duration predictor only), bucketized
    embeddings, per-phoneme controls, length regulation."""
    from speakingstyle_tpu.models.variance_adaptor import VarianceAdaptor as JVA
    from speakingstyle_torch.models.variance_adaptor import VarianceAdaptor as TVA

    rng, x, mask, film, _, _ = _inputs(3)
    B, L = mask.shape
    kw = dict(pitch_stats=(-2.0, 3.0), energy_stats=(-1.0, 2.5), n_bins=16,
              d_model=16, filter_size=16)
    jva = JVA(**kw, dropout=0.0)
    d_t = (rng.integers(0, 4, (B, L)) * ~mask).astype(np.int32)
    p_t, e_t = (rng.standard_normal((B, L)).astype(np.float32) for _ in range(2))
    d_ctl = np.where(mask, 1.0, rng.uniform(0.5, 2.0, (B, L))).astype(np.float32)
    variables = numpy_variables(jva, jnp.asarray(x), jnp.asarray(mask), None, 40,
                                p_t, e_t, d_t, gammas=film[0], betas=film[1], seed=2)
    targets = (None, None, None) if free_running else (p_t, e_t, d_t)
    want = jax.jit(lambda v: jva.apply(v, jnp.asarray(x), jnp.asarray(mask), None, 40,
                                       *targets, 1.3, 0.8, d_ctl, gammas=film[0],
                                       betas=film[1]))(variables)
    tva = carried(TVA(**kw, film=True), variables)
    with torch.no_grad():
        got = tva(_t(x), _t(mask), 40, *(None if a is None else _t(a) for a in targets),
                  1.3, 0.8, _t(d_ctl), _t(film[0]), _t(film[1]))
    np.testing.assert_array_equal(got["durations"].numpy(), np.asarray(want["durations"]))
    np.testing.assert_array_equal(got["mel_lens"].numpy(), np.asarray(want["mel_lens"]))
    for key in ("features", "pitch_prediction", "energy_prediction",
                "log_duration_prediction"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=1e-5,
                                   err_msg=key)


@pytest.mark.parametrize("conv_impl", ["xla", "pallas"])
def test_postnet_matches_jax_with_keep_mask(conv_impl):
    """Conv + BatchNorm at running stats (carried from batch_stats) + tanh,
    re-zeroed at masked frames."""
    from speakingstyle_tpu.models.postnet import PostNet as JPost
    from speakingstyle_torch.models.postnet import PostNet as TPost

    rng = np.random.default_rng(4)
    mel = rng.standard_normal((2, 15, 80)).astype(np.float32)
    keep = np.arange(15) < 11
    jp = JPost(embedding_dim=16, n_convolutions=3, conv_impl=conv_impl)
    variables = numpy_variables(jp, jnp.asarray(mel), seed=3)
    want = jax.jit(jp.apply)(variables, jnp.asarray(mel), keep_mask=jnp.asarray(keep))
    tp = carried(TPost(80, 16, 5, 3, conv_impl=conv_impl), variables)
    with torch.no_grad():
        got = tp(_t(mel), keep_mask=_t(keep))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("resblock", ["1", "2"])
def test_hifigan_generator_matches_jax(resblock):
    """Folded-weight generator: torch-padded convs, transposed-conv upsample,
    MRF blocks; and vocoder_infer's int16 trimming."""
    from speakingstyle_tpu.models import hifigan as jh
    from speakingstyle_torch.models import hifigan as th

    topo = dict(upsample_rates=(2, 3), upsample_kernel_sizes=(4, 7),
                upsample_initial_channel=16, resblock_kernel_sizes=(3, 5),
                resblock_dilation_sizes=((1, 3), (1, 2)), resblock=resblock)
    mel = np.random.default_rng(5).standard_normal((2, 11, 80)).astype(np.float32)
    jg = jh.Generator(**topo)
    params = numpy_variables(jg, jnp.asarray(mel), seed=4)["params"]
    tg = carried(th.Generator(80, **topo), {"params": params})
    with torch.no_grad():
        got = tg(_t(mel))
    want = jax.jit(jg.apply)({"params": params}, jnp.asarray(mel))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    lens = [11, 7]
    jw = jh.vocoder_infer(jg, params, jnp.asarray(mel), lens)
    tw = th.vocoder_infer(tg, _t(mel), lens)
    for a, b in zip(tw, jw):
        assert a.dtype == np.int16 and a.shape == b.shape == (b.shape[0],)
        assert np.abs(a.astype(np.int32) - b.astype(np.int32)).max() <= 1


# ------------------------------------------------------------ the whole acoustic model


@pytest.fixture(scope="module")
def acoustic_pair(tmp_path_factory):
    """JAX FastSpeech2 variables for the tiny config, the duration
    predictor's bias raised by 1.1 so random weights predict real frames."""
    from speakingstyle_tpu.models.fastspeech2 import FastSpeech2

    jcfg, _ = load_both(tmp_path_factory.mktemp("cfg"), attention_kernel="einsum")
    model = FastSpeech2(config=jcfg, pitch_stats=(-2.0, 3.0), energy_stats=(-1.0, 2.5))
    _, _, _, _, mel, mel_lens = _inputs(6)
    B, L = 3, 9
    variables = numpy_variables(
        model, jnp.zeros((B,), jnp.int32), jnp.ones((B, L), jnp.int32),
        jnp.full((B,), L), mels=jnp.asarray(mel), mel_lens=jnp.asarray(mel_lens),
        max_mel_len=40, p_targets=jnp.zeros((B, L)), e_targets=jnp.zeros((B, L)),
        d_targets=jnp.full((B, L), 2, jnp.int32), seed=7,
    )
    dp = variables["params"]["variance_adaptor"]["duration_predictor"]["linear_layer"]
    dp["bias"] = dp["bias"] + 1.1
    return variables


def _acoustic_batch():
    rng, _, _, _, mel, mel_lens = _inputs(8)
    texts = rng.integers(1, 300, (3, 9)).astype(np.int32)
    src_lens = np.array([9, 6, 8], np.int32)
    texts[np.arange(9)[None] >= src_lens[:, None]] = 0
    return texts, src_lens, mel, mel_lens


@pytest.mark.parametrize("conv_impl", ["xla", "pallas"])
def test_free_running_acoustic_model_matches_jax(interpret_kernels, acoustic_pair,
                                                 tmp_path, conv_impl):
    """The whole FastSpeech2 + reference encoder, free-running, with the
    fused attention kernel: identical durations and mel lengths, postnet
    mel within 2e-4."""
    from speakingstyle_tpu.models.fastspeech2 import FastSpeech2 as JFS2
    from speakingstyle_torch.models.fastspeech2 import FastSpeech2 as TFS2

    jcfg, tcfg = load_both(tmp_path, conv_impl=conv_impl, attention_kernel="fused")
    texts, src_lens, mel, mel_lens = _acoustic_batch()
    stats = dict(pitch_stats=(-2.0, 3.0), energy_stats=(-1.0, 2.5))
    apply = jax.jit(JFS2(config=jcfg, **stats).apply, static_argnames="max_mel_len")
    want = apply(
        acoustic_pair, jnp.zeros((3,), jnp.int32), jnp.asarray(texts),
        jnp.asarray(src_lens), mels=jnp.asarray(mel), mel_lens=jnp.asarray(mel_lens),
        max_mel_len=48,
    )
    # the seed keeps every real log-duration clear of a rounding edge
    # (exp(logd) - 1 = k + 1/2), so equal durations test the model, not luck
    logd = np.asarray(want["log_duration_prediction"])[np.arange(9)[None] < src_lens[:, None]]
    edges = np.log(np.arange(200) + 1.5)
    assert np.abs(logd[:, None] - edges[None]).min() >= 1e-3
    assert int(np.asarray(want["mel_lens"]).min()) > 0

    tmodel = carried(TFS2(tcfg, **stats), acoustic_pair)
    with torch.no_grad():
        got = tmodel(torch.zeros(3, dtype=torch.int64), _t(texts).long(), _t(src_lens).long(),
                     mels=_t(mel), mel_lens=_t(mel_lens).long(), max_mel_len=48)
    np.testing.assert_array_equal(got["durations"].numpy(), np.asarray(want["durations"]))
    np.testing.assert_array_equal(got["mel_lens"].numpy(), np.asarray(want["mel_lens"]))
    for key in ("mel", "mel_postnet"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=2e-4,
                                   err_msg=key)


def test_teacher_forced_acoustic_model_with_precomputed_film(acoustic_pair, tmp_path):
    """The serve path's precomputed (gamma, beta) entry, teacher-forced."""
    from speakingstyle_tpu.models.fastspeech2 import FastSpeech2 as JFS2
    from speakingstyle_torch.models.fastspeech2 import FastSpeech2 as TFS2

    jcfg, tcfg = load_both(tmp_path, attention_kernel="einsum")
    texts, src_lens, _, _ = _acoustic_batch()
    rng = np.random.default_rng(9)
    film = (rng.standard_normal((2, 3, 1, 16)) * 0.3).astype(np.float32)
    d = (rng.integers(0, 4, (3, 9)) * (np.arange(9)[None] < src_lens[:, None])).astype(np.int32)
    p, e = (rng.standard_normal((3, 9)).astype(np.float32) for _ in range(2))
    stats = dict(pitch_stats=(-2.0, 3.0), energy_stats=(-1.0, 2.5))
    apply = jax.jit(JFS2(config=jcfg, **stats).apply, static_argnames="max_mel_len")
    want = apply(
        acoustic_pair, jnp.zeros((3,), jnp.int32), jnp.asarray(texts), jnp.asarray(src_lens),
        max_mel_len=30, p_targets=p, e_targets=e, d_targets=d, gammas=film[0], betas=film[1],
    )
    tmodel = carried(TFS2(tcfg, **stats), acoustic_pair)
    with torch.no_grad():
        got = tmodel(torch.zeros(3, dtype=torch.int64), _t(texts).long(), _t(src_lens).long(),
                     max_mel_len=30, p_targets=_t(p), e_targets=_t(e), d_targets=_t(d),
                     gammas=_t(film[0]), betas=_t(film[1]))
    np.testing.assert_allclose(got["mel_postnet"].numpy(), np.asarray(want["mel_postnet"]),
                               atol=2e-4)


# ------------------------------------------------------------ the carrier


def test_carrier_raises_on_missing_extra_or_misshapen_leaf(acoustic_pair, tmp_path):
    import copy

    from speakingstyle_torch.models.fastspeech2 import FastSpeech2 as TFS2

    _, tcfg = load_both(tmp_path)
    model = TFS2(tcfg)
    assert {p[0] for p in expected_leaves(model)} == {"params", "batch_stats"}
    load_flax_variables(model, acoustic_pair)  # the full tree loads

    missing = copy.deepcopy(acoustic_pair)
    del missing["params"]["decoder"]["layer_stack"]["layer_1"]["film"]
    with pytest.raises(ValueError, match=r"missing \['params/decoder/layer_stack/layer_1/film"):
        load_flax_variables(model, missing)

    extra = copy.deepcopy(acoustic_pair)
    extra["params"]["encoder"]["renamed_emb"] = {"embedding": np.zeros((3, 16), np.float32)}
    with pytest.raises(ValueError, match="extra \\['params/encoder/renamed_emb/embedding'\\]"):
        load_flax_variables(model, extra)

    wrong = copy.deepcopy(acoustic_pair)
    wrong["batch_stats"]["postnet"]["bn_0"]["mean"] = np.zeros((17,), np.float32)
    with pytest.raises(ValueError, match="batch_stats/postnet/bn_0/mean"):
        load_flax_variables(model, wrong)


def test_to_flax_tree_round_trip_is_bit_identical(acoustic_pair, tmp_path):
    """Flax variables -> the port (load_flax_variables) -> Flax layout
    (to_flax_tree) gives back every leaf bit for bit, and flax_param_names
    names every parameter and statistic by its Flax path."""
    from speakingstyle_torch.compat.from_jax import flax_param_names, to_flax_tree
    from speakingstyle_torch.models.fastspeech2 import FastSpeech2 as TFS2

    _, tcfg = load_both(tmp_path)
    model = load_flax_variables(TFS2(tcfg), acoustic_pair)
    back = to_flax_tree(model)
    want = jax.tree_util.tree_flatten_with_path(jax.device_get(acoustic_pair))[0]
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(got[path], np.asarray(leaf, np.float32))
    names = flax_param_names(model)
    assert names["encoder.src_word_emb.weight"] == "encoder/src_word_emb/embedding"
    assert names["postnet.bn_0.mean"] == "postnet/bn_0/mean"
    assert len(names) == len(want)
