"""PyTorch port, the slice as a whole: text ids + reference mel -> int16 wav.

``speakingstyle_torch``'s ``SynthesisEngine.run`` is held against the JAX
package's ``FastSpeech2.apply`` (its fused-MHA Pallas kernel in interpret
mode) + ``vocoder_infer`` on the identical padded batch, with weights
carried across by ``compat.from_jax``, at float32 and a tiny size. The
``synthesize`` command is driven on the CPU, and both entry points are
shown to refuse, not fall back, when no card is present.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from test_torch_models import (  # noqa: F401 (fixtures)
    MODEL_YAML, interpret_kernels, numpy_variables, one_cpu_thread)

SERVE = {
    "batch_buckets": [1, 2, 4], "src_buckets": [16], "mel_buckets": [48],
    "frames_per_phoneme": 2, "style": {"ref_buckets": [32]},
}
GEN_TOPO = dict(upsample_rates=(2, 2), upsample_kernel_sizes=(4, 4),
                upsample_initial_channel=16, resblock_kernel_sizes=(3,),
                resblock_dilation_sizes=((1,),))
STATS = dict(pitch_stats=(-2.0, 3.0), energy_stats=(-1.0, 2.5))
# (phonemes, reference frames) of the three requests
SHAPES = [(7, 20), (5, 12), (8, 30)]


def write_configs(tmp_path, **model_overrides):
    """model.yaml + train.yaml (with the serve block) for both packages."""
    model = tmp_path / "model.yaml"
    model.write_text(yaml.safe_dump(dict(MODEL_YAML, **model_overrides)))
    train = tmp_path / "train.yaml"
    train.write_text(yaml.safe_dump({"serve": SERVE}))
    return str(model), str(train)


def _requests():
    from speakingstyle_torch.serving.engine import SynthesisRequest

    rng = np.random.default_rng(11)
    return [
        SynthesisRequest(
            id=f"u{i}", sequence=rng.integers(1, 300, L).astype(np.int32),
            ref_mel=rng.standard_normal((T, 80)).astype(np.float32),
        )
        for i, (L, T) in enumerate(SHAPES)
    ]


@pytest.fixture(scope="module")
def jax_weights(tmp_path_factory):
    """Acoustic variables (duration bias raised by 1.1 so random weights
    predict real frames) and tiny HiFi-GAN params, from seeded numpy."""
    from speakingstyle_tpu.configs.config import load_config
    from speakingstyle_tpu.models import hifigan as jh
    from speakingstyle_tpu.models.fastspeech2 import FastSpeech2

    model_yaml, _ = write_configs(tmp_path_factory.mktemp("cfg"), attention_kernel="einsum")
    jcfg = load_config(model=model_yaml)
    B, L, T = 3, 9, 20
    variables = numpy_variables(
        FastSpeech2(config=jcfg, **STATS), jnp.zeros((B,), jnp.int32),
        jnp.ones((B, L), jnp.int32), jnp.full((B,), L),
        mels=jnp.zeros((B, T, 80)), mel_lens=jnp.full((B,), T), max_mel_len=40,
        p_targets=jnp.zeros((B, L)), e_targets=jnp.zeros((B, L)),
        d_targets=jnp.full((B, L), 2, jnp.int32), seed=21,
    )
    dp = variables["params"]["variance_adaptor"]["duration_predictor"]["linear_layer"]
    dp["bias"] = dp["bias"] + 1.1
    gparams = numpy_variables(jh.Generator(**GEN_TOPO), jnp.zeros((1, 8, 80)),
                              seed=22)["params"]
    return variables, gparams


@pytest.mark.parametrize("conv_impl", ["xla", "pallas"])
def test_engine_run_matches_jax_slice(interpret_kernels, jax_weights, tmp_path, conv_impl):
    """Three requests of unequal text and reference lengths through the
    port's engine (fused attention, both conv impls) == the JAX model +
    vocoder on the same padded bucket: identical durations and mel
    lengths, postnet mel within 2e-4, int16 wav within 2 LSB."""
    from speakingstyle_tpu.configs.config import load_config as j_load
    from speakingstyle_tpu.models import hifigan as jh
    from speakingstyle_tpu.models.fastspeech2 import FastSpeech2 as JFS2
    from speakingstyle_torch.compat.from_jax import load_flax_variables
    from speakingstyle_torch.configs.config import load_config as t_load
    from speakingstyle_torch.models import hifigan as th
    from speakingstyle_torch.models.fastspeech2 import FastSpeech2 as TFS2
    from speakingstyle_torch.serving.engine import SynthesisEngine

    variables, gparams = jax_weights
    model_yaml, train_yaml = write_configs(
        tmp_path, conv_impl=conv_impl, attention_kernel="fused")
    jcfg, tcfg = j_load(model=model_yaml), t_load(model=model_yaml, train=train_yaml)

    tmodel = load_flax_variables(TFS2(tcfg, **STATS), variables)
    tgen = load_flax_variables(th.Generator(80, **GEN_TOPO), {"params": gparams})
    engine = SynthesisEngine(tcfg, model=tmodel, vocoder=tgen, device="cpu")
    requests = _requests()
    results = engine.run(requests)
    bucket = results[0].bucket
    assert (bucket.b, bucket.l_src, bucket.t_mel) == (4, 16, 48)
    assert engine.dispatches == 1

    # the JAX side on the identical padded batch: texts in the (4, 16)
    # bucket, reference mels in the 32-frame style bucket
    b, l, t, r = bucket.b, bucket.l_src, bucket.t_mel, 32
    texts = np.zeros((b, l), np.int32)
    src_lens = np.zeros((b,), np.int32)
    mels = np.zeros((b, r, 80), np.float32)
    mel_lens = np.zeros((b,), np.int32)
    for i, req in enumerate(requests):
        texts[i, : len(req.sequence)] = req.sequence
        src_lens[i] = len(req.sequence)
        mels[i, : len(req.ref_mel)] = req.ref_mel
        mel_lens[i] = len(req.ref_mel)
    apply = jax.jit(JFS2(config=jcfg, **STATS).apply, static_argnames="max_mel_len")
    want = apply(variables, jnp.zeros((b,), jnp.int32), jnp.asarray(texts),
                 jnp.asarray(src_lens), mels=jnp.asarray(mels),
                 mel_lens=jnp.asarray(mel_lens), max_mel_len=t)
    want_wavs = jh.vocoder_infer(jh.Generator(**GEN_TOPO), gparams,
                                 want["mel_postnet"], np.asarray(want["mel_lens"]))

    # every real log-duration is clear of a rounding edge (exp(logd) - 1 =
    # k + 1/2), so equal durations test the port, not luck
    logd = np.asarray(want["log_duration_prediction"])[np.arange(l)[None] < src_lens[:, None]]
    edges = np.log(np.arange(200) + 1.5)
    assert np.abs(logd[:, None] - edges[None]).min() >= 1e-3

    for i, res in enumerate(results):
        mel_len = int(want["mel_lens"][i])
        assert res.mel_len == mel_len > 0
        np.testing.assert_array_equal(res.durations, np.asarray(want["durations"])[i, : res.src_len])
        np.testing.assert_allclose(res.mel, np.asarray(want["mel_postnet"])[i, :mel_len],
                                   atol=2e-4)
        assert res.wav.dtype == np.int16 and res.wav.shape == (mel_len * 4,)
        assert np.abs(res.wav).max() > 0
        assert np.abs(res.wav.astype(np.int32) - want_wavs[i].astype(np.int32)).max() <= 2


def test_engine_precomputed_style_equals_reference_mel_path(jax_weights, tmp_path):
    """Requests that carry the (gamma, beta) which ``encode_styles`` gives
    for their reference mels synthesize the same wavs, bit for bit, with
    the reference encoder skipped."""
    from speakingstyle_torch.compat.from_jax import load_flax_variables
    from speakingstyle_torch.configs.config import load_config
    from speakingstyle_torch.models import hifigan as th
    from speakingstyle_torch.models.fastspeech2 import FastSpeech2
    from speakingstyle_torch.serving.engine import StyleVectors, SynthesisEngine

    variables, gparams = jax_weights
    model_yaml, train_yaml = write_configs(tmp_path)
    cfg = load_config(model=model_yaml, train=train_yaml)
    engine = SynthesisEngine(
        cfg, model=load_flax_variables(FastSpeech2(cfg, **STATS), variables),
        vocoder=load_flax_variables(th.Generator(80, **GEN_TOPO), {"params": gparams}),
        device="cpu",
    )
    requests = _requests()
    film = engine.encode_styles([r.ref_mel for r in requests]).numpy()
    for r, f in zip(requests, film):
        r.style, r.ref_mel = StyleVectors(gamma=f[0], beta=f[1]), None
    fresh = engine.run(_requests())
    precomputed = engine.run(requests)
    for a, b in zip(fresh, precomputed):
        assert a.mel_len > 0
        np.testing.assert_array_equal(a.wav, b.wav)
    with pytest.raises(ValueError, match="ref_mel"):
        engine.run([type(requests[1])(id="x", sequence=requests[1].sequence)])


def test_synthesize_cli_on_cpu(monkeypatch, tmp_path):
    """``python -m speakingstyle_torch synthesize --device cpu``: a saved
    checkpoint restored, G2P, the reference wav -> mel, the engine, a wav
    file of mel_len * hop samples under <result_path>/<step>/ (with a tiny
    HiFi-GAN from ``--seed`` in place of the LJSpeech V1 generator)."""
    from scipy.io import wavfile

    from speakingstyle_torch import synthesis
    from speakingstyle_torch.__main__ import main
    from speakingstyle_torch.configs.config import load_config
    from speakingstyle_torch.training.checkpoint import CheckpointManager
    from speakingstyle_torch.training.trainer import build_state

    model_yaml, train_yaml = write_configs(tmp_path)
    with open(train_yaml, "a") as f:
        f.write(yaml.safe_dump({"path": {"ckpt_path": str(tmp_path / "ckpt"),
                                         "result_path": str(tmp_path / "out")}}))
    cfg = load_config(model=model_yaml, train=train_yaml)
    CheckpointManager(cfg.train.path.ckpt_path).save(4, build_state(cfg, "cpu"))
    ref = tmp_path / "ref.wav"
    tt = np.arange(22050 // 4) / 22050.0
    wavfile.write(str(ref), 22050, (8000 * np.sin(2 * np.pi * 220 * tt)).astype(np.int16))
    monkeypatch.setattr(synthesis, "DEFAULT_HIFIGAN_CONFIG", {
        "resblock": "1", "upsample_rates": [2, 2], "upsample_kernel_sizes": [4, 4],
        "upsample_initial_channel": 16, "resblock_kernel_sizes": [3],
        "resblock_dilation_sizes": [[1]],
    })
    ns = main([
        "synthesize", "-m", model_yaml, "-t", train_yaml, "--device", "cpu",
        "--restore_step", "4", "--mode", "single",
        "--text", "Hello world", "--ref_audio", str(ref),
    ])
    path = ns.paths[0]
    assert path.startswith(str(tmp_path / "out" / "4"))
    sr, wav = wavfile.read(path)
    assert sr == 22050 and wav.dtype == np.int16 and len(wav) % 4 == 0


def test_entry_points_refuse_without_a_card(monkeypatch, tmp_path):
    """With no card and no explicit CPU request, the engine and the CLI
    raise; neither carries on on the CPU."""
    from speakingstyle_torch.__main__ import main
    from speakingstyle_torch.configs.config import load_config
    from speakingstyle_torch.serving.engine import SynthesisEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model_yaml, train_yaml = write_configs(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SynthesisEngine(load_config(model=model_yaml, train=train_yaml))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["synthesize", "-m", model_yaml, "--restore_step", "1", "--mode", "single",
              "--text", "hi", "--ref_audio", "x.wav"])
