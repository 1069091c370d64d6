"""PyTorch port, the weight formats: reference PyTorch checkpoints and
Flax msgpack files, against the JAX package on identical files.

* The reference FastSpeech2 ``<step>.pth.tar`` (the key naming of
  tests/test_convert.py, written with ``torch.save``): every leaf the port
  converts equals the JAX package's ``convert_fastspeech2`` tree, and,
  through ``convert`` and ``synthesize --restore_step``, a free-running
  forward gives the JAX model's durations and its mel within 2e-4 (f32).
* HiFi-GAN ``generator_*.pth.tar`` (weight-normed, as tests/test_hifigan.py
  builds it) and MelGAN hub state dicts: the folded and converted trees
  equal the JAX package's; the wavs agree within 1e-5.
* The Flax ``*.generator.msgpack`` sidecar both ways, byte for byte,
  chunked leaves and bf16 leaves included; a full VocoderState file is
  refused.
"""

import dataclasses
import json
import math
import os

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from test_convert import make_reference_state_dict
from test_hifigan import SMALL, TorchGenerator, _torch_melgan
from test_torch_models import one_cpu_thread  # noqa: F401 (an autouse fixture)


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _assert_trees_equal(got, want):
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg="/".join(k))


def _save_pth(path, sd, key):
    torch.save({key: {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}}, str(path))
    return str(path)


def _f32_model_yaml(root, **overrides):
    """The LJSpeech preset's model.yaml at float32 (and ``overrides``)."""
    from speakingstyle_torch.configs.config import PRESET_DIR

    model = yaml.safe_load(open(os.path.join(PRESET_DIR, "LJSpeech", "model.yaml")))
    model.update(compute_dtype="float32", **overrides)
    path = root / "model.yaml"
    path.write_text(yaml.safe_dump(model))
    return str(path)


# ---------------------------------------------------------------- FastSpeech2


@pytest.mark.parametrize("dp_prefix", [False, True])
def test_reference_checkpoint_converts_leaf_for_leaf_as_jax(tmp_path, dp_prefix):
    """The reference state dict saved with torch.save, loaded and converted
    by the port (``module.`` prefix of DataParallel stripped): the same
    tree as the JAX package's ``convert_fastspeech2`` on the same arrays,
    postnet running stats in ``batch_stats``; and every leaf the port's
    LJSpeech model takes from it is that tree's, bit for bit."""
    from speakingstyle_tpu.compat.torch_convert import convert_fastspeech2 as j_convert
    from speakingstyle_torch.compat import torch_convert as tc
    from speakingstyle_torch.compat.from_jax import load_flax_variables, to_flax_tree
    from speakingstyle_torch.configs.config import load_config
    from speakingstyle_torch.models.factory import build_model

    sd = make_reference_state_dict()
    if dp_prefix:
        sd = {"module." + k: v for k, v in sd.items()}
    path = _save_pth(tmp_path / "100.pth.tar", sd, "model")
    loaded = tc.load_torch_state_dict(path, key="model")
    got = tc.convert_fastspeech2(loaded)
    want = j_convert(sd)
    _assert_trees_equal(got, want)
    assert set(got["batch_stats"]["postnet"]) == {f"bn_{i}" for i in range(5)}

    model = load_flax_variables(build_model(load_config(preset="LJSpeech")), got)
    _assert_trees_equal(to_flax_tree(model), want)


def _scaled_reference_state_dict():
    """The reference state dict with weights at the scale of a trained
    model: matrices and conv kernels over sqrt(fan_in), and the duration
    predictor's output layer scaled by a further 0.1 with its bias at
    ln(1 + 2), so that it predicts about two frames a phoneme."""
    sd = make_reference_state_dict()
    for k, v in sd.items():
        if k.endswith(".weight") and v.ndim >= 2 and "embedding" not in k \
                and "src_word_emb" not in k:
            sd[k] = (v / math.sqrt(np.prod(v.shape[1:]))).astype(np.float32)
    sd["variance_adaptor.duration_predictor.linear_layer.weight"] *= 0.1
    sd["variance_adaptor.duration_predictor.linear_layer.bias"] = np.full(
        (1,), math.log(3.0), np.float32)
    return sd


# CMUdict entries of the test's text, in read_lexicon's format
LEXICON = "printing P R IH1 N T IH0 NG\nin IH0 N\nthe DH AH0\nonly OW1 N L IY0\n" \
    "sense S EH1 N S\n"


def _preprocess_yaml_with_lexicon(root):
    """The LJSpeech preset's preprocess.yaml with a lexicon of LEXICON."""
    from speakingstyle_torch.configs.config import PRESET_DIR

    (root / "lexicon.txt").write_text(LEXICON)
    pre = yaml.safe_load(open(os.path.join(PRESET_DIR, "LJSpeech", "preprocess.yaml")))
    pre["path"]["lexicon_path"] = str(root / "lexicon.txt")
    path = root / "preprocess.yaml"
    path.write_text(yaml.safe_dump(pre))
    return str(path)


def test_converted_reference_checkpoint_synthesizes_like_jax(tmp_path):
    """``convert`` turns the reference ``100.pth.tar`` into the port's step
    100; ``synthesize --restore_step 100`` on the CPU then gives, for a
    request of its own G2P and reference mel, the durations of the JAX
    model on the JAX package's own conversion of the same file, and the
    postnet mel within 2e-4 (float32, the LJSpeech widths)."""
    from speakingstyle_tpu.compat.torch_convert import convert_fastspeech2 as j_convert
    from speakingstyle_tpu.configs.config import load_config as j_load
    from speakingstyle_tpu.models.factory import build_model as j_build
    from speakingstyle_torch.__main__ import main

    sd = _scaled_reference_state_dict()
    pth = _save_pth(tmp_path / "100.pth.tar", sd, "model")
    model_yaml = _f32_model_yaml(tmp_path)
    train_yaml = tmp_path / "train.yaml"
    train_yaml.write_text(yaml.safe_dump({
        "path": {"ckpt_path": str(tmp_path / "ckpt"), "result_path": str(tmp_path / "out")},
        "serve": {"batch_buckets": [1], "src_buckets": [32], "mel_buckets": [128],
                  "frames_per_phoneme": 4, "style": {"ref_buckets": [64]}},
    }))
    pre_yaml = _preprocess_yaml_with_lexicon(tmp_path)
    cfg_args = ["--preset", "LJSpeech", "-p", pre_yaml, "-m", model_yaml, "-t", str(train_yaml)]
    step_dir = main(["convert", *cfg_args, "--ckpt", pth])
    assert step_dir == str(tmp_path / "ckpt" / "100")

    from scipy.io import wavfile

    t = np.arange(int(22050 * 0.5)) / 22050.0
    ref = tmp_path / "ref.wav"
    wavfile.write(str(ref), 22050, (8000 * np.sin(2 * np.pi * 180 * t)).astype(np.int16))
    ns = main(["synthesize", *cfg_args, "--device", "cpu", "--restore_step", "100",
               "--mode", "single", "--text", "printing in the only sense",
               "--ref_audio", str(ref), "--griffin_lim"])
    req, res = ns.requests[0], ns.results[0]
    assert ns.info["step"] == 100 and res.bucket.t_mel == 128

    # the JAX model on the identical padded batch
    jcfg = j_load(preprocess=pre_yaml, model=model_yaml, preset="LJSpeech")
    assert len(req.sequence) == 19  # the lexicon's phones, not one "spn" a word
    L, T, R = res.bucket.l_src, res.bucket.t_mel, 64
    texts = np.zeros((1, L), np.int32)
    texts[0, : len(req.sequence)] = req.sequence
    mels = np.zeros((1, R, 80), np.float32)
    mels[0, : len(req.ref_mel)] = req.ref_mel
    apply = jax.jit(j_build(jcfg, n_position=1001).apply, static_argnames="max_mel_len")
    want = apply(j_convert(sd), jnp.zeros((1,), jnp.int32), jnp.asarray(texts),
                 jnp.asarray([len(req.sequence)]), mels=jnp.asarray(mels),
                 mel_lens=jnp.asarray([len(req.ref_mel)]), max_mel_len=T)
    n = res.src_len
    logd = np.asarray(want["log_duration_prediction"])[0, :n]
    edges = np.log(np.arange(200) + 1.5)  # where round(exp(logd) - 1) steps
    assert np.abs(logd[:, None] - edges[None]).min() >= 1e-3
    assert 0 < res.mel_len == int(want["mel_lens"][0])
    np.testing.assert_array_equal(res.durations, np.asarray(want["durations"])[0, :n])
    np.testing.assert_allclose(res.mel, np.asarray(want["mel_postnet"])[0, : res.mel_len],
                               atol=2e-4)


def test_convert_refuses_a_checkpoint_of_another_model(tmp_path):
    """A checkpoint whose widths do not fit the config stops ``convert``
    before anything is written."""
    from speakingstyle_torch.__main__ import main

    sd = make_reference_state_dict()
    sd["mel_linear.weight"] = sd["mel_linear.weight"][:, :128]
    pth = _save_pth(tmp_path / "7.pth.tar", sd, "model")
    train_yaml = tmp_path / "train.yaml"
    train_yaml.write_text(yaml.safe_dump({"path": {"ckpt_path": str(tmp_path / "ckpt")}}))
    with pytest.raises(SystemExit, match="mel_linear"):
        main(["convert", "--preset", "LJSpeech", "-t", str(train_yaml), "--ckpt", pth])
    assert not os.path.exists(tmp_path / "ckpt" / "7")


# ---------------------------------------------------------------- vocoders


def _weight_normed_hifigan(seed=0):
    torch.manual_seed(seed)
    cfg = {k: list(v) if isinstance(v, tuple) else v for k, v in SMALL.items()}
    return TorchGenerator(cfg).eval()


SMALL_CONFIG = dict({k: list(v) if isinstance(v, tuple) else v for k, v in SMALL.items()},
                    resblock_dilation_sizes=[list(d) for d in SMALL["resblock_dilation_sizes"]],
                    resblock="1")


def _small_hifigan(monkeypatch, root):
    """The port's vocoder topology set to SMALL; returns a hifigan config.json
    of it for the JAX package's ``get_vocoder``."""
    from speakingstyle_torch import synthesis

    monkeypatch.setattr(synthesis, "DEFAULT_HIFIGAN_CONFIG", SMALL_CONFIG)
    path = root / "hifigan.json"
    path.write_text(json.dumps(SMALL_CONFIG))
    return str(path)


def test_hifigan_pth_tar_folds_and_converts_as_jax(tmp_path, monkeypatch):
    """A weight-normed HiFi-GAN ``generator_*.pth.tar``: ``fold_weight_norm``
    and ``convert_hifigan`` give the JAX package's trees bit for bit, and
    the port's ``get_vocoder`` on the file gives the JAX generator's wav
    and the weight-normed torch module's within 1e-5."""
    from speakingstyle_tpu.compat.torch_convert import convert_hifigan as j_conv
    from speakingstyle_tpu.compat.torch_convert import fold_weight_norm as j_fold
    from speakingstyle_tpu.models.hifigan import Generator as JGen
    from speakingstyle_torch.compat import torch_convert as tc
    from speakingstyle_torch.configs.config import load_config
    from speakingstyle_torch.synthesis import get_vocoder

    tgen = _weight_normed_hifigan()
    sd = {k: v.detach().numpy() for k, v in tgen.state_dict().items()}
    assert any(k.endswith("weight_g") for k in sd)
    pth = _save_pth(tmp_path / "generator_x.pth.tar", sd, "generator")
    loaded = tc.load_torch_state_dict(pth, key="generator")
    _assert_trees_equal(tc.fold_weight_norm(loaded), j_fold(sd))
    _assert_trees_equal(tc.convert_hifigan(loaded), j_conv(sd))

    _small_hifigan(monkeypatch, tmp_path)
    voc = get_vocoder(load_config(preset="LJSpeech"), pth)
    mel = np.random.default_rng(0).standard_normal((2, 17, 80)).astype(np.float32)
    with torch.no_grad():
        got = voc(torch.from_numpy(mel)).numpy()
        ref = tgen(torch.from_numpy(mel).transpose(1, 2)).numpy()
    want = np.asarray(JGen(**SMALL).apply({"params": j_conv(sd)}, jnp.asarray(mel)))
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(got, ref, atol=1e-5)


@pytest.mark.parametrize("ratios", [(4, 2), (4, 3)])
def test_melgan_converts_and_runs_as_jax(ratios):
    """A weight-normed descript MelGAN state dict: ``convert_melgan`` gives
    the JAX package's tree, and the port's generator on natural-log mels
    gives the JAX ``vocode`` (log10 scaling included) within 1e-5."""
    from speakingstyle_tpu.compat.torch_convert import convert_melgan as j_conv
    from speakingstyle_tpu.models.melgan import MelGANGenerator as JMel
    from speakingstyle_torch.compat.from_jax import load_flax_variables
    from speakingstyle_torch.compat.torch_convert import convert_melgan
    from speakingstyle_torch.models.melgan import MelGANGenerator

    torch.manual_seed(0)
    sd = {k: v.detach().numpy() for k, v in _torch_melgan(ratios=ratios).state_dict().items()}
    params = convert_melgan(sd)
    _assert_trees_equal(params, j_conv(sd))
    gen = load_flax_variables(MelGANGenerator(80, ngf=8, n_residual_layers=2, ratios=ratios),
                              {"params": params})
    assert gen.hop_factor == math.prod(ratios)
    mel = np.random.default_rng(1).standard_normal((2, 13, 80)).astype(np.float32)
    with torch.no_grad():
        got = gen(torch.from_numpy(mel)).numpy()
    jgen = JMel(n_mels=80, ngf=8, n_residual_layers=2, ratios=ratios)
    want = np.asarray(jgen.vocode(j_conv(sd), jnp.asarray(mel)))
    assert got.shape == want.shape == (2, 13 * math.prod(ratios))
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_melgan_hub_file_through_get_vocoder(tmp_path):
    """The preset MelGAN (ngf 32, 3 residual layers, ratios 8, 8, 2, 2)
    from a saved hub state dict under ``model_g``: the port's
    ``get_vocoder`` against the JAX package's on the same file, 1e-5."""
    from speakingstyle_tpu.configs.config import load_config as j_load
    from speakingstyle_tpu.synthesis import get_vocoder as j_get
    from speakingstyle_torch.configs.config import load_config as t_load
    from speakingstyle_torch.synthesis import get_vocoder

    torch.manual_seed(2)
    tgen = _torch_melgan(ngf=32, n_residual_layers=3, ratios=(8, 8, 2, 2))
    path = tmp_path / "melgan.pt"
    torch.save({"model_g": tgen.state_dict()}, str(path))

    def melgan(cfg):
        return dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, vocoder=dataclasses.replace(cfg.model.vocoder, model="MelGAN")))

    voc = get_vocoder(melgan(t_load(preset="LJSpeech")), str(path))
    jgen, jparams = j_get(melgan(j_load(preset="LJSpeech")), str(path))
    mel = np.random.default_rng(3).standard_normal((1, 6, 80)).astype(np.float32)
    with torch.no_grad():
        got = voc(torch.from_numpy(mel)).numpy()
    np.testing.assert_allclose(got, np.asarray(jgen.vocode(jparams, jnp.asarray(mel))),
                               atol=1e-5)


# ---------------------------------------------------------------- Flax msgpack


def test_generator_msgpack_sidecar_both_ways(tmp_path, monkeypatch):
    """The JAX ``convert --kind hifigan`` writes the sidecar and the port
    reads it; the port's ``convert --kind hifigan`` writes the same bytes
    and the JAX ``get_vocoder`` reads them; both load the .pth.tar's
    weights."""
    import argparse

    from speakingstyle_tpu.cli import convert as j_cli
    from speakingstyle_tpu.configs.config import load_config as j_load
    from speakingstyle_tpu.synthesis import get_vocoder as j_get
    from speakingstyle_torch.__main__ import main
    from speakingstyle_torch.configs.config import load_config as t_load
    from speakingstyle_torch.synthesis import get_vocoder

    tgen = _weight_normed_hifigan(3)
    sd = {k: v.detach().numpy() for k, v in tgen.state_dict().items()}
    pth = _save_pth(tmp_path / "generator_y.pth.tar", sd, "generator")
    j_out = str(tmp_path / "jax.generator.msgpack")
    j_cli.main(argparse.Namespace(kind="hifigan", ckpt=pth, out=j_out))
    t_out = main(["convert", "--kind", "hifigan", "--ckpt", pth])
    assert t_out == pth + ".generator.msgpack"
    assert open(j_out, "rb").read() == open(t_out, "rb").read()

    cfg_json = _small_hifigan(monkeypatch, tmp_path)
    tcfg = t_load(preset="LJSpeech")
    from_pth = get_vocoder(tcfg, pth).state_dict()
    for path in (j_out, t_out):
        got = get_vocoder(tcfg, path).state_dict()
        assert sorted(got) == sorted(from_pth)
        for k in got:
            assert torch.equal(got[k], from_pth[k]), k
    _, j_params = j_get(j_load(preset="LJSpeech"), t_out, config_path=cfg_json)
    _, j_from_pth = j_get(j_load(preset="LJSpeech"), pth, config_path=cfg_json)
    _assert_trees_equal(jax.device_get(j_params), jax.device_get(j_from_pth))


def test_msgpack_chunked_and_bf16_leaves(tmp_path, monkeypatch):
    """Leaves past ``MAX_CHUNK_SIZE`` are chunked by the writer of either
    package and joined by the reader of either (both limits lowered to 64
    bytes); bf16 leaves read as torch.bfloat16; ints, floats, strings,
    nil, bool and lists (as maps keyed "0", "1", ...) round-trip."""
    from flax import serialization

    from speakingstyle_torch.compat import flax_msgpack as fm

    rng = np.random.default_rng(4)
    tree = {"conv": {"kernel": rng.standard_normal((7, 4, 5)).astype(np.float32),
                     "bias": rng.standard_normal(5).astype(np.float32)},
            "half": jnp.asarray(rng.standard_normal((3, 4)), jnp.bfloat16),
            "step": 12345, "lr": 0.5, "name": "generator", "none": None, "flag": True,
            "pair": [np.int32(3), np.arange(4, dtype=np.int64)]}
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(fm, "MAX_CHUNK_SIZE", 64)
    j_bytes = serialization.to_bytes(tree)
    port_tree = dict(tree, half=torch.from_numpy(
        np.array(tree["half"].astype(jnp.float32))).to(torch.bfloat16))
    t_bytes = fm.to_bytes(port_tree)
    assert t_bytes == j_bytes
    assert fm.CHUNKED.encode() in t_bytes  # the kernel (560 bytes) was chunked

    back = fm.msgpack_restore(j_bytes)
    np.testing.assert_array_equal(back["conv"]["kernel"], tree["conv"]["kernel"])
    np.testing.assert_array_equal(back["conv"]["bias"], tree["conv"]["bias"])
    assert back["half"].dtype == torch.bfloat16
    assert torch.equal(back["half"], port_tree["half"])
    assert (back["step"], back["lr"], back["name"], back["none"], back["flag"]) == \
        (12345, 0.5, "generator", None, True)
    assert back["pair"]["0"] == 3 and back["pair"]["0"].dtype == np.int32
    np.testing.assert_array_equal(back["pair"]["1"], np.arange(4))
    j_back = serialization.msgpack_restore(t_bytes)
    np.testing.assert_array_equal(np.asarray(j_back["conv"]["kernel"]), tree["conv"]["kernel"])


def test_full_vocoder_state_file_is_refused(tmp_path):
    """A msgpack of a whole VocoderState (``gen_params`` and the rest) is
    refused with the sidecar named, as the JAX package refuses it."""
    from flax import serialization

    from speakingstyle_torch.configs.config import load_config
    from speakingstyle_torch.synthesis import get_vocoder

    path = tmp_path / "vocoder_100.msgpack"
    path.write_bytes(serialization.to_bytes(
        {"gen_params": {"conv_pre": {"conv": {"bias": np.zeros(4, np.float32)}}},
         "step": 100}))
    with pytest.raises(ValueError, match="generator.msgpack"):
        get_vocoder(load_config(preset="LJSpeech"), str(path))


def test_flax_version_is_the_format_the_reader_was_written_for():
    """The ext codes and the chunk limit the port copies are Flax's."""
    from flax import serialization

    from speakingstyle_torch.compat import flax_msgpack as fm

    assert fm.MAX_CHUNK_SIZE == serialization.MAX_CHUNK_SIZE
    assert (fm.EXT_NDARRAY, fm.EXT_NPSCALAR) == (
        serialization._MsgpackExtType.ndarray, serialization._MsgpackExtType.npscalar)
    assert flax.__version__
