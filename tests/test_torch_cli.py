"""PyTorch port, the synthesis entry points over trained weights, on the CPU.

``synthesize --restore_step`` against the in-memory model the port's
``train`` left (bit for bit), batch mode against single requests, the
speaker registry and the reference loader against the JAX package's
``TextFrontend``, every preset against the JAX package's, the refusal of
an Orbax step directory, and the rendering helpers (``istft``,
``griffin_lim``, ``render_result``) against the JAX package's with the
same initial phases (float32, within the tolerance stated at each).
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from test_torch_training import corpus, write_configs  # noqa: F401 (a fixture)
from test_torch_models import one_cpu_thread  # noqa: F401 (an autouse fixture)


def _ref_wav(path, seconds=0.4, f0=220.0):
    t = np.arange(int(22050 * seconds)) / 22050.0
    wav = 0.3 * np.sin(2 * np.pi * f0 * t) + 0.1 * np.sin(2 * np.pi * 3 * f0 * t)
    wavfile.write(str(path), 22050, (wav * 32767).astype(np.int16))
    return str(path)


# a lattice within the tiny model's position table (max_seq_len 64)
SERVE = {"batch_buckets": [1, 2, 4], "src_buckets": [16], "mel_buckets": [64],
         "frames_per_phoneme": 4, "style": {"ref_buckets": [64]}}
# CMUdict entries of the texts below, in read_lexicon's format
LEXICON = "hello HH AH0 L OW1\nworld W ER1 L D\nhi HH AY1\n"


def add_lexicon(preprocess_yaml, root):
    """Point the preprocess config at a lexicon of the tests' words."""
    import yaml

    (root / "lexicon.txt").write_text(LEXICON)
    pre = yaml.safe_load(open(preprocess_yaml))
    pre["path"]["lexicon_path"] = str(root / "lexicon.txt")
    open(preprocess_yaml, "w").write(yaml.safe_dump(pre))


def _args(paths, *extra):
    return ["synthesize", "-p", paths["preprocess"], "-m", paths["model"],
            "-t", paths["train"], "--device", "cpu", *extra]


@pytest.fixture(scope="module")
def trained(tmp_path_factory, corpus):  # noqa: F811
    """The tiny config trained for 2 steps by the port's ``train`` on the
    CPU: (config paths, the in-memory TrainState, the run's directory)."""
    from speakingstyle_torch.__main__ import main

    root = tmp_path_factory.mktemp("trained")
    paths = write_configs(root, corpus, path={"result_path": str(root / "result")},
                          serve=SERVE)
    add_lexicon(paths["preprocess"], root)
    state = main(["train", "-p", paths["preprocess"], "-m", paths["model"],
                  "-t", paths["train"], "--device", "cpu", "--max_steps", "2"])
    assert state.step == 2
    return paths, state, root


def test_restore_step_synthesizes_the_trained_model(trained):
    """``synthesize --restore_step 2`` restores the checkpoint ``train``
    wrote (manifest checked) and gives the in-memory model's durations, mel
    and wav bit for bit; the wav lands in <result_path>/2/<id>.wav, and
    ``--restore_step -1`` finds the same step."""
    from speakingstyle_torch.__main__ import main
    from speakingstyle_torch.configs.config import load_config
    from speakingstyle_torch.serving.engine import SynthesisEngine
    from speakingstyle_torch.synthesis import get_vocoder

    paths, state, root = trained
    ref = _ref_wav(root / "ref.wav")
    args = ["--mode", "single", "--text", "hello world", "--ref_audio", ref]
    ns = main(_args(paths, "--restore_step", "2", *args))
    assert ns.info["step"] == 2 and ns.info["weights_digest"]
    assert ns.paths == [os.path.join(str(root / "result"), "2", "hello_world.wav")]
    cfg = load_config(paths["preprocess"], paths["model"], paths["train"])
    memory = SynthesisEngine(cfg, model=state.model, vocoder=get_vocoder(cfg, seed=1),
                             device="cpu")
    want = memory.run(ns.requests)[0]
    got = ns.results[0]
    assert got.mel_len == want.mel_len > 0
    np.testing.assert_array_equal(got.durations, want.durations)
    np.testing.assert_array_equal(got.mel, want.mel)
    np.testing.assert_array_equal(got.wav, want.wav)
    sr, wav = wavfile.read(ns.paths[0])
    assert sr == 22050 and np.array_equal(wav, got.wav)
    latest = main(_args(paths, "--restore_step", "-1", *args))
    assert latest.info == ns.info
    np.testing.assert_array_equal(latest.results[0].mel, got.mel)


def seeded_checkpoint(root, corpus, step, speakers=None, **model_overrides):  # noqa: F811
    """Configs of the tiny model (with SERVE and the lexicon) and a
    checkpoint at ``step`` of its seeded weights, the duration predictor's
    bias raised by 1.1 so that they predict a few frames a phoneme;
    ``speakers`` replaces the corpus's speakers.json. Returns (config
    paths, the saved model)."""
    import shutil

    import yaml

    from speakingstyle_torch.configs.config import load_config
    from speakingstyle_torch.training.checkpoint import CheckpointManager
    from speakingstyle_torch.training.trainer import build_state

    paths = write_configs(root, corpus, path={"result_path": str(root / "result")},
                          serve=SERVE)
    add_lexicon(paths["preprocess"], root)
    if speakers is not None:
        pre_dir = root / "preprocessed"
        pre_dir.mkdir()
        shutil.copy(os.path.join(corpus, "stats.json"), pre_dir)
        (pre_dir / "speakers.json").write_text(json.dumps(speakers))
        pre = yaml.safe_load(open(paths["preprocess"]))
        pre["path"]["preprocessed_path"] = str(pre_dir)
        open(paths["preprocess"], "w").write(yaml.safe_dump(pre))
    model = yaml.safe_load(open(paths["model"]))
    model.update(model_overrides)
    open(paths["model"], "w").write(yaml.safe_dump(model))
    cfg = load_config(paths["preprocess"], paths["model"], paths["train"])
    state = build_state(cfg, "cpu")
    with torch.no_grad():
        state.model.variance_adaptor.duration_predictor.linear_layer.bias.add_(1.1)
    CheckpointManager(cfg.train.path.ckpt_path).save(step, state)
    return paths, state.model


def test_batch_mode_encodes_one_shared_reference_once(tmp_path, corpus):  # noqa: F811
    """``--mode batch --source`` over the synthetic corpus's metadata with
    one ``--ref_audio``: the reference encoder runs once for the whole
    batch, the requests go out in dispatches of at most the lattice's
    largest batch, and each result equals its own single-request run (the
    reference encoded inside that run): equal durations and mel lengths,
    the mel within 1e-5 (other paddings only reorder f32 sums). Free-running,
    the postnet reads its dispatch's buffer up to the longest row (the
    reference's semantics), so a shorter row's last frames within the
    postnet's reach of its end are compared only for the longest rows."""
    from speakingstyle_torch.__main__ import main
    from speakingstyle_torch.serving.frontend import load_ref_mel

    paths, _ = seeded_checkpoint(tmp_path, corpus, 3)
    ref = _ref_wav(tmp_path / "ref_batch.wav", seconds=0.3)
    source = os.path.join(corpus, "train.txt")
    ns = main(_args(paths, "--restore_step", "3", "--mode", "batch", "--source", source,
                    "--ref_audio", ref, "--griffin_lim"))
    engine = ns.engine
    n = len(ns.requests)
    assert n == 11 and len(ns.paths) == n
    assert engine.style_encodes == 1
    most = engine.lattice.batch_buckets[-1]
    assert engine.dispatches == -(-n // most)
    reach = engine.cfg.model.postnet_layers * (engine.cfg.model.postnet_kernel_size // 2)
    ref_mel = load_ref_mel(engine.cfg, ref)
    compared = 0
    for i, (req, got) in enumerate(zip(ns.requests, ns.results)):
        assert req.style is not None and req.ref_mel is None
        alone = engine.run([dataclasses.replace(req, style=None, ref_mel=ref_mel)])[0]
        assert got.id == alone.id and got.mel_len == alone.mel_len > reach
        np.testing.assert_array_equal(got.durations, alone.durations)
        longest = max(r.mel_len for r in ns.results[i - i % most: i - i % most + most])
        upto = got.mel_len if got.mel_len == longest else got.mel_len - reach
        np.testing.assert_allclose(got.mel[:upto], alone.mel[:upto], atol=1e-5)
        compared += upto
        assert os.path.isfile(os.path.join(str(tmp_path / "result"), "3", f"{got.id}.wav"))
    assert engine.style_encodes == 1 + n
    assert compared > sum(r.mel_len for r in ns.results) // 2


def test_batch_mode_without_reference_reads_each_items_mel(trained, corpus):  # noqa: F811
    """Without ``--ref_audio`` each item's preprocessed mel is its
    reference; per-word controls are refused outside single mode."""
    from speakingstyle_torch.__main__ import main

    paths, _, _ = trained
    source = os.path.join(corpus, "val.txt")
    ns = main(_args(paths, "--restore_step", "2", "--mode", "batch", "--source", source,
                    "--griffin_lim"))
    assert len(ns.results) == 3
    assert all(r.style is None and r.ref_mel is not None for r in ns.requests)
    with pytest.raises(SystemExit, match="per-word"):
        main(_args(paths, "--restore_step", "2", "--mode", "batch", "--source", source,
                   "--duration_control", "1.0,2.0"))


def test_speaker_registry_matches_jax(tmp_path):
    """``TextFrontend.speaker``: a name from speakers.json, a numeric id
    range-checked against the registry, and an unknown name, against the
    JAX package's on the same speakers.json."""
    from speakingstyle_tpu.configs.config import load_config as j_load
    from speakingstyle_tpu.serving.server import TextFrontend as JFrontend
    from speakingstyle_torch.configs.config import load_config as t_load
    from speakingstyle_torch.serving.frontend import TextFrontend

    root = tmp_path / "pre"
    root.mkdir()
    (root / "speakers.json").write_text(json.dumps({"SSB0005": 0, "SSB0009": 1, "p225": 2}))
    pre = tmp_path / "preprocess.yaml"
    pre.write_text(f"path:\n  preprocessed_path: {root}\n")
    jf, tf = JFrontend(j_load(preprocess=str(pre)), None), TextFrontend(t_load(str(pre)))
    for spec in ("SSB0009", "p225", "0", "2", 1):
        assert tf.speaker(spec) == jf.speaker(spec)
    for spec in ("nobody", "3", "-1", 7):
        with pytest.raises(ValueError) as want:
            jf.speaker(spec)
        with pytest.raises(ValueError) as got:
            tf.speaker(spec)
        assert str(got.value) == str(want.value)
    # no registry: any numeric id, no names
    empty = TextFrontend(t_load())
    assert empty.speaker("5") == 5
    with pytest.raises(ValueError, match="unknown speaker"):
        empty.speaker("SSB0005")


def test_speaker_id_drives_a_multi_speaker_model(tmp_path, corpus):  # noqa: F811
    """A multi-speaker config: ``--speaker_id`` by name and by id pick the
    same embedding row (another row gives another mel), an unknown name or
    an id outside the registry stops the command."""
    from speakingstyle_torch.__main__ import main

    paths, model = seeded_checkpoint(tmp_path, corpus, 7, speakers={"SYNTH": 0, "p225": 1},
                                     multi_speaker=True)
    assert model.speaker_emb.weight.shape[0] == 2
    ref = _ref_wav(tmp_path / "ref.wav")
    args = ["--restore_step", "7", "--mode", "single", "--text", "hi", "--ref_audio", ref,
            "--griffin_lim"]
    by_name = main(_args(paths, *args, "--speaker_id", "p225"))
    by_id = main(_args(paths, *args, "--speaker_id", "1"))
    other = main(_args(paths, *args, "--speaker_id", "SYNTH"))
    assert by_name.requests[0].speaker == by_id.requests[0].speaker == 1
    assert other.requests[0].speaker == 0
    np.testing.assert_array_equal(by_name.results[0].mel, by_id.results[0].mel)
    assert not np.allclose(by_name.results[0].pitch_prediction,
                           other.results[0].pitch_prediction)
    with pytest.raises(SystemExit, match="unknown speaker"):
        main(_args(paths, *args, "--speaker_id", "nobody"))
    with pytest.raises(SystemExit, match="outside the registry"):
        main(_args(paths, *args, "--speaker_id", "3"))


UNPORTED_DEFAULTS = {f"train.resilience.{k}"
                     for k in ("nan_sentinel", "keep_best", "async_checkpointing")}


@pytest.mark.parametrize("preset", ["LJSpeech", "LJSpeech_paper", "AISHELL3", "BC2013",
                                    "LibriTTS"])
def test_presets_match_jax(preset):
    """Each preset loads in both packages, and every field the port reads
    has the JAX package's value, but for the defaults of the resilience
    paths the port has not ported yet (ROADMAP.md queue A item 2: off in the
    port, on in the JAX package; no preset sets them)."""
    from speakingstyle_tpu.configs.config import load_config as j_load
    from speakingstyle_torch.configs.config import load_config as t_load

    def same(t, j, where):
        if dataclasses.is_dataclass(t):
            for f in dataclasses.fields(t):
                same(getattr(t, f.name), getattr(j, f.name), f"{where}.{f.name}")
        elif isinstance(t, (list, tuple)):
            assert len(t) == len(j), where
            for i, (a, b) in enumerate(zip(t, j)):
                same(a, b, f"{where}[{i}]")
        elif where not in UNPORTED_DEFAULTS:
            assert t == j, where

    t, j = t_load(preset=preset), j_load(preset=preset)
    for part in ("preprocess", "model", "train"):
        same(getattr(t, part), getattr(j, part), part)
    assert t.model.multi_speaker == (preset in ("AISHELL3", "LibriTTS"))


def test_orbax_step_directory_names_the_convert_route(tmp_path, trained):
    """A step directory of the JAX package (an Orbax checkpoint with its
    manifest and no state.pt) is refused with an error that names
    ``convert``, for an explicit step and for the latest; the port's own
    steps beside it still restore."""
    from speakingstyle_torch.__main__ import main
    from speakingstyle_torch.training.checkpoint import (
        CheckpointManager, ForeignCheckpointError,
    )
    from speakingstyle_torch.training.trainer import build_state
    from speakingstyle_torch.configs.config import load_config

    paths, _, root = trained
    orbax = tmp_path / "ckpt" / "5"
    (orbax / "default").mkdir(parents=True)
    (orbax / "manifest.json").write_text(json.dumps({"format": 1, "step": 5, "leaves": {}}))
    (orbax / "_CHECKPOINT_METADATA").write_text("{}")
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    cfg = load_config(paths["preprocess"], paths["model"], paths["train"])
    model = build_state(cfg, "cpu").model
    for step in (5, None):
        with pytest.raises(ForeignCheckpointError, match="speakingstyle_torch convert"):
            mgr.restore_weights(model, step=step)
    assert mgr.all_steps() == []
    # the same through the command, pointed at that directory
    train = tmp_path / "train.yaml"
    train.write_text(open(paths["train"]).read().replace(str(root / "ckpt"),
                                                           str(tmp_path / "ckpt")))
    with pytest.raises(ForeignCheckpointError, match="Orbax"):
        main(["synthesize", "-p", paths["preprocess"], "-m", paths["model"], "-t", str(train),
              "--device", "cpu", "--restore_step", "5", "--mode", "single", "--text", "hi",
              "--ref_audio", _ref_wav(tmp_path / "r.wav")])
    with pytest.raises(FileNotFoundError):
        mgr.restore_weights(model, step=9)


def test_griffin_lim_plot_and_short_results(trained, tmp_path):
    """``--griffin_lim --plot`` writes a wav and a png; a result of fewer
    than 2 frames renders as an empty, valid wav."""
    from speakingstyle_torch.__main__ import main
    from speakingstyle_torch.synthesis import render_result

    paths, _, root = trained
    ns = main(_args(paths, "--restore_step", "2", "--mode", "single", "--text", "hello",
                    "--ref_audio", _ref_wav(root / "ref_plot.wav"), "--griffin_lim", "--plot"))
    res = ns.results[0]
    assert res.wav is None and res.mel_len >= 2
    sr, wav = wavfile.read(ns.paths[0])
    assert wav.dtype == np.int16 and len(wav) > 0
    assert os.path.isfile(ns.paths[0][:-4] + ".png")
    short = dataclasses.replace(res, id="short", mel=res.mel[:1], mel_len=1)
    out = render_result(short, ns.engine.cfg, str(tmp_path))
    assert os.path.getsize(out) == 44 and len(wavfile.read(out)[1]) == 0


# ---------------------------------------------------------------- rendering vs JAX


def test_istft_matches_jax():
    """Overlap-add inverse STFT against the JAX package's: 1e-6 absolute
    (two f32 irffts, 4 overlapping frames a sample)."""
    from speakingstyle_tpu.audio import tools as jt
    from speakingstyle_torch.audio import tools as tt

    rng = np.random.default_rng(0)
    mag = np.abs(rng.standard_normal((2, 513, 20))).astype(np.float32)
    phase = rng.uniform(-np.pi, np.pi, (2, 513, 20)).astype(np.float32)
    want = np.asarray(jt.istft(jnp.asarray(mag), jnp.asarray(phase), 1024, 256, 1024))
    got = tt.istft(torch.from_numpy(mag), torch.from_numpy(phase), 1024, 256, 1024).numpy()
    assert got.shape == want.shape == (2, 19 * 256)
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("frames", [3, 24])
def test_griffin_lim_matches_jax_from_the_same_angles(frames):
    """30 Griffin-Lim iterations from the JAX package's initial phases
    (``PRNGKey(0)``, threefry pinned), passed to the port: 1e-5 absolute,
    f32 rounding carried through 30 FFT round trips. 3 frames make a
    signal shorter than the STFT's reflect-pad, which numpy reflects
    again."""
    from speakingstyle_tpu.audio import tools as jt
    from speakingstyle_torch.audio import tools as tt

    mag = np.abs(np.random.default_rng(frames).standard_normal((1, 513, frames))).astype(
        np.float32)
    with jax.default_prng_impl("threefry2x32"):
        want = np.asarray(jt.griffin_lim(jnp.asarray(mag), 1024, 256, 1024))
        angles = np.asarray(jax.random.uniform(jax.random.PRNGKey(0), mag.shape,
                                               minval=-np.pi, maxval=np.pi))
    got = tt.griffin_lim(torch.from_numpy(mag), 1024, 256, 1024,
                         angles=torch.from_numpy(angles.copy())).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5)
    # the port's own draw: seeded, so two runs agree
    a, b = (tt.griffin_lim(torch.from_numpy(mag), 1024, 256, 1024, n_iters=2,
                           generator=torch.Generator().manual_seed(0)) for _ in range(2))
    assert torch.equal(a, b)


def test_save_wav_and_expand_match_jax(tmp_path):
    from speakingstyle_tpu import synthesis as js
    from speakingstyle_tpu.audio import tools as jt
    from speakingstyle_torch import synthesis as ts
    from speakingstyle_torch.audio import tools as tt

    wav = np.random.default_rng(2).uniform(-1.5, 1.5, 500).astype(np.float32)
    jt.save_wav(str(tmp_path / "j.wav"), wav, 22050)
    tt.save_wav(str(tmp_path / "t.wav"), wav, 22050)
    assert open(tmp_path / "j.wav", "rb").read() == open(tmp_path / "t.wav", "rb").read()
    vals, durs = np.array([0.5, -1.0, 2.0]), np.array([2, 0, 3])
    np.testing.assert_array_equal(ts.expand(vals, durs), js.expand(vals, durs))
