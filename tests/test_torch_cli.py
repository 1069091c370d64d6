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
from torch_threads import no_tensorflow  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("no_tensorflow")


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
    one ``--ref_audio``: the StyleService encodes the reference once for
    the whole batch (one encoder dispatch, one cache entry), the requests
    go out in dispatches of at most the lattice's largest batch, and each
    result equals its own single-request run (the reference's mel resolved
    inside that run: encoded once under the mel's content address, then
    served from the cache): equal durations and mel lengths,
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
    style = engine.style
    assert style.dispatch_count == engine.style_encodes == 1 and len(style) == 1
    assert engine.registry.value("serve_style_cache_misses_total") == 1
    hits = engine.registry.value("serve_style_cache_hits_total")
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
    assert style.dispatch_count == engine.style_encodes == 2 and len(style) == 2
    assert engine.registry.value("serve_style_cache_hits_total") == hits + n - 1
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
    # three distinct references, fresh in one dispatch: one encoder pass
    style = ns.engine.style
    assert style.dispatch_count == 1 and len(style) == 3
    assert ns.engine.registry.value("serve_style_cache_misses_total") == 3
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


@pytest.mark.parametrize("preset", ["LJSpeech", "LJSpeech_paper", "AISHELL3", "BC2013",
                                    "LibriTTS"])
def test_presets_match_jax(preset):
    """Each preset loads in both packages, and every field the port reads
    has the JAX package's value, the resilience defaults included."""
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
        else:
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


# ---------------------------------------------------------------- vocoder training,
# distillation and vocode


@pytest.fixture(scope="module")
def vocoder_run(tmp_path_factory):
    """``train_vocoder`` on the CPU at SEG 1024 with the small generator
    (32 initial channels, also written as a config.json for ``vocode``)
    and small discriminators (periods 2 and 3 of narrow channels, one
    scale), all patched into the trainer: 2 steps, then ``--restore`` of
    its step-2 checkpoint to step 3. Returns (root, the generator config,
    the two runs' states)."""
    import functools

    from speakingstyle_torch.__main__ import main
    from speakingstyle_torch.models import hifigan_disc
    from speakingstyle_torch.training import vocoder_trainer

    root = tmp_path_factory.mktemp("vocoder")
    (root / "wavs").mkdir()
    for i, f0 in enumerate((180.0, 220.0, 260.0, 300.0)):
        _ref_wav(root / "wavs" / f"w{i}.wav", seconds=0.3, f0=f0)
    config = root / "config.json"
    small_gen = {"upsample_rates": [8, 8, 2, 2], "upsample_kernel_sizes": [16, 16, 4, 4],
                 "upsample_initial_channel": 32}
    config.write_text(json.dumps(small_gen))
    common = ["train_vocoder", "--input_wavs_dir", str(root / "wavs"), "--checkpoint_path",
              str(root / "ckpt"), "--batch_size", "2", "--log_every", "1", "--device", "cpu"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(vocoder_trainer, "Generator", functools.partial(
            vocoder_trainer.Generator, **small_gen))
        mp.setattr(vocoder_trainer, "VocoderHParams", functools.partial(
            vocoder_trainer.VocoderHParams, segment_size=1024))
        mp.setattr(vocoder_trainer, "MultiPeriodDiscriminator", functools.partial(
            hifigan_disc.MultiPeriodDiscriminator, (2, 3), (8, 16, 32, 32, 32)))
        mp.setattr(vocoder_trainer, "MultiScaleDiscriminator", functools.partial(
            hifigan_disc.MultiScaleDiscriminator, 1))
        first = main(common + ["--training_steps", "2"])
        resumed = main(common + ["--training_steps", "3", "--restore",
                                 str(root / "ckpt" / "vocoder_00000002.msgpack")])
    return root, config, (first, resumed)


def test_train_vocoder_command_saves_and_resumes(vocoder_run):
    root, _, (first, resumed) = vocoder_run
    assert first.step == 2 and resumed.step == 3
    names = sorted(p.name for p in (root / "ckpt").iterdir())
    assert names == [f"vocoder_0000000{s}.msgpack{x}" for s in (2, 3)
                     for x in ("", ".generator.msgpack")]
    # the resumed run started from the saved discriminators and moments
    assert resumed.gen_opt.count == 3 and resumed.disc_opt.count == 3


@pytest.mark.parametrize("layout", ["mels_frames_first", "mels_channels_first", "wavs"])
def test_vocode_command_writes_int16_wavs_of_t_hops(vocoder_run, tmp_path, layout):
    """``vocode`` with the trained generator sidecar: a mel dir in either
    layout ([T, 80] or [80, T]; T = 70, padded to 128 and trimmed) and a
    wav dir (wav -> mel -> wav); int16 wavs of T * 256 samples."""
    from speakingstyle_torch.__main__ import main

    root, config, _ = vocoder_run
    src = tmp_path / "in"
    src.mkdir()
    if layout == "wavs":
        _ref_wav(src / "a.wav", seconds=0.5)
        frames = int(22050 * 0.5) // 256 + 1
        flag = "--input_wavs_dir"
    else:
        frames = 70
        mel = np.random.default_rng(0).standard_normal((frames, 80)).astype(np.float32) - 5
        np.save(src / "a.npy", mel if layout == "mels_frames_first" else mel.T)
        flag = "--input_mels_dir"
    written = main(["vocode", flag, str(src), "--output_dir", str(tmp_path / "out"),
                    "--checkpoint_file", str(root / "ckpt" / "vocoder_00000003.msgpack"
                                             ".generator.msgpack"),
                    "--hifigan_config", str(config), "--device", "cpu"])
    assert len(written) == 1
    sr, wav = wavfile.read(written[0])
    assert sr == 22050 and wav.dtype == np.int16 and len(wav) == frames * 256


def test_distill_command_checkpoints_the_student(tmp_path, corpus, monkeypatch):  # noqa: F811
    from speakingstyle_torch.__main__ import main
    from speakingstyle_torch.training.checkpoint import CheckpointManager

    # --faults sets the variable for the process: restore it after the test
    monkeypatch.setenv("SPEAKINGSTYLE_FAULTS", "")
    paths = write_configs(tmp_path, corpus, serve=SERVE)
    state = main(["distill", "-p", paths["preprocess"], "-m", paths["model"],
                  "-t", paths["train"], "--device", "cpu", "--max_steps", "3",
                  "--batch_size", "2", "--src_len", "6", "--faults", "sigterm@2"])
    assert state.step == 2
    assert CheckpointManager(str(tmp_path / "ckpt" / "student")).all_steps() == [2]
    # no teacher checkpoint: the seeded fresh teacher, as --fresh_teacher gives
    monkeypatch.setenv("SPEAKINGSTYLE_FAULTS", "")
    again = main(["distill", "-p", paths["preprocess"], "-m", paths["model"],
                  "-t", paths["train"], "--device", "cpu", "--max_steps", "2",
                  "--batch_size", "2", "--src_len", "6", "--fresh_teacher"])
    for a, b in zip(state.model.state_dict().values(), again.model.state_dict().values()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("command", ["train_vocoder", "distill", "vocode"])
def test_new_commands_run_on_cuda_unless_told(command, monkeypatch, tmp_path):
    from speakingstyle_torch.__main__ import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    extra = {"train_vocoder": ["--input_wavs_dir", str(tmp_path)],
             "distill": [],
             "vocode": ["--input_mels_dir", str(tmp_path), "--checkpoint_file", "g.msgpack"]}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main([command, *extra[command]])


def test_serve_command_precompiles_serves_and_drains_on_sigterm(tmp_path, corpus):  # noqa: F811
    """``python -m speakingstyle_torch serve`` on the CPU over a saved
    checkpoint: it prepares the whole lattice before it binds (the
    "precompiled N synthesis + M style programs" line), answers a request
    on the port it printed (mel JSON under --griffin_lim) and /healthz with
    its model and SLO blocks, prints the JAX command's warnings for
    --enable_rollout and --cluster without a fleet, and exits 0 on
    SIGTERM."""
    import http.client
    import signal
    import subprocess
    import sys

    paths, _ = seeded_checkpoint(tmp_path, corpus, 3)
    ref = _ref_wav(tmp_path / "ref.wav", seconds=0.3)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen(
        [sys.executable, "-m", "speakingstyle_torch", "serve", "-p", paths["preprocess"],
         "-m", paths["model"], "-t", paths["train"], "--restore_step", "3", "--device", "cpu",
         "--griffin_lim", "--ref_audio", ref, "--host", "127.0.0.1", "--port", "0",
         "--enable_rollout", "--cluster"],
        cwd=repo, env=dict(os.environ, PYTHONPATH=repo, OMP_NUM_THREADS="1"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines = []
    try:
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("serving on http://"):
                break
        address = lines[-1].split("http://", 1)[1].split(" ", 1)[0]
        host, port = address.rsplit(":", 1)
        conn = http.client.HTTPConnection(host, int(port), timeout=120)
        conn.request("POST", "/synthesize", body=json.dumps({"text": "hello world"}))
        resp = conn.getresponse()
        body = json.loads(resp.read())
        conn.request("GET", "/healthz")
        health = conn.getresponse()
        health_body = json.loads(health.read())
        conn.close()
        proc.send_signal(signal.SIGTERM)
        rest, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    out = "".join(lines) + rest
    assert proc.returncode == 0, out
    assert "precompiled 3 synthesis + 3 style programs" in out
    assert "warning: --enable_rollout needs fleet mode" in out
    assert "warning: --cluster needs fleet mode" in out
    assert health.status == 200 and health_body["model"]["step"] == 3
    assert set(health_body["slo"]) == {"interactive", "batch"}
    assert "SIGTERM: draining" in out and "server stopped" in out
    assert resp.status == 200 and resp.getheader("X-Model-Version").startswith("3:")
    assert body["mel_len"] > 0 and len(body["mel"]) == body["mel_len"]


def test_serve_command_refuses_a_fleet_and_runs_on_cuda_unless_told(monkeypatch):
    """Without ``--device cpu`` the serve command needs a card, on one
    engine, a fleet or the cluster (``--replicas 2 --cluster``: the router
    process needs one before it spawns a replica); so does the replica
    command. A replica spanning hosts (``--coordinator_address``,
    ``--num_processes``, ``--process_id``) is refused naming ROADMAP queue A
    item 6."""
    from speakingstyle_torch.__main__ import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["serve", "--restore_step", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["serve", "--restore_step", "1", "--replicas", "2"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["serve", "--restore_step", "1", "--replicas", "2", "--cluster"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["replica", "--restore_step", "1", "--replica_id", "r1", "--router", "127.0.0.1:9"])
    for extra in (["--coordinator_address", "10.0.0.1:1234"], ["--num_processes", "2"],
                  ["--process_id", "0"]):
        with pytest.raises(SystemExit, match="queue A item 6"):
            main(["replica", "--restore_step", "1", "--replica_id", "r1", "--router",
                  "127.0.0.1:9", *extra])


def test_serve_command_refuses_the_ring_long_form_tier(tmp_path):
    """``serve.longform.mesh_seq > 1`` (the ring tier) is served since the
    sequence axis was ported (ROADMAP queue A item 6c-i), so no mesh_seq is
    refused any more: on one engine and with a fleet (which serves the
    chunked tier only, as the JAX command does) the command goes past its
    checks to the restore, as for mesh_seq 1. The name is kept from when
    the ring tier was refused."""
    import yaml

    from speakingstyle_torch.__main__ import main

    train = tmp_path / "train.yaml"
    for mesh_seq, replicas in ((2, "1"), (4, "2"), (1, "1")):
        train.write_text(yaml.safe_dump({"serve": {"longform": {"mesh_seq": mesh_seq}}}))
        with pytest.raises(FileNotFoundError):  # past the checks: no checkpoint to restore
            main(["serve", "-t", str(train), "--restore_step", "1", "--replicas", replicas,
                  "--device", "cpu"])


# the ring long-form tier of the serve command at the tiny model: 2 ranks,
# one point past the interactive lattice, within the position table
RING_LONGFORM = {"mesh_seq": 2, "src_buckets": [32], "mel_buckets": [128],
                 "crossfade_frames": 1, "deadline_ms_per_chunk": 30000.0}
# a chapter of the lexicon's words (well under 32 phonemes)
RING_CHAPTER = "hello world. hi world. hello hi."


def ring_checkpoint(root, corpus):  # noqa: F811
    """``seeded_checkpoint``'s configs and checkpoint (step 3) with
    ``serve.longform`` = ``RING_LONGFORM``; returns the config paths."""
    import yaml

    paths, _ = seeded_checkpoint(root, corpus, 3)
    train = yaml.safe_load(open(paths["train"]))
    train["serve"]["longform"] = RING_LONGFORM
    open(paths["train"], "w").write(yaml.safe_dump(train))
    return paths


def test_serve_command_answers_a_chapter_on_the_ring_tier(tmp_path, corpus):  # noqa: F811
    """``python -m speakingstyle_torch serve --device cpu`` with
    ``serve.longform.mesh_seq: 2`` (the JAX command's ring branch): it
    starts its helper rank process, prepares the ring's point before it
    binds, answers ``POST /synthesize/longform`` with ``X-Longform-Tier:
    ring`` (a wav streamed through the vocoder; weights from --seed), and on
    SIGTERM stops the helper and exits 0."""
    import http.client
    import signal
    import subprocess
    import sys

    paths = ring_checkpoint(tmp_path, corpus)
    ref = _ref_wav(tmp_path / "ref.wav", seconds=0.3)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen(
        [sys.executable, "-m", "speakingstyle_torch", "serve", "-p", paths["preprocess"],
         "-m", paths["model"], "-t", paths["train"], "--restore_step", "3", "--device", "cpu",
         "--ref_audio", ref, "--host", "127.0.0.1", "--port", "0"],
        cwd=repo, env=dict(os.environ, PYTHONPATH=repo, OMP_NUM_THREADS="1"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines = []
    try:
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("serving on http://"):
                break
        address = lines[-1].split("http://", 1)[1].split(" ", 1)[0]
        host, port = address.rsplit(":", 1)
        conn = http.client.HTTPConnection(host, int(port), timeout=120)
        conn.request("POST", "/synthesize/longform", body=json.dumps({"text": RING_CHAPTER}))
        resp = conn.getresponse()
        body = resp.read()
        conn.close()
        proc.send_signal(signal.SIGTERM)
        rest, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    out = "".join(lines) + rest
    assert proc.returncode == 0, out
    assert "ring tier ready" in out and "1 ring-attention long-form points" in out
    assert resp.status == 200, body[:300]
    assert resp.getheader("X-Longform-Tier") == "ring"
    assert body[:4] == b"RIFF" and len(body) > 44
    # the helper ran the preparation and the chapter, then stopped
    assert "[ring 1] stopped after 2 program(s)" in out, out
    assert "SIGTERM: draining" in out and "server stopped" in out


@pytest.mark.parametrize("failure", ["helper_exits", "preparation_fails"])
def test_serve_command_exits_when_the_ring_does_not_start(failure, tmp_path, corpus,  # noqa: F811
                                                          monkeypatch):
    """A ring tier that does not start (its helper process exits before it
    joins, or a preparation fails after it joined) ends the serve command
    with a non-zero exit naming the cause, its server closed before it ever
    served and no helper process left; it neither hangs nor serves the
    chunked tier alone."""
    import subprocess
    import sys
    import threading

    from speakingstyle_torch.__main__ import main
    from speakingstyle_torch.parallel import launch
    from speakingstyle_torch.serving.longform import RingTier

    paths = ring_checkpoint(tmp_path, corpus)
    helpers = []
    if failure == "helper_exits":
        def start_workers(*args, **kwargs):
            helpers.append(subprocess.Popen([sys.executable, "-c", "raise SystemExit(3)"]))
            return list(helpers)
        monkeypatch.setattr(launch, "start_workers", start_workers)
        cause = "exited"
    else:
        def precompile(self):
            helpers.extend(self.group.procs)
            raise RuntimeError("CUDA out of memory (injected)")
        monkeypatch.setattr(RingTier, "precompile", precompile)
        cause = "CUDA out of memory"
    raised = []

    def serve():
        try:
            main(["serve", "-p", paths["preprocess"], "-m", paths["model"], "-t",
                  paths["train"], "--restore_step", "3", "--device", "cpu", "--griffin_lim",
                  "--host", "127.0.0.1", "--port", "0"])
        except BaseException as e:  # noqa: B036 (SystemExit is the result)
            raised.append(e)

    thread = threading.Thread(target=serve, daemon=True)
    thread.start()
    thread.join(timeout=120)
    assert not thread.is_alive(), "serve hung after the ring failed to start"
    assert len(raised) == 1 and isinstance(raised[0], SystemExit), raised
    assert raised[0].code and "ring long-form tier did not start" in str(raised[0].code)
    assert cause in str(raised[0].code)
    assert helpers and all(p.poll() is not None for p in helpers)


def test_seq_axis_in_training_does_what_the_jax_trainer_does(tmp_path, corpus):  # noqa: F811
    """One set of YAMLs for both packages' trainers (ROADMAP queue A item
    6c-i); the JAX trainer builds no sequence axis:

    * ``parallel.seq: 2`` (mesh [1, 1]): the JAX trainer's mesh is the
      (data, model) mesh of 1 x 1, and the port trains on one device (a
      step, dense attention);
    * with ``mesh: [1, 2]`` and a partition rule naming ``seq``: the same
      ValueError from both trainers' sharding, word for word;
    * ``model.attention_impl: ring``: the same ValueError from both
      trainers' ``build_model`` (a ring model needs a seq mesh)."""
    from speakingstyle_torch.models.factory import build_model, init_weights
    from speakingstyle_torch.parallel.mesh import Mesh
    from speakingstyle_torch.training.trainer import run_training, shard_model
    from speakingstyle_tpu.parallel.mesh import resolve_mesh as j_resolve_mesh
    from speakingstyle_tpu.training.trainer import run_training as j_run
    from test_torch_training import LIBRARY_MODEL, load_both

    def both(name, model=LIBRARY_MODEL, **parallel):
        (tmp_path / name).mkdir()
        return load_both(write_configs(tmp_path / name, corpus, model, step={"val_step": 1000},
                                       obs={"program_card": False}, parallel=parallel))

    def jax_run(jcfg):
        with jax.default_prng_impl("threefry2x32"):
            return j_run(dataclasses.replace(jcfg, train=dataclasses.replace(
                jcfg.train, fast_prng=False)), max_steps=1)

    jcfg, tcfg = both("seq", seq=2)
    mesh = j_resolve_mesh(jcfg.train.parallel)
    assert mesh.axis_names == ("data", "model") and mesh.devices.shape == (1, 1)
    assert run_training(tcfg, device="cpu", max_steps=1).step == 1
    jcfg, tcfg = both("seq_rule", mesh=[1, 2],
                      partition_rules=[["mel_linear/kernel$", "seq,none"]])
    with pytest.raises(ValueError) as want:
        jax_run(jcfg)
    with pytest.raises(ValueError) as got:  # the sharding step of a tp rank
        shard_model(init_weights(build_model(tcfg)), tcfg, Mesh(dp=1, tp=2))
    assert str(got.value) == str(want.value) and "Resource axis: seq" in str(got.value)
    jcfg, tcfg = both("ring", model=dict(LIBRARY_MODEL, attention_impl="ring"))
    with pytest.raises(ValueError) as want:
        jax_run(jcfg)
    with pytest.raises(ValueError) as got:
        run_training(tcfg, device="cpu", max_steps=1)
    assert str(got.value) == str(want.value) and "seq mesh" in str(got.value)


def test_a_serve_parallel_yaml_loads_in_both_packages(tmp_path):
    """A train.yaml holding only ``serve: {parallel: {mesh: [1, 1]}}`` (the
    JAX package's replica mesh) loads in both packages to the same
    ``ParallelConfig`` fields; the port validates it as the JAX package
    does."""
    import dataclasses

    import yaml

    from speakingstyle_torch.configs.config import load_config
    from speakingstyle_tpu.configs.config import load_config as j_load

    train = tmp_path / "train.yaml"
    train.write_text(yaml.safe_dump({"serve": {"parallel": {"mesh": [1, 1]}}}))
    got, want = load_config(train=str(train)).serve.parallel, j_load(train=str(train)).serve.parallel
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.is_single()
    train.write_text(yaml.safe_dump({"serve": {"parallel": {"mesh": [1, 2, 3]}}}))
    with pytest.raises(ValueError, match="mesh must be"):
        load_config(train=str(train))


def test_serve_and_replica_refuse_a_replica_mesh_naming_6c(tmp_path):
    """``serve.parallel.mesh: [1, 2]`` (one replica across devices) exits
    naming ROADMAP queue A item 6c in ``serve`` and ``replica``, before
    anything is loaded; ``[1, 1]`` passes that check."""
    import yaml

    from speakingstyle_torch.__main__ import main

    train = tmp_path / "train.yaml"
    train.write_text(yaml.safe_dump({"serve": {"parallel": {"mesh": [1, 2]}}}))
    with pytest.raises(SystemExit, match="queue A item 6c"):
        main(["serve", "-t", str(train), "--restore_step", "1", "--device", "cpu"])
    with pytest.raises(SystemExit, match="queue A item 6c"):
        main(["replica", "-t", str(train), "--restore_step", "1", "--replica_id", "r1",
              "--router", "127.0.0.1:9", "--device", "cpu"])
    train.write_text(yaml.safe_dump({"serve": {"parallel": {"mesh": [1, 1]}}}))
    with pytest.raises(FileNotFoundError):  # past the check: no checkpoint to restore
        main(["serve", "-t", str(train), "--restore_step", "1", "--device", "cpu"])


def test_serve_command_with_two_replicas_on_the_cpu(tmp_path, corpus):  # noqa: F811
    """``serve --replicas 2 --device cpu --enable_rollout`` over a saved
    checkpoint: it binds at once with /healthz answering 503 (each replica
    still warming, or not yet ready) until a replica is ready, then 200
    with both replicas' states and the model block; a /synthesize answers
    200 through the fleet; POST /admin/rollout to the same step commits
    over both replicas; SIGTERM drains and exits 0."""
    import http.client
    import signal
    import subprocess
    import sys
    import time

    paths, _ = seeded_checkpoint(tmp_path, corpus, 3)
    ref = _ref_wav(tmp_path / "ref.wav", seconds=0.3)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen(
        [sys.executable, "-m", "speakingstyle_torch", "serve", "-p", paths["preprocess"],
         "-m", paths["model"], "-t", paths["train"], "--restore_step", "3", "--device", "cpu",
         "--griffin_lim", "--ref_audio", ref, "--host", "127.0.0.1", "--port", "0",
         "--replicas", "2", "--enable_rollout"],
        cwd=repo, env=dict(os.environ, PYTHONPATH=repo, OMP_NUM_THREADS="1"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines = []
    try:
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("serving on http://"):
                break
        address = lines[-1].split("http://", 1)[1].split(" ", 1)[0]
        host, port = address.rsplit(":", 1)
        conn = http.client.HTTPConnection(host, int(port), timeout=120)
        statuses, deadline, health = [], time.monotonic() + 300, {}
        while time.monotonic() < deadline:
            conn.request("GET", "/healthz")
            resp = conn.getresponse()
            health = json.loads(resp.read())
            statuses.append(resp.status)
            if resp.status == 200 and set(health["replicas"].values()) == {"ready"}:
                break
            time.sleep(0.05)
        conn.request("POST", "/synthesize", body=json.dumps({"text": "hello world"}))
        resp = conn.getresponse()
        body = json.loads(resp.read())
        conn.request("POST", "/admin/rollout", body=json.dumps({"step": 3}))
        rolled = conn.getresponse()
        rollout = json.loads(rolled.read())
        conn.close()
        proc.send_signal(signal.SIGTERM)
        rest, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    out = "".join(lines) + rest
    assert proc.returncode == 0, out
    assert "warming 2 replicas" in out and "rollout enabled" in out
    assert statuses[-1] == 200 and health["replicas"] == {"0": "ready", "1": "ready"}
    assert health["model"]["step"] == 3
    assert resp.status == 200 and body["mel_len"] > 0
    assert resp.getheader("X-Model-Version").startswith("3:")
    assert rolled.status == 200 and rollout["status"] == "committed", rollout
    assert rollout["replicas"] == 2 and rollout["step"] == 3
    assert "SIGTERM: draining" in out and "server stopped" in out


@pytest.mark.parametrize("head_dim", [8, 12, 16, 24, 128, 136])
def test_attention_routes_head_dims_the_kernels_do_not_take(head_dim, monkeypatch):
    """ROADMAP queue C item 4: a head dim the kernels take (a multiple of 8
    up to 128) goes to the kernels on a non-CPU tensor; any other runs the
    plain versions with no launch, as the JAX package's ``fused_mha``
    sends shapes outside ``supported`` to ``_reference_mha``. Held here on
    meta tensors with the kernel wrappers replaced by recorders; on the
    CPU both routes give the JAX einsum path's numbers."""
    from speakingstyle_tpu.ops.pallas_attention import fused_mha as j_fused_mha
    from speakingstyle_torch.ops import fused_attention as t_attn

    calls = []

    def fwd(q, k, v, mask, scale, want_lse=False, softmax_dtype=torch.float32):
        calls.append("fwd")
        return torch.empty_like(q), torch.empty(q.shape[0], q.shape[2], q.shape[1],
                                                device=q.device)

    def bwd(q, k, v, mask, out, lse, dout, scale, softmax_dtype=torch.float32):
        calls.append("bwd")
        return torch.empty_like(q), torch.empty_like(q), torch.empty_like(q)

    monkeypatch.setattr(t_attn, "fused_mha_fwd", fwd)
    monkeypatch.setattr(t_attn, "fused_mha_bwd", bwd)
    takes = head_dim % 8 == 0 and head_dim <= 128
    assert t_attn.kernel_takes_head_dim(head_dim) == takes
    B, L, H = 2, 5, 2
    q = torch.empty((B, L, H, head_dim), device="meta", requires_grad=True)
    mask = torch.zeros((B, L), dtype=torch.bool, device="meta")
    out = t_attn._FusedMHA.apply(q, q, q, mask, 0.5, torch.float32, True)
    out.backward(torch.empty_like(out))
    assert calls == (["fwd", "bwd"] if takes else [])

    rng = np.random.default_rng(head_dim)
    qkv = [rng.standard_normal((B, L, H, head_dim)).astype(np.float32) for _ in range(3)]
    pad = np.zeros((B, L), bool)
    pad[1, 3:] = True
    got = t_attn.fused_mha(*(torch.from_numpy(a) for a in qkv), torch.from_numpy(pad))
    want = np.asarray(j_fused_mha(*(jnp.asarray(a) for a in qkv), jnp.asarray(pad)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
