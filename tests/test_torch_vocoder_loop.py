"""PyTorch port, vocoder training: the checkpoint files read both ways
(the port's and the JAX package's ``save_vocoder``, the generator sidecar
in both packages' ``get_vocoder``), the one tolerated layout drift, and the
loop's resilience drills on the CPU. Files are compared bit for bit.
"""

import json

import jax
import numpy as np
import pytest
import torch

from speakingstyle_torch.compat.from_jax import to_flax_tree

from test_torch_vocoder import (  # noqa: F401 (one_cpu_thread: an autouse fixture)
    NARROW, PERIODS, SEG, SMALL_GEN, SMALL_GEN_JSON, configs, flat, jax_tree, jax_vocoder,
    one_cpu_thread, port_vocoder, wav_dir,
)


# ---------------------------------------------------------------- checkpoints


def test_checkpoints_read_both_ways(tmp_path):
    """The port's vocoder_*.msgpack restores in JAX ``restore_vocoder`` and
    JAX ``save_vocoder``'s in the port, leaf for leaf; both files hold the
    same tree (keys, shapes, dtypes). The generator sidecar loads in both
    packages' ``get_vocoder``; the port's refuses either full-state file."""
    from speakingstyle_torch.compat.flax_msgpack import msgpack_restore
    from speakingstyle_torch.synthesis import get_vocoder as t_get
    from speakingstyle_torch.training.vocoder_trainer import (
        restore_vocoder as t_restore, save_vocoder as t_save, state_tree,
    )
    from speakingstyle_tpu.synthesis import get_vocoder as j_get
    from speakingstyle_tpu.training.vocoder_trainer import (
        restore_vocoder as j_restore, save_vocoder as j_save,
    )

    jcfg, tcfg = configs()
    j_state = jax_vocoder(state_tree(port_vocoder(3, NARROW, 1)))[0]
    j_path = str(tmp_path / "j" / "vocoder_00000000.msgpack")
    j_gen = j_save(j_path, j_state)
    t_state = t_restore(j_path, port_vocoder(4, NARROW, 1))
    want = flat(jax_tree(j_state))
    got = flat(state_tree(t_state))
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)

    # the port writes; JAX restores into another draw's template
    for p in t_state.gen.parameters():
        p.data.mul_(1.5)
    t_state.step = 7
    t_path = str(tmp_path / "t" / "vocoder_00000007.msgpack")
    t_gen = t_save(t_path, t_state)
    with open(t_path, "rb") as f:
        t_raw = msgpack_restore(f.read())
    with open(j_path, "rb") as f:
        j_raw = msgpack_restore(f.read())
    shape = lambda tree: {k: (v.shape, v.dtype.name) for k, v in flat(tree).items()}
    assert shape(t_raw) == shape(j_raw)
    assert t_raw["gen_opt"]["1"] == {} == j_raw["gen_opt"]["1"]
    restored = jax_tree(j_restore(t_path, jax_vocoder(state_tree(port_vocoder(5, NARROW, 1)))[0]))
    for k, v in flat(state_tree(t_state)).items():
        np.testing.assert_array_equal(flat(restored)[k], v, err_msg=k)
    assert int(restored["step"]) == 7

    config = tmp_path / "config.json"
    config.write_text(json.dumps(SMALL_GEN_JSON))
    for gen_file, want in ((t_gen, to_flax_tree(t_state.gen)["params"]),
                           (j_gen, jax.device_get(j_state.gen_params))):
        got = to_flax_tree(t_get(tcfg, gen_file, config_path=str(config)))["params"]
        for k, v in flat(want).items():
            np.testing.assert_array_equal(flat(got)[k], v, err_msg=k)
    got = flat(jax.device_get(j_get(jcfg, t_gen, config_path=str(config))[1]))
    for k, v in flat(to_flax_tree(t_state.gen)["params"]).items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    for full in (t_path, j_path):
        with pytest.raises(ValueError, match="generator.msgpack"):
            t_get(tcfg, full, config_path=str(config))


def test_restore_tolerates_only_a_pre_r4_checkpoint(tmp_path, capsys):
    """A checkpoint without ``msd_stats`` (before the MSD's spectral norm)
    whose first scale's params differ keeps msd_stats, msd_params and
    disc_opt fresh, naming them; every other field restores. Any other
    mismatch raises, naming the field."""
    from speakingstyle_torch.compat.flax_msgpack import to_bytes
    from speakingstyle_torch.training.vocoder_trainer import restore_vocoder, state_tree

    src = port_vocoder(6, NARROW, 1)
    src.step = 3
    tree = state_tree(src)
    del tree["msd_stats"]
    # its first scale's params (and their moments) had another layout
    old_kernel = np.zeros((3, 1, 1), np.float32)
    tree["msd_params"]["discriminators_0"]["convs_0"]["kernel"] = old_kernel
    for moment in ("mu", "nu"):
        tree["disc_opt"]["0"][moment]["msd"]["discriminators_0"]["convs_0"]["kernel"] = old_kernel
    path = tmp_path / "pre_r4.msgpack"
    path.write_bytes(to_bytes(tree))
    dst = port_vocoder(7, NARROW, 1)
    fresh = {k: v.clone() for k, v in dst.msd.state_dict().items()}
    fresh_mu = [m.clone() for m in dst.disc_opt.mu]
    restore_vocoder(str(path), dst)
    out = capsys.readouterr().out
    assert "kept fresh: ['msd_params', 'msd_stats', 'disc_opt']" in out
    assert dst.step == 3
    assert all(torch.equal(v, dst.msd.state_dict()[k]) for k, v in fresh.items())
    assert all(torch.equal(a, b) for a, b in zip(fresh_mu, dst.disc_opt.mu))
    for a, b in zip(src.gen.parameters(), dst.gen.parameters()):
        assert torch.equal(a, b)

    tree = state_tree(src)
    del tree["gen_params"]["conv_pre"]
    path.write_bytes(to_bytes(tree))
    with pytest.raises(ValueError, match="field 'gen_params'.*msd_stats present"):
        restore_vocoder(str(path), port_vocoder(7, NARROW, 1))


# ---------------------------------------------------------------- the loop


def loop_kwargs(tmp_path, wav_dir, **kw):
    from speakingstyle_torch.models.hifigan import Generator
    from speakingstyle_torch.models.hifigan_disc import (
        MultiPeriodDiscriminator, MultiScaleDiscriminator,
    )
    from speakingstyle_torch.training.vocoder_trainer import VocoderHParams

    return dict(hp=VocoderHParams(segment_size=SEG), batch_size=2,
                ckpt_path=str(tmp_path / "ckpt"), log_every=1, seed=1,
                gen=Generator(**SMALL_GEN), mpd=MultiPeriodDiscriminator(PERIODS, NARROW),
                msd=MultiScaleDiscriminator(n_scales=1), device="cpu", **kw)


def test_train_vocoder_rollback_sigterm_and_resume(tmp_path, wav_dir, monkeypatch, capsys):
    """``nan_grads@2`` with no checkpoint yet rolls back to the initial state
    once and the run still ends at its last step; ``sigterm@2`` flushes a
    step-2 checkpoint and returns; a resume from it continues to step 3."""
    from speakingstyle_torch.data.mel_dataset import scan_wavs
    from speakingstyle_torch.training.vocoder_trainer import train_vocoder

    _, tcfg = configs()
    wavs = scan_wavs(str(wav_dir))
    monkeypatch.setenv("SPEAKINGSTYLE_FAULTS", "nan_grads@2")
    state, metrics = train_vocoder(tcfg, wavs, max_steps=3,
                                   **loop_kwargs(tmp_path / "nan", wav_dir))
    out = capsys.readouterr().out
    assert "non-finite metrics at step 2; rollback 1/3 to fresh init" in out
    assert state.step == 3 and all(np.isfinite(float(v)) for v in metrics.values())
    assert sorted(p.name for p in (tmp_path / "nan" / "ckpt").iterdir()) == [
        "vocoder_00000003.msgpack", "vocoder_00000003.msgpack.generator.msgpack"]

    monkeypatch.setenv("SPEAKINGSTYLE_FAULTS", "sigterm@2")
    state, _ = train_vocoder(tcfg, wavs, max_steps=3, **loop_kwargs(tmp_path / "sig", wav_dir))
    out = capsys.readouterr().out
    assert state.step == 2 and "SIGTERM: checkpoint flushed at step 2" in out
    ckpt = tmp_path / "sig" / "ckpt" / "vocoder_00000002.msgpack"
    assert ckpt.exists()
    monkeypatch.delenv("SPEAKINGSTYLE_FAULTS")
    resumed, _ = train_vocoder(tcfg, wavs, max_steps=3, restore_path=str(ckpt),
                               **loop_kwargs(tmp_path / "sig", wav_dir))
    out = capsys.readouterr().out
    assert "restored step 2" in out and "[vocoder] step 3:" in out and resumed.step == 3
    assert (tmp_path / "sig" / "ckpt" / "vocoder_00000003.msgpack").exists()
