"""PyTorch port, vocoder training: each piece against its JAX twin on the
same seeded inputs and the same weights (carried across by
``compat/from_jax``), and one whole GAN step, on the CPU at the JAX tests'
small sizes (the checkpoint files and the loop: test_torch_vocoder_loop.py).

Tolerances (float32, the two packages' convs summing in other orders):
discriminator scores, feature maps, losses and the mel 1e-5 relative to
the tensor's max (2e-5 absolute for the mel); the spectral-norm state 1e-5;
gradients 1e-4 of their max; the optimizer 1e-6; the whole GAN step's
metrics 1e-5 relative, its updated parameters 1e-6 absolute (the first
Adam step moves every element by about lr = 2e-4) and its spectral-norm
state 1e-5. The datasets are compared exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization
from scipy.io import wavfile

from speakingstyle_torch.compat.from_jax import load_flax_variables, to_flax_tree
from speakingstyle_torch.models.factory import init_weights
from speakingstyle_torch.models.hifigan_disc import init_spectral_stats

from torch_threads import one_cpu_thread  # noqa: F401 (an autouse fixture)

SEG = 1024
# the JAX tests' small generator: upsample product 256 (the hop), 32 channels
SMALL_GEN = dict(upsample_rates=(8, 8, 2, 2), upsample_kernel_sizes=(16, 16, 4, 4),
                 upsample_initial_channel=32)
SMALL_GEN_JSON = dict(SMALL_GEN, resblock="1", resblock_kernel_sizes=(3, 7, 11),
                      resblock_dilation_sizes=((1, 3, 5), (1, 3, 5), (1, 3, 5)))
PERIODS = (2, 3)
NARROW = (8, 16, 32, 32, 32)  # MPD channels of the loop tests


def rel_close(got, want, rtol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max() / scale
    assert err <= rtol, f"{what}: {err} of max {scale}"


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


def configs():
    from speakingstyle_torch.configs.config import Config as TC
    from speakingstyle_tpu.configs.config import Config as JC

    return JC(), TC()


def wave(rng, B, T=SEG, scale=0.3):
    return np.clip(rng.standard_normal((B, T)) * scale, -1, 1).astype(np.float32)


# ---------------------------------------------------------------- discriminators


def to_nchw(f):
    f = np.asarray(f)
    return f.transpose(0, 3, 1, 2) if f.ndim == 4 else f.transpose(0, 2, 1)


@pytest.mark.parametrize("channels", [None, NARROW])
def test_period_discriminators_match_flax(channels):
    """MPD scores and every feature map (the JAX package's NHWC maps
    transposed), over a length that is not a multiple of 3 (reflect pad);
    the narrow channels through the period discriminator itself."""
    from speakingstyle_torch.models.hifigan_disc import MultiPeriodDiscriminator as TM
    from speakingstyle_torch.models.hifigan_disc import PeriodDiscriminator as TP
    from speakingstyle_tpu.models.hifigan_disc import MultiPeriodDiscriminator as JM
    from speakingstyle_tpu.models.hifigan_disc import PeriodDiscriminator as JP

    rng = np.random.default_rng(0)
    y, y_hat = wave(rng, 2, SEG + 1), wave(rng, 2, SEG + 1)
    if channels is None:
        jm, tm = JM(periods=PERIODS), init_weights(TM(periods=PERIODS), 0)
        j_out = jm.apply(to_flax_tree(tm), y, y_hat)
        t_out = tm(torch.from_numpy(y), torch.from_numpy(y_hat))
    else:
        jm, tm = JP(3, channels=channels), init_weights(TP(3, channels=channels), 0)
        (jo, jf), (to, tf) = jm.apply(to_flax_tree(tm), y), tm(torch.from_numpy(y))
        j_out, t_out = ([jo], [jf]), ([to], [tf])
    for j_list, t_list in zip(j_out, t_out):
        for j, t in zip(j_list, t_list):
            if isinstance(j, list):
                assert len(j) == len(t) == 6
                for jj, tt in zip(j, t):
                    rel_close(tt.detach(), to_nchw(jj), 1e-5, "fmap")
            else:
                rel_close(t.detach(), j, 1e-5, "scores")


def test_scale_discriminators_and_spectral_state_match_flax():
    """MSD (2 scales, the first spectral-normalised) with update_stats:
    scores, every feature map, and u / sigma after the apply (two
    sequential power iterations: the y pass, then the y_hat pass)."""
    from speakingstyle_torch.models.hifigan_disc import MultiScaleDiscriminator as TM
    from speakingstyle_tpu.models.hifigan_disc import MultiScaleDiscriminator as JM

    rng = np.random.default_rng(1)
    y, y_hat = wave(rng, 2), wave(rng, 2)
    jm, tm = JM(n_scales=2), init_spectral_stats(init_weights(TM(n_scales=2), 1), 1)
    variables = to_flax_tree(tm)
    j_out, upd = jax.jit(lambda v: jm.apply(v, y, y_hat, update_stats=True,
                                           mutable=["batch_stats"]))(variables)
    t_out = tm(torch.from_numpy(y), torch.from_numpy(y_hat), update_stats=True)
    for j_list, t_list in zip(j_out, t_out):
        for j, t in zip(j_list, t_list):
            if isinstance(j, list):
                assert len(j) == len(t) == 8
                for jj, tt in zip(j, t):
                    rel_close(tt.detach(), to_nchw(jj), 1e-5, "fmap")
            else:
                rel_close(t.detach(), j, 1e-5, "scores")
    want = flat(upd["batch_stats"])
    got = flat(to_flax_tree(tm)["batch_stats"])
    assert got.keys() == want.keys() and len(want) == 16
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6, err_msg=k)
    # and the stats moved: the apply stored a new u
    before = flat(variables["batch_stats"])
    assert all(not np.array_equal(before[k], want[k]) for k in want if k.endswith("/u"))


def test_spectral_norm_one_and_two_calls_and_its_gradient():
    """One spectral-normalised scale: u and sigma after one call and after
    a second call from the stored u; without update_stats the state stays
    but the power iteration still runs (the output moves with u); and the
    gradient through sigma, against Flax."""
    from speakingstyle_torch.models.hifigan_disc import ScaleDiscriminator as TS
    from speakingstyle_tpu.models.hifigan_disc import ScaleDiscriminator as JS

    rng = np.random.default_rng(2)
    x = wave(rng, 2, 512)
    jd = JS(use_spectral_norm=True)
    td = init_spectral_stats(init_weights(TS(use_spectral_norm=True), 2), 2)
    variables = to_flax_tree(td)
    stats = variables["batch_stats"]
    apply = jax.jit(lambda v: jd.apply(v, x, update_stats=True, mutable=["batch_stats"]))
    for call in range(2):
        (jo, _), upd = apply({"params": variables["params"], "batch_stats": stats})
        to, _ = td(torch.from_numpy(x), update_stats=True)
        rel_close(to.detach(), jo, 1e-5, f"scores call {call}")
        stats = jax.device_get(upd["batch_stats"])
        got = flat(to_flax_tree(td)["batch_stats"])
        for k, v in flat(stats).items():
            np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-6,
                                       err_msg=f"call {call} {k}")
    frozen = {k: v.clone() for k, v in td.state_dict().items() if "SpectralNorm" in k}
    to, _ = td(torch.from_numpy(x), update_stats=False)
    jo, _ = jd.apply({"params": variables["params"], "batch_stats": stats}, x)
    rel_close(to.detach(), jo, 1e-5, "scores without update_stats")
    assert all(torch.equal(v, td.state_dict()[k]) for k, v in frozen.items())

    def j_loss(params):
        out, _ = jd.apply({"params": params, "batch_stats": stats}, x, update_stats=True,
                          mutable=["batch_stats"])
        return jnp.sum(out[0] ** 2)

    j_grads = flat(jax.jit(jax.grad(j_loss))(variables["params"]))
    load_flax_variables(td, {"params": variables["params"], "batch_stats": stats})
    out, _ = td(torch.from_numpy(x), update_stats=True)
    params = list(td.parameters())
    grads = torch.autograd.grad(torch.sum(out ** 2), params)
    t_grads = flat(to_flax_tree(td, dict(zip(map(id, params), grads)))["params"])
    assert t_grads.keys() == j_grads.keys()
    for k, v in j_grads.items():
        rel_close(t_grads[k], v, 1e-4, f"grad {k}")


def test_avg_pool_and_losses_match_jax():
    from speakingstyle_torch.models import hifigan_disc as T
    from speakingstyle_tpu.models import hifigan_disc as J

    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 67)).astype(np.float32)
    np.testing.assert_allclose(T._avg_pool1d(torch.from_numpy(x)).numpy(),
                               np.asarray(J._avg_pool1d(jnp.asarray(x))), atol=1e-6)
    outs_r = [rng.standard_normal((2, n)).astype(np.float32) for n in (5, 9)]
    outs_g = [rng.standard_normal((2, n)).astype(np.float32) for n in (5, 9)]
    fr = [[rng.standard_normal((2, 3, 7)).astype(np.float32) for _ in range(2)]] * 2
    fg = [[rng.standard_normal((2, 3, 7)).astype(np.float32) for _ in range(2)]] * 2
    tt = lambda xs: [torch.from_numpy(a) if isinstance(a, np.ndarray) else tt(a) for a in xs]
    for name, args in (("discriminator_loss", (outs_r, outs_g)),
                       ("generator_adversarial_loss", (outs_g,)),
                       ("feature_matching_loss", (fr, fg))):
        got = float(getattr(T, name)(*map(tt, args)))
        want = float(getattr(J, name)(*args))
        assert got == pytest.approx(want, rel=1e-6), name


# ---------------------------------------------------------------- the mel, the data


@pytest.mark.parametrize("valid", [SEG, 300])
def test_differentiable_mel_value_and_gradient_match_jax(valid):
    """The log-mel of a segment (and of a short one zero-padded to SEG)
    and the gradient of an L1 loss on it, against the JAX package's."""
    from speakingstyle_torch.training.vocoder_trainer import differentiable_mel as t_mel
    from speakingstyle_tpu.training.vocoder_trainer import differentiable_mel as j_mel

    jcfg, tcfg = configs()
    rng = np.random.default_rng(4)
    wav = wave(rng, 2)
    wav[:, valid:] = 0.0
    target = rng.standard_normal((2, SEG // 256 + 1, 80)).astype(np.float32)
    jf, tf = j_mel(jcfg), t_mel(tcfg)
    j_loss = lambda w: jnp.mean(jnp.abs(jf(w) - target))
    j_val, j_grad = np.asarray(jf(wav)), np.asarray(jax.jit(jax.grad(j_loss))(wav))
    w = torch.from_numpy(wav).requires_grad_(True)
    t_val = tf(w)
    (t_grad,) = torch.autograd.grad(torch.mean(torch.abs(t_val - torch.from_numpy(target))), w)
    assert t_val.shape == j_val.shape == (2, SEG // 256 + 1, 80)
    np.testing.assert_allclose(t_val.detach().numpy(), j_val, atol=2e-5)
    rel_close(t_grad, j_grad, 1e-4, "mel gradient")


@pytest.fixture(scope="module")
def wav_dir(tmp_path_factory):
    """Six int16 wavs of unequal lengths (one shorter than SEG) and, for the
    fine-tune mode, predicted-mel files named as the preprocessor names
    them ("<speaker>-mel-<base>.npy"), one longer and one shorter than
    the segment's frames."""
    root = tmp_path_factory.mktemp("vocoder_wavs")
    rng = np.random.default_rng(5)
    mel_dir = root / "mels"
    mel_dir.mkdir()
    for i, n in enumerate((3000, 6000, 2500, 9000, 4100, 5200)):
        t = np.arange(n) / 22050.0
        w = 0.4 * np.sin(2 * np.pi * (150 + 40 * i) * t) + 0.05 * rng.standard_normal(n)
        wavfile.write(root / f"u{i}.wav", 22050, (w * 20000).astype(np.int16))
        frames = n // 256 + 1
        np.save(mel_dir / f"LJ-mel-u{i}.npy",
                rng.standard_normal((frames, 80)).astype(np.float32))
    return root


@pytest.mark.parametrize("fine_tune", [False, True])
def test_mel_wav_dataset_batches_equal_jax(wav_dir, fine_tune):
    """Two epochs of batches from one seed, equal to the JAX package's
    (the shuffle, then one crop per item, from the same generator)."""
    from speakingstyle_torch.data.mel_dataset import MelWavDataset as TD, scan_wavs as t_scan
    from speakingstyle_tpu.data.mel_dataset import MelWavDataset as JD, scan_wavs as j_scan

    jcfg, tcfg = configs()
    paths = t_scan(str(wav_dir))
    assert paths == j_scan(str(wav_dir)) and len(paths) == 6
    mels = str(wav_dir / "mels") if fine_tune else None
    kw = dict(segment_size=SEG, batch_size=2, fine_tune_mel_dir=mels, seed=11)
    jd, td = iter(JD(paths, jcfg, **kw)), iter(TD(paths, tcfg, **kw))
    for _ in range(6):
        (jw, jm), (tw, tm) = next(jd), next(td)
        assert tw.shape == (2, SEG) and tm.shape == (2, SEG // 256, 80)
        np.testing.assert_array_equal(tw, jw)
        np.testing.assert_array_equal(tm, jm)


def test_numpy_mel_energy_equals_the_preprocessors():
    from speakingstyle_torch.audio.mel import mel_filterbank
    from speakingstyle_torch.audio.stft import hann_window
    from speakingstyle_torch.data.mel_dataset import _numpy_mel_energy as t_fn
    from speakingstyle_tpu.data.preprocessor import _numpy_mel_energy as j_fn

    wav = wave(np.random.default_rng(6), 1, 5000)[0] * 4
    fb, win = mel_filterbank(22050, 1024, 80, 0.0, 8000.0), hann_window(1024, 1024)
    for a, b in zip(t_fn(wav, fb, win, 1024, 256), j_fn(wav, fb, win, 1024, 256)):
        np.testing.assert_array_equal(a, b)


def test_dynamic_range_compression_matches_jax():
    from speakingstyle_torch.audio import stft as T
    from speakingstyle_tpu.audio import stft as J

    x = np.abs(np.random.default_rng(7).standard_normal(50)).astype(np.float32)
    x[:5] = 0.0
    np.testing.assert_allclose(T.dynamic_range_compression(torch.from_numpy(x)).numpy(),
                               np.asarray(J.dynamic_range_compression(jnp.asarray(x))),
                               atol=1e-6)
    np.testing.assert_allclose(T.dynamic_range_decompression(torch.from_numpy(x)).numpy(),
                               np.asarray(J.dynamic_range_decompression(jnp.asarray(x))),
                               rtol=1e-6)


# ---------------------------------------------------------------- the optimizer


def test_adamw_and_staircase_schedule_match_optax_across_the_decay_boundary():
    """lr 2e-4 * 0.999^floor(count / 1000) and the AdamW update (decay of
    the pre-update parameters) against optax.adamw, over updates 998-1002."""
    from speakingstyle_torch.training.vocoder_trainer import (
        AdamW, VocoderHParams, exponential_decay,
    )

    hp = VocoderHParams()
    sched = exponential_decay(hp)
    o_sched = optax.exponential_decay(hp.learning_rate, hp.lr_decay_steps, hp.lr_decay,
                                      staircase=True)
    for count in (0, 1, 999, 1000, 1001, 1999, 2000, 123456):
        assert sched(count) == pytest.approx(float(o_sched(count)), rel=1e-7), count
    rng = np.random.default_rng(8)
    params = {"a": rng.standard_normal((3, 4)).astype(np.float32),
              "b": rng.standard_normal(5).astype(np.float32)}
    tx = optax.adamw(o_sched, b1=hp.adam_b1, b2=hp.adam_b2, weight_decay=0.01)
    state = tx.init(params)
    start = 998
    state = (state[0]._replace(count=jnp.asarray(start, jnp.int32)), state[1],
             state[2]._replace(count=jnp.asarray(start, jnp.int32)))
    tp = [torch.from_numpy(params[k].copy()) for k in ("a", "b")]
    opt = AdamW(tp, sched, hp.adam_b1, hp.adam_b2)
    opt.count = start
    j_params = params
    for _ in range(4):
        grads = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in params.items()}
        updates, state = tx.update(grads, state, j_params)
        j_params = optax.apply_updates(j_params, updates)
        opt.update([torch.from_numpy(grads[k]) for k in ("a", "b")])
        for t, k in zip(tp, ("a", "b")):
            np.testing.assert_allclose(t.numpy(), np.asarray(j_params[k]), atol=1e-6, rtol=1e-6)
    assert opt.count == int(state[0].count) == int(state[2].count) == start + 4


# ---------------------------------------------------------------- the GAN step


def jax_vocoder(tree):
    """The JAX package's VocoderState holding ``tree`` (a state dict the
    port wrote: weights, spectral-norm state and optimizer states), its
    modules and its two optax transforms, as its ``init_vocoder_state``
    builds them (the JAX draw is left out: its eager init takes ~50 s on
    the CPU)."""
    from speakingstyle_tpu.models.hifigan import Generator
    from speakingstyle_tpu.models.hifigan_disc import (
        MultiPeriodDiscriminator, MultiScaleDiscriminator,
    )
    from speakingstyle_tpu.training.vocoder_trainer import VocoderHParams, VocoderState

    hp = VocoderHParams(segment_size=SEG)
    schedule = optax.exponential_decay(hp.learning_rate, hp.lr_decay_steps, hp.lr_decay,
                                       staircase=True)
    gen_tx, disc_tx = (optax.adamw(schedule, b1=hp.adam_b1, b2=hp.adam_b2, weight_decay=0.01)
                       for _ in range(2))
    template = VocoderState(
        step=jnp.zeros((), jnp.int32), gen_params=tree["gen_params"],
        mpd_params=tree["mpd_params"], msd_params=tree["msd_params"],
        msd_stats=tree["msd_stats"], gen_opt=gen_tx.init(tree["gen_params"]),
        disc_opt=disc_tx.init({"mpd": tree["mpd_params"], "msd": tree["msd_params"]}))
    state = serialization.from_state_dict(template, tree)
    return (state, Generator(**SMALL_GEN), MultiPeriodDiscriminator(periods=PERIODS),
            MultiScaleDiscriminator(n_scales=2), gen_tx, disc_tx)


def port_vocoder(seed=0, mpd_channels=None, n_scales=2):
    from speakingstyle_torch.models.hifigan import Generator
    from speakingstyle_torch.models.hifigan_disc import (
        PERIOD_CHANNELS, MultiPeriodDiscriminator, MultiScaleDiscriminator,
    )
    from speakingstyle_torch.training.vocoder_trainer import VocoderHParams, init_vocoder_state

    _, tcfg = configs()
    return init_vocoder_state(tcfg, VocoderHParams(segment_size=SEG), seed,
                              gen=Generator(**SMALL_GEN),
                              mpd=MultiPeriodDiscriminator(PERIODS,
                                                           mpd_channels or PERIOD_CHANNELS),
                              msd=MultiScaleDiscriminator(n_scales=n_scales), device="cpu")


def jax_tree(state):
    return jax.device_get(serialization.to_state_dict(state))


def test_one_gan_step_matches_jax():
    """One whole GAN step from the same weights and batch: the metrics,
    the updated parameters of all three nets, the optimizer moments and
    counts, and the spectral-norm state after its four sequential updates."""
    from speakingstyle_torch.training.vocoder_trainer import (
        make_vocoder_train_step as t_make, state_tree,
    )
    from speakingstyle_tpu.training.vocoder_trainer import (
        VocoderHParams, make_vocoder_train_step as j_make,
    )

    jcfg, tcfg = configs()
    hp = VocoderHParams(segment_size=SEG)
    t_state = port_vocoder(seed=9)
    j_state, gen, mpd, msd, gen_tx, disc_tx = jax_vocoder(state_tree(t_state))
    before = jax_tree(j_state)
    rng = np.random.default_rng(10)
    wavs = wave(rng, 2)
    mels = rng.standard_normal((2, SEG // 256, 80)).astype(np.float32) - 4.0
    j_step = j_make(jcfg, hp, gen, mpd, msd, gen_tx, disc_tx)
    j_state, j_metrics = j_step(j_state, jnp.asarray(wavs), jnp.asarray(mels))
    t_metrics = t_make(tcfg, hp)(t_state, torch.from_numpy(wavs), torch.from_numpy(mels))
    assert_gan_step_matches(t_metrics, state_tree(t_state), j_metrics, jax_tree(j_state),
                            before, hp)


def assert_gan_step_matches(t_metrics, t_tree, j_metrics, j_tree, before, hp):
    """One GAN step's metrics and state (``t_*`` the port's, ``j_*`` the
    JAX package's, both from ``before``) at this module's tolerances."""
    for k, v in j_metrics.items():
        assert float(t_metrics[k]) == pytest.approx(float(v), rel=1e-5), k
    want, got = flat(j_tree), flat(t_tree)
    assert got.keys() == want.keys()
    b = flat(before)
    moved = 0
    for k, w in want.items():
        g = got[k]
        assert g.dtype == w.dtype, k
        if "/count" in k or k == "/step":
            assert int(g) == int(w) == 1, k
        elif "msd_stats" in k:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6, err_msg=k)
        elif "/nu/" in k:  # (1 - b2) g^2
            rel_close(g, w, 1e-4, k)
        elif "/mu/" in k:  # (1 - b1) g
            rel_close(g, w, 1e-4, k)
        else:
            # Adam's first step is lr g / (|g| + eps): an error dg in the
            # gradient (held to 1e-4 of the leaf's max above, through mu)
            # moves it by at most lr dg / (|g| + eps), which is large only
            # where |g| is at rounding level
            mu_key = k.replace("/gen_params/", "/gen_opt/0/mu/").replace(
                "/mpd_params/", "/disc_opt/0/mu/mpd/").replace(
                "/msd_params/", "/disc_opt/0/mu/msd/")
            grad = np.abs(got[mu_key]) / (1 - hp.adam_b1)
            allowed = 1e-6 + hp.learning_rate * 1e-4 * grad.max() / (grad + 1e-8)
            assert (np.abs(g - w) <= allowed).all(), k
            moved += int(np.abs(w - b[k]).max() > 1e-4)
    assert moved > 50  # the parameters moved (by about lr each)
