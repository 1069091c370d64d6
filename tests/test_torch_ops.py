"""PyTorch port, ops layer: each op of speakingstyle_torch/ops against its
JAX counterpart on identical numpy inputs.

The two kernels' plain versions (the path a CPU tensor takes) are held
against the JAX package's Pallas kernels in interpret mode at atol 1e-5;
tests/test_torch_kernels.py holds the hand-written kernels against those
plain versions on the card.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speakingstyle_torch.ops import fused_attention as t_attn
from speakingstyle_torch.ops import fused_conv as t_conv

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _lengths_mask(rng, B, L):
    lens = rng.integers(L // 2, L + 1, B)
    lens[0] = L
    return np.arange(L)[None] >= lens[:, None]


# ---------------------------------------------------------------- kernel plain versions


@pytest.mark.parametrize("L", [23, 130])
@pytest.mark.parametrize("D", [8, 16, 32])
def test_plain_attention_matches_pallas_interpret(L, D):
    """fused_mha on CPU tensors (the plain version) == the JAX fused-MHA
    Pallas kernel in interpret mode, with unequal key lengths; 130 crosses
    the JAX kernel's 128-lane padding."""
    from speakingstyle_tpu.ops.pallas_attention import fused_mha

    rng = np.random.default_rng(L * 100 + D)
    B, H = 2, 2
    q, k, v = (rng.standard_normal((B, L, H, D)).astype(np.float32) for _ in range(3))
    mask = _lengths_mask(rng, B, L)

    want = fused_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     jnp.asarray(mask), interpret=True)
    before = t_attn.fused_mha.launches
    got = t_attn.fused_mha(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), torch.from_numpy(mask))
    assert t_attn.fused_mha.launches == before  # CPU tensors never launch
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("K", [1, 3, 9])
@pytest.mark.parametrize("dilation", [1, 2])
@pytest.mark.parametrize("ln", [False, True])
def test_plain_conv_matches_pallas_interpret(K, dilation, ln):
    """fused_conv1d / fused_conv_relu_ln on CPU tensors == the JAX fused
    conv Pallas kernel in interpret mode. The LN cases use Cout = 128, the
    JAX kernel's lane width, so the interpreted kernel (not its reference
    fallback) is what runs."""
    from speakingstyle_tpu.ops.pallas_conv import fused_conv1d, fused_conv_relu_ln

    rng = np.random.default_rng(K * 10 + dilation + 100 * ln)
    cin, cout = 8, (128 if ln else 12)
    x = rng.standard_normal((2, 23, cin)).astype(np.float32)
    w = (rng.standard_normal((K, cin, cout)) * 0.2).astype(np.float32)
    b = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    s = rng.standard_normal(cout).astype(np.float32)
    sb = rng.standard_normal(cout).astype(np.float32)
    tx, tw, tb, ts, tsb = (torch.from_numpy(a) for a in (x, w, b, s, sb))
    before = t_conv.fused_conv1d.launches
    if ln:
        want = fused_conv_relu_ln(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                  jnp.asarray(s), jnp.asarray(sb),
                                  dilation=dilation, interpret=True)
        got = t_conv.fused_conv_relu_ln(tx, tw, tb, ts, tsb, dilation=dilation)
    else:
        want = fused_conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                            dilation=dilation, relu=True, interpret=True)
        got = t_conv.fused_conv1d(tx, tw, tb, dilation=dilation, relu=True)
    assert t_conv.fused_conv1d.launches == before
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_plain_conv_without_relu_or_bias_matches_lax_conv():
    """The no-ReLU, no-bias form against lax.conv SAME padding (odd and
    even spans)."""
    import jax

    rng = np.random.default_rng(3)
    for K, dil in ((4, 1), (5, 3)):
        x = rng.standard_normal((2, 17, 6)).astype(np.float32)
        w = (rng.standard_normal((K, 6, 5)) * 0.3).astype(np.float32)
        want = jax.lax.conv_general_dilated(
            jnp.asarray(x), jnp.asarray(w), (1,), "SAME", rhs_dilation=(dil,),
            dimension_numbers=("NWC", "WIO", "NWC"),
        )
        got = t_conv.fused_conv1d(torch.from_numpy(x), torch.from_numpy(w), dilation=dil)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_plain_versions_round_like_the_kernels_in_bf16():
    """bf16 plain versions: attention rounds P to bf16 and accumulates in
    f32; the conv's LN stats see the bf16-rounded activation. Both equal an
    explicit f32 restatement of that arithmetic."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 9, 2, 8)).astype(np.float32))
               .to(torch.bfloat16) for _ in range(3))
    mask = torch.from_numpy(_lengths_mask(rng, 2, 9))
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (1.0 / np.sqrt(8))
    s = s + torch.where(mask, torch.finfo(torch.float32).min / 2, 0.0)[:, None, None]
    p = torch.softmax(s, -1).to(torch.bfloat16).float()
    want = torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(torch.bfloat16)
    assert torch.equal(t_attn.fused_mha(q, k, v, mask), want)

    x = torch.from_numpy(rng.standard_normal((2, 11, 8)).astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy(rng.standard_normal((3, 8, 16)).astype(np.float32) * 0.3).to(torch.bfloat16)
    one, zero = torch.ones(16, dtype=torch.bfloat16), torch.zeros(16, dtype=torch.bfloat16)
    got = t_conv.fused_conv_relu_ln(x, w, zero, one, zero)
    act = torch.relu(t_conv.conv1d_unfold(x.float(), w.float())).to(torch.bfloat16).float()
    norm = torch.nn.functional.layer_norm(act, (16,), eps=1e-5).to(torch.bfloat16)
    torch.testing.assert_close(got, norm, atol=1e-2, rtol=0)


# ---------------------------------------------------------------- plain ops


def test_masks_and_position_table_match_jax():
    from speakingstyle_tpu.ops import masking as j_mask
    from speakingstyle_tpu.ops.positional import sinusoid_position_table as j_table
    from speakingstyle_torch.ops import masking as t_mask
    from speakingstyle_torch.ops.positional import sinusoid_position_table as t_table

    lens = np.array([0, 3, 7], np.int32)
    j = np.asarray(j_mask.length_to_mask(jnp.asarray(lens), 7))
    t = t_mask.length_to_mask(torch.from_numpy(lens), 7)
    np.testing.assert_array_equal(t.numpy(), j)
    np.testing.assert_array_equal(
        t_mask.attention_bias(t).numpy(), np.asarray(j_mask.attention_bias(jnp.asarray(j)))
    )
    np.testing.assert_array_equal(t_table(11, 6), j_table(11, 6))


def test_length_regulator_and_durations_match_jax():
    """Gather expansion with the max_mel_len clamp, and free-run durations
    that round half to even BEFORE the d_control scale."""
    from speakingstyle_tpu.ops import length_regulator as j_lr
    from speakingstyle_torch.ops import length_regulator as t_lr

    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3)).astype(np.float32)
    d = np.array([[2, 0, 3, 1, 4], [1, 1, 0, 0, 0]], np.int32)
    for max_len in (6, 12):
        jf, jl, jm = j_lr.length_regulate(jnp.asarray(x), jnp.asarray(d), max_len)
        tf, tl, tm = t_lr.length_regulate(torch.from_numpy(x), torch.from_numpy(d), max_len)
        np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))

    # exp(logd) - 1 lands exactly on .5 and 2.5: half-to-even gives 0 and 2
    logd = np.log(np.array([[1.5, 3.5, 2.2, 5.0, 1.0]], np.float32))
    pad = np.array([[False, False, False, False, True]])
    for ctl in (1.0, 1.7, np.array([[2.0, 1.0, 0.5, 3.0, 1.0]], np.float32)):
        jd = j_lr.predicted_durations(jnp.asarray(logd), jnp.asarray(pad), ctl)
        td = t_lr.predicted_durations(
            torch.from_numpy(logd), torch.from_numpy(pad),
            torch.from_numpy(ctl) if isinstance(ctl, np.ndarray) else ctl,
        )
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


def test_bucketize_matches_jax_searchsorted_left():
    from speakingstyle_tpu.ops import quantize as j_q
    from speakingstyle_torch.ops import quantize as t_q

    bins = t_q.make_bins(-2.0, 8.0, 16, "linear")
    np.testing.assert_array_equal(bins, j_q.make_bins(-2.0, 8.0, 16, "linear"))
    vals = np.concatenate([bins, bins + 1e-3, [-5.0, 20.0]]).astype(np.float32)
    np.testing.assert_array_equal(
        t_q.bucketize(torch.from_numpy(vals), torch.from_numpy(bins)).numpy(),
        np.asarray(j_q.bucketize(jnp.asarray(vals), bins)),
    )


@pytest.mark.parametrize("impl", ["xla", "unfold", "pallas"])
@pytest.mark.parametrize("K", [1, 5])
def test_conv1d_module_matches_jax(impl, K):
    """Conv1d of each impl (incl. the K=1 matmul exception) against the JAX
    Conv1d on the same [K, Cin, Cout] kernel."""
    import jax

    from speakingstyle_tpu.ops.conv import Conv1d as JConv
    from speakingstyle_torch.compat.from_jax import load_flax_variables
    from speakingstyle_torch.ops.conv import Conv1d as TConv

    x = np.random.default_rng(K).standard_normal((2, 13, 6)).astype(np.float32)
    jmod = JConv(7, kernel_size=K, impl=impl, activation="relu")
    variables = jax.device_get(jmod.init(jax.random.PRNGKey(K), jnp.asarray(x)))
    tmod = load_flax_variables(TConv(6, 7, K, impl=impl, activation="relu"), variables)
    want = jmod.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = tmod(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_mel_from_wav_array_matches_jax():
    """The reference wav -> log-mel features: the port's torch STFT against
    the JAX MelExtractor that the JAX package's mel_from_wav_array runs."""
    from speakingstyle_tpu.audio.stft import MelExtractor, get_mel_from_wav
    from speakingstyle_torch.configs.config import Config as TConfig
    from speakingstyle_torch.serving.style import mel_from_wav_array as t_mel

    t = np.arange(22050 // 4) / 22050.0
    wav = (0.3 * np.sin(2 * np.pi * 220 * t) * np.exp(-t)).astype(np.float32)
    want = get_mel_from_wav(wav, MelExtractor(1024, 256, 1024, 80, 22050, 0.0, 8000.0))[0].T
    got = t_mel(TConfig(), wav)
    assert got.shape == want.shape == (22050 // 4 // 256 + 1, 80)
    # the two FFTs round differently; the log magnifies that where a mel
    # bin's magnitude sits near the 1e-5 clamp, hence a relative bound
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)


# ---------------------------------------------------------------- routing and isolation


def test_port_imports_no_jax():
    """``import speakingstyle_torch`` and every submodule leaves jax and the
    JAX package out of sys.modules (a subprocess: this test process
    already imported jax through tests/conftest.py)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import speakingstyle_torch\n"
        "for m in pkgutil.walk_packages(speakingstyle_torch.__path__, 'speakingstyle_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'speakingstyle_tpu'))\n"
        "print(len([n for n in sys.modules if n.startswith('speakingstyle_torch')]))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 30  # every submodule really imported


def test_default_device_is_cuda_and_never_falls_back(monkeypatch):
    from speakingstyle_torch.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


def test_wrappers_reject_what_the_kernels_do_not_take():
    """The CUDA path's input checks (run here on CPU stand-ins), and the
    refusal of devices that have neither a kernel nor a plain version."""
    q = torch.zeros((1, 4, 2, 16))
    mask = torch.zeros((1, 4), dtype=torch.bool)
    t_attn.check_inputs(q, q, q, mask)
    bad = [
        ((q, q, q, mask, torch.bfloat16), NotImplementedError),  # bf16 softmax
        ((q, q[:, :3], q, mask), ValueError),                     # k shape
        ((q.double(), q.double(), q.double(), mask), TypeError),
        ((torch.zeros((1, 4, 2, 12)),) * 3 + (mask,), ValueError),  # D % 8
        ((torch.zeros((1, 4, 1, 136)),) * 3 + (mask,), ValueError),  # D > 128
        ((q, q, q, mask.int()), ValueError),
        ((q.transpose(1, 2).contiguous().transpose(1, 2), q, q, mask), ValueError),
    ]
    for args, err in bad:
        with pytest.raises(err):
            t_attn.check_inputs(*args)

    x, w, vec = torch.zeros((1, 5, 4)), torch.zeros((3, 4, 8)), torch.zeros(8)
    t_conv.check_inputs(x, w, vec, vec, vec)
    for args, err in [
        ((x, torch.zeros((3, 5, 8))), ValueError),             # Cin
        ((x.half(), w.half()), TypeError),
        ((x, w, vec.double()), ValueError),                    # bias dtype
        ((x, w, torch.zeros(7)), ValueError),                  # bias shape
        ((x, w, vec, vec, None), ValueError),                  # LN pair
        ((torch.zeros((1, 5, 4)), torch.zeros((3, 4, 1025)), None,
          torch.zeros(1025), torch.zeros(1025)), ValueError),  # LN width
        ((torch.zeros((5, 2, 4)).transpose(0, 1), w), ValueError),  # contiguity
    ]:
        with pytest.raises(err):
            t_conv.check_inputs(*args)

    meta = torch.empty((1, 4, 2, 16), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        t_attn.fused_mha(meta, meta, meta, mask.to("meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        t_conv.fused_conv1d(x.to("meta"), w.to("meta"))
