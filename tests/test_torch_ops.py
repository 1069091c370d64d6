"""PyTorch port, ops layer: each op of speakingstyle_torch/ops against its
JAX counterpart on identical numpy inputs.

The two kernels' plain versions (the path a CPU tensor takes) are held
against the JAX package's Pallas kernels in interpret mode at atol 1e-5,
and their backward passes (the port's own backward math through the
``torch.autograd.Function``s the card uses) against JAX's gradients at
1e-4 (attention) and 2e-4 (conv); tests/test_torch_kernels.py holds the
hand-written kernels against those plain versions on the card.
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

from test_torch_models import one_cpu_thread  # noqa: F401 (an autouse fixture)

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


@pytest.mark.parametrize("L,H,D", [(23, 4, 16), (130, 2, 8)])
def test_attention_delta_equals_the_tpu_kernels_row_term(L, H, D):
    """The backward's pre-pass takes delta = rowsum(dO o O) from the
    forward's output, where the JAX package's _bwd_kernel
    (pallas_attention.py:92) takes rowsum(dP o P) over all keys: the same
    sum reordered, since O = P V. The plain pre-pass on O against
    rowsum(dP o P) in float64, with unequal lengths and a batch row of
    length 0 (uniform P, as the port's forward gives it)."""
    rng = np.random.default_rng(L * D)
    B = 3
    q, k, v, dout = (rng.standard_normal((B, L, H, D)) for _ in range(4))
    lens = np.array([L, L // 2, 0])
    mask = np.arange(L)[None] >= lens[:, None]
    scores = np.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(D)
    scores = np.where(mask[:, None, None, :], np.finfo(np.float32).min / 2, scores)
    p = np.exp(scores - scores.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    out = np.einsum("bhqk,bkhd->bqhd", p, v)
    want = (np.einsum("bqhd,bkhd->bhqk", dout, v) * p).sum(-1)  # [B, H, L]
    got = t_attn.attention_delta_plain(torch.from_numpy(out).float(),
                                       torch.from_numpy(dout).float())
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, H, L)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("L,H,D", [(23, 4, 16), (130, 2, 8)])
def test_attention_grads_match_pallas_interpret(L, H, D):
    """q/k/v grads through fused_mha on CPU tensors (plain forward, plain
    backward) against the JAX fused-MHA kernel's custom_vjp in interpret
    mode, with unequal lengths and a batch row of length 0; the cotangent
    is masked at padded queries, as tests/test_ops.py does."""
    import jax

    from speakingstyle_tpu.ops.pallas_attention import fused_mha

    rng = np.random.default_rng(L + H + D)
    B = 3
    q, k, v = (rng.standard_normal((B, L, H, D)).astype(np.float32) for _ in range(3))
    lens = np.array([L, rng.integers(L // 2, L), 0])
    mask = np.arange(L)[None] >= lens[:, None]
    real = (~mask)[:, :, None, None].astype(np.float32)

    def j_loss(q_, k_, v_):
        return jnp.sum(jnp.square(fused_mha(q_, k_, v_, jnp.asarray(mask), interpret=True) * real))

    want = jax.grad(j_loss, argnums=(0, 1, 2))(q, k, v)
    leaves = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    out = t_attn.fused_mha(*leaves, torch.from_numpy(mask))
    assert out.grad_fn is not None
    (out * torch.from_numpy(real)).square().sum().backward()
    for got, w in zip(leaves, want):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(w), atol=1e-4)


def _bf16_softmax_p_error(q, k, mask, scale):
    """(|p_jax - p_plain| bound [B, H, L, L], the plain version's p), float64.

    Both round the f32 scores to bf16 (one flipped by another f32 sum
    order moves by a bf16 ulp, <= 2^-7 |s|); the JAX package's
    ``_softmax_rows`` then rounds s - m, its exp, the row sum and the
    quotient to bf16 (<= 2^-8 relative each, s - m's rounding moving p by
    2^-8 |s - m|), the plain version the quotient only: to first order
    |dp| <= 2^-8 (|s - m| + 4 + 2 |s|) p."""
    sc = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64), k.astype(np.float64)) * scale
    sc = np.where(mask[:, None, None, :], np.finfo(np.float32).min / 2, sc)
    sb = torch.from_numpy(sc).float().to(torch.bfloat16).double().numpy()
    m = sb.max(-1, keepdims=True)
    p = np.exp(sb - m)
    p /= p.sum(-1, keepdims=True)
    return 2.0 ** -8 * (np.abs(sb - m) + 4 + 2 * np.abs(sb)) * p, p


@pytest.mark.parametrize("L,D", [(23, 16), (130, 32)])
def test_bf16_softmax_plain_matches_pallas_interpret(L, D):
    """The plain versions at ``softmax_dtype=bfloat16`` (the oracle of the
    kernels' bf16-softmax specialisation) against the JAX fused-MHA kernel
    with ``softmax_dtype=bfloat16`` in interpret mode and its VJP, scores
    spread to ~N(0, 4), rows of unequal length and one fully padded row
    (forward compared on rows with a valid key: the Pallas kernel attends
    over its 128-lane padding there, ROADMAP.md queue C item 3). Bound per
    element: the P error of ``_bf16_softmax_p_error`` carried through each
    product (dV = P^T dO; dS = P (dP - delta) sm_scale with delta's error
    sum_j |dp_j| |dP_j|; dQ = dS K, dK = dS^T Q), plus 1e-5 for the f32
    sums."""
    import jax

    from speakingstyle_tpu.ops.pallas_attention import fused_mha

    rng = np.random.default_rng(L + D)
    B, H = 3, 2
    q, k, v, g = (rng.standard_normal((B, L, H, D)).astype(np.float32) for _ in range(4))
    q *= 2.0
    lens = np.array([L, L // 2, 0])
    mask = np.arange(L)[None] >= lens[:, None]
    real = (~mask)[:, :, None, None].astype(np.float32)
    scale = D ** -0.5
    dp_bound, p = _bf16_softmax_p_error(q, k, mask, scale)

    bf16 = jnp.bfloat16
    want = np.asarray(fused_mha(*(jnp.asarray(a) for a in (q, k, v, mask)),
                                softmax_dtype=bf16, interpret=True))
    got = t_attn.fused_mha_plain(*(torch.from_numpy(a) for a in (q, k, v, mask)),
                                 softmax_dtype=torch.bfloat16).numpy()
    bound = 1e-5 + np.einsum("bhqk,bkhd->bqhd", dp_bound, np.abs(v))
    rows = lens > 0
    assert np.all(np.abs(got - want)[rows] <= bound[rows])
    f32 = t_attn.fused_mha_plain(*(torch.from_numpy(a) for a in (q, k, v, mask))).numpy()
    assert np.abs(f32 - want)[rows].max() > np.abs(got - want)[rows].max()

    def j_loss(q_, k_, v_):
        out = fused_mha(q_, k_, v_, jnp.asarray(mask), softmax_dtype=bf16, interpret=True)
        return jnp.sum(out * g * real)

    wq, wk, wv = (np.asarray(w) for w in jax.grad(j_loss, argnums=(0, 1, 2))(q, k, v))
    leaves = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    out = t_attn.fused_mha(*leaves, torch.from_numpy(mask), softmax_dtype=torch.bfloat16)
    (out * torch.from_numpy(g * real)).sum().backward()
    gr = (g * real).astype(np.float64)
    dp = np.einsum("bqhd,bkhd->bhqk", gr, v)
    delta = (dp * p).sum(-1, keepdims=True)
    d_delta = (dp_bound * np.abs(dp)).sum(-1, keepdims=True)
    ds = (dp_bound * np.abs(dp - delta) + p * d_delta) * scale
    bounds = (np.einsum("bhqk,bkhd->bqhd", ds, np.abs(k)),
              np.einsum("bhqk,bqhd->bkhd", ds, np.abs(q)),
              np.einsum("bhqk,bqhd->bkhd", dp_bound, np.abs(gr)))
    for leaf, w, b in zip(leaves, (wq, wk, wv), bounds):
        assert np.all(np.abs(leaf.grad.numpy() - w) <= 1e-5 + b)


@pytest.mark.parametrize("ln", [True, False])
def test_conv_grads_match_jax_analytic_backward(ln):
    """Grads of x, w, b (and the LN scale and bias) through
    fused_conv_relu_ln / fused_conv1d(relu=True) on CPU tensors against
    the JAX package's analytic backward, at Cout 128 (the lane width where
    its interpreted kernel, not its reference fallback, runs)."""
    import jax

    from speakingstyle_tpu.ops.pallas_conv import fused_conv1d, fused_conv_relu_ln

    rng = np.random.default_rng(11 + ln)
    x = rng.standard_normal((2, 24, 48)).astype(np.float32)
    w = (rng.standard_normal((3, 48, 128)) * 0.05).astype(np.float32)
    b = (rng.standard_normal(128) * 0.1).astype(np.float32)
    s = rng.standard_normal(128).astype(np.float32)
    sb = rng.standard_normal(128).astype(np.float32)
    args = (x, w, b, s, sb) if ln else (x, w, b)
    if ln:
        j_fn = lambda a: fused_conv_relu_ln(*a, interpret=True)
        t_fn = lambda a: t_conv.fused_conv_relu_ln(*a)
    else:
        j_fn = lambda a: fused_conv1d(*a, relu=True, interpret=True)
        t_fn = lambda a: t_conv.fused_conv1d(*a, relu=True)
    want = jax.grad(lambda a: jnp.sum(j_fn(a) ** 2))(tuple(jnp.asarray(t) for t in args))
    leaves = [torch.tensor(a, requires_grad=True) for a in args]
    (t_fn(leaves) ** 2).sum().backward()
    for got, wnt in zip(leaves, want):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(wnt), rtol=2e-4, atol=2e-4)


def test_conv_backward_relu_mask_in_bf16_matches_jax():
    """The analytic backward on the same bf16 residuals as the JAX
    package's ``_fused_bwd``: the ReLU mask passes act >= finfo.tiny only,
    so stored zeros and subnormals pass no gradient."""
    import jax

    from speakingstyle_tpu.ops import pallas_conv

    rng = np.random.default_rng(21)
    bf = jnp.bfloat16
    x = jnp.asarray(rng.standard_normal((2, 9, 16)), bf)
    w = jnp.asarray(rng.standard_normal((3, 16, 32)) * 0.2, bf)
    b = jnp.asarray(rng.standard_normal(32) * 0.1, bf)
    act = np.abs(rng.standard_normal((2, 9, 32))).astype(np.float32)
    act[0, :, :4] = 0.0
    act[0, :, 4:8] = 1e-39  # a bf16 subnormal
    act[1, :, :4] = float(np.finfo(np.float32).tiny)
    act = jnp.asarray(act, bf)
    g = jnp.asarray(rng.standard_normal((2, 9, 32)), bf)
    want = pallas_conv._fused_bwd(1, True, 16, True, "analytic",
                                  (x, w, b, None, None, act), g)
    t = lambda a: torch.from_numpy(np.array(jnp.asarray(a, jnp.float32))).to(torch.bfloat16)
    got = t_conv.fused_conv_bwd(t(g), t(x), t(w), t(b), None, None, t(act), 1, True)
    assert got[3] is None and got[4] is None
    db = got[2].float().numpy()
    assert np.all(db == np.asarray(want[2], np.float32))
    for gt, wt in zip(got[:2], want[:2]):
        np.testing.assert_allclose(gt.float().numpy(), np.asarray(wt, np.float32),
                                   rtol=2 ** -7, atol=2e-2)


def test_hash_dropout_mask_is_bit_identical_to_jax():
    """Given JAX's salt (``jax.random.bits(rng, (), uint32)``), the hash
    impl's mask is JAX's, bit for bit, at several rates and shapes."""
    import jax

    from speakingstyle_tpu.ops.dropout import keep_mask as j_keep
    from speakingstyle_torch.ops.dropout import keep_mask as t_keep

    for i, (rate, shape) in enumerate([(0.1, (7, 13)), (0.5, (3, 5, 64)), (0.2, (2, 333))]):
        rng = jax.random.PRNGKey(i)
        # the same key on purpose: keep_mask draws its salt from it this way
        salt = int(jax.random.bits(rng, (), jnp.uint32))
        want = np.asarray(j_keep(rng, rate, shape, "hash"))  # jaxlint: disable=JL006
        np.testing.assert_array_equal(t_keep(rate, shape, "hash", salt=salt).numpy(), want)


@pytest.mark.parametrize("impl", ["hash", "bits16", "bernoulli"])
def test_dropout_statistics_scaling_and_determinism(impl):
    from speakingstyle_torch.ops.dropout import DropoutRNG, dropout

    x = torch.ones((64, 1000))
    for rate in (0.1, 0.5):
        y = dropout(x, rate, DropoutRNG(3), impl)
        kept = y != 0
        assert abs(kept.float().mean() - (1 - rate)) < 0.01
        torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / (1 - rate)))
        assert torch.equal(y, dropout(x, rate, DropoutRNG(3), impl))
        assert not torch.equal(y, dropout(x, rate, DropoutRNG(4), impl))
    assert torch.equal(dropout(x, 1.0, DropoutRNG(3), impl), torch.zeros_like(x))
    assert not dropout(x, 1.5, None, impl).any()
    assert dropout(x, 0.0, None, impl) is x


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
    """``import speakingstyle_torch`` and every submodule leaves jax, flax,
    orbax and the JAX package out of sys.modules, and msgpack and
    matplotlib too, which the card's machine lacks (a subprocess: this test
    process already imported jax through tests/conftest.py)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import speakingstyle_torch\n"
        "for m in pkgutil.walk_packages(speakingstyle_torch.__path__, 'speakingstyle_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'orbax', 'msgpack', 'matplotlib', 'speakingstyle_tpu'))\n"
        "print(len([n for n in sys.modules if n.startswith('speakingstyle_torch')]))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 56  # every submodule really imported


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
        ((q, q, q, mask, torch.float16), ValueError),             # f16 softmax
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

    # the backward kernels copy rows in 16-byte pieces: a tensor that does
    # not start on a 16-byte boundary is refused before any launch
    flat = torch.zeros(1 * 4 * 2 * 16 + 1)
    shifted = flat[1:].view(1, 4, 2, 16)
    lse = torch.zeros((1, 2, 4))
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte boundary"):
        t_attn.fused_mha_bwd(shifted, q, q, mask, q, lse, q, 0.25)
    with pytest.raises(ValueError, match="16-byte boundary"):
        t_attn.attention_delta(q, shifted)
    with pytest.raises(ValueError, match="contiguous twin"):
        t_attn.attention_delta(q, q[:, :3])
    with pytest.raises(ValueError, match="not taken"):
        t_attn.attention_delta(q.double(), q.double())

    meta = torch.empty((1, 4, 2, 16), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        t_attn.fused_mha(meta, meta, meta, mask.to("meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        t_conv.fused_conv1d(x.to("meta"), w.to("meta"))


@pytest.mark.parametrize("B,T,cout,ln,want", [
    (4, 1000, 1024, True, (128, 8)),   # serve: the reference encoder's LN convs
    (48, 768, 1024, True, (128, 8)),   # train batch: the same
    (4, 1000, 1000, True, (128, 8)),   # a last block of 104 channels
    (4, 1000, 512, True, (64, 4)),     # 128-step tiles: 128 blocks < 132 SMs
    (2, 45, 256, True, (32, 2)),
    (2, 300, 128, True, (32, 1)),      # one block a cluster
    (4, 1000, 1024, False, (128, 1)),  # serve: the decoder FFN
    (4, 128, 1024, False, (32, 1)),    # serve: the encoder FFN, no size fills the SMs
    (48, 128, 256, False, (64, 1)),    # train: the encoder's second FFN conv
])
def test_conv_plan_matches_the_kernels_tiles(B, T, cout, ln, want):
    """The bf16 conv's launch shape, chosen on the host: the largest of 128,
    64, 32 steps a block whose grid gives each of the H100's 132 SMs a
    block, and with LayerNorm a cluster of ceil(Cout / 128) blocks (the
    kernel refuses any other cluster)."""
    bm, cluster = t_conv.conv_plan(B, T, cout, ln, 132)
    assert (bm, cluster) == want
    n_blocks = B * -(-T // bm) * -(-cout // 128)
    assert n_blocks >= 132 or bm == 32
    assert bm == 128 or B * -(-T // (2 * bm)) * -(-cout // 128) < 132


def test_conv_plan_refuses_a_layernorm_wider_than_a_cluster():
    assert t_conv.conv_plan(4, 100, 1024, True, 132)[1] == t_conv.MAX_CLUSTER
    assert t_conv.conv_plan(4, 100, 4096, False, 132)[1] == 1
    with pytest.raises(ValueError, match="Cout <= 1024"):
        t_conv.conv_plan(4, 100, 1025, True, 132)
