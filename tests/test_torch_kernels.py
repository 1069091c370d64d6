"""PyTorch port, the hand-written CUDA kernels: their build and, on a
card, each kernel (forward and backward) against its plain version.

This file imports no JAX, so it also runs where JAX is not installed.
On a machine with a card, skip the JAX-side ``tests/conftest.py``:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

Tests marked ``cuda`` skip where there is no card.
"""

import os

import numpy as np
import pytest
import torch

from speakingstyle_torch.ops import fused_attention as t_attn
from speakingstyle_torch.ops import fused_conv as t_conv
from speakingstyle_torch.ops import kernels
from speakingstyle_torch.tools import mutation_check

from torch_threads import one_cpu_thread  # noqa: F401 (an autouse fixture)


def _lengths_mask(rng, B, L):
    lens = rng.integers(L // 2, L + 1, B)
    lens[0] = L
    return np.arange(L)[None] >= lens[:, None]


def test_build_is_keyed_by_source_and_flags(monkeypatch, tmp_path):
    """A library's file name hashes its source, the shared headers and the
    nvcc flags, so an edited source or header or a new flag builds anew
    instead of loading a stale library; every source of csrc/ is one the
    builder knows."""
    assert sorted(kernels.SOURCES) == sorted(
        f[:-3] for f in os.listdir(kernels.CSRC_DIR) if f.endswith(".cu"))
    path = kernels._lib_path("fused_conv")
    assert os.path.dirname(path) == kernels.BUILD_DIR
    assert path == kernels._lib_path("fused_conv")
    monkeypatch.setattr(kernels, "NVCC_FLAGS", kernels.NVCC_FLAGS + ["-DX"])
    assert kernels._lib_path("fused_conv") != path
    src = tmp_path / "fused_conv.cu"
    src.write_text("// edited\n")
    monkeypatch.setattr(kernels, "CSRC_DIR", str(tmp_path))
    edited = kernels._lib_path("fused_conv")
    assert edited != path
    (tmp_path / "tensor_core.cuh").write_text("// a header\n")
    assert kernels._lib_path("fused_conv") != edited


def test_missing_nvcc_raises(monkeypatch):
    monkeypatch.setattr(kernels.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setattr(kernels.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels._nvcc()
    with pytest.raises(RuntimeError, match="cudaError_t 700"):
        kernels.check(700, "fused_conv1d_fwd")
    kernels.check(0, "fused_conv1d_fwd")


@pytest.mark.parametrize("variant", sorted(mutation_check.MUTANTS))
def test_mutation_check_variants_apply_to_the_source(variant):
    """Each broken variant of the mutation check changes its tensor-core
    kernel (the conv's or the attention forward's) at exactly one place of
    its current source and matches nowhere in the other sources ("none"
    changes none), so the check cannot go stale silently as a kernel is
    edited."""
    change = mutation_check.MUTANTS[variant]
    for name in mutation_check.SOURCES:
        with open(os.path.join(kernels.CSRC_DIR, name)) as f:
            source = f.read()
        if change is None:
            assert mutation_check.mutate(source, variant) == source
        elif change[0] == name:
            mutated = mutation_check.mutate(source, variant)
            assert mutated != source
            with pytest.raises(ValueError, match="occurs 0 times"):
                mutation_check.mutate(mutated, variant)
        else:
            with pytest.raises(ValueError, match="occurs 0 times"):
                mutation_check.mutate(source, variant)

def test_kernel_ab_child_is_valid_python():
    """The A/B timing tool's child program (run only on a card) parses,
    with the cases the tool passes it."""
    from speakingstyle_torch.tools import kernel_ab

    compile(kernel_ab.child_code("checkout", False), "kernel_ab_child", "exec")
    assert all(len(c) == 7 for c in kernel_ab.CONV)
    assert all(len(c) == 6 for c in kernel_ab.ATTENTION_FWD)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run `python3 chip_smoke.py` on the H100")
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    # the plain versions in full float32 (cuDNN defaults to TF32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


# float32: sums in another order. bfloat16: a rounding flipped by that
# order is one bf16 ulp (<= 2^-7 |x|), plus P rounded before rather than
# after the softmax normalisation (atol); as chip_smoke.py states them
TOL = {torch.float32: dict(atol=1e-5, rtol=0), torch.bfloat16: dict(atol=1e-2, rtol=2 ** -7)}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 130, 2, 32), (2, 77, 2, 128), (1, 33, 3, 24)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernel_matches_plain_on_card(cuda_device, shape, dtype):
    B, L, H, D = shape
    g = torch.Generator().manual_seed(L + D)
    q, k, v = (torch.randn(shape, generator=g).to(cuda_device, dtype) for _ in range(3))
    mask = torch.from_numpy(_lengths_mask(np.random.default_rng(L), B, L)).to(cuda_device)
    mask[-1] = True  # a fully padded row stays finite
    before = t_attn.fused_mha.launches
    got = t_attn.fused_mha(q, k, v, mask)
    assert t_attn.fused_mha.launches == before + 1
    want = t_attn.fused_mha_plain(q, k, v, mask)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


# the forward's row lse against logsumexp of the plain version's f32
# scores: reordered sums of L exp terms and of the scores' D products
# (<= ~1.2e-4 at L = 1000, D = 128), and a fully padded row's lse, the bias
# -1.7e38, to a few roundings of its size (as chip_smoke.py states them)
LSE_TOL = dict(atol=2e-4, rtol=2 ** -20)
# a fully padded row's output is V's mean over its L rows: rounded to the
# output dtype (rtol of |mean|) after an f32 sum (sum_tol of sum |v|)
PAD_ROW_TOL = {torch.float32: (2 ** -22, 2 ** -22), torch.bfloat16: (2 ** -8 + 2 ** -22, 2 ** -22)}


@pytest.mark.cuda
@pytest.mark.parametrize("L", [1, 63, 64, 65, 1000])
@pytest.mark.parametrize("H,D", [(3, 24), (8, 32), (2, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_forward_tile_edges_on_card(cuda_device, L, H, D, dtype):
    """The forward (bf16: the tensor-core kernel) around its 64-key tiles,
    at a head dim that is not a multiple of 16 and at the path's two, with
    a row of unequal length, a fully padded row and a row whose only valid
    key is key 0: out against the plain version, lse against logsumexp of
    the plain scores, the padded row against V's mean over its L rows, and
    two runs bit-identical."""
    B = 4
    g = torch.Generator().manual_seed(L * D + 1)
    q, k, v = (torch.randn((B, L, H, D), generator=g).to(cuda_device, dtype) for _ in range(3))
    lens = torch.tensor([L, L // 2 + 1, 0, 1])
    mask = (torch.arange(L)[None] >= lens[:, None]).to(cuda_device)
    scale = D ** -0.5
    before = t_attn.fused_mha.launches
    out, lse = t_attn.fused_mha_fwd(q, k, v, mask, scale, want_lse=True)
    assert t_attn.fused_mha.launches == before + 1
    again, _ = t_attn.fused_mha_fwd(q, k, v, mask, scale)
    assert torch.equal(out, again)
    want = t_attn.fused_mha_plain(q, k, v, mask, scale)
    torch.testing.assert_close(out.float(), want.float(), **TOL[dtype])
    torch.testing.assert_close(lse, t_attn.attention_lse_plain(q, k, mask, scale), **LSE_TOL)
    rtol, sum_tol = PAD_ROW_TOL[dtype]
    v_row = v[2].float()
    mean = v_row.mean(dim=0)
    bound = rtol * mean.abs() + sum_tol * v_row.abs().sum(dim=0)
    assert bool(((out[2].float() - mean).abs() <= bound).all())
    # the row whose only valid key is key 0 returns that key's value
    torch.testing.assert_close(out[3].float(), v[3, :1].float().expand(L, H, D), **TOL[dtype])


@pytest.mark.cuda
def test_attention_forward_refuses_a_misaligned_view_on_card(cuda_device):
    """The forward copies rows in 16-byte pieces: a view that does not
    start on a 16-byte boundary is refused before any launch."""
    _assert_forward_refuses_a_misaligned_view(cuda_device)


def test_attention_forward_refuses_a_misaligned_view():
    """The same refusal on CPU stand-ins: the check comes before the kernel
    library is built or loaded."""
    _assert_forward_refuses_a_misaligned_view(torch.device("cpu"))


def _assert_forward_refuses_a_misaligned_view(dev):
    flat = torch.zeros(2 * 33 * 2 * 32 + 1, dtype=torch.bfloat16, device=dev)
    shifted = flat[1:].view(2, 33, 2, 32)
    q = torch.zeros((2, 33, 2, 32), dtype=torch.bfloat16, device=dev)
    mask = torch.zeros((2, 33), dtype=torch.bool, device=dev)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    before = t_attn.fused_mha.launches
    for args in ((shifted, q, q), (q, shifted, q), (q, q, shifted)):
        with pytest.raises(ValueError, match="16-byte boundary"):
            t_attn.fused_mha_fwd(*args, mask, 0.25)
    assert t_attn.fused_mha.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("K,cin,cout,dil,ln", [
    (3, 80, 1024, 1, True), (9, 256, 300, 1, False), (1, 1024, 256, 1, False),
    (5, 512, 80, 2, False), (3, 70, 1000, 1, True), (1, 40, 200, 1, True),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_kernel_matches_plain_on_card(cuda_device, K, cin, cout, dil, ln, dtype):
    g = torch.Generator().manual_seed(K + cin + cout)
    x = torch.randn((2, 45, cin), generator=g).to(cuda_device, dtype)
    w = (torch.randn((K, cin, cout), generator=g) / np.sqrt(K * cin)).to(cuda_device, dtype)
    b, s, sb = (torch.randn(cout, generator=g).to(cuda_device, dtype) for _ in range(3))
    tol = _conv_tol(dtype)
    if not ln:
        got = t_conv.fused_conv1d(x, w, b, dilation=dil, relu=True)
        want = t_conv.fused_conv_plain(x, w, b, None, None, dil, True)
        torch.testing.assert_close(got.float(), want.float(), **tol)
        return
    got = t_conv.fused_conv_relu_ln(x, w, b, s, sb, dilation=dil)
    _assert_ln_close(got, x, w, b, s, sb, dil, dtype)


def _conv_tol(dtype):
    return dict(TOL[dtype], atol=1e-4) if dtype == torch.float32 else TOL[dtype]


def _assert_ln_close(got, x, w, b, s, sb, dil, dtype):
    """The LN conv's output against the plain version's. The activation is
    rounded to the storage dtype before the LN stats: where the kernel's and
    the plain version's f32 sums round it to neighbouring bf16 values
    (<= 2^-7 |act| apart), the output moves by that step times |gamma| /
    sigma of its row (as chip_smoke.py states)."""
    tol = _conv_tol(dtype)
    got = got.float()
    want = t_conv.fused_conv_plain(x, w, b, s, sb, dil, True).float()
    act = t_conv.fused_conv_plain(x, w, b, None, None, dil, True).float()
    step = 2 ** -7 if dtype == torch.bfloat16 else 0.0
    sigma = act.std(dim=-1, unbiased=False, keepdim=True)
    bound = (tol["atol"] + tol["rtol"] * want.abs()
             + step * act.abs() * s.float().abs() / (sigma + 1e-5))
    assert bool(((got - want).abs() <= bound).all()), (got - want).abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("K", [1, 3, 5, 9])
@pytest.mark.parametrize("ln", [False, True])
def test_conv_cin80_dilation2_on_card(cuda_device, K, ln):
    """Cin = 80 (the first reference conv and the postnet): a last input
    chunk of 16 of 32 channels; dilation 2: each tap's rows shifted past
    both ends of the sequence, with an even span too (K = 1 has none)."""
    g = torch.Generator().manual_seed(80 + K)
    x = torch.randn((3, 71, 80), generator=g).to(cuda_device, torch.bfloat16)
    w = (torch.randn((K, 80, 256), generator=g) / np.sqrt(K * 80)).to(cuda_device, torch.bfloat16)
    b, s, sb = (torch.randn(256, generator=g).to(cuda_device, torch.bfloat16) for _ in range(3))
    if ln:
        _assert_ln_close(t_conv.fused_conv_relu_ln(x, w, b, s, sb, dilation=2),
                         x, w, b, s, sb, 2, torch.bfloat16)
        return
    got = t_conv.fused_conv1d(x, w, b, dilation=2, relu=True)
    want = t_conv.fused_conv_plain(x, w, b, None, None, 2, True)
    torch.testing.assert_close(got.float(), want.float(), **TOL[torch.bfloat16])


@pytest.mark.cuda
@pytest.mark.parametrize("cout", [128, 256, 1024])
@pytest.mark.parametrize("T", [45, 300])
def test_conv_ln_cluster_sizes_on_card(cuda_device, cout, T):
    """The bf16 LN conv at the cluster sizes 1, 2 and 8 (128 channels a
    block), at a few blocks and at 32-step tiles: the output and act."""
    g = torch.Generator().manual_seed(cout + T)
    x = torch.randn((2, T, 1024), generator=g).to(cuda_device, torch.bfloat16)
    w = (torch.randn((3, 1024, cout), generator=g) / np.sqrt(3 * 1024)).to(
        cuda_device, torch.bfloat16)
    b, s, sb = (torch.randn(cout, generator=g).to(cuda_device, torch.bfloat16) for _ in range(3))
    assert t_conv.conv_plan(2, T, cout, True, t_conv._sm_count(x.device))[1] == -(-cout // 128)
    y, act = t_conv.fused_conv_fwd(x, w, b, s, sb, relu=True, want_act=True)
    _assert_ln_close(y, x, w, b, s, sb, 1, torch.bfloat16)
    _, want_act = t_conv.fused_conv_plain_parts(x, w, b, s, sb, 1, True)
    torch.testing.assert_close(act.float(), want_act.float(), **TOL[torch.bfloat16])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_kernel_without_bias_or_relu_on_card(cuda_device, dtype):
    """The null-bias pointer and the linear epilogue; an even tap count."""
    g = torch.Generator().manual_seed(4)
    x = torch.randn((3, 37, 48), generator=g).to(cuda_device, dtype)
    w = (torch.randn((4, 48, 40), generator=g) / np.sqrt(4 * 48)).to(cuda_device, dtype)
    before = t_conv.fused_conv1d.launches
    got = t_conv.fused_conv1d(x, w, dilation=3)
    assert t_conv.fused_conv1d.launches == before + 1
    want = t_conv.fused_conv_plain(x, w, dilation=3)
    tol = dict(TOL[dtype], atol=1e-4) if dtype == torch.float32 else TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), **tol)


# the backward's tolerance, relative to each gradient's max |value| (and
# to each element): float32 sums in another order and takes the row term
# as dO.O instead of rowsum(dP o P); bfloat16 also flips roundings of P and
# dS (<= 2^-8 relative each) inside sums over L terms, a small share of
# the max, where a dropped tile errs by a whole tile's probability mass
BWD_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2 ** -6, 2 ** -7)}


def assert_close_to_max(got, want, dtype):
    rel_max, rtol = BWD_TOL[dtype]
    got, want = got.float(), want.float()
    bound = rel_max * want.abs().max() + rtol * want.abs()
    assert bool(((got - want).abs() <= bound).all()), (got - want).abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 130, 2, 32), (2, 77, 2, 128), (2, 33, 3, 24)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_backward_matches_plain_on_card(cuda_device, shape, dtype):
    """Grads through fused_mha on the card (the forward kernel saving its
    lse, the backward kernel) against the plain backward, with unequal
    lengths, a fully padded batch row, and a cotangent that is not zero at
    padded queries."""
    B, L, H, D = shape
    g = torch.Generator().manual_seed(7 * L + D)
    q, k, v, dout = (torch.randn(shape, generator=g).to(cuda_device, dtype) for _ in range(4))
    mask = torch.from_numpy(_lengths_mask(np.random.default_rng(L), B, L)).to(cuda_device)
    mask[-1] = True
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = t_attn.fused_mha_bwd.launches
    out = t_attn.fused_mha(*leaves, mask)
    assert out.grad_fn is not None
    out.backward(dout)
    assert t_attn.fused_mha_bwd.launches == before + 1
    want = t_attn.fused_mha_bwd_plain(q, k, v, mask, dout)
    for got, w in zip(leaves, want):
        assert got.grad.dtype == dtype
        assert_close_to_max(got.grad, w, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_act_output_and_grads_on_card(cuda_device, dtype):
    """The LN variant's act output against the plain version's, and grads
    through both entry points on the card (kernel forward, analytic
    backward) against torch autograd through the plain version."""
    g = torch.Generator().manual_seed(11)
    x = torch.randn((2, 45, 80), generator=g).to(cuda_device, dtype)
    w = (torch.randn((3, 80, 256), generator=g) / np.sqrt(240)).to(cuda_device, dtype)
    b, s, sb = (torch.randn(256, generator=g).to(cuda_device, dtype) for _ in range(3))
    before = t_conv.fused_conv1d.act_launches
    y, act = t_conv.fused_conv_fwd(x, w, b, s, sb, relu=True, want_act=True)
    assert t_conv.fused_conv1d.act_launches == before + 1
    _, want_act = t_conv.fused_conv_plain_parts(x, w, b, s, sb, 1, True)
    torch.testing.assert_close(act.float(), want_act.float(),
                               **(dict(atol=1e-4, rtol=0) if dtype == torch.float32 else TOL[dtype]))
    if dtype != torch.float32:
        return
    cot = torch.randn((2, 45, 256), generator=g).to(cuda_device)
    for ln in (True, False):
        args = [x, w, b] + ([s, sb] if ln else [])
        leaves = [t.clone().requires_grad_() for t in args]
        ref = [t.clone().requires_grad_() for t in args]
        if ln:
            out = t_conv.fused_conv_relu_ln(*leaves)
            want = t_conv.fused_conv_plain(*ref, 1, True)
        else:
            out = t_conv.fused_conv1d(*leaves, relu=True)
            want = t_conv.fused_conv_plain(*ref, None, None, 1, True)
        assert out.grad_fn is not None
        out.backward(cot)
        want.backward(cot)
        for a, r in zip(leaves, ref):
            assert_close_to_max(a.grad, r.grad, torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("L", [1, 63, 65, 129, 1000])
@pytest.mark.parametrize("H,D", [(8, 32), (2, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_backward_tile_edges_on_card(cuda_device, L, H, D, dtype):
    """The backward at lengths around its 32- and 64-row tiles, with a row
    of unequal length and a fully padded row, against the plain backward;
    and two runs of it bit-identical (no atomics)."""
    B = 3
    g = torch.Generator().manual_seed(L * D)
    q, k, v, dout = (torch.randn((B, L, H, D), generator=g).to(cuda_device, dtype)
                     for _ in range(4))
    lens = torch.tensor([L, L // 2 + 1, 0])
    mask = (torch.arange(L)[None] >= lens[:, None]).to(cuda_device)
    scale = D ** -0.5
    out, lse = t_attn.fused_mha_fwd(q, k, v, mask, scale, want_lse=True)
    got = t_attn.fused_mha_bwd(q, k, v, mask, out, lse, dout, scale)
    again = t_attn.fused_mha_bwd(q, k, v, mask, out, lse, dout, scale)
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    want = t_attn.fused_mha_bwd_plain(q, k, v, mask, dout, scale)
    for a, w in zip(got, want):
        assert a.dtype == dtype
    if L > 1:
        for a, w in zip(got, want):
            assert_close_to_max(a, w, dtype)
        return
    # L = 1: P = 1, so dV = dO and dS = dP - delta = dO.V - dO.O is zero in
    # exact arithmetic (the plain version's dP - rowsum(dP o P) cancels
    # exactly). The kernels take delta from O by another sum, so dQ = dS K
    # and dK = dS Q are that sum's rounding: two f32 sums of D products
    # (<= D 2^-24 of sum |dO V| each), and in bfloat16 O itself rounded
    # (2^-8), times sm_scale, times |K| or |Q|; doubled for the rounding of
    # dS and of the output
    assert_close_to_max(got[2], want[2], dtype)
    u = 2 * D * 2 ** -24 + (2 ** -8 if dtype == torch.bfloat16 else 0.0)
    ds = u * scale * (dout.float().abs() * v.float().abs()).sum(-1, keepdim=True)
    for a, other in ((got[0], k), (got[1], q)):
        assert bool((a.float().abs() <= 2 * ds * other.float().abs()).all())


@pytest.mark.cuda
@pytest.mark.parametrize("D", [24, 32, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_delta_matches_plain_on_card(cuda_device, D, dtype):
    """The backward's pre-pass: delta = rowsum(dO o O) per (b, h, row), in
    f32, against its plain version (the same products summed in another
    order: <= D 2^-24 of the sum of their magnitudes)."""
    g = torch.Generator().manual_seed(D)
    out, dout = (torch.randn((2, 77, 3, D), generator=g).to(cuda_device, dtype) for _ in range(2))
    before = t_attn.attention_delta.launches
    got = t_attn.attention_delta(out, dout)
    assert t_attn.attention_delta.launches == before + 1
    want = t_attn.attention_delta_plain(out, dout)
    scale = torch.einsum("blhd,blhd->bhl", dout.float().abs(), out.float().abs())
    assert got.shape == (2, 3, 77) and got.dtype == torch.float32
    assert bool(((got - want).abs() <= 1e-5 * scale).all())


@pytest.mark.cuda
@pytest.mark.parametrize("L", [1, 63, 65, 1000])
@pytest.mark.parametrize("H,D", [(3, 24), (8, 32), (2, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_bf16_softmax_on_card(cuda_device, L, H, D, dtype):
    """The bf16-softmax specialisation through ``fused_mha`` (forward
    kernel writing lse, then the backward kernels) against the plain
    versions at the same softmax, with a row of unequal length, a fully
    padded row and a row whose only valid key is key 0; inputs and bounds
    as chip_smoke.py states them (q and k on a quarter-step grid, so both
    sides round the same f32 scores to bf16; the backward held to
    ``sm16_bwd_bound``, which the float32-softmax kernels must fail). Only
    the bf16-softmax counts move."""
    import chip_smoke as cs

    B, bf16 = 4, torch.bfloat16
    g = torch.Generator().manual_seed(L * D + 5)
    q, k = cs.exact_score_qk((B, L, H, D), dtype, g, cuda_device)
    v, dout = (torch.randn((B, L, H, D), generator=g).to(cuda_device, dtype) for _ in range(2))
    lens = torch.tensor([L, L // 2 + 1, 0, 1])
    mask = (torch.arange(L)[None] >= lens[:, None]).to(cuda_device)
    scale = D ** -0.5
    counts = lambda: (t_attn.fused_mha.launches, t_attn.fused_mha.launches_bf16sm,
                      t_attn.fused_mha_bwd.launches, t_attn.fused_mha_bwd.launches_bf16sm)
    before = counts()
    out, lse = t_attn.fused_mha_fwd(q, k, v, mask, scale, want_lse=True, softmax_dtype=bf16)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    again = t_attn.fused_mha(*leaves, mask, scale, softmax_dtype=bf16)
    again.backward(dout)
    assert torch.equal(out, again.detach())
    assert counts() == (before[0], before[1] + 2, before[2], before[3] + 1)

    p, premise = cs.sm16_probs(q, k, mask, scale)
    assert premise
    want = t_attn.fused_mha_plain(q, k, v, mask, scale, bf16).float()
    atol, rtol = TOL[dtype]["atol"], TOL[dtype]["rtol"]
    atol = 2e-5 if dtype == torch.float32 else atol  # chip_smoke's attention float32 bound
    extra = cs.SM16_P_ROUND if dtype == torch.float32 else 0.0
    pv = torch.einsum("bhqk,bkhd->bqhd", p, v.float().abs())
    diff = (out.float() - want).abs()
    assert bool((diff <= atol + rtol * want.abs() + extra * pv).all()), diff.max()
    lse_want = t_attn.attention_lse_plain(q, k, mask, scale, bf16)
    torch.testing.assert_close(lse, lse_want, **LSE_TOL)
    rtol_pad, sum_tol = PAD_ROW_TOL[dtype]
    v_row = v[2].float()
    mean = v_row.mean(dim=0)
    assert bool(((out[2].float() - mean).abs()
                 <= rtol_pad * mean.abs() + sum_tol * v_row.abs().sum(dim=0)).all())

    grads = t_attn.fused_mha_bwd_plain(q, k, v, mask, dout, scale, bf16)
    allowed, premise = cs.sm16_bwd_bound(q, k, v, dout, out, lse, mask, scale, grads)
    assert premise
    got = [leaf.grad for leaf in leaves]
    assert max(cs.over_bound(got, grads, allowed)) <= 1.0, cs.over_bound(got, grads, allowed)
    # the control: the float32-softmax kernels from the same inputs fail the
    # bound (at L = 1 every P is 1 under either softmax, the same function)
    out32, lse32 = t_attn.fused_mha_fwd(q, k, v, mask, scale, want_lse=True)
    control = t_attn.fused_mha_bwd(q, k, v, mask, out32, lse32, dout, scale)
    assert (max(cs.over_bound(control, grads, allowed)) > 1.0) == (L > 1)


def test_bf16_softmax_inputs_make_exact_scores():
    """The premise of the bf16-softmax bounds, on the CPU: the quarter-step
    q and k are exact in bf16 and the plain version's f32 scores are their
    exact sums times the f32 sm_scale, rounded once."""
    import chip_smoke as cs

    g = torch.Generator().manual_seed(3)
    for dtype in (torch.float32, torch.bfloat16):
        q, k = cs.exact_score_qk((2, 40, 2, 128), dtype, g, torch.device("cpu"))
        assert torch.equal(q.to(torch.bfloat16).float(), q.float())
        assert float(q.float().abs().max()) < 16
        mask = torch.arange(40)[None] >= torch.tensor([40, 17])[:, None]
        p, premise = cs.sm16_probs(q, k, mask, 128 ** -0.5)
        assert premise and p.shape == (2, 2, 40, 40)
        torch.testing.assert_close(p.sum(-1), torch.ones(2, 2, 40), atol=2e-2, rtol=0)
        spread = float(t_attn._scores(q, k, mask, 128 ** -0.5)[0].std())
        assert 0.5 * cs.SM16_SCORE_STD < spread < 2 * cs.SM16_SCORE_STD


# ---------------------------------------------------------------- the bf16-softmax backward bound


def _emulated_forward(q, k, v, mask, scale, dtype, sm16=True):
    """(out, lse) as the forward kernels compute them: the scores rounded
    to bf16 (``sm16``), P unnormalised in f32, rounded to bf16 for P V in
    a bfloat16 kernel, the row sum from the f32 P."""
    s = t_attn._scores(q, k, mask, scale)
    s = s.to(torch.bfloat16).float() if sm16 else s
    m = s.max(dim=-1, keepdim=True).values
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    pv = p.to(torch.bfloat16).float() if dtype == torch.bfloat16 else p
    out = torch.einsum("bhqk,bkhd->bqhd", pv / l, v.float()).to(dtype)
    return out, (m + torch.log(l))[..., 0]


def _emulated_backward(q, k, v, mask, out, lse, dout, scale, dtype, broken=None):
    """(dq, dk, dv) as the bf16-softmax backward kernels compute them from
    the forward's out and lse: P = bf16(exp(bf16(S) - lse)) (1 / L in a
    fully padded row), delta = dO.O, dS = P (dP - delta) sm_scale, rounded
    to bf16 in a bfloat16 kernel. ``broken`` leaves out roundings: of S
    (``s_all``), of S in the dK/dV pass (``s_dkdv``) or the dQ pass
    (``s_dq``), of P (``p_all``), of P before dS in the dK/dV pass
    (``p_ds``), of S and P (``float32_softmax``, the float32 softmax)."""
    rb = lambda x: x.to(torch.bfloat16).float()
    s = t_attn._scores(q, k, mask, scale)

    def probs(round_s, round_p):
        p = torch.exp((rb(s) if round_s else s) - lse[..., None])
        p[mask.all(dim=-1)] = 1.0 / mask.shape[1]
        return rb(p) if round_p else p

    s_all = ("s_all", "float32_softmax")
    round_p = broken not in ("p_all", "float32_softmax")
    p_dkdv = probs(broken not in (*s_all, "s_dkdv"), round_p)
    p_ds = probs(True, False) if broken == "p_ds" else p_dkdv
    p_dq = probs(broken not in (*s_all, "s_dq"), round_p)
    g = dout.float()
    dp = torch.einsum("bqhd,bkhd->bhqk", g, v.float())
    delta = torch.einsum("blhd,blhd->bhl", g, out.float())[..., None]

    def ds_of(p):
        ds = p * (dp - delta) * scale
        return rb(ds) if dtype == torch.bfloat16 else ds

    dv = torch.einsum("bhqk,bqhd->bkhd", rb(p_dkdv) if dtype == torch.bfloat16 else p_dkdv, g)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds_of(p_dq), k.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds_of(p_ds), q.float())
    return dq.to(dtype), dk.to(dtype), dv.to(dtype)


def _sm16_bound_inputs(dtype):
    import chip_smoke as cs

    B, L, H, D = 3, 96, 2, 64
    g = torch.Generator().manual_seed(11)
    q, k = cs.exact_score_qk((B, L, H, D), dtype, g, torch.device("cpu"))
    v, dout = (torch.randn((B, L, H, D), generator=g).to(dtype) for _ in range(2))
    mask = torch.arange(L)[None] >= torch.tensor([L, 41, 0])[:, None]
    return q, k, v, dout, mask, D ** -0.5


@pytest.mark.parametrize("broken", [None, "s_all", "s_dkdv", "s_dq", "p_all", "p_ds",
                                    "float32_softmax"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sm16_backward_bound_tells_the_rounding_points_apart(dtype, broken):
    """``chip_smoke.sm16_bwd_bound`` on the CPU, against an emulation of the
    bf16-softmax kernels' arithmetic (with a row of unequal length and a
    fully padded row): the sound emulation lies within it, each emulation
    that leaves out one rounding of S or P, and the float32 softmax, fails
    it by more than 4 times."""
    import chip_smoke as cs

    q, k, v, dout, mask, scale = _sm16_bound_inputs(dtype)
    bf16 = torch.bfloat16
    out, lse = _emulated_forward(q, k, v, mask, scale, dtype)
    want = t_attn.fused_mha_bwd_plain(q, k, v, mask, dout, scale, bf16)
    allowed, premise = cs.sm16_bwd_bound(q, k, v, dout, out, lse, mask, scale, want, rows=2)
    assert premise
    if broken == "float32_softmax":
        out, lse = _emulated_forward(q, k, v, mask, scale, dtype, sm16=False)
    got = _emulated_backward(q, k, v, mask, out, lse, dout, scale, dtype, broken)
    ratios = cs.over_bound(got, want, allowed)
    if broken is None:
        assert max(ratios) <= 1.0, ratios
    else:
        assert max(ratios) > 4.0, ratios
