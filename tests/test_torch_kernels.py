"""PyTorch port, the hand-written CUDA kernels: their build and, on a
card, each kernel against its plain version.

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


def _lengths_mask(rng, B, L):
    lens = rng.integers(L // 2, L + 1, B)
    lens[0] = L
    return np.arange(L)[None] >= lens[:, None]


def test_build_is_keyed_by_source_and_flags(monkeypatch, tmp_path):
    """A library's file name hashes its source and the nvcc flags, so an
    edited source or a new flag builds anew instead of loading a stale
    library; every source of csrc/ is one the builder knows."""
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
    assert kernels._lib_path("fused_conv") != path


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
    """Each broken variant of the mutation check changes the tensor-core
    conv kernel at exactly one place of the current source ("none" at
    none), so the check cannot go stale silently as the kernel is edited."""
    with open(os.path.join(kernels.CSRC_DIR, "fused_conv.cu")) as f:
        source = f.read()
    mutated = mutation_check.mutate(source, variant)
    assert (mutated == source) == (variant == "none")
    if variant != "none":
        with pytest.raises(ValueError, match="occurs 0 times"):
            mutation_check.mutate(mutated, variant)

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
    tol = dict(TOL[dtype], atol=1e-4) if dtype == torch.float32 else TOL[dtype]
    if not ln:
        got = t_conv.fused_conv1d(x, w, b, dilation=dil, relu=True)
        want = t_conv.fused_conv_plain(x, w, b, None, None, dil, True)
        torch.testing.assert_close(got.float(), want.float(), **tol)
        return
    got = t_conv.fused_conv_relu_ln(x, w, b, s, sb, dilation=dil).float()
    want = t_conv.fused_conv_plain(x, w, b, s, sb, dil, True).float()
    # the activation is rounded to the storage dtype before the LN stats:
    # where the kernel's and the plain version's f32 sums round it to
    # neighbouring bf16 values (<= 2^-7 |act| apart), the output moves by
    # that step times |gamma| / sigma of its row (as chip_smoke.py states)
    act = t_conv.fused_conv_plain(x, w, b, None, None, dil, True).float()
    step = 2 ** -7 if dtype == torch.bfloat16 else 0.0
    sigma = act.std(dim=-1, unbiased=False, keepdim=True)
    bound = (tol["atol"] + tol["rtol"] * want.abs()
             + step * act.abs() * s.float().abs() / (sigma + 1e-5))
    assert bool(((got - want).abs() <= bound).all()), (got - want).abs().max()


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
