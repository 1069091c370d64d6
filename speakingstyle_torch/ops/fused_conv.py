"""Fused conv1d (+bias +ReLU +LayerNorm): the wrapper of the Hopper kernel
and its plain PyTorch version.

The kernel (``csrc/fused_conv.cu``) replaces the TPU kernel
``speakingstyle_tpu/ops/pallas_conv.py::_kernel`` (reached there through
``fused_conv1d`` and ``fused_conv_relu_ln``). It is an implicit GEMM with
the epilogue in the same kernel; what bounds it on the H100 and what its
design does about that is written at the top of the CUDA source.

A CPU tensor goes to ``fused_conv_plain``; a CUDA tensor goes to the kernel,
or the call raises. ``fused_conv1d.launches`` counts kernel launches of both
entry points. Forward only: the post-ReLU ``act`` output and the backward
belong to the training path.
"""

import ctypes
from typing import Optional

import torch

from speakingstyle_torch.ops import kernels

LN_EPS = 1e-5
MAX_LN_CHANNELS = 1024  # the LN variant's block owns whole Cout rows

_SIGNATURE = {
    "fused_conv1d_fwd": (
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    )
}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def conv1d_unfold(x, kernel, bias=None, dilation: int = 1):
    """SAME-padded 1-D conv as one matmul over the stacked taps (im2col).
    x [B, T, Cin], kernel [K, Cin, Cout] -> [B, T, Cout] in x's dtype."""
    K = kernel.shape[0]
    if K == 1:
        y = x @ kernel[0]
    else:
        span = (K - 1) * dilation + 1
        pad = (span - 1) // 2
        T = x.shape[1]
        xp = torch.nn.functional.pad(x, (0, 0, pad, span - 1 - pad))
        cols = torch.stack(
            [xp[:, j * dilation: j * dilation + T] for j in range(K)], dim=2
        )  # [B, T, K, Cin]
        y = cols.flatten(2) @ kernel.reshape(-1, kernel.shape[-1])
    if bias is not None:
        y = y + bias
    return y


def fused_conv_plain(x, kernel, bias=None, ln_scale=None, ln_bias=None,
                     dilation: int = 1, relu: bool = False):
    """The kernel's function in plain tensor ops (the JAX package's
    ``_reference_fused_parts``): the conv and bias in f32, optional ReLU,
    then the result in x's dtype; with LayerNorm, the stats are taken over
    that rounded activation in f32 and the affine applied before the final
    cast."""
    dtype = x.dtype
    y = conv1d_unfold(
        x.float(), kernel.float(), None if bias is None else bias.float(), dilation
    )
    if relu:
        y = torch.clamp(y, min=0.0)
    y = y.to(dtype)
    if ln_scale is not None:
        yf = y.float()
        mean = yf.mean(dim=-1, keepdim=True)
        var = ((yf - mean) ** 2).mean(dim=-1, keepdim=True)
        yf = (yf - mean) * torch.rsqrt(var + LN_EPS)
        y = (yf * ln_scale.float() + ln_bias.float()).to(dtype)
    return y


def check_inputs(x, kernel, bias=None, ln_scale=None, ln_bias=None, dilation=1) -> None:
    """Raise on anything the CUDA kernel does not take."""
    B, T, cin = x.shape
    K, kcin, cout = kernel.shape
    if kcin != cin:
        raise ValueError(f"fused_conv: kernel {tuple(kernel.shape)} vs x Cin {cin}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"fused_conv: dtype {x.dtype} is not float32 or bfloat16")
    vecs = [("bias", bias), ("ln_scale", ln_scale), ("ln_bias", ln_bias)]
    for name, t in [("kernel", kernel)] + vecs:
        if t is None:
            continue
        if t.dtype != x.dtype or t.device != x.device:
            raise ValueError(
                f"fused_conv: {name} is {t.dtype} on {t.device}, x is "
                f"{x.dtype} on {x.device}"
            )
        if name != "kernel" and tuple(t.shape) != (cout,):
            raise ValueError(f"fused_conv: {name} must be [{cout}], got {tuple(t.shape)}")
    if (ln_scale is None) != (ln_bias is None):
        raise ValueError("fused_conv: ln_scale and ln_bias go together")
    if ln_scale is not None and cout > MAX_LN_CHANNELS:
        raise ValueError(
            f"fused_conv: the LayerNorm variant takes Cout <= {MAX_LN_CHANNELS}, got {cout}"
        )
    if dilation < 1 or K < 1:
        raise ValueError(f"fused_conv: K={K} dilation={dilation}")
    for name, t in [("x", x), ("kernel", kernel)] + vecs:
        if t is not None and not t.is_contiguous():
            raise ValueError(f"fused_conv: {name} must be contiguous")


def _launch(x, kernel, bias, ln_scale, ln_bias, dilation, relu):
    check_inputs(x, kernel, bias, ln_scale, ln_bias, dilation)
    B, T, cin = x.shape
    K, _, cout = kernel.shape
    out = torch.empty((B, T, cout), dtype=x.dtype, device=x.device)
    if B == 0 or T == 0 or cout == 0:
        return out
    lib = kernels.load("fused_conv", _SIGNATURE)
    ptr = lambda t: None if t is None else t.data_ptr()
    err = lib.fused_conv1d_fwd(
        x.data_ptr(), kernel.data_ptr(), ptr(bias), ptr(ln_scale), ptr(ln_bias),
        out.data_ptr(), B, T, cin, cout, K, dilation, int(relu), _DTYPES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    kernels.check(err, "fused_conv1d_fwd")
    fused_conv1d.launches += 1
    return out


def _dispatch(x, kernel, bias, ln_scale, ln_bias, dilation, relu):
    if x.device.type == "cpu":
        return fused_conv_plain(x, kernel, bias, ln_scale, ln_bias, dilation, relu)
    if x.device.type != "cuda":
        raise ValueError(f"fused_conv: unsupported device {x.device}")
    return _launch(x, kernel, bias, ln_scale, ln_bias, dilation, relu)


def fused_conv1d(x, kernel, bias: Optional[torch.Tensor] = None, *,
                 dilation: int = 1, relu: bool = False):
    """SAME conv1d (+bias, +optional ReLU). x [B, T, Cin], kernel
    [K, Cin, Cout], bias [Cout], all of one dtype -> [B, T, Cout]."""
    return _dispatch(x, kernel, bias, None, None, dilation, relu)


def fused_conv_relu_ln(x, kernel, bias, ln_scale, ln_bias, *, dilation: int = 1):
    """conv1d -> ReLU -> channel LayerNorm in one pass (the reference
    encoder's conv stack)."""
    return _dispatch(x, kernel, bias, ln_scale, ln_bias, dilation, True)


fused_conv1d.launches = 0
