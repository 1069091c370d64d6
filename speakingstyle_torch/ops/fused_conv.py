"""Fused conv1d (+bias +ReLU +LayerNorm): the wrapper of the Hopper kernel,
its plain PyTorch version, and the analytic backward around both.

The kernel (``csrc/fused_conv.cu``) replaces the TPU kernel
``speakingstyle_tpu/ops/pallas_conv.py::_kernel`` (reached there through
``fused_conv1d`` and ``fused_conv_relu_ln``). It is an implicit GEMM with
the epilogue in the same kernel; what bounds it on the H100 and what its
design does about that is written at the top of the CUDA source. With
LayerNorm it also writes ``act``, the post-ReLU, pre-LN activation rounded
to the storage dtype, for the backward. ``conv_plan`` chooses the bf16
launch's shape (time steps a block, and the cluster that shares Cout under
LayerNorm) from the problem and the card's SM count; ``ln_tiles`` gives the
128-channel tiles each block of that cluster computes in turn. Any Cout
runs in the kernel, LayerNorm included (the TPU kernel runs every
128-aligned Cout).

Both entry points are differentiable. The backward is the JAX package's
"analytic" ``_fused_bwd`` (``pallas_conv.py:295-360``) in torch ops, on
the card and on the CPU alike: the LN backward from ``act`` with the
statistics recomputed, the ReLU mask ``act >= finfo(dtype).tiny``, then db
and the vjp of the linear conv (``torch.nn.grad``'s convolution
backward, as the JAX package leaves it to XLA). Without LN the residual
is the output itself.

A CPU tensor goes to ``fused_conv_plain``; a CUDA tensor goes to the kernel,
or the call raises. ``fused_conv1d.launches`` counts kernel launches of both
entry points, ``fused_conv1d.act_launches`` those that wrote ``act``.
"""

import ctypes
from typing import Dict, Optional, Tuple

import torch

from speakingstyle_torch.ops import kernels

LN_EPS = 1e-5
CONV_BN = 128          # output channels a block of the bf16 kernel
CONV_BMS = (128, 64, 32)  # its time steps a block, largest first
MAX_CLUSTER = 8        # blocks of a cluster (the portable maximum)

_P, _I = ctypes.c_void_p, ctypes.c_int
# x, w, bias, ln_scale, ln_shift, out, act; B, T, Cin, Cout, K, dilation,
# relu, bm, cluster, dtype; stream
_SIGNATURE = {"fused_conv1d_fwd": (_P,) * 7 + (_I,) * 10 + (_P,)}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SMS: Dict[int, int] = {}  # device index -> SM count


def ln_tiles(cout: int) -> int:
    """128-channel tiles a block of the bf16 LayerNorm launch computes one
    after another: ceil(n / 8) of the n = ceil(Cout / 128), so that one
    cluster of at most 8 blocks covers Cout (1 up to Cout = 1024)."""
    return -(-(-(-cout // CONV_BN)) // MAX_CLUSTER)


def conv_plan(B: int, T: int, cout: int, ln: bool, sms: int) -> Tuple[int, int]:
    """(time steps a block, blocks a cluster) of the bf16 kernel's launch.
    A block owns ``bm`` steps of one batch row x 128 output channels (with
    LayerNorm, ``ln_tiles(cout)`` such tiles in turn): the largest of 128,
    64, 32 steps whose grid still gives every one of the card's ``sms`` SMs
    a block (32 where none does). With LayerNorm the blocks of one row tile
    form a cluster of ceil(ceil(Cout / 128) / ln_tiles) <= 8, which
    exchanges the per-step LN sums; without it the cluster is 1."""
    n_tiles = -(-cout // CONV_BN)
    cols = -(-n_tiles // ln_tiles(cout)) if ln else n_tiles
    bm = next((m for m in CONV_BMS if B * -(-T // m) * cols >= sms), CONV_BMS[-1])
    return bm, (cols if ln else 1)


def _sm_count(device) -> int:
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


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


def fused_conv_plain_parts(x, kernel, bias=None, ln_scale=None, ln_bias=None,
                           dilation: int = 1, relu: bool = False):
    """The kernel's function in plain tensor ops (the JAX package's
    ``_reference_fused_parts``): the conv and bias in f32, optional ReLU,
    then the result in x's dtype (``act``); with LayerNorm, the stats are
    taken over that rounded activation in f32 and the affine applied
    before the final cast. Returns (y, act); act is y without LayerNorm."""
    dtype = x.dtype
    y = conv1d_unfold(
        x.float(), kernel.float(), None if bias is None else bias.float(), dilation
    )
    if relu:
        y = torch.clamp(y, min=0.0)
    act = y = y.to(dtype)
    if ln_scale is not None:
        yf = y.float()
        mean = yf.mean(dim=-1, keepdim=True)
        var = ((yf - mean) ** 2).mean(dim=-1, keepdim=True)
        yf = (yf - mean) * torch.rsqrt(var + LN_EPS)
        y = (yf * ln_scale.float() + ln_bias.float()).to(dtype)
    return y, act


def fused_conv_plain(x, kernel, bias=None, ln_scale=None, ln_bias=None,
                     dilation: int = 1, relu: bool = False):
    """The forward kernel's output (``fused_conv_plain_parts``' y)."""
    return fused_conv_plain_parts(x, kernel, bias, ln_scale, ln_bias, dilation, relu)[0]


def fused_conv_bwd(g, x, kernel, bias, ln_scale, ln_bias, act, dilation: int, relu: bool):
    """The analytic backward (``pallas_conv.py:309-360``): grads of x,
    kernel, bias, ln_scale and ln_bias (None where the input is None).
    ``act`` is the post-ReLU, pre-LN activation in x's dtype (the output
    itself without LN; unused without ReLU and LN)."""
    import torch.nn.functional as F

    gf = g.float()
    d_scale = d_lnbias = None
    if ln_scale is not None:
        af = act.float()
        mean = af.mean(dim=-1, keepdim=True)
        var = ((af - mean) ** 2).mean(dim=-1, keepdim=True)
        rstd = torch.rsqrt(var + LN_EPS)
        norm = (af - mean) * rstd
        d_scale = (gf * norm).sum(dim=(0, 1)).to(ln_scale.dtype)
        d_lnbias = gf.sum(dim=(0, 1)).to(ln_bias.dtype)
        dnorm = gf * ln_scale.float()
        da = (dnorm - dnorm.mean(dim=-1, keepdim=True)
              - norm * (dnorm * norm).mean(dim=-1, keepdim=True)) * rstd
    else:
        da = gf
    if relu:
        # the stored activation's smallest normal, not 0: a value that
        # rounded to a stored 0 or subnormal passes no gradient
        da = da * (act.float() >= torch.finfo(act.dtype).tiny)
    dz = da.to(x.dtype)
    db = None if bias is None else da.sum(dim=(0, 1)).to(bias.dtype)
    # the vjp of the linear SAME conv, channels-first, on the explicitly
    # padded input (an even span pads one more step on the right)
    K, T = kernel.shape[0], x.shape[1]
    span = (K - 1) * dilation + 1
    lo = (span - 1) // 2
    xp = F.pad(x.transpose(1, 2), (lo, span - 1 - lo))
    w = kernel.permute(2, 1, 0)
    dzt = dz.transpose(1, 2)
    dx = torch.nn.grad.conv1d_input(xp.shape, w, dzt, dilation=dilation)
    dw = torch.nn.grad.conv1d_weight(xp, w.shape, dzt, dilation=dilation)
    dx = dx[:, :, lo: lo + T].transpose(1, 2)
    return dx, dw.permute(2, 1, 0), db, d_scale, d_lnbias


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
    if dilation < 1 or K < 1:
        raise ValueError(f"fused_conv: K={K} dilation={dilation}")
    for name, t in [("x", x), ("kernel", kernel)] + vecs:
        if t is not None and not t.is_contiguous():
            raise ValueError(f"fused_conv: {name} must be contiguous")


def fused_conv_fwd(x, kernel, bias=None, ln_scale=None, ln_bias=None, dilation: int = 1,
                   relu: bool = False, want_act: bool = False):
    """Launch the kernel on CUDA tensors: (y, act or None). ``want_act``
    (LayerNorm only) also writes the post-ReLU, pre-LN activation."""
    check_inputs(x, kernel, bias, ln_scale, ln_bias, dilation)
    if want_act and ln_scale is None:
        raise ValueError("fused_conv: act is written only by the LayerNorm variant")
    B, T, cin = x.shape
    K, _, cout = kernel.shape
    out = torch.empty((B, T, cout), dtype=x.dtype, device=x.device)
    act = torch.empty_like(out) if want_act else None
    if B == 0 or T == 0 or cout == 0:
        return out, act
    bm, cluster = conv_plan(B, T, cout, ln_scale is not None, _sm_count(x.device))
    lib = kernels.load("fused_conv", _SIGNATURE)
    ptr = lambda t: None if t is None else t.data_ptr()
    err = lib.fused_conv1d_fwd(
        x.data_ptr(), kernel.data_ptr(), ptr(bias), ptr(ln_scale), ptr(ln_bias),
        out.data_ptr(), ptr(act), B, T, cin, cout, K, dilation, int(relu), bm, cluster,
        _DTYPES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream,
    )
    kernels.check(err, "fused_conv1d_fwd")
    kernels.add_flops(2 * B * T * K * cin * cout)
    fused_conv1d.launches += 1
    fused_conv1d.act_launches += int(want_act)
    return out, act


class _FusedConv(torch.autograd.Function):
    """The kernel (CUDA) or the plain version (CPU) forward; the analytic
    backward in torch ops on both. Where a backward can follow (grad mode on
    and an input that requires grad), saves x, the weights and, where the
    backward reads it, ``act``."""

    @staticmethod
    def forward(ctx, x, kernel, bias, ln_scale, ln_bias, dilation, relu, grad_enabled):
        ctx.dilation, ctx.relu = dilation, relu
        grad = grad_enabled and any(ctx.needs_input_grad[:5])
        ln = ln_scale is not None
        if x.device.type == "cpu":
            y, act = fused_conv_plain_parts(x, kernel, bias, ln_scale, ln_bias, dilation, relu)
        else:
            y, act = fused_conv_fwd(x, kernel, bias, ln_scale, ln_bias, dilation, relu,
                                    want_act=grad and ln)
            if not ln:
                act = y
        if grad:
            ctx.save_for_backward(x, kernel, bias, ln_scale, ln_bias,
                                  act if (ln or relu) else None)
        return y

    @staticmethod
    def backward(ctx, g):
        x, kernel, bias, ln_scale, ln_bias, act = ctx.saved_tensors
        grads = fused_conv_bwd(g, x, kernel, bias, ln_scale, ln_bias, act,
                               ctx.dilation, ctx.relu)
        return (*grads, None, None, None)


def _dispatch(x, kernel, bias, ln_scale, ln_bias, dilation, relu):
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_conv: unsupported device {x.device}")
    return _FusedConv.apply(x, kernel, bias, ln_scale, ln_bias, dilation, relu,
                            torch.is_grad_enabled())


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
fused_conv1d.act_launches = 0
