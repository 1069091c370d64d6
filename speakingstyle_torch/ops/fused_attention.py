"""Fused masked self-attention: the wrappers of the Hopper kernels, their
plain PyTorch versions, and the autograd Function that joins them.

The kernels (``csrc/fused_attention.cu``) replace the TPU kernels
``speakingstyle_tpu/ops/pallas_attention.py::_fwd_kernel`` and
``::_bwd_kernel`` (reached there through ``fused_mha`` and its
``custom_vjp``). What bounds them on the H100, and what their design does
about that, is written at the top of the CUDA source: the TPU kernel's
whole T x T score tile does not fit in shared memory, so the forward
streams key tiles through a cp.async ring with an online softmax in
registers, and the backward runs two tiled passes (dK/dV, then dQ) that
recompute P from the forward's row lse, after a pre-pass that writes each
row's delta = rowsum(dO o O) once. In bfloat16 every product runs on the
tensor cores; float32 stays on the CUDA cores.

The softmax runs in float32 or, as the TPU kernels' ``sm_dtype`` allows,
in bfloat16: the kernels then round each f32 score to bf16 (in
natural-log units) before the max, the exp and the row sum, and the
backward rounds P to bf16 too, a template specialisation of every kernel.

``fused_mha`` is the entry point the model calls; it is differentiable. A
CPU tensor runs ``fused_mha_plain`` forward and ``fused_mha_bwd_plain``
backward (the JAX package's ``_bwd_kernel`` math, not torch autograd's); a
CUDA tensor runs the kernels, or the call raises. ``fused_mha.launches``,
``fused_mha_bwd.launches`` and ``attention_delta.launches`` (the
backward's pre-pass) count kernel launches of the float32 softmax,
``fused_mha.launches_bf16sm`` and ``fused_mha_bwd.launches_bf16sm`` those
of the bf16 softmax.
"""

import ctypes
import math
from typing import Optional

import torch

from speakingstyle_torch.ops import kernels

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURE = {
    "fused_attention_fwd": (_P,) * 6 + (_I,) * 4 + (_F, _I, _I, _P),
    "fused_attention_bwd": (_P,) * 10 + (_I,) * 4 + (_F, _I, _I, _P),
    "fused_attention_bwd_delta": (_P,) * 3 + (_I,) * 5 + (_P,),
}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128
_NEG = torch.finfo(torch.float32).min / 2  # the key-padding bias


def _scores(q, k, pad_mask, sm_scale):
    """f32 scores with the key-padding bias (every padded key's score is
    the bias exactly: |q.k| * scale is far below its ulp)."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * sm_scale
    return scores.masked_fill(pad_mask[:, None, None, :], _NEG)


def fused_mha_plain(q, k, v, pad_mask, sm_scale: Optional[float] = None,
                    softmax_dtype=torch.float32):
    """The forward kernel's function in plain tensor ops (the einsum math of
    the JAX package's ``_reference_mha``): f32 scores, additive key-padding
    bias ``finfo(f32).min / 2``, softmax in ``softmax_dtype``,
    probabilities rounded to v's dtype, f32 accumulation of P.V.

    q/k/v: [B, L, H, D]; pad_mask: [B, L] True at padding. -> [B, L, H, D].
    """
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    p = torch.softmax(_scores(q, k, pad_mask, sm_scale).to(softmax_dtype), dim=-1)
    p = p.to(v.dtype).float()
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def attention_lse_plain(q, k, pad_mask, sm_scale: float, softmax_dtype=torch.float32):
    """The forward kernel's second output in plain tensor ops: each query
    row's f32 log-sum-exp (natural log) of its biased scores, rounded to
    ``softmax_dtype`` first -> [B, H, L]."""
    scores = _scores(q, k, pad_mask, sm_scale).to(softmax_dtype).float()
    return torch.logsumexp(scores, dim=-1)


def fused_mha_bwd_plain(q, k, v, pad_mask, dout, sm_scale: Optional[float] = None,
                        softmax_dtype=torch.float32):
    """The backward kernel's function in plain tensor ops: the JAX
    package's ``_bwd_kernel`` (``pallas_attention.py:92-122``) with its
    rounding points. P recomputed in f32 (softmax in ``softmax_dtype``);
    dV = dO^T P with P in v's dtype; dP = dO V^T; dS = P (dP - rowsum(dP o
    P)) sm_scale, rounded to q's dtype; dQ = dS K, dK = dS^T Q; f32 sums.
    Returns (dq, dk, dv), each [B, L, H, D] in q's dtype."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    p = torch.softmax(_scores(q, k, pad_mask, sm_scale).to(softmax_dtype), dim=-1).float()
    g = dout.float()
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(v.dtype).float(), g)
    dp = torch.einsum("bqhd,bkhd->bhqk", g, v.float())
    ds = (p * (dp - (dp * p).sum(dim=-1, keepdim=True)) * sm_scale).to(q.dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def attention_delta_plain(out, dout):
    """The backward's row term in plain tensor ops: delta[b, h, l] =
    sum_d dout[b, l, h, d] out[b, l, h, d] in f32 -> [B, H, L] float32."""
    return torch.einsum("blhd,blhd->bhl", dout.float(), out.float())


def _check_softmax(softmax_dtype) -> None:
    if softmax_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(
            f"fused_mha: softmax dtype {softmax_dtype} is not float32 or bfloat16"
        )


def check_inputs(q, k, v, pad_mask, softmax_dtype=torch.float32) -> None:
    """Raise on anything the CUDA kernels do not take."""
    B, L, H, D = q.shape
    _check_softmax(softmax_dtype)
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(
                f"fused_mha: {name} {tuple(t.shape)} {t.dtype} {t.device} does "
                f"not match q {tuple(q.shape)} {q.dtype} {q.device}"
            )
    if q.dtype not in _DTYPES:
        raise TypeError(f"fused_mha: dtype {q.dtype} is not float32 or bfloat16")
    if D % 8 or D > MAX_HEAD_DIM:
        raise ValueError(f"fused_mha: head dim {D} must be a multiple of 8 <= 128")
    if tuple(pad_mask.shape) != (B, L) or pad_mask.dtype != torch.bool \
            or pad_mask.device != q.device:
        raise ValueError(
            f"fused_mha: pad_mask must be bool [{B}, {L}] on {q.device}, got "
            f"{pad_mask.dtype} {tuple(pad_mask.shape)} on {pad_mask.device}"
        )
    for name, t in (("q", q), ("k", k), ("v", v), ("pad_mask", pad_mask)):
        if not t.is_contiguous():
            raise ValueError(f"fused_mha: {name} must be contiguous")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def fused_mha_fwd(q, k, v, pad_mask, sm_scale: float, want_lse: bool = False,
                  softmax_dtype=torch.float32):
    """Launch the forward kernel on CUDA tensors: (out, lse or None), lse
    the f32 row log-sum-exp [B, H, L] (natural log) of the scores the
    softmax saw (rounded to bf16 under the bf16 softmax), which the backward
    kernel reads. q, k and v must start on a 16-byte boundary."""
    check_inputs(q, k, v, pad_mask, softmax_dtype)
    _check_aligned("fused_mha", q=q, k=k, v=v)
    B, L, H, D = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((B, H, L), dtype=torch.float32, device=q.device) if want_lse else None
    if B == 0 or L == 0 or H == 0:
        return out, lse
    lib = kernels.load("fused_attention", _SIGNATURE)
    err = lib.fused_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pad_mask.view(torch.uint8).data_ptr(),
        out.data_ptr(), None if lse is None else lse.data_ptr(),
        B, L, H, D, float(sm_scale), _DTYPES[q.dtype], int(softmax_dtype == torch.bfloat16),
        _stream(q),
    )
    kernels.check(err, "fused_attention_fwd")
    kernels.add_flops(4 * B * H * L * L * D)  # Q K^T and P V
    if softmax_dtype == torch.bfloat16:
        fused_mha.launches_bf16sm += 1
    else:
        fused_mha.launches += 1
    return out, lse


def _check_rows(who, like, **tensors) -> None:
    """Raise unless each tensor is a contiguous twin of ``like`` (shape,
    dtype, device) that starts on a 16-byte boundary: the kernels copy rows
    in 16-byte pieces."""
    for name, t in tensors.items():
        if t.shape != like.shape or t.dtype != like.dtype or t.device != like.device \
                or not t.is_contiguous():
            raise ValueError(f"{who}: {name} must be a contiguous twin of "
                             f"{tuple(like.shape)} {like.dtype} {like.device}")
    _check_aligned(who, **tensors)


def _check_aligned(who, **tensors) -> None:
    """Raise unless each tensor starts on a 16-byte boundary."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{who}: {name} must start on a 16-byte boundary "
                             "(the kernels copy rows in 16-byte pieces)")


def attention_delta(out, dout):
    """Launch the backward's pre-pass kernel on CUDA tensors (contiguous
    16-byte-aligned twins [B, L, H, D], float32 or bfloat16, D a multiple of
    8 up to 128): delta [B, H, L] float32, as ``attention_delta_plain``."""
    B, L, H, D = out.shape
    if out.dtype not in _DTYPES or D % 8 or D > MAX_HEAD_DIM:
        raise ValueError(f"attention_delta: {out.dtype} rows of {D} are not taken")
    _check_rows("attention_delta", out, out=out, dout=dout)
    delta = torch.empty((B, H, L), dtype=torch.float32, device=out.device)
    if B == 0 or L == 0 or H == 0:
        return delta
    lib = kernels.load("fused_attention", _SIGNATURE)
    err = lib.fused_attention_bwd_delta(
        out.data_ptr(), dout.data_ptr(), delta.data_ptr(), B, L, H, D, _DTYPES[out.dtype],
        _stream(out),
    )
    kernels.check(err, "fused_attention_bwd_delta")
    attention_delta.launches += 1
    return delta


attention_delta.launches = 0


def fused_mha_bwd(q, k, v, pad_mask, out, lse, dout, sm_scale: float,
                  softmax_dtype=torch.float32):
    """Launch the backward kernels on CUDA tensors: the delta pre-pass,
    then the dK/dV and dQ passes; returns (dq, dk, dv). ``out`` and ``lse``
    are the forward kernel's, of the same ``softmax_dtype``; ``dout`` is
    out's cotangent."""
    check_inputs(q, k, v, pad_mask, softmax_dtype)
    B, L, H, D = q.shape
    _check_rows("fused_mha backward", q, q=q, k=k, v=v, out=out, dout=dout)
    if lse is None or tuple(lse.shape) != (B, H, L) or lse.dtype != torch.float32 \
            or lse.device != q.device or not lse.is_contiguous():
        raise ValueError(f"fused_mha_bwd: lse must be contiguous float32 [{B}, {H}, {L}]")
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    if B == 0 or L == 0 or H == 0:
        return dq, dk, dv
    delta = attention_delta(out, dout)
    lib = kernels.load("fused_attention", _SIGNATURE)
    err = lib.fused_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pad_mask.view(torch.uint8).data_ptr(),
        delta.data_ptr(), lse.data_ptr(), dout.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), B, L, H, D, float(sm_scale), _DTYPES[q.dtype],
        int(softmax_dtype == torch.bfloat16), _stream(q),
    )
    kernels.check(err, "fused_attention_bwd")
    kernels.add_flops(10 * B * H * L * L * D)  # S recomputed, dV, dP, dQ and dK
    if softmax_dtype == torch.bfloat16:
        fused_mha_bwd.launches_bf16sm += 1
    else:
        fused_mha_bwd.launches += 1
    return dq, dk, dv


fused_mha_bwd.launches = fused_mha_bwd.launches_bf16sm = 0


def kernel_takes_head_dim(head_dim: int) -> bool:
    """Whether the CUDA kernels take this head dim: a multiple of 8 up to
    ``MAX_HEAD_DIM``. ``fused_mha`` sends every other head dim to the plain
    versions, as the JAX package's ``fused_mha`` sends every shape outside
    its kernel's ``supported`` to ``_reference_mha``."""
    return head_dim % 8 == 0 and head_dim <= MAX_HEAD_DIM


def _runs_plain(q) -> bool:
    return q.device.type == "cpu" or not kernel_takes_head_dim(q.shape[-1])


class _FusedMHA(torch.autograd.Function):
    """Forward and backward both by kernel on CUDA, both by plain version
    on the CPU or at a head dim the kernels do not take. Where a backward
    can follow (grad mode on and an input that requires grad), the forward
    saves q, k, v, the mask, and on the kernel path the output and the row
    lse the backward kernel reads."""

    @staticmethod
    def forward(ctx, q, k, v, pad_mask, sm_scale, softmax_dtype, grad_enabled):
        ctx.sm_scale, ctx.softmax_dtype = sm_scale, softmax_dtype
        grad = grad_enabled and any(ctx.needs_input_grad[:3])
        if _runs_plain(q):
            out = fused_mha_plain(q, k, v, pad_mask, sm_scale, softmax_dtype)
            if grad:
                ctx.save_for_backward(q, k, v, pad_mask)
            return out
        out, lse = fused_mha_fwd(q, k, v, pad_mask, sm_scale, want_lse=grad,
                                 softmax_dtype=softmax_dtype)
        if grad:
            ctx.save_for_backward(q, k, v, pad_mask, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        saved = ctx.saved_tensors
        q, k, v, pad_mask = saved[:4]
        if _runs_plain(q):
            grads = fused_mha_bwd_plain(q, k, v, pad_mask, dout, ctx.sm_scale,
                                        ctx.softmax_dtype)
        else:
            grads = fused_mha_bwd(q, k, v, pad_mask, saved[4], saved[5],
                                  dout.contiguous(), ctx.sm_scale, ctx.softmax_dtype)
        return (*grads, None, None, None, None)


def fused_mha(q, k, v, pad_mask, sm_scale: Optional[float] = None,
              softmax_dtype=torch.float32):
    """Masked self-attention. q/k/v: [B, L, H, D]; pad_mask: [B, L] bool,
    True at padding. Returns [B, L, H, D] in q's dtype; differentiable in
    q, k and v.

    CPU tensors run the plain versions. CUDA tensors launch the kernels,
    which take float32 or bfloat16 and a float32 or bfloat16 softmax;
    anything else raises (the shapes, types and layout in ``fused_mha_fwd``
    / ``fused_mha_bwd``). A head dim the kernels do not take (not a
    multiple of 8, or over 128: ``kernel_takes_head_dim``) runs the plain
    versions on either device and counts no launch, as the JAX package's
    entry sends shapes outside its kernel to the einsum path.
    """
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_mha: unsupported device {q.device}")
    _check_softmax(softmax_dtype)
    return _FusedMHA.apply(q, k, v, pad_mask, float(sm_scale), softmax_dtype,
                           torch.is_grad_enabled())


fused_mha.launches = fused_mha.launches_bf16sm = 0
