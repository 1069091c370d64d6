"""Fused masked self-attention: the wrapper of the Hopper kernel and its
plain PyTorch version.

The kernel (``csrc/fused_attention.cu``) replaces the TPU kernel
``speakingstyle_tpu/ops/pallas_attention.py::_fwd_kernel`` (reached there
through ``fused_mha``). What bounds it on the H100, and what its design does
about that, is written at the top of the CUDA source: the TPU kernel's whole
T x T score tile does not fit in shared memory, so the port streams key
tiles with an online softmax.

``fused_mha`` is the entry point the model calls. A CPU tensor goes to
``fused_mha_plain``; a CUDA tensor goes to the kernel, or the call raises.
``fused_mha.launches`` counts kernel launches.
"""

import ctypes
import math
from typing import Optional

import torch

from speakingstyle_torch.ops import kernels

_SIGNATURE = {
    "fused_attention_fwd": (
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    )
}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128


def fused_mha_plain(q, k, v, pad_mask, sm_scale: Optional[float] = None,
                    softmax_dtype=torch.float32):
    """The kernel's function in plain tensor ops (the einsum math of the
    JAX package's ``_reference_mha``): f32 scores, additive key-padding
    bias ``finfo(f32).min / 2``, softmax in ``softmax_dtype``,
    probabilities rounded to v's dtype, f32 accumulation of P.V.

    q/k/v: [B, L, H, D]; pad_mask: [B, L] True at padding. -> [B, L, H, D].
    """
    D = q.shape[-1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * sm_scale
    neg = torch.finfo(torch.float32).min / 2
    scores = scores.masked_fill(pad_mask[:, None, None, :], neg)
    p = torch.softmax(scores.to(softmax_dtype), dim=-1)
    p = p.to(v.dtype).float()
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def check_inputs(q, k, v, pad_mask, softmax_dtype=torch.float32) -> None:
    """Raise on anything the CUDA kernel does not take."""
    B, L, H, D = q.shape
    if softmax_dtype != torch.float32:
        raise NotImplementedError(
            "fused_mha: the CUDA kernel computes the softmax in float32 only"
        )
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


def fused_mha(q, k, v, pad_mask, sm_scale: Optional[float] = None,
              softmax_dtype=torch.float32):
    """Masked self-attention. q/k/v: [B, L, H, D]; pad_mask: [B, L] bool,
    True at padding. Returns [B, L, H, D] in q's dtype.

    CPU tensors run ``fused_mha_plain``. CUDA tensors launch the kernel,
    which takes float32 or bfloat16, head dims that are multiples of 8 up
    to 128, and a float32 softmax; anything else raises.
    """
    B, L, H, D = q.shape
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    if q.device.type == "cpu":
        return fused_mha_plain(q, k, v, pad_mask, sm_scale, softmax_dtype)
    if q.device.type != "cuda":
        raise ValueError(f"fused_mha: unsupported device {q.device}")
    check_inputs(q, k, v, pad_mask, softmax_dtype)
    mask = pad_mask.view(torch.uint8)
    out = torch.empty_like(q)
    if B == 0 or L == 0 or H == 0:
        return out
    lib = kernels.load("fused_attention", _SIGNATURE)
    err = lib.fused_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), out.data_ptr(),
        B, L, H, D, float(sm_scale), _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    kernels.check(err, "fused_attention_fwd")
    fused_mha.launches += 1
    return out


fused_mha.launches = 0
