"""Mask construction helpers (JAX counterpart: speakingstyle_tpu/ops/masking.py).

Masks are True at PADDING positions.
"""

import torch


def length_to_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """[B] lengths -> [B, max_len] bool mask, True where position >= length."""
    ids = torch.arange(max_len, device=lengths.device, dtype=lengths.dtype)[None, :]
    return ids >= lengths[:, None]


def attention_bias(pad_mask: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """[B, L] padding mask -> [B, 1, 1, L] additive bias for attention logits.

    Padded keys get ``finfo(dtype).min / 2``, not -inf: a fully padded row
    then softmaxes to a finite uniform row instead of NaN.
    """
    neg = torch.tensor(torch.finfo(dtype).min / 2, dtype=dtype, device=pad_mask.device)
    zero = torch.zeros((), dtype=dtype, device=pad_mask.device)
    return torch.where(pad_mask[:, None, None, :], neg, zero)


def mask_fill(x: torch.Tensor, pad_mask: torch.Tensor, value: float = 0.0) -> torch.Tensor:
    """Zero (or fill) padded time steps. x: [B, L, H], pad_mask: [B, L]."""
    return x.masked_fill(pad_mask[..., None], value)
