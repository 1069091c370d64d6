"""Core layers: post-LN transformer FFT block and conv primitives (JAX
counterpart: speakingstyle_tpu/models/layers.py).

Submodule and parameter names follow the JAX package's parameter tree
(``w_qs``, ``pos_ffn``, ``layer_norm``, ``film/s_gamma``, ...) so weights
carry across by name (compat/from_jax.py). Parameters are float32 and cast
to the compute dtype at use; LayerNorm computes in float32 and casts its
output, as Flax's does. Dropout is the identity at inference and is not
modelled.
"""

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from speakingstyle_torch.ops.conv import Conv1d
from speakingstyle_torch.ops.fused_attention import fused_mha
from speakingstyle_torch.ops.masking import attention_bias, mask_fill

LN_EPS = 1e-5


def linear(layer: nn.Linear, x, dtype):
    """``nn.Dense(dtype=...)``: input, weight and bias all in ``dtype``."""
    b = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), b)


def layer_norm(layer: nn.LayerNorm, x, dtype):
    """``nn.LayerNorm(dtype=...)``: statistics and affine in float32."""
    y = F.layer_norm(x.float(), layer.normalized_shape, layer.weight, layer.bias, layer.eps)
    return y.to(dtype)


class FiLM(nn.Module):
    """``y = (s_gamma * gamma + 1) * x + s_beta * beta`` with learned scalar gates."""

    def __init__(self):
        super().__init__()
        self.s_gamma = nn.Parameter(torch.ones(1))
        self.s_beta = nn.Parameter(torch.ones(1))

    def forward(self, x, gammas, betas):
        g = (self.s_gamma * gammas).to(x.dtype)
        b = (self.s_beta * betas).to(x.dtype)
        return (g + 1.0) * x + b


class MultiHeadSelfAttention(nn.Module):
    """Post-LN multi-head self-attention. ``attention_kernel="fused"`` goes
    through the attention kernel (ops/fused_attention.py), ``"einsum"``
    through the plain tensor math of the JAX package's dense path."""

    def __init__(self, n_head: int, d_model: int, dtype=torch.float32,
                 softmax_dtype=torch.float32, attention_kernel: str = "einsum",
                 attention_impl: str = "dense"):
        super().__init__()
        if attention_impl != "dense":
            raise NotImplementedError(
                f"attention_impl={attention_impl!r}: the sequence-parallel ring "
                "is not ported yet"
            )
        if attention_kernel not in ("einsum", "fused"):
            raise ValueError(f"attention_kernel must be einsum|fused, got {attention_kernel!r}")
        self.n_head, self.d_model = n_head, d_model
        self.dtype, self.softmax_dtype = dtype, softmax_dtype
        self.attention_kernel = attention_kernel
        for name in ("w_qs", "w_ks", "w_vs", "fc"):
            self.add_module(name, nn.Linear(d_model, d_model))
        self.layer_norm = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, x, pad_mask):
        B, L, _ = x.shape
        d_head = self.d_model // self.n_head
        residual = x
        q, k, v = (
            linear(getattr(self, n), x, self.dtype).reshape(B, L, self.n_head, d_head)
            for n in ("w_qs", "w_ks", "w_vs")
        )
        if self.attention_kernel == "fused":
            out = fused_mha(q, k, v, pad_mask, softmax_dtype=self.softmax_dtype)
        else:
            scale = torch.tensor(math.sqrt(d_head), dtype=torch.float32).to(self.dtype)
            logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / scale.to(x.device)
            logits = logits.to(self.softmax_dtype) + attention_bias(
                pad_mask, self.softmax_dtype
            )
            attn = torch.softmax(logits, dim=-1).to(self.dtype)
            out = torch.einsum("bhqk,bkhd->bqhd", attn, v)
        out = linear(self.fc, out.reshape(B, L, self.d_model), self.dtype)
        return layer_norm(self.layer_norm, out + residual, self.dtype)


class ConvFFN(nn.Module):
    """Position-wise conv feed-forward: conv k0 + ReLU, conv k1, residual LN."""

    def __init__(self, d_model: int, d_inner: int, kernel_sizes: Tuple[int, int],
                 conv_impl: str = "xla", dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.w_1 = Conv1d(d_model, d_inner, kernel_sizes[0], impl=conv_impl,
                          activation="relu", dtype=dtype)
        self.w_2 = Conv1d(d_inner, d_model, kernel_sizes[1], impl=conv_impl, dtype=dtype)
        self.layer_norm = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, x):
        h = self.w_2(self.w_1(x))
        return layer_norm(self.layer_norm, h + x, self.dtype)


class FFTBlock(nn.Module):
    """Self-attention + conv FFN + optional FiLM, padded steps re-zeroed."""

    def __init__(self, d_model: int, n_head: int, d_inner: int,
                 kernel_sizes: Tuple[int, int], film: bool = True,
                 conv_impl: str = "xla", dtype=torch.float32,
                 softmax_dtype=torch.float32, attention_kernel: str = "einsum",
                 attention_impl: str = "dense"):
        super().__init__()
        self.slf_attn = MultiHeadSelfAttention(
            n_head, d_model, dtype=dtype, softmax_dtype=softmax_dtype,
            attention_kernel=attention_kernel, attention_impl=attention_impl,
        )
        self.pos_ffn = ConvFFN(d_model, d_inner, kernel_sizes, conv_impl=conv_impl, dtype=dtype)
        self.film = FiLM() if film else None

    def forward(self, x, pad_mask, gammas=None, betas=None):
        x = mask_fill(self.slf_attn(x, pad_mask), pad_mask)
        x = self.pos_ffn(x)
        if self.film is not None and gammas is not None and betas is not None:
            x = self.film(x, gammas, betas)
        return mask_fill(x, pad_mask)


class ConvNorm(nn.Module):
    """1-D conv over time, channel-last, as a child named ``conv``."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 1,
                 dilation: int = 1, conv_impl: str = "xla", dtype=torch.float32):
        super().__init__()
        self.conv = Conv1d(in_channels, out_channels, kernel_size, impl=conv_impl,
                           dilation=dilation, dtype=dtype)

    def forward(self, x):
        return self.conv(x)


class LinearNorm(nn.Module):
    """Projection without bias, as a child named ``linear``."""

    def __init__(self, in_features: int, out_features: int, use_bias: bool = False,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.linear = nn.Linear(in_features, out_features, bias=use_bias)

    def forward(self, x):
        return linear(self.linear, x, self.dtype)


def position_table(n_position: int, d: int) -> torch.Tensor:
    """The sinusoid table as a float32 tensor (a non-persistent buffer in
    the modules that add it)."""
    from speakingstyle_torch.ops.positional import sinusoid_position_table

    return torch.from_numpy(sinusoid_position_table(n_position, d))
