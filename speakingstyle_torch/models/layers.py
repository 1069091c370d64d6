"""Core layers: post-LN transformer FFT block and conv primitives (JAX
counterpart: speakingstyle_tpu/models/layers.py).

Submodule and parameter names follow the JAX package's parameter tree
(``w_qs``, ``pos_ffn``, ``layer_norm``, ``film/s_gamma``, ...) so weights
carry across by name (compat/from_jax.py). Parameters are float32 and cast
to the compute dtype at use; LayerNorm computes in float32 and casts its
output, as Flax's does. Dropout sits where the JAX package's does (after
the attention's ``fc`` and after the conv FFN); ``deterministic=True``
(the default, as in Flax) makes it the identity, and ``rng`` (an
``ops.dropout.DropoutRNG``) feeds its masks in training.

Tensor parallelism (``parallel/partition.py``'s layout applied): every
parameter is read through ``parallel.tensor.param``, whole, gathered where
the layout splits it. Where the layout splits a Megatron pair, the
attention runs its ``n_head / tp`` heads on the rank's column slices of
q/k/v and its row slice of ``fc``, and the conv FFN its ``d_inner / tp``
filters, each ending in one all-reduce over ``tp`` before the replicated
bias; the dropout after either sees the replicated tensor.

Sequence parallelism (``attention_impl="ring"`` with a ``seq_mesh``, a
``parallel.mesh.SeqMesh``): the attention's scores run through
``parallel/ring_attention.py`` in float32, each rank on its block of the
sequence, and every other layer runs whole on every rank, as in the JAX
package (``models/layers.py:71-89``); the attention kernel is bypassed
there.
"""

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from speakingstyle_torch.ops.conv import Conv1d
from speakingstyle_torch.ops.dropout import maybe_dropout
from speakingstyle_torch.ops.fused_attention import fused_mha
from speakingstyle_torch.ops.masking import attention_bias, mask_fill
from speakingstyle_torch.parallel.tensor import (
    copy_to_tp, pair_mesh, param, reduce_from_tp, split_of,
)

LN_EPS = 1e-5


def linear(layer: nn.Linear, x, dtype):
    """``nn.Dense(dtype=...)``: input, weight and bias all in ``dtype``."""
    b = param(layer, "bias")
    b = None if b is None else b.to(dtype)
    return F.linear(x.to(dtype), param(layer, "weight").to(dtype), b)


def layer_norm(layer: nn.LayerNorm, x, dtype):
    """``nn.LayerNorm(dtype=...)``: statistics and affine in float32."""
    y = F.layer_norm(x.float(), layer.normalized_shape, param(layer, "weight"),
                     param(layer, "bias"), layer.eps)
    return y.to(dtype)


def add_bias(x, layer: nn.Module, dtype):
    """``x`` plus ``layer``'s (replicated) bias in ``dtype``, if it has one."""
    return x if layer.bias is None else x + layer.bias.to(dtype)


class FiLM(nn.Module):
    """``y = (s_gamma * gamma + 1) * x + s_beta * beta`` with learned scalar gates."""

    def __init__(self):
        super().__init__()
        self.s_gamma = nn.Parameter(torch.ones(1))
        self.s_beta = nn.Parameter(torch.ones(1))

    def forward(self, x, gammas, betas):
        g = (param(self, "s_gamma") * gammas).to(x.dtype)
        b = (param(self, "s_beta") * betas).to(x.dtype)
        return (g + 1.0) * x + b


class MultiHeadSelfAttention(nn.Module):
    """Post-LN multi-head self-attention. ``attention_kernel="fused"`` goes
    through the attention kernel (ops/fused_attention.py), ``"einsum"``
    through the plain tensor math of the JAX package's dense path; a
    ``seq_mesh`` (``attention_impl="ring"``) through ring attention, before
    either is looked at."""

    def __init__(self, n_head: int, d_model: int, dtype=torch.float32,
                 softmax_dtype=torch.float32, attention_kernel: str = "einsum",
                 attention_impl: str = "dense", dropout: float = 0.0,
                 dropout_impl: str = "hash", seq_mesh=None):
        super().__init__()
        if attention_impl not in ("dense", "ring"):
            raise ValueError(f"attention_impl must be dense|ring, got {attention_impl!r}")
        self.seq_mesh = seq_mesh
        if attention_kernel not in ("einsum", "fused"):
            raise ValueError(f"attention_kernel must be einsum|fused, got {attention_kernel!r}")
        self.n_head, self.d_model = n_head, d_model
        self.dtype, self.softmax_dtype = dtype, softmax_dtype
        self.attention_kernel = attention_kernel
        self.dropout, self.dropout_impl = dropout, dropout_impl
        for name in ("w_qs", "w_ks", "w_vs", "fc"):
            self.add_module(name, nn.Linear(d_model, d_model))
        self.layer_norm = nn.LayerNorm(d_model, eps=LN_EPS)

    def _head_mesh(self):
        """The mesh when the layout splits whole heads as a column / row
        pair (q/k/v by output, ``fc`` by input) and ``tp`` divides the
        heads; else None."""
        mesh = pair_mesh([(getattr(self, n), "weight", 0) for n in ("w_qs", "w_ks", "w_vs")],
                         (self.fc, "weight", 1))
        return mesh if mesh is not None and self.n_head % mesh.tp == 0 else None

    def forward(self, x, pad_mask, deterministic: bool = True, rng=None):
        B, L, _ = x.shape
        d_head = self.d_model // self.n_head
        residual = x
        mesh = None if self.seq_mesh is not None else self._head_mesh()
        if mesh is None:
            n_head = self.n_head
            q, k, v = (
                linear(getattr(self, n), x, self.dtype).reshape(B, L, n_head, d_head)
                for n in ("w_qs", "w_ks", "w_vs")
            )
        else:  # this rank's heads, from its column slices
            n_head, xin = self.n_head // mesh.tp, copy_to_tp(x, mesh).to(self.dtype)
            q, k, v = (
                F.linear(xin, getattr(self, n).weight.to(self.dtype),
                         getattr(self, n).bias.to(self.dtype)).reshape(B, L, n_head, d_head)
                for n in ("w_qs", "w_ks", "w_vs")
            )
        if self.seq_mesh is not None:
            from speakingstyle_torch.parallel.ring_attention import ring_self_attention

            # f32 end to end inside the ring; [B, L, H, D] -> [B, H, L, D]
            out = ring_self_attention(
                *(t.transpose(1, 2).float() for t in (q, k, v)),
                attention_bias(pad_mask, torch.float32), mesh=self.seq_mesh,
            ).transpose(1, 2).to(self.dtype)
        elif self.attention_kernel == "fused":
            out = fused_mha(q, k, v, pad_mask, softmax_dtype=self.softmax_dtype)
        else:
            # made on the device: a host tensor copied in would be a host
            # sync, which a CUDA graph capture refuses
            scale = torch.full((), math.sqrt(d_head), dtype=torch.float32,
                               device=x.device).to(self.dtype)
            logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / scale
            logits = logits.to(self.softmax_dtype) + attention_bias(
                pad_mask, self.softmax_dtype
            )
            attn = torch.softmax(logits, dim=-1).to(self.dtype)
            out = torch.einsum("bhqk,bkhd->bqhd", attn, v)
        out = out.reshape(B, L, n_head * d_head)
        if mesh is None:
            out = linear(self.fc, out, self.dtype)
        else:  # the row slice of fc, summed over tp, then its bias once
            out = reduce_from_tp(F.linear(out, self.fc.weight.to(self.dtype)), mesh)
            out = add_bias(out, self.fc, self.dtype)
        out = maybe_dropout(out, self.dropout, deterministic, rng, self.dropout_impl)
        return layer_norm(self.layer_norm, out + residual, self.dtype)


class ConvFFN(nn.Module):
    """Position-wise conv feed-forward: conv k0 + ReLU, conv k1, residual LN."""

    def __init__(self, d_model: int, d_inner: int, kernel_sizes: Tuple[int, int],
                 conv_impl: str = "xla", dtype=torch.float32, dropout: float = 0.0,
                 dropout_impl: str = "hash"):
        super().__init__()
        self.dtype = dtype
        self.dropout, self.dropout_impl = dropout, dropout_impl
        self.w_1 = Conv1d(d_model, d_inner, kernel_sizes[0], impl=conv_impl,
                          activation="relu", dtype=dtype)
        self.w_2 = Conv1d(d_inner, d_model, kernel_sizes[1], impl=conv_impl, dtype=dtype)
        self.layer_norm = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, x, deterministic: bool = True, rng=None):
        mesh = pair_mesh([(self.w_1, "kernel", 2)], (self.w_2, "kernel", 1))
        if mesh is None:
            h = self.w_2(self.w_1(x))
        else:  # this rank's d_inner / tp filters, then the row slice of w_2
            h = self.w_1.run(copy_to_tp(x, mesh), self.w_1.kernel, self.w_1.bias)
            h = reduce_from_tp(self.w_2.run(h, self.w_2.kernel, None), mesh)
            h = add_bias(h, self.w_2, self.dtype)
        h = maybe_dropout(h, self.dropout, deterministic, rng, self.dropout_impl)
        return layer_norm(self.layer_norm, h + x, self.dtype)


class FFTBlock(nn.Module):
    """Self-attention + conv FFN + optional FiLM, padded steps re-zeroed."""

    def __init__(self, d_model: int, n_head: int, d_inner: int,
                 kernel_sizes: Tuple[int, int], film: bool = True,
                 conv_impl: str = "xla", dtype=torch.float32,
                 softmax_dtype=torch.float32, attention_kernel: str = "einsum",
                 attention_impl: str = "dense", dropout: float = 0.0,
                 dropout_impl: str = "hash", seq_mesh=None):
        super().__init__()
        self.slf_attn = MultiHeadSelfAttention(
            n_head, d_model, dtype=dtype, softmax_dtype=softmax_dtype,
            attention_kernel=attention_kernel, attention_impl=attention_impl,
            dropout=dropout, dropout_impl=dropout_impl, seq_mesh=seq_mesh,
        )
        self.pos_ffn = ConvFFN(d_model, d_inner, kernel_sizes, conv_impl=conv_impl, dtype=dtype,
                               dropout=dropout, dropout_impl=dropout_impl)
        self.film = FiLM() if film else None

    def forward(self, x, pad_mask, gammas=None, betas=None, deterministic: bool = True,
                rng=None):
        x = mask_fill(self.slf_attn(x, pad_mask, deterministic, rng), pad_mask)
        x = self.pos_ffn(x, deterministic, rng)
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
    """Projection without bias, as a child named ``linear``. Where the
    tensor-parallel layout splits its kernel by input (row parallel), each
    rank projects its slice of the input channels and the partial sums are
    all-reduced over ``tp``."""

    def __init__(self, in_features: int, out_features: int, use_bias: bool = False,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.linear = nn.Linear(in_features, out_features, bias=use_bias)

    def forward(self, x):
        lin = self.linear
        if split_of(lin, "weight") != 1 or split_of(lin, "bias") is not None:
            return linear(lin, x, self.dtype)
        mesh, n = lin.tp_mesh, lin.weight.shape[1]
        xl = copy_to_tp(x, mesh).narrow(-1, mesh.tp_rank * n, n).to(self.dtype)
        y = reduce_from_tp(F.linear(xl, lin.weight.to(self.dtype)), mesh)
        return add_bias(y, lin, self.dtype)


def position_table(n_position: int, d: int) -> torch.Tensor:
    """The sinusoid table as a float32 tensor (a non-persistent buffer in
    the modules that add it)."""
    from speakingstyle_torch.ops.positional import sinusoid_position_table

    return torch.from_numpy(sinusoid_position_table(n_position, d))
