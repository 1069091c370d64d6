"""Conv1d with the three impls of ``ModelConfig.conv_impl`` (JAX counterpart:
speakingstyle_tpu/ops/conv.py).

* ``"xla"``: ``torch.nn.functional.conv1d``;
* ``"unfold"``: im2col, one matmul over the stacked taps;
* ``"pallas"``: the hand-written fused conv kernel (ops/fused_conv.py), with
  the ReLU in its epilogue.

Every impl holds the same parameters, ``kernel`` [K, Cin, Cout] and
``bias`` [Cout], so ``conv_impl`` can change on loaded weights. As in the
JAX package, a K=1 conv under "xla" or "unfold" is a plain matmul; under
"pallas" it still goes through the fused kernel.
"""

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from speakingstyle_torch.ops.fused_conv import conv1d_unfold, fused_conv1d

CONV_IMPLS = ("xla", "unfold", "pallas")


class Conv1d(nn.Module):
    """SAME-padded, channel-last 1-D conv: [B, T, Cin] -> [B, T, Cout]."""

    def __init__(self, in_channels: int, features: int, kernel_size: int,
                 impl: str = "xla", dilation: int = 1, use_bias: bool = True,
                 activation: Optional[str] = None, dtype=torch.float32):
        super().__init__()
        if impl not in CONV_IMPLS:
            raise ValueError(f"conv_impl must be one of {CONV_IMPLS}, got {impl!r}")
        if activation not in (None, "relu"):
            raise ValueError(f"activation must be None|relu, got {activation!r}")
        self.impl, self.dilation, self.activation = impl, dilation, activation
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(kernel_size, in_channels, features))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x):
        x = x.to(self.dtype)
        kernel = self.kernel.to(self.dtype)
        bias = None if self.bias is None else self.bias.to(self.dtype)
        relu = self.activation == "relu"
        K = kernel.shape[0]
        if self.impl == "pallas":
            return fused_conv1d(x, kernel, bias, dilation=self.dilation, relu=relu)
        if K == 1 or self.impl == "unfold":
            y = conv1d_unfold(x, kernel, bias, dilation=self.dilation)
        else:
            y = F.conv1d(
                x.transpose(1, 2), kernel.permute(2, 1, 0), bias,
                padding="same", dilation=self.dilation,
            ).transpose(1, 2)
        return torch.relu(y) if relu else y
