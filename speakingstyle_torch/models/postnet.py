"""PostNet mel refiner: 5 conv1d(512, k=5) + BatchNorm, tanh on all but the
last (JAX counterpart: speakingstyle_tpu/models/postnet.py). Inference
only: BatchNorm runs at its running statistics."""

import torch
from torch import nn

from speakingstyle_torch.ops.conv import Conv1d


class BatchNorm(nn.Module):
    """Channel-last BatchNorm at running statistics, in float32 with the
    output cast to the compute dtype (Flax's ``use_running_average=True``).
    Parameters ``scale``/``bias``, buffers ``mean``/``var``: the JAX
    package's names."""

    def __init__(self, features: int, eps: float = 1e-5, dtype=torch.float32):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x):
        mul = torch.rsqrt(self.var + self.eps) * self.scale
        return ((x.float() - self.mean) * mul + self.bias).to(self.dtype)


class PostNet(nn.Module):
    def __init__(self, n_mel_channels: int = 80, embedding_dim: int = 512,
                 kernel_size: int = 5, n_convolutions: int = 5, conv_impl: str = "xla",
                 dtype=torch.float32):
        super().__init__()
        self.n, self.dtype = n_convolutions, dtype
        for i in range(n_convolutions):
            cin = n_mel_channels if i == 0 else embedding_dim
            cout = n_mel_channels if i == n_convolutions - 1 else embedding_dim
            self.add_module(f"conv_{i}", Conv1d(cin, cout, kernel_size, impl=conv_impl, dtype=dtype))
            self.add_module(f"bn_{i}", BatchNorm(cout, dtype=dtype))

    def forward(self, mel, keep_mask=None):
        """mel [B, T, n_mels] -> residual [B, T, n_mels]. ``keep_mask``
        ([T] or [B, T], True = real frame) re-zeroes every layer's output at
        masked frames: the free-running parity rule of the JAX package."""
        x = mel.to(self.dtype)
        if keep_mask is not None and keep_mask.dim() == 1:
            keep_mask = keep_mask[None, :]
        for i in range(self.n):
            x = getattr(self, f"bn_{i}")(getattr(self, f"conv_{i}")(x))
            if i < self.n - 1:
                x = torch.tanh(x)
            if keep_mask is not None:
                x = x.masked_fill(~keep_mask[..., None], 0.0)
        return x
