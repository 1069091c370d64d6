"""Style reference encoder: mel -> FiLM conditioning vectors (gamma, beta)
(JAX counterpart: speakingstyle_tpu/models/reference_encoder.py).

3 x (conv k=3 + ReLU + LN) over the mel, padded steps zeroed, sinusoid PE,
1024 -> 256 projection, 4 FFT blocks (8 heads, no FiLM), time mean-pool,
256 -> 512 affine, split into gamma/beta [B, 1, 256]. Under
``conv_impl="pallas"`` each conv -> ReLU -> LN runs as one fused kernel
with the LN affine in the compute dtype, as in the JAX package.

The mean-pool divides by the PADDED length (the JAX package's
``true_length_mean=False``, its only setting in use), the reference's
quirk: padded frames are zeros but count in the denominator.
"""

import torch
from torch import nn

from speakingstyle_torch.models.layers import (
    LN_EPS, ConvNorm, FFTBlock, LinearNorm, layer_norm, position_table,
)
from speakingstyle_torch.ops.fused_conv import fused_conv_relu_ln
from speakingstyle_torch.ops.masking import mask_fill
from speakingstyle_torch.ops.positional import add_position_encoding


class ReferenceEncoder(nn.Module):
    def __init__(self, n_mels: int = 80, n_conv_layers: int = 3,
                 conv_filter_size: int = 1024, conv_kernel_size: int = 3,
                 n_layers: int = 4, n_head: int = 8, d_model: int = 256,
                 n_position: int = 1001, conv_impl: str = "xla", dtype=torch.float32,
                 softmax_dtype=torch.float32, attention_kernel: str = "einsum"):
        super().__init__()
        self.n_conv_layers, self.n_layers = n_conv_layers, n_layers
        self.conv_impl, self.dtype = conv_impl, dtype
        for i in range(n_conv_layers):
            cin = n_mels if i == 0 else conv_filter_size
            self.add_module(f"conv_{i}", ConvNorm(
                cin, conv_filter_size, conv_kernel_size, conv_impl=conv_impl, dtype=dtype,
            ))
            self.add_module(f"ln_{i}", nn.LayerNorm(conv_filter_size, eps=LN_EPS))
        self.register_buffer(
            "pe", position_table(n_position, conv_filter_size), persistent=False
        )
        self.fftb_linear = LinearNorm(conv_filter_size, d_model, dtype=dtype)
        for i in range(n_layers):
            self.add_module(f"fftb_{i}", FFTBlock(
                d_model, n_head, conv_filter_size, (conv_kernel_size, conv_kernel_size),
                film=False, conv_impl=conv_impl, dtype=dtype,
                softmax_dtype=softmax_dtype, attention_kernel=attention_kernel,
            ))
        self.feature_wise_affine = LinearNorm(d_model, 2 * d_model, dtype=dtype)

    def forward(self, mel, pad_mask):
        """mel [B, T, n_mels], pad_mask [B, T] -> (gammas, betas) [B, 1, d_model]."""
        x = mask_fill(mel.to(self.dtype), pad_mask)
        for i in range(self.n_conv_layers):
            conv = getattr(self, f"conv_{i}").conv
            ln = getattr(self, f"ln_{i}")
            if self.conv_impl == "pallas":
                x = fused_conv_relu_ln(
                    x, *(p.to(self.dtype) for p in (conv.kernel, conv.bias, ln.weight, ln.bias))
                )
            else:
                x = layer_norm(ln, torch.relu(conv(x)), self.dtype)
        x = mask_fill(x, pad_mask)
        x = add_position_encoding(x, self.pe)
        x = self.fftb_linear(x)
        for i in range(self.n_layers):
            x = getattr(self, f"fftb_{i}")(x, pad_mask)
        pooled = x.mean(dim=1, keepdim=True)  # over the padded length
        gammas, betas = self.feature_wise_affine(pooled).chunk(2, dim=-1)
        return gammas, betas
