"""MelGAN generator, the reference's alternative vocoder (JAX counterpart:
speakingstyle_tpu/models/melgan.py).

The reference loads it from torch.hub at run time (reference:
utils/model.py:64-74, ``descriptinc/melgan-neurips`` ``load_melgan``) and
feeds it **log10** mels: ``vocoder.inverse(mels / np.log(10))``
(reference: utils/model.py:101-102). ``MelGANGenerator.forward`` takes the
acoustic model's natural-log mels and applies that scaling itself, as the
JAX package's ``vocode`` does, so the engine drives it like HiFi-GAN.

Architecture (descript mel2wav/modules.py): reflection-padded conv k=7 ->
4 x [LeakyReLU(0.2) -> ConvTranspose1d(k=2r, stride=r) -> n dilated
ResnetBlocks (dilations 3^j, reflection padding, 1x1 shortcut)] ->
LeakyReLU -> reflection-padded conv k=7 -> tanh. Hub checkpoints use
ngf=32, 3 residual layers, ratios (8, 8, 2, 2): 256x upsampling. Weights
load through ``compat.torch_convert.convert_melgan`` (weight norm folded)
and ``compat.from_jax.load_flax_variables``; the convs are ``F.conv1d`` /
``F.conv_transpose1d`` (the JAX package leaves them to XLA).
"""

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from speakingstyle_torch.models.hifigan import ConvWeights, TorchConvTranspose1d

MELGAN_LRELU_SLOPE = 0.2
LOG10 = math.log(10.0)


class ReflectConv1d(nn.Module):
    """Reflection-padded conv1d (descript's ReflectionPad1d + WNConv1d
    pair, weight norm folded at conversion); [B, C, T] layout."""

    def __init__(self, cin: int, cout: int, kernel_size: int, dilation: int = 1):
        super().__init__()
        self.dilation = dilation
        self.pad = dilation * (kernel_size - 1) // 2
        self.conv = ConvWeights(cin, cout, kernel_size)

    def forward(self, x):
        if self.pad:
            x = F.pad(x, (self.pad, self.pad), mode="reflect")
        return F.conv1d(x, self.conv.weight, self.conv.bias, dilation=self.dilation)


class MelGANResBlock(nn.Module):
    """descript ResnetBlock: LeakyReLU -> dilated k=3 conv -> LeakyReLU ->
    1x1 conv, plus a 1x1 shortcut."""

    def __init__(self, dim: int, dilation: int):
        super().__init__()
        self.conv1 = ReflectConv1d(dim, dim, 3, dilation)
        self.conv2 = ReflectConv1d(dim, dim, 1)
        self.shortcut = ReflectConv1d(dim, dim, 1)

    def forward(self, x):
        y = self.conv1(F.leaky_relu(x, MELGAN_LRELU_SLOPE))
        y = self.conv2(F.leaky_relu(y, MELGAN_LRELU_SLOPE))
        return self.shortcut(x) + y


class MelGANGenerator(nn.Module):
    """natural-log mel [B, T, n_mels] -> wav [B, T * prod(ratios)] float32."""

    def __init__(self, n_mels: int = 80, ngf: int = 32, n_residual_layers: int = 3,
                 ratios: Sequence[int] = (8, 8, 2, 2)):
        super().__init__()
        self.ratios, self.n_res = tuple(ratios), n_residual_layers
        self.hop_factor = math.prod(self.ratios)
        mult = 2 ** len(self.ratios)
        self.conv_pre = ReflectConv1d(n_mels, mult * ngf, 7)
        for i, r in enumerate(self.ratios):
            ch = mult * ngf // 2
            # descript layout: odd upsample ratios land at L * r too
            self.add_module(f"ups_{i}", TorchConvTranspose1d(
                mult * ngf, ch, 2 * r, r, padding=r // 2 + r % 2, output_padding=r % 2))
            for j in range(n_residual_layers):
                self.add_module(f"res_{i}_{j}", MelGANResBlock(ch, 3 ** j))
            mult //= 2
        self.conv_post = ReflectConv1d(mult * ngf, 1, 7)

    def forward(self, mel):
        x = self.conv_pre((mel.float() / LOG10).transpose(1, 2))
        for i in range(len(self.ratios)):
            x = getattr(self, f"ups_{i}")(F.leaky_relu(x, MELGAN_LRELU_SLOPE))
            for j in range(self.n_res):
                x = getattr(self, f"res_{i}_{j}")(x)
        x = self.conv_post(F.leaky_relu(x, MELGAN_LRELU_SLOPE))
        return torch.tanh(x)[:, 0, :]
