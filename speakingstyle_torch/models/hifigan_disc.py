"""HiFi-GAN discriminators and GAN losses, for vocoder training (JAX
counterpart: speakingstyle_tpu/models/hifigan_disc.py).

* ``MultiPeriodDiscriminator``: one stack of (5, 1) 2-D convs per period
  (2, 3, 5, 7, 11) over the waveform reflect-padded to a multiple of the
  period and folded to [B, 1, T / p, p].
* ``MultiScaleDiscriminator``: 3 scales of grouped 1-D convs over the raw,
  x2- and x4-average-pooled waveform; the first scale spectral-normalised.

Losses: least-squares GAN, feature matching (x2) (reference:
hifigan/models.py:231-263). The convs are ``F.conv1d`` / ``F.conv2d``: the
JAX package leaves them to XLA and has no TPU kernel for them. Weights are
stored in torch's layout; compat/from_jax.py transposes the Flax kernels
([k, 1, in, out] and [k, in / groups, out]) on the way in. Feature maps are
NCHW / NCL, the JAX package's NHWC / NLC transposed.

``SpectralNorm`` is Flax 0.12's ``nn.SpectralNorm``, not
``torch.nn.utils.parametrizations.spectral_norm``: one power iteration on
every call from the stored ``u`` (stored back, with ``sigma``, only with
``update_stats``), the kernel matricised to [k * in / groups, out], u and v
held constant in the gradient, W divided by sigma = v W u^T.
"""

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from speakingstyle_torch.models.hifigan import LRELU_SLOPE, ConvWeights

# (features, kernel, stride, groups) of each conv of a scale
# discriminator: the reference's DiscriminatorS (hifigan/models.py:185-196)
SCALE_SPEC = ((128, 15, 1, 1), (128, 41, 2, 4), (256, 41, 2, 16), (512, 41, 4, 16),
              (1024, 41, 4, 16), (1024, 41, 1, 16), (1024, 5, 1, 1))
PERIOD_CHANNELS = (32, 128, 512, 1024, 1024)


class Conv2dWeights(nn.Module):
    """``weight`` [Cout, Cin, K, 1] and ``bias`` of one (K, 1) 2-D conv;
    the Flax ``kernel`` [K, 1, Cin, Cout] maps onto ``weight`` transposed."""

    FLAX_LEAVES = {"kernel": ("weight", (3, 2, 0, 1)), "bias": ("bias", None)}
    FAN_IN_DIMS = (1, 2, 3)

    def __init__(self, cin: int, cout: int, k: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, k, 1))
        self.bias = nn.Parameter(torch.zeros(cout))


def _l2_normalize(x: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).sum() + eps)


class SpectralNorm(nn.Module):
    """The power-iteration state (``u`` [1, out], ``sigma``) of one
    layer's kernel, in the Flax ``batch_stats`` layout (``SpectralNorm_<i>``
    holding the keys ``"<layer>/kernel/u"`` and ``".../sigma"``); ``forward(weight,
    update_stats)`` returns the kernel divided by its spectral norm."""

    def __init__(self, layer_name: str, n_out: int, eps: float = 1e-12):
        super().__init__()
        self.eps = eps
        self.register_buffer("u", torch.zeros(1, n_out))
        self.register_buffer("sigma", torch.ones(()))
        self.FLAX_LEAVES = {f"{layer_name}/kernel/{leaf}": (leaf, None, "batch_stats")
                            for leaf in ("u", "sigma")}

    def forward(self, weight: torch.Tensor, update_stats: bool) -> torch.Tensor:
        # Flax's matrix of a [k, in/g, out] kernel: [k * in/g, out]
        w = weight.permute(2, 1, 0).reshape(-1, weight.shape[0]).float()
        with torch.no_grad():
            v = _l2_normalize(self.u @ w.T, self.eps)
            u = _l2_normalize(v @ w, self.eps)
        sigma = (v @ w @ u.T)[0, 0]
        if update_stats:
            self.u.copy_(u)
            self.sigma.copy_(sigma.detach())
        return weight / torch.where(sigma != 0, sigma, torch.ones_like(sigma))


class PeriodDiscriminator(nn.Module):
    """wav [B, T] -> (scores [B, -1], feature maps [B, C, T / p, p])."""

    def __init__(self, period: int, channels: Sequence[int] = PERIOD_CHANNELS,
                 kernel_size: int = 5, stride: int = 3):
        super().__init__()
        self.period, self.k, self.stride, self.n = period, kernel_size, stride, len(channels)
        cin = 1
        for i, ch in enumerate(channels):
            self.add_module(f"convs_{i}", Conv2dWeights(cin, ch, kernel_size))
            cin = ch
        self.conv_post = Conv2dWeights(cin, 1, 3)

    def forward(self, x) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        B, T = x.shape
        p = self.period
        pad = (-T) % p
        if pad:
            x = F.pad(x[:, None], (0, pad), mode="reflect")[:, 0]
        x = x.float().reshape(B, 1, (T + pad) // p, p)
        fmaps = []
        for i in range(self.n):
            c = getattr(self, f"convs_{i}")
            stride = self.stride if i < self.n - 1 else 1
            x = F.leaky_relu(F.conv2d(x, c.weight, c.bias, stride=(stride, 1),
                                      padding=(self.k // 2, 0)), LRELU_SLOPE)
            fmaps.append(x)
        x = F.conv2d(x, self.conv_post.weight, self.conv_post.bias, padding=(1, 0))
        fmaps.append(x)
        return x.reshape(B, -1), fmaps


class ScaleDiscriminator(nn.Module):
    """Grouped 1-D conv stack over a waveform [B, T] -> (scores [B, -1],
    feature maps [B, C, T']); ``use_spectral_norm`` normalises every conv,
    one power-iteration step per call (stored with ``update_stats``)."""

    def __init__(self, use_spectral_norm: bool = False):
        super().__init__()
        self.use_spectral_norm = use_spectral_norm
        self.layers = []  # (name, kernel, stride, groups)
        cin = 1
        for i, (ch, k, s, g) in enumerate(SCALE_SPEC + ((1, 3, 1, 1),)):
            name = "conv_post" if i == len(SCALE_SPEC) else f"convs_{i}"
            self.add_module(name, ConvWeights(cin // g, ch, k))
            if use_spectral_norm:
                self.add_module(f"SpectralNorm_{i}", SpectralNorm(name, ch))
            self.layers.append((name, k, s, g))
            cin = ch

    def forward(self, x, update_stats: bool = False) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        B = x.shape[0]
        x = x.float()[:, None]
        fmaps = []
        for i, (name, k, s, g) in enumerate(self.layers):
            c = getattr(self, name)
            w = c.weight
            if self.use_spectral_norm:
                w = getattr(self, f"SpectralNorm_{i}")(w, update_stats)
            x = F.conv1d(x, w, c.bias, stride=s, padding=k // 2, groups=g)
            if name != "conv_post":
                x = F.leaky_relu(x, LRELU_SLOPE)
            fmaps.append(x)
        return x.reshape(B, -1), fmaps


def _avg_pool1d(x: torch.Tensor) -> torch.Tensor:
    """AvgPool1d(4, 2, padding=2) over [B, T], the zero padding counted."""
    return F.avg_pool1d(x[:, None], 4, 2, padding=2, count_include_pad=True)[:, 0]


class MultiPeriodDiscriminator(nn.Module):
    def __init__(self, periods: Sequence[int] = (2, 3, 5, 7, 11),
                 channels: Sequence[int] = PERIOD_CHANNELS):
        super().__init__()
        self.n = len(periods)
        for i, p in enumerate(periods):
            self.add_module(f"discriminators_{i}", PeriodDiscriminator(p, channels))

    def forward(self, y, y_hat):
        outs_r, outs_g, fmaps_r, fmaps_g = [], [], [], []
        for i in range(self.n):
            d = getattr(self, f"discriminators_{i}")
            o_r, f_r = d(y)
            o_g, f_g = d(y_hat)
            outs_r.append(o_r)
            outs_g.append(o_g)
            fmaps_r.append(f_r)
            fmaps_g.append(f_g)
        return outs_r, outs_g, fmaps_r, fmaps_g


class MultiScaleDiscriminator(nn.Module):
    """Scales over the raw and the pooled waveforms; the first one
    spectral-normalised (torch: spectral_norm on the first scale only).
    Each scale runs on ``y``, then on ``y_hat``: with ``update_stats`` the
    second pass iterates from the ``u`` the first stored."""

    def __init__(self, n_scales: int = 3):
        super().__init__()
        self.n = n_scales
        for i in range(n_scales):
            self.add_module(f"discriminators_{i}", ScaleDiscriminator(use_spectral_norm=i == 0))

    def forward(self, y, y_hat, update_stats: bool = False):
        outs_r, outs_g, fmaps_r, fmaps_g = [], [], [], []
        for i in range(self.n):
            d = getattr(self, f"discriminators_{i}")
            o_r, f_r = d(y, update_stats)
            o_g, f_g = d(y_hat, update_stats)
            outs_r.append(o_r)
            outs_g.append(o_g)
            fmaps_r.append(f_r)
            fmaps_g.append(f_g)
            y, y_hat = _avg_pool1d(y), _avg_pool1d(y_hat)
        return outs_r, outs_g, fmaps_r, fmaps_g


@torch.no_grad()
def init_spectral_stats(module: nn.Module, seed: int = 0) -> nn.Module:
    """Every ``SpectralNorm``'s ``u`` from a normal draw of ``seed`` and its
    ``sigma`` 1, as Flax initialises them."""
    g = torch.Generator().manual_seed(seed)
    for m in module.modules():
        if isinstance(m, SpectralNorm):
            m.u.copy_(torch.randn(m.u.shape, generator=g))
            m.sigma.fill_(1.0)
    return module


# ---------------------------------------------------------------- losses


def discriminator_loss(outs_real, outs_gen) -> torch.Tensor:
    """LSGAN: mean((1 - D(y))^2) + mean(D(y_hat)^2), summed over heads."""
    loss = 0.0
    for dr, dg in zip(outs_real, outs_gen):
        loss = loss + torch.mean((1.0 - dr) ** 2) + torch.mean(dg ** 2)
    return loss


def generator_adversarial_loss(outs_gen) -> torch.Tensor:
    """LSGAN generator side: mean((1 - D(y_hat))^2) summed over heads."""
    loss = 0.0
    for dg in outs_gen:
        loss = loss + torch.mean((1.0 - dg) ** 2)
    return loss


def feature_matching_loss(fmaps_real, fmaps_gen) -> torch.Tensor:
    """L1 between real and generated feature maps, x2 (reference weighting)."""
    loss = 0.0
    for fr_list, fg_list in zip(fmaps_real, fmaps_gen):
        for fr, fg in zip(fr_list, fg_list):
            loss = loss + torch.mean(torch.abs(fr - fg))
    return 2.0 * loss
