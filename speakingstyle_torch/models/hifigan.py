"""HiFi-GAN generator (mel -> waveform vocoder) as a torch module (JAX
counterpart: speakingstyle_tpu/models/hifigan.py).

conv_pre(512, k7) -> 4 x [transposed-conv upsample (rates 8,8,2,2 /
kernels 16,16,4,4) + multi-receptive-field fusion of 3 ResBlocks
(k=3,7,11; dilations 1,3,5)] -> conv_post -> tanh; LeakyReLU slope 0.1.
The convs are ``F.conv1d`` / ``F.conv_transpose1d``: the JAX package
leaves them to XLA and has no TPU kernel for them. Weights are stored in
torch's layout (weight norm already folded); compat/from_jax.py transposes
the JAX package's ``[K, Cin, Cout]`` kernels on the way in.
"""

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

LRELU_SLOPE = 0.1

# The pretrained LJSpeech/universal generators' hyperparameters
# (hifigan/config.json: 22050 Hz, hop 256, 80 mels).
DEFAULT_HIFIGAN_CONFIG = {
    "resblock": "1",
    "upsample_rates": [8, 8, 2, 2],
    "upsample_kernel_sizes": [16, 16, 4, 4],
    "upsample_initial_channel": 512,
    "resblock_kernel_sizes": [3, 7, 11],
    "resblock_dilation_sizes": [[1, 3, 5], [1, 3, 5], [1, 3, 5]],
}


class ConvWeights(nn.Module):
    """``weight`` [Cout, Cin, K] and ``bias`` [Cout] of one conv; the JAX
    package's ``nn.Conv`` leaf ``kernel`` [K, Cin, Cout] maps onto
    ``weight`` transposed."""

    FLAX_LEAVES = {"kernel": ("weight", (2, 1, 0)), "bias": ("bias", None)}
    FAN_IN_DIMS = (1, 2)

    def __init__(self, cin: int, cout: int, k: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, k))
        self.bias = nn.Parameter(torch.zeros(cout))


class TorchConv1d(nn.Module):
    """Conv1d with torch padding: (k*d - d) // 2 per side; [B, C, T] layout."""

    def __init__(self, cin: int, cout: int, kernel_size: int, dilation: int = 1):
        super().__init__()
        self.dilation = dilation
        self.pad = (kernel_size * dilation - dilation) // 2
        self.conv = ConvWeights(cin, cout, kernel_size)

    def forward(self, x):
        return F.conv1d(x, self.conv.weight, self.conv.bias, padding=self.pad,
                        dilation=self.dilation)


class TorchConvTranspose1d(nn.Module):
    """ConvTranspose1d(stride=u, padding=(k-u)//2); ``kernel`` is torch's
    [in, out, k] layout in both packages."""

    FLAX_LEAVES = {"kernel": ("kernel", None), "bias": ("bias", None)}
    INIT_STD = 0.01

    def __init__(self, cin: int, cout: int, kernel_size: int, stride: int,
                 padding: Optional[int] = None, output_padding: int = 0):
        super().__init__()
        self.stride, self.output_padding = stride, output_padding
        self.padding = (kernel_size - stride) // 2 if padding is None else padding
        self.kernel = nn.Parameter(torch.empty(cin, cout, kernel_size))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        return F.conv_transpose1d(x, self.kernel, self.bias, stride=self.stride,
                                  padding=self.padding, output_padding=self.output_padding)


class ResBlock(nn.Module):
    """MRF residual block, resblock "1": dilated + plain conv pairs."""

    def __init__(self, channels: int, kernel_size: int = 3,
                 dilations: Tuple[int, ...] = (1, 3, 5)):
        super().__init__()
        self.n = len(dilations)
        for i, d in enumerate(dilations):
            self.add_module(f"convs1_{i}", TorchConv1d(channels, channels, kernel_size, d))
            self.add_module(f"convs2_{i}", TorchConv1d(channels, channels, kernel_size, 1))

    def forward(self, x):
        for i in range(self.n):
            y = getattr(self, f"convs1_{i}")(F.leaky_relu(x, LRELU_SLOPE))
            x = x + getattr(self, f"convs2_{i}")(F.leaky_relu(y, LRELU_SLOPE))
        return x


class ResBlock2(nn.Module):
    """The lighter MRF block of the HiFi-GAN V3 config: one conv per dilation."""

    def __init__(self, channels: int, kernel_size: int = 3, dilations: Tuple[int, ...] = (1, 3)):
        super().__init__()
        self.n = len(dilations)
        for i, d in enumerate(dilations):
            self.add_module(f"convs_{i}", TorchConv1d(channels, channels, kernel_size, d))

    def forward(self, x):
        for i in range(self.n):
            x = x + getattr(self, f"convs_{i}")(F.leaky_relu(x, LRELU_SLOPE))
        return x


class Generator(nn.Module):
    """mel [B, T, n_mels] -> wav [B, T * prod(upsample_rates)] float32."""

    def __init__(self, n_mels: int = 80,
                 upsample_rates: Sequence[int] = (8, 8, 2, 2),
                 upsample_kernel_sizes: Sequence[int] = (16, 16, 4, 4),
                 upsample_initial_channel: int = 512,
                 resblock_kernel_sizes: Sequence[int] = (3, 7, 11),
                 resblock_dilation_sizes: Sequence[Tuple[int, ...]] = ((1, 3, 5),) * 3,
                 resblock: str = "1"):
        super().__init__()
        if str(resblock) not in ("1", "2"):
            raise ValueError(f"resblock must be '1' or '2', got {resblock!r}")
        block_cls = {"1": ResBlock, "2": ResBlock2}[str(resblock)]
        self.hop_factor = int(np.prod(upsample_rates))
        # the topology, which serving/streaming.py's receptive field reads
        self.upsample_rates = tuple(upsample_rates)
        self.upsample_kernel_sizes = tuple(upsample_kernel_sizes)
        self.resblock_kernel_sizes = tuple(resblock_kernel_sizes)
        self.resblock_dilation_sizes = tuple(tuple(d) for d in resblock_dilation_sizes)
        self.n_ups, self.n_kernels = len(upsample_rates), len(resblock_kernel_sizes)
        self.conv_pre = TorchConv1d(n_mels, upsample_initial_channel, 7)
        ch = upsample_initial_channel
        for i, (u, k) in enumerate(zip(upsample_rates, upsample_kernel_sizes)):
            cout = upsample_initial_channel // (2 ** (i + 1))
            self.add_module(f"ups_{i}", TorchConvTranspose1d(ch, cout, k, u))
            for j, (rk, rd) in enumerate(zip(resblock_kernel_sizes, resblock_dilation_sizes)):
                self.add_module(f"resblocks_{i * self.n_kernels + j}",
                                block_cls(cout, rk, tuple(rd)))
            ch = cout
        self.conv_post = TorchConv1d(ch, 1, 7)

    def forward(self, mel):
        x = self.conv_pre(mel.float().transpose(1, 2))
        for i in range(self.n_ups):
            x = getattr(self, f"ups_{i}")(F.leaky_relu(x, LRELU_SLOPE))
            xs = None
            for j in range(self.n_kernels):
                y = getattr(self, f"resblocks_{i * self.n_kernels + j}")(x)
                xs = y if xs is None else xs + y
            x = xs / self.n_kernels
        x = self.conv_post(F.leaky_relu(x, LRELU_SLOPE))
        return torch.tanh(x)[:, 0, :]


def generator_from_config(config: dict, n_mels: int = 80) -> Generator:
    """Build from a hifigan config.json dict (``resblock`` "1" or "2")."""
    return Generator(
        n_mels=n_mels,
        upsample_rates=tuple(config["upsample_rates"]),
        upsample_kernel_sizes=tuple(config["upsample_kernel_sizes"]),
        upsample_initial_channel=config["upsample_initial_channel"],
        resblock_kernel_sizes=tuple(config["resblock_kernel_sizes"]),
        resblock_dilation_sizes=tuple(tuple(d) for d in config["resblock_dilation_sizes"]),
        resblock=str(config.get("resblock", "1")),
    )


def to_int16(wavs: torch.Tensor, max_wav_value: float = 32768.0) -> np.ndarray:
    """Float wavs in [-1, 1] -> int16 (scaled by max_wav_value, clipped)."""
    w = wavs.float().cpu().numpy()
    return np.clip(w * max_wav_value, -max_wav_value, max_wav_value - 1).astype(np.int16)


@torch.inference_mode()
def vocoder_infer(generator: Generator, mels: torch.Tensor, lengths=None,
                  max_wav_value: float = 32768.0):
    """Batch mel [B, T, n_mels] -> list of int16 wavs trimmed to
    ``lengths[i] * hop_factor`` samples (untrimmed without lengths)."""
    wavs = to_int16(generator(mels), max_wav_value)
    return [
        wavs[i] if lengths is None else wavs[i, : int(lengths[i]) * generator.hop_factor]
        for i in range(wavs.shape[0])
    ]
