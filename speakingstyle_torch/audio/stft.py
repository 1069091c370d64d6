"""STFT / log-mel extraction in torch (JAX counterpart:
speakingstyle_tpu/audio/stft.py).

The reference's conv1d-based STFT contract: reflect-pad the signal by
n_fft//2 on both sides, periodic hann window of ``win_length`` zero-padded
to n_fft, magnitude = |rfft| per frame (T//hop + 1 frames),
mel = log(clamp(mel_fb @ mag, 1e-5)), energy = L2 norm of each frame.
"""

from typing import Optional, Tuple

import numpy as np
import torch

from speakingstyle_torch.audio.mel import mel_filterbank


def hann_window(win_length: int, n_fft: int) -> np.ndarray:
    """Periodic hann of win_length, zero-center-padded to n_fft."""
    n = np.arange(win_length)
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)
    pad = (n_fft - win_length) // 2
    out = np.zeros(n_fft, dtype=np.float32)
    out[pad: pad + win_length] = w
    return out


def frame_signal(y: torch.Tensor, n_fft: int, hop_length: int) -> torch.Tensor:
    """[B, T] -> [B, n_frames, n_fft] reflect-padded overlapping frames."""
    pad = n_fft // 2
    y = torch.nn.functional.pad(y[:, None, :], (pad, pad), mode="reflect")[:, 0]
    return y.unfold(-1, n_fft, hop_length)


def stft_magnitude(y: torch.Tensor, n_fft: int, hop_length: int, win_length: int):
    """[B, T] float in [-1, 1] -> magnitude [B, 1 + n_fft//2, n_frames]."""
    frames = frame_signal(y, n_fft, hop_length)
    window = torch.from_numpy(hann_window(win_length, n_fft)).to(y.device)
    spec = torch.fft.rfft(frames * window, dim=-1)
    return spec.abs().float().transpose(1, 2)


def dynamic_range_compression(x: torch.Tensor, C: float = 1.0, clip_val: float = 1e-5):
    """log(clamp(x, clip_val) * C): the log-mel of a mel magnitude."""
    return torch.log(torch.clamp(x, min=clip_val) * C)


def dynamic_range_decompression(x: torch.Tensor, C: float = 1.0):
    return torch.exp(x) / C


class MelExtractor:
    """TacotronSTFT equivalent: wav -> (log-mel, energy)."""

    def __init__(self, filter_length: int = 1024, hop_length: int = 256,
                 win_length: int = 1024, n_mel_channels: int = 80,
                 sampling_rate: int = 22050, mel_fmin: float = 0.0,
                 mel_fmax: Optional[float] = 8000.0):
        self.filter_length, self.hop_length, self.win_length = (
            filter_length, hop_length, win_length)
        self.mel_basis = torch.from_numpy(mel_filterbank(
            sampling_rate, filter_length, n_mel_channels, mel_fmin, mel_fmax
        ))

    def mel_spectrogram(self, y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """[B, T] wav in [-1, 1] -> (mel [B, n_mels, n_frames], energy [B, n_frames])."""
        mag = stft_magnitude(y, self.filter_length, self.hop_length, self.win_length)
        mel = torch.einsum("mf,bft->bmt", self.mel_basis.to(y.device), mag)
        return dynamic_range_compression(mel), torch.linalg.norm(mag, dim=1)


def get_mel_from_wav(audio: np.ndarray, extractor: MelExtractor):
    """Single utterance, numpy in and out -> (mel [n_mels, T], energy [T])."""
    audio = np.clip(np.asarray(audio, np.float32), -1.0, 1.0)
    mel, energy = extractor.mel_spectrogram(torch.from_numpy(audio)[None])
    return mel[0].numpy(), energy[0].numpy()
