"""Inverse STFT, Griffin-Lim and wav file IO (JAX counterpart:
speakingstyle_tpu/audio/tools.py).

``istft`` and ``griffin_lim`` replace the reference's torch ISTFT and
Griffin-Lim (reference: audio/stft.py:82-139,
audio/audio_processing.py:66-82) with a windowed overlap-add in torch ops,
the JAX package's arithmetic. Resampling uses scipy polyphase filtering.
"""

import math
from fractions import Fraction
from typing import Optional

import numpy as np
import scipy.io.wavfile
import scipy.signal
import torch

from speakingstyle_torch.audio.stft import frame_signal, hann_window


def istft(magnitude: torch.Tensor, phase: torch.Tensor, n_fft: int, hop_length: int,
          win_length: int) -> torch.Tensor:
    """Inverse STFT by windowed overlap-add: magnitude / phase
    [B, 1 + n_fft // 2, n_frames] -> wav [B, T], the forward transform's
    n_fft // 2 reflect-pad trimmed off, normalised by the window's summed
    square (reference: audio/audio_processing.py:7-63)."""
    spec = torch.polar(magnitude.float(), phase.float())
    frames = torch.fft.irfft(spec.transpose(1, 2), n=n_fft, dim=-1)
    window = torch.from_numpy(hann_window(win_length, n_fft)).to(frames.device)
    frames = frames * window
    B, n_frames, _ = frames.shape
    out_len = n_fft + hop_length * (n_frames - 1)
    idx = (torch.arange(n_frames, device=frames.device)[:, None] * hop_length
           + torch.arange(n_fft, device=frames.device)[None, :]).reshape(-1)
    sig = torch.zeros((B, out_len), dtype=frames.dtype, device=frames.device)
    sig.index_add_(1, idx, frames.reshape(B, -1))
    wss = torch.zeros((out_len,), dtype=frames.dtype, device=frames.device)
    wss.index_add_(0, idx, (window ** 2).repeat(n_frames))
    sig = sig / torch.where(wss > 1e-11, wss, torch.ones_like(wss))
    pad = n_fft // 2
    return sig[:, pad: out_len - pad]


def _frames(y: torch.Tensor, n_fft: int, hop_length: int) -> torch.Tensor:
    """``frame_signal`` for any length: the n_fft // 2 reflect-pad repeats
    its reflection where the signal is shorter than the pad, as numpy's
    (and so the JAX package's) reflect padding does."""
    pad, n = n_fft // 2, y.shape[-1]
    if n > pad:
        return frame_signal(y, n_fft, hop_length)
    period = 2 * (n - 1)
    idx = torch.remainder(torch.arange(-pad, n + pad, device=y.device), period)
    idx = torch.where(idx < n, idx, period - idx)
    return y[:, idx].unfold(-1, n_fft, hop_length)


def _stft_phase(y: torch.Tensor, n_fft: int, hop_length: int, win_length: int):
    frames = _frames(y, n_fft, hop_length)
    window = torch.from_numpy(hann_window(win_length, n_fft)).to(y.device)
    return torch.angle(torch.fft.rfft(frames * window, dim=-1)).transpose(1, 2)


def griffin_lim(magnitudes: torch.Tensor, n_fft: int, hop_length: int, win_length: int,
                n_iters: int = 30, angles: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Phase reconstruction: magnitude [B, F, T] -> wav [B, T'].

    The initial phase is ``angles`` ([B, F, T]) if given, else uniform in
    [-pi, pi) drawn from ``generator``. The JAX package draws it from
    ``jax.random.PRNGKey(0)``, which torch cannot reproduce: to compare the
    two, pass the same angles to both."""
    magnitudes = magnitudes.float()
    if angles is None:
        angles = (torch.rand(magnitudes.shape, generator=generator) * 2 - 1) * math.pi
    angles = angles.to(magnitudes.device, torch.float32)
    for _ in range(n_iters):
        signal = istft(magnitudes, angles, n_fft, hop_length, win_length)
        angles = _stft_phase(signal, n_fft, hop_length, win_length)[..., : magnitudes.shape[-1]]
    return istft(magnitudes, angles, n_fft, hop_length, win_length)


def load_wav(path: str, target_sr: int = None) -> tuple:
    """Read a wav file -> (float32 array in [-1, 1], sample_rate)."""
    sr, data = scipy.io.wavfile.read(path)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    if data.ndim > 1:
        data = data.mean(axis=1)
    if target_sr is not None and sr != target_sr:
        frac = Fraction(target_sr, sr).limit_denominator(1000)
        data = scipy.signal.resample_poly(data, frac.numerator, frac.denominator)
        sr = target_sr
    return data.astype(np.float32), sr


def write_wav_int16(path: str, wav: np.ndarray, sampling_rate: int) -> None:
    """Write already-scaled int16 samples (the engine's output) as a wav."""
    scipy.io.wavfile.write(path, sampling_rate, np.asarray(wav, np.int16))


def save_wav(path: str, wav: np.ndarray, sampling_rate: int, max_wav_value: float = 32768.0):
    """Float samples -> int16 wav, scaled down to a peak of 1 if louder."""
    wav = np.asarray(wav, np.float32)
    peak = max(np.abs(wav).max(), 1e-8)
    if peak > 1.0:
        wav = wav / peak
    scipy.io.wavfile.write(path, sampling_rate, (wav * (max_wav_value - 1)).astype(np.int16))
