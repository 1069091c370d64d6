"""Wav file IO (JAX counterpart: speakingstyle_tpu/audio/tools.py).
Resampling uses scipy polyphase filtering."""

from fractions import Fraction

import numpy as np
import scipy.io.wavfile
import scipy.signal


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
