"""Mel filterbank, self-contained (no librosa dependency).

Reproduces `librosa.filters.mel` with its defaults (htk=False, Slaney-style
area normalization) — the filterbank the reference builds in
audio/stft.py:145-147 — as a pure numpy function, so offline preprocessing
and on-device mel extraction share one set of constants.
"""

import numpy as np

_F_SP = 200.0 / 3  # Hz per mel below the log knee
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = np.log(6.4) / 27.0


def hz_to_mel(frequencies):
    """Slaney mel scale: linear below 1 kHz, log above."""
    frequencies = np.asarray(frequencies, dtype=np.float64)
    mels = frequencies / _F_SP
    log_region = frequencies >= _MIN_LOG_HZ
    mels = np.where(
        log_region,
        _MIN_LOG_MEL + np.log(np.maximum(frequencies, 1e-10) / _MIN_LOG_HZ) / _LOGSTEP,
        mels,
    )
    return mels


def mel_to_hz(mels):
    mels = np.asarray(mels, dtype=np.float64)
    freqs = mels * _F_SP
    log_region = mels >= _MIN_LOG_MEL
    return np.where(
        log_region, _MIN_LOG_HZ * np.exp(_LOGSTEP * (mels - _MIN_LOG_MEL)), freqs
    )


def mel_frequencies(n_mels, fmin, fmax):
    return mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels))


def mel_filterbank(
    sampling_rate: int,
    n_fft: int,
    n_mels: int = 80,
    fmin: float = 0.0,
    fmax=None,
) -> np.ndarray:
    """[n_mels, 1 + n_fft//2] triangular filterbank, Slaney-normalized."""
    if fmax is None:
        fmax = sampling_rate / 2.0
    fft_freqs = np.linspace(0.0, sampling_rate / 2.0, 1 + n_fft // 2)
    mel_f = mel_frequencies(n_mels + 2, fmin, fmax)

    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fft_freqs[None, :]  # [n_mels+2, n_freq]

    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))

    # Slaney area normalization: each filter integrates to ~2/bandwidth
    enorm = 2.0 / (mel_f[2 : n_mels + 2] - mel_f[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)
