"""Reference audio -> the style encoder's input features (JAX counterpart:
``mel_from_wav_array`` of speakingstyle_tpu/serving/style.py). The
StyleService cache of the JAX package is not ported yet: the port's
engine encodes each dispatch's references directly."""

import numpy as np

from speakingstyle_torch.audio.stft import MelExtractor, get_mel_from_wav
from speakingstyle_torch.configs.config import Config


def mel_from_wav_array(cfg: Config, wav: np.ndarray) -> np.ndarray:
    """Float wav samples -> [T, n_mels] log-mel, the feature pipeline the
    preprocessor and the CLI use."""
    pp = cfg.preprocess.preprocessing
    mel, _ = get_mel_from_wav(
        np.asarray(wav, np.float32),
        MelExtractor(
            pp.stft.filter_length, pp.stft.hop_length, pp.stft.win_length,
            pp.mel.n_mel_channels, pp.audio.sampling_rate,
            pp.mel.mel_fmin, pp.mel.mel_fmax,
        ),
    )
    return np.asarray(mel.T, np.float32)
