"""Vocoder training data: random wav segments and their mels (JAX
counterpart: speakingstyle_tpu/data/mel_dataset.py).

Reference: hifigan/meldataset.py:48-167. A segment of ``segment_size``
samples is cropped at random from each wav and its log-mel computed in
numpy with the preprocessor's constants (``_numpy_mel_energy``), so the
vocoder trains on the features the acoustic model predicts. Fine-tune mode
reads the acoustic model's predicted mels instead and crops wav and mel in
lockstep. The draws of ``np.random.default_rng(seed)`` come in the JAX
package's order (the shuffle of an epoch, then one crop offset per item),
so both packages cut the same batches from the same seed.
"""

import os
from typing import Iterator, List, Optional, Tuple

import numpy as np

from speakingstyle_torch.audio.mel import mel_filterbank
from speakingstyle_torch.audio.stft import hann_window
from speakingstyle_torch.audio.tools import load_wav
from speakingstyle_torch.configs.config import Config


def scan_wavs(root: str) -> List[str]:
    """Every ``.wav`` under ``root``, sorted."""
    out = []
    for dirpath, _, names in os.walk(root):
        out += [os.path.join(dirpath, n) for n in names if n.endswith(".wav")]
    return sorted(out)


def _numpy_mel_energy(wav: np.ndarray, mel_basis: np.ndarray, window: np.ndarray,
                      n_fft: int, hop: int) -> Tuple[np.ndarray, np.ndarray]:
    """(log-mel [T, n_mels], energy [T]) in numpy, the arithmetic of
    audio/stft.py: reflect pad, periodic hann, |rfft|, mel filterbank,
    log-clamp at 1e-5, L2 energy of each magnitude frame (a copy of the JAX
    package's ``data/preprocessor.py::_numpy_mel_energy``)."""
    pad = n_fft // 2
    y = np.pad(np.clip(wav, -1.0, 1.0), (pad, pad), mode="reflect")
    n_frames = (len(y) - n_fft) // hop + 1
    starts = np.arange(n_frames) * hop
    frames = y[starts[:, None] + np.arange(n_fft)[None, :]] * window[None, :]
    mag = np.abs(np.fft.rfft(frames, axis=1)).astype(np.float32)  # [T, F]
    mel = np.log(np.clip(mag @ mel_basis.T, 1e-5, None))  # [T, n_mels]
    energy = np.linalg.norm(mag, axis=1)
    return mel.astype(np.float32), energy.astype(np.float32)


class MelWavDataset:
    """Yields (wav segments [B, S], mels [B, S / hop, n_mels]) batches,
    float32 numpy."""

    def __init__(self, wav_paths: List[str], config: Config, segment_size: int = 8192,
                 batch_size: int = 16, fine_tune_mel_dir: Optional[str] = None,
                 seed: int = 1234):
        pp = config.preprocess.preprocessing
        if segment_size % pp.stft.hop_length != 0:
            raise ValueError(f"segment_size {segment_size} must be a multiple of "
                             f"hop_length {pp.stft.hop_length}")
        self.paths = list(wav_paths)
        if len(self.paths) < batch_size:
            raise ValueError(f"{len(self.paths)} wavs < batch_size {batch_size}: epoch() "
                             "would yield no batches (lower --batch_size or add data)")
        self.segment, self.batch_size = segment_size, batch_size
        self.sr, self.hop, self.n_fft = (pp.audio.sampling_rate, pp.stft.hop_length,
                                         pp.stft.filter_length)
        self.fine_tune_mel_dir = fine_tune_mel_dir
        self._mel_index = {}
        if fine_tune_mel_dir is not None:
            # exact-basename index: "<speaker>-mel-<base>.npy" or "<base>.npy"
            for name in os.listdir(fine_tune_mel_dir):
                if not name.endswith(".npy"):
                    continue
                stem = name[: -len(".npy")]
                base = stem.split("-mel-", 1)[1] if "-mel-" in stem else stem
                self._mel_index[base] = os.path.join(fine_tune_mel_dir, name)
        self.rng = np.random.default_rng(seed)
        self._mel_basis = mel_filterbank(self.sr, self.n_fft, pp.mel.n_mel_channels,
                                         pp.mel.mel_fmin, pp.mel.mel_fmax)
        self._window = hann_window(pp.stft.win_length, self.n_fft)

    def _load_item(self, path: str) -> Tuple[np.ndarray, np.ndarray]:
        wav, _ = load_wav(path, target_sr=self.sr)
        S = self.segment
        if self.fine_tune_mel_dir is not None:
            base = os.path.splitext(os.path.basename(path))[0]
            if base not in self._mel_index:
                raise FileNotFoundError(f"no fine-tune mel for {base!r}")
            mel = np.load(self._mel_index[base])
            # crop wav and mel in lockstep (reference: meldataset.py:121-138)
            frames = S // self.hop
            if mel.shape[0] > frames:
                start = int(self.rng.integers(0, mel.shape[0] - frames + 1))
                mel = mel[start: start + frames]
                wav = wav[start * self.hop: start * self.hop + S]
            wav = np.pad(wav, (0, max(0, S - len(wav))))
            mel = np.pad(mel, ((0, frames - mel.shape[0]), (0, 0)))
            return wav[:S], mel
        if len(wav) >= S:
            start = int(self.rng.integers(0, len(wav) - S + 1))
            wav = wav[start: start + S]
        else:
            wav = np.pad(wav, (0, S - len(wav)))
        mel, _ = _numpy_mel_energy(wav, self._mel_basis, self._window, self.n_fft, self.hop)
        return wav, mel[: S // self.hop]

    def epoch(self, shuffle: bool = True) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        order = np.arange(len(self.paths))
        if shuffle:
            self.rng.shuffle(order)
        for s in range(0, len(order) - self.batch_size + 1, self.batch_size):
            wavs, mels = [], []
            for i in order[s: s + self.batch_size]:
                w, m = self._load_item(self.paths[int(i)])
                wavs.append(w)
                mels.append(m)
            yield np.stack(wavs).astype(np.float32), np.stack(mels).astype(np.float32)

    def __iter__(self):
        while True:
            yield from self.epoch()
