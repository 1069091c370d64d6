"""Request frontend: the speaker registry and the reference-wav loader
(JAX counterpart: ``TextFrontend.speaker`` and ``load_ref_mel`` of
speakingstyle_tpu/serving/server.py; the rest of the HTTP frontend is not
ported yet, ROADMAP.md queue A item 5).
"""

import json
import os
from typing import Dict

import numpy as np

from speakingstyle_torch.configs.config import Config


class TextFrontend:
    """Speaker resolution for one config, through the preprocessed
    dataset's ``speakers.json``."""

    def __init__(self, cfg: Config):
        root = cfg.preprocess.path.preprocessed_path
        speakers_path = os.path.join(root or "", "speakers.json")
        self.speaker_map: Dict[str, int] = {}
        if root and os.path.exists(speakers_path):
            with open(speakers_path) as f:
                self.speaker_map = json.load(f)

    def speaker(self, spec) -> int:
        """A speaker name from speakers.json, or a numeric id, which must
        fall inside the registry when one is loaded (an unknown id would
        index an untrained embedding row): the id, or ValueError."""
        if isinstance(spec, int):
            idx = spec
        else:
            s = str(spec)
            if s in self.speaker_map:
                return self.speaker_map[s]
            if not s.lstrip("-").isdigit():
                raise ValueError(f"unknown speaker {spec!r}")
            idx = int(s)
        if self.speaker_map and not (
                0 <= idx < max(len(self.speaker_map), max(self.speaker_map.values()) + 1)):
            raise ValueError(
                f"speaker id {idx} outside the registry (0..{len(self.speaker_map) - 1})"
            )
        return idx


def load_ref_mel(cfg: Config, wav_path: str) -> np.ndarray:
    """Reference wav -> [T, n_mels] normalised log-mel, the style encoder's
    input (resampled to the config's rate)."""
    from speakingstyle_torch.audio.tools import load_wav
    from speakingstyle_torch.serving.style import mel_from_wav_array

    wav, _ = load_wav(wav_path, target_sr=cfg.preprocess.preprocessing.audio.sampling_rate)
    return mel_from_wav_array(cfg, wav)
