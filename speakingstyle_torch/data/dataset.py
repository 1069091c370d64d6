"""Training datasets over preprocessed features (a copy of the JAX package's
speakingstyle_tpu/data/dataset.py; numpy only).

On-disk contract matches the reference exactly (reference: dataset.py:12-146):
metadata lines ``basename|speaker|{phones}|raw_text``; features at
``<root>/{mel,pitch,energy,duration}/{speaker}-{kind}-{basename}.npy``;
collate sorts a ``group_size × batch_size`` super-batch by text length and
splits it into ``group_size`` real batches.

Every emitted batch is padded to a shape from a small static bucket grid
(src rounded up to ``src_bucket``, mel rounded up to ``mel_bucket``), as in
the JAX package, so both packages see the same batches from the same seed.
The loader's retry and quarantine layer is not ported yet (ROADMAP.md): a
failed feature load raises.
"""

import json
import os
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from speakingstyle_torch.configs.config import Config
from speakingstyle_torch.text import text_to_sequence


def parse_metadata(path: str):
    """metadata file -> list of (basename, speaker, phones_text, raw_text)."""
    entries = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip("\n")
            if not line:
                continue
            basename, speaker, text, raw = line.split("|", 3)
            entries.append((basename, speaker, text, raw))
    return entries


def bucket_length(n: int, step: int, max_len: Optional[int] = None) -> int:
    """Round n up to the next bucket edge (multiple of `step`)."""
    b = ((max(n, 1) + step - 1) // step) * step
    return min(b, max_len) if max_len is not None else b


@dataclass
class Batch:
    """One padded, static-shape training batch (all numpy, host-side).

    The batch dimension may include all-padding dummy items (src_len =
    mel_len = 0) so B divides the mesh's data axis; ``n_real`` counts the
    genuine items. Dummy items contribute nothing to masked losses.
    """

    n_real: int
    ids: List[str]
    raw_texts: List[str]
    speakers: np.ndarray     # [B] int32
    texts: np.ndarray        # [B, L_src] int32
    src_lens: np.ndarray     # [B] int32
    mels: np.ndarray         # [B, L_mel, n_mels] float32
    mel_lens: np.ndarray     # [B] int32
    pitches: np.ndarray      # [B, L_src or L_mel] float32
    energies: np.ndarray     # [B, L_src or L_mel] float32
    durations: np.ndarray    # [B, L_src] int32

    def arrays(self) -> Dict[str, np.ndarray]:
        return {
            "speakers": self.speakers,
            "texts": self.texts,
            "src_lens": self.src_lens,
            "mels": self.mels,
            "mel_lens": self.mel_lens,
            "pitches": self.pitches,
            "energies": self.energies,
            "durations": self.durations,
        }


class SpeechDataset:
    """Feature-loading dataset (reference: dataset.py:12-146)."""

    def __init__(self, filename: str, config: Config, sort: bool = True,
                 drop_last: bool = False):
        pp = config.preprocess
        self.root = pp.path.preprocessed_path
        self.cleaners = pp.preprocessing.text.text_cleaners
        self.batch_size = config.train.optimizer.batch_size
        self.group_size = 4  # super-batch factor (reference: train.py:31)
        self.sort = sort
        self.drop_last = drop_last
        self.pitch_level = pp.preprocessing.pitch.feature
        self.energy_level = pp.preprocessing.energy.feature
        self.entries = parse_metadata(os.path.join(self.root, filename))
        with open(os.path.join(self.root, "speakers.json")) as f:
            self.speaker_map = json.load(f)

    def __len__(self):
        return len(self.entries)

    def _feature(self, kind: str, speaker: str, basename: str) -> np.ndarray:
        return np.load(os.path.join(self.root, kind, f"{speaker}-{kind}-{basename}.npy"))

    def __getitem__(self, idx: int) -> Dict:
        basename, speaker, text, raw = self.entries[idx]
        phones = np.asarray(text_to_sequence(text, self.cleaners), np.int32)
        return {
            "id": basename,
            "speaker": self.speaker_map[speaker],
            "raw_text": raw,
            "text": phones,
            "mel": self._feature("mel", speaker, basename).astype(np.float32),
            "pitch": self._feature("pitch", speaker, basename).astype(np.float32),
            "energy": self._feature("energy", speaker, basename).astype(np.float32),
            "duration": self._feature("duration", speaker, basename).astype(np.int32),
        }


class BucketedBatcher:
    """Sort-group collate + static-shape bucket padding.

    ``src_bucket``/``mel_bucket`` control the bucket grid granularity;
    ``max_src``/``max_mel`` cap the padded shapes (features beyond the cap
    are truncated, mirroring the reference Decoder's max_seq_len truncation,
    transformer/Models.py:154-162). The shuffle draws from
    ``np.random.default_rng(seed)``, as the JAX package's does.
    """

    def __init__(
        self,
        dataset: SpeechDataset,
        src_bucket: int = 32,
        mel_bucket: int = 128,
        max_src: Optional[int] = None,
        max_mel: Optional[int] = None,
        batch_pad_multiple: int = 1,
        seed: int = 1234,
    ):
        self.ds = dataset
        self.src_bucket = src_bucket
        self.mel_bucket = mel_bucket
        self.max_src = max_src
        self.max_mel = max_mel
        self.batch_pad_multiple = batch_pad_multiple
        self.rng = np.random.default_rng(seed)

    def _pad_batch(self, items: Sequence[Dict]) -> Batch:
        n_real = len(items)
        m = self.batch_pad_multiple
        B = ((n_real + m - 1) // m) * m
        src_lens = np.zeros((B,), np.int32)
        mel_lens = np.zeros((B,), np.int32)
        src_lens[:n_real] = [len(d["text"]) for d in items]
        mel_lens[:n_real] = [d["mel"].shape[0] for d in items]
        if self.max_src is not None:
            src_lens = np.minimum(src_lens, self.max_src)
        if self.max_mel is not None:
            mel_lens = np.minimum(mel_lens, self.max_mel)
        L_src = bucket_length(int(src_lens.max()), self.src_bucket, self.max_src)
        L_mel = bucket_length(int(mel_lens.max()), self.mel_bucket, self.max_mel)
        n_mels = items[0]["mel"].shape[1]

        texts = np.zeros((B, L_src), np.int32)
        durations = np.zeros((B, L_src), np.int32)
        mels = np.zeros((B, L_mel, n_mels), np.float32)
        p_len = L_src if self.ds.pitch_level == "phoneme_level" else L_mel
        e_len = L_src if self.ds.energy_level == "phoneme_level" else L_mel
        pitches = np.zeros((B, p_len), np.float32)
        energies = np.zeros((B, e_len), np.float32)

        for i, d in enumerate(items):
            ls, lm = src_lens[i], mel_lens[i]
            texts[i, :ls] = d["text"][:ls]
            dur = d["duration"][:ls].copy()
            # keep sum(duration) == mel_len after any truncation: trim excess
            # frames from the tail phones, and if src truncation dropped
            # duration mass, shrink mel_len to the frames still covered
            excess = int(dur.sum()) - int(lm)
            j = len(dur) - 1
            while excess > 0 and j >= 0:
                take = min(excess, int(dur[j]))
                dur[j] -= take
                excess -= take
                j -= 1
            lm = int(dur.sum())
            mel_lens[i] = lm
            durations[i, :ls] = dur
            mels[i, :lm] = d["mel"][:lm]
            pitches[i, : min(len(d["pitch"]), p_len)] = d["pitch"][:p_len]
            energies[i, : min(len(d["energy"]), e_len)] = d["energy"][:e_len]

        speakers = np.zeros((B,), np.int32)
        speakers[:n_real] = [d["speaker"] for d in items]
        return Batch(
            n_real=n_real,
            ids=[d["id"] for d in items],
            raw_texts=[d["raw_text"] for d in items],
            speakers=speakers,
            texts=texts,
            src_lens=src_lens,
            mels=mels,
            mel_lens=mel_lens,
            pitches=pitches,
            energies=energies,
            durations=durations,
        )

    def epoch(self, shuffle: bool = True) -> Iterator[Batch]:
        """One pass: super-batch grouping then per-group length sort."""
        ds = self.ds
        order = np.arange(len(ds))
        if shuffle:
            self.rng.shuffle(order)
        super_size = ds.batch_size * ds.group_size
        for s in range(0, len(order), super_size):
            chunk = order[s : s + super_size]
            items = [ds[int(i)] for i in chunk]
            if ds.sort:
                idx = np.argsort([-len(d["text"]) for d in items], kind="stable")
                items = [items[int(i)] for i in idx]
            for b in range(0, len(items), ds.batch_size):
                sub = items[b : b + ds.batch_size]
                if len(sub) < ds.batch_size and ds.drop_last:
                    continue
                yield self._pad_batch(sub)

    def __iter__(self) -> Iterator[Batch]:
        """Infinite stream of batches (the reference's while-True epoch loop)."""
        while True:
            yield from self.epoch()


class TextBatcher:
    """Inference-time dataset (batch synthesis's source; reference:
    dataset.py:149-218): a metadata file's texts without targets, each
    speaker's id from ``speakers.json``, and each item's reference mel for
    the style encoder (the preprocessed ``mel/<speaker>-mel-<basename>.npy``,
    else None)."""

    def __init__(self, filename: str, config: Config):
        pp = config.preprocess
        self.root = pp.path.preprocessed_path
        self.cleaners = pp.preprocessing.text.text_cleaners
        self.entries = parse_metadata(filename)
        with open(os.path.join(self.root, "speakers.json")) as f:
            self.speaker_map = json.load(f)

    def __len__(self):
        return len(self.entries)

    def __getitem__(self, idx: int) -> Dict:
        basename, speaker, text, raw = self.entries[idx]
        item = {
            "id": basename,
            "speaker": self.speaker_map.get(speaker, 0),
            "raw_text": raw,
            "text": np.asarray(text_to_sequence(text, self.cleaners), np.int32),
        }
        path = os.path.join(self.root, "mel", f"{speaker}-mel-{basename}.npy")
        item["mel"] = np.load(path).astype(np.float32) if os.path.exists(path) else None
        return item
