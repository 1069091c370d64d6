"""Learnable synthetic corpus generator (preprocessed-data layout); a copy
of the JAX package's speakingstyle_tpu/data/synthetic.py.

Emits the exact on-disk contract the preprocessor writes (SURVEY.md §2.2:
mel/pitch/energy/duration ``.npy`` + train/val metadata + speakers/stats
json) with *learnable* structure: every phone has a fixed 80-dim mel
signature, a fixed pitch/energy level, and a duration range, all lightly
noised. A model that learns the phone→(mel, variance) mapping drives the
loss well below its init value, so a few hundred real ``run_training``
steps at paper geometry (batch 48, ~600 mel frames — reference:
config/LJSpeech_paper train.yaml) demonstrate monotone-ish descent without
shipping corpus audio. Same seed, same files as the JAX package's copy.
"""

import json
import os

import numpy as np

PHONES = (
    "AA1 AE1 AH0 AO1 EH1 ER0 IH1 IY1 OW1 UW1 B CH D DH F G HH JH K L M N "
    "NG P R S SH T TH V W Y Z sp"
).split()


def generate_corpus(
    out_dir: str,
    n_utts: int = 640,
    val_utts: int = 48,
    n_phones_per_utt: tuple = (88, 112),
    duration_range: tuple = (4, 8),
    n_mels: int = 80,
    noise: float = 0.1,
    seed: int = 0,
) -> str:
    """Write a synthetic preprocessed corpus; returns ``out_dir``.

    Default geometry: ~100 phones x ~6 frames ≈ 600 mel frames/utterance —
    the paper-config shape used for the descent artifact and bench.
    """
    rng = np.random.default_rng(seed)
    sig_rng = np.random.default_rng(1234)  # phone signatures: corpus-stable
    mel_sig = sig_rng.standard_normal((len(PHONES), n_mels)).astype(np.float32)
    pitch_sig = sig_rng.standard_normal(len(PHONES)).astype(np.float32)
    energy_sig = sig_rng.standard_normal(len(PHONES)).astype(np.float32)

    for kind in ("mel", "pitch", "energy", "duration"):
        os.makedirs(os.path.join(out_dir, kind), exist_ok=True)

    speaker = "SYNTH"
    lines = []
    for i in range(n_utts):
        n_ph = int(rng.integers(*n_phones_per_utt))
        ids = rng.integers(0, len(PHONES), n_ph)
        durations = rng.integers(
            duration_range[0], duration_range[1] + 1, n_ph
        ).astype(np.int64)
        mel = np.repeat(mel_sig[ids], durations, axis=0)
        mel = mel + noise * rng.standard_normal(mel.shape).astype(np.float32)
        pitch = pitch_sig[ids] + noise * rng.standard_normal(n_ph).astype(
            np.float32
        )
        energy = energy_sig[ids] + noise * rng.standard_normal(n_ph).astype(
            np.float32
        )
        base = f"synth{i:05d}"
        np.save(os.path.join(out_dir, "mel", f"{speaker}-mel-{base}.npy"), mel)
        np.save(
            os.path.join(out_dir, "pitch", f"{speaker}-pitch-{base}.npy"), pitch
        )
        np.save(
            os.path.join(out_dir, "energy", f"{speaker}-energy-{base}.npy"),
            energy,
        )
        np.save(
            os.path.join(out_dir, "duration", f"{speaker}-duration-{base}.npy"),
            durations,
        )
        phones = " ".join(PHONES[j] for j in ids)
        lines.append(f"{base}|{speaker}|{{{phones}}}|synthetic utterance {i}")

    with open(os.path.join(out_dir, "train.txt"), "w") as f:
        f.write("\n".join(lines[: n_utts - val_utts]) + "\n")
    with open(os.path.join(out_dir, "val.txt"), "w") as f:
        f.write("\n".join(lines[n_utts - val_utts :]) + "\n")
    with open(os.path.join(out_dir, "speakers.json"), "w") as f:
        json.dump({speaker: 0}, f)
    lo = float(pitch_sig.min() - 3 * noise)
    hi = float(pitch_sig.max() + 3 * noise)
    elo = float(energy_sig.min() - 3 * noise)
    ehi = float(energy_sig.max() + 3 * noise)
    with open(os.path.join(out_dir, "stats.json"), "w") as f:
        json.dump({"pitch": [lo, hi, 0.0, 1.0], "energy": [elo, ehi, 0.0, 1.0]}, f)
    return out_dir


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", required=True)
    ap.add_argument("--n_utts", type=int, default=640)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    generate_corpus(args.out, n_utts=args.n_utts, seed=args.seed)
    print(f"synthetic corpus written to {args.out}")
