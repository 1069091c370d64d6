"""FastSpeech2 loss (JAX counterpart: speakingstyle_tpu/models/loss.py).

L1 on mel and postnet mel, MSE on pitch, energy and log duration, each a
mean over the real (unmasked) elements only, plus the FiLM-gate L2 term
``lambda_f * sum(s_gamma^2 + s_beta^2)`` over the parameters of those
names.

Under data parallelism each rank passes ``counts``, the global batch's
valid positions (``loss_counts`` of the global arrays, known on every rank
without a collective), so that its masked means are its rows' share of the
global means, and only data-parallel rank 0 adds the parameter-only FiLM
term (``param_terms``; every tensor-parallel rank of it, since each
tensor-parallel rank's gradients are summed over its own ``dp`` group):
the sum of the data-parallel ranks' losses, and of their gradients, is
then the one-process value of the global batch.
"""

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from speakingstyle_torch.ops.masking import masked_mean


def film_gate_l2(module: nn.Module) -> torch.Tensor:
    """Sum of squares of every ``s_gamma`` / ``s_beta`` parameter, in f32."""
    total = None
    for name, p in module.named_parameters():
        if name.split(".")[-1] in ("s_gamma", "s_beta"):
            sq = p.float().square().sum()
            total = sq if total is None else total + sq
    if total is None:
        return torch.zeros((), device=next(module.parameters()).device)
    return total


def loss_counts(arrays: Dict) -> Dict[str, float]:
    """The valid positions of a (global) batch's host arrays: ``src``
    phonemes (``src_lens`` within the padded length) and ``mel`` frames
    (the durations' sums within the padded length, which the length
    regulator's mask keeps)."""
    L, T = arrays["texts"].shape[1], arrays["mels"].shape[1]
    src = np.minimum(np.asarray(arrays["src_lens"]), L)
    mel = np.minimum(np.asarray(arrays["durations"]).sum(axis=1), T)
    return {"src": float(src.sum()), "mel": float(mel.sum())}


def fastspeech2_loss(predictions: Dict, mel_targets, pitch_targets, energy_targets,
                     duration_targets, module: nn.Module, lambda_f: float = 0.0,
                     pitch_feature_level: str = "phoneme_level",
                     energy_feature_level: str = "phoneme_level",
                     counts: Optional[Dict[str, float]] = None,
                     param_terms: bool = True) -> Dict[str, torch.Tensor]:
    """The JAX package's loss dict: ``total_loss`` and its parts.
    ``counts`` (``loss_counts`` of the global batch) divides each masked
    mean by the global count; ``param_terms`` False leaves the FiLM term
    out of ``total_loss`` (its ``film_gate_l2`` entry stays the value)."""
    src_keep = ~predictions["src_pad_mask"]
    mel_keep = ~predictions["mel_pad_mask"]
    log_duration_targets = torch.log(duration_targets.float() + 1.0)
    pitch_keep = src_keep if pitch_feature_level == "phoneme_level" else mel_keep
    energy_keep = src_keep if energy_feature_level == "phoneme_level" else mel_keep

    n_src = n_mel = n_pitch = n_energy = None
    if counts is not None:
        n_src, n_mel = counts["src"], counts["mel"]
        n_pitch = n_src if pitch_feature_level == "phoneme_level" else n_mel
        n_energy = n_src if energy_feature_level == "phoneme_level" else n_mel

    mel_targets = mel_targets.float()
    mel_keep3 = mel_keep[..., None].expand(mel_targets.shape)
    n_mel3 = None if n_mel is None else n_mel * mel_targets.shape[-1]
    mel_loss = masked_mean((predictions["mel"] - mel_targets).abs(), mel_keep3, n_mel3)
    postnet_mel_loss = masked_mean((predictions["mel_postnet"] - mel_targets).abs(), mel_keep3,
                                   n_mel3)
    pitch_loss = masked_mean(
        (predictions["pitch_prediction"] - pitch_targets.float()).square(), pitch_keep, n_pitch)
    energy_loss = masked_mean(
        (predictions["energy_prediction"] - energy_targets.float()).square(), energy_keep,
        n_energy)
    duration_loss = masked_mean(
        (predictions["log_duration_prediction"] - log_duration_targets).square(), src_keep,
        n_src)
    scale_reg = film_gate_l2(module)
    total = mel_loss + postnet_mel_loss + duration_loss + pitch_loss + energy_loss
    if param_terms:
        total = total + lambda_f * scale_reg
    return {
        "total_loss": total,
        "mel_loss": mel_loss,
        "postnet_mel_loss": postnet_mel_loss,
        "pitch_loss": pitch_loss,
        "energy_loss": energy_loss,
        "duration_loss": duration_loss,
        "film_gate_l2": scale_reg,
    }
