"""FastSpeech2 loss (JAX counterpart: speakingstyle_tpu/models/loss.py).

L1 on mel and postnet mel, MSE on pitch, energy and log duration, each a
mean over the real (unmasked) elements only, plus the FiLM-gate L2 term
``lambda_f * sum(s_gamma^2 + s_beta^2)`` over the parameters of those
names.
"""

from typing import Dict

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


def fastspeech2_loss(predictions: Dict, mel_targets, pitch_targets, energy_targets,
                     duration_targets, module: nn.Module, lambda_f: float = 0.0,
                     pitch_feature_level: str = "phoneme_level",
                     energy_feature_level: str = "phoneme_level") -> Dict[str, torch.Tensor]:
    """The JAX package's loss dict: ``total_loss`` and its parts."""
    src_keep = ~predictions["src_pad_mask"]
    mel_keep = ~predictions["mel_pad_mask"]
    log_duration_targets = torch.log(duration_targets.float() + 1.0)
    pitch_keep = src_keep if pitch_feature_level == "phoneme_level" else mel_keep
    energy_keep = src_keep if energy_feature_level == "phoneme_level" else mel_keep

    mel_targets = mel_targets.float()
    mel_keep3 = mel_keep[..., None].expand(mel_targets.shape)
    mel_loss = masked_mean((predictions["mel"] - mel_targets).abs(), mel_keep3)
    postnet_mel_loss = masked_mean((predictions["mel_postnet"] - mel_targets).abs(), mel_keep3)
    pitch_loss = masked_mean(
        (predictions["pitch_prediction"] - pitch_targets.float()).square(), pitch_keep)
    energy_loss = masked_mean(
        (predictions["energy_prediction"] - energy_targets.float()).square(), energy_keep)
    duration_loss = masked_mean(
        (predictions["log_duration_prediction"] - log_duration_targets).square(), src_keep)
    scale_reg = film_gate_l2(module)
    total = (mel_loss + postnet_mel_loss + duration_loss + pitch_loss + energy_loss
             + lambda_f * scale_reg)
    return {
        "total_loss": total,
        "mel_loss": mel_loss,
        "postnet_mel_loss": postnet_mel_loss,
        "pitch_loss": pitch_loss,
        "energy_loss": energy_loss,
        "duration_loss": duration_loss,
        "film_gate_l2": scale_reg,
    }
