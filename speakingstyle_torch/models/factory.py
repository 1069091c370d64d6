"""Model factory: build FastSpeech2 from config + preprocessed-dataset
stats, and seeded random initialisation (JAX counterpart:
speakingstyle_tpu/models/factory.py).

``init_weights`` fills a model from a seed with ``torch.Generator`` (no
trained weights are in the repository); trained weights come from the
port's checkpoints (``training/checkpoint.py``) or, as Flax-named trees,
through ``compat/from_jax.py`` (the JAX package's variables, a reference
PyTorch checkpoint converted by ``compat/torch_convert.py``).
"""

import json
import math
import os
from typing import Optional, Tuple

import torch
from torch import nn

from speakingstyle_torch.configs.config import Config
from speakingstyle_torch.models.fastspeech2 import FastSpeech2


def load_dataset_stats(cfg: Config) -> Tuple[tuple, tuple, int]:
    """(pitch_min_max, energy_min_max, n_speakers) from the preprocessed dir."""
    root = cfg.preprocess.path.preprocessed_path
    pitch_stats, energy_stats, n_speakers = (-3.0, 12.0), (-2.0, 10.0), 1
    stats_path = os.path.join(root, "stats.json") if root else ""
    if stats_path and os.path.exists(stats_path):
        with open(stats_path) as f:
            stats = json.load(f)
        pitch_stats = tuple(stats["pitch"][:2])
        energy_stats = tuple(stats["energy"][:2])
    speakers_path = os.path.join(root, "speakers.json") if root else ""
    if speakers_path and os.path.exists(speakers_path):
        with open(speakers_path) as f:
            n_speakers = max(len(json.load(f)), 1)
    return pitch_stats, energy_stats, n_speakers


def build_model(cfg: Config, n_position: Optional[int] = None) -> FastSpeech2:
    """FastSpeech2 with the dataset stats' bins and speaker count; its
    parameters are uninitialised until ``init_weights`` or
    ``compat.from_jax.load_flax_variables`` fills them."""
    pitch_stats, energy_stats, n_speakers = load_dataset_stats(cfg)
    return FastSpeech2(cfg, pitch_stats, energy_stats, n_speakers, n_position)


def _fill(module: nn.Module, name: str, shape, g: torch.Generator) -> torch.Tensor:
    """One parameter's initial value: LayerNorm / FiLM / BatchNorm scales
    one, biases zero, matrices and embeddings normal with 1/sqrt(fan_in)."""
    if name == "bias":
        return torch.zeros(shape)
    if isinstance(module, nn.LayerNorm) or name in ("s_gamma", "s_beta", "scale"):
        return torch.ones(shape)
    if isinstance(module, nn.Embedding):
        return torch.randn(shape, generator=g)
    if isinstance(module, nn.Linear):
        fan_in = shape[1]
    elif getattr(module, "FAN_IN_DIMS", None) is not None:
        fan_in = math.prod(shape[d] for d in module.FAN_IN_DIMS)
    else:
        fan_in = math.prod(shape[:-1])  # [K, Cin, Cout] conv kernels
    return torch.randn(shape, generator=g) * (getattr(module, "INIT_STD", None)
                                              or 1.0 / math.sqrt(fan_in))


@torch.no_grad()
def init_weights(module: nn.Module, seed: int = 0) -> nn.Module:
    """Fill every parameter of ``module`` from ``seed`` (CPU generator, so
    the values do not depend on the device the module lives on)."""
    g = torch.Generator().manual_seed(seed)
    for mod in module.modules():
        for name, p in mod.named_parameters(recurse=False):
            p.copy_(_fill(mod, name, tuple(p.shape), g))
    return module
