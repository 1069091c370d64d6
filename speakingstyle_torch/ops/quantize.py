"""Pitch/energy bucketization (JAX counterpart: speakingstyle_tpu/ops/quantize.py).

``torch.bucketize(v, bins)`` with ``right=False`` is ``searchsorted(bins,
v, side='left')``, which is what the JAX package computes.
"""

import numpy as np
import torch


def make_bins(vmin: float, vmax: float, n_bins: int, quantization: str) -> np.ndarray:
    """[n_bins - 1] boundaries; log spacing only valid for unnormalized stats."""
    if quantization == "log":
        if vmin <= 0:
            raise ValueError(
                f"log quantization needs positive stats, got min={vmin}; "
                "z-normalized features require 'linear' (see config comment)"
            )
        return np.exp(
            np.linspace(np.log(vmin), np.log(vmax), n_bins - 1, dtype=np.float64)
        ).astype(np.float32)
    return np.linspace(vmin, vmax, n_bins - 1, dtype=np.float32)


def bucketize(values: torch.Tensor, bins: torch.Tensor) -> torch.Tensor:
    """Map continuous values to bucket ids in [0, len(bins)]."""
    return torch.bucketize(values, bins, right=False)
