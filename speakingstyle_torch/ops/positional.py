"""Sinusoid position encoding (JAX counterpart: speakingstyle_tpu/ops/positional.py)."""

import numpy as np
import torch


def sinusoid_position_table(n_position: int, d_hid: int) -> np.ndarray:
    """[n_position, d_hid] float32 table; even dims sin, odd dims cos."""
    positions = np.arange(n_position, dtype=np.float64)[:, None]
    dim_idx = np.arange(d_hid, dtype=np.float64)[None, :]
    angle_rates = 1.0 / np.power(10000.0, 2.0 * (np.floor(dim_idx / 2.0)) / d_hid)
    angles = positions * angle_rates
    table = np.empty((n_position, d_hid), dtype=np.float64)
    table[:, 0::2] = np.sin(angles[:, 0::2])
    table[:, 1::2] = np.cos(angles[:, 1::2])
    return table.astype(np.float32)


def add_position_encoding(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Add the first L rows of ``table`` ([n_position, d]) to [B, L, d]
    features; L must fit the table."""
    L = x.shape[1]
    if L > table.shape[0]:
        raise ValueError(
            f"sequence length {L} exceeds position table {table.shape[0]}; "
            "enlarge max_seq_len / n_position for long inference"
        )
    return x + table[:L].to(x.dtype)[None]
