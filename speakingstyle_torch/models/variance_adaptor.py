"""Variance adaptor: duration/pitch/energy predictors + length regulation
(JAX counterpart: speakingstyle_tpu/models/variance_adaptor.py).

As in the JAX package, FiLM conditioning reaches only the duration
predictor, and bucket boundaries are n_bins-1 values with
``bucketize(right=False)``.
"""

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from speakingstyle_torch.models.layers import FiLM, LN_EPS, layer_norm, linear
from speakingstyle_torch.ops.conv import Conv1d
from speakingstyle_torch.ops.dropout import maybe_dropout
from speakingstyle_torch.ops.length_regulator import length_regulate, predicted_durations
from speakingstyle_torch.ops.quantize import bucketize, make_bins
from speakingstyle_torch.parallel.tensor import param


class VariancePredictor(nn.Module):
    """2 x (conv k=3 + ReLU + LN + dropout) -> optional FiLM -> linear -> scalar."""

    def __init__(self, in_channels: int, filter_size: int = 256, kernel_size: int = 3,
                 film: bool = False, conv_impl: str = "xla", dtype=torch.float32,
                 dropout: float = 0.0, dropout_impl: str = "hash"):
        super().__init__()
        self.dtype = dtype
        self.dropout, self.dropout_impl = dropout, dropout_impl
        for i, cin in ((1, in_channels), (2, filter_size)):
            self.add_module(f"conv1d_{i}", Conv1d(
                cin, filter_size, kernel_size, impl=conv_impl, activation="relu", dtype=dtype,
            ))
            self.add_module(f"layer_norm_{i}", nn.LayerNorm(filter_size, eps=LN_EPS))
        self.film = FiLM() if film else None
        self.linear_layer = nn.Linear(filter_size, 1)

    def forward(self, x, pad_mask, gammas=None, betas=None, deterministic: bool = True,
                rng=None):
        for i in (1, 2):
            x = getattr(self, f"conv1d_{i}")(x)
            x = layer_norm(getattr(self, f"layer_norm_{i}"), x, self.dtype)
            x = maybe_dropout(x, self.dropout, deterministic, rng, self.dropout_impl)
        if self.film is not None and gammas is not None and betas is not None:
            x = self.film(x, gammas, betas)
        out = linear(self.linear_layer, x, self.dtype)[..., 0]
        return out.float().masked_fill(pad_mask, 0.0)


class VarianceAdaptor(nn.Module):
    def __init__(self, pitch_stats: Tuple[float, float] = (-2.0, 10.0),
                 energy_stats: Tuple[float, float] = (-2.0, 10.0), n_bins: int = 256,
                 pitch_quantization: str = "linear", energy_quantization: str = "linear",
                 pitch_feature_level: str = "phoneme_level",
                 energy_feature_level: str = "phoneme_level", d_model: int = 256,
                 filter_size: int = 256, kernel_size: int = 3, film: bool = True,
                 conv_impl: str = "xla", dtype=torch.float32, dropout: float = 0.0,
                 dropout_impl: str = "hash", seq_mesh=None):
        super().__init__()
        self.dtype = dtype
        # a sequence mesh's ranks regulate to rank 0's predicted durations
        self.seq_mesh = seq_mesh
        self.pitch_level, self.energy_level = pitch_feature_level, energy_feature_level
        mk = lambda with_film: VariancePredictor(
            d_model, filter_size, kernel_size, film=with_film, conv_impl=conv_impl, dtype=dtype,
            dropout=dropout, dropout_impl=dropout_impl,
        )
        self.duration_predictor = mk(film)
        self.pitch_predictor = mk(False)
        self.energy_predictor = mk(False)
        self.pitch_embedding = nn.Embedding(n_bins, d_model)
        self.energy_embedding = nn.Embedding(n_bins, d_model)
        for name, stats, q in (("pitch_bins", pitch_stats, pitch_quantization),
                               ("energy_bins", energy_stats, energy_quantization)):
            bins = make_bins(stats[0], stats[1], n_bins, q)
            self.register_buffer(name, torch.from_numpy(bins), persistent=False)

    def _variance(self, kind, x, mask, target, control, deterministic, rng):
        pred = getattr(self, f"{kind}_predictor")(x, mask, None, None, deterministic, rng)
        if target is None:
            pred = pred * control
            target = pred
        emb = param(getattr(self, f"{kind}_embedding"), "weight").to(self.dtype)
        return pred, F.embedding(bucketize(target, getattr(self, f"{kind}_bins")), emb)

    def forward(self, x, src_pad_mask, max_mel_len: Optional[int] = None,
                pitch_target=None, energy_target=None, duration_target=None,
                p_control=1.0, e_control=1.0, d_control=1.0, gammas=None, betas=None,
                deterministic: bool = True, rng=None):
        log_d_pred = self.duration_predictor(x, src_pad_mask, gammas, betas, deterministic, rng)
        p_pred = e_pred = None
        dr = (deterministic, rng)
        if self.pitch_level == "phoneme_level":
            p_pred, p_emb = self._variance("pitch", x, src_pad_mask, pitch_target, p_control, *dr)
            x = x + p_emb
        if self.energy_level == "phoneme_level":
            e_pred, e_emb = self._variance("energy", x, src_pad_mask, energy_target, e_control,
                                           *dr)
            x = x + e_emb
        if duration_target is not None:
            durations = duration_target
        else:
            durations = predicted_durations(log_d_pred, src_pad_mask, d_control)
            if self.seq_mesh is not None:
                self.seq_mesh.broadcast_([durations])
        x, mel_lens, mel_pad_mask = length_regulate(x, durations, max_mel_len)
        if self.pitch_level == "frame_level":
            p_pred, p_emb = self._variance("pitch", x, mel_pad_mask, pitch_target, p_control, *dr)
            x = x + p_emb
        if self.energy_level == "frame_level":
            e_pred, e_emb = self._variance("energy", x, mel_pad_mask, energy_target, e_control,
                                           *dr)
            x = x + e_emb
        return {
            "features": x,
            "pitch_prediction": p_pred,
            "energy_prediction": e_pred,
            "log_duration_prediction": log_d_pred,
            "durations": durations,
            "mel_lens": mel_lens,
            "mel_pad_mask": mel_pad_mask,
        }
