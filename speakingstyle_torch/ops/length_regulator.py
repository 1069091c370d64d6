"""Length regulation, phoneme -> frame expansion (JAX counterpart:
speakingstyle_tpu/ops/length_regulator.py).

One batched gather instead of a per-phoneme loop::

    ends[i]      = cumsum(durations)[i]
    frame_to_ph  = searchsorted(ends, t, right=True)   (phone owning frame t)
    out[t]       = x[frame_to_ph[t]]

The output length is static; frames beyond sum(durations) are zero.
"""

import torch

from speakingstyle_torch.ops.masking import length_to_mask


def length_regulate(x: torch.Tensor, durations: torch.Tensor, max_mel_len: int):
    """x [B, L_src, H], durations [B, L_src] (>= 0) ->
    (frames [B, max_mel_len, H], mel_lens [B], mel_pad_mask [B, max_mel_len])."""
    if x.dim() != 3 or tuple(durations.shape) != tuple(x.shape[:2]):
        raise ValueError(
            f"length_regulate: x {tuple(x.shape)} / durations "
            f"{tuple(durations.shape)} disagree"
        )
    ends = torch.cumsum(durations.to(torch.int64), dim=1)
    mel_lens = ends[:, -1]
    frame_idx = torch.arange(max_mel_len, device=x.device, dtype=torch.int64)
    frame_idx = frame_idx[None, :].expand(x.shape[0], max_mel_len).contiguous()
    frame_to_ph = torch.searchsorted(ends, frame_idx, right=True)
    frame_to_ph = torch.clamp(frame_to_ph, max=x.shape[1] - 1)
    frames = torch.gather(
        x, 1, frame_to_ph[..., None].expand(-1, -1, x.shape[2])
    )
    mel_lens = torch.clamp(mel_lens, max=max_mel_len).to(torch.int32)
    pad_mask = length_to_mask(mel_lens, max_mel_len)
    frames = frames.masked_fill(pad_mask[..., None], 0.0)
    return frames, mel_lens, pad_mask


def predicted_durations(log_duration_pred: torch.Tensor, src_pad_mask: torch.Tensor,
                        d_control=1.0) -> torch.Tensor:
    """Free-running durations: round(exp(logd) - 1) * control, clamped at 0.

    Rounds BEFORE scaling by ``d_control`` and clamps after, the reference
    order; ``torch.round`` rounds half to even like ``jnp.round``. Padded
    source positions get duration 0.

    The cast saturates as XLA's float -> int32 convert does (NaN -> 0,
    past the range -> 2^31 - 1), where torch's cast of a non-finite or
    out-of-range float is undefined (INT32_MIN on x86): a diverged or
    poisoned model then predicts empty or full-length utterances, as in the
    JAX package, never negative lengths.
    """
    d = torch.round(torch.exp(log_duration_pred) - 1.0) * d_control
    d = torch.clamp(d, min=0.0)
    d = d.masked_fill(src_pad_mask | torch.isnan(d), 0.0)
    return d.double().clamp(max=2.0 ** 31 - 1).to(torch.int32)
