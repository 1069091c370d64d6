"""Chunked streaming synthesis: wav windows emitted as mel frames land
(JAX counterpart: speakingstyle_tpu/serving/streaming.py). A result that
carries a trace context records one ``vocode_window`` span per window,
from its dispatch to its collect.

HiFi-GAN is convolutional: every output sample depends only on mel frames
within its receptive field, so the wav can be produced in windows: vocode
``[start - overlap, end + overlap)`` of the mel, trim ``overlap`` frames
worth of samples from each side, and emit the centre. With
``overlap >= receptive_field_frames(generator)`` the emitted samples are
those of a full-utterance vocode up to the algorithm the convolution
library picks for each bucket, except in the final ``overlap`` tail,
where the full vocode sees the acoustic model's past-end frames and the
stream sees silence.

Windows ride the engine's prepared vocoder lattice
(``SynthesisEngine.vocode_dispatch`` pads each window into the smallest
covering ``(batch, T_mel)`` point), never ad-hoc shapes.

``stream_wav`` is a producer-consumer over the engine's asynchronous
dispatch: window k+1 is dispatched (padded into a pooled buffer, copied
in, enqueued) before window k is collected (the host readback plus trim
and int16 conversion). ``depth`` bounds the windows in flight (1 =
sequential); the emitted samples are the same at any depth, since the
pipeline reorders waiting, not the per-window arithmetic. If the consumer
abandons the stream or a later dispatch faults, the ``finally`` abandons
every in-flight handle so its pooled buffer returns, and no chunk is
emitted twice.
"""

import math
import time
from collections import deque
from typing import Iterator, Tuple

import numpy as np

from speakingstyle_torch.obs.trace import Span

__all__ = ["receptive_field_frames", "resolve_overlap", "stream_plan", "stream_wav"]


def receptive_field_frames(generator) -> int:
    """Per-side receptive field of a HiFi-GAN-family generator in mel
    frames, from its topology (``upsample_rates``,
    ``upsample_kernel_sizes``, ``resblock_kernel_sizes``,
    ``resblock_dilation_sizes``). Conservative (each stage ceils):

    * ``conv_pre`` / ``conv_post``: k=7 -> 3 taps a side;
    * each transposed-conv upsample (k, u): ``ceil(k / u / 2)`` input
      positions a side;
    * each MRF resblock at stage rate r: ``sum_d ((k-1) d + (k-1)) / 2``
      samples a side at rate r; parallel kernels take the max.
    """
    frames = 3.0  # conv_pre: k=7, d=1 at the mel rate
    rate = 1
    dil_sizes = list(generator.resblock_dilation_sizes)
    for u, k in zip(generator.upsample_rates, generator.upsample_kernel_sizes):
        frames += math.ceil(k / u / 2) / rate
        rate *= u
        per_kernel = []
        for j, rk in enumerate(generator.resblock_kernel_sizes):
            dils = dil_sizes[j] if j < len(dil_sizes) else (1,)
            # ResBlock1 pairs each dilated conv with a plain one; charging
            # both keeps the bound valid for ResBlock2 too
            per_kernel.append(sum(((rk - 1) * d) / 2 + (rk - 1) / 2 for d in dils))
        frames += max(per_kernel) / rate
    frames += 3.0 / rate  # conv_post: k=7 at the output rate
    return int(math.ceil(frames))


def resolve_overlap(cfg_overlap: int, generator) -> int:
    """The per-side overlap to stream with: the configured value, or the
    generator's receptive field when the config says 0."""
    if cfg_overlap > 0:
        return int(cfg_overlap)
    return receptive_field_frames(generator)


def stream_plan(mel_len: int, window: int, overlap: int) -> Iterator[Tuple[int, int, int, int]]:
    """Yield ``(emit_start, emit_end, ctx_start, ctx_end)`` mel-frame spans
    covering ``[0, mel_len)`` in ``window``-frame steps, each with up to
    ``overlap`` frames of context clamped to the utterance."""
    if mel_len <= 0:
        return
    for start in range(0, mel_len, window):
        end = min(start + window, mel_len)
        yield start, end, max(0, start - overlap), min(mel_len, end + overlap)


def stream_wav(engine, result, window: int, overlap: int, depth: int = 2) -> Iterator[np.ndarray]:
    """Yield int16 wav chunks of one SynthesisResult's mel, in order.

    Each chunk is one overlap-padded window vocoded through the prepared
    lattice with the margins trimmed; the chunks together cover exactly
    ``mel_len * hop`` samples. Up to ``depth`` windows are in flight
    (dispatch k+1 before collecting k)."""
    if depth < 1:
        raise ValueError(f"stream depth must be >= 1, got {depth}")
    hop = int(engine.vocoder.hop_factor)
    mel = result.mel
    trace = getattr(result, "trace", None)
    klass = getattr(result, "priority", None)
    # (handle, emit_start, emit_end, ctx_start, wall start, monotonic start)
    pending = deque()

    def collect_one() -> np.ndarray:
        handle, start, end, lo, t0, t0m = pending.popleft()
        wav = engine.vocode_collect(handle)
        if trace is not None:
            Span.record("vocode_window", t0, time.monotonic() - t0m, parent=trace,
                        frames=end - start)
        return wav[(start - lo) * hop: (end - lo) * hop]

    try:
        for start, end, lo, hi in stream_plan(int(result.mel_len), window, overlap):
            pending.append((engine.vocode_dispatch(mel[lo:hi], klass=klass, trace=trace),
                            start, end, lo, time.time(), time.monotonic()))
            if len(pending) >= depth:
                yield collect_one()
        while pending:
            yield collect_one()
    finally:
        # consumer gone or a dispatch / collect faulted: return the in-flight
        # handles' buffers; nothing is emitted here
        while pending:
            engine.vocode_abandon(pending.popleft()[0])
