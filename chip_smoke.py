#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``speakingstyle_torch``) on one CUDA card.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout, on a machine with an NVIDIA H100 (or any
sm_90a card), the CUDA toolkit and PyTorch built for CUDA. Phases, each
printing one JSON line:

1. ``env``: the card (``nvidia-smi`` name and power limit), torch / CUDA
   versions, and the time to build the hand-written kernels of
   ``speakingstyle_torch/csrc`` (one ``nvcc`` per source, in parallel).
   The parity comparisons run in full float32 (TF32 off in matmuls and
   cuDNN); the synthesis phases at PyTorch's defaults.
2. ``synthesize``: a ``SynthesisEngine`` at the full width of the LJSpeech
   preset (bf16, fused attention, ``conv_impl="xla"``) with seeded random
   weights answers 4 requests of different text lengths, G2P included,
   each with its own seeded synthetic reference wav of a different length.
   Every kernel count is set to 0 just before and read just after: the
   attention kernel must have run 14 times per dispatch.
3. ``kernels``: each kernel against its plain PyTorch version on the card,
   at every shape the main path gives it (phase 2's serve and style
   buckets) with the padding masks of the requests' real lengths, in
   float32 and bfloat16: the max abs error against the stated tolerance,
   and the kernel / plain / library times (CUDA events, warm, median).
4. ``synthesize_pallas_conv``: phase 2 under ``conv_impl="pallas"``; the
   conv kernel must have run 42 times per dispatch. Then the acoustic
   model, teacher-forced on phase 2's durations, pitch and energy, with
   our kernels against library ones, in float32 and in bfloat16.
5. ``profile``: one dispatch of each path traced with ``torch.profiler``:
   device time per engine stage, the busiest kernels and the device's
   idle share within the traced window.

Then a summary line of every kernel, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``. Any failed check exits non-zero before
that line; so does a machine without a card, or a directory without the
rest of the repository.
"""

import argparse
import contextlib
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# NVIDIA H100 SXM data sheet: HBM rate and dense peaks by operand type
# (bf16 on the tensor cores, float32 on the CUDA cores)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}

# each kernel against its plain version: |kernel - plain| <= atol + rtol *
# |plain| everywhere. float32: the two sum in different orders (~1e-6
# relative). bfloat16: the kernel and the plain version round at the same
# points, so what remains is a rounding flipped by a different f32 sum
# order, one bf16 ulp (<= 2^-7 |x|), and, for attention, P rounded to bf16
# before rather than after the normalisation (atol)
TOL = {
    ("attention", "float32"): (2e-5, 0.0), ("attention", "bfloat16"): (1e-2, 2 ** -7),
    ("conv", "float32"): (1e-4, 0.0), ("conv", "bfloat16"): (1e-2, 2 ** -7),
}
# the LayerNorm conv rounds its activation to the storage dtype before the
# statistics (as the TPU kernel does): where the two f32 sums round it to
# neighbouring bf16 values (<= 2^-7 |act| apart), the output moves by that
# step times |gamma| / sigma of its row, which the elementwise bound above
# does not cover; compare() adds it for the LayerNorm cases
ACT_STEP = {"float32": 0.0, "bfloat16": 2 ** -7}
# relative bound (to max |mel|) of the float32 teacher-forced acoustic
# comparisons of phase 4: ten FFT blocks and a postnet of f32 sums in
# different orders
ACOUSTIC_RTOL = 1e-4

# bfloat16 teacher-forced acoustic comparison of phase 4: the pallas-conv
# model's distance to the cuDNN-conv model, over the cuDNN-conv model's own
# distance to float32 (what bf16 rounding does to the mel). Both round at
# the same points (bf16 operands, f32 sums, bf16 outputs), so by the
# triangle inequality the ratio is <= 1 + (the kernel's rounding error over
# cuDNN's): 3 lets the kernel's be up to twice cuDNN's
BF16_ACOUSTIC_RATIO = 3.0

# the cases the summary line reports per kernel: the largest of each on
# the path (the decoder's, at T_mel), in the path's dtype
SUMMARY_CASES = {"fused_attention_fwd": "attn_decoder_bfloat16",
                 "fused_conv1d_fwd": "conv_dec_ffn_w1_bfloat16"}

TEXTS = [
    "Hello world.",
    "The quick brown fox jumps over the lazy dog.",
    "Printing, in the only sense with which we are at present concerned.",
    "It differs from most if not from all the arts and crafts represented in the exhibition.",
]
# the pronouncing lexicon of TEXTS (CMUdict ARPAbet), in read_lexicon's format
LEXICON = """
hello HH AH0 L OW1
world W ER1 L D
the DH AH0
quick K W IH1 K
brown B R AW1 N
fox F AA1 K S
jumps JH AH1 M P S
over OW1 V ER0
lazy L EY1 Z IY0
dog D AO1 G
printing P R IH1 N T IH0 NG
in IH0 N
only OW1 N L IY0
sense S EH1 N S
with W IH1 DH
which W IH1 CH
we W IY1
are AA1 R
at AE1 T
present P R EH1 Z AH0 N T
concerned K AH0 N S ER1 N D
it IH1 T
differs D IH1 F ER0 Z
from F R AH1 M
most M OW1 S T
if IH1 F
not N AA1 T
all AO1 L
arts AA1 R T S
and AH0 N D
crafts K R AE1 F T S
represented R EH2 P R IH0 Z EH1 N T IH0 D
exhibition EH2 K S AH0 B IH1 SH AH0 N
"""
# one reference recording per request, of unequal lengths: 603, 474, 345
# and 216 frames at hop 256, 22050 Hz, in the style bucket of 1000
REF_SECONDS = (7.0, 5.5, 4.0, 2.5)
DISPATCHES = 3
FRAMES_PER_PHONEME = 6


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        fail(f"nvidia-smi exited {out.returncode}: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, inner: int = 10, outer: int = 7) -> float:
    """Median over ``outer`` samples of the mean device time of ``inner``
    back-to-back calls (CUDA events around the run), after a warm-up."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(outer):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / inner)
    return statistics.median(samples)


def bound(nbytes: float, flops: float, dtype: str):
    """(least time in ms for these bytes and operations on the card, the
    side that bounds it)."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def compare(got, want, kind: str, dtype: str, ln_parts=None):
    """(max abs error, tolerance dict, within tolerance everywhere).
    ``ln_parts`` = (pre-LN activation, LN scale) adds, per element, the
    LayerNorm conv's allowance for a rounding step of its activation."""
    atol, rtol = TOL[(kind, dtype)]
    diff = (got.float() - want.float()).abs()
    bound = atol + rtol * want.float().abs()
    tol = {"atol": atol, "rtol": rtol}
    if ln_parts is not None:
        act, scale = (t.float() for t in ln_parts)
        sigma = act.std(dim=-1, unbiased=False, keepdim=True)
        bound = bound + ACT_STEP[dtype] * act.abs() * scale.abs() / (sigma + 1e-5)
        tol["ln_act_step"] = ACT_STEP[dtype]
    ok = bool((diff <= bound).all())
    return diff.max().item(), tol, ok


def pad_mask(lens, L: int):
    """[B, L] bool, True at padding, from the valid lengths ``lens``."""
    import torch

    return torch.arange(L)[None, :] >= torch.tensor(lens)[:, None]


# ---------------------------------------------------------------- phase 2


def attention_cases(cfg):
    """(name, length axis, heads, head dim, launches per dispatch) of every
    attention of the main path."""
    tr, re = cfg.model.transformer, cfg.model.reference_encoder
    return [
        ("ref_encoder", "ref", re.encoder_head, re.encoder_hidden // re.encoder_head,
         re.encoder_layer),
        ("encoder", "src", tr.encoder_head, tr.encoder_hidden // tr.encoder_head,
         tr.encoder_layer),
        ("decoder", "mel", tr.decoder_head, tr.decoder_hidden // tr.decoder_head,
         tr.decoder_layer),
    ]


def conv_cases(cfg):
    """(name, length axis, K, Cin, Cout, relu, layernorm, launches per
    dispatch) of every conv of the main path under ``conv_impl="pallas"``."""
    m = cfg.model
    tr, re, vp = m.transformer, m.reference_encoder, m.variance_predictor
    n_mels = cfg.preprocess.preprocessing.mel.n_mel_channels
    k1, k2 = tr.conv_kernel_size
    rk, rf = re.conv_kernel_size, re.conv_filter_size
    pk, pe = m.postnet_kernel_size, m.postnet_embedding_dim
    return [
        ("ref_conv_in", "ref", rk, n_mels, rf, True, True, 1),
        ("ref_conv", "ref", rk, rf, rf, True, True, re.conv_layer - 1),
        ("ref_ffn_w1", "ref", rk, re.encoder_hidden, rf, True, False, re.encoder_layer),
        ("ref_ffn_w2", "ref", rk, rf, re.encoder_hidden, False, False, re.encoder_layer),
        ("enc_ffn_w1", "src", k1, tr.encoder_hidden, tr.conv_filter_size, True, False,
         tr.encoder_layer),
        ("enc_ffn_w2", "src", k2, tr.conv_filter_size, tr.encoder_hidden, False, False,
         tr.encoder_layer),
        # two convs in each of the duration, pitch and energy predictors
        # (phoneme-level); the second's Cin is filter_size, equal here
        ("variance_predictor", "src", vp.kernel_size, tr.encoder_hidden, vp.filter_size,
         True, False, 6),
        ("dec_ffn_w1", "mel", k1, tr.decoder_hidden, tr.conv_filter_size, True, False,
         tr.decoder_layer),
        ("dec_ffn_w2", "mel", k2, tr.conv_filter_size, tr.decoder_hidden, False, False,
         tr.decoder_layer),
        ("postnet_in", "mel", pk, n_mels, pe, False, False, 1),
        ("postnet_mid", "mel", pk, pe, pe, False, False, m.postnet_layers - 2),
        ("postnet_out", "mel", pk, pe, n_mels, False, False, 1),
    ]


def path_lengths(engine, requests, results):
    """{length axis: (batch, padded length, valid lengths)} of the main
    path's dispatch: the style bucket over the reference frames, and the
    serve bucket over the phonemes and the predicted mel frames."""
    b = results[0].bucket
    sb, r = engine.style_lattice.cover(len(requests), max(len(q.ref_mel) for q in requests))

    def rows(lens, n):
        return list(lens) + [0] * (n - len(lens))

    return {
        "ref": (sb, r, rows([len(q.ref_mel) for q in requests], sb)),
        "src": (b.b, b.l_src, rows([res.src_len for res in results], b.b)),
        "mel": (b.b, b.t_mel, rows([res.mel_len for res in results], b.b)),
    }


def attention_case(case, lengths, dtype, g, dev):
    import torch
    import torch.nn.functional as F

    from speakingstyle_torch.ops.fused_attention import fused_mha, fused_mha_plain

    name, axis, H, D, per_dispatch = case
    B, L, lens = lengths[axis]
    shape = (B, L, H, D)
    q, k, v = (torch.randn(shape, generator=g).to(dev, dtype) for _ in range(3))
    mask = pad_mask(lens, L).to(dev)
    dname = str(dtype).split(".")[-1]
    got = fused_mha(q, k, v, mask)
    want = fused_mha_plain(q, k, v, mask)
    torch.cuda.synchronize()
    err, tol, ok = compare(got, want, "attention", dname)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    keep = ~mask[:, None, None, :]
    itemsize = q.element_size()
    # data-dependent work: every query row against its batch row's valid keys
    flops = 4.0 * H * D * L * float(sum(lens))
    bound_ms, bound_by = bound(4 * q.numel() * itemsize + mask.numel(), flops, dname)
    return {
        "case": f"attn_{name}_{dname}", "kernel": "fused_attention_fwd",
        "dtype": dname, "shape": list(shape), "lengths": list(lens),
        "launches_per_dispatch": per_dispatch,
        "max_abs_err": err, "tol": tol, "ok": ok,
        "ms": time_ms(lambda: fused_mha(q, k, v, mask)),
        "plain_ms": time_ms(lambda: fused_mha_plain(q, k, v, mask)),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=keep)),
        "bound_ms": bound_ms, "bound_by": bound_by,
    }


def conv_case(case, lengths, dtype, g, dev):
    import torch
    import torch.nn.functional as F

    from speakingstyle_torch.ops.fused_conv import (
        fused_conv1d, fused_conv_plain, fused_conv_relu_ln,
    )

    name, axis, K, cin, cout, relu, ln, per_dispatch = case
    B, T, lens = lengths[axis]
    mask = pad_mask(lens, T)
    x = torch.randn((B, T, cin), generator=g).masked_fill(mask[..., None], 0.0)
    w = torch.randn((K, cin, cout), generator=g) / (K * cin) ** 0.5
    b = torch.randn(cout, generator=g) * 0.1
    s = 1.0 + 0.1 * torch.randn(cout, generator=g)
    sb = 0.1 * torch.randn(cout, generator=g)
    x, w, b, s, sb = (t.to(dev, dtype) for t in (x, w, b, s, sb))
    if ln:
        run = lambda: fused_conv_relu_ln(x, w, b, s, sb)
        plain = lambda: fused_conv_plain(x, w, b, s, sb, 1, True)
    else:
        run = lambda: fused_conv1d(x, w, b, relu=relu)
        plain = lambda: fused_conv_plain(x, w, b, None, None, 1, relu)
    dname = str(dtype).split(".")[-1]
    got, want = run(), plain()
    torch.cuda.synchronize()
    ln_parts = (fused_conv_plain(x, w, b, None, None, 1, True), s) if ln else None
    err, tol, ok = compare(got, want, "conv", dname, ln_parts)
    xt, wt = x.transpose(1, 2).contiguous(), w.permute(2, 1, 0).contiguous()
    itemsize = x.element_size()
    nbytes = (x.numel() + w.numel() + got.numel() + (3 if ln else 1) * cout) * itemsize
    bound_ms, bound_by = bound(nbytes, 2.0 * B * T * K * cin * cout, dname)
    return {
        "case": f"conv_{name}_{dname}", "kernel": "fused_conv1d_fwd", "dtype": dname,
        "shape": {"B": B, "T": T, "K": K, "Cin": cin, "Cout": cout, "relu": relu, "ln": ln},
        "lengths": list(lens), "launches_per_dispatch": per_dispatch,
        "max_abs_err": err, "tol": tol, "ok": ok,
        "ms": time_ms(run), "plain_ms": time_ms(plain),
        # the conv alone (cuDNN), without the ReLU / LayerNorm epilogue
        "library_ms": time_ms(lambda: F.conv1d(xt, wt, b, padding="same")),
        "bound_ms": bound_ms, "bound_by": bound_by,
    }


def kernels_phase(cfg, lengths, dev, seed):
    """Every kernel case of the main path (shapes and valid lengths from
    ``path_lengths``) in float32 and bfloat16; returns {case: result}."""
    import torch

    g = torch.Generator().manual_seed(seed)
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for case in attention_cases(cfg):
            cases.append(attention_case(case, lengths, dtype, g, dev))
            emit("kernels", **cases[-1])
        for case in conv_cases(cfg):
            cases.append(conv_case(case, lengths, dtype, g, dev))
            emit("kernels", **cases[-1])
    return {c["case"]: c for c in cases}


# ---------------------------------------------------------------- phases 2 and 4


def reference_wav(seed: int, sr: int, seconds: float):
    """A seeded synthetic voice-like reference: a gliding harmonic source
    with vibrato under a syllable-rate envelope, plus breath noise."""
    import numpy as np

    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    f0 = 140 + 30 * np.sin(2 * np.pi * 0.3 * t) + 4 * np.sin(2 * np.pi * 5.5 * t)
    phase = 2 * np.pi * np.cumsum(f0) / sr
    amps = rng.uniform(0.2, 1.0, 12) / np.arange(1, 13)
    voiced = sum(a * np.sin((h + 1) * phase) for h, a in enumerate(amps))
    env = 0.5 * (1 + np.sin(2 * np.pi * 4.0 * t + rng.uniform(0, 2 * np.pi)))
    wav = env * voiced + 0.01 * rng.standard_normal(t.shape)
    return (0.3 * wav / np.abs(wav).max()).astype(np.float32)


def make_requests(cfg, seed):
    import numpy as np

    from speakingstyle_torch.control import english_word_spans, spans_to_sequence
    from speakingstyle_torch.serving.engine import SynthesisRequest
    from speakingstyle_torch.serving.style import mel_from_wav_array

    lexicon = {}
    for line in LEXICON.strip().splitlines():
        word, *phones = line.split()
        lexicon[word] = phones
    pp = cfg.preprocess.preprocessing
    requests = []
    for i, (text, seconds) in enumerate(zip(TEXTS, REF_SECONDS)):
        spans = english_word_spans(text, lexicon)
        if any(ps == ["spn"] for _, ps in spans):
            fail(f"a word of {text!r} is missing from the lexicon")
        seq = spans_to_sequence(spans, pp.text.text_cleaners)
        ref_mel = mel_from_wav_array(
            cfg, reference_wav(seed + i, pp.audio.sampling_rate, seconds))
        requests.append(SynthesisRequest(id=f"r{i}", sequence=np.asarray(seq, np.int32),
                                         ref_mel=ref_mel, raw_text=text))
    return requests


def build_engine(cfg, seed, dev):
    import torch

    from speakingstyle_torch.models.factory import init_weights
    from speakingstyle_torch.models.hifigan import DEFAULT_HIFIGAN_CONFIG, generator_from_config
    from speakingstyle_torch.serving.engine import SynthesisEngine

    vocoder = init_weights(generator_from_config(DEFAULT_HIFIGAN_CONFIG), seed + 1)
    engine = SynthesisEngine(cfg, vocoder=vocoder, device=dev, seed=seed)
    # random weights put the log-durations far from any real speech (a
    # random FiLM beta shifts a whole utterance); scale the duration
    # predictor's output layer so they sit near ln(1 + 6), LJSpeech's
    # ~6 frames per phoneme
    lin = engine.model.variance_adaptor.duration_predictor.linear_layer
    with torch.no_grad():
        lin.weight.mul_(0.1)
        lin.bias.fill_(math.log(1.0 + FRAMES_PER_PHONEME))
    return engine


@contextlib.contextmanager
def strict_float32():
    """Full float32 in matmuls and cuDNN convs (cuDNN defaults to TF32) for
    the parity comparisons; the synthesis phases run at PyTorch's
    defaults, as a user of the port would."""
    import torch

    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def reset_counts():
    from speakingstyle_torch.ops.fused_attention import fused_mha
    from speakingstyle_torch.ops.fused_conv import fused_conv1d

    fused_mha.launches = 0
    fused_conv1d.launches = 0


def read_counts():
    from speakingstyle_torch.ops.fused_attention import fused_mha
    from speakingstyle_torch.ops.fused_conv import fused_conv1d

    return {"fused_attention_fwd": fused_mha.launches, "fused_conv1d_fwd": fused_conv1d.launches}


def synthesize_phase(phase, cfg, requests, seed, dev, want_per_dispatch):
    """Drive ``SynthesisEngine.run`` ``DISPATCHES`` times (after one warm-up
    run), with every kernel count set to 0 just before and read just after;
    check the counts and the wavs."""
    import numpy as np
    import torch

    engine = build_engine(cfg, seed, dev)
    engine.run(requests)  # warm-up: cuDNN plans, allocator
    torch.cuda.synchronize()
    engine.dispatches = 0
    walls = []
    reset_counts()
    for _ in range(DISPATCHES):
        t0 = time.perf_counter()
        results = engine.run(requests)  # ends in a device -> host copy
        walls.append((time.perf_counter() - t0) * 1e3)
    counts = read_counts()
    n = engine.dispatches
    hop = engine.vocoder.hop_factor
    rows = []
    for r in results:
        rms = float(np.sqrt(np.mean(r.wav.astype(np.float64) ** 2))) if len(r.wav) else 0.0
        rows.append({
            "id": r.id, "phonemes": r.src_len, "mel_len": r.mel_len,
            "wav_samples": int(len(r.wav)), "wav_finite": r.wav_finite,
            "mel_finite": bool(np.isfinite(r.mel).all()), "wav_rms": rms,
        })
    b = results[0].bucket
    emit(phase, conv_impl=cfg.model.conv_impl, compute_dtype=cfg.model.compute_dtype,
         bucket={"b": b.b, "l_src": b.l_src, "t_mel": b.t_mel}, dispatches=n,
         launches=counts, want_launches_per_dispatch=want_per_dispatch,
         dispatch_wall_ms=walls, dispatch_wall_ms_median=statistics.median(walls),
         requests=rows)
    for row in rows:
        if not (row["mel_len"] > 0 and row["wav_samples"] == row["mel_len"] * hop
                and row["wav_finite"] and row["mel_finite"] and row["wav_rms"] > 1.0):
            fail(f"{phase}: request {row} is empty, silent, non-finite or mis-sized")
    for name, per in want_per_dispatch.items():
        # a kernel of this path must have run; one off it must not have
        if counts[name] != per * n or (per > 0 and counts[name] == 0):
            fail(f"{phase}: {name} launched {counts[name]} times, want {per} x {n}")
    return engine, results, counts


def profile_dispatch(path, engine, requests):
    """One dispatch under ``torch.profiler``: the device time of the
    kernels inside each engine stage's range (``synthesis.*``), the
    busiest kernels, and the device's idle share within the traced window,
    from the start of its first device operation to the end of its last.
    The profiler adds host time to every launch, so the share is an upper
    bound on an unprofiled dispatch's."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        engine.run(requests)
        torch.cuda.synchronize()
    on_device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = {e.name: e.time_range for e in on_device
             if e.is_user_annotation and e.name.startswith("synthesis.")}
    kernels = [e for e in on_device if not e.is_user_annotation]
    if not kernels:
        fail(f"profile of {path}: the trace holds no device operation")
    # busy = the union of the operations' intervals (us)
    intervals = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy_us, (lo, hi) = 0.0, intervals[0]
    for s, e in intervals[1:]:
        if s > hi:
            busy_us, lo = busy_us + hi - lo, s
        hi = max(hi, e)
    busy_us += hi - lo
    window = (hi - intervals[0][0]) / 1e3
    busy = busy_us / 1e3
    stages = {
        name: {"span_ms": r.elapsed_us() / 1e3,
               "kernel_ms": sum(e.time_range.elapsed_us() for e in kernels
                                if r.start <= e.time_range.start < r.end) / 1e3}
        for name, r in spans.items()
    }
    by_name = {}
    for e in kernels:
        ms, calls = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, calls + 1)
    top = sorted(by_name.items(), key=lambda kv: kv[1][0], reverse=True)[:12]
    # device time of the port's own kernels in this dispatch, by symbol
    # (csrc/fused_conv.cu has conv_fwd_kernel and conv_fwd_mma_kernel)
    ours = {name: sum(ms for n, (ms, _) in by_name.items() if symbol in n)
            for name, symbol in (("fused_attention_fwd", "(anonymous namespace)::attn_fwd"),
                                 ("fused_conv1d_fwd", "(anonymous namespace)::conv_fwd"))}
    emit("profile", path=path, trace_window_ms=window, device_busy_ms=busy,
         idle_share=1.0 - busy / window, device_ops=len(kernels), stages=stages,
         port_kernel_ms=ours,
         top_kernels=[{"name": n[:100], "ms": ms, "calls": c} for n, (ms, c) in top])


# (tag, compute dtype, conv_impl, attention_kernel) of the teacher-forced runs
PARITY_RUNS = (
    ("f32_kernels", "float32", "pallas", "fused"),
    ("f32_cudnn_conv", "float32", "xla", "fused"),
    ("f32_plain", "float32", "xla", "einsum"),
    ("bf16_kernels", "bfloat16", "pallas", "fused"),
    ("bf16_cudnn_conv", "bfloat16", "xla", "fused"),
)


def teacher_forced_parity(cfg, engine, requests, results, dev):
    """The acoustic model teacher-forced on phase 2's durations, pitch and
    energy (so that no duration's rounding flip can hide a fault), with our
    kernels against library ones; returns the failed checks.

    * float32: the fused-attention + kernel-conv model and the all-plain
      model against the fused-attention + cuDNN-conv model (phase 2's
      path), within ``ACOUSTIC_RTOL`` of max |mel|;
    * bfloat16, the model's compute dtype (the conv on the tensor-core
      kernel): the kernel-conv model's distance to the cuDNN-conv model
      over the cuDNN-conv model's own distance to float32, within
      ``BF16_ACOUSTIC_RATIO``."""
    import numpy as np
    import torch

    from speakingstyle_torch.models.factory import build_model

    b = results[0].bucket
    B, L, T = b.b, b.l_src, b.t_mel
    r = engine.style_lattice.cover(len(requests), max(len(q.ref_mel) for q in requests))[1]
    texts = np.zeros((B, L), np.int64)
    src_lens = np.zeros((B,), np.int64)
    d = np.zeros((B, L), np.int64)
    p = np.zeros((B, L), np.float32)
    e = np.zeros((B, L), np.float32)
    mels = np.zeros((B, r, engine.n_mels), np.float32)
    mel_lens = np.ones((B,), np.int64)
    for i, (q, res) in enumerate(zip(requests, results)):
        n = res.src_len
        texts[i, :n], src_lens[i] = q.sequence, n
        d[i, :n], p[i, :n], e[i, :n] = res.durations, res.pitch_prediction, res.energy_prediction
        mels[i, : len(q.ref_mel)], mel_lens[i] = q.ref_mel, len(q.ref_mel)
    args = [torch.from_numpy(a).to(dev) for a in (np.zeros((B,), np.int64), texts, src_lens)]
    kw = {k: torch.from_numpy(v).to(dev) for k, v in
          dict(mels=mels, mel_lens=mel_lens, d_targets=d, p_targets=p, e_targets=e).items()}
    state = engine.model.state_dict()
    outs = {}
    for tag, dtype, conv_impl, attention in PARITY_RUNS:
        mcfg = dataclasses.replace(cfg.model, compute_dtype=dtype, conv_impl=conv_impl,
                                   attention_kernel=attention)
        model = build_model(dataclasses.replace(cfg, model=mcfg),
                            n_position=engine.model.encoder.layer_stack.pe.shape[0])
        model.load_state_dict(state)
        model = model.to(dev).eval()
        with torch.inference_mode():
            outs[tag] = model(*args, max_mel_len=T, **kw)["mel_postnet"].float()
        del model
    keep = torch.zeros((B, T, 1), dtype=torch.bool, device=dev)
    for i, res in enumerate(results):
        keep[i, : res.mel_len] = True

    def dist(a, b):  # max abs difference over the real frames
        return (outs[a] - outs[b]).masked_fill(~keep, 0).abs().max().item()

    scale = float(outs["f32_cudnn_conv"].masked_fill(~keep, 0).abs().max())
    f32 = {"max_abs_mel": scale, "rtol": ACOUSTIC_RTOL,
           "kernels_vs_cudnn_conv_max_abs_err": dist("f32_kernels", "f32_cudnn_conv"),
           "plain_vs_cudnn_conv_max_abs_err": dist("f32_plain", "f32_cudnn_conv")}
    emit("acoustic_parity_f32", **f32)
    err, noise = dist("bf16_kernels", "bf16_cudnn_conv"), dist("bf16_cudnn_conv", "f32_cudnn_conv")
    bf16 = {"max_abs_mel": scale,
            "kernels_vs_cudnn_conv_max_abs_err": err,
            "cudnn_conv_vs_f32_max_abs_err": noise,
            "kernels_vs_f32_max_abs_err": dist("bf16_kernels", "f32_cudnn_conv"),
            "ratio": err / noise if noise > 0 else math.inf,
            "max_ratio": BF16_ACOUSTIC_RATIO}
    emit("acoustic_parity_bf16", **bf16)
    bad = [f"float32 {tag}: {f32[f'{tag}_vs_cudnn_conv_max_abs_err']}"
           for tag in ("kernels", "plain")
           if not f32[f"{tag}_vs_cudnn_conv_max_abs_err"] <= ACOUSTIC_RTOL * scale]
    if not bf16["ratio"] <= BF16_ACOUSTIC_RATIO:
        bad.append(f"bfloat16 kernels: ratio {bf16['ratio']}")
    return bad


# ---------------------------------------------------------------- main


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    if not os.path.isdir(os.path.join(REPO, "speakingstyle_torch", "csrc")):
        fail(f"{REPO} holds no speakingstyle_torch/csrc: run from a checkout of the repository")
    sys.path.insert(0, REPO)
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    dev = torch.device("cuda", 0)

    from speakingstyle_torch.configs.config import load_config
    from speakingstyle_torch.ops import kernels

    smi = nvidia_smi()
    t0 = time.perf_counter()
    build = kernels.build_all()
    emit("env", nvidia_smi=smi, device=torch.cuda.get_device_name(0),
         capability=list(torch.cuda.get_device_capability(0)), torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0],
         build_wall_s=time.perf_counter() - t0, build_s=build,
         ptxas={n: kernels.ptxas_report(n).splitlines() for n in kernels.SOURCES},
         tf32_in_parity_phases=False,
         tf32_in_synthesis_phases={"matmul": torch.backends.cuda.matmul.allow_tf32,
                                   "cudnn": torch.backends.cudnn.allow_tf32})

    cfg = load_config(preset="LJSpeech")
    requests = make_requests(cfg, args.seed)
    # launches per dispatch of each kernel: 14 attentions, 42 convs
    attn_per = sum(c[-1] for c in attention_cases(cfg))
    conv_per = sum(c[-1] for c in conv_cases(cfg))
    xla_engine, results, attn_counts = synthesize_phase(
        "synthesize", cfg, requests, args.seed, dev,
        {"fused_attention_fwd": attn_per, "fused_conv1d_fwd": 0})

    with strict_float32():
        cases = kernels_phase(cfg, path_lengths(xla_engine, requests, results), dev, args.seed)
    bad = [c["case"] for c in cases.values() if not c["ok"]]
    if bad:
        fail(f"kernels disagree with their plain versions: {bad}")

    pallas_cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, conv_impl="pallas"))
    engine, _, conv_counts = synthesize_phase(
        "synthesize_pallas_conv", pallas_cfg, requests, args.seed, dev,
        {"fused_attention_fwd": attn_per, "fused_conv1d_fwd": conv_per})
    with strict_float32():
        bad = teacher_forced_parity(cfg, engine, requests, results, dev)
    if bad:
        fail(f"acoustic parity: {bad}")
    profile_dispatch("xla", xla_engine, requests)
    profile_dispatch("pallas", engine, requests)

    sources = {
        "fused_attention_fwd": ("speakingstyle_torch/csrc/fused_attention.cu",
                                "speakingstyle_tpu/ops/pallas_attention.py:75",
                                attn_counts["fused_attention_fwd"]),
        "fused_conv1d_fwd": ("speakingstyle_torch/csrc/fused_conv.cu",
                             "speakingstyle_tpu/ops/pallas_conv.py:91",
                             conv_counts["fused_conv1d_fwd"]),
    }
    summary = []
    for name, (source, replaces, launches) in sources.items():
        c = cases[SUMMARY_CASES[name]]
        summary.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": c["max_abs_err"], "ms": c["ms"],
            "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
            "library_ms": c["library_ms"], "case": c["case"],
        })
    print(json.dumps({"kernels": summary}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
