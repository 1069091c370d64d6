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
   and the kernel / plain / library times (CUDA events, warm, median). The
   attention forward is also held to its row lse and, with the last batch
   row fully padded, to the plain version and to V's mean over the row.
4. ``synthesize_pallas_conv``: phase 2 under ``conv_impl="pallas"``; the
   conv kernel must have run 42 times per dispatch. Then the acoustic
   model, teacher-forced on phase 2's durations, pitch and energy, with
   our kernels against library ones, in float32 and in bfloat16.
5. ``profile``: one dispatch of each path traced with ``torch.profiler``:
   device time per engine stage, the busiest kernels and the device's
   idle share within the traced window.
6. ``train``: FastSpeech2 training at the full width of the LJSpeech_paper
   preset (batch 48, bf16, hash dropout) on a synthetic corpus written from
   ``--seed``, through ``run_training`` (the ``train`` command's entry), on
   the kernel path (``fused`` + ``pallas``) and the library path
   (``einsum`` + ``xla``): 12 steps with a log line each, validation and
   checkpoints inside them, every kernel count set to 0 just before and
   read just after (per step: 14 attention forwards, backwards and
   backward delta pre-passes, 42 conv forwards of which the 3 LayerNorm
   ones write ``act``; per val batch the forwards), finite losses, the
   log's step times and frames/s, peak memory, the checkpoints and their
   manifests; then a resume from the last checkpoint for 2 steps under the
   profiler, and the last step's idle share and kernel ms. Then the
   forward kernel (as in phase 3, timed writing its lse), the backward
   kernel and its delta pre-pass against their plain versions at the
   first batch's shapes and lengths (float32 and bfloat16), every conv
   of the train step at those shapes (bfloat16, timed beside cuDNN), the LN
   conv's ``act`` output against the plain one, and one step's per-leaf
   gradients, kernel path against library path, in float32 and bfloat16.

Every timed case also gives ``bound_share`` (bound ms / kernel ms) and
``vs_library`` (kernel ms / library ms, null without a library call).

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
import re
import statistics
import subprocess
import sys
import tempfile
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
# the forward's row lse against logsumexp of the plain version's f32
# scores: |kernel - plain| <= LSE_ATOL + LSE_RTOL |plain|. Both sum the exp
# terms of a row in another order (<= L 2^-24 relative in the sum, so in
# its log: 6e-5 at L = 1000) from scores whose D-term sums also differ in
# order (<= D 2^-24 sm_scale sum |q_d k_d|, ~6e-5 at D = 128); a fully
# padded row's lse is the bias (-1.7e38) in both, up to a few roundings of
# that size in the kernel's log2 units (LSE_RTOL)
LSE_ATOL, LSE_RTOL = 2e-4, 2 ** -20
# a batch row whose keys are all padded (a bucket with fewer requests than
# rows) attends uniformly over its L keys, so its output is the mean of V's
# L rows: an f32 sum of L terms (<= 2^-23 of sum |v| in the mean, with the
# tensor cores' truncating f32 adds; PAD_ROW_SUM_TOL doubles it), scaled by
# 1 / L and rounded to the output dtype (PAD_ROW_RTOL of |mean|). A kernel
# that also counted the tail of its last key tile past L would miss by
# (Lp - L) / Lp of the mean (2.3 % at L = 1000), several times this bound
PAD_ROW_RTOL = {"float32": 2 ** -22, "bfloat16": 2 ** -8 + 2 ** -22}
PAD_ROW_SUM_TOL = 2 ** -22
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
# the path (the decoder's, at T_mel), in the path's dtype; the attention
# forward's at the train step's shape, where it is operations-bound
SUMMARY_CASES = {"fused_attention_fwd": "train_attn_decoder_bfloat16",
                 "fused_conv1d_fwd": "conv_dec_ffn_w1_bfloat16",
                 "fused_attention_bwd": "attn_bwd_decoder_bfloat16",
                 "fused_attention_bwd_delta": "attn_bwd_delta_decoder_bfloat16"}

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


def shares(case: dict) -> dict:
    """A timed case with its bound share (bound ms / ms) and its factor
    against the library call (ms / library ms); None where a time is
    missing (no library call, or a run that does not time)."""
    ms, lib = case["ms"], case.get("library_ms")
    case["bound_share"] = case["bound_ms"] / ms if ms else None
    case["vs_library"] = ms / lib if ms and lib else None
    return case


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


def attended_keys(lens, L: int) -> int:
    """Keys the attention needs over all batch rows: each row's valid keys,
    or all L keys for a fully padded row (it attends uniformly)."""
    return sum(n if n else L for n in lens)


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


def attention_case(case, lengths, dtype, g, dev, train=False):
    """The forward kernel at one shape of the path and its valid lengths,
    against its plain versions: out and the row lse on the path's mask, and
    out again with the last batch row fully padded (also against V's mean
    over its L rows). Timed as the path calls it: ``fused_mha`` when
    serving, ``fused_mha_fwd`` writing its lse when training (``train``)."""
    import torch
    import torch.nn.functional as F

    from speakingstyle_torch.ops.fused_attention import (
        attention_lse_plain, fused_mha, fused_mha_fwd, fused_mha_plain,
    )

    name, axis, H, D, per_dispatch = case
    B, L, lens = lengths[axis]
    shape = (B, L, H, D)
    q, k, v = (torch.randn(shape, generator=g).to(dev, dtype) for _ in range(3))
    mask = pad_mask(lens, L).to(dev)
    scale = D ** -0.5
    dname = str(dtype).split(".")[-1]
    got, lse = fused_mha_fwd(q, k, v, mask, scale, want_lse=True)
    want, lse_want = fused_mha_plain(q, k, v, mask), attention_lse_plain(q, k, mask, scale)
    padded = mask.clone()
    padded[-1] = True
    got_pad, want_pad = fused_mha(q, k, v, padded), fused_mha_plain(q, k, v, padded)
    torch.cuda.synchronize()
    err, tol, ok = compare(got, want, "attention", dname)
    pad_err, _, pad_ok = compare(got_pad, want_pad, "attention", dname)
    lse_diff = (lse - lse_want).abs()
    lse_ok = bool((lse_diff <= LSE_ATOL + LSE_RTOL * lse_want.abs()).all())
    v_row = v[-1].float()
    mean = v_row.mean(dim=0)
    mean_diff = (got_pad[-1].float() - mean).abs()
    mean_ok = bool((mean_diff <= PAD_ROW_RTOL[dname] * mean.abs()
                    + PAD_ROW_SUM_TOL * v_row.abs().sum(dim=0)).all())
    tol.update(lse={"atol": LSE_ATOL, "rtol": LSE_RTOL},
               padded_row_vs_mean={"rtol": PAD_ROW_RTOL[dname], "sum_tol": PAD_ROW_SUM_TOL})
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    keep = ~mask[:, None, None, :]
    itemsize = q.element_size()
    # reads q and the mask once and k, v at the attended keys only, writes
    # out (and lse when training); every query row against those keys
    keys = attended_keys(lens, L)
    nbytes = (2 * q.numel() + 2 * keys * H * D) * itemsize + mask.numel() \
        + (lse.numel() * 4 if train else 0)
    bound_ms, bound_by = bound(nbytes, 4.0 * H * D * L * keys, dname)
    if train:
        run = lambda: fused_mha_fwd(q, k, v, mask, scale, want_lse=True)
        plain_ms = time_ms(lambda: fused_mha_plain(q, k, v, mask), inner=3, outer=3)
    else:
        run = lambda: fused_mha(q, k, v, mask)
        plain_ms = time_ms(lambda: fused_mha_plain(q, k, v, mask))
    return shares({
        "case": f"{'train_attn' if train else 'attn'}_{name}_{dname}",
        "kernel": "fused_attention_fwd",
        "dtype": dname, "shape": list(shape), "lengths": list(lens),
        "launches_per_dispatch": per_dispatch,
        "max_abs_err": err, "lse_max_abs_err": lse_diff.max().item(),
        "padded_row_max_abs_err": pad_err, "padded_row_vs_mean_max_abs_err":
            mean_diff.max().item(),
        "tol": tol, "ok": ok and lse_ok and pad_ok and mean_ok,
        "ms": time_ms(run), "plain_ms": plain_ms,
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=keep)),
        "bound_ms": bound_ms, "bound_by": bound_by,
    })


def conv_case(case, lengths, dtype, g, dev, prefix="conv"):
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
    return shares({
        "case": f"{prefix}_{name}_{dname}", "kernel": "fused_conv1d_fwd", "dtype": dname,
        "shape": {"B": B, "T": T, "K": K, "Cin": cin, "Cout": cout, "relu": relu, "ln": ln},
        "lengths": list(lens), "launches_per_dispatch": per_dispatch,
        "max_abs_err": err, "tol": tol, "ok": ok,
        "ms": time_ms(run), "plain_ms": time_ms(plain),
        # the conv alone (cuDNN), without the ReLU / LayerNorm epilogue
        "library_ms": time_ms(lambda: F.conv1d(xt, wt, b, padding="same")),
        "bound_ms": bound_ms, "bound_by": bound_by,
    })


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
    from speakingstyle_torch.ops.fused_attention import attention_delta, fused_mha, fused_mha_bwd
    from speakingstyle_torch.ops.fused_conv import fused_conv1d

    fused_mha.launches = fused_mha_bwd.launches = attention_delta.launches = 0
    fused_conv1d.launches = fused_conv1d.act_launches = 0


def read_counts():
    from speakingstyle_torch.ops.fused_attention import attention_delta, fused_mha, fused_mha_bwd
    from speakingstyle_torch.ops.fused_conv import fused_conv1d

    return {"fused_attention_fwd": fused_mha.launches,
            "fused_attention_bwd": fused_mha_bwd.launches,
            "fused_attention_bwd_delta": attention_delta.launches,
            "fused_conv1d_fwd": fused_conv1d.launches,
            "fused_conv1d_fwd_act": fused_conv1d.act_launches}


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
    window, busy, by_name, ours = device_time(f"profile of {path}", kernels)
    stages = {
        name: {"span_ms": r.elapsed_us() / 1e3,
               "kernel_ms": sum(e.time_range.elapsed_us() for e in kernels
                                if r.start <= e.time_range.start < r.end) / 1e3}
        for name, r in spans.items()
    }
    top = sorted(by_name.items(), key=lambda kv: kv[1][0], reverse=True)[:12]
    emit("profile", path=path, trace_window_ms=window, device_busy_ms=busy,
         idle_share=1.0 - busy / window, device_ops=len(kernels), stages=stages,
         port_kernel_ms=ours,
         top_kernels=[{"name": n[:100], "ms": ms, "calls": c} for n, (ms, c) in top])


# the port's kernels by symbol prefix (csrc/fused_conv.cu has conv_fwd_kernel
# and conv_fwd_mma_kernel; the attention backward attn_bwd_delta_kernel,
# attn_bwd_dkdv_kernel, attn_bwd_dq_kernel and their _mma twins, the delta
# pre-pass counted both in the backward's time and alone)
PORT_SYMBOLS = (("fused_attention_fwd", "(anonymous namespace)::attn_fwd"),
                ("fused_attention_bwd", "(anonymous namespace)::attn_bwd"),
                ("fused_attention_bwd_delta", "(anonymous namespace)::attn_bwd_delta"),
                ("fused_conv1d_fwd", "(anonymous namespace)::conv_fwd"))


def device_time(what, kernels):
    """(traced window ms from the first device operation's start to the
    last one's end, busy ms = the union of their intervals, {name: (ms,
    calls)}, {port kernel: ms}) of a trace's device operations."""
    if not kernels:
        fail(f"{what}: the trace holds no device operation")
    intervals = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy_us, (lo, hi) = 0.0, intervals[0]
    for s, e in intervals[1:]:
        if s > hi:
            busy_us, lo = busy_us + hi - lo, s
        hi = max(hi, e)
    busy_us += hi - lo
    by_name = {}
    for e in kernels:
        ms, calls = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, calls + 1)
    ours = {name: sum(ms for n, (ms, _) in by_name.items() if symbol in n)
            for name, symbol in PORT_SYMBOLS}
    return (hi - intervals[0][0]) / 1e3, busy_us / 1e3, by_name, ours


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


# ---------------------------------------------------------------- phase 6: training

TRAIN_STEPS = 12   # run_training's steps on each path
TRAIN_WARMUP = 2   # its first steps, left out of the medians (cuDNN plans, allocator)
# a log line every step (its one synchronisation), validation at steps 6
# and 12, checkpoints at 5 and 10 and the final flush at 12
TRAIN_STEP_CFG = {"log_step": 1, "val_step": 6, "save_step": 5}
TRAIN_TRACED = 2   # steps of the traced resume; the last one is read
# the corpus: ~100 phonemes x ~6 frames, so T_mel buckets up to 896
CORPUS_UTTS, CORPUS_VAL = 288, 48
# (tag, model overrides) of the two training paths
TRAIN_PATHS = (("kernels", {"attention_kernel": "fused", "conv_impl": "pallas"}),
               ("library", {"attention_kernel": "einsum", "conv_impl": "xla"}))
# the backward kernel against its plain version: |kernel - plain| <=
# rel_max * max|plain| + rtol * |plain|, per gradient. float32: sums in
# another order, and the row term as dO.O instead of rowsum(dP o P) (the
# same sum reordered). bfloat16: also flipped roundings of P and dS (<=
# 2^-8 relative each) inside sums over L terms, a small share of the max,
# where a dropped tile errs by a whole tile's probability mass
BWD_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2 ** -6, 2 ** -7)}
# the backward's delta pre-pass against its plain version, per row:
# |kernel - plain| <= DELTA_RTOL * sum_d |dO_d O_d|. Both sum the same f32
# products (exact even from bf16 operands) in another order, which moves the
# sum by at most D * 2^-24 (<= 7.6e-6 at D = 128) of that magnitude
DELTA_RTOL = 1e-5
# float32 gradient parity, kernel path against library path, relative to
# each leaf's max |grad|. Reordered sums alone give ~eps sqrt(n) per
# reduction (eps 6e-8, n <= B*T = 43k: 1.2e-5) over ~30 layers, ~4e-4. The
# L1 mel losses add more: their gradient is sign(pred - target) / N, so
# where the two forwards straddle a target (|pred - target| ~ 1e-6 of the
# N = B*T*80 = 3.4M elements: a few) the mel gradient moves by 2/N there,
# which moves a postnet weight's gradient, itself a sum of N such terms of
# size ~1/sqrt(N) of its max, by ~2/sqrt(N) = 1e-3 per flip (3.5e-3
# measured with one flip at N = 1e5 in a CPU rehearsal at small width).
# 2e-2 covers a few flips; a broken kernel moves gradients by O(1)
F32_GRAD_RTOL = 2e-2
# and the float32 losses of the two paths, relative
F32_LOSS_RTOL = 1e-5
# bfloat16 gradient parity: the kernel path's distance to the library
# path over the library path's own distance to float32 (both as max over
# leaves of max|difference| / max|float32 grad|). By the triangle
# inequality the ratio is <= 1 + (the kernel path's error over the library
# path's): 3 lets it be up to twice the library's (as BF16_ACOUSTIC_RATIO)
BF16_GRAD_RATIO = 3.0
# a gradient that is zero in exact arithmetic comes out of float32 sums as
# rounding noise (the key projection's bias: the softmax cancels a shift
# of a row's scores; a postnet conv's bias: the train-mode BatchNorm after
# it cancels it). A leaf whose float32 library-path max |grad| is at most
# NOISE_SHARE of the step's largest is told so; the rule and the constant
# are those of tests/test_torch_training.py. Such leaves measured <= 7.9e-10
# of the largest here (H100, the first batch) and <= 3e-8 in the test's
# tiny config, every other leaf >= 2.3e-6 here and >= 3.5e-4 there.
# Relative to its own max such a leaf would compare noise with noise, so
# on every path it is held below ZERO_GRAD_SHARE of the largest instead
NOISE_SHARE = 3e-7
ZERO_GRAD_SHARE = 1e-3


def train_config(corpus, out, seed, **model):
    from speakingstyle_torch.configs.config import load_config

    cfg = load_config(preset="LJSpeech_paper")
    rep = dataclasses.replace
    pre = rep(cfg.preprocess, path=rep(cfg.preprocess.path, preprocessed_path=corpus))
    train = rep(cfg.train, seed=seed, step=rep(cfg.train.step, **TRAIN_STEP_CFG), path=rep(
        cfg.train.path, ckpt_path=os.path.join(out, "ckpt"), log_path=os.path.join(out, "log")))
    return rep(cfg, preprocess=pre, train=train, model=rep(cfg.model, **model))


def read_log(path):
    """{"train" | "val": {step: {key: value}}} of a trainer's log.txt."""
    rows = {"train": {}, "val": {}}
    with open(path, encoding="utf-8") as fh:
        for line in fh:
            m = re.match(r"\[(\w+)\] Step (\d+), (.*)$", line.strip())
            if m:
                rows.setdefault(m[1], {})[int(m[2])] = {
                    k: float(v) for k, v in (kv.split(": ") for kv in m[3].split(", "))}
    return rows


def trace_last_step(what, events):
    """Device time of the last ``train.step`` range of a trace: the window
    from its first device operation to its last, busy ms, idle share, our
    kernels' ms and the busiest kernels."""
    from torch.autograd import DeviceType

    on_device = [e for e in events if e.device_type == DeviceType.CUDA]
    spans = sorted((e.time_range for e in on_device
                    if e.is_user_annotation and e.name == "train.step"), key=lambda r: r.start)
    if len(spans) != TRAIN_TRACED:
        fail(f"{what}: {len(spans)} train.step ranges on the device, want {TRAIN_TRACED}")
    r = spans[-1]
    kernels = [e for e in on_device
               if not e.is_user_annotation and r.start <= e.time_range.start < r.end]
    window, busy, by_name, ours = device_time(what, kernels)
    top = sorted(by_name.items(), key=lambda kv: kv[1][0], reverse=True)[:10]
    return {"trace_window_ms": window, "device_busy_ms": busy, "idle_share": 1.0 - busy / window,
            "device_ops": len(kernels), "port_kernel_ms": ours,
            "top_kernels": [{"name": k[:100], "ms": ms, "calls": c} for k, (ms, c) in top]}


def train_run(tag, cfg, dev, want, n_val):
    """``run_training`` for TRAIN_STEPS steps, every kernel count set to 0
    just before and read just after: the counts (``want``: {kernel: (per
    train step, per val batch)}, ``n_val`` val batches a pass), finite
    losses, the log's step times and frames/s, the checkpoints and their
    manifests. Then a resume from the last checkpoint for TRAIN_TRACED
    steps under the profiler. Returns the counts."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from speakingstyle_torch.training.checkpoint import MANIFEST_NAME, CheckpointManager
    from speakingstyle_torch.training.trainer import run_training

    steps, paths = cfg.train.step, cfg.train.path
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    state = run_training(cfg, device=dev, max_steps=TRAIN_STEPS)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    del state
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        resumed = run_training(cfg, device=dev, restore_step=-1,
                               max_steps=TRAIN_STEPS + TRAIN_TRACED).step
        torch.cuda.synchronize()
    traced = trace_last_step(f"train profile of {tag}", prof.events())

    log = read_log(os.path.join(paths.log_path, "log.txt"))
    train_rows, val_rows = log["train"], log["val"]
    measured = [train_rows.get(s, {}) for s in range(TRAIN_WARMUP + 1, TRAIN_STEPS + 1)]
    walls = [r.get("train_step_seconds", math.nan) * 1e3 for r in measured]
    rates = [r.get("mel_frames_per_sec", math.nan) for r in measured]
    waits = [r.get("train_data_wait_seconds", math.nan) * 1e3 for r in measured]
    total = {s: r["total_loss"] for s, r in sorted(train_rows.items())}
    val = {s: r["total_loss"] for s, r in sorted(val_rows.items())}
    last = TRAIN_STEPS + TRAIN_TRACED
    saves = set(range(steps.save_step, TRAIN_STEPS + 1, steps.save_step)) | {TRAIN_STEPS}
    want_saved = sorted(saves | {last})[-cfg.train.resilience.max_to_keep:]
    saved = CheckpointManager(paths.ckpt_path).all_steps()
    with open(os.path.join(paths.ckpt_path, str(last), MANIFEST_NAME), encoding="utf-8") as fh:
        manifest = json.load(fh)
    n_vals = last // steps.val_step  # val passes over both runs
    want_counts = {k: per_step * TRAIN_STEPS + per_val * n_val * (TRAIN_STEPS // steps.val_step)
                   for k, (per_step, per_val) in want.items()}
    emit("train", path=tag, entry="training.trainer.run_training",
         attention_kernel=cfg.model.attention_kernel, conv_impl=cfg.model.conv_impl,
         compute_dtype=cfg.model.compute_dtype, batch=cfg.train.optimizer.batch_size,
         steps=TRAIN_STEPS, warmup_steps=TRAIN_WARMUP, step_cfg=TRAIN_STEP_CFG,
         total_loss=list(total.values()), val_total_loss=val,
         step_wall_ms=walls, step_wall_ms_median=statistics.median(walls),
         mel_frames_per_s=rates, mel_frames_per_s_median=statistics.median(rates),
         data_wait_ms=waits, data_wait_ms_median=statistics.median(waits),
         max_memory_allocated_bytes=peak, launches=counts, want_launches=want_counts,
         val_batches=n_val, checkpoints=saved, manifest_leaves=len(manifest["leaves"]),
         resumed_to=resumed, traced_step=traced)
    if sorted(train_rows) != list(range(1, last + 1)):
        fail(f"train {tag}: log.txt holds train steps {sorted(train_rows)}, want 1..{last}")
    if len(val) != n_vals:
        fail(f"train {tag}: log.txt holds val steps {sorted(val)}, want {n_vals}")
    if not all(math.isfinite(v) for v in list(total.values()) + list(val.values())):
        fail(f"train {tag}: non-finite loss: train {total}, val {val}")
    if not all(math.isfinite(v) and v > 0 for v in walls + rates):
        fail(f"train {tag}: log.txt step times or frames/s missing: {walls} {rates}")
    if saved != want_saved or manifest["step"] != last or not manifest["weights_digest"]:
        fail(f"train {tag}: checkpoints {saved} (want {want_saved}), manifest step "
             f"{manifest['step']}, digest {manifest['weights_digest']}")
    if resumed != last:
        fail(f"train {tag}: the resume ended at step {resumed}, want {last}")
    for name, n in want_counts.items():
        if counts[name] != n or (want[name][0] > 0 and counts[name] == 0):
            fail(f"train {tag}: {name} launched {counts[name]} times, want {n}")
    return counts


def attention_bwd_case(name, B, L, H, D, lens, dtype, g, dev):
    """The backward kernels at one training shape and its lengths, against
    their plain versions: (the backward, delta pre-pass included, beside
    SDPA's backward with the same mask; the delta pre-pass alone)."""
    import torch
    import torch.nn.functional as F

    from speakingstyle_torch.ops.fused_attention import (
        attention_delta, attention_delta_plain, fused_mha_bwd, fused_mha_bwd_plain,
        fused_mha_fwd,
    )

    shape = (B, L, H, D)
    q, k, v, dout = (torch.randn(shape, generator=g).to(dev, dtype) for _ in range(4))
    mask = pad_mask(lens, L).to(dev)
    scale = D ** -0.5
    out, lse = fused_mha_fwd(q, k, v, mask, scale, want_lse=True)
    run = lambda: fused_mha_bwd(q, k, v, mask, out, lse, dout, scale)
    plain = lambda: fused_mha_bwd_plain(q, k, v, mask, dout, scale)
    got, want = run(), plain()
    torch.cuda.synchronize()
    dname = str(dtype).split(".")[-1]
    rel_max, rtol = BWD_TOL[dname]
    err, ok = 0.0, True
    for a, w in zip(got, want):
        diff = (a.float() - w.float()).abs()
        ok &= bool((diff <= rel_max * w.float().abs().max() + rtol * w.float().abs()).all())
        err = max(err, diff.max().item())
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
    o = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=~mask[:, None, None, :])
    dot = dout.transpose(1, 2)
    library = lambda: torch.autograd.grad(o, (qt, kt, vt), dot, retain_graph=True)
    itemsize = q.element_size()
    # reads q, out, dout, lse and the mask once and k, v at the attended keys
    # only, writes dq, dk, dv in full; five products (S, dP, dV, dQ, dK) over
    # every query row and those keys
    keys = attended_keys(lens, L)
    nbytes = (6 * q.numel() + 2 * keys * H * D) * itemsize + lse.numel() * 4 + mask.numel()
    bound_ms, bound_by = bound(nbytes, 10.0 * H * D * L * keys, dname)
    case = shares({
        "case": f"attn_bwd_{name}_{dname}", "kernel": "fused_attention_bwd", "dtype": dname,
        "shape": list(shape), "lengths": list(lens), "launches_per_step": None,
        "max_abs_err": err, "tol": {"rel_max": rel_max, "rtol": rtol}, "ok": ok,
        "ms": time_ms(run), "plain_ms": time_ms(plain, inner=3, outer=3),
        "library_ms": time_ms(library), "bound_ms": bound_ms, "bound_by": bound_by,
    })
    # the pre-pass alone: reads out and dout once, writes delta; 2 flops an element
    got, want = attention_delta(out, dout), attention_delta_plain(out, dout)
    scale = torch.einsum("blhd,blhd->bhl", dout.float().abs(), out.float().abs())
    diff = (got - want).abs()
    bound_ms, bound_by = bound(2 * q.numel() * itemsize + want.numel() * 4, 2.0 * q.numel(), dname)
    # the library's one call for f32 row sums of a bf16 product: a batched
    # 1 x D by D x 1 product with an f32 output, its rows in [B, L, H] order
    do_rows, o_cols = dout.view(-1, 1, D), out.view(-1, D, 1)
    rows = lambda: torch.bmm(do_rows, o_cols, out_dtype=torch.float32)
    try:
        got_rows = rows()
    except (RuntimeError, NotImplementedError, TypeError) as e:
        lib_err, library_ms, library_error = None, None, f"{type(e).__name__}: {e}"[:300]
    else:
        lib_err = (got_rows.view(B, L, H).transpose(1, 2) - want).abs().max().item()
        library_ms, library_error = time_ms(rows), None
    delta_case = shares({
        "case": f"attn_bwd_delta_{name}_{dname}", "kernel": "fused_attention_bwd_delta",
        "dtype": dname, "shape": list(shape), "max_abs_err": diff.max().item(),
        "tol": {"rtol_of_abs_sum": DELTA_RTOL},
        "ok": bool((diff <= DELTA_RTOL * scale).all()),
        "ms": time_ms(lambda: attention_delta(out, dout)),
        "plain_ms": time_ms(lambda: attention_delta_plain(out, dout)),
        "library_ms": library_ms, "library_max_abs_err": lib_err,
        "library_error": library_error, "bound_ms": bound_ms, "bound_by": bound_by,
    })
    return case, delta_case


def act_case(name, B, T, K, cin, cout, lens, dtype, g, dev):
    """The LN conv's act output against the plain version's."""
    import torch

    from speakingstyle_torch.ops.fused_conv import fused_conv_fwd, fused_conv_plain_parts

    x = torch.randn((B, T, cin), generator=g).masked_fill(pad_mask(lens, T)[..., None], 0.0)
    w = torch.randn((K, cin, cout), generator=g) / (K * cin) ** 0.5
    b, s, sb = (torch.randn(cout, generator=g) * 0.1 for _ in range(3))
    x, w, b, s, sb = (t.to(dev, dtype) for t in (x, w, b, s, sb))
    _, act = fused_conv_fwd(x, w, b, s, sb, relu=True, want_act=True)
    _, want = fused_conv_plain_parts(x, w, b, s, sb, 1, True)
    torch.cuda.synchronize()
    dname = str(dtype).split(".")[-1]
    err, tol, ok = compare(act, want, "conv", dname)
    return {"case": f"act_{name}_{dname}", "kernel": "fused_conv1d_fwd (act)",
            "shape": {"B": B, "T": T, "K": K, "Cin": cin, "Cout": cout},
            "max_abs_err": err, "tol": tol, "ok": ok}


def train_kernel_cases(cfg, batch, dev, seed):
    """The forward kernel, the backward kernel and its delta pre-pass at
    the first batch's shapes and real lengths (reference encoder and
    decoder over the mel frames, encoder over the phonemes), in float32 and
    bfloat16; every conv of the train step at those shapes in bfloat16 (the
    reference encoder's over the target mel frames); and the LN conv's act
    output."""
    import torch

    g = torch.Generator().manual_seed(seed + 7)
    B, L_src = batch.texts.shape
    T = batch.mels.shape[1]
    src, mel = [int(x) for x in batch.src_lens], [int(x) for x in batch.mel_lens]
    tr, re_ = cfg.model.transformer, cfg.model.reference_encoder
    n_mels = cfg.preprocess.preprocessing.mel.n_mel_channels
    lengths = {"ref": (B, T, mel), "src": (B, L_src, src), "mel": (B, T, mel)}
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for case in attention_cases(cfg):
            c = attention_case(case, lengths, dtype, g, dev, train=True)
            c["launches_per_step"] = c.pop("launches_per_dispatch")
            cases.append(c)
            emit("train_kernels", **c)
        for name, L, H, D, lens in (
                ("ref_encoder", T, re_.encoder_head, re_.encoder_hidden // re_.encoder_head, mel),
                ("encoder", L_src, tr.encoder_head, tr.encoder_hidden // tr.encoder_head, src),
                ("decoder", T, tr.decoder_head, tr.decoder_hidden // tr.decoder_head, mel)):
            cases.extend(attention_bwd_case(name, B, L, H, D, lens, dtype, g, dev))
            emit("train_kernels", **cases[-2])
            emit("train_kernels", **cases[-1])
        for name, cin in (("ref_conv_in", n_mels), ("ref_conv", re_.conv_filter_size)):
            cases.append(act_case(name, B, T, re_.conv_kernel_size, cin, re_.conv_filter_size,
                                  mel, dtype, g, dev))
            emit("train_kernels", **cases[-1])
    for case in conv_cases(cfg):
        c = conv_case(case, lengths, torch.bfloat16, g, dev, prefix="train_conv")
        c["launches_per_step"] = c.pop("launches_per_dispatch")
        cases.append(c)
        emit("train_kernels", **c)
    return {c["case"]: c for c in cases}


def grad_parity(cfg, batch, dev, seed):
    """One train step's per-leaf gradients from the same weights, batch and
    dropout masks, kernel path against library path: float32 (TF32 off)
    within F32_GRAD_RTOL of each leaf's max |grad|, bfloat16 by the distance
    ratio. Returns the failed checks."""
    import torch

    from speakingstyle_torch.models.factory import build_model, init_weights
    from speakingstyle_torch.ops.dropout import DropoutRNG
    from speakingstyle_torch.training.trainer import compute_losses, to_device

    weights = init_weights(build_model(cfg), seed).state_dict()
    arrays = to_device(batch.arrays(), dev)
    grads, loss = {}, {}
    for dtype in ("float32", "bfloat16"):
        for tag, model_kw in TRAIN_PATHS:
            c = dataclasses.replace(cfg, model=dataclasses.replace(
                cfg.model, compute_dtype=dtype, **model_kw))
            model = build_model(c)
            model.load_state_dict(weights)
            model = model.to(dev)
            named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
            with strict_float32():
                losses = compute_losses(model, c, arrays, deterministic=False,
                                        rng=DropoutRNG(seed, dev))
                gs = torch.autograd.grad(losses["total_loss"], [p for _, p in named])
            grads[f"{dtype}_{tag}"] = {n: gr.float() for (n, _), gr in zip(named, gs)}
            loss[f"{dtype}_{tag}"] = float(losses["total_loss"].detach())
            del model, gs, losses
    ref = grads["float32_library"]
    share = {name: g.abs().max().item() for name, g in ref.items()}
    top = max(share.values())
    share = {name: v / top for name, v in share.items()}
    zero = {name for name, v in share.items() if v <= NOISE_SHARE}
    rows, bad = {}, []
    loss_err = abs(loss["float32_kernels"] - loss["float32_library"]) / abs(loss["float32_library"])
    if not loss_err <= F32_LOSS_RTOL:
        bad.append(f"float32 total loss {loss['float32_kernels']} vs {loss['float32_library']}")
    for name, want in ref.items():
        scale = want.abs().max().item()
        if name in zero:
            worst = max(grads[k][name].abs().max().item() for k in grads)
            if worst > ZERO_GRAD_SHARE * top:
                bad.append(f"{name}: |grad| {worst} with zero exact gradient")
            continue
        d = lambda a, b: (grads[a][name] - grads[b][name]).abs().max().item() / scale
        rows[name] = (d("float32_kernels", "float32_library"),
                      d("bfloat16_kernels", "bfloat16_library"),
                      d("bfloat16_library", "float32_library"))
        if not rows[name][0] <= F32_GRAD_RTOL:
            bad.append(f"float32 {name}: {rows[name][0]} of its max |grad| {scale}")
    f32_worst = max(rows.items(), key=lambda kv: kv[1][0])
    err = max(r[1] for r in rows.values())
    noise = max(r[2] for r in rows.values())
    ratio = err / noise if noise > 0 else math.inf
    emit("train_grad_parity", leaves=len(ref), max_abs_grad=top, total_loss=loss,
         noise_leaves=sorted(zero), noise_share=NOISE_SHARE,
         noise_leaves_max_share=max((share[n] for n in zero), default=None),
         other_leaves_min_share=min(share[n] for n in rows),
         smallest_leaves=[[n, share[n], rows[n][0] if n in rows else None]
                          for n in sorted(share, key=share.get)[:30]],
         float32={"worst_leaf": f32_worst[0], "worst_rel_err": f32_worst[1][0],
                  "median_rel_err": statistics.median(r[0] for r in rows.values()),
                  "rtol": F32_GRAD_RTOL, "loss_rel_err": loss_err},
         bfloat16={"kernels_vs_library": err, "library_vs_float32": noise, "ratio": ratio,
                   "max_ratio": BF16_GRAD_RATIO})
    if not ratio <= BF16_GRAD_RATIO:
        bad.append(f"bfloat16 gradient ratio {ratio}")
    return bad


def train_phase(cfg_of, dev, seed):
    """Phase 6 on a synthetic corpus in a temporary directory; returns
    (the kernel path's counts, the kernel cases)."""
    from speakingstyle_torch.data.synthetic import generate_corpus
    from speakingstyle_torch.training.trainer import batch_streams

    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        corpus = generate_corpus(os.path.join(tmp, "corpus"), n_utts=CORPUS_UTTS,
                                 val_utts=CORPUS_VAL, seed=seed)
        runs = {tag: cfg_of(corpus, os.path.join(tmp, tag), seed, **kw)
                for tag, kw in TRAIN_PATHS}
        cfg = runs["kernels"]
        # run_training's own batches: its first, and the val pass's count
        stream, val = batch_streams(cfg)
        first = next(stream)
        n_val = sum(1 for _ in val.epoch(shuffle=False))
        tr, re_ = cfg.model.transformer, cfg.model.reference_encoder
        attn = re_.encoder_layer + tr.encoder_layer + tr.decoder_layer
        convs = sum(c[-1] for c in conv_cases(cfg))
        # (per train step, per val batch): the val pass runs the forwards
        # only, and without grad the LN convs write no act
        want = {"fused_attention_fwd": (attn, attn), "fused_attention_bwd": (attn, 0),
                "fused_attention_bwd_delta": (attn, 0),
                "fused_conv1d_fwd": (convs, convs), "fused_conv1d_fwd_act": (re_.conv_layer, 0)}
        counts = train_run("kernels", cfg, dev, want, n_val)
        train_run("library", runs["library"], dev, {k: (0, 0) for k in want}, n_val)
        with strict_float32():
            cases = train_kernel_cases(cfg, first, dev, seed)
        bad = [c["case"] for c in cases.values() if not c["ok"]]
        if bad:
            fail(f"train kernels disagree with their plain versions: {bad}")
        bad = grad_parity(cfg, first, dev, seed)
        if bad:
            fail(f"train gradient parity: {bad}")
    return counts, cases



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
    xla_engine, results, _ = synthesize_phase(
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
    del xla_engine, engine
    train_counts, train_cases = train_phase(train_config, dev, args.seed)
    cases.update(train_cases)

    sources = {
        "fused_attention_fwd": ("speakingstyle_torch/csrc/fused_attention.cu",
                                "speakingstyle_tpu/ops/pallas_attention.py:75",
                                train_counts["fused_attention_fwd"]),
        "fused_conv1d_fwd": ("speakingstyle_torch/csrc/fused_conv.cu",
                             "speakingstyle_tpu/ops/pallas_conv.py:91",
                             conv_counts["fused_conv1d_fwd"]),
        "fused_attention_bwd": ("speakingstyle_torch/csrc/fused_attention.cu",
                                "speakingstyle_tpu/ops/pallas_attention.py:92",
                                train_counts["fused_attention_bwd"]),
        # the backward's delta pre-pass, part of the port of the same TPU kernel
        "fused_attention_bwd_delta": ("speakingstyle_torch/csrc/fused_attention.cu",
                                      "speakingstyle_tpu/ops/pallas_attention.py:92",
                                      train_counts["fused_attention_bwd_delta"]),
    }
    summary = []
    for name, (source, replaces, launches) in sources.items():
        c = cases[SUMMARY_CASES[name]]
        summary.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": c["max_abs_err"], "ms": c["ms"],
            "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
            "library_ms": c["library_ms"], "bound_share": c["bound_share"],
            "vs_library": c["vs_library"], "case": c["case"],
        })
    print(json.dumps({"kernels": summary}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
