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
                 "fused_attention_bwd_delta": "attn_bwd_delta_decoder_bfloat16",
                 "fused_attention_fwd_bf16sm": "sm16_train_attn_decoder_bfloat16",
                 "fused_attention_bwd_bf16sm": "sm16_attn_bwd_decoder_bfloat16"}

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


def attention_case(case, lengths, dtype, g, dev, train=False, softmax=None):
    """The forward kernel at one shape of the path and its valid lengths,
    against its plain versions at the same softmax dtype (``softmax``,
    default float32): out and the row lse on the path's mask, and out again
    with the last batch row fully padded (also against V's mean over its L
    rows). Timed as the path calls it: ``fused_mha`` when serving,
    ``fused_mha_fwd`` writing its lse when training (``train``). Under the
    bf16 softmax q and k come from ``exact_score_qk``, the float32 kernel
    gets the SM16_P_ROUND allowance, and no library call computes the same
    function."""
    import torch
    import torch.nn.functional as F

    from speakingstyle_torch.ops.fused_attention import (
        attention_lse_plain, fused_mha, fused_mha_fwd, fused_mha_plain,
    )

    name, axis, H, D, per_dispatch = case
    B, L, lens = lengths[axis]
    shape = (B, L, H, D)
    sm16 = softmax == torch.bfloat16
    sm = torch.bfloat16 if sm16 else torch.float32
    if sm16:
        q, k = exact_score_qk(shape, dtype, g, dev)
        v = torch.randn(shape, generator=g).to(dev, dtype)
    else:
        q, k, v = (torch.randn(shape, generator=g).to(dev, dtype) for _ in range(3))
    mask = pad_mask(lens, L).to(dev)
    scale = D ** -0.5
    dname = str(dtype).split(".")[-1]
    got, lse = fused_mha_fwd(q, k, v, mask, scale, want_lse=True, softmax_dtype=sm)
    want = fused_mha_plain(q, k, v, mask, scale, sm)
    lse_want = attention_lse_plain(q, k, mask, scale, sm)
    padded = mask.clone()
    padded[-1] = True
    got_pad = fused_mha(q, k, v, padded, scale, sm)
    want_pad = fused_mha_plain(q, k, v, padded, scale, sm)
    torch.cuda.synchronize()
    atol, rtol = TOL[("attention", dname)]
    extra = SM16_P_ROUND if sm16 and dtype == torch.float32 else 0.0
    ok, errs = True, {}
    for tag, m, a, w in (("", mask, got, want), ("padded_row_", padded, got_pad, want_pad)):
        diff = (a.float() - w.float()).abs()
        allowed = atol + rtol * w.float().abs()
        if sm16:
            p, premise = sm16_probs(q, k, m, scale)
            allowed = allowed + extra * torch.einsum("bhqk,bkhd->bqhd", p, v.float().abs())
            del p
            ok &= premise
            errs[f"{tag}scores_premise"] = premise
        ok &= bool((diff <= allowed).all())
        errs[f"{tag}max_abs_err"] = diff.max().item()
    lse_diff = (lse - lse_want).abs()
    ok &= bool((lse_diff <= LSE_ATOL + LSE_RTOL * lse_want.abs()).all())
    v_row = v[-1].float()
    mean = v_row.mean(dim=0)
    mean_diff = (got_pad[-1].float() - mean).abs()
    ok &= bool((mean_diff <= PAD_ROW_RTOL[dname] * mean.abs()
                + PAD_ROW_SUM_TOL * v_row.abs().sum(dim=0)).all())
    tol = {"atol": atol, "rtol": rtol, "lse": {"atol": LSE_ATOL, "rtol": LSE_RTOL},
           "padded_row_vs_mean": {"rtol": PAD_ROW_RTOL[dname], "sum_tol": PAD_ROW_SUM_TOL}}
    if sm16:
        tol.update(p_round_of_sum_p_abs_v=extra, score_std=SM16_SCORE_STD)
    itemsize = q.element_size()
    # reads q and the mask once and k, v at the attended keys only, writes
    # out (and lse when training); every query row against those keys
    keys = attended_keys(lens, L)
    nbytes = (2 * q.numel() + 2 * keys * H * D) * itemsize + mask.numel() \
        + (lse.numel() * 4 if train else 0)
    bound_ms, bound_by = bound(nbytes, 4.0 * H * D * L * keys, dname)
    plain = lambda: fused_mha_plain(q, k, v, mask, scale, sm)
    if train:
        run = lambda: fused_mha_fwd(q, k, v, mask, scale, want_lse=True, softmax_dtype=sm)
        plain_ms = time_ms(plain, inner=3, outer=3)
    else:
        run = lambda: fused_mha(q, k, v, mask, scale, sm)
        plain_ms = time_ms(plain)
    library_ms = None  # no library call rounds the scores to bf16 before the softmax
    if not sm16:
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        keep = ~mask[:, None, None, :]
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=keep))
    return shares({
        "case": f"{'sm16_' if sm16 else ''}{'train_attn' if train else 'attn'}_{name}_{dname}",
        "kernel": "fused_attention_fwd_bf16sm" if sm16 else "fused_attention_fwd",
        "dtype": dname, "shape": list(shape), "lengths": list(lens),
        "launches_per_dispatch": per_dispatch, **errs,
        "lse_max_abs_err": lse_diff.max().item(),
        "padded_row_vs_mean_max_abs_err": mean_diff.max().item(),
        "tol": tol, "ok": ok, "ms": time_ms(run), "plain_ms": plain_ms,
        "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by,
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
    fused_mha.launches_bf16sm = fused_mha_bwd.launches_bf16sm = 0
    fused_conv1d.launches = fused_conv1d.act_launches = 0


def read_counts():
    from speakingstyle_torch.ops.fused_attention import attention_delta, fused_mha, fused_mha_bwd
    from speakingstyle_torch.ops.fused_conv import fused_conv1d

    return {"fused_attention_fwd": fused_mha.launches,
            "fused_attention_fwd_bf16sm": fused_mha.launches_bf16sm,
            "fused_attention_bwd": fused_mha_bwd.launches,
            "fused_attention_bwd_bf16sm": fused_mha_bwd.launches_bf16sm,
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


# ---------------------------------------------------------------- trained weights

# the folded vocoder's float wav against the seeded generator's on the same
# mel, float32 (TF32 off): weight norm folds each kernel back to the seeded
# one up to a few f32 roundings (g v / |v|, ~1e-7 relative), which ~30
# convs carry to ~1e-5 of the [-1, 1] output; a wrong fold moves it by O(1)
VOCODER_FOLD_ATOL = 1e-4


def smoke_configs(tmp, cfg_model=None):
    """YAML files of the LJSpeech preset for the synthesize and convert
    commands: the preset's preprocess.yaml with LEXICON as its lexicon (and
    a preprocessed dir holding speakers.json, for batch mode), its
    model.yaml with ``cfg_model``'s overrides, and its train.yaml with
    checkpoint and result paths under ``tmp``. Returns the command's
    config arguments."""
    import yaml

    from speakingstyle_torch.configs.config import PRESET_DIR

    def preset(name):
        with open(os.path.join(PRESET_DIR, "LJSpeech", name)) as f:
            return yaml.safe_load(f)

    pre, model, train = preset("preprocess.yaml"), preset("model.yaml"), preset("train.yaml")
    with open(os.path.join(tmp, "lexicon.txt"), "w") as f:
        f.write(LEXICON.strip() + "\n")
    pre["path"]["lexicon_path"] = os.path.join(tmp, "lexicon.txt")
    root = os.path.join(tmp, "preprocessed")
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "speakers.json"), "w") as f:
        json.dump({"LJSpeech": 0}, f)
    pre["path"]["preprocessed_path"] = root
    model.update(cfg_model or {})
    train["path"].update(ckpt_path=os.path.join(tmp, "ckpt"),
                         result_path=os.path.join(tmp, "result"))
    args = ["--preset", "LJSpeech"]
    for flag, name, data in (("-p", "preprocess", pre), ("-m", "model", model),
                             ("-t", "train", train)):
        path = os.path.join(tmp, f"{name}.yaml")
        with open(path, "w") as f:
            yaml.safe_dump(data, f)
        args += [flag, path]
    return args


def write_smoke_inputs(tmp, cfg, seed):
    """The smoke requests' reference wavs (float32 files, so that they load
    as the requests' own samples) and a metadata file of their texts in
    train.txt's format (phones from LEXICON); returns (wav paths, the
    metadata path)."""
    import scipy.io.wavfile

    lexicon = dict((w, ps) for w, *ps in (l.split() for l in LEXICON.strip().splitlines()))
    sr = cfg.preprocess.preprocessing.audio.sampling_rate
    wavs, lines = [], []
    for i, (text, seconds) in enumerate(zip(TEXTS, REF_SECONDS)):
        path = os.path.join(tmp, f"ref{i}.wav")
        scipy.io.wavfile.write(path, sr, reference_wav(seed + i, sr, seconds))
        wavs.append(path)
        words = re.findall(r"[a-z]+", text.lower())
        lines.append(f"r{i}|LJSpeech|{{{' '.join(p for w in words for p in lexicon[w])}}}|{text}")
    source = os.path.join(tmp, "smoke.txt")
    with open(source, "w") as f:
        f.write("\n".join(lines) + "\n")
    return wavs, source


def run_cli(argv, want):
    """``python -m speakingstyle_torch`` in this process, every kernel
    count set to 0 just before and read just after; fails unless each
    kernel of ``want`` launched its count. Returns (the command's return
    value, the counts)."""
    from speakingstyle_torch.__main__ import main as cli

    reset_counts()
    out = cli(argv)
    counts = read_counts()
    for name, n in want.items():
        if counts[name] != n:
            fail(f"{argv[0]} {argv[-1]}: {name} launched {counts[name]} times, want {n}")
    return out, counts


def check_wavs(phase, results, hop):
    """Finite, non-silent wavs of mel_len * hop samples."""
    import numpy as np

    rows = []
    for r in results:
        rms = float(np.sqrt(np.mean(r.wav.astype(np.float64) ** 2))) if len(r.wav) else 0.0
        rows.append({"id": r.id, "mel_len": r.mel_len, "wav_samples": int(len(r.wav)),
                     "wav_finite": r.wav_finite, "wav_rms": rms})
        if not (r.mel_len > 0 and len(r.wav) == r.mel_len * hop and r.wav_finite
                and bool(np.isfinite(r.mel).all()) and rms > 1.0):
            fail(f"{phase}: request {rows[-1]} is empty, silent, non-finite or mis-sized")
    return rows


def restored_phase(cfg, seed, dev, attn_per):
    """``synthesize --restore_step`` from the port's own checkpoint: the
    seeded LJSpeech engine's model saved with ``CheckpointManager``, then
    the command in single mode (each smoke request with its own reference)
    and in batch mode (a metadata file of the 4 smoke requests, one shared
    ``--ref_audio`` encoded once). Durations, mel lengths and mels must
    equal the in-memory engine's on the command's own requests, bit for
    bit: both run the same kernels at the same shapes on the same weights.
    Then one request with ``--griffin_lim``, inverted on the card: its wav
    must be (mel_len - 1) * hop samples, non-silent, and its mel equal."""
    import numpy as np
    import scipy.io.wavfile

    from speakingstyle_torch.training.checkpoint import CheckpointManager
    from speakingstyle_torch.training.optim import Optimizer
    from speakingstyle_torch.training.state import TrainState
    from speakingstyle_torch.training.trainer import trainable

    step = 4242
    engine = build_engine(cfg, seed, dev)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_restore_") as tmp:
        args = smoke_configs(tmp)
        CheckpointManager(os.path.join(tmp, "ckpt")).save(step, TrainState(
            step=step, model=engine.model,
            optimizer=Optimizer(trainable(engine.model), cfg.train)))
        wavs, source = write_smoke_inputs(tmp, cfg, seed)
        common = ["synthesize", *args, "--device", dev.type, "--restore_step", str(step),
                  "--seed", str(seed)]
        want = {"fused_attention_fwd": attn_per, "fused_attention_fwd_bf16sm": 0,
                "fused_conv1d_fwd": 0}
        runs = []
        for i, text in enumerate(TEXTS):
            ns, counts = run_cli(common + ["--mode", "single", "--text", text,
                                           "--ref_audio", wavs[i]], want)
            runs.append(("single", ns, counts))
        ns, counts = run_cli(common + ["--mode", "batch", "--source", source,
                                       "--ref_audio", wavs[0]], want)
        runs.append(("batch", ns, counts))
        rows, bad = [], []
        for mode, ns, counts in runs:
            got = ns.results
            mine = engine.run(ns.requests)
            for g, m in zip(got, mine):
                same = (g.mel_len == m.mel_len and np.array_equal(g.durations, m.durations)
                        and np.array_equal(g.mel, m.mel))
                diff = float(np.abs(g.mel - m.mel).max()) if g.mel_len == m.mel_len else None
                rows.append({"mode": mode, "id": g.id, "mel_len": g.mel_len,
                             "mel_max_abs_diff": diff, "equal": same,
                             "wav_files": os.path.isfile(os.path.join(
                                 tmp, "result", str(step), f"{g.id}.wav"))})
                if not same or not rows[-1]["wav_files"]:
                    bad.append(rows[-1])
            check_wavs(f"synthesize_restored {mode}", got, engine.vocoder.hop_factor)
            if ns.info["step"] != step:
                bad.append({"restored_step": ns.info["step"]})
        batch_engine = runs[-1][1].engine
        ns, _ = run_cli(common + ["--mode", "single", "--text", TEXTS[0], "--ref_audio",
                                  wavs[0], "--griffin_lim"], want)
        gl = ns.results[0]
        _, wav = scipy.io.wavfile.read(ns.paths[0])
        hop = cfg.preprocess.preprocessing.stft.hop_length
        rms = float(np.sqrt(np.mean(wav.astype(np.float64) ** 2))) if len(wav) else 0.0
        griffin_lim = {"id": gl.id, "mel_len": gl.mel_len, "wav_samples": int(len(wav)),
                       "wav_rms": rms,
                       "mel_equal": bool(np.array_equal(gl.mel, runs[0][1].results[0].mel))}
        if not (gl.wav is None and len(wav) == (gl.mel_len - 1) * hop and rms > 1.0
                and griffin_lim["mel_equal"]):
            bad.append({"griffin_lim": griffin_lim})
        emit("synthesize_restored", entry="cli.synthesize.main", restore_step=step,
             results=rows, batch_style_encodes=batch_engine.style_encodes,
             batch_dispatches=batch_engine.dispatches, griffin_lim=griffin_lim,
             launches={mode: counts for mode, _, counts in runs})
        if bad:
            fail(f"synthesize_restored: results differ from the in-memory engine's: {bad}")
        if batch_engine.style_encodes != 1:
            fail(f"synthesize_restored: batch mode ran the style encoder "
                 f"{batch_engine.style_encodes} times, want 1")


def reference_state_dict(cfg, seed):
    """A FastSpeech2 state dict in the reference's key naming (the port's
    copy of tests/test_convert.py's generator), at ``cfg``'s widths, from
    ``seed``: normal weights over sqrt(fan_in), LayerNorm scales near 1,
    and the duration predictor's output layer at 0.1 of that with its bias
    at ln(1 + FRAMES_PER_PHONEME), as ``build_engine`` sets it."""
    import numpy as np

    from speakingstyle_torch.text.symbols import VOCAB_SIZE

    rng = np.random.default_rng(seed)
    m = cfg.model
    tr, re_, vp = m.transformer, m.reference_encoder, m.variance_predictor
    n_mels = cfg.preprocess.preprocessing.mel.n_mel_channels
    H, bins = tr.encoder_hidden, m.variance_embedding.n_bins
    sd = {}

    def w(name, *shape):
        fan_in = int(np.prod(shape[1:])) if len(shape) > 1 else 1
        sd[name] = (rng.standard_normal(shape) / math.sqrt(fan_in)).astype(np.float32)

    def b(name, n, scale=0.1, base=0.0):
        sd[name] = (base + scale * rng.standard_normal(n)).astype(np.float32)

    def dense(p, d_in, d_out, bias=True):
        w(p + ".weight", d_out, d_in)
        if bias:
            b(p + ".bias", d_out)

    def conv(p, cin, cout, k):
        w(p + ".weight", cout, cin, k)
        b(p + ".bias", cout)

    def ln(p, d):
        b(p + ".weight", d, base=1.0)
        b(p + ".bias", d)

    def fft_block(p, d, d_inner, kernels, film):
        for name in ("w_qs", "w_ks", "w_vs", "fc"):
            dense(f"{p}.slf_attn.{name}", d, d)
        ln(f"{p}.slf_attn.layer_norm", d)
        conv(f"{p}.pos_ffn.w_1", d, d_inner, kernels[0])
        conv(f"{p}.pos_ffn.w_2", d_inner, d, kernels[1])
        ln(f"{p}.pos_ffn.layer_norm", d)
        if film:
            b(f"{p}.film.s_gamma", 1, base=1.0)
            b(f"{p}.film.s_beta", 1, base=1.0)

    sd["encoder.src_word_emb.weight"] = rng.standard_normal((VOCAB_SIZE, H)).astype(np.float32)
    for i in range(tr.encoder_layer):
        fft_block(f"encoder.layer_stack.{i}", H, tr.conv_filter_size, tr.conv_kernel_size, True)
    for i in range(tr.decoder_layer):
        fft_block(f"decoder.layer_stack.{i}", tr.decoder_hidden, tr.conv_filter_size,
                  tr.conv_kernel_size, True)
    for name in ("duration_predictor", "pitch_predictor", "energy_predictor"):
        p = f"variance_adaptor.{name}"
        conv(f"{p}.conv_layer.conv1d_1.conv", H, vp.filter_size, vp.kernel_size)
        ln(f"{p}.conv_layer.layer_norm_1", vp.filter_size)
        conv(f"{p}.conv_layer.conv1d_2.conv", vp.filter_size, vp.filter_size, vp.kernel_size)
        ln(f"{p}.conv_layer.layer_norm_2", vp.filter_size)
        b(f"{p}.film.s_gamma", 1, base=1.0)
        b(f"{p}.film.s_beta", 1, base=1.0)
        dense(f"{p}.linear_layer", vp.filter_size, 1)
    sd["variance_adaptor.duration_predictor.linear_layer.weight"] *= 0.1
    sd["variance_adaptor.duration_predictor.linear_layer.bias"] = np.full(
        (1,), math.log(1.0 + FRAMES_PER_PHONEME), np.float32)
    for name in ("pitch", "energy"):
        sd[f"variance_adaptor.{name}_bins"] = np.zeros(bins - 1, np.float32)  # skipped
        sd[f"variance_adaptor.{name}_embedding.weight"] = rng.standard_normal(
            (bins, H)).astype(np.float32)
    for i in range(re_.conv_layer):
        conv(f"reference_encoder.layer_stack.{i}.0.conv", n_mels if i == 0 else
             re_.conv_filter_size, re_.conv_filter_size, re_.conv_kernel_size)
        ln(f"reference_encoder.layer_stack.{i}.2", re_.conv_filter_size)
    dense("reference_encoder.fftb_linear.linear", re_.conv_filter_size, re_.encoder_hidden,
          bias=False)
    for i in range(re_.encoder_layer):
        fft_block(f"reference_encoder.fftb_stack.{i}", re_.encoder_hidden,
                  re_.conv_filter_size, (re_.conv_kernel_size,) * 2, False)
    dense("reference_encoder.feature_wise_affine.linear", re_.encoder_hidden,
          2 * re_.encoder_hidden, bias=False)
    dense("mel_linear", tr.decoder_hidden, n_mels)
    for i in range(m.postnet_layers):
        cin = n_mels if i == 0 else m.postnet_embedding_dim
        cout = n_mels if i == m.postnet_layers - 1 else m.postnet_embedding_dim
        conv(f"postnet.convolutions.{i}.0.conv", cin, cout, m.postnet_kernel_size)
        ln(f"postnet.convolutions.{i}.1", cout)
        b(f"postnet.convolutions.{i}.1.running_mean", cout)
        b(f"postnet.convolutions.{i}.1.running_var", cout, base=1.0)
        sd[f"postnet.convolutions.{i}.1.num_batches_tracked"] = np.zeros((), np.int64)
    return sd


def hifigan_reference_state_dict(gen):
    """The port's HiFi-GAN ``gen`` as a reference ``generator_*.pth.tar``
    state dict: the reference's module names, every conv weight-normed
    (weight_v a per-row positive multiple of the weight, weight_g the norm
    of the weight over all but dim 0), so that folding gives ``gen``'s
    weights back."""
    import numpy as np

    g = np.random.default_rng(0)
    sd = {}
    for name, t in gen.state_dict().items():
        name = re.sub(r"(ups|resblocks|convs1|convs2|convs)_(\d+)", r"\1.\2", name)
        name = name.replace(".conv.", ".").replace(".kernel", ".weight")
        a = t.detach().cpu().numpy()
        if name.endswith(".weight"):
            row = g.uniform(0.5, 2.0, (a.shape[0],) + (1,) * (a.ndim - 1)).astype(np.float32)
            sd[name[:-len("weight")] + "weight_v"] = a * row
            sd[name[:-len("weight")] + "weight_g"] = np.sqrt(
                (a.astype(np.float64) ** 2).sum(axis=tuple(range(1, a.ndim)), keepdims=True)
            ).astype(np.float32)
        else:
            sd[name] = a
    return sd


def convert_phase(cfg, seed, dev, attn_per, conv_per):
    """``convert`` then ``synthesize --vocoder_ckpt``: a full-width
    reference-format FastSpeech2 ``<step>.pth.tar`` and a weight-normed
    HiFi-GAN ``generator_*.pth.tar`` folding back to the seeded generator,
    written from ``seed``; ``convert --kind fastspeech2`` and ``--kind
    hifigan``; then single mode with the .pth.tar vocoder and batch mode
    with the .msgpack one, under ``conv_impl: pallas`` (the kernel counts
    of ``synthesize_pallas_conv``). The wavs must be finite, non-silent and
    mel_len x 256 samples; the folded vocoder within VOCODER_FOLD_ATOL of
    the seeded one on the same mel; the .msgpack vocoder bit for bit the
    .pth.tar one."""
    import torch

    from speakingstyle_torch.models.factory import init_weights
    from speakingstyle_torch.models.hifigan import DEFAULT_HIFIGAN_CONFIG, generator_from_config

    step = 900000
    seeded = init_weights(generator_from_config(DEFAULT_HIFIGAN_CONFIG), seed + 1)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_convert_") as tmp:
        args = smoke_configs(tmp, {"conv_impl": "pallas"})
        pth = os.path.join(tmp, f"{step}.pth.tar")
        sd = reference_state_dict(cfg, seed + 3)
        torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}}, pth)
        gen_pth = os.path.join(tmp, "generator_smoke.pth.tar")
        torch.save({"generator": {k: torch.from_numpy(v) for k, v in
                                  hifigan_reference_state_dict(seeded).items()}}, gen_pth)
        t0 = time.perf_counter()
        step_dir, _ = run_cli(["convert", *args, "--ckpt", pth], {})
        msgpack, _ = run_cli(["convert", "--kind", "hifigan", "--ckpt", gen_pth], {})
        convert_s = time.perf_counter() - t0
        wavs, source = write_smoke_inputs(tmp, cfg, seed)
        common = ["synthesize", *args, "--device", dev.type, "--restore_step", str(step)]
        want = {"fused_attention_fwd": attn_per, "fused_attention_fwd_bf16sm": 0,
                "fused_conv1d_fwd": conv_per}
        single, c1 = run_cli(common + ["--mode", "single", "--text", TEXTS[2], "--ref_audio",
                                       wavs[2], "--vocoder_ckpt", gen_pth], want)
        batch, c2 = run_cli(common + ["--mode", "batch", "--source", source, "--ref_audio",
                                      wavs[0], "--vocoder_ckpt", msgpack], want)
        hop = seeded.hop_factor
        rows = check_wavs("convert_reference single", single.results, hop) \
            + check_wavs("convert_reference batch", batch.results, hop)
        folded = single.engine.vocoder
        same_msgpack = all(torch.equal(a, b) for a, b in zip(
            folded.state_dict().values(), batch.engine.vocoder.state_dict().values()))
        mel = torch.from_numpy(single.results[0].mel[None]).to(dev)
        with strict_float32(), torch.inference_mode():
            fold_err = (folded(mel) - seeded.to(dev).eval()(mel)).abs().max().item()
        emit("convert_reference", entry="cli.convert.main, cli.synthesize.main",
             checkpoint=os.path.basename(step_dir), restored_step=single.info["step"],
             convert_s=convert_s, leaves=len(sd), results=rows,
             vocoder_fold_max_abs_err=fold_err, vocoder_fold_atol=VOCODER_FOLD_ATOL,
             msgpack_vocoder_equals_pth_tar=same_msgpack,
             launches={"single": c1, "batch": c2})
        if single.info["step"] != step or not fold_err <= VOCODER_FOLD_ATOL \
                or not same_msgpack:
            fail(f"convert_reference: step {single.info['step']}, vocoder fold error "
                 f"{fold_err}, msgpack equal {same_msgpack}")


# ---------------------------------------------------------------- phase 6: training

TRAIN_STEPS = 12   # run_training's steps on each path
TRAIN_WARMUP = 2   # its first steps, left out of the medians (cuDNN plans, allocator)
# a log line every step (its one synchronisation), validation at steps 6
# and 12, checkpoints at 5 and 10 and the final flush at 12
TRAIN_STEP_CFG = {"log_step": 1, "val_step": 6, "save_step": 5}
TRAIN_TRACED = 2   # steps of the traced resume; the last one is read
SM16_TRAIN_STEPS = 2  # steps of the kernel path under the bf16 softmax
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


def attention_bwd_case(name, B, L, H, D, lens, dtype, g, dev, softmax=None):
    """The backward kernels at one training shape and its lengths, from
    the forward kernel's out and lse, against their plain versions at the
    same softmax dtype (``softmax``, default float32). Returns [the
    backward, delta pre-pass included, beside SDPA's backward with the
    same mask; the delta pre-pass alone]. Under the bf16 softmax, [the
    backward] only (the pre-pass takes no flag), held to
    ``sm16_bwd_bound``, which the float32-softmax kernels from the same
    inputs must fail (the control: the bound tells the two apart)."""
    import torch
    import torch.nn.functional as F

    from speakingstyle_torch.ops.fused_attention import (
        attention_delta, attention_delta_plain, fused_mha_bwd, fused_mha_bwd_plain,
        fused_mha_fwd,
    )

    shape = (B, L, H, D)
    sm16 = softmax == torch.bfloat16
    sm = torch.bfloat16 if sm16 else torch.float32
    if sm16:
        q, k = exact_score_qk(shape, dtype, g, dev)
        v, dout = (torch.randn(shape, generator=g).to(dev, dtype) for _ in range(2))
    else:
        q, k, v, dout = (torch.randn(shape, generator=g).to(dev, dtype) for _ in range(4))
    mask = pad_mask(lens, L).to(dev)
    scale = D ** -0.5
    out, lse = fused_mha_fwd(q, k, v, mask, scale, want_lse=True, softmax_dtype=sm)
    run = lambda: fused_mha_bwd(q, k, v, mask, out, lse, dout, scale, sm)
    plain = lambda: fused_mha_bwd_plain(q, k, v, mask, dout, scale, sm)
    got, want = run(), plain()
    torch.cuda.synchronize()
    dname = str(dtype).split(".")[-1]
    err, ok, extra = 0.0, True, {}
    if sm16:
        allowed, premise = sm16_bwd_bound(q, k, v, dout, out, lse, mask, scale, want)
        out32, lse32 = fused_mha_fwd(q, k, v, mask, scale, want_lse=True)
        control = fused_mha_bwd(q, k, v, mask, out32, lse32, dout, scale)
        worst = over_bound(control, want, allowed)
        del out32, lse32, control
        ok = premise and max(worst) > 1.0
        tol = {"sm16_bwd_bound": {"exp_noise": SM16_EXP_NOISE, "sum_noise": SM16_SUM_NOISE},
               "score_std": SM16_SCORE_STD}
        extra = {"scores_premise": premise, "err_over_bound": over_bound(got, want, allowed),
                 "float32_softmax_control_err_over_bound": worst}
    else:
        rel_max, rtol = BWD_TOL[dname]
        allowed = [rel_max * w.float().abs().max() + rtol * w.float().abs() for w in want]
        tol = {"rel_max": rel_max, "rtol": rtol}
    for a, w, lim in zip(got, want, allowed):
        diff = (a.float() - w.float()).abs()
        ok &= bool((diff <= lim).all())
        err = max(err, diff.max().item())
    del allowed
    itemsize = q.element_size()
    # reads q, out, dout, lse and the mask once and k, v at the attended keys
    # only, writes dq, dk, dv in full; five products (S, dP, dV, dQ, dK) over
    # every query row and those keys
    keys = attended_keys(lens, L)
    nbytes = (6 * q.numel() + 2 * keys * H * D) * itemsize + lse.numel() * 4 + mask.numel()
    bound_ms, bound_by = bound(nbytes, 10.0 * H * D * L * keys, dname)
    library_ms = None  # no library call rounds the scores to bf16 before the softmax
    if not sm16:
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
        o = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=~mask[:, None, None, :])
        dot = dout.transpose(1, 2)
        library_ms = time_ms(lambda: torch.autograd.grad(o, (qt, kt, vt), dot,
                                                         retain_graph=True))
    case = shares({
        "case": f"{'sm16_' if sm16 else ''}attn_bwd_{name}_{dname}",
        "kernel": "fused_attention_bwd_bf16sm" if sm16 else "fused_attention_bwd",
        "dtype": dname, "shape": list(shape), "lengths": list(lens), "launches_per_step": None,
        "max_abs_err": err, **extra, "tol": tol, "ok": ok,
        "ms": time_ms(run), "plain_ms": time_ms(plain, inner=3, outer=3),
        "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by,
    })
    if sm16:
        return [case]
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
    return [case, delta_case]


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
    bwd_shapes = (
        ("ref_encoder", T, re_.encoder_head, re_.encoder_hidden // re_.encoder_head, mel),
        ("encoder", L_src, tr.encoder_head, tr.encoder_hidden // tr.encoder_head, src),
        ("decoder", T, tr.decoder_head, tr.decoder_hidden // tr.decoder_head, mel))
    for dtype in (torch.float32, torch.bfloat16):
        # the float32 softmax, then its bf16 specialisation at the same shapes
        for softmax, phase in ((torch.float32, "train_kernels"), (torch.bfloat16, "bf16_softmax")):
            for case in attention_cases(cfg):
                c = attention_case(case, lengths, dtype, g, dev, train=True, softmax=softmax)
                c["launches_per_step"] = c.pop("launches_per_dispatch")
                cases.append(c)
                emit(phase, **c)
            for name, L, H, D, lens in bwd_shapes:
                for c in attention_bwd_case(name, B, L, H, D, lens, dtype, g, dev, softmax):
                    cases.append(c)
                    emit(phase, **c)
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


def train_sm16_run(cfg, dev, attn):
    """``run_training`` for SM16_TRAIN_STEPS steps of the kernel path under
    ``attention_softmax_dtype: bfloat16``, every kernel count set to 0 just
    before and read just after: each step launches the bf16-softmax forward,
    backward and delta pre-pass once per attention layer and the
    float32-softmax kernels never; finite losses. Returns the counts."""
    from speakingstyle_torch.training.trainer import run_training

    reset_counts()
    run_training(cfg, device=dev, max_steps=SM16_TRAIN_STEPS)
    counts = read_counts()
    total = {s: r["total_loss"] for s, r in
             sorted(read_log(os.path.join(cfg.train.path.log_path, "log.txt"))["train"].items())}
    n = attn * SM16_TRAIN_STEPS
    want = {"fused_attention_fwd_bf16sm": n, "fused_attention_bwd_bf16sm": n,
            "fused_attention_bwd_delta": n, "fused_attention_fwd": 0, "fused_attention_bwd": 0}
    emit("train_bf16_softmax", entry="training.trainer.run_training",
         attention_softmax_dtype=cfg.model.attention_softmax_dtype, steps=SM16_TRAIN_STEPS,
         total_loss=list(total.values()), launches=counts, want_launches=want)
    if sorted(total) != list(range(1, SM16_TRAIN_STEPS + 1)) \
            or not all(math.isfinite(v) for v in total.values()):
        fail(f"train under the bf16 softmax: losses {total}")
    for name, want_n in want.items():
        if counts[name] != want_n:
            fail(f"train under the bf16 softmax: {name} launched {counts[name]} times, "
                 f"want {want_n}")
    return counts


def train_phase(cfg_of, dev, seed):
    """Phase 6 on a synthetic corpus in a temporary directory; returns
    (the kernel path's counts, those of its run under the bf16 softmax, the
    kernel cases)."""
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
        sm16_counts = train_sm16_run(
            cfg_of(corpus, os.path.join(tmp, "bf16_softmax"), seed, **dict(
                TRAIN_PATHS)["kernels"], attention_softmax_dtype="bfloat16"), dev, attn)
        with strict_float32():
            cases = train_kernel_cases(cfg, first, dev, seed)
        bad = [c["case"] for c in cases.values() if not c["ok"]]
        if bad:
            fail(f"train kernels disagree with their plain versions: {bad}")
        bad = grad_parity(cfg, first, dev, seed)
        if bad:
            fail(f"train gradient parity: {bad}")
    return counts, sm16_counts, cases



# ---------------------------------------------------------------- the bf16 softmax

# The bf16-softmax specialisation (attention_softmax_dtype: bfloat16) of the
# forward and backward kernels against their plain versions at the same
# softmax dtype. Its inputs put q and k on a grid of quarter steps (|q|, |k|
# < 16: exact in bf16), so every f32 sum of their products is exact in any
# order (multiples of 2^-4 below 2^14) and each score is that exact sum
# times sm_scale, rounded once to f32, on both sides: both round the same
# f32 score to bf16 and no rounding of S can flip. A kernel that rounds
# another number (an unrounded score, or the score in log2 units) then
# differs at every score, by up to half a bf16 ulp, 2^-8 |s|: at a score
# spread of SM16_SCORE_STD that moves the lse by ~1e-2, against LSE_ATOL.
# v and dout are normal.
SM16_SCORE_STD = 2.5
# the float32 forward kernel does not round P (an online softmax normalises
# at the end), where the plain version rounds the normalised P to bf16:
# <= half a bf16 ulp, 2^-8 of each p, so <= SM16_P_ROUND * sum_j p_j |v_j|
# per output on top of TOL. The bf16 kernel rounds P before the
# normalisation, as it does under the float32 softmax: TOL covers it
SM16_P_ROUND = 2 ** -8
# The backward is held per element to sm16_bwd_bound, derived from the
# same inputs, the forward kernel's out and lse included, by following the
# plain backward's arithmetic and each place where the kernels may differ:
# * P: both sides round to bf16 an f32 P that differs by f32 noise (exp
#   against exp2, and the forward kernel's lse against logsumexp, |d lse|
#   per row, measured). Only a P whose f32 value lies within that noise,
#   relative |d lse| + SM16_EXP_NOISE, of a bf16 rounding midpoint may
#   land one ulp apart; every other P is the same on both sides. A kernel
#   that rounds S elsewhere or not at all moves a P by up to 2^-8 |s| of
#   it, one that does not round P by up to 2^-8 of it: at most P, 64 times
#   or more the window.
# * delta: the kernels take dO.O from the forward kernel's O (which rounds
#   P at other points, and O to the dtype) where the plain version sums
#   dP o P: their difference is computed from out, and its effect on each
#   dS entry carried, signed, into dQ and dK.
# * dS in bfloat16: rounded on both sides from f32 values that differ by
#   that delta term (known) and the P window and noise (bounded): the
#   difference of the two roundings is exact where no rounding can flip.
# * f32 sums in another order on each side: SM16_SUM_NOISE of the sum of
#   absolute terms (random-walk error ~ sqrt(n) 2^-24 <= 2^-19 at
#   n = 1024 terms, with a margin of 8).
# * the outputs in bfloat16: each side's half-ulp rounding, 2^-8 relative.
SM16_EXP_NOISE = 2 ** -14
SM16_SUM_NOISE = 2 ** -16


def exact_score_qk(shape, dtype, g, dev):
    """q and k for the bf16-softmax cases: quarter steps of a normal draw
    scaled so that the scores' spread is about SM16_SCORE_STD."""
    import torch

    sigma = SM16_SCORE_STD ** 0.5
    q, k = ((torch.randn(shape, generator=g) * sigma * 4).round().clamp(-63, 63) / 4
            for _ in range(2))
    return q.to(dev, dtype), k.to(dev, dtype)


def sm16_probs(q, k, mask, scale):
    """(the plain version's bf16 P in f32, [B, H, L, L]; whether its f32
    scores are the exact sums times the f32 sm_scale rounded once, the
    premise of the bounds above)."""
    import numpy as np
    import torch

    from speakingstyle_torch.ops.fused_attention import _scores

    scores = _scores(q, k, mask, scale)
    exact = torch.einsum("bqhd,bkhd->bhqk", q.double(), k.double()) * float(np.float32(scale))
    keep = ~mask[:, None, None, :].expand_as(scores)
    premise = bool(torch.equal(scores[keep], exact.float()[keep]))
    del exact
    return torch.softmax(scores.to(torch.bfloat16), dim=-1).float(), premise


def sm16_bwd_bound(q, k, v, dout, out, lse, mask, scale, want, rows=8):
    """([dq, dk, dv] per-element bounds of |kernel - plain| for the
    bf16-softmax backward, as stated above, from the forward kernel's
    ``out`` and ``lse`` and the plain backward's ``want``; whether the
    exact-score premise held). Computed ``rows`` batch rows at a time."""
    import torch

    from speakingstyle_torch.ops.fused_attention import _scores

    rb = lambda x: x.to(torch.bfloat16).float()
    ein = torch.einsum
    out_ulp = 2 ** -8 if q.dtype == torch.bfloat16 else 0.0
    bounds, premise = [[], [], []], True
    for b0 in range(0, q.shape[0], rows):
        sl = slice(b0, b0 + rows)
        qf, kf, vf, g, o = (t[sl].float() for t in (q, k, v, dout, out))
        m = mask[sl]
        _, ok = sm16_probs(q[sl], k[sl], m, scale)
        premise &= ok
        s = rb(_scores(qf, kf, m, scale))
        p32 = torch.softmax(s, dim=-1)
        p = rb(p32)
        # the window: |d lse| + exp noise, relative; a fully padded row's P
        # is 1/L on both sides and its lse unused
        empty = m.all(dim=1)[:, None, None]
        d_lse = torch.where(empty, 0.0, (lse[sl] - torch.logsumexp(s, dim=-1)).abs())
        w = torch.expm1(d_lse + SM16_EXP_NOISE)[..., None]
        ep = rb(p32 * (1 + w)) - rb(p32 * (1 - w))
        del p32, w
        dp = ein("bqhd,bkhd->bhqk", g, vf)
        dp_abs = ein("bqhd,bkhd->bhqk", g.abs(), vf.abs())
        delta_k = ein("bqhd,bqhd->bhq", g, o)[..., None]
        delta_p = (dp * p).sum(dim=-1, keepdim=True)
        noise_delta = SM16_SUM_NOISE * (ein("bqhd,bqhd->bhq", g.abs(), o.abs())[..., None]
                                        + (dp_abs * p).sum(dim=-1, keepdim=True))
        ds_k = p * (dp - delta_k) * scale
        ds_p = p * (dp - delta_p) * scale
        e = (ep * (dp - delta_k).abs()
             + (p + ep) * (SM16_SUM_NOISE * dp_abs + noise_delta)) * scale
        del dp, dp_abs
        if out_ulp:
            c = rb(ds_k) - rb(ds_p)
            r = rb(ds_k + e) - rb(ds_k - e)
        else:
            c, r = ds_k - ds_p, e
        del ds_k, e
        a_abs = ds_p.abs() + c.abs() + r
        sums = [
            (ein("bhqk,bkhd->bqhd", c, kf).abs() + ein("bhqk,bkhd->bqhd", r, kf.abs())
             + 2 * SM16_SUM_NOISE * ein("bhqk,bkhd->bqhd", a_abs, kf.abs())),
            (ein("bhqk,bqhd->bkhd", c, qf).abs() + ein("bhqk,bqhd->bkhd", r, qf.abs())
             + 2 * SM16_SUM_NOISE * ein("bhqk,bqhd->bkhd", a_abs, qf.abs())),
            ein("bhqk,bqhd->bkhd", ep + 2 * SM16_SUM_NOISE * p, g.abs()),
        ]
        del c, r, a_abs, p, ep, ds_p
        for i, (a, w) in enumerate(zip(sums, want)):
            w = w[sl].float().abs()
            bounds[i].append(a * (1 + out_ulp) + 2 * out_ulp / (1 - out_ulp) * w)
    return [torch.cat(b) for b in bounds], premise


def over_bound(got, want, allowed):
    """Per gradient, the largest |got - want| over its allowance (inf where
    a zero allowance is exceeded, 0 where nothing differs)."""
    import torch

    ratios = []
    for x, w, a in zip(got, want, allowed):
        d = (x.float() - w.float()).abs()
        ratios.append(torch.where(d > 0, d / a, torch.zeros_like(d)).max().item())
    return ratios


def sm16_serve_cases(cfg, lengths, dev, seed):
    """The bf16-softmax forward at every attention shape of the serve path
    (shapes and valid lengths from ``path_lengths``), float32 and bfloat16."""
    import torch

    g = torch.Generator().manual_seed(seed + 16)
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for case in attention_cases(cfg):
            cases.append(attention_case(case, lengths, dtype, g, dev, softmax=torch.bfloat16))
            emit("bf16_softmax", **cases[-1])
    return {c["case"]: c for c in cases}


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
        {"fused_attention_fwd": attn_per, "fused_attention_fwd_bf16sm": 0,
         "fused_conv1d_fwd": 0})

    lengths = path_lengths(xla_engine, requests, results)
    with strict_float32():
        cases = kernels_phase(cfg, lengths, dev, args.seed)
        cases.update(sm16_serve_cases(cfg, lengths, dev, args.seed))
    bad = [c["case"] for c in cases.values() if not c["ok"]]
    if bad:
        fail(f"kernels disagree with their plain versions: {bad}")
    # the LJSpeech config under attention_softmax_dtype: bfloat16
    sm16_cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, attention_softmax_dtype="bfloat16"))
    _, _, sm16_counts = synthesize_phase(
        "synthesize_bf16_softmax", sm16_cfg, requests, args.seed, dev,
        {"fused_attention_fwd": 0, "fused_attention_fwd_bf16sm": attn_per,
         "fused_conv1d_fwd": 0})

    pallas_cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, conv_impl="pallas"))
    engine, _, conv_counts = synthesize_phase(
        "synthesize_pallas_conv", pallas_cfg, requests, args.seed, dev,
        {"fused_attention_fwd": attn_per, "fused_attention_fwd_bf16sm": 0,
         "fused_conv1d_fwd": conv_per})
    with strict_float32():
        bad = teacher_forced_parity(cfg, engine, requests, results, dev)
    if bad:
        fail(f"acoustic parity: {bad}")
    profile_dispatch("xla", xla_engine, requests)
    profile_dispatch("pallas", engine, requests)
    del xla_engine, engine
    restored_phase(cfg, args.seed, dev, attn_per)
    convert_phase(cfg, args.seed, dev, attn_per, conv_per)
    train_counts, train_sm16_counts, train_cases = train_phase(train_config, dev, args.seed)
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
        # the bf16-softmax specialisations (sm_dtype = bfloat16 in the TPU
        # kernels): the synthesis run's forwards, the train run's backwards
        "fused_attention_fwd_bf16sm": ("speakingstyle_torch/csrc/fused_attention.cu",
                                       "speakingstyle_tpu/ops/pallas_attention.py:75",
                                       sm16_counts["fused_attention_fwd_bf16sm"]),
        "fused_attention_bwd_bf16sm": ("speakingstyle_torch/csrc/fused_attention.cu",
                                       "speakingstyle_tpu/ops/pallas_attention.py:92",
                                       train_sm16_counts["fused_attention_bwd_bf16sm"]),
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
