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
   buckets) with the padding masks of the requests' real lengths, and the
   LayerNorm conv past one cluster of 8 x 128 channels (Cout 1536, 2048),
   in float32 and bfloat16: the max abs error against the stated tolerance,
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

7. ``kernels_nonfinite`` (run after phase 3): each kernel against its plain
   version on inputs with one NaN and one +inf planted at valid positions,
   at the LJSpeech_paper train widths, float32 and bfloat16: the attention
   forward and backward with the plant in q, k or v, the conv plain, with
   ReLU and with ReLU + LayerNorm + ``act``. The non-finite output
   positions must be the same. Then ``all_finite`` on the card.
8. ``train_resilience`` (in phase 6's corpus): the ``train`` command in
   subprocesses with the preset's resilience defaults (NaN sentinel,
   keep-best, async saves): ``--faults nan_grads@7,loader_ioerror@3`` over
   12 steps (one rollback to step 5, the loader error retried, the kernels'
   launches per step unchanged, the best checkpoint kept), then
   ``--faults sigterm@8`` (a flushed step-8 checkpoint) and
   ``--restore_step -1`` to step 12, held to two runs that stop at step 8
   without the signal and resume. The four chains of runs (the NaN drill,
   the SIGTERM drill, each baseline) run at once, each chain's runs in
   turn.
9. ``train_remat``: 4 steps with ``sharding.remat`` off and on (the
   checkpointed blocks' forwards launched twice), peak memory, step time,
   and one step's gradients with dropout on, remat against no remat.
10. ``train_costs``: the NaN sentinel on vs off and the prefetcher vs the
   inline copy (8-step runs in turns: step time, data wait, iteration),
   the sentinel's own device operations and ms, the save stall sync vs
   async, the checkpoint's bytes.
11. ``train_vocoder`` (after phase 4's restore and convert phases): the
   ``train_vocoder`` command at the reference recipe's sizes (HiFi-GAN V1,
   MPD periods 2 3 5 7 11, MSD 3 scales, batch 16 x 8192 samples, lr
   5e-4) on 32 seeded 2 s wavs: 20 steps, every metric finite and
   ``mel_l1`` at the last below the first, step ms, peak memory, TF32;
   ``--restore`` of its checkpoint for 2 more steps; its
   ``.generator.msgpack`` in ``synthesize --vocoder_ckpt`` (a finite wav).
12. ``train_vocoder_resilience``: ``nan_grads@3`` gives exactly one
   rollback (to the step-2 checkpoint); ``sigterm@4`` (the command in a
   subprocess, which runs while this process runs the NaN drill) exits 0
   with a flushed checkpoint, and the resume from it logs steps 5-6.
13. ``vocode``: the trained generator on a mel dir (both layouts) and on
   a wav dir: int16 wavs of T x 256 samples.
14. ``distill`` (inside phase 6, from its kernel path's checkpoint, the
   duration layer set as phase 2 sets it): ``run_distillation`` at the
   JAX defaults (batch 8, 12 phonemes, 144 frames) and at (48, 128,
   1000), 30 steps each: every kernel count set to 0 just before and read
   just after, held to the launches a step exactly (15 attention
   forwards, 5 backwards and δ pre-passes, 49 convs); the loss falls; the
   student restores from ``<ckpt>/student``; its reference encoder stays
   bit-equal to the teacher's and the teacher unchanged; the step's ms
   (30 steps), device busy ms and idle share (3 traced steps), and peak
   memory. The ``distill`` command's drills (``nan_grads@6``: one
   rollback to step 4; ``sigterm@7``: flushed at 7). One step's student
   gradients, kernel path against library path (the rule of phase 6),
   for 3 seeds under deterministic algorithms, the first seed repeated
   bit for bit.
15. ``distill_kernels``: the student's new conv shapes (k9 256 -> 512
   +ReLU, k1 512 -> 256, postnet k5 80 -> 256 and 256 -> 80) and the
   attention forward, backward and δ at both distill sizes, against their
   plain versions, timed.

16. ``serve_http`` (after phase 4's ``synthesize_restored``, from its
   checkpoint): the single-engine HTTP path. The LJSpeech preset at full
   width on the kernel path (bf16 compute, bf16 softmax) with its whole
   lattice (48 acoustic, 12 vocoder, 12 style points), built and
   precompiled through the ``serve`` command's ``load_engine`` and
   ``precompile`` (programs, seconds, ``memory_reserved``), behind
   ``SynthesisServer`` on 127.0.0.1:0 with a frontend pool of 2. The
   traffic runs under torch.profiler, every kernel count set to 0 just
   before it and read just after (the port's kernels counted by name in
   the trace must equal the registry's credits): the four references
   uploaded with POST /styles, 4 closed-loop clients sending 32
   /synthesize requests, 8 /synthesize/stream requests one at a time, a
   burst of queue_depth + 16 concurrent requests (200 or 429 + Retry-After
   only). Then shutdown() while 2 streams are in flight (both complete,
   later requests get 503). Every 200 is a RIFF wav of mel_len x 256
   samples that passes the quality gate and whose whole wav matches
   ``engine.run(eager=True)`` of the same request alone; each stream is
   within ``STREAM_LSB`` of its
   full wav outside the overlap tail; no program is prepared over the
   traffic. Client latency p50 / p90 / max, TTFA, batches and occupancy,
   sheds and the server's histograms are printed. Then ``python -m
   speakingstyle_torch serve`` in a subprocess on that checkpoint and a
   one-point lattice answers a request and a two-sentence chapter on
   /synthesize/longform, and exits 0 on SIGTERM.
17. ``serve_fleet`` (after ``serve_http``, from the same checkpoint): the
   fleet router on the one card, two replicas in this process, built by
   the serve command's fleet branch (``build_fleet``: the checkpoint
   loaded once, one shared StyleService), on the kernel path at a lattice
   of batch {1, 4} x src {128} x mel {256, 1000} and style (b, 1000).
   Replica 0 warms alone, then serves requests while replica 1 warms (the
   device gate's waits of replica 0's dispatches in that window are
   printed) and ``memory_reserved`` is read at 1 and 2 replicas. Steady
   traffic under torch.profiler (4 closed-loop clients x 8 /synthesize, 4
   streams): both replicas dispatch, nothing is prepared, the port's
   kernels counted by name in the trace equal the credits summed over both
   replicas. A ``replica_raise`` and a ``replica_hang`` drill under
   concurrent requests (the watchdog at 1.5 s): every request 200, the
   breakers open and close, the failed replicas come back READY, their
   old engines are closed and ``memory_reserved`` stays within one
   replica's graphs of its pre-drill reading. POST /admin/rollout to a
   second step of the same weights under load: committed, every replica on
   the new version and digest, no request failed, the surge's memory
   polled. Every 200 within ``SERVE_HTTP_LSB`` of ``run(eager=True)`` of
   one engine, streams within ``STREAM_LSB`` outside the overlap tail.
   ``serve --replicas 2`` in a subprocess (started at the end of
   ``serve_http``, beside its ``serve``): /healthz 503, then 200, and one
   /synthesize 200 and one /synthesize/longform 200.
18. ``serve_tiers`` (after ``serve_fleet``, from the same checkpoint, kernel
   path and lattice): the quality tiers teacher-f32 / teacher-bf16 /
   teacher-int8 as three one-replica fleets (``serving.tiers.tier_fleets``:
   an engine each over the weights loaded once, one StyleService) behind
   one ``TierRouter`` (interactive -> bf16, batch -> int8) behind
   ``SynthesisServer`` with a ``GoldenProber``; ``memory_reserved`` with
   the three up. Under torch.profiler, every kernel count set to 0 just
   before and read just after (the port's kernels counted by name in the
   trace equal the credits): each narrower tier's ``tier_gate`` on the
   card while the anchor serves 2 clients (both ship; ``mel_l2``, ms),
   and a control, int8 with its scales perturbed, refused;
   open-loop traffic from a ``TrafficModel`` schedule over 10 s, its
   long_form events chapters on /synthesize/longform (200 or 429 +
   Retry-After only, ``X-Model-Tier`` the class's tier, the tier dispatch
   counters equal to the routed submits, nothing prepared; p50 / p90 /
   max per class); anchors pinned and one probe round with zero
   drift; a chapter of at least 8 chunks on /synthesize/longform beside 2
   interactive clients (the tier and chunk headers, the stitcher's sample
   arithmetic, each chunk outside the crossfades within
   ``SERVE_HTTP_LSB`` of the chunk run alone, seam RMS, TTFA, the
   clients' p50 with and without the chapter); ``tier_poison`` on the
   int8 fleet: the prober pages on it alone, its gate refuses it and
   ``batch`` falls back to teacher-f32.
19. ``serve_cluster`` (after ``serve_tiers``, from the same checkpoint, kernel
   path and lattice): the cluster, built through the serve command's
   cluster branch (``serve.cluster.enabled``): the router, the StyleService
   and ``SynthesisServer`` in this process, two ``python -m
   speakingstyle_torch replica`` processes on the card, each with its own
   engine and graphs. /healthz 503 until both are READY; each one's
   spawn-to-lease seconds and ``memory_reserved``; neither rebuilt a kernel
   library. Steady traffic (4 uploads, 4 closed-loop clients x 8) inside one
   POST /debug/profile fan-out: in each process the port's kernels counted
   by name in its window equal the launches it credited; X-Served-By names
   both replicas; nothing prepared; latency, wire latency, hedges,
   idempotent hits. One traced request joined across the processes; the
   federated /metrics' wire dispatches add up to the router's. Drills under
   8 concurrent requests (hedging off): ``replica_proc_kill`` (nothing
   lost, a fresh process READY, the card's memory back), ``net_partition``
   then heal (the same pid re-admitted, nothing captured again), a
   replica's SIGTERM (its batch in flight answered, exit 0). Every 200
   within ``SERVE_HTTP_LSB`` of ``run(eager=True)``. No replica process
   outlives the phase. ``serve --replicas 2 --cluster`` in a subprocess
   (started beside the partition and SIGTERM drills, which measure no time
   or memory): /healthz 503 then 200, one request 200, exit 0 on SIGTERM,
   its replicas gone.

20. ``train_dp`` (inside phase 6, on its corpus): data-parallel training on
   the one card, 2 rank processes sharing it over gloo (NCCL refuses two
   ranks on one device), LJSpeech_paper at full width on the kernel path,
   global batch 48 (24 rows a rank), hash dropout. The ranks
   (``--train_dp_worker``, started by ``parallel/launch.py``) take 2 steps
   at strict float32 from the same seeded weights; before each, rank 0
   takes one process's step on the whole global batch from a copy of the
   same state, and the two are held to the train phase's bounds
   (``dp_judge``: losses, every gradient, the parameters and BatchNorm
   statistics after the step); the ranks' weights digests are equal after
   every step and each rank launches 14 / 14 / 14 / 42 kernels a step; a
   rank's traced step counts them by name (as credited), its all-reduce
   ms and its idle share; both steps' ms, ``memory_reserved`` a rank.
   Then at once: ``train --data_parallel 2 --max_steps 3 --faults
   nan_grads@3`` (rank 0's rows poisoned: both ranks roll back to step 2,
   one writer of log.txt), its dp = 2 checkpoint restored at dp = 1 (every
   leaf as saved) and stepped; one NCCL rank at world size 1 in this
   process (a step, its gradients all-reduced and parameters broadcast on
   the card); ``train_vocoder --data_parallel 2`` (3 steps, equal digests
   on both ranks). Every number is labelled "2 ranks sharing one card over
   gloo": a check of the path, not a multi-card measurement.
21. ``train_tp`` (inside phase 20's rank processes, after their
   data-parallel steps): the same two processes re-formed as dp = 1 x
   tp = 2 (new groups), each keeping its shards of a fresh state of the
   same weights (the JAX rules' layout), the global batch of 48 on both:
   2 steps at strict float32, each held (``dp_judge``) against one
   process's step from the same state gathered whole; the whole state and
   the replicated leaves digest equal on both ranks after every step, 14 /
   14 / 14 / 42 launches a rank step (0 for the bf16-softmax kernels) and
   as many by name in a traced step, with its ``tp.all_reduce`` ms.
   ``train_tp_command``: beside phase 20's commands, ``train
   --model_parallel 2 --max_steps 2`` at the preset's widths cut to 1
   encoder and 1 decoder layer (bf16): each step logged once, rank 0's
   launches those of 2 steps of the cut model, its whole checkpoint
   restored at tp = 1 (every leaf and Adam moment as saved) and stepped.
   The train phase's kernel cases also run each kernel at the local
   shapes of tp = 2 and 4 (``*_tp2_*``, ``*_tp4_*``).

22. ``serve_ring`` (after ``serve_cluster``, from the same checkpoint): the
   ring long-form tier (``serve.longform.mesh_seq: 2``) as the serve
   command builds it on one engine, at full width on the kernel path in
   float32 and the preset's long-form lattice (src {512, 1024} x mel {6144,
   12288}): ``RingTier`` starts one helper rank process (the two ranks share
   the card over gloo), broadcasts rank 0's weights (digests checked) and
   prepares its 4 points (cards without graphs, ``kind=acoustic_ring``).
   A chapter of 600-900 phonemes on /synthesize/longform (every count set
   to 0 just before and read just after) answers ``X-Longform-Tier: ring``
   at ``b1.s1024.m12288`` with mel_len x 256 samples; a repeat prepares
   nothing and equals it; a traced ring dispatch counts kernel #3 by name
   as credited and kernel #1 not at all; the mel is held against a
   one-process dense free run (einsum attention over 12288 frames) of the
   same weights and inputs (``SERVE_RING_RTOL`` x max |mel|); kernel #3 at
   the ring's shapes against its plain version; ``longform_ring_error``
   and a killed helper each answer the next chapter chunked, the server
   up. Rotation and gather ms, the helper's spawn-to-ready seconds, each
   rank's memory and the dense oracle's are printed.

Every timed case also gives ``bound_share`` (bound ms / kernel ms) and
``vs_library`` (kernel ms / library ms, null without a library call).
A ``phase_seconds`` line gives each phase's seconds and the total.

Then a summary line of every kernel (with its launches a distill step and
in the traces of the ``serve_http`` and ``serve_fleet`` traffic, the
``serve_tiers`` phase and the ``serve_cluster`` processes' windows, the
``serve_ring`` chapter, and a data-parallel and a tensor-parallel rank's
train step),
the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``. Any failed check exits non-zero before
that line; so does a machine without a card, or a directory without the
rest of the repository.
"""

import argparse
import contextlib
import dataclasses
import gc
import json
import math
import os
import pathlib
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


T0 = time.perf_counter()


PHASE_S = {}  # seconds of each phase of main()


def timed(name, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, its wall seconds kept under ``name``."""
    t0 = time.perf_counter()
    try:
        return fn(*args, **kwargs)
    finally:
        PHASE_S[name] = time.perf_counter() - t0


def emit(phase: str, **fields) -> None:
    """One JSON line of a phase, with the seconds since the script started."""
    print(json.dumps({"phase": phase, **fields,
                      "elapsed_s": round(time.perf_counter() - T0, 3)}), flush=True)


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
    sb, r = engine.style.lattice.cover(len(requests), max(len(q.ref_mel) for q in requests))

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


def conv_case(case, lengths, dtype, g, dev, prefix="conv", bias=True):
    """One conv of the path against its plain version (``bias`` False: the
    conv without one, as a tensor-parallel rank's row slice of ``w_2``
    runs)."""
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
    if not bias:
        b = None
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
    nbytes = (x.numel() + w.numel() + got.numel() + ((3 if ln else 1) if bias else 0) * cout) \
        * itemsize
    bound_ms, bound_by = bound(nbytes, 2.0 * B * T * K * cin * cout, dname)
    return shares({
        "case": f"{prefix}_{name}_{dname}", "kernel": "fused_conv1d_fwd", "dtype": dname,
        "shape": {"B": B, "T": T, "K": K, "Cin": cin, "Cout": cout, "relu": relu, "ln": ln,
                  "bias": bias},
        "lengths": list(lens), "launches_per_dispatch": per_dispatch,
        "max_abs_err": err, "tol": tol, "ok": ok,
        "ms": time_ms(run), "plain_ms": time_ms(plain),
        # the conv alone (cuDNN), without the ReLU / LayerNorm epilogue
        "library_ms": time_ms(lambda: F.conv1d(xt, wt, b, padding="same")),
        "bound_ms": bound_ms, "bound_by": bound_by,
    })


def preset_style_dispatches(cfg, requests):
    """[(batch, ref bucket, valid lengths)] of the encoder dispatches the
    StyleService makes for ``requests``' fresh references under ``cfg``'s
    style lattice: grouped by covering ref bucket in arrival order, chunked
    at the largest batch, as ``StyleService.encode_mels`` does."""
    from speakingstyle_torch.serving.lattice import StyleLattice

    lattice = StyleLattice.from_config(cfg.serve)
    groups = {}
    for q in requests:
        groups.setdefault(lattice.cover(1, len(q.ref_mel))[1], []).append(len(q.ref_mel))
    out = []
    for r, lens in groups.items():
        for at in range(0, len(lens), lattice.max_batch):
            chunk = lens[at: at + lattice.max_batch]
            b, r = lattice.cover(len(chunk), r)
            out.append((b, r, chunk + [0] * (b - len(chunk))))
    return out


# Cout of the LayerNorm conv past one cluster of 8 x 128 channels (each
# block then computes two 128-channel tiles in turn): held at the reference
# encoder's shapes (k3 from 1024 channels, the style dispatch's rows), on no
# preset's path (every reference_encoder.conv_filter_size is 1024)
WIDE_LN_COUTS = (1536, 2048)


def kernels_phase(cfg, lengths, dev, seed, style_dispatches=()):
    """Every kernel case of the main path (shapes and valid lengths from
    ``path_lengths``) in float32 and bfloat16, the reference encoder's
    cases at each of ``style_dispatches``' other shapes, and the LN conv at
    ``WIDE_LN_COUTS``; returns {case: result}."""
    import torch

    g = torch.Generator().manual_seed(seed)
    ref_attn = [c for c in attention_cases(cfg) if c[1] == "ref"]
    ref_conv = [c for c in conv_cases(cfg) if c[1] == "ref"]
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for case in attention_cases(cfg):
            cases.append(attention_case(case, lengths, dtype, g, dev))
            emit("kernels", **cases[-1])
        for case in conv_cases(cfg):
            cases.append(conv_case(case, lengths, dtype, g, dev))
            emit("kernels", **cases[-1])
        re_ = cfg.model.reference_encoder
        for cout in WIDE_LN_COUTS:
            case = (f"ref_conv_ln_c{cout}", "ref", re_.conv_kernel_size, re_.conv_filter_size,
                    cout, True, True, 0)
            cases.append(conv_case(case, lengths, dtype, g, dev))
            emit("kernels", **cases[-1])
        for b, r, lens in style_dispatches:
            if (b, r) == lengths["ref"][:2]:
                continue
            at = {"ref": (b, r, lens)}
            for name, *rest in ref_attn:
                cases.append(attention_case((f"{name}_b{b}_r{r}", *rest), at, dtype, g, dev))
                emit("kernels", **cases[-1])
            for name, *rest in ref_conv:
                cases.append(conv_case((f"{name}_b{b}_r{r}", *rest), at, dtype, g, dev))
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


def serve_cell(cfg):
    """The serve cell's config, cut to one style bucket (ref 1000), so a
    dispatch's fresh references (603-216 frames) encode together in the
    style bucket (4, 1000) and every phase counts one encoder dispatch a
    dispatch. (The StyleService groups references by their covering ref
    bucket: under the preset's [256, 512, 1000] these four take three
    encoder dispatches, whose other shapes ``kernels_phase`` holds against
    the plain versions.)"""
    return dataclasses.replace(cfg, serve=dataclasses.replace(
        cfg.serve, style=dataclasses.replace(cfg.serve.style, ref_buckets=[1000])))


def build_engine(cfg, seed, dev):
    import torch

    from speakingstyle_torch.models.factory import build_model, init_weights
    from speakingstyle_torch.models.hifigan import DEFAULT_HIFIGAN_CONFIG, generator_from_config
    from speakingstyle_torch.serving.engine import SynthesisEngine, n_position_for

    vocoder = init_weights(generator_from_config(DEFAULT_HIFIGAN_CONFIG), seed + 1)
    model = init_weights(build_model(cfg, n_position=n_position_for(cfg)), seed)
    # random weights put the log-durations far from any real speech (a
    # random FiLM beta shifts a whole utterance); scale the duration
    # predictor's output layer so they sit near ln(1 + 6), LJSpeech's
    # ~6 frames per phoneme (before the engine casts its precision tiers)
    lin = model.variance_adaptor.duration_predictor.linear_layer
    with torch.no_grad():
        lin.weight.mul_(0.1)
        lin.bias.fill_(math.log(1.0 + FRAMES_PER_PHONEME))
    return SynthesisEngine(cfg, model=model, vocoder=vocoder, device=dev)


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


# plain kernels at the head of a trace (see prime_trace)
TRACE_PRIMER_KERNELS = 256


def prime_trace():
    """Run just after a profiler starts, before any device work its trace
    counts: ``TRACE_PRIMER_KERNELS`` plain PyTorch kernels (float64, a dtype
    the model does not use), then wait for them. On the H100 a trace has
    dropped the records of its first few kernels, however long after the
    start they ran: ``serve_tiers`` lost the first one or two LayerNorm
    convs of its first graph replay, which the registry credited, in 8
    runs of 29 with at most 2 plain kernels (or a 1 s wait) ahead of it,
    and in none of 8 with this primer; a plain kernel launched 1 s after
    the start was missing from 3 traces of 7."""
    import torch

    x = torch.zeros(1, dtype=torch.float64, device="cuda")
    for _ in range(TRACE_PRIMER_KERNELS):
        x.add_(1.0)
    torch.cuda.synchronize()


def read_counts():
    from speakingstyle_torch.training.trainer import kernel_launches

    return kernel_launches()


def synthesize_phase(phase, cfg, requests, seed, dev, want_per_dispatch):
    """Drive ``SynthesisEngine.run(eager=True)`` ``DISPATCHES`` times (after
    a warm-up that prepares the programs and runs them eagerly once), with
    every kernel count set to 0 just before and read just after; check the
    counts and the wavs. Eager, so that every count is one the kernel
    wrappers made where they launched (a replayed graph's launches are
    counted from a trace in ``serve_core_phase``)."""
    import numpy as np
    import torch

    engine = build_engine(cfg, seed, dev)
    engine.run(requests)  # warm-up: prepares (captures) the programs
    engine.run(requests, eager=True)
    torch.cuda.synchronize()
    first = engine.dispatch_count
    walls = []
    reset_counts()
    for _ in range(DISPATCHES):
        # every dispatch encodes its references afresh (the path of a new
        # reference): the StyleService's cache is emptied before it
        engine.style.clear()
        t0 = time.perf_counter()
        results = engine.run(requests, eager=True)  # ends in a device -> host copy
        walls.append((time.perf_counter() - t0) * 1e3)
    counts = read_counts()
    n = engine.dispatch_count - first
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
         bucket={"b": b.b, "l_src": b.l_src, "t_mel": b.t_mel}, dispatches=n, eager=True,
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
    bound on an unprofiled dispatch's. The dispatch replays its graphs:
    its port kernels counted in the trace must equal the launches the
    registry credited."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    engine.style.clear()  # a dispatch with fresh references, as synthesize_phase times
    reset_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        engine.run(requests)
        torch.cuda.synchronize()
    credited = read_counts()
    on_device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = {e.name: e.time_range for e in on_device
             if e.is_user_annotation and e.name.startswith("synthesis.")}
    kernels = [e for e in on_device if not e.is_user_annotation]
    window, busy, by_name, ours = device_time(f"profile of {path}", kernels)
    in_trace = check_trace(f"profile of {path}", by_name, credited)
    stages = {
        name: {"span_ms": r.elapsed_us() / 1e3,
               "kernel_ms": sum(e.time_range.elapsed_us() for e in kernels
                                if r.start <= e.time_range.start < r.end) / 1e3}
        for name, r in spans.items()
    }
    top = sorted(by_name.items(), key=lambda kv: kv[1][0], reverse=True)[:12]
    emit("profile", path=path, trace_window_ms=window, device_busy_ms=busy,
         idle_share=1.0 - busy / window, device_ops=len(kernels), stages=stages,
         port_kernel_ms=ours, kernels_in_trace=in_trace, credited=credited,
         top_kernels=[{"name": n[:100], "ms": ms, "calls": c} for n, (ms, c) in top])


# the port's kernels by symbol prefix (csrc/fused_conv.cu has conv_fwd_kernel
# and conv_fwd_mma_kernel; the attention backward attn_bwd_delta_kernel,
# attn_bwd_dkdv_kernel, attn_bwd_dq_kernel and their _mma twins, the delta
# pre-pass counted both in the backward's time and alone)
PORT_SYMBOLS = (("fused_attention_fwd", "(anonymous namespace)::attn_fwd"),
                ("fused_attention_bwd", "(anonymous namespace)::attn_bwd"),
                ("fused_attention_bwd_delta", "(anonymous namespace)::attn_bwd_delta"),
                ("fused_conv1d_fwd", "(anonymous namespace)::conv_fwd"))


# a trace's kernel names -> the launch counters' names: the forward (one
# kernel a launch) and the backward's dK/dV kernel (one a backward launch)
# carry SM16 as their second template argument; the convs and the delta
# pre-pass are one kernel a launch
TRACE_KERNELS = re.compile(
    r"\(anonymous namespace\)::(attn_fwd|attn_bwd_dkdv|attn_bwd_delta|conv_fwd)"
    r"(?:_mma)?_kernel<(?:\d+, (true|false))?")
TRACE_NAMES = {"attn_fwd": "fused_attention_fwd", "attn_bwd_dkdv": "fused_attention_bwd",
               "attn_bwd_delta": "fused_attention_bwd_delta", "conv_fwd": "fused_conv1d_fwd"}


def trace_launches(by_name):
    """{launch counter: kernels of that counter in a trace} from
    ``device_time``'s {name: (ms, calls)}."""
    counts = dict.fromkeys(TRACE_NAMES.values(), 0)
    counts.update(fused_attention_fwd_bf16sm=0, fused_attention_bwd_bf16sm=0)
    for name, (_, calls) in by_name.items():
        m = TRACE_KERNELS.search(name)
        if m:
            key = TRACE_NAMES[m.group(1)]
            if m.group(2) == "true" and m.group(1) != "conv_fwd":
                key += "_bf16sm"
            counts[key] += calls
    return counts


def check_trace(what, by_name, credited):
    """Fail unless the port's kernels counted in a trace equal the launch
    counts read over the traced run; returns the trace's counts."""
    in_trace = trace_launches(by_name)
    differ = {k: (n, credited[k]) for k, n in in_trace.items() if n != credited[k]}
    if differ:
        fail(f"{what}: kernels in the trace differ from the launch counts (trace, counted): "
             f"{differ}")
    return in_trace


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
    r = engine.style.lattice.cover(len(requests), max(len(q.ref_mel) for q in requests))[1]
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


def captured_cli(argv):
    """``python -m speakingstyle_torch`` in this process, its standard
    output captured: (the command's return value, the output, the kernels'
    launches)."""
    import io

    from speakingstyle_torch.__main__ import main as cli

    buf = io.StringIO()
    reset_counts()
    with contextlib.redirect_stdout(buf):
        out = cli(argv)
    return out, buf.getvalue(), read_counts()


@contextlib.contextmanager
def fault_env(spec):
    """SPEAKINGSTYLE_FAULTS set to ``spec`` for the block."""
    from speakingstyle_torch.training.faults import ENV_VAR

    saved = os.environ.get(ENV_VAR)
    os.environ[ENV_VAR] = spec
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop(ENV_VAR, None)
        else:
            os.environ[ENV_VAR] = saved


def run_cli(argv, want):
    """``python -m speakingstyle_torch`` in this process, every kernel
    count set to 0 just before and read just after; fails unless each
    kernel of ``want`` launched its count. Returns (the command's return
    value, the counts)."""
    out, _, counts = captured_cli(argv)
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


def restored_phase(cfg, seed, dev, attn_per, tmp):
    """``synthesize --restore_step`` from the port's own checkpoint: the
    seeded LJSpeech engine's model saved with ``CheckpointManager`` under
    ``tmp`` (where the checkpoint stays, for ``serve_http_phase``), then
    the command in single mode (each smoke request with its own reference)
    and in batch mode (a metadata file of the 4 smoke requests, one shared
    ``--ref_audio`` encoded once). Durations, mel lengths and mels must
    equal the in-memory engine's on the command's own requests, bit for
    bit: both run the same kernels at the same shapes on the same weights.
    Then one request with ``--griffin_lim``, inverted on the card: its wav
    must be (mel_len - 1) * hop samples, non-silent, and its mel equal.
    Returns the checkpoint's step."""
    import numpy as np
    import scipy.io.wavfile

    from speakingstyle_torch.training.checkpoint import CheckpointManager
    from speakingstyle_torch.training.optim import Optimizer
    from speakingstyle_torch.training.state import TrainState
    from speakingstyle_torch.training.trainer import trainable

    step = 4242
    engine = build_engine(cfg, seed, dev)
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
    return step


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


# ---------------------------------------------------------------- phases 11-13: the vocoder

# train_vocoder at the reference recipe's sizes: HiFi-GAN V1 (512 initial
# channels, upsampling 8 8 2 2), MPD periods 2 3 5 7 11, MSD 3 scales,
# batch 16 segments of 8192 samples (the trainer's default, checked), from
# VOC_WAVS seeded 2 s wavs; the learning rate of the JAX package's CPU test
# of the descent
VOC_BATCH, VOC_SEGMENT, VOC_LR = 16, 8192, 5e-4
VOC_WAVS, VOC_SECONDS = 32, 2.0
VOC_STEPS, VOC_RESUMED = 20, 2  # steps of the run, then of its resume
VOC_WARMUP = 2  # first steps, left out of the step-time median (cuDNN plans)
# the drills: nan_grads poisons step VOC_NAN's wavs (a checkpoint every 2
# steps, so it rolls back to step VOC_NAN - 1); sigterm after step VOC_SIGTERM
VOC_DRILL_STEPS, VOC_NAN, VOC_SIGTERM = 6, 3, 4
VOC_MELS = 4  # the vocode phase's mel files (from the first wavs), and as many wavs


def vocoder_log(text):
    """{step: {metric: value}} of train_vocoder's ``[vocoder] step N:`` lines."""
    rows = {}
    for line in text.splitlines():
        m = re.match(r"\[vocoder\] step (\d+): (.*)$", line.strip())
        if m:
            rows[int(m[1])] = {k: float(v) for k, v in (kv.split(": ") for kv in m[2].split(", "))}
    return rows


def vocoder_phase(cfg, seed, dev, attn_per):
    """Phases 11-13 in a temporary directory: ``train_vocoder`` (the
    command in this process) at the reference recipe's sizes, its resume,
    its generator in ``synthesize --vocoder_ckpt``; the NaN and SIGTERM
    drills; ``vocode`` on a mel dir and a wav dir."""
    import numpy as np
    import scipy.io.wavfile
    import torch

    from speakingstyle_torch.training.vocoder_trainer import VocoderHParams

    if VocoderHParams().segment_size != VOC_SEGMENT:
        fail(f"train_vocoder: the default segment is {VocoderHParams().segment_size}, "
             f"not the recipe's {VOC_SEGMENT}")
    sr = cfg.preprocess.preprocessing.audio.sampling_rate
    hop = cfg.preprocess.preprocessing.stft.hop_length
    with tempfile.TemporaryDirectory(prefix="chip_smoke_vocoder_") as tmp:
        wav_dir = os.path.join(tmp, "wavs")
        os.makedirs(wav_dir)
        for i in range(VOC_WAVS):
            scipy.io.wavfile.write(os.path.join(wav_dir, f"w{i:02d}.wav"), sr,
                                   reference_wav(seed + 100 + i, sr, VOC_SECONDS))
        ckpt = os.path.join(tmp, "ckpt")

        def args(steps, ckpt_dir=ckpt, save_every=VOC_STEPS):
            return ["train_vocoder", "--preset", "LJSpeech", "--input_wavs_dir", wav_dir,
                    "--checkpoint_path", ckpt_dir, "--batch_size", str(VOC_BATCH),
                    "--learning_rate", str(VOC_LR),
                    "--log_every", "1", "--save_every", str(save_every),
                    "--training_steps", str(steps), "--device", dev.type]

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        state, text, counts = captured_cli(args(VOC_STEPS))
        peak = torch.cuda.max_memory_allocated()
        log = vocoder_log(text)
        last = os.path.join(ckpt, f"vocoder_{VOC_STEPS:08d}.msgpack")
        resumed, resumed_text, _ = captured_cli(
            args(VOC_STEPS + VOC_RESUMED) + ["--restore", last])
        resumed_log = vocoder_log(resumed_text)
        gen_file = last + ".generator.msgpack"
        synth = vocoder_synthesize(cfg, seed, dev, attn_per, tmp, gen_file)
        step_ms = [log[s]["step_ms"] for s in range(VOC_WARMUP + 1, VOC_STEPS + 1) if s in log]
        mel_l1 = [log[s]["mel_l1"] for s in sorted(log)]
        emit("train_vocoder", entry="cli.train_vocoder.main", generator="HiFi-GAN V1",
             mpd_periods=[2, 3, 5, 7, 11], msd_scales=3, batch=VOC_BATCH,
             segment=VOC_SEGMENT, learning_rate=VOC_LR, wavs=VOC_WAVS, steps=VOC_STEPS,
             metrics={s: log[s] for s in sorted(log)}, mel_l1=mel_l1,
             step_ms=step_ms, step_ms_median=statistics.median(step_ms) if step_ms else None,
             warmup_steps=VOC_WARMUP, max_memory_allocated_bytes=peak,
             tf32={"matmul": torch.backends.cuda.matmul.allow_tf32,
                   "cudnn": torch.backends.cudnn.allow_tf32},
             checkpoints=sorted(os.listdir(ckpt)), resumed_steps=sorted(resumed_log),
             resumed_to=resumed.step, launches=counts, synthesize=synth)
        if sorted(log) != list(range(1, VOC_STEPS + 1)) or not all(
                math.isfinite(v) for row in log.values() for v in row.values()):
            fail(f"train_vocoder: log steps {sorted(log)} or non-finite metrics {log}")
        if not mel_l1[-1] < mel_l1[0]:
            fail(f"train_vocoder: mel_l1 did not fall: {mel_l1}")
        if state.step != VOC_STEPS or resumed.step != VOC_STEPS + VOC_RESUMED or sorted(
                resumed_log) != list(range(VOC_STEPS + 1, VOC_STEPS + VOC_RESUMED + 1)):
            fail(f"train_vocoder: ended at {state.step}, resumed to {resumed.step} with "
                 f"steps {sorted(resumed_log)}")
        if any(counts.values()):
            fail(f"train_vocoder launched hand-written kernels: {counts}")
        vocoder_drills(args, tmp, dev)
        vocode_phase(cfg, tmp, wav_dir, gen_file, dev, hop)


def vocoder_synthesize(cfg, seed, dev, attn_per, tmp, gen_file):
    """``synthesize --vocoder_ckpt`` with the trained generator sidecar, on
    a checkpoint of the seeded LJSpeech engine's model: a finite wav of
    mel_len * hop samples."""
    import numpy as np

    from speakingstyle_torch.training.checkpoint import CheckpointManager
    from speakingstyle_torch.training.optim import Optimizer
    from speakingstyle_torch.training.state import TrainState
    from speakingstyle_torch.training.trainer import trainable

    step = 7
    root = os.path.join(tmp, "synthesize")
    os.makedirs(root)
    engine = build_engine(cfg, seed, dev)
    args = smoke_configs(root)
    CheckpointManager(os.path.join(root, "ckpt")).save(step, TrainState(
        step=step, model=engine.model, optimizer=Optimizer(trainable(engine.model), cfg.train)))
    wavs, _ = write_smoke_inputs(root, cfg, seed)
    ns, counts = run_cli(["synthesize", *args, "--device", dev.type, "--restore_step", str(step),
                          "--mode", "single", "--text", TEXTS[1], "--ref_audio", wavs[1],
                          "--vocoder_ckpt", gen_file],
                         {"fused_attention_fwd": attn_per, "fused_attention_fwd_bf16sm": 0,
                          "fused_conv1d_fwd": 0})
    r = ns.results[0]
    hop = cfg.preprocess.preprocessing.stft.hop_length
    row = {"mel_len": r.mel_len, "wav_samples": int(len(r.wav)), "wav_finite": r.wav_finite,
           "wav_rms": float(np.sqrt(np.mean(r.wav.astype(np.float64) ** 2)))
           if len(r.wav) else 0.0, "launches": counts}
    if not (r.mel_len > 0 and len(r.wav) == r.mel_len * hop and r.wav_finite):
        fail(f"synthesize --vocoder_ckpt: {row}")
    return row


def vocoder_drills(args, tmp, dev):
    """``nan_grads@VOC_NAN`` (in this process): exactly one rollback, to the
    step-(VOC_NAN - 1) checkpoint, and the run ends at its last step.
    ``sigterm@VOC_SIGTERM`` (the command in a subprocess, which runs while
    this process runs the NaN drill; its seconds are those until its exit
    is read): exit 0 with a flushed checkpoint at that step; the resume
    from it continues at the next step."""
    sig = os.path.join(tmp, "drill_sigterm")
    env = dict(os.environ, SPEAKINGSTYLE_FAULTS=f"sigterm@{VOC_SIGTERM}")
    # its output goes to files: a pipe nobody reads while the NaN drill runs could fill
    outs = [os.path.join(tmp, f"drill_sigterm.{n}") for n in ("out", "err")]
    t0 = time.perf_counter()
    with open(outs[0], "w") as out, open(outs[1], "w") as err:
        proc = subprocess.Popen([sys.executable, "-m", "speakingstyle_torch",
                                 *args(VOC_DRILL_STEPS, sig, VOC_DRILL_STEPS)], cwd=REPO,
                                env=env, stdout=out, stderr=err, text=True)
    try:
        drill = os.path.join(tmp, "drill_nan")
        with fault_env(f"nan_grads@{VOC_NAN}"):
            state, text, _ = captured_cli(args(VOC_DRILL_STEPS, drill, 2))
        proc.wait(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
    sig_s = time.perf_counter() - t0
    sig_out, sig_err = (pathlib.Path(f).read_text() for f in outs)
    rollbacks = re.findall(r"rollback (\d+)/\d+ to (\S+)", text)
    log = vocoder_log(text)
    flushed = os.path.join(sig, f"vocoder_{VOC_SIGTERM:08d}.msgpack")
    resumed, resumed_text, _ = captured_cli(args(VOC_DRILL_STEPS, sig, VOC_DRILL_STEPS)
                                            + ["--restore", flushed])
    resumed_steps = sorted(vocoder_log(resumed_text))
    emit("train_vocoder_resilience", nan_drill={
        "faults": f"nan_grads@{VOC_NAN}", "rollbacks": rollbacks, "steps": sorted(log),
        "ended_at": state.step, "last": log.get(VOC_DRILL_STEPS)},
        sigterm_drill={"faults": f"sigterm@{VOC_SIGTERM}", "exit_code": proc.returncode,
                       "seconds": sig_s, "flushed": os.path.isfile(flushed),
                       "resumed_steps": resumed_steps, "resumed_to": resumed.step})
    want_to = os.path.join(drill, f"vocoder_{VOC_NAN - 1:08d}.msgpack")
    if rollbacks != [("1", want_to)] or state.step != VOC_DRILL_STEPS or not all(
            math.isfinite(v) for v in log[VOC_DRILL_STEPS].values()):
        fail(f"train_vocoder nan drill: rollbacks {rollbacks}, ended at {state.step}")
    if proc.returncode != 0 or f"SIGTERM: checkpoint flushed at step {VOC_SIGTERM}" not in \
            sig_out or not os.path.isfile(flushed):
        fail(f"train_vocoder sigterm drill: exit {proc.returncode}: {sig_out[-2000:]} "
             f"{sig_err[-2000:]}")
    if resumed_steps != list(range(VOC_SIGTERM + 1, VOC_DRILL_STEPS + 1)):
        fail(f"train_vocoder sigterm drill: the resume logged steps {resumed_steps}")


def vocode_phase(cfg, tmp, wav_dir, gen_file, dev, hop):
    """``vocode`` with the trained generator: mels of the first wavs (half
    of them saved [T, 80], half [80, T]) and the wavs themselves; int16 wavs
    of T * hop samples, finite and not silent."""
    import numpy as np
    import scipy.io.wavfile

    from speakingstyle_torch.audio.stft import MelExtractor, get_mel_from_wav
    from speakingstyle_torch.audio.tools import load_wav

    pp = cfg.preprocess.preprocessing
    extractor = MelExtractor(pp.stft.filter_length, pp.stft.hop_length, pp.stft.win_length,
                             pp.mel.n_mel_channels, pp.audio.sampling_rate, pp.mel.mel_fmin,
                             pp.mel.mel_fmax)
    mel_dir, in_wavs = os.path.join(tmp, "vocode_mels"), os.path.join(tmp, "vocode_wavs")
    os.makedirs(mel_dir)
    os.makedirs(in_wavs)
    frames = {}
    names = sorted(os.listdir(wav_dir))[:VOC_MELS]
    for i, name in enumerate(names):
        audio, _ = load_wav(os.path.join(wav_dir, name), target_sr=pp.audio.sampling_rate)
        audio = audio[: len(audio) * (i + 1) // VOC_MELS]  # unequal lengths
        mel, _ = get_mel_from_wav(audio, extractor)  # [80, T]
        base = os.path.splitext(name)[0]
        np.save(os.path.join(mel_dir, base + ".npy"), mel if i % 2 else mel.T)
        scipy.io.wavfile.write(os.path.join(in_wavs, base + ".wav"), pp.audio.sampling_rate, audio)
        frames[base] = mel.shape[1]
    rows, bad = [], []
    for flag, src, suffix in (("--input_mels_dir", mel_dir, "_generated_e2e.wav"),
                              ("--input_wavs_dir", in_wavs, "_generated.wav")):
        written, _, counts = captured_cli(["vocode", "--preset", "LJSpeech", flag, src,
                                           "--output_dir", os.path.join(tmp, "vocoded"),
                                           "--checkpoint_file", gen_file, "--device", dev.type])
        for path in written:
            base = os.path.basename(path)[: -len(suffix)]
            rate, wav = scipy.io.wavfile.read(path)
            rms = float(np.sqrt(np.mean(wav.astype(np.float64) ** 2))) if len(wav) else 0.0
            rows.append({"input": flag[8:12], "file": base, "frames": frames[base],
                         "samples": int(len(wav)), "dtype": str(wav.dtype), "rms": rms})
            if not (rate == pp.audio.sampling_rate and wav.dtype == np.int16
                    and len(wav) == frames[base] * hop and rms > 1.0):
                bad.append(rows[-1])
        if len(written) != len(names) or any(counts.values()):
            bad.append({"flag": flag, "written": len(written), "launches": counts})
    emit("vocode", entry="cli.vocode.main", checkpoint=os.path.basename(gen_file), results=rows)
    if bad:
        fail(f"vocode: {bad}")


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


def without_card(cfg):
    """``cfg`` without the train step's one-time program card: its flop
    counter sends every op of a run's first step through Python (~15-19 s
    at full width), and no check of this script reads it beyond the train
    phase's kernel-path run, which keeps it (a cut for the script's
    time)."""
    rep = dataclasses.replace
    return rep(cfg, train=rep(cfg.train, obs=rep(cfg.train.obs, program_card=False)))


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
        resumed = run_training(without_card(cfg), device=dev, restore_step=-1,
                               max_steps=TRAIN_STEPS + TRAIN_TRACED).step
        torch.cuda.synchronize()
    traced = trace_last_step(f"train profile of {tag}", prof.events())

    log = read_log(os.path.join(paths.log_path, "log.txt"))
    train_rows, val_rows = log["train"], log["val"]
    measured = [train_rows.get(s, {}) for s in range(TRAIN_WARMUP + 1, TRAIN_STEPS + 1)]
    walls = [r.get("step_time_s", math.nan) * 1e3 for r in measured]
    rates = [r.get("mel_frames_per_sec", math.nan) for r in measured]
    waits = [r.get("data_wait_s", math.nan) * 1e3 for r in measured]
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
    cases += tp_kernel_cases(cfg, lengths, dev, g)
    return {c["case"]: c for c in cases}


# the tensor-parallel degrees whose local shapes the kernel cases cover
TP_CASE_DEGREES = (2, 4)


def tp_kernel_cases(cfg, lengths, dev, g):
    """The kernels at a tensor-parallel rank's local shapes of the train
    step, each against its plain version: the attention forward, backward
    and delta pre-pass on ``n_head / tp`` heads where tp divides the heads
    (the encoder's and decoder's 1 head of d128, the reference encoder's 4
    or 2 of d32; 2 heads of d128 do not split at tp = 4: they gather and run
    the whole shape, a case above), in float32 (the tensor-parallel parity
    steps) and bfloat16; each FFN's ``w_1`` on its ``d_inner / tp`` filters
    with ReLU and ``w_2`` on its ``d_inner / tp`` input channels without a
    bias, in bfloat16 and, at tp = 2, float32."""
    import torch

    tr, re_ = cfg.model.transformer, cfg.model.reference_encoder
    attn = (("ref_encoder", "ref", re_.encoder_head, re_.encoder_hidden, re_.encoder_layer),
            ("encoder", "src", tr.encoder_head, tr.encoder_hidden, tr.encoder_layer),
            ("decoder", "mel", tr.decoder_head, tr.decoder_hidden, tr.decoder_layer))
    ffn = (("ref", "ref", re_.conv_kernel_size, re_.conv_kernel_size, re_.encoder_hidden,
            re_.conv_filter_size, re_.encoder_layer),
           ("enc", "src", *tr.conv_kernel_size, tr.encoder_hidden, tr.conv_filter_size,
            tr.encoder_layer),
           ("dec", "mel", *tr.conv_kernel_size, tr.decoder_hidden, tr.conv_filter_size,
            tr.decoder_layer))
    cases = []
    for tp in TP_CASE_DEGREES:
        for dtype in (torch.float32, torch.bfloat16):
            for name, axis, H, d_model, layers in attn:
                if H % tp:
                    continue
                tag, (B, L, lens) = f"tp{tp}_{name}", lengths[axis]
                c = attention_case((tag, axis, H // tp, d_model // H, layers), lengths, dtype, g,
                                   dev, train=True)
                c["launches_per_step"] = c.pop("launches_per_dispatch")
                cases.append(c)
                cases += attention_bwd_case(tag, B, L, H // tp, d_model // H, lens, dtype, g, dev)
            dtypes = (torch.bfloat16, torch.float32) if tp == 2 else (torch.bfloat16,)
            if dtype not in dtypes:
                continue
            for name, axis, k1, k2, d, d_inner, layers in ffn:
                w1 = (f"tp{tp}_{name}_ffn_w1", axis, k1, d, d_inner // tp, True, False, layers)
                w2 = (f"tp{tp}_{name}_ffn_w2", axis, k2, d_inner // tp, d, False, False, layers)
                for case, bias in ((w1, True), (w2, False)):
                    c = conv_case(case, lengths, dtype, g, dev, prefix="train_conv", bias=bias)
                    c["launches_per_step"] = c.pop("launches_per_dispatch")
                    cases.append(c)
    for c in cases:
        emit("train_kernels", **c)
    return cases


def grad_parity(cfg, batch, dev, seed):
    """One train step's per-leaf gradients from the same weights, batch and
    dropout masks, kernel path against library path: float32 (TF32 off)
    within F32_GRAD_RTOL of each leaf's max |grad|, bfloat16 by the distance
    ratio. Returns the failed checks."""
    from speakingstyle_torch.models.factory import build_model, init_weights
    from speakingstyle_torch.ops.dropout import DropoutRNG
    from speakingstyle_torch.training.trainer import compute_losses, to_device

    weights = init_weights(build_model(cfg), seed).state_dict()
    arrays = to_device(batch.arrays(), dev)
    grads, loss = path_grads(cfg, weights, dev, lambda model, c: compute_losses(
        model, c, arrays, deterministic=False, rng=DropoutRNG(seed, dev)))
    return judge_grads("train_grad_parity", grads, loss)


def path_grads(cfg, weights, dev, losses_of_model):
    """({"<dtype>_<path>": {parameter: float32 grad}}, {...: total loss}) of
    ``losses_of_model(model, cfg)`` for a model of ``cfg`` holding
    ``weights`` on each of TRAIN_PATHS, in float32 (TF32 off) and bfloat16."""
    import torch

    from speakingstyle_torch.models.factory import build_model

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
                losses = losses_of_model(model, c)
                gs = torch.autograd.grad(losses["total_loss"], [p for _, p in named],
                                         materialize_grads=True)
            grads[f"{dtype}_{tag}"] = {n: gr.float() for (n, _), gr in zip(named, gs)}
            loss[f"{dtype}_{tag}"] = float(losses["total_loss"].detach())
            del model, gs, losses
    return grads, loss


def judge_grads(phase, grads, loss, **extra):
    """The gradient parity of ``path_grads``'s results, emitted as one
    ``phase`` line (with ``extra``); returns the failed checks."""
    ref = grads["float32_library"]
    share = {name: g.abs().max().item() for name, g in ref.items()}
    top = max(share.values())
    share = {name: v / top for name, v in share.items()}
    zero = {name for name, v in share.items() if v <= NOISE_SHARE}
    rows, bad = {}, []
    d_leaf = lambda name, a, b: ((grads[a][name] - grads[b][name]).abs().max().item()
                                 / ref[name].abs().max().item())
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
        rows[name] = (d_leaf(name, "float32_kernels", "float32_library"),
                      d_leaf(name, "bfloat16_kernels", "bfloat16_library"),
                      d_leaf(name, "bfloat16_library", "float32_library"))
        if not rows[name][0] <= F32_GRAD_RTOL:
            bad.append(f"float32 {name}: {rows[name][0]} of its max |grad| {scale}")
    f32_worst = max(rows.items(), key=lambda kv: kv[1][0])
    err_leaf = max(rows, key=lambda n: rows[n][1])
    noise_leaf = max(rows, key=lambda n: rows[n][2])
    err, noise = rows[err_leaf][1], rows[noise_leaf][2]
    ratio = err / noise if noise > 0 else math.inf
    emit(phase, **extra, leaves=len(ref), max_abs_grad=top, total_loss=loss,
         noise_leaves=sorted(zero), noise_share=NOISE_SHARE,
         noise_leaves_max_share=max((share[n] for n in zero), default=None),
         other_leaves_min_share=min(share[n] for n in rows),
         smallest_leaves=[[n, share[n], rows[n][0] if n in rows else None]
                          for n in sorted(share, key=share.get)[:30]],
         float32={"worst_leaf": f32_worst[0], "worst_rel_err": f32_worst[1][0],
                  "median_rel_err": statistics.median(r[0] for r in rows.values()),
                  "rtol": F32_GRAD_RTOL, "loss_rel_err": loss_err},
         bfloat16={"kernels_vs_library": err, "library_vs_float32": noise, "ratio": ratio,
                   "max_ratio": BF16_GRAD_RATIO,
                   "worst_leaf": [err_leaf, share[err_leaf], *rows[err_leaf][1:], d_leaf(
                       err_leaf, "bfloat16_kernels", "float32_library")],
                   "noise_worst_leaf": [noise_leaf, share[noise_leaf], *rows[noise_leaf][1:]]})
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
    """Phase 6 on a synthetic corpus in a temporary directory, then the
    distillation phases from its checkpoint and the data-parallel phase on
    its corpus; returns (the kernel path's counts, those of its run under
    the bf16 softmax, the kernel cases, the launches per distill step, the
    launches per data-parallel rank step)."""
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
        train_run("library", without_card(runs["library"]), dev, {k: (0, 0) for k in want},
                  n_val)
        resilience_phase(cfg_of, corpus, tmp, seed, dev, want, n_val)
        remat_phase(cfg_of(corpus, os.path.join(tmp, "remat"), seed,
                           **dict(TRAIN_PATHS)["kernels"]), first, dev)
        costs_phase(cfg_of, corpus, tmp, seed, dev, first)
        sm16_counts = train_sm16_run(without_card(
            cfg_of(corpus, os.path.join(tmp, "bf16_softmax"), seed, **dict(
                TRAIN_PATHS)["kernels"], attention_softmax_dtype="bfloat16")), dev, attn)
        with strict_float32():
            cases = train_kernel_cases(cfg, first, dev, seed)
        bad = [c["case"] for c in cases.values() if not c["ok"]]
        if bad:
            fail(f"train kernels disagree with their plain versions: {bad}")
        bad = grad_parity(cfg, first, dev, seed)
        if bad:
            fail(f"train gradient parity: {bad}")
        distill_launches, distill_cases = distill_phase(cfg, tmp, dev, seed)
        cases.update(distill_cases)
        dp_launches = timed("train_dp", train_dp_phase, cfg_of, corpus, tmp, seed, dev)
    return counts, sm16_counts, cases, distill_launches, dp_launches



# ---------------------------------------------------------------- phases 14-15: distillation

# (tag, batch, phonemes) of the distill runs: the JAX package's defaults
# (src = min(serve.src_buckets[0], 12), mel = 12 x 12 = 144 frames) and the
# train phase's size (mel = min(128 x 12, max_seq_len) = 1000 frames)
DISTILL_RUNS = (("defaults", 8, 12), ("train_size", 48, 128))
DISTILL_STEPS = 20
DISTILL_TIMED = 10  # steps of the timed loop after each run
DISTILL_TRACED = 3  # then steps under torch.profiler: device busy ms, idle share
# the gradient parity: one student per seed (weights, batch, dropout), and
# the first seed again, which must give the same gradients bit for bit
DISTILL_PARITY_SEEDS = 3
# the loss falls: the mean of the last DISTILL_MEAN logged losses below
# that of the first (dropout is on: single steps are noisy)
DISTILL_MEAN = 5
# a log line (and the sentinel's read) every step, a student checkpoint
# every 10; the lr ramp shortened to 5 steps (as the JAX package's distill
# test does), so that the loss moves within the run
DISTILL_STEP_CFG = {"log_step": 1, "save_step": 10}
DISTILL_ANNEAL = 5
# the distill command's drills, with a student checkpoint every 4 steps
DISTILL_DRILL_STEPS, DISTILL_DRILL, DISTILL_DRILL_SAVE = 8, "nan_grads@6,sigterm@7", 4
TEACHER_STEP = 1000  # the step the prepared teacher is saved under


def distill_config(cfg, out):
    """The train phase's kernel-path config with the teacher's checkpoints
    and the logs under ``out``, DISTILL_STEP_CFG and the short lr ramp."""
    rep = dataclasses.replace
    train = rep(cfg.train, step=rep(cfg.train.step, **DISTILL_STEP_CFG),
                loss=rep(cfg.train.loss, anneal_steps=DISTILL_ANNEAL),
                path=rep(cfg.train.path, ckpt_path=os.path.join(out, "ckpt"),
                         log_path=os.path.join(out, "log")))
    return rep(cfg, train=train)


def set_duration_layer(model):
    """``model`` with the duration predictor's output layer set as
    ``build_engine`` sets it, to predict ~FRAMES_PER_PHONEME frames a
    phoneme (briefly trained or random weights predict ~0)."""
    import torch

    lin = model.variance_adaptor.duration_predictor.linear_layer
    with torch.no_grad():
        lin.weight.mul_(0.1)
        lin.bias.fill_(math.log(1.0 + FRAMES_PER_PHONEME))
    return model


def prepare_teacher(cfg, out, dev):
    """The train phase's latest checkpoint, restored through
    ``CheckpointManager``, with ``set_duration_layer``, saved as step
    TEACHER_STEP of the distill config's checkpoint directory. Returns
    (that config, its step)."""
    from speakingstyle_torch.models.factory import build_model
    from speakingstyle_torch.training.checkpoint import CheckpointManager
    from speakingstyle_torch.training.optim import Optimizer
    from speakingstyle_torch.training.state import TrainState
    from speakingstyle_torch.training.trainer import trainable

    teacher = build_model(cfg)
    restored = CheckpointManager(cfg.train.path.ckpt_path).restore_weights(teacher)
    set_duration_layer(teacher)
    dcfg = distill_config(cfg, out)
    CheckpointManager(dcfg.train.path.ckpt_path).save(TEACHER_STEP, TrainState(
        step=TEACHER_STEP, model=teacher, optimizer=Optimizer(trainable(teacher), cfg.train)),
        block=True)
    return dcfg, restored["step"]


def distill_per_step(cfg):
    """Launches of each kernel per distill step: the teacher free-running
    (forwards), the student teacher-forced (forwards, backwards and their
    delta pre-passes); no reference encoder runs, so no LayerNorm conv."""
    from speakingstyle_torch.training.distill import student_config

    s_cfg = student_config(cfg)
    n_attn = lambda c: c.model.transformer.encoder_layer + c.model.transformer.decoder_layer
    n_conv = lambda c: sum(n for name, *_, n in conv_cases(c) if not name.startswith("ref_"))
    return {"fused_attention_fwd": n_attn(cfg) + n_attn(s_cfg),
            "fused_attention_bwd": n_attn(s_cfg), "fused_attention_bwd_delta": n_attn(s_cfg),
            "fused_attention_fwd_bf16sm": 0, "fused_attention_bwd_bf16sm": 0,
            "fused_conv1d_fwd": n_conv(cfg) + n_conv(s_cfg), "fused_conv1d_fwd_act": 0}


def read_distill_log(path):
    return {s: r["total_loss"] for s, r in sorted(read_log(path).get("distill", {}).items())}


def distill_run(dcfg, tag, batch, src, dev, want):
    """``run_distillation`` for DISTILL_STEPS steps with the teacher
    restored from the distill config's checkpoint, every kernel count set to
    0 just before and read just after (each a whole multiple of the steps;
    ``launches_per_step`` is the count over the steps, held to ``want``);
    then DISTILL_TIMED synchronised steps of the distill step alone, and
    DISTILL_TRACED more under the profiler. Returns (the emitted row, the
    student's config, the first batch's teacher mel lengths)."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from speakingstyle_torch.models.factory import build_model
    from speakingstyle_torch.obs import MetricsRegistry
    from speakingstyle_torch.training.checkpoint import CheckpointManager
    from speakingstyle_torch.training.distill import (
        STUDENT_SUBDIR, batch_tensors, make_distill_batch, make_distill_step, run_distillation,
        teacher_targets,
    )
    from speakingstyle_torch.training.optim import Optimizer
    from speakingstyle_torch.training.state import TrainState
    from speakingstyle_torch.training.trainer import trainable

    rep = dataclasses.replace
    out = os.path.join(os.path.dirname(dcfg.train.path.ckpt_path), tag)
    run_cfg = rep(dcfg, train=rep(dcfg.train, path=rep(dcfg.train.path,
                                                       log_path=os.path.join(out, "log"))))
    teacher = build_model(run_cfg)
    CheckpointManager(run_cfg.train.path.ckpt_path).restore_weights(teacher, step=TEACHER_STEP)
    before = {k: v.clone() for k, v in teacher.state_dict().items()}
    t_mel = min(src * run_cfg.serve.frames_per_phoneme, run_cfg.model.max_seq_len)
    student_dir = os.path.join(out, STUDENT_SUBDIR)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    state, s_cfg = run_distillation(run_cfg, teacher=teacher, max_steps=DISTILL_STEPS,
                                    batch_size=batch, src_len=src, registry=MetricsRegistry(),
                                    ckpt_dir=student_dir, device=dev)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = read_distill_log(os.path.join(run_cfg.train.path.log_path, "log.txt"))
    t_ref, s_ref = (m.reference_encoder.state_dict() for m in (teacher, state.model))
    graft_equal = all(torch.equal(t_ref[k], s_ref[k]) for k in t_ref)
    teacher_same = all(torch.equal(v.cpu(), before[k]) for k, v in teacher.state_dict().items())
    model = build_model(s_cfg)
    restored = TrainState(0, model, Optimizer(trainable(model), s_cfg.train))
    CheckpointManager(student_dir).restore(restored)
    restore_equal = restored.step == DISTILL_STEPS and all(
        torch.equal(a.cpu(), b) for a, b in zip(state.model.state_dict().values(),
                                                restored.model.state_dict().values()))
    # the step alone, synchronised: the student carries on from the run
    step = make_distill_step(teacher, run_cfg, t_mel)
    rng = np.random.default_rng(0)
    arrays = batch_tensors(make_distill_batch(run_cfg, rng, batch, src), dev)
    mel_lens = [int(x) for x in teacher_targets(teacher, run_cfg, arrays, t_mel)["mel_lens"]]
    step(state, arrays)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(DISTILL_TIMED):
        step(state, arrays)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t1) * 1e3 / DISTILL_TIMED
    # the profiler adds host time to every launch: the idle share is an
    # upper bound on an unprofiled step's
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(DISTILL_TRACED):
            step(state, arrays)
        torch.cuda.synchronize()
    window, busy, by_name, ours = device_time(
        f"distill {tag} trace", [e for e in prof.events()
                                 if e.device_type == DeviceType.CUDA and not e.is_user_annotation])
    per_step = {k: n // DISTILL_STEPS for k, n in counts.items()}
    whole = all(n % DISTILL_STEPS == 0 for n in counts.values())
    first = list(losses.values())[:DISTILL_MEAN]
    last = list(losses.values())[-DISTILL_MEAN:]
    top = sorted(by_name.items(), key=lambda kv: kv[1][0], reverse=True)[:8]
    row = {"path": tag, "batch": batch, "src_len": src, "max_mel_len": t_mel,
           "teacher_mel_lens": mel_lens, "steps": DISTILL_STEPS, "run_s": run_s,
           "total_loss": losses, "launches": counts, "launches_per_step": per_step,
           "want_launches_per_step": want, "step_ms": step_ms, "timed_steps": DISTILL_TIMED,
           "traced_steps": DISTILL_TRACED, "trace_window_ms": window,
           "device_busy_ms_per_step": busy / DISTILL_TRACED, "idle_share": 1.0 - busy / window,
           "port_kernel_ms_per_step": {k: v / DISTILL_TRACED for k, v in ours.items()},
           "top_kernels": [{"name": n[:100], "ms": ms, "calls": c} for n, (ms, c) in top],
           "max_memory_allocated_bytes": peak, "graft_bit_equal": graft_equal,
           "teacher_unchanged": teacher_same, "student_restored": restore_equal,
           "student_checkpoints": CheckpointManager(student_dir).all_steps()}
    emit("distill", entry="training.distill.run_distillation", **row)
    if sorted(losses) != list(range(1, DISTILL_STEPS + 1)) or not all(
            math.isfinite(v) for v in losses.values()):
        fail(f"distill {tag}: losses {losses}")
    if not statistics.mean(last) < statistics.mean(first):
        fail(f"distill {tag}: the loss did not fall: {losses}")
    if not whole or per_step != want:
        fail(f"distill {tag}: launches {counts} over {DISTILL_STEPS} steps, want {want} a step")
    if not (graft_equal and teacher_same and restore_equal):
        fail(f"distill {tag}: graft equal {graft_equal}, teacher unchanged {teacher_same}, "
             f"student restored {restore_equal}")
    return row, s_cfg, mel_lens


def distill_drills(dcfg, dev):
    """The ``distill`` command in this process with ``--faults
    DISTILL_DRILL`` and a student checkpoint every DISTILL_DRILL_SAVE steps:
    one rollback at step 6 to the step-4 checkpoint, the SIGTERM after step
    7 ending the run there with a flushed checkpoint."""
    from speakingstyle_torch.obs import read_events
    from speakingstyle_torch.training.checkpoint import CheckpointManager
    from speakingstyle_torch.training.distill import STUDENT_SUBDIR

    rep = dataclasses.replace
    out = os.path.join(os.path.dirname(dcfg.train.path.ckpt_path), "drill")
    drill_cfg = rep(dcfg, train=rep(
        dcfg.train, path=rep(dcfg.train.path, log_path=os.path.join(out, "log")),
        step=rep(dcfg.train.step, save_step=DISTILL_DRILL_SAVE)))
    with fault_env(""):  # the command sets the variable for its process
        state, _, _ = captured_cli(["distill", *config_yamls(drill_cfg, out), "--device",
                                    dev.type, "--max_steps", str(DISTILL_DRILL_STEPS),
                                    "--faults", DISTILL_DRILL])

    events = list(read_events(drill_cfg.train.path.log_path))
    rollbacks = [(e["step"], e["restore_step"]) for e in of(events, "rollback")]
    fired = [(e["kind"], e["step"]) for e in of(events, "fault_fire")]
    student = CheckpointManager(os.path.join(dcfg.train.path.ckpt_path, STUDENT_SUBDIR))
    row = {"faults": DISTILL_DRILL, "rollbacks": rollbacks, "faults_fired": fired,
           "ended_at": state.step, "student_checkpoints": student.all_steps(),
           "distill_end": [e.get("step") for e in of(events, "distill_end")]}
    emit("distill_drills", entry="cli.distill.main", **row)
    if rollbacks != [(6, DISTILL_DRILL_SAVE)] or fired != [("nan_grads", 6), ("sigterm", 7)] \
            or state.step != 7 or student.latest_step() != 7:
        fail(f"distill drills: {row}")


def distill_grad_parity(dcfg, s_cfg, batch, src, dev, seed):
    """The first distill step's student losses and gradients, kernel path
    against library path, from the same student weights, batch, teacher
    targets (the teacher once, on the kernel path) and dropout masks; the
    rule of ``judge_grads``, for DISTILL_PARITY_SEEDS seeds of the student,
    batch and dropout, under deterministic algorithms; the first seed again
    must give the same gradients bit for bit. The teacher is drawn from
    ``seed`` (with ``set_duration_layer``), not taken from the train phase,
    whose run is not deterministic: so every input, and with them the
    gradients, repeat from one card run to the next. Returns the failed
    checks."""
    import numpy as np
    import torch

    from speakingstyle_torch.models.factory import build_model, init_weights
    from speakingstyle_torch.ops.dropout import DropoutRNG
    from speakingstyle_torch.training.distill import (
        batch_tensors, make_distill_batch, student_losses, teacher_targets,
    )

    t_mel = min(src * dcfg.serve.frames_per_phoneme, dcfg.model.max_seq_len)
    teacher = set_duration_layer(init_weights(build_model(dcfg), seed)).to(dev)

    def grads_of(s):
        arrays = batch_tensors(make_distill_batch(dcfg, np.random.default_rng(s), batch, src),
                               dev)
        with strict_float32():
            t_out = teacher_targets(teacher, dcfg, arrays, t_mel)
        weights = init_weights(build_model(s_cfg), s).state_dict()
        grads, loss = path_grads(s_cfg, weights, dev, lambda model, c: student_losses(
            model, c, arrays, t_out, t_mel, DropoutRNG(s, dev)))
        # the inputs' fingerprint, to compare across card runs
        return grads, loss, {"teacher_mel_lens": [int(x) for x in t_out["mel_lens"]],
                             "teacher_duration_sum": int(t_out["durations"].sum()),
                             "teacher_mel_sum": float(t_out["mel_postnet"].double().sum())}

    bad = []
    with deterministic():
        for s in range(seed, seed + DISTILL_PARITY_SEEDS):
            grads, loss, inputs = grads_of(s)
            bad += judge_grads("distill_grad_parity", grads, loss, seed=s, inputs=inputs)
            if s == seed:
                first = grads
        again, _, _ = grads_of(seed)
    differ = sorted(f"{k}/{n}" for k in first for n in first[k]
                    if not torch.equal(first[k][n], again[k][n]))
    emit("distill_grad_parity_repeat", seed=seed, leaves=sum(len(v) for v in first.values()),
         differ=len(differ), first_differing=differ[:10])
    if differ:
        bad.append(f"seed {seed} again: {len(differ)} gradients differ under deterministic "
                   f"algorithms, e.g. {differ[:3]}")
    return bad


def distill_kernel_cases(cfg, s_cfg, sizes, dev, seed):
    """The student's convs (FFN k9 d -> filter / 2 with ReLU and k1 back,
    postnet k5 80 -> dim / 2 and back) at each distill size over its mel
    frames, bfloat16; and the attention forward, backward and delta
    pre-pass at the distill batches (encoder over the phonemes, decoder
    over the teacher's frames), float32 and bfloat16. ``sizes``: [(batch,
    phonemes, mel frames, the teacher's mel lengths)]. Each case's
    ``layers_per_step`` counts the layers of the step at its shape, from
    the configs (the counters give each kernel's total a step, not its
    split by shape). Returns {case: result}."""
    import torch

    g = torch.Generator().manual_seed(seed + 11)
    m, tr, t_tr = s_cfg.model, s_cfg.model.transformer, cfg.model.transformer
    n_mels = cfg.preprocess.preprocessing.mel.n_mel_channels
    k1, k2 = tr.conv_kernel_size
    pk, pe = m.postnet_kernel_size, m.postnet_embedding_dim
    convs = [("ffn_w1", "mel", k1, tr.decoder_hidden, tr.conv_filter_size, True, False,
              tr.decoder_layer),
             ("ffn_w2", "mel", k2, tr.conv_filter_size, tr.decoder_hidden, False, False,
              tr.decoder_layer),
             ("postnet_in", "mel", pk, n_mels, pe, False, False, 1),
             ("postnet_out", "mel", pk, pe, n_mels, False, False, 1)]
    cases = []
    for B, src, T, mel_lens in sizes:
        lengths = {"src": (B, src, [src] * B), "mel": (B, T, mel_lens)}
        for case in convs:
            c = conv_case(case, lengths, torch.bfloat16, g, dev, prefix=f"distill_conv_{B}x{T}")
            c["layers_per_step"] = c.pop("launches_per_dispatch")
            cases.append(c)
            emit("distill_kernels", **c)
        for dtype in (torch.float32, torch.bfloat16):
            # (name, axis, L, lengths, student layers, teacher layers, heads, width):
            # the teacher's forwards run at the student's shapes
            for name, axis, L, lens, n, n_t, H, d in (
                    ("encoder", "src", src, [src] * B, tr.encoder_layer, t_tr.encoder_layer,
                     tr.encoder_head, tr.encoder_hidden),
                    ("decoder", "mel", T, mel_lens, tr.decoder_layer, t_tr.decoder_layer,
                     tr.decoder_head, tr.decoder_hidden)):
                D = d // H
                c = attention_case((name, axis, H, D, n + n_t), lengths, dtype, g, dev,
                                   train=True)
                c["case"] = f"distill_{B}x{L}_{c['case']}"
                c["layers_per_step"] = c.pop("launches_per_dispatch")
                cases.append(c)
                emit("distill_kernels", **c)
                for c in attention_bwd_case(name, B, L, H, D, lens, dtype, g, dev):
                    c["case"] = f"distill_{B}x{L}_{c['case']}"
                    c.pop("launches_per_step", None)
                    c["layers_per_step"] = n
                    cases.append(c)
                    emit("distill_kernels", **c)
    return {c["case"]: c for c in cases}


def distill_phase(cfg, tmp, dev, seed):
    """Phases 14-15 in the train phase's directory (``cfg``: its kernel
    path): the teacher from its checkpoint, the distill runs at
    DISTILL_RUNS, the CLI drills, the gradient parity, the student-shape
    kernel cases. Returns (the first run's measured launches per distill
    step, the kernel cases)."""
    out = os.path.join(tmp, "distill")
    dcfg, teacher_step = prepare_teacher(cfg, out, dev)
    want = distill_per_step(dcfg)
    sizes, rows = [], []
    for tag, batch, src in DISTILL_RUNS:
        row, s_cfg, mel_lens = distill_run(dcfg, tag, batch, src, dev, want)
        sizes.append((batch, src, row["max_mel_len"], mel_lens))
        rows.append(row)
    distill_drills(dcfg, dev)
    _, batch, src = DISTILL_RUNS[0]
    bad = distill_grad_parity(dcfg, s_cfg, batch, src, dev, seed)
    if bad:
        fail(f"distill gradient parity: {bad}")
    with strict_float32():
        cases = distill_kernel_cases(dcfg, s_cfg, sizes, dev, seed)
    bad = [c["case"] for c in cases.values() if not c["ok"]]
    if bad:
        fail(f"distill kernels disagree with their plain versions: {bad}")
    emit("distill_teacher", restored_from_step=teacher_step, saved_as=TEACHER_STEP,
         duration_layer={"weight_scale": 0.1, "bias": math.log(1.0 + FRAMES_PER_PHONEME)})
    return rows[0]["launches_per_step"], cases


# ---------------------------------------------------------------- phase 7: non-finite inputs

# the batch rows' valid lengths of the non-finite cases (T = 768 at the
# train shapes, 128 for the phoneme axis): a NaN is planted at a valid
# position of row 0 and a +inf at one of row 1
NF_MEL_LENS, NF_SRC_LENS = (768, 700, 650, 600), (128, 120, 110, 100)


def plant_nonfinite(t, L_axis_pos=(5, 17)):
    """t with a NaN at [0, 5, 0, ..., 3 % last] and a +inf at [1, 17, -1, ...,
    7 % last] (valid positions of both rows)."""
    t = t.clone()
    last = t.shape[-1]
    t[(0, L_axis_pos[0]) + (0,) * (t.dim() - 3) + (3 % last,)] = float("nan")
    t[(1, L_axis_pos[1]) + (-1,) * (t.dim() - 3) + (7 % last,)] = float("inf")
    return t


def nonfinite_equal(got, want, valid):
    """(the non-finite positions of got and want agree where ``valid``,
    got's count of them there, want's)."""
    import torch

    a, b = ~torch.isfinite(got) & valid, ~torch.isfinite(want) & valid
    return bool((a == b).all()), int(a.sum()), int(b.sum())


def nonfinite_cases(cfg, dev, seed):
    """Each kernel against its plain version on inputs with one NaN and
    one +inf planted at valid positions, at the LJSpeech_paper train widths
    with 4 batch rows: the attention forward (out, lse) and backward (dq,
    dk, dv, from the forward kernel's out and lse) with the plant in q, k
    or v; the conv plain, with ReLU, and with ReLU + LayerNorm + act. The
    non-finite positions of every output must be the same over the valid
    (unpadded) positions: past a row's length the plain backward sums 0 x
    NaN over padded keys, which the kernels skip. Then ``all_finite`` on
    the card against one NaN leaf, one inf leaf and a finite 1e30 leaf."""
    import torch

    from speakingstyle_torch.ops.fused_attention import (
        attention_lse_plain, fused_mha_bwd, fused_mha_bwd_plain, fused_mha_fwd,
        fused_mha_plain,
    )
    from speakingstyle_torch.ops.fused_conv import fused_conv_fwd, fused_conv_plain_parts

    g = torch.Generator().manual_seed(seed + 13)
    tr, re_ = cfg.model.transformer, cfg.model.reference_encoder
    cases = []
    shapes = (("ref_encoder", NF_MEL_LENS, re_.encoder_head, re_.encoder_hidden // re_.encoder_head),
              ("encoder", NF_SRC_LENS, tr.encoder_head, tr.encoder_hidden // tr.encoder_head),
              ("decoder", NF_MEL_LENS, tr.decoder_head, tr.decoder_hidden // tr.decoder_head))
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for name, lens, H, D in shapes:
            L = lens[0]
            mask = pad_mask(lens, L).to(dev)
            rows = ~mask[:, :, None, None]
            for target in ("q", "k", "v"):
                t = {n: torch.randn((len(lens), L, H, D), generator=g).to(dev, dtype)
                     for n in ("q", "k", "v", "dout")}
                t[target] = plant_nonfinite(t[target])
                q, k, v, dout = t["q"], t["k"], t["v"], t["dout"]
                scale = D ** -0.5
                out, lse = fused_mha_fwd(q, k, v, mask, scale, want_lse=True)
                grads = fused_mha_bwd(q, k, v, mask, out, lse, dout, scale)
                want = (fused_mha_plain(q, k, v, mask, scale),
                        attention_lse_plain(q, k, mask, scale),
                        *fused_mha_bwd_plain(q, k, v, mask, dout, scale))
                torch.cuda.synchronize()
                outs = {}
                for key, a, w in zip(("out", "lse", "dq", "dk", "dv"), (out, lse, *grads), want):
                    valid = ~mask[:, None, :] if key == "lse" else rows
                    outs[key] = nonfinite_equal(a, w, valid)
                cases.append({"case": f"nonfinite_attn_{name}_{target}_{dname}",
                              "kernel": "fused_attention_fwd / _bwd", "shape": [len(lens), L, H, D],
                              "planted_in": target, "nonfinite_kernel_plain": outs,
                              "ok": all(v[0] for v in outs.values()) and outs["out"][2] > 0})
        convs = (("ref_conv_relu_ln", re_.conv_kernel_size, re_.conv_filter_size,
                  re_.conv_filter_size, True),
                 ("ref_conv_relu_ln_c2048", re_.conv_kernel_size, re_.conv_filter_size, 2048,
                  True),
                 ("ffn_w1_relu", tr.conv_kernel_size[0], tr.decoder_hidden, tr.conv_filter_size,
                  False),
                 ("ffn_w2", tr.conv_kernel_size[1], tr.conv_filter_size, tr.decoder_hidden, None))
        for name, K, cin, cout, ln in convs:
            B, T = len(NF_MEL_LENS), NF_MEL_LENS[0]
            x = plant_nonfinite(torch.randn((B, T, cin), generator=g)).to(dev, dtype)
            w = (torch.randn((K, cin, cout), generator=g) / (K * cin) ** 0.5).to(dev, dtype)
            b, sc, sh = (torch.randn(cout, generator=g).to(dev, dtype) for _ in range(3))
            relu, lnp = ln is not None, (sc, sh) if ln else (None, None)
            y, act = fused_conv_fwd(x, w, b, *lnp, relu=relu, want_act=bool(ln))
            wy, wact = fused_conv_plain_parts(x, w, b, *lnp, 1, relu)
            torch.cuda.synchronize()
            every = torch.ones_like(y, dtype=torch.bool)
            outs = {"out": nonfinite_equal(y, wy, every)}
            if ln:
                outs["act"] = nonfinite_equal(act, wact, every)
            cases.append({"case": f"nonfinite_conv_{name}_{dname}", "kernel": "fused_conv1d_fwd",
                          "shape": {"B": B, "T": T, "K": K, "Cin": cin, "Cout": cout},
                          "relu": relu, "layer_norm": bool(ln), "nonfinite_kernel_plain": outs,
                          "ok": all(v[0] and v[2] > 0 for v in outs.values())})
    return cases


def all_finite_case(dev):
    """``training.resilience.all_finite`` on card tensors: one NaN leaf, one
    +inf leaf (float32 and bfloat16), one finite 1e30 leaf among others."""
    import torch

    from speakingstyle_torch.training.resilience import all_finite

    ok_leaves = [torch.randn(1000, device=dev), torch.randn(64, 64, device=dev).bfloat16(),
                 torch.tensor(2.0, device=dev)]
    spots = {}
    for name, value, dtype in (("nan", float("nan"), torch.float32),
                               ("inf", float("inf"), torch.float32),
                               ("inf_bf16", float("inf"), torch.bfloat16),
                               ("finite_1e30", 1e30, torch.float32)):
        leaf = torch.zeros(4096, device=dev, dtype=dtype)
        leaf[1234] = value
        flag = all_finite({"losses": ok_leaves[2]}, ok_leaves[:2] + [leaf])
        spots[name] = {"on_device": flag.device.type == "cuda", "finite": bool(flag)}
    ok = (not spots["nan"]["finite"] and not spots["inf"]["finite"]
          and not spots["inf_bf16"]["finite"] and spots["finite_1e30"]["finite"]
          and all(v["on_device"] for v in spots.values()))
    return {"case": "all_finite", "verdicts": spots, "ok": ok}


def nonfinite_phase(cfg, dev, seed):
    """Phase 7: ``nonfinite_cases`` and ``all_finite_case``, one
    ``kernels_nonfinite`` line each."""
    cases = nonfinite_cases(cfg, dev, seed) + [all_finite_case(dev)]
    for c in cases:
        emit("kernels_nonfinite", **c)
    bad = [c["case"] for c in cases if not c["ok"]]
    if bad:
        fail(f"non-finite inputs: kernels and plain versions disagree: {bad}")


# ---------------------------------------------------------------- phase 8: resilience drills

DRILL_STEPS = 12
# the train command's drills, each on the kernel path with the preset's
# resilience defaults (NaN sentinel, keep-best, async saves on)
DRILL_NAN = "nan_grads@7,loader_ioerror@3"
DRILL_SIGTERM = "sigterm@8"
# the SIGTERM'd and resumed run's losses (steps 1-12, deterministic
# algorithms) against a run that stops at step 8 without the signal and
# resumes: within the largest difference of two such runs plus 2^-20
# relative (an f32 rounding, should a process pick another algorithm)
RESUME_RTOL = 2 ** -20


def config_yamls(cfg, out):
    """The -p / -m / -t arguments of a config written as YAML under out."""
    import yaml

    def plain(x):
        if dataclasses.is_dataclass(x):
            return {f.name: plain(getattr(x, f.name)) for f in dataclasses.fields(x)}
        return [plain(v) for v in x] if isinstance(x, (list, tuple)) else x

    os.makedirs(out, exist_ok=True)
    args = []
    for flag, name, doc in (("-p", "preprocess", plain(cfg.preprocess)),
                            ("-m", "model", plain(cfg.model)),
                            ("-t", "train", dict(plain(cfg.train), serve=plain(cfg.serve)))):
        path = os.path.join(out, f"{name}.yaml")
        with open(path, "w", encoding="utf-8") as fh:
            yaml.safe_dump(doc, fh)
        args += [flag, path]
    return args


def train_chains(chains, dev):
    """``python -m speakingstyle_torch train`` in subprocesses from the
    checkout's root. ``chains``: {name: [(what, args), ...]}; each chain's
    runs in turn, the chains at once (a thread each). Returns {name:
    [(stdout, seconds), ...]} once every process has ended; a non-zero
    exit, or a run past its time limit, fails."""
    import concurrent.futures

    def run_chain(runs):
        done = []
        for what, args in runs:
            t0 = time.perf_counter()
            try:  # subprocess.run kills the process at its time limit
                out = subprocess.run([sys.executable, "-m", "speakingstyle_torch", "train",
                                      *args, "--device", dev.type], cwd=REPO,
                                     capture_output=True, text=True, timeout=900)
            except subprocess.TimeoutExpired:
                return done, f"{what}: train ran past 900 s"
            if out.returncode != 0:
                return done, f"{what}: train exited {out.returncode}: {out.stderr[-3000:]}"
            done.append((out.stdout, time.perf_counter() - t0))
        return done, None

    with concurrent.futures.ThreadPoolExecutor(len(chains)) as pool:
        futures = {name: pool.submit(run_chain, runs) for name, runs in chains.items()}
    results = {name: f.result() for name, f in futures.items()}
    errors = [err for _, err in results.values() if err]
    if errors:
        fail("; ".join(errors))
    return {name: done for name, (done, _) in results.items()}


def runs_of(log_path):
    """The event records of each run (split at ``train_start``)."""
    from speakingstyle_torch.obs import read_events

    runs = []
    for e in read_events(log_path):
        if e["event"] == "train_start":
            runs.append([])
        runs[-1].append(e)
    return runs


def of(events, kind):
    return [e for e in events if e["event"] == kind]


def losses_of(events):
    return {e["step"]: e["total_loss"] for e in of(events, "train_step")}


def resilience_phase(cfg_of, corpus, tmp, seed, dev, want, n_val):
    """Phase 8: the train command's drills, in subprocesses. (a) DRILL_NAN
    over DRILL_STEPS steps with max_to_keep 1: one rollback at step 7 to
    step 5, the loader error retried, 2 faults fired, finite losses at the
    end, the kernels launched per step (and per val batch) as without the
    drill, and (c) the best step by val loss still on disk beside the
    newest. (b) DRILL_SIGTERM: exit 0 after a flushed step-8 checkpoint and
    a preempt_flush event, then ``--restore_step -1`` resumes at step 9 and
    reaches 12, its losses against two runs that stop at 8 without the
    signal and resume, all with ``--deterministic``. The four chains of
    runs ((a), (b), each of the two baselines) run at once, so each run's
    seconds are taken beside the others."""
    import torch

    from speakingstyle_torch.training.checkpoint import CheckpointManager

    kernels = dict(TRAIN_PATHS)["kernels"]
    rep = dataclasses.replace
    cfg = without_card(cfg_of(corpus, os.path.join(tmp, "drill_a"), seed, **kernels))
    cfg = rep(cfg, train=rep(cfg.train, resilience=rep(cfg.train.resilience, max_to_keep=1)))
    res = cfg.train.resilience
    chains = {"a": [("train_resilience (a)", config_yamls(cfg, os.path.join(
        tmp, "drill_a", "yaml")) + ["--max_steps", str(DRILL_STEPS), "--faults", DRILL_NAN])]}
    # (b): every run of the train command with --deterministic, so that two
    # uninterrupted runs repeat bit for bit (the default backward sums with
    # atomics: two runs' losses part by ~1e-2 within 9 steps)
    det = ["--deterministic", "--max_steps", str(DRILL_STEPS)]
    cfg_b = without_card(cfg_of(corpus, os.path.join(tmp, "drill_b"), seed, **kernels))
    args = config_yamls(cfg_b, os.path.join(tmp, "drill_b", "yaml")) + det
    chains["b"] = [("train_resilience (b)", args + ["--faults", DRILL_SIGTERM]),
                   ("train_resilience (b) resume", args + ["--restore_step", "-1"])]
    base_cfgs = []
    for i in range(2):  # stop at 8 without a signal, then resume: the same batches
        c = without_card(cfg_of(corpus, os.path.join(tmp, f"drill_b_uninterrupted_{i}"), seed,
                                **kernels))
        a = config_yamls(c, os.path.join(tmp, f"drill_b_uninterrupted_{i}", "yaml")) + det
        chains[f"uninterrupted_{i}"] = [
            ("train_resilience (b) uninterrupted", a[:-1] + ["8"]),
            ("train_resilience (b) uninterrupted", a + ["--restore_step", "-1"])]
        base_cfgs.append(c)
    gc.collect()
    torch.cuda.empty_cache()  # the card's memory for the four processes
    done = train_chains(chains, dev)

    ((stdout, secs_a),) = done["a"]
    (events,) = runs_of(cfg.train.path.log_path)
    end = of(events, "train_end")[-1]
    counters, launches = end["counters"], end["kernel_launches"]
    n_steps, n_vals = int(counters.get("train_steps_total", 0)), len(of(events, "val"))
    want_launches = {k: per_step * n_steps + per_val * n_val * n_vals
                     for k, (per_step, per_val) in want.items()}
    last = of(events, "train_step")[-1]
    finite = last["step"] == DRILL_STEPS and all(
        math.isfinite(v) for k, v in last.items() if k.endswith("_loss"))
    rollbacks = [(e["step"], e["restore_step"]) for e in of(events, "rollback")]
    retried = "injected loader_ioerror@3" in stdout and "retry 1/3" in stdout
    val = None
    saved = {}
    for e in events:  # each save carries the val loss logged before it
        if e["event"] == "val":
            val = e["total_loss"]
        elif e["event"] == "checkpoint_save":
            saved[e["step"]] = val
    scored = {s: v for s, v in saved.items() if v is not None}
    best = min(scored, key=scored.get) if scored else None
    on_disk = CheckpointManager(cfg.train.path.ckpt_path).all_steps()
    want_disk = sorted({max(saved)} | ({best} if best is not None else set()))
    emit("train_resilience", drill="a", entry="python -m speakingstyle_torch train",
         faults=DRILL_NAN, steps=DRILL_STEPS, seconds=secs_a, run_at_once=list(chains),
         resilience=dataclasses.asdict(res), rollbacks=rollbacks, loader_retried=retried,
         counters=counters, steps_run=n_steps, val_passes=n_vals,
         train_steps_logged=[e["step"] for e in of(events, "train_step")],
         final_losses={k: v for k, v in last.items() if k.endswith("_loss")},
         launches=launches, want_launches=want_launches,
         keep_best={"saves_with_val": saved, "best": best, "on_disk": on_disk,
                    "want_on_disk": want_disk})
    if rollbacks != [(7, 5)] or not retried or not finite:
        fail(f"train_resilience (a): rollbacks {rollbacks}, loader retried {retried}, "
             f"finite at step {DRILL_STEPS} {finite}")
    if counters.get("faults_fired_total") != 2 or counters.get("train_rollbacks_total") != 1 \
            or n_steps != DRILL_STEPS + 2:
        fail(f"train_resilience (a): counters {counters}")
    if any(launches[k] != n or (want[k][0] and not n) for k, n in want_launches.items()):
        fail(f"train_resilience (a): launches {launches}, want {want_launches}")
    if on_disk != want_disk:
        fail(f"train_resilience (c): checkpoints {on_disk}, want {want_disk} (best {best})")

    (stdout, secs_b), (_, secs_r) = done["b"]
    flushed = "SIGTERM: checkpoint flushed at step 8" in stdout
    stopped, resumed = runs_of(cfg_b.train.path.log_path)
    flush = [(e["signal"], e["step"]) for e in of(stopped, "preempt_flush")]
    ckpt8 = 8 in CheckpointManager(cfg_b.train.path.ckpt_path).all_steps()
    base = [{k: v for run in runs_of(c.train.path.log_path) for k, v in losses_of(run).items()}
            for c in base_cfgs]
    got = {**losses_of(stopped), **losses_of(resumed)}
    steps = range(1, DRILL_STEPS + 1)
    spread = max(abs(base[0][s] - base[1][s]) for s in steps)
    err = max(abs(got.get(s, math.nan) - base[0][s]) for s in steps)
    allowed = spread + RESUME_RTOL * max(abs(base[0][s]) for s in steps)
    emit("train_resilience", drill="b", entry="python -m speakingstyle_torch train",
         faults=DRILL_SIGTERM, deterministic=True,
         seconds={"stopped": secs_b, "resumed": secs_r}, run_at_once=list(chains),
         flushed=flushed,
         preempt_flush=flush, checkpoint_8_on_disk=ckpt8,
         stopped_steps=sorted(losses_of(stopped)), resumed_steps=sorted(losses_of(resumed)),
         resumed_from=of(resumed, "train_start")[0].get("checkpoint_step"),
         losses={s: got.get(s) for s in steps},
         uninterrupted_losses=[{s: b[s] for s in steps} for b in base],
         uninterrupted_spread=spread, max_abs_err=err, allowed=allowed,
         tol={"spread_plus_rtol": RESUME_RTOL})
    if not (flushed and flush == [("SIGTERM", 8)] and ckpt8
            and sorted(losses_of(stopped)) == list(range(1, 9))
            and sorted(losses_of(resumed)) == list(range(9, DRILL_STEPS + 1))):
        fail(f"train_resilience (b): flushed {flushed} {flush}, step 8 on disk {ckpt8}, "
             f"steps {sorted(losses_of(stopped))} then {sorted(losses_of(resumed))}")
    if not err <= allowed:
        fail(f"train_resilience (b): losses {err} from the uninterrupted runs', allowed "
             f"{allowed} (their spread {spread})")


# ---------------------------------------------------------------- phase 9: remat

REMAT_STEPS = 4


@contextlib.contextmanager
def deterministic():
    """Deterministic algorithms for a comparison (``device.use_deterministic``),
    restored after."""
    import torch

    from speakingstyle_torch.device import use_deterministic

    saved = torch.are_deterministic_algorithms_enabled()
    use_deterministic(True)
    try:
        yield
    finally:
        use_deterministic(saved)


def step_ms(cfg, arrays, dev, reps=5):
    """Median wall ms of ``reps`` train steps on one batch (after two),
    synchronised around each."""
    import torch

    from speakingstyle_torch.training.trainer import build_state, make_train_step

    state, step = build_state(cfg, dev), make_train_step(cfg)
    times = []
    for i in range(reps + 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(state, arrays)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times[2:])


def remat_phase(cfg, batch, dev):
    """Phase 9: ``run_training`` for REMAT_STEPS steps with
    ``sharding.remat`` off and on, every kernel count set to 0 just before
    and read just after each: under remat the encoder's and decoder's FFT
    blocks run their forwards twice (the recompute), the reference
    encoder's once; the peak memory of both. The step time of both on the
    first batch, in turns (off, on, on, off). Then one step's per-leaf
    gradients on the first batch, dropout on, deterministic algorithms:
    remat against two runs without it, within their difference (bit for
    bit where they repeat); and how far two runs under PyTorch's default
    algorithms part."""
    import torch

    from speakingstyle_torch.training.trainer import (
        build_state, make_train_step, run_training, to_device,
    )

    rep = dataclasses.replace
    tr, re_ = cfg.model.transformer, cfg.model.reference_encoder
    blocks = tr.encoder_layer + tr.decoder_layer
    attn = re_.encoder_layer + blocks
    convs = sum(c[-1] for c in conv_cases(cfg))
    with_remat = lambda c, on: rep(c, train=rep(c.train, sharding=rep(c.train.sharding,
                                                                       remat=on)))
    runs = {}
    for remat in (False, True):
        c = with_remat(cfg, remat)
        c = rep(c, train=rep(c.train, path=rep(c.train.path,
                                               ckpt_path=c.train.path.ckpt_path + f"_{remat}",
                                               log_path=c.train.path.log_path + f"_{remat}")))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        run_training(c, device=dev, max_steps=REMAT_STEPS)
        counts = read_counts()
        runs[remat] = {"launches": counts, "max_memory_allocated_bytes":
                       torch.cuda.max_memory_allocated(), "step_ms": []}
    arrays = to_device(batch.arrays(), dev)
    for remat in (False, True, True, False):
        runs[remat]["step_ms"].append(step_ms(with_remat(cfg, remat), arrays, dev))
    per_step = {"fused_attention_fwd": attn + blocks, "fused_attention_bwd": attn,
                "fused_attention_bwd_delta": attn, "fused_conv1d_fwd": convs + 2 * blocks,
                "fused_conv1d_fwd_act": re_.conv_layer}
    want = {k: n * REMAT_STEPS for k, n in per_step.items()}
    def one_step(remat):
        c = with_remat(cfg, remat)
        return [x.float() for x in make_train_step(c)(build_state(c, dev), arrays)[1]]

    with deterministic():
        grads = [one_step(False), one_step(False), one_step(True)]
    default = [one_step(False), one_step(False)]  # PyTorch's default algorithms
    scale = [x.abs().max().clamp_min(1e-30) for x in grads[0]]
    rel = lambda a, b: max(((x - y).abs().max() / s).item() for x, y, s in zip(a, b, scale))
    spread, err = rel(grads[0], grads[1]), rel(grads[2], grads[0])
    default_differ = sum(not torch.equal(a, b) for a, b in zip(*default))
    emit("train_remat", entry="training.trainer.run_training", steps=REMAT_STEPS,
         checkpointed_blocks=blocks, remat=runs[True], no_remat=runs[False],
         want_launches=want, peak_ratio=runs[True]["max_memory_allocated_bytes"]
         / runs[False]["max_memory_allocated_bytes"],
         step_ms_ratio=statistics.median(runs[True]["step_ms"])
         / statistics.median(runs[False]["step_ms"]),
         grads={"leaves": len(grads[0]), "deterministic": True,
                "remat_vs_no_remat_max_rel": err, "no_remat_spread_max_rel": spread,
                "default_algorithms_leaves_differing": default_differ,
                "default_algorithms_spread_max_rel": rel(default[0], default[1]),
                "dropout": [tr.encoder_dropout, tr.decoder_dropout, re_.dropout]})
    if any(runs[True]["launches"][k] != n for k, n in want.items()):
        fail(f"train_remat: launches {runs[True]['launches']}, want {want}")
    if not err <= spread:
        fail(f"train_remat: remat gradients {err} from the plain ones, spread {spread}")


# ---------------------------------------------------------------- phase 10: costs

SAVE_REPEATS = 3
# the runs of the costs phase, each configuration once (a cut for the
# script's time: twice, in turns, and one step more a run before); 3 steps
# a run are measured
COST_STEPS = 5
COST_ORDER = ("prefetcher", "no_sentinel", "inline_copy")


class InlineCopy:
    """The loop's data path before the prefetcher: each batch loaded,
    collated and copied in the step loop's own thread (``to_device``)."""

    def __init__(self, batches, device, **_):
        self.batches, self.device = batches, device

    def __iter__(self):
        return self

    def __next__(self):
        from speakingstyle_torch.training.trainer import to_device

        batch = next(self.batches)
        return batch, to_device(batch.arrays(), self.device)

    def stop(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def save_costs(cfg, dev, tmp):
    """The step loop's stall at a save step (the time ``save()`` holds
    it) with synchronous and with async saves, the checkpoint's bytes, and
    the async write's seconds after the stall, median of SAVE_REPEATS."""
    import torch

    from speakingstyle_torch.training.checkpoint import STATE_NAME, CheckpointManager
    from speakingstyle_torch.training.trainer import build_state

    state = build_state(cfg, dev)
    out = {}
    for mode in ("sync", "async"):
        ckpt = CheckpointManager(os.path.join(tmp, f"save_{mode}"), max_to_keep=1,
                                 async_save=mode == "async")
        stalls, writes = [], []
        for i in range(SAVE_REPEATS + 1):  # the first allocates the pinned buffers
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            path = ckpt.save(i + 1, state)
            t1 = time.perf_counter()
            ckpt.wait()
            if i:
                stalls.append((t1 - t0) * 1e3)
                writes.append(time.perf_counter() - t1)
        out[mode] = {"stall_ms": stalls, "stall_ms_median": statistics.median(stalls),
                     "write_s_after_stall_median": statistics.median(writes),
                     "checkpoint_bytes": os.path.getsize(os.path.join(path, STATE_NAME))}
    return out


def timed_run(cfg, dev):
    """``run_training`` for COST_STEPS steps: per step from step 3 on, the
    step time and data wait of its log line and the whole iteration
    (1 / steps_per_sec), in ms."""
    from speakingstyle_torch.training.trainer import run_training

    run_training(cfg, device=dev, max_steps=COST_STEPS)
    rows = read_log(os.path.join(cfg.train.path.log_path, "log.txt"))["train"]
    rows = [rows[s] for s in range(TRAIN_WARMUP + 1, COST_STEPS + 1)]
    return {"step_ms": [r["step_time_s"] * 1e3 for r in rows],
            "data_wait_ms": [r["data_wait_s"] * 1e3 for r in rows],
            "iteration_ms": [1e3 / r["steps_per_sec"] for r in rows]}


def sentinel_cost(cfg, batch, dev):
    """What the NaN sentinel adds to a step: ``all_finite`` over one step's
    losses and gradients, traced: its device operations, their launches
    and device ms; and its host ms a call (launches only, no sync)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from speakingstyle_torch.training.resilience import all_finite
    from speakingstyle_torch.training.trainer import build_state, make_train_step, to_device

    state = build_state(cfg, dev)
    losses, grads = make_train_step(cfg)(state, to_device(batch.arrays(), dev))
    losses.pop("_finite", None)
    run = lambda: all_finite(losses, grads)
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    events = prof.events()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    t0 = time.perf_counter()
    for _ in range(100):
        run()
    host_ms = (time.perf_counter() - t0) * 10.0
    torch.cuda.synchronize()
    return {"device_ops": len(kernels),
            "launches": sum(e.name in ("cudaLaunchKernel", "cudaMemcpyAsync", "cudaMemsetAsync")
                            for e in events),
            "device_ms": sum(e.time_range.elapsed_us() for e in kernels) / 1e3,
            "host_ms": host_ms, "leaves": len(grads) + len(losses)}


def costs_phase(cfg_of, corpus, tmp, seed, dev, batch):
    """Phase 10, what the new paths cost (no claim): ``run_training`` in
    COST_ORDER, the kernel path with the prefetcher and the NaN sentinel
    (the defaults), with the sentinel off, and with the inline copy in place
    of the prefetcher: step time, data wait and iteration per step; what the
    sentinel's reduction adds to a step; the save stall."""
    from speakingstyle_torch.data import prefetch

    rep = dataclasses.replace
    kernels = dict(TRAIN_PATHS)["kernels"]

    def variant(tag, out):
        cfg = without_card(cfg_of(corpus, out, seed, **kernels))
        if tag == "no_sentinel":
            cfg = rep(cfg, train=rep(cfg.train, resilience=rep(cfg.train.resilience,
                                                                nan_sentinel=False)))
        return cfg

    # first: a traced window late in the process can come back without its
    # device events
    sentinel = sentinel_cost(variant("no_sentinel", os.path.join(tmp, "cost_ops")), batch, dev)
    runs = {}
    for i, tag in enumerate(COST_ORDER):
        cfg = variant(tag, os.path.join(tmp, f"cost_{i}_{tag}"))
        saved = prefetch.DevicePrefetcher
        if tag == "inline_copy":
            prefetch.DevicePrefetcher = InlineCopy
        try:
            run = timed_run(cfg, dev)
        finally:
            prefetch.DevicePrefetcher = saved
        for k, v in run.items():
            runs.setdefault(tag, {}).setdefault(k, []).extend(v)
    summary = {tag: {f"{k}_median": statistics.median(v) for k, v in r.items()}
               for tag, r in runs.items()}
    emit("train_costs", nvidia_smi=nvidia_smi(), order=COST_ORDER, steps=COST_STEPS,
         warmup_steps=TRAIN_WARMUP, runs=runs, medians=summary,
         sentinel=sentinel,
         saves=save_costs(variant("prefetcher", os.path.join(tmp, "cost_save")), dev, tmp))


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


# ---------------------------------------------------------------- serve_core

SERVE_CORE_PRECISIONS = ("f32", "bf16", "int8")
SERVE_CORE_DISPATCHES = 3  # steady dispatches per precision, and timed ones per path
STREAM_WINDOW = 32  # mel frames a streamed chunk emits (+ the 14-frame overlap a side)
# a streamed sample against the full-utterance vocode, outside the final
# overlap: cuDNN may pick another algorithm for the window's (1, 64) bucket
# than for the utterance's (4, 1000) one, and under TF32 (PyTorch's default
# for cuDNN convs, which a captured graph keeps) inputs that differ by f32
# noise can round to different 10-bit mantissas: one TF32 ulp of full
# scale, 2^-10 * 32768 = 32 int16 LSB
STREAM_LSB = 32


def serve_core_config(cfg, conv_impl):
    """The LJSpeech config on a lattice cut to the serve cell's point
    (4, 128, 1000), batch 1 and T_mel 64 for the streamed windows, one
    style bucket (4 or 1, 1000), and the three precision tiers."""
    serve = dataclasses.replace(
        serve_cell(cfg).serve, batch_buckets=[1, 4], src_buckets=[128], mel_buckets=[64, 1000],
        tiers=dataclasses.replace(cfg.serve.tiers, enabled=True,
                                  precisions=list(SERVE_CORE_PRECISIONS)))
    return dataclasses.replace(cfg, serve=serve,
                               model=dataclasses.replace(cfg.model, conv_impl=conv_impl))


def same_results(a, b):
    """Two dispatches' results equal bit for bit (mel, durations, wav)."""
    import numpy as np

    return all(x.mel_len == y.mel_len and np.array_equal(x.mel, y.mel)
               and np.array_equal(x.durations, y.durations) and np.array_equal(x.wav, y.wav)
               for x, y in zip(a, b))


def counted_run(engine, requests, **kw):
    """One dispatch with every kernel count set to 0 just before and read
    just after: (results, counts)."""
    import torch

    reset_counts()
    res = engine.run(requests, **kw)
    torch.cuda.synchronize()
    return res, read_counts()


def serve_core_phase(cfg, requests, seed, dev, attn_per, conv_per):
    """The serving engine core at the LJSpeech width, per conv path:
    precompile (CUDA graphs), steady dispatches at every precision, replay
    against eager, the style cache, streaming, a faulted stream, the
    poisoned tier, card FLOPs and the traced replayed dispatch. Returns
    {conv_impl: the kernel launches of one replayed dispatch}."""
    import numpy as np
    import torch

    from speakingstyle_torch.faults import FaultPlan
    from speakingstyle_torch.obs.cost import device_memory_watermarks
    from speakingstyle_torch.serving.resilience import InjectedFault
    from speakingstyle_torch.serving.streaming import receptive_field_frames, stream_wav

    flops, replay_launches = {}, {}
    for conv_impl in ("xla", "pallas"):
        phase = f"serve_core_{conv_impl}"
        want = {"fused_attention_fwd": attn_per, "fused_attention_fwd_bf16sm": 0,
                "fused_conv1d_fwd": conv_per if conv_impl == "pallas" else 0}
        scfg = serve_core_config(cfg, conv_impl)
        gc.collect()
        torch.cuda.empty_cache()
        reserved_before = torch.cuda.memory_reserved(dev)
        engine = build_engine(scfg, seed, dev)
        style = engine.style
        torch.cuda.synchronize()
        precompile_s = engine.precompile()
        torch.cuda.synchronize()
        rows = engine.programs() + style.programs()
        reserved = torch.cuda.memory_reserved(dev)
        watermarks = device_memory_watermarks()
        # a graph per program on the card (none on a CPU rehearsal)
        if any(r["graph"] != (dev.type == "cuda") for r in rows) or not engine.is_ready \
                or not style.is_ready:
            fail(f"{phase}: precompile left a program without a graph: {rows}")
        compiles = (engine.compile_count, style.compile_count)
        allocs = None

        # steady dispatches at every precision: nothing prepared
        steady, walls = {}, {"graph": [], "eager": []}
        for prec in SERVE_CORE_PRECISIONS:
            reqs = [dataclasses.replace(r, precision=prec) for r in requests]
            for _ in range(SERVE_CORE_DISPATCHES):
                steady[prec] = engine.run(reqs)
            if allocs is None:
                allocs = engine.pool.allocated
        if (engine.compile_count, style.compile_count) != compiles:
            fail(f"{phase}: steady dispatches prepared programs: "
                 f"{compiles} -> {(engine.compile_count, style.compile_count)}")
        # the dispatch wall, graphs against eager, in turns (cached styles),
        # after one eager dispatch (the default stream's first library calls)
        engine.run(requests, eager=True)
        for eager in (False, True, True, False, False, True):
            t0 = time.perf_counter()
            engine.run(requests, eager=eager)
            walls["eager" if eager else "graph"].append((time.perf_counter() - t0) * 1e3)

        # replay against eager, each with fresh references (the style
        # programs run too): bit for bit, and the same kernel launches,
        # the replay's counted by name in its trace
        replay_rows, bad = [], []
        for prec in SERVE_CORE_PRECISIONS:
            reqs = [dataclasses.replace(r, precision=prec) for r in requests]
            style.clear()
            got, trace = traced_replay(engine, reqs)
            style.clear()
            ref, ref_counts = counted_run(engine, reqs, eager=True)
            same = same_results(got, ref)
            got_counts = trace["kernels_in_trace"]
            replay_rows.append({"precision": prec, "bit_equal": same, "replay_launches": got_counts,
                                "eager_launches": ref_counts, "trace": trace})
            if not same or any(got_counts[k] != ref_counts[k] for k in got_counts) or any(
                    got_counts[k] != n for k, n in want.items()):
                bad.append(replay_rows[-1])
        if bad:
            fail(f"{phase}: replay differs from eager or from the launches a dispatch makes "
                 f"({want}): {bad}")

        # repeated references: zero encoder dispatches, a hit per request
        d0, h0 = style.dispatch_count, engine.registry.value("serve_style_cache_hits_total")
        repeat = engine.run(requests)
        hits = engine.registry.value("serve_style_cache_hits_total") - h0
        if style.dispatch_count != d0 or hits != len(requests):
            fail(f"{phase}: repeated references ran the encoder "
                 f"{style.dispatch_count - d0} times, {hits} cache hits")

        # streaming at depth 2 against depth 1 and the full-utterance wav
        overlap = receptive_field_frames(engine.vocoder)
        hop = engine.vocoder.hop_factor
        stream_rows = []
        for r in repeat:
            one = list(stream_wav(engine, r, STREAM_WINDOW, overlap, depth=1))
            two = list(stream_wav(engine, r, STREAM_WINDOW, overlap, depth=2))
            wav = np.concatenate(two)
            keep = max(0, r.mel_len - overlap) * hop
            lsb = int(np.abs(wav[:keep].astype(np.int32) - r.wav[:keep].astype(np.int32)).max(
                initial=0))
            stream_rows.append({
                "id": r.id, "chunks": len(two),
                "depth2_bit_equal_depth1": len(one) == len(two) and all(
                    np.array_equal(a, b) for a, b in zip(one, two)),
                "samples": int(len(wav)), "max_lsb_vs_full": lsb, "compared_samples": keep})
            if not (stream_rows[-1]["depth2_bit_equal_depth1"] and len(wav) == r.mel_len * hop
                    and lsb <= STREAM_LSB and keep > 0):
                fail(f"{phase}: stream {stream_rows[-1]} (bound {STREAM_LSB} LSB)")
        # a fault on the second window of a stream: every lease returns
        # (windows 1 and 2 dispatched, 1 emitted, the third dispatch raises)
        engine.fault_plan = FaultPlan.parse(f"vocoder_raise@{engine.vocode_calls + 3}")
        emitted = []
        longest = max(repeat, key=lambda r: r.mel_len)
        if longest.mel_len <= 2 * STREAM_WINDOW:
            fail(f"{phase}: no result spans three stream windows: {longest.mel_len} frames")
        try:
            for chunk in stream_wav(engine, longest, STREAM_WINDOW, overlap, depth=2):
                emitted.append(chunk)
            fail(f"{phase}: the armed vocoder_raise did not fire")
        except InjectedFault:
            pass
        engine.fault_plan = None
        faulted = {"chunks_emitted": len(emitted), "pool_outstanding": engine.pool.outstanding}
        if engine.pool.outstanding != 0 or len(emitted) != 1:
            fail(f"{phase}: the faulted stream left {faulted}")
        if engine.pool.allocated != allocs + 2:  # + two (1, 64) windows in flight
            fail(f"{phase}: staging buffers grew from {allocs} to {engine.pool.allocated}")

        # the poisoned int8 tier fails the quality gate, f32 still passes
        engine.poison_params("int8")
        poisoned = engine.run([dataclasses.replace(r, precision="int8") for r in requests])
        healthy = engine.run([dataclasses.replace(r, precision="f32") for r in requests])
        # a poisoned row whose durations all collapse to 0 (a huge negative
        # log-duration) emits an empty wav, which a per-wav gate cannot
        # judge (the JAX package's own drill notes it; its golden prober is
        # the detector for those): every non-empty poisoned wav must fail
        judged = [r for r in poisoned if len(r.wav)]
        gate = {"int8_poisoned": [dict(r.quality.as_dict(), mel_len=r.mel_len) for r in poisoned],
                "int8_empty_rows": len(poisoned) - len(judged),
                "f32": [dict(r.quality.as_dict(), mel_len=r.mel_len) for r in healthy]}
        if not judged or any(r.quality.ok for r in judged) or not all(
                r.quality.ok and len(r.wav) for r in healthy):
            fail(f"{phase}: the quality gate did not tell the poisoned tier apart: {gate}")
        if (engine.compile_count, style.compile_count) != compiles:
            fail(f"{phase}: the serve path prepared programs after precompile")

        cards = {r["name"]: r for r in rows}
        bucket = "acoustic:b4.s128.m1000"
        flops[conv_impl] = cards[bucket]["flops"]
        emit(phase, conv_impl=conv_impl, compute_dtype=scfg.model.compute_dtype,
             lattice={"batch": scfg.serve.batch_buckets, "src": scfg.serve.src_buckets,
                      "mel": scfg.serve.mel_buckets, "ref": scfg.serve.style.ref_buckets,
                      "precisions": list(SERVE_CORE_PRECISIONS)},
             precompile_s=precompile_s, graphs=len(rows), memory_reserved_bytes=reserved,
             memory_watermarks=watermarks,
             memory_reserved_by_engine_bytes=reserved - reserved_before,
             compiles=compiles, steady_dispatches=SERVE_CORE_DISPATCHES,
             pool_allocated=engine.pool.allocated,
             dispatch_wall_ms=walls,
             dispatch_wall_ms_median={k: statistics.median(v) for k, v in walls.items()},
             replay_vs_eager=replay_rows, style_repeat={"encoder_dispatches": 0, "hits": hits},
             stream=stream_rows, stream_overlap=overlap, stream_lsb_bound=STREAM_LSB,
             faulted_stream=faulted, quality_gate=gate,
             traced_replay=replay_rows[0]["trace"],
             cards={n: {k: c[k] for k in ("flops", "peak_bytes", "launches_per_replay",
                                          "precision")} for n, c in cards.items()})
        replay_launches[conv_impl] = replay_rows[0]["replay_launches"]
        del engine, style, steady, poisoned, healthy, repeat
        gc.collect()
        torch.cuda.empty_cache()
    # the card's FLOPs on the library path (einsum attention, cuDNN convs)
    lib_cfg = serve_core_config(cfg, "xla")
    lib_cfg = dataclasses.replace(lib_cfg, model=dataclasses.replace(
        lib_cfg.model, attention_kernel="einsum"))
    from speakingstyle_torch.serving.lattice import Bucket

    lib = build_engine(lib_cfg, seed, dev)
    flops["library"] = lib.acoustic_program(Bucket(4, 128, 1000)).card["flops"]
    del lib
    torch.cuda.empty_cache()
    emit("serve_core_flops", acoustic_flops=flops)
    if not (flops["xla"] == flops["pallas"] == flops["library"] > 0):
        fail(f"serve_core: the kernel and library paths' cards disagree: {flops}")
    return replay_launches


# the serve_http phase: the LJSpeech preset on the kernel path under its
# bf16 compute and the bf16 softmax, its whole lattice, behind the server
SERVE_HTTP_MODEL = {"attention_kernel": "fused", "conv_impl": "pallas",
                    "attention_softmax_dtype": "bfloat16"}
SERVE_HTTP_CLIENTS = 4      # closed-loop client threads
SERVE_HTTP_REQUESTS = 32    # their /synthesize requests in all
SERVE_HTTP_STREAMS = 8      # then /synthesize/stream requests, one at a time
SERVE_HTTP_BURST_EXTRA = 16  # the burst: queue_depth + this many at once
# a whole /synthesize wav against engine.run(eager=True) of the same
# request alone, in another bucket: within SERVE_HTTP_LSB int16 LSB, one
# TF32 ulp of full scale as STREAM_LSB (cuDNN may pick another vocoder
# algorithm per bucket; the first card runs read at most 12 LSB)
SERVE_HTTP_LSB = 32
# the serve command's subprocess: a lattice cut to one point per program
SERVE_CLI_LATTICE = {"batch_buckets": [1], "src_buckets": [32], "mel_buckets": [256],
                     "style": {"ref_buckets": [256]}}


def http_call(address, method, path, body=None, headers=None, conn=None, timeout=300):
    """(status, headers, body, seconds) of one request, on ``conn`` (kept
    alive) or a new connection."""
    import http.client

    own = conn is None
    if own:
        conn = http.client.HTTPConnection(*address, timeout=timeout)
    try:
        if isinstance(body, dict):
            body = json.dumps(body)
        t0 = time.perf_counter()
        conn.request(method, path, body=body, headers=headers or {})
        resp = conn.getresponse()
        data = resp.read()
        return resp.status, dict(resp.getheaders()), data, time.perf_counter() - t0
    finally:
        if own:
            conn.close()


def stream_call(address, payload, timeout=300, path="/synthesize/stream"):
    """One chunked-wav request (/synthesize/stream, or ``path``): (status,
    headers, body, seconds to the first PCM bytes, seconds in all)."""
    import http.client

    conn = http.client.HTTPConnection(*address, timeout=timeout)
    try:
        t0 = time.perf_counter()
        conn.request("POST", path, body=json.dumps(payload))
        resp = conn.getresponse()
        if resp.status != 200:
            return resp.status, dict(resp.getheaders()), resp.read(), None, None
        head = resp.read(44)
        first = resp.read(2)
        ttfa = time.perf_counter() - t0
        data = head + first + resp.read()
        return 200, dict(resp.getheaders()), data, ttfa, time.perf_counter() - t0
    finally:
        conn.close()


def pcm_of(what, body, sr):
    """int16 samples of a RIFF/WAVE body (16-bit mono at ``sr``)."""
    import numpy as np

    if body[:4] != b"RIFF" or body[8:12] != b"WAVE" or body[36:40] != b"data" \
            or int.from_bytes(body[24:28], "little") != sr:
        fail(f"{what}: not a 16-bit RIFF wav at {sr} Hz: {body[:44]!r}")
    return np.frombuffer(body[44:], np.int16)


def quantiles_ms(seconds):
    import numpy as np

    a = np.asarray(seconds, np.float64) * 1e3
    return {"n": int(a.size), "p50": float(np.percentile(a, 50)),
            "p90": float(np.percentile(a, 90)), "max": float(a.max())}


def hist_view(registry, name, labels=None):
    snap = registry.histogram(name, labels=labels).snapshot()
    return {k: snap.get(k) for k in ("count", "p50", "p95", "p99")}


def longform_check(address):
    """One two-sentence chapter on /synthesize/longform of a ``serve``
    subprocess: its record, ``ok`` when it answered a chunked RIFF wav of
    at least 2 chunks."""
    status, headers, body, secs = http_call(
        address, "POST", "/synthesize/longform", {"text": " ".join(TEXTS[:2])})
    chunks = int(headers.get("X-Longform-Chunks", 0))
    return {"status": status, "tier": headers.get("X-Longform-Tier"), "chunks": chunks,
            "samples": max(0, len(body) - 44) // 2, "seconds": secs,
            "ok": status == 200 and body[:4] == b"RIFF" and len(body) > 44 and chunks >= 2
            and headers.get("X-Longform-Tier") == "chunked"}


def serve_cli_check(tmp, step, seed, wav, dev):
    """``python -m speakingstyle_torch serve`` in a subprocess over the
    checkpoint ``restored_phase`` wrote, on a one-point lattice: it
    precompiles, serves one request and one chapter (``longform_check``) on
    the port it prints, and exits 0 on SIGTERM. Returns its record."""
    import queue
    import signal
    import threading

    import yaml

    out = os.path.join(tmp, "serve_cli")
    os.makedirs(out)
    os.symlink(os.path.join(tmp, "ckpt"), os.path.join(out, "ckpt"))
    cli_args = smoke_configs(out, SERVE_HTTP_MODEL)
    train_yaml = cli_args[cli_args.index("-t") + 1]
    with open(train_yaml) as f:
        train = yaml.safe_load(f)
    train["serve"] = SERVE_CLI_LATTICE
    with open(train_yaml, "w") as f:
        yaml.safe_dump(train, f)
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "speakingstyle_torch", "serve", *cli_args, "--restore_step",
         str(step), "--seed", str(seed), "--host", "127.0.0.1", "--port", "0",
         "--ref_audio", wav, "--device", dev.type],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    lines = queue.Queue()
    reader = threading.Thread(target=lambda: [lines.put(l) for l in proc.stdout], daemon=True)
    reader.start()
    log, address = [], None
    try:
        deadline = time.monotonic() + 300
        while address is None and time.monotonic() < deadline and proc.poll() is None:
            try:
                line = lines.get(timeout=1.0)
            except queue.Empty:
                continue
            log.append(line.rstrip())
            if line.startswith("serving on http://"):
                host, port = line.split("http://", 1)[1].split(" ", 1)[0].rsplit(":", 1)
                address = (host, int(port))
        if address is None:
            fail(f"serve_http: the serve command did not start serving: {log[-20:]}")
        ready_s = time.perf_counter() - t0
        status, headers, body, secs = http_call(address, "POST", "/synthesize",
                                                {"text": TEXTS[0]})
        samples = len(body) - 44
        longform = longform_check(address)
        proc.send_signal(signal.SIGTERM)
        code = proc.wait(timeout=120)
        reader.join(timeout=30)
        while not lines.empty():
            log.append(lines.get().rstrip())
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
    record = {"exit_code": code, "ready_s": ready_s, "status": status,
              "wav_samples": samples // 2, "request_s": secs,
              "model_version": headers.get("X-Model-Version"),
              "precompiled": [l for l in log if l.startswith("precompiled")],
              "longform": longform, "log_tail": log[-6:]}
    if not (code == 0 and status == 200 and body[:4] == b"RIFF" and samples > 0
            and record["precompiled"] and any("SIGTERM" in l for l in log)
            and longform["ok"]):
        fail(f"serve_http: the serve command {record}")
    return record


def serve_http_phase(tmp, step, seed, dev, smi):
    """The single-engine HTTP path on the card: the LJSpeech preset at full
    width on the kernel path (bf16 compute, bf16 softmax) and its whole
    lattice, built and precompiled through the serve command's own
    ``load_engine`` and ``precompile`` from ``restored_phase``'s
    checkpoint, behind ``SynthesisServer`` on 127.0.0.1:0 (frontend pool of
    2). Traffic, all of it under torch.profiler, with every kernel count
    set to 0 just before and read just after: the four references uploaded
    with POST /styles; 4 closed-loop clients sending 32 /synthesize
    requests; 8 /synthesize/stream requests one at a time (TTFA); a burst
    of queue_depth + 16 concurrent requests. Then shutdown() while 2
    streams are in flight. Checks: every 200 a RIFF wav of mel_len x hop
    samples that passes the quality gate and matches
    ``engine.run(eager=True)`` of the same request alone, the whole wav
    (``SERVE_HTTP_LSB``); each stream within ``STREAM_LSB`` of its full wav
    outside the overlap tail; no program prepared over the traffic; the
    burst answered 200 or 429 (each 429 with Retry-After); the in-flight
    streams complete and later requests get 503; the port's kernels
    counted by name in the trace of the traffic equal the registry's
    credits; then the ``serve`` command in a subprocess. Returns the
    kernels counted in the trace (the launches it reports). The client
    latencies are read under the profiler."""
    import threading

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from speakingstyle_torch.cli import config_from_args
    from speakingstyle_torch.cli.serve import build_parser, model_version_string
    from speakingstyle_torch.obs.quality import validate_wav
    from speakingstyle_torch.serving.engine import load_engine
    from speakingstyle_torch.serving.frontend import TextFrontend, load_ref_mel
    from speakingstyle_torch.serving.server import SynthesisServer
    from speakingstyle_torch.serving.streaming import resolve_overlap

    out = os.path.join(tmp, "serve_http")
    os.makedirs(out)
    os.symlink(os.path.join(tmp, "ckpt"), os.path.join(out, "ckpt"))
    args = build_parser().parse_args(smoke_configs(out, SERVE_HTTP_MODEL)
                                     + ["--restore_step", str(step)])
    cfg = config_from_args(args)
    serve = cfg.serve
    sr = cfg.preprocess.preprocessing.audio.sampling_rate
    gc.collect()
    torch.cuda.empty_cache()
    reserved0 = torch.cuda.memory_reserved(dev)
    engine, info = load_engine(cfg, step, device=dev, vocoder_seed=seed + 1)
    style = engine.style
    hop = engine.vocoder.hop_factor
    torch.cuda.synchronize()
    precompile_s = engine.precompile()
    torch.cuda.synchronize()
    rows = engine.programs() + style.programs()
    reserved = torch.cuda.memory_reserved(dev)
    if any(r["graph"] != (dev.type == "cuda") for r in rows) or not engine.is_ready \
            or not style.is_ready:
        fail("serve_http: precompile left a program without a graph")
    compiles = (engine.compile_count, style.compile_count)
    emit("serve_http_precompile", nvidia_smi=smi, entry="cli.serve: load_engine + precompile",
         restore_step=step, model=SERVE_HTTP_MODEL, compute_dtype=cfg.model.compute_dtype,
         lattice={"batch": serve.batch_buckets, "src": serve.src_buckets,
                  "mel": serve.mel_buckets, "ref": serve.style.ref_buckets,
                  "precisions": list(engine.precisions)},
         programs=len(rows), synthesis_programs=compiles[0], style_programs=compiles[1],
         precompile_s=precompile_s, memory_reserved_bytes=reserved,
         memory_reserved_by_engine_bytes=reserved - reserved0,
         memory_allocated_bytes=torch.cuda.memory_allocated(dev))

    wavs, _ = write_smoke_inputs(out, cfg, seed)
    server = SynthesisServer(engine, TextFrontend(cfg, load_ref_mel(cfg, wavs[-1])),
                             host="127.0.0.1", port=0,
                             model_info=dict(info, version=model_version_string(info)))
    server_thread = threading.Thread(target=server.serve_forever, daemon=True)
    server_thread.start()
    address = server.address[:2]
    answers = []  # (what, payload, status, headers, body)
    # the whole traffic under the profiler: the port's kernels counted by
    # name in its trace are the launches this phase reports
    prof, profiling = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]), False
    try:
        reset_counts()
        prof.start()
        profiling = True
        prime_trace()
        t_traffic = time.perf_counter()
        style_ids = []
        for w in wavs:
            with open(w, "rb") as f:
                status, _, body, _ = http_call(address, "POST", "/styles", f.read(),
                                               {"Content-Type": "audio/wav"})
            if status != 200:
                fail(f"serve_http: POST /styles answered {status}: {body[:300]!r}")
            style_ids.append(json.loads(body)["style_id"])

        def payload(i):
            return {"text": TEXTS[i % len(TEXTS)], "style_id": style_ids[(i // 4) % 4]}

        # closed-loop clients, each on its own kept-alive connection
        import http.client

        latencies, lock = [], threading.Lock()

        def client(c):
            conn = http.client.HTTPConnection(*address, timeout=300)
            try:
                for k in range(c, SERVE_HTTP_REQUESTS, SERVE_HTTP_CLIENTS):
                    p = payload(k)
                    status, headers, body, secs = http_call(address, "POST", "/synthesize", p,
                                                            conn=conn)
                    with lock:
                        answers.append(("closed_loop", p, status, headers, body))
                        latencies.append(secs)
            finally:
                conn.close()

        threads = [threading.Thread(target=client, args=(c,)) for c in range(SERVE_HTTP_CLIENTS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        closed_loop_s = time.perf_counter() - t0

        # streams, one at a time (so each dispatch is alone)
        streams, ttfas = [], []
        for i in range(SERVE_HTTP_STREAMS):
            p = payload(i)
            status, headers, body, ttfa, secs = stream_call(address, p)
            streams.append((p, status, headers, body))
            if ttfa is not None:
                ttfas.append(ttfa)

        # the burst
        burst, n_burst = [], serve.queue_depth + SERVE_HTTP_BURST_EXTRA
        start = threading.Event()

        def burst_one(k):
            start.wait(timeout=60)
            p = payload(k)
            status, headers, body, _ = http_call(address, "POST", "/synthesize", p)
            with lock:
                burst.append((p, status, headers, body))

        threads = [threading.Thread(target=burst_one, args=(k,)) for k in range(n_burst)]
        for t in threads:
            t.start()
        t0 = time.perf_counter()
        start.set()
        for t in threads:
            t.join(timeout=600)
        burst_s = time.perf_counter() - t0
        answers.extend(("burst", p, s, h, b) for p, s, h, b in burst if s == 200)
        traffic_s = time.perf_counter() - t_traffic
        torch.cuda.synchronize()
        prof.stop()
        profiling = False
        credited = read_counts()
        kernels = [e for e in prof.events()
                   if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
        window_ms, busy_ms, by_name, ours = device_time("serve_http traffic", kernels)
        launches = check_trace("serve_http traffic", by_name, credited)
        after = (engine.compile_count, style.compile_count)
        if after != compiles:
            fail(f"serve_http: the traffic prepared programs: {compiles} -> {after}")
        for name in ("fused_attention_fwd_bf16sm", "fused_conv1d_fwd"):
            if launches[name] <= 0:
                fail(f"serve_http: {name} ran no time in the traffic's trace: {launches}")
        statuses = sorted({s for _, s, _, _ in burst})
        no_retry = [h for _, s, h, _ in burst if s == 429 and "Retry-After" not in h]
        if len(burst) != n_burst or set(statuses) - {200, 429} or no_retry:
            fail(f"serve_http: the burst answered {statuses} ({len(burst)} of {n_burst}), "
                 f"{len(no_retry)} 429s without Retry-After")

        # shutdown while two streams are in flight: each stream holds after
        # its first window until both are inside their stream scope
        hold, held = threading.Event(), threading.Semaphore(0)
        real_chunks = server.stream_chunks

        def held_chunks(result, arrival=None):
            chunks = real_chunks(result, arrival)
            try:
                yield next(chunks)
                held.release()
                hold.wait(timeout=120)
                yield from chunks
            finally:
                chunks.close()

        server.stream_chunks = held_chunks
        keep = http.client.HTTPConnection(*address, timeout=300)
        first = http_call(address, "POST", "/synthesize", payload(0), conn=keep)[0]
        inflight = []
        drains = [threading.Thread(target=lambda k=k: inflight.append(
            (payload(k), *stream_call(address, payload(k))[:3]))) for k in (3, 7)]
        for t in drains:  # one after the other, so each dispatch is alone
            t.start()
            if not held.acquire(timeout=120):
                fail("serve_http: a stream to hold in flight did not start")
        closer = threading.Thread(target=server.shutdown)
        closer.start()
        closer.join(timeout=2.0)
        draining = closer.is_alive() and server._active_streams == 2
        hold.set()
        for t in drains:
            t.join(timeout=300)
        closer.join(timeout=300)
        server_thread.join(timeout=60)
        late = [http_call(address, "POST", "/synthesize", payload(k), conn=keep)[:3]
                for k in range(2)]
        keep.close()
        if not (first == 200 and draining and not closer.is_alive()
                and [s for _, s, _, _ in inflight] == [200, 200]
                and [s for s, _, _ in late] == [503, 503]
                and all("X-Request-Id" in h for s, h, _ in late)):
            fail(f"serve_http: shutdown with streams in flight: drained while waiting "
                 f"{draining}, streams {[s for _, s, _, _ in inflight]}, later requests "
                 f"{[s for s, _, _ in late]}")
    finally:
        if profiling:
            prof.stop()
        server.shutdown()

    # every answer against engine.run(eager=True) of the same request alone
    refs = {}

    def reference(p):
        key = (p["text"], p["style_id"])
        if key not in refs:
            req = server.frontend.request("eager", p)
            refs[key] = engine.run([req], eager=True)[0]
        return refs[key]

    bad, worst, checked = [], 0, 0
    for what, p, status, headers, body in answers:
        if status != 200:
            bad.append({"what": what, "status": status, "body": body[:200].decode(errors="replace")})
            continue
        wav = pcm_of(f"serve_http {what}", body, sr)
        ref = reference(p)
        verdict = validate_wav(wav, sr, serve.quality)
        if len(wav) != ref.mel_len * hop or not verdict.ok or "X-Request-Id" not in headers \
                or "X-Trace-Id" not in headers:
            bad.append({"what": what, "samples": len(wav), "want": ref.mel_len * hop,
                        "quality": verdict.as_dict()})
            continue
        lsb = int(np.abs(wav.astype(np.int32) - ref.wav.astype(np.int32)).max(initial=0))
        worst = max(worst, lsb)
        checked += 1
        if lsb > SERVE_HTTP_LSB:
            bad.append({"what": what, "text": p["text"][:20], "max_lsb": lsb})
    overlap = resolve_overlap(serve.fleet.stream_overlap, engine.vocoder)
    stream_rows = []
    for p, status, headers, body in streams + [(p, s, h, b) for p, s, h, b in inflight]:
        ref = reference(p)
        wav = pcm_of("serve_http stream", body, sr) if status == 200 else np.zeros(0, np.int16)
        keep_n = max(0, ref.mel_len - overlap) * hop
        lsb = int(np.abs(wav[:keep_n].astype(np.int32)
                         - ref.wav[:keep_n].astype(np.int32)).max(initial=0)) \
            if len(wav) == len(ref.wav) else None
        stream_rows.append({"status": status, "samples": int(len(wav)),
                            "batch_rows": headers.get("X-Batch-Rows"), "max_lsb": lsb})
        if status != 200 or lsb is None or lsb > STREAM_LSB or keep_n <= 0:
            bad.append({"stream": stream_rows[-1], "want_samples": len(ref.wav)})
    if bad:
        fail(f"serve_http: answers that fail their checks: {bad[:8]}")

    # one closed-loop request's span tree, its engine split timed on the
    # device (CUDA events) on the card
    from speakingstyle_torch.obs.trace import assemble_trace, get_span_ring

    tid = next(h["X-Trace-Id"] for what, _, s, h, _ in answers if what == "closed_loop")
    spans = {x["name"]: x for x in get_span_ring().spans(tid)}
    clock = "cuda_event" if dev.type == "cuda" else "host"
    if not ({"serve_request", "serve_frontend", "engine_run", "engine_acoustic",
             "engine_vocode"} <= set(spans) and all(
                spans[n]["fields"]["clock"] == clock and spans[n]["duration_s"] > 0
                for n in ("engine_acoustic", "engine_vocode"))):
        fail(f"serve_http: request {tid}'s spans {sorted(spans)} lack the engine split "
             f"timed by {clock}")
    span_tree = {n: spans[n]["duration_s"] * 1e3 for n in sorted(spans)}
    span_tree["critical_path"] = [x["name"] for x in assemble_trace(
        list(spans.values()), tid)["critical_path"]]

    registry = engine.registry
    occupancy = {int(dict(m.labels)["rows"]): int(m.value)
                 for m in registry.metrics_named("serve_batch_occupancy_total")}
    batches = sum(occupancy.values())
    emit("serve_http", nvidia_smi=smi,
         requests={"closed_loop": SERVE_HTTP_REQUESTS, "clients": SERVE_HTTP_CLIENTS,
                   "streams": SERVE_HTTP_STREAMS, "burst": n_burst,
                   "checked_wavs": checked},
         under_profiler=True,
         latency_ms=quantiles_ms(latencies), closed_loop_s=closed_loop_s,
         ttfa_ms=quantiles_ms(ttfas), burst_s=burst_s, traffic_s=traffic_s,
         burst_statuses={s: sum(1 for _, x, _, _ in burst if x == s) for s in statuses},
         shed=int(registry.value("serve_shed_total")),
         batches=batches, occupancy=occupancy,
         mean_occupancy=(sum(r * n for r, n in occupancy.items()) / batches) if batches else None,
         server_request_latency_s=hist_view(registry, "serve_request_latency_seconds"),
         server_queue_wait_s=hist_view(registry, "serve_queue_wait_seconds"),
         server_ttfa_s=hist_view(registry, "serve_ttfa_seconds"),
         server_http_200_s=hist_view(registry, "serve_http_request_seconds", {"status": "200"}),
         wav_vs_eager_lsb={"max": worst, "bound": SERVE_HTTP_LSB},
         streams=stream_rows, stream_lsb_bound=STREAM_LSB, stream_overlap=overlap,
         compiles={"before": compiles, "after": after},
         traffic_trace={"trace_window_ms": window_ms, "device_busy_ms": busy_ms,
                        "idle_share": 1.0 - busy_ms / window_ms, "device_ops": len(kernels),
                        "port_kernel_ms": ours, "kernels_in_trace": launches,
                        "credited": credited},
         span_ms=span_tree,
         shutdown={"drained_while_waiting": draining, "in_flight_streams": 2,
                   "later_statuses": [s for s, _, _ in late]})
    del server, engine, style, refs
    gc.collect()
    torch.cuda.empty_cache()
    # the serve command and its fleet form (serve_fleet's check) at once: two
    # subprocesses that time nothing, side by side for the script's time
    import concurrent.futures

    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        checks = [pool.submit(fn, tmp, step, seed, wavs[-1], dev)
                  for fn in (serve_cli_check, fleet_cli_check)]
        emit("serve_http_cli", **checks[0].result())
        emit("serve_fleet_cli", **checks[1].result())
    return launches


# ---------------------------------------------------------------- phase 17: serve_fleet

SERVE_FLEET_REPLICAS = 2
# the fleet cell's lattice, cut as serve_core's: batch {1, 4} x src {128} x
# mel {1000} and style (b, 1000), plus the 256-frame vocoder point the
# stream windows cover (the engine's vocoder points are batch x mel, so 256
# also brings two acoustic points)
SERVE_FLEET_LATTICE = {"batch_buckets": [1, 4], "src_buckets": [128], "mel_buckets": [256, 1000],
                       "style": {"ref_buckets": [1000]}}
SERVE_FLEET_CLIENTS = 4
SERVE_FLEET_REQUESTS = 8       # a closed-loop client's /synthesize requests
SERVE_FLEET_STREAMS = 4        # then /synthesize/stream requests, one at a time
SERVE_FLEET_WARM_REQUESTS = 4  # replica 0's, while replica 1 warms
# the watchdog, low for the drill: a steady dispatch takes ~0.1 s and the
# injected hang sleeps 3 x this before its (discarded) dispatch
SERVE_FLEET_WATCHDOG_S = 1.5
# class budgets past the drill's hang, so a stolen request is retried on
# the other replica instead of resolving as 504
SERVE_FLEET_DEADLINES = {"interactive": 30000.0, "batch": 60000.0}


class EventLog:
    """In-memory event log with ``JsonlEventLog``'s ``emit``: the fleet
    phase reads the router's replica_state / replica_failure / engine_closed
    / rollout events back from it."""

    def __init__(self):
        import threading

        self._lock = threading.Lock()
        self.records = []

    def emit(self, event, **fields):
        with self._lock:
            self.records.append((event, dict(fields)))
        return fields

    def of(self, kind):
        with self._lock:
            return [f for k, f in self.records if k == kind]


def gate_wait_recorder():
    """Time every outermost shared entry of the port's DEVICE_GATE (one
    per dispatch, vocode window or style encode), by thread name: returns
    (the list of (thread name, seconds), a function that restores the
    gate)."""
    import threading

    from speakingstyle_torch.parallel.registry import DEVICE_GATE

    waits = []
    enter = DEVICE_GATE._enter_shared

    def timed():
        t0 = time.perf_counter()
        enter()
        waits.append((threading.current_thread().name, time.perf_counter() - t0))

    DEVICE_GATE._enter_shared = timed
    return waits, lambda: delattr(DEVICE_GATE, "_enter_shared")


def fleet_cli_check(tmp, step, seed, wav, dev):
    """``python -m speakingstyle_torch serve --replicas 2`` in a subprocess
    over the phase's checkpoint, on the one-point lattice of
    ``serve_cli_check``: it binds at once, /healthz answers 503 while the
    replicas warm and then 200 with both ready, one /synthesize and one
    chapter (``longform_check``) answer 200, and SIGTERM exits 0. Returns
    its record."""
    import queue
    import signal
    import threading

    import yaml

    out = os.path.join(tmp, "serve_fleet_cli")
    os.makedirs(out)
    os.symlink(os.path.join(tmp, "ckpt"), os.path.join(out, "ckpt"))
    cli_args = smoke_configs(out, SERVE_HTTP_MODEL)
    train_yaml = cli_args[cli_args.index("-t") + 1]
    with open(train_yaml) as f:
        train = yaml.safe_load(f)
    train["serve"] = SERVE_CLI_LATTICE
    with open(train_yaml, "w") as f:
        yaml.safe_dump(train, f)
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "speakingstyle_torch", "serve", *cli_args, "--restore_step",
         str(step), "--seed", str(seed), "--host", "127.0.0.1", "--port", "0",
         "--ref_audio", wav, "--device", dev.type, "--replicas", "2"],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    lines = queue.Queue()
    reader = threading.Thread(target=lambda: [lines.put(l) for l in proc.stdout], daemon=True)
    reader.start()
    log, address, healthz, code = [], None, [], None
    try:
        deadline = time.monotonic() + 300
        while address is None and time.monotonic() < deadline and proc.poll() is None:
            try:
                line = lines.get(timeout=1.0)
            except queue.Empty:
                continue
            log.append(line.rstrip())
            if line.startswith("serving on http://"):
                host, port = line.split("http://", 1)[1].split(" ", 1)[0].rsplit(":", 1)
                address = (host, int(port))
        if address is None:
            fail(f"serve_fleet: the serve command did not start serving: {log[-20:]}")
        bound_s = time.perf_counter() - t0
        ready = {}
        while time.monotonic() < deadline:
            status, _, body, _ = http_call(address, "GET", "/healthz")
            ready = json.loads(body).get("replicas", {})
            healthz.append((round(time.perf_counter() - t0, 3), status, ready))
            if status == 200 and set(ready.values()) == {"ready"}:
                break
            time.sleep(0.1)
        ready_s = time.perf_counter() - t0
        status, headers, body, secs = http_call(address, "POST", "/synthesize",
                                                {"text": TEXTS[0]})
        samples = len(body) - 44
        longform = longform_check(address)
        proc.send_signal(signal.SIGTERM)
        code = proc.wait(timeout=120)
        reader.join(timeout=30)
        while not lines.empty():
            log.append(lines.get().rstrip())
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
    statuses = [h[1] for h in healthz]
    record = {"exit_code": code, "bound_s": bound_s, "ready_s": ready_s,
              "healthz": healthz[:3] + healthz[-1:], "healthz_polls": len(healthz),
              "status": status, "wav_samples": samples // 2, "request_s": secs,
              "model_version": headers.get("X-Model-Version"), "longform": longform,
              "log_tail": log[-6:]}
    if not (code == 0 and statuses and statuses[0] == 503 and statuses[-1] == 200
            and longform["ok"]
            and healthz[-1][2] == {"0": "ready", "1": "ready"} and status == 200
            and body[:4] == b"RIFF" and samples > 0 and any("warming 2 replicas" in l for l in log)
            and any("SIGTERM" in l for l in log)):
        fail(f"serve_fleet: the serve --replicas 2 command {record}")
    return record


def serve_fleet_phase(tmp, step, seed, dev, smi):
    """The fleet router on one card: the LJSpeech preset at full width on
    the kernel path (bf16 compute, bf16 softmax), ``SERVE_FLEET_LATTICE``,
    from ``restored_phase``'s checkpoint, built through the serve command's
    fleet branch (``cli.serve.build_fleet``: the checkpoint loaded once, one
    shared StyleService, the rollout armed) behind ``SynthesisServer``.

    1. Warm-up: replica 0 warms alone (its ``memory_reserved``); then
       ``scale_to(2)``, and replica 0 serves requests one after another
       while replica 1 warms: the DEVICE_GATE waits of replica 0's
       dispatches in that window (each preparation holds the gate
       exclusively), then ``memory_reserved`` with two replicas.
    2. Steady traffic under torch.profiler, every kernel count set to 0
       just before and read just after: the 4 references uploaded, 4
       closed-loop clients x 8 /synthesize (the 4 texts x 4 styles), 4
       streams one at a time. Both replicas must dispatch, nothing may be
       prepared, and the port's kernels counted by name in the trace must
       equal the credits summed over both replicas.
    3. Chaos: ``replica_raise`` at the next dispatch under 8 concurrent
       requests, recovery; then ``replica_hang`` (the watchdog at
       ``SERVE_FLEET_WATCHDOG_S``) under 8 more, recovery. Every request
       ends 200, both breakers open and close again, each failed replica
       comes back READY, its old engine is closed, and ``memory_reserved``
       stays within one replica's graphs of the pre-drill reading.
    4. Rollout: POST /admin/rollout to a second step saved from the same
       weights, under two clients' load: it commits, every READY replica
       runs the new version and digest, no request fails;
       ``memory_reserved`` polled over the canary's surge.
    Every 200 is a RIFF wav of mel_len x hop samples passing the quality
    gate and within ``SERVE_HTTP_LSB`` of ``run(eager=True)`` of one engine
    on the same request; each stream within ``STREAM_LSB`` of its full wav
    outside the overlap tail. (``serve --replicas 2`` in a subprocess,
    ``fleet_cli_check``, runs at the end of ``serve_http_phase``.) Returns
    the kernels counted in the traffic's trace."""
    import http.client
    import threading

    import numpy as np
    import torch
    import yaml
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from speakingstyle_torch.cli import config_from_args
    from speakingstyle_torch.cli.serve import build_fleet, build_parser, model_version_string
    from speakingstyle_torch.faults import FaultPlan
    from speakingstyle_torch.obs.quality import validate_wav
    from speakingstyle_torch.serving.engine import load_engine_parts
    from speakingstyle_torch.serving.fleet import READY
    from speakingstyle_torch.serving.frontend import TextFrontend, load_ref_mel
    from speakingstyle_torch.serving.server import SynthesisServer
    from speakingstyle_torch.serving.streaming import resolve_overlap
    from speakingstyle_torch.training.checkpoint import CheckpointManager
    from speakingstyle_torch.training.optim import Optimizer
    from speakingstyle_torch.training.state import TrainState
    from speakingstyle_torch.training.trainer import trainable

    out = os.path.join(tmp, "serve_fleet")
    os.makedirs(out)
    os.symlink(os.path.join(tmp, "ckpt"), os.path.join(out, "ckpt"))
    cli_args = smoke_configs(out, SERVE_HTTP_MODEL)
    train_yaml = cli_args[cli_args.index("-t") + 1]
    with open(train_yaml) as f:
        train = yaml.safe_load(f)
    train["serve"] = dict(SERVE_FLEET_LATTICE, fleet={
        "hang_watchdog_s": SERVE_FLEET_WATCHDOG_S, "class_deadline_ms": SERVE_FLEET_DEADLINES})
    with open(train_yaml, "w") as f:
        yaml.safe_dump(train, f)
    args = build_parser().parse_args(cli_args + ["--restore_step", str(step), "--seed", str(seed),
                                                 "--enable_rollout"])
    cfg = config_from_args(args)
    sr = cfg.preprocess.preprocessing.audio.sampling_rate
    # the rollout's candidate: a second step of the same weights
    step2 = step + 1
    model, _, _, _ = load_engine_parts(cfg, step, griffin_lim=True, device=dev)
    CheckpointManager(os.path.join(tmp, "ckpt")).save(step2, TrainState(
        step=step2, model=model, optimizer=Optimizer(trainable(model), cfg.train)), block=True)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    reserved0 = torch.cuda.memory_reserved(dev)

    events, plan = EventLog(), FaultPlan()
    waits, restore_gate = gate_wait_recorder()
    server = None
    answers, lock = [], threading.Lock()  # (what, payload, status, headers, body)
    try:
        router, lifecycle, _ = build_fleet(cfg, args, 1, dev, fault_plan=plan, events=events)
        registry = router.registry
        t0 = time.perf_counter()
        if not router.wait_ready(timeout=300, n=1):
            fail(f"serve_fleet: replica 0 did not warm: {router.states()}")
        warm0_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        reserved1 = torch.cuda.memory_reserved(dev)
        wavs, _ = write_smoke_inputs(out, cfg, seed)
        frontend = TextFrontend(cfg, load_ref_mel(cfg, wavs[-1]))

        # 1. replica 1 warms while replica 0 serves
        at = len(waits)
        t0 = time.perf_counter()
        router.scale_to(SERVE_FLEET_REPLICAS)
        warm_lat, k = [], 0
        while router.states().get(1) != READY or k < SERVE_FLEET_WARM_REQUESTS:
            if time.perf_counter() - t0 > 300:
                fail(f"serve_fleet: replica 1 did not warm: {router.states()}")
            r0 = time.perf_counter()
            res = router.submit(frontend.request(f"warm{k}", {"text": TEXTS[k % 4]})).result(
                timeout=300)
            if router.states().get(1) != READY:
                warm_lat.append((res.replica, time.perf_counter() - r0))
            k += 1
        warm1_s = time.perf_counter() - t0
        rep0 = [w for name, w in waits[at:] if name.startswith("replica-0-dispatch")]
        served0 = sum(1 for r, _ in warm_lat if r == 0)
        torch.cuda.synchronize()
        reserved2 = torch.cuda.memory_reserved(dev)
        precompile_s = {i: registry.value("serve_replica_precompile_seconds", {"replica": str(i)})
                        for i in range(SERVE_FLEET_REPLICAS)}
        if served0 < SERVE_FLEET_WARM_REQUESTS and warm1_s > 5.0:
            fail(f"serve_fleet: replica 0 served {served0} requests during a {warm1_s:.1f} s "
                 "warm-up of replica 1")
        emit("serve_fleet_warmup", nvidia_smi=smi, entry="cli.serve.build_fleet",
             lattice=SERVE_FLEET_LATTICE, model=SERVE_HTTP_MODEL,
             replica0_warm_s=warm0_s, replica1_warm_s=warm1_s, precompile_s=precompile_s,
             replica0_requests_during_warmup=served0,
             replica0_latency_ms=quantiles_ms([s for r, s in warm_lat if r == 0])
             if served0 else None,
             replica0_gate_wait_ms=quantiles_ms(rep0) if rep0 else None,
             memory_reserved_bytes={"before": reserved0, "replicas_1": reserved1,
                                    "replicas_2": reserved2},
             memory_reserved_per_replica_bytes=reserved2 - reserved1)

        server = SynthesisServer(frontend=frontend, host="127.0.0.1", port=0, events=events,
                                 router=router, lifecycle=lifecycle)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        address = server.address[:2]

        def payload(i):
            return {"text": TEXTS[i % len(TEXTS)], "style_id": style_ids[(i // 4) % 4]}

        def clients(what, n_clients, per_client, stop=None):
            """Closed-loop clients on kept-alive connections; returns their
            latencies. With ``stop`` (an Event) each runs until it is set."""
            lat = []

            def client(c):
                conn = http.client.HTTPConnection(*address, timeout=300)
                try:
                    i = 0
                    while (i < per_client) if stop is None else not stop.is_set():
                        p = payload(c + n_clients * i)
                        status, headers, body, secs = http_call(address, "POST", "/synthesize",
                                                                p, conn=conn)
                        with lock:
                            answers.append((what, p, status, headers, body))
                            lat.append(secs)
                        i += 1
                finally:
                    conn.close()

            threads = [threading.Thread(target=client, args=(c,)) for c in range(n_clients)]
            for t in threads:
                t.start()
            return threads, lat

        def join(threads):
            for t in threads:
                t.join(timeout=600)

        # 2. steady traffic under the profiler
        style_ids = []
        prof, profiling = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]), False
        dispatched0 = [registry.value("serve_replica_dispatches_total", {"replica": str(i)})
                       for i in range(SERVE_FLEET_REPLICAS)]
        compiles = (registry.value("serve_compiles_total"),
                    registry.value("serve_style_compiles_total"))
        reset_counts()
        prof.start()
        profiling = True
        prime_trace()
        try:
            for w in wavs:
                with open(w, "rb") as f:
                    status, _, body, _ = http_call(address, "POST", "/styles", f.read(),
                                                   {"Content-Type": "audio/wav"})
                if status != 200:
                    fail(f"serve_fleet: POST /styles answered {status}: {body[:300]!r}")
                style_ids.append(json.loads(body)["style_id"])
            t0 = time.perf_counter()
            threads, latencies = clients("steady", SERVE_FLEET_CLIENTS, SERVE_FLEET_REQUESTS)
            join(threads)
            steady_s = time.perf_counter() - t0
            streams, ttfas = [], []
            for i in range(SERVE_FLEET_STREAMS):
                p = payload(i)
                status, headers, body, ttfa, _ = stream_call(address, p)
                streams.append((p, status, headers, body))
                if ttfa is not None:
                    ttfas.append(ttfa)
            torch.cuda.synchronize()
        finally:
            prof.stop()
            profiling = False
        credited = read_counts()
        kernels = [e for e in prof.events()
                   if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
        window_ms, busy_ms, by_name, ours = device_time("serve_fleet traffic", kernels)
        launches = check_trace("serve_fleet traffic", by_name, credited)
        dispatched = [registry.value("serve_replica_dispatches_total", {"replica": str(i)}) - d
                      for i, d in enumerate(dispatched0)]
        after = (registry.value("serve_compiles_total"),
                 registry.value("serve_style_compiles_total"))
        if after != compiles:
            fail(f"serve_fleet: the traffic prepared programs: {compiles} -> {after}")
        if min(dispatched) <= 0:
            fail(f"serve_fleet: a replica took no dispatch of the traffic: {dispatched}")
        for name in ("fused_attention_fwd_bf16sm", "fused_conv1d_fwd"):
            if launches[name] <= 0:
                fail(f"serve_fleet: {name} ran no time in the traffic's trace: {launches}")
        emit("serve_fleet", nvidia_smi=smi, under_profiler=True,
             requests={"closed_loop": SERVE_FLEET_CLIENTS * SERVE_FLEET_REQUESTS,
                       "clients": SERVE_FLEET_CLIENTS, "streams": SERVE_FLEET_STREAMS},
             latency_ms=quantiles_ms(latencies), ttfa_ms=quantiles_ms(ttfas),
             steady_s=steady_s, replica_dispatches=dispatched,
             replica_requests={i: registry.value("serve_replica_requests_total",
                                                 {"replica": str(i)})
                               for i in range(SERVE_FLEET_REPLICAS)},
             server_queue_wait_s=hist_view(registry, "serve_queue_wait_seconds"),
             compiles={"before": compiles, "after": after},
             traffic_trace={"trace_window_ms": window_ms, "device_busy_ms": busy_ms,
                            "idle_share": 1.0 - busy_ms / window_ms, "port_kernel_ms": ours,
                            "kernels_in_trace": launches, "credited": credited})

        # 3. chaos: a raise, then a hang past the watchdog
        gc.collect()
        torch.cuda.synchronize()
        reserved_pre = torch.cuda.memory_reserved(dev)
        drill = {}
        for kind in ("replica_raise", "replica_hang"):
            t0 = time.perf_counter()
            fails0 = len(events.of("replica_failure"))
            plan.arm(kind, router.dispatch_total + 1)
            threads, lat = clients(kind, SERVE_FLEET_CLIENTS, 2)
            join(threads)
            deadline = time.monotonic() + 300
            while time.monotonic() < deadline and not (
                    sorted(router.states().values()).count(READY) == SERVE_FLEET_REPLICAS
                    and all(registry.value("serve_replica_breaker_state", {"replica": str(i)})
                            == 0 for i, s in router.states().items() if s == READY)):
                # the breaker closes on the re-warmed replica's first good dispatch
                if sorted(router.states().values()).count(READY) == SERVE_FLEET_REPLICAS:
                    threads, more = clients(kind + "_recovery", 2, 1)
                    join(threads)
                else:
                    time.sleep(0.05)
            failures = events.of("replica_failure")[fails0:]
            drill[kind] = {"seconds": time.perf_counter() - t0, "latency_ms": quantiles_ms(lat),
                           "failures": [{k: f[k] for k in ("replica", "kind", "requeued",
                                                           "failed", "backoff_s")}
                                        for f in failures],
                           "states": router.states()}
            if len(failures) != 1 or failures[0]["failed"] or \
                    failures[0]["kind"] != kind.split("_")[1]:
                fail(f"serve_fleet: the {kind} drill's failures: {failures}")
        states = router.states()
        ready_now = [i for i, s in states.items() if s == READY]
        if len(ready_now) != SERVE_FLEET_REPLICAS:
            fail(f"serve_fleet: the fleet did not recover: {states}")
        breakers = {i: registry.value("serve_replica_breaker_state", {"replica": str(i)})
                    for i in ready_now}
        opened = [f for f in events.of("replica_state") if f["state"] == "failed"]
        closed_engines = len(events.of("engine_closed"))
        gc.collect()
        torch.cuda.synchronize()
        reserved_post = torch.cuda.memory_reserved(dev)
        per_replica = reserved2 - reserved1
        emit("serve_fleet_chaos", drills=drill, breakers=breakers, failed_states=len(opened),
             engines_closed=closed_engines, watchdog_s=SERVE_FLEET_WATCHDOG_S,
             deferred_warmups=len(events.of("replica_warm_deferred")),
             requeued=registry.value("serve_requeued_total"),
             memory_reserved_bytes={"before_drill": reserved_pre, "after_drill": reserved_post,
                                    "one_replica": per_replica})
        if any(breakers.values()) or len(opened) < 2 or closed_engines < 2:
            fail(f"serve_fleet: breakers {breakers}, failed states {len(opened)}, engines "
                 f"closed {closed_engines}")
        if reserved_post > reserved_pre + per_replica:
            fail(f"serve_fleet: memory_reserved {reserved_post} after the drill, "
                 f"{reserved_pre} before, one replica's graphs {per_replica}")

        # 4. the rollout under load, memory polled over the surge
        old = {id(router.engine_at(i)) for i in ready_now}
        stop, peak = threading.Event(), [0]

        def poll():
            while not stop.is_set():
                peak[0] = max(peak[0], torch.cuda.memory_reserved(dev))
                stop.wait(0.02)

        poller = threading.Thread(target=poll)
        poller.start()
        load, load_lat = clients("rollout", 2, 0, stop=stop)
        t0 = time.perf_counter()
        try:
            status, _, body, _ = http_call(address, "POST", "/admin/rollout", {"step": step2},
                                           timeout=600)
        finally:
            stop.set()
            join(load + [poller])
        rollout_s = time.perf_counter() - t0
        outcome = json.loads(body)
        info2 = {"step": step2, "weights_digest": outcome.get("weights_digest")}
        states = router.states()
        ready_after = [i for i, s in states.items() if s == READY]
        versions = {i: router._replicas[i].version for i in ready_after}
        status_h, _, body_h, _ = http_call(address, "GET", "/healthz")
        model = json.loads(body_h).get("model", {})
        emit("serve_fleet_rollout", status=status, outcome=outcome, seconds=rollout_s,
             states=states, versions=versions, healthz_model=model,
             load_requests=len(load_lat), load_latency_ms=quantiles_ms(load_lat)
             if load_lat else None,
             memory_reserved_bytes={"surge_peak": peak[0],
                                    "after": torch.cuda.memory_reserved(dev)})
        want_version = model_version_string(info2)
        if not (status == 200 and outcome.get("status") == "committed"
                and len(ready_after) == SERVE_FLEET_REPLICAS
                and set(versions.values()) == {want_version}
                and not old & {id(router.engine_at(i)) for i in ready_after}
                and model.get("version") == want_version and model.get("step") == step2
                and model.get("weights_digest") == outcome.get("weights_digest")):
            fail(f"serve_fleet: the rollout {outcome}, states {states}, versions {versions}, "
                 f"healthz {model}")

        # every answer against run(eager=True) of one live engine
        engine = router.engine_at(ready_after[0])
        hop = engine.vocoder.hop_factor
        refs = {}

        def reference(p):
            key = (p["text"], p["style_id"])
            if key not in refs:
                refs[key] = engine.run([frontend.request("eager", p)], eager=True)[0]
            return refs[key]

        bad, worst, checked = [], 0, 0
        for what, p, status, headers, body in answers:
            if status != 200:
                bad.append({"what": what, "status": status,
                            "body": body[:200].decode(errors="replace")})
                continue
            wav = pcm_of(f"serve_fleet {what}", body, sr)
            ref = reference(p)
            verdict = validate_wav(wav, sr, cfg.serve.quality)
            if len(wav) != ref.mel_len * hop or not verdict.ok:
                bad.append({"what": what, "samples": len(wav), "want": ref.mel_len * hop,
                            "quality": verdict.as_dict()})
                continue
            lsb = int(np.abs(wav.astype(np.int32) - ref.wav.astype(np.int32)).max(initial=0))
            worst, checked = max(worst, lsb), checked + 1
            if lsb > SERVE_HTTP_LSB:
                bad.append({"what": what, "text": p["text"][:20], "max_lsb": lsb})
        overlap = resolve_overlap(cfg.serve.fleet.stream_overlap, engine.vocoder)
        stream_rows = []
        for p, status, headers, body in streams:
            ref = reference(p)
            wav = pcm_of("serve_fleet stream", body, sr) if status == 200 \
                else np.zeros(0, np.int16)
            keep_n = max(0, ref.mel_len - overlap) * hop
            lsb = int(np.abs(wav[:keep_n].astype(np.int32)
                             - ref.wav[:keep_n].astype(np.int32)).max(initial=0)) \
                if len(wav) == len(ref.wav) else None
            stream_rows.append({"status": status, "samples": int(len(wav)), "max_lsb": lsb})
            if status != 200 or lsb is None or lsb > STREAM_LSB or keep_n <= 0:
                bad.append({"stream": stream_rows[-1], "want_samples": len(ref.wav)})
        emit("serve_fleet_answers", checked_wavs=checked, wav_vs_eager_lsb={
            "max": worst, "bound": SERVE_HTTP_LSB}, streams=stream_rows,
            stream_lsb_bound=STREAM_LSB, by_phase={w: sum(1 for a in answers if a[0] == w)
                                                   for w in sorted({a[0] for a in answers})})
        if bad:
            fail(f"serve_fleet: answers that fail their checks: {bad[:8]}")
    finally:
        restore_gate()
        if server is not None:
            server.shutdown()
    del server, router, engine, refs, lifecycle
    gc.collect()
    torch.cuda.empty_cache()
    return launches


SERVE_TIERS_NAMES = ("teacher-f32", "teacher-bf16", "teacher-int8")
SERVE_TIERS_CLASS_TIER = {"interactive": "teacher-bf16", "batch": "teacher-int8"}
# the gate's bound: a narrower tier's worst golden-set mel_l2 against
# teacher-f32 (random weights at full width), between what the sound
# tiers read, 0.0 (bf16: the f32 tier computes in bf16 too) and 0.1418
# (int8), and what the control below reads, 0.2232 (both the same on
# every H100 run); the poisoned tier reads 3.1e9
SERVE_TIERS_TOLERANCE = 0.18
# the gate's control, a wrong int8 path: each output channel's int8 scale
# off by a seeded factor in [1 - spread, 1 + spread]
SERVE_TIERS_CONTROL_SPREAD = 0.05
# the prober's mel drift bound (healthy drift is 0: the same programs on
# the same inputs)
SERVE_TIERS_PROBE_TOLERANCE = 1.0
# the open-loop traffic: the traffic model's schedule over 10 s (a diurnal
# cycle and a 3x flash crowd from 6 to 8 s), styles over the 4 uploads
SERVE_TIERS_TRAFFIC = {"base_qps": 6.0, "duration_s": 10.0, "flash_windows": [(6.0, 8.0)],
                       "flash_multiplier": 3.0, "n_styles": 4}
SERVE_TIERS_LONGFORM = {"crossfade_frames": 8, "group_depth": 4, "max_chunks": 32}
SERVE_TIERS_MIN_CHUNKS = 8
SERVE_TIERS_LF_CLIENTS = 2   # closed-loop interactive clients beside the chapter
SERVE_TIERS_LF_REQUESTS = 6  # each one's requests without the chapter


@contextlib.contextmanager
def perturbed_int8_scales(engine, spread, seed):
    """The int8 tier of ``engine`` with every per-channel scale multiplied
    in place by a seeded factor in [1 - spread, 1 + spread] (its captured
    graphs read the perturbed scales); restored bit for bit on exit."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    scales = [v["int8_scale"] for v in engine._params_by_precision["int8"].values()
              if isinstance(v, dict)]
    saved = [t.clone() for t in scales]
    with torch.no_grad():
        for t in scales:
            f = 1.0 + spread * (2.0 * torch.rand(t.shape, generator=gen) - 1.0)
            t.mul_(f.to(t.device, t.dtype))
    try:
        yield len(scales)
    finally:
        with torch.no_grad():
            for t, s in zip(scales, saved):
                t.copy_(s)


def serve_tiers_phase(tmp, step, seed, dev, smi):
    """The rest of the fleet on one card: quality tiers, golden probes and
    the chunked long-form tier, on ``serve_fleet``'s checkpoint, kernel
    path and lattice (``SERVE_FLEET_LATTICE``). ``teacher-f32`` /
    ``teacher-bf16`` / ``teacher-int8`` are three one-replica fleets
    (``serving.tiers.tier_fleets``: an engine each over the weights loaded
    once and one StyleService) behind one ``TierRouter`` (interactive ->
    bf16, batch -> int8) behind ``SynthesisServer``; ``memory_reserved``
    with the three up. Then, under torch.profiler with every kernel count
    set to 0 just before and read just after (the port's kernels counted
    by name in the trace must equal the credits):

    1. the gates: ``tier_gate`` of bf16 and int8 against teacher-f32 on
       the card while the anchor serves 2 closed-loop clients, each must
       ship (``mel_l2``, ms); the control (int8 with its scales perturbed,
       ``SERVE_TIERS_CONTROL_SPREAD``) must be refused, and int8 gated
       again on its restored scales must read as before;
    2. open-loop traffic from a ``TrafficModel`` schedule (10 s), its
       long_form events chapters on /synthesize/longform: every answer a
       200 (a valid wav; a chapter's tier and chunk headers) or a 429 with
       Retry-After, ``X-Model-Tier`` its class's tier,
       ``serve_tier_dispatch_total`` equal to the routed submits (a chunk
       each), nothing prepared; client p50 / p90 / max per class;
    3. the prober: anchors pinned, one round reads zero mel and style drift
       on every tier;
    4. a chapter of at least ``SERVE_TIERS_MIN_CHUNKS`` chunks on
       /synthesize/longform while 2 closed-loop interactive clients run:
       the tier and chunk headers, the stitcher's sample arithmetic, each
       chunk outside the crossfades within ``SERVE_HTTP_LSB`` of the chunk
       run alone (``run(eager=True)``), seam RMS, TTFA, and the clients'
       p50 beside their p50 without the chapter;
    5. ``tier_poison`` on the int8 fleet: the prober pages on teacher-int8
       alone, the poisoned tier's gate refuses it, and ``batch`` falls back
       to teacher-f32 (``X-Model-Tier``). Returns the trace's kernels."""
    import http.client
    import threading
    import traceback
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch
    import yaml
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from speakingstyle_torch.cli import config_from_args
    from speakingstyle_torch.cli.serve import build_parser
    from speakingstyle_torch.faults import FaultPlan
    from speakingstyle_torch.obs import MetricsRegistry
    from speakingstyle_torch.obs.quality import validate_wav
    from speakingstyle_torch.serving.engine import load_engine_parts
    from speakingstyle_torch.serving.frontend import TextFrontend, load_ref_mel
    from speakingstyle_torch.serving.longform import LongformService, plan_chunks
    from speakingstyle_torch.serving.probes import GoldenProber
    from speakingstyle_torch.serving.server import SynthesisServer
    from speakingstyle_torch.serving.tiers import TierRouter, tier_fleets, tier_gate
    from speakingstyle_torch.serving.traffic import TrafficModel

    out = os.path.join(tmp, "serve_tiers")
    os.makedirs(out)
    os.symlink(os.path.join(tmp, "ckpt"), os.path.join(out, "ckpt"))
    cli_args = smoke_configs(out, SERVE_HTTP_MODEL)
    train_yaml = cli_args[cli_args.index("-t") + 1]
    with open(train_yaml) as f:
        train = yaml.safe_load(f)
    train["serve"] = dict(
        SERVE_FLEET_LATTICE, fleet={"class_deadline_ms": SERVE_FLEET_DEADLINES},
        tiers={"enabled": True, "precisions": ["f32", "bf16", "int8"],
               "class_tier": SERVE_TIERS_CLASS_TIER, "tier_tolerance": SERVE_TIERS_TOLERANCE},
        quality={"probe_mel_tolerance": SERVE_TIERS_PROBE_TOLERANCE,
                 "anchor_dir": os.path.join(out, "anchors")},
        longform=SERVE_TIERS_LONGFORM)
    with open(train_yaml, "w") as f:
        yaml.safe_dump(train, f)
    args = build_parser().parse_args(cli_args + ["--restore_step", str(step), "--seed",
                                                 str(seed)])
    cfg = config_from_args(args)
    sr = cfg.preprocess.preprocessing.audio.sampling_rate
    gc.collect()
    torch.cuda.empty_cache()
    reserved0 = torch.cuda.memory_reserved(dev)
    events, registry = EventLog(), MetricsRegistry()
    plans = {name: FaultPlan() for name in SERVE_TIERS_NAMES}
    server = prober = None
    prof, profiling = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]), False
    try:
        model, vocoder, _, _ = load_engine_parts(cfg, step, device=dev, vocoder_seed=seed + 1)
        t0 = time.perf_counter()
        fleets = tier_fleets(cfg, model, vocoder, SERVE_TIERS_NAMES, device=dev,
                             registry=registry, fault_plans=plans, events=events)
        for name, fleet in fleets.items():
            if not fleet.wait_ready(timeout=300):
                errors = [r.error for r in fleet._replicas if r.error is not None]
                fail(f"serve_tiers: the {name} fleet did not warm: {fleet.states()}, "
                     f"{events.of('replica_warm_failed')}: "
                     + ("".join(traceback.format_exception(errors[0])) if errors else ""))
        warm_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        reserved3 = torch.cuda.memory_reserved(dev)
        engines = {name: fleet.engines()[0] for name, fleet in fleets.items()}
        emit("serve_tiers_warmup", nvidia_smi=smi, tiers=list(SERVE_TIERS_NAMES),
             lattice=SERVE_FLEET_LATTICE, model=SERVE_HTTP_MODEL, warm_s=warm_s,
             programs={n: e.compile_count for n, e in engines.items()},
             memory_reserved_bytes={"before": reserved0, "tiers_3": reserved3},
             memory_reserved_tiers_bytes=reserved3 - reserved0)

        router = TierRouter(cfg, registry=registry)
        router.add_tier("teacher-f32", fleets["teacher-f32"])
        wavs, _ = write_smoke_inputs(out, cfg, seed)
        frontend = TextFrontend(cfg, load_ref_mel(cfg, wavs[-1]))
        prober = GoldenProber(router, cfg, style=fleets["teacher-f32"].style, registry=registry,
                              events=events, start=False)
        server = SynthesisServer(frontend=frontend, host="127.0.0.1", port=0, events=events,
                                 router=router, probes=prober)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        address = server.address[:2]
        compiles = (registry.value("serve_compiles_total"),
                    registry.value("serve_style_compiles_total"))
        reset_counts()
        prof.start()
        profiling = True
        prime_trace()

        style_ids = []
        for w in wavs:
            with open(w, "rb") as f:
                status, _, body, _ = http_call(address, "POST", "/styles", f.read(),
                                               {"Content-Type": "audio/wav"})
            if status != 200:
                fail(f"serve_tiers: POST /styles answered {status}: {body[:300]!r}")
            style_ids.append(json.loads(body)["style_id"])

        def closed_loop(n, want_tier, stop=None):
            """SERVE_TIERS_LF_CLIENTS interactive clients on kept-alive
            connections, ``n`` requests each or until ``stop``; returns their
            threads and latencies (a tuple for an answer that is not a 200
            from ``want_tier``)."""
            lat = []

            def client(c):
                conn = http.client.HTTPConnection(*address, timeout=300)
                try:
                    i = 0
                    while (i < n) if stop is None else not stop.is_set():
                        p = {"text": TEXTS[(c + i) % len(TEXTS)], "style_id": style_ids[c]}
                        status, headers, _, secs = http_call(address, "POST", "/synthesize", p,
                                                             conn=conn)
                        ok = status == 200 and headers.get("X-Model-Tier") == want_tier
                        with lock:
                            lat.append(secs if ok else (status, headers.get("X-Model-Tier")))
                        i += 1
                finally:
                    conn.close()

            threads = [threading.Thread(target=client, args=(c,))
                       for c in range(SERVE_TIERS_LF_CLIENTS)]
            for t in threads:
                t.start()
            return threads, lat

        def join(threads):
            for t in threads:
                t.join(timeout=300)

        # 1. the gates, on the card while the anchor tier serves 2 clients
        lock = threading.Lock()
        stop = threading.Event()
        threads, during_gates = closed_loop(0, "teacher-f32", stop=stop)
        gates = {}
        try:
            for name in SERVE_TIERS_NAMES[1:]:
                gates[name] = tier_gate(engines[name], engines["teacher-f32"], cfg, name)
            # the int8 tier is not routed yet: nothing else reads its scales
            with perturbed_int8_scales(engines["teacher-int8"], SERVE_TIERS_CONTROL_SPREAD,
                                       seed) as n_scales:
                control = tier_gate(engines["teacher-int8"], engines["teacher-f32"], cfg,
                                    "teacher-int8")
            restored = tier_gate(engines["teacher-int8"], engines["teacher-f32"], cfg,
                                 "teacher-int8")
        finally:
            stop.set()
            join(threads)
        for name, g in gates.items():
            router.add_tier(name, fleets[name], gate=g)
        emit("serve_tiers_gates", nvidia_smi=smi, tolerance=SERVE_TIERS_TOLERANCE,
             gates={n: g.as_dict() for n, g in gates.items()},
             control={"spread": SERVE_TIERS_CONTROL_SPREAD, "scales": n_scales,
                      **control.as_dict()},
             int8_restored_mel_l2=restored.mel_l2, routing=router.routing_table(),
             requests_during_gates=len(during_gates))
        if not all(g.shipped for g in gates.values()) or not during_gates or any(
                not isinstance(x, float) for x in during_gates) or control.shipped \
                or restored.mel_l2 != gates["teacher-int8"].mel_l2:
            fail(f"serve_tiers: the gates { {n: g.as_dict() for n, g in gates.items()} }, "
                 f"the control {control.as_dict()}, int8 restored {restored.mel_l2}, "
                 f"the anchor's answers meanwhile {during_gates[:8]}")

        # 2. open-loop mixed traffic; a long_form event is a chapter of
        # length_frac x chunk_phoneme_cap phonemes or more, planned here
        # (off the clock) and sent to /synthesize/longform
        schedule = TrafficModel(seed=seed, **SERVE_TIERS_TRAFFIC).schedule()
        cap = server.longform.chunk_phoneme_cap
        chapters = {}
        for i, e in enumerate(schedule):
            if e.kind == "long_form":
                sentences = []
                while sum(len(c.sequence) for c in plan_chunks(
                        " ".join(sentences), frontend.sequence, cap)) < e.length_frac * cap:
                    sentences.append(TEXTS[(i + len(sentences)) % len(TEXTS)])
                text = " ".join(sentences)
                chapters[i] = (text, len(plan_chunks(text, frontend.sequence, cap)))
        routed0 = {n: registry.value("serve_tier_dispatch_total", {"tier": n})
                   for n in SERVE_TIERS_NAMES}
        answers = []

        def send(i, e):
            if i in chapters:
                p = {"text": chapters[i][0], "style_id": style_ids[e.style]}
                status, headers, body, ttfa, secs = stream_call(
                    address, p, timeout=120, path="/synthesize/longform")
            else:
                text = TEXTS[min(len(TEXTS) - 1, int(e.length_frac * len(TEXTS)))]
                p = {"text": text, "style_id": style_ids[e.style], "priority": e.priority}
                status, headers, body, secs = http_call(address, "POST", "/synthesize", p,
                                                        timeout=120)
            with lock:
                answers.append((i, e, status, headers, body, secs))

        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=64) as pool:
            for i, e in enumerate(schedule):
                wait = t0 + e.t - time.perf_counter()
                if wait > 0:
                    time.sleep(wait)
                pool.submit(send, i, e)
        traffic_s = time.perf_counter() - t0
        routed = {n: registry.value("serve_tier_dispatch_total", {"tier": n}) - routed0[n]
                  for n in SERVE_TIERS_NAMES}
        after = (registry.value("serve_compiles_total"),
                 registry.value("serve_style_compiles_total"))
        # routed submits: one a /synthesize answer, a chunk an answered
        # chapter; a shed chapter may have routed up to all its chunks
        bad, by_class, n_routed, n_shed_chunks = [], {}, 0, 0
        for i, e, status, headers, body, secs in answers:
            klass = "long_form" if i in chapters else e.priority
            want = router.tier_for(server.longform.klass if i in chapters else e.priority)
            row = by_class.setdefault(klass, {"ok": [], "shed": 0})
            if status == 200:
                wav = pcm_of("serve_tiers traffic", body, sr)
                verdict = validate_wav(wav, sr, cfg.serve.quality)
                n = chapters[i][1] if i in chapters else 1
                if headers.get("X-Model-Tier") != want or not len(wav) or not verdict.ok or (
                        i in chapters and (headers.get("X-Longform-Tier") != "chunked" or int(
                            headers.get("X-Longform-Chunks", -1)) != n)):
                    bad.append({"class": klass, "tier": headers.get("X-Model-Tier"),
                                "want": want, "samples": len(wav), "chunks": n,
                                "headers": {k: v for k, v in headers.items()
                                            if k.startswith("X-")},
                                "quality": verdict.as_dict()})
                row["ok"].append(secs)
                n_routed += n
            elif status == 429 and headers.get("Retry-After"):
                row["shed"] += 1
                if i in chapters:
                    n_shed_chunks += chapters[i][1]
                else:
                    n_routed += 1
            else:
                bad.append({"class": klass, "status": status,
                            "body": body[:200].decode(errors="replace")})
        emit("serve_tiers_traffic", nvidia_smi=smi, schedule=dict(
            SERVE_TIERS_TRAFFIC, seed=seed, events=len(schedule),
            kinds={k: sum(e.kind == k for e in schedule) for k in ("interactive", "batch",
                                                                   "long_form")},
            chapter_chunks=[n for _, n in chapters.values()]),
             traffic_s=traffic_s, latency_ms={k: quantiles_ms(v["ok"]) if v["ok"] else None
                                              for k, v in by_class.items()},
             shed={k: v["shed"] for k, v in by_class.items()}, routed=routed,
             compiles={"before": compiles, "after": after})
        if len(answers) != len(schedule) or bad:
            fail(f"serve_tiers: {len(answers)} answers of {len(schedule)}; bad {bad[:8]}")
        if not n_routed <= sum(routed.values()) <= n_routed + n_shed_chunks \
                or after != compiles:
            fail(f"serve_tiers: routed {routed} for {n_routed} routed submits (+ up to "
                 f"{n_shed_chunks} of shed chapters); compiles {compiles} -> {after}")

        # 3. the prober on the unchanged weights
        t0 = time.perf_counter()
        prober.pin()
        pin_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        healthy = prober.probe_once()
        probe_s = time.perf_counter() - t0
        emit("serve_tiers_probes", nvidia_smi=smi, pin_s=pin_s, probe_s=probe_s,
             round=healthy, alerting=prober.alerting())
        if any(t["mel_drift"] != 0.0 for t in healthy["tiers"].values()) \
                or healthy["style_drift"] != 0.0 or set(healthy["tiers"]) != \
                set(SERVE_TIERS_NAMES) or any(prober.alerting().values()):
            fail(f"serve_tiers: the prober read drift on unchanged weights: {healthy}")

        # 4. a chapter beside two interactive clients
        fe_seq = frontend.sequence
        sentences = []
        while len(plan_chunks(" ".join(sentences), fe_seq, cap)) < SERVE_TIERS_MIN_CHUNKS:
            sentences.append(TEXTS[len(sentences) % len(TEXTS)])
        chapter = {"text": " ".join(sentences)}

        threads, alone = closed_loop(SERVE_TIERS_LF_REQUESTS, "teacher-bf16")
        join(threads)
        stop = threading.Event()
        threads, beside = closed_loop(0, "teacher-bf16", stop=stop)
        try:
            status, headers, body, ttfa, lf_s = stream_call(address, chapter,
                                                            path="/synthesize/longform")
        finally:
            stop.set()
            join(threads)
        if status != 200:
            fail(f"serve_tiers: /synthesize/longform answered {status}: {body[:300]!r}")
        wav = pcm_of("serve_tiers longform", body, sr)
        # each chunk alone on its tier's engine, from the same plan
        svc = LongformService(cfg, frontend, None, registry=MetricsRegistry())
        plan = svc.admit("alone", chapter)
        lf_tier = router.tier_for(server.longform.klass)
        engine = engines[lf_tier]
        hop = engine.vocoder.hop_factor
        fade = cfg.serve.longform.crossfade_frames * cfg.preprocess.preprocessing.stft.hop_length
        pieces = [engine.run([svc._chunk_request(plan, c)], eager=True)[0].wav
                  for c in plan.chunks]
        n = len(pieces)
        want_samples = sum(len(p) for p in pieces) - (n - 1) * fade
        worst, at, chunk_lsb = 0, 0, []
        for i, p in enumerate(pieces):
            lo = fade if i else 0
            hi = len(p) - (fade if i < n - 1 else 0)
            got = wav[at + lo: at + hi] if len(wav) == want_samples else np.zeros(0, np.int16)
            lsb = int(np.abs(got.astype(np.int32) - p[lo:hi].astype(np.int32)).max(initial=0)) \
                if len(got) == hi - lo else None
            chunk_lsb.append(lsb)
            at += len(p) - fade
        done = events.of("longform_done")
        bad_lat = [x for x in alone + beside if not isinstance(x, float)]
        emit("serve_tiers_longform", nvidia_smi=smi, chunks=int(headers.get(
            "X-Longform-Chunks", -1)), plan_chunks=n, tier=headers.get("X-Longform-Tier"),
             model_tier=headers.get("X-Model-Tier"), samples=len(wav),
             want_samples=want_samples, fade_samples=fade, chunk_samples=[len(p) for p in pieces],
             chunk_vs_alone_lsb=chunk_lsb, lsb_bound=SERVE_HTTP_LSB, ttfa_ms=ttfa * 1e3,
             chapter_s=lf_s, seam_rms=hist_view(registry, "serve_longform_seam_rms"),
             seam_rms_max=done[-1]["seam_rms_max"] if done else None,
             interactive_latency_ms={
                 "alone": quantiles_ms([x for x in alone if isinstance(x, float)]),
                 "beside_the_chapter": quantiles_ms([x for x in beside if isinstance(x, float)])
                 if any(isinstance(x, float) for x in beside) else None})
        if not (headers.get("X-Longform-Tier") == "chunked"
                and int(headers.get("X-Longform-Chunks", -1)) == n >= SERVE_TIERS_MIN_CHUNKS
                and headers.get("X-Model-Tier") == lf_tier and len(wav) == want_samples
                and all(len(p) > 2 * fade for p in pieces)
                and all(lsb is not None and lsb <= SERVE_HTTP_LSB for lsb in chunk_lsb)
                and not bad_lat and done and done[-1]["seams"] == n - 1):
            fail(f"serve_tiers: the chapter: headers {headers}, samples {len(wav)} (want "
                 f"{want_samples}), chunk LSB {chunk_lsb}, clients {bad_lat[:4]}")

        # 5. tier_poison on the int8 fleet: the prober pages on it alone,
        # its gate refuses it, and its class falls back to teacher-f32
        poisoned = "teacher-int8"
        alerts0 = len(events.of("probe_drift_alert"))
        fail0 = registry.value("serve_quality_class_fail_total", {"class": "probe"})
        plans[poisoned].arm("tier_poison", fleets[poisoned].dispatch_total + 1)
        status, headers, _, _ = http_call(address, "POST", "/synthesize",
                                          {"text": TEXTS[1], "priority": "batch"})
        drill = prober.probe_once()
        paged = [f["tier"] for f in events.of("probe_drift_alert")[alerts0:]]
        gate = tier_gate(engines[poisoned], engines["teacher-f32"], cfg, poisoned)
        router.add_tier(poisoned, fleets[poisoned], gate=gate)
        fb_status, fb_headers, fb_body, _ = http_call(address, "POST", "/synthesize",
                                                      {"text": TEXTS[1], "priority": "batch"})
        _, _, health_body, _ = http_call(address, "GET", "/healthz")
        health = json.loads(health_body)
        torch.cuda.synchronize()
    finally:
        if profiling:
            prof.stop()
    try:
        credited = read_counts()
        kernels = [e for e in prof.events()
                   if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
        window_ms, busy_ms, by_name, ours = device_time("serve_tiers", kernels)
        launches = check_trace("serve_tiers", by_name, credited)
        final = (registry.value("serve_compiles_total"),
                 registry.value("serve_style_compiles_total"))
        emit("serve_tiers_poison", nvidia_smi=smi, poisoned=poisoned,
             poisoning_status=status, poisoning_quality=headers.get("X-Audio-Quality"),
             round=drill, paged=paged, alerting=prober.alerting(),
             quality_fail_delta=registry.value("serve_quality_class_fail_total",
                                               {"class": "probe"}) - fail0,
             gate=gate.as_dict(), routing=router.routing_table(),
             fallback={"status": fb_status, "tier": fb_headers.get("X-Model-Tier")},
             healthz_tiers=health.get("tiers"), healthz_probes=health.get("quality", {}).get(
                 "probes"))
        if not (status in (200, 500) and paged == [poisoned] and registry.value(
                "serve_quality_class_fail_total", {"class": "probe"}) > fail0
                and prober.alerting() == {poisoned: True} and not gate.shipped
                and router.routing_table()["batch"] == "teacher-f32" and fb_status == 200
                and fb_headers.get("X-Model-Tier") == "teacher-f32"
                and health.get("tiers", {}).get("gates", {}).get(poisoned, {}).get("shipped")
                is False and "probes" in health.get("quality", {})):
            fail(f"serve_tiers: the tier_poison drill: paged {paged}, alerting "
                 f"{prober.alerting()}, gate {gate.as_dict()}, fallback {fb_status} "
                 f"{fb_headers.get('X-Model-Tier')}")
        emit("serve_tiers", nvidia_smi=smi, under_profiler=True,
             compiles={"before": compiles, "after": final},
             trace={"trace_window_ms": window_ms, "device_busy_ms": busy_ms,
                    "idle_share": 1.0 - busy_ms / window_ms, "port_kernel_ms": ours,
                    "kernels_in_trace": launches, "credited": credited})
        if final != compiles:
            fail(f"serve_tiers: programs were prepared in the phase: {compiles} -> {final}")
        for name in ("fused_attention_fwd_bf16sm", "fused_conv1d_fwd"):
            if launches[name] <= 0:
                fail(f"serve_tiers: {name} ran no time in the phase's trace: {launches}")
    finally:
        if prober is not None:
            prober.close()
        if server is not None:
            server.shutdown()
    del server, prober, router, fleets, engines, model, vocoder, engine
    gc.collect()
    torch.cuda.empty_cache()
    return launches


SERVE_CLUSTER_REPLICAS = 2
SERVE_CLUSTER_CLIENTS = 4
SERVE_CLUSTER_REQUESTS = 8       # a closed-loop client's /synthesize requests
SERVE_CLUSTER_DRILL_REQUESTS = 8  # concurrent requests under each drill
# the POST /debug/profile fan-out's window: it opens before the steady
# traffic and must outlast it (the traffic takes 0.9-1.3 s on an H100)
SERVE_CLUSTER_PROFILE_S = 4.0
# the survivor's probe while a killed replica respawns: one request, then
# this pause, until the fresh process is READY
SERVE_CLUSTER_PROBE_PAUSE_S = 0.05
# the cluster block of the phase's serve.yaml: the quorum is both replicas,
# 0.25 s heartbeats and a 2 s lease (a partitioned replica's lease expires
# 2 s after its last beat)
SERVE_CLUSTER_CFG = {"enabled": True, "quorum": SERVE_CLUSTER_REPLICAS,
                     "heartbeat_interval_s": 0.25, "lease_miss_budget": 7,
                     "spawn_grace_s": 300.0}
# a SIGTERMed replica drains for at most this long
SERVE_CLUSTER_FLEET = {"class_deadline_ms": SERVE_FLEET_DEADLINES, "drain_timeout_s": 5.0}
# the clock of a replica's engine_acoustic / engine_vocode spans: CUDA events
SERVE_CLUSTER_SPAN_CLOCK = "cuda_event"
# parallel/registry.read_launches' names -> the launch counters' names
LAUNCH_COUNTERS = {"fused_mha.launches": "fused_attention_fwd",
                   "fused_mha.launches_bf16sm": "fused_attention_fwd_bf16sm",
                   "fused_mha_bwd.launches": "fused_attention_bwd",
                   "fused_mha_bwd.launches_bf16sm": "fused_attention_bwd_bf16sm",
                   "attention_delta.launches": "fused_attention_bwd_delta",
                   "fused_conv1d.launches": "fused_conv1d_fwd"}


def check_window(what, summary):
    """A profile window's summary (``serving.server.profile_window``: the
    device kernels by name, the kernel wrappers' launches over the window)
    held as ``check_trace`` holds a trace: the port's kernels counted by
    name must equal the launches the same process credited. Returns the
    trace's counts."""
    credited = dict.fromkeys(TRACE_NAMES.values(), 0)
    credited.update(fused_attention_fwd_bf16sm=0, fused_attention_bwd_bf16sm=0)
    for name, n in summary["launches"].items():
        if name in LAUNCH_COUNTERS:
            credited[LAUNCH_COUNTERS[name]] += n
    return check_trace(what, {n: (0.0, c) for n, c in summary["kernels"].items()}, credited)


def pid_alive(pid):
    """True while ``pid`` runs (a zombie counts as gone)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            state = f.read().rsplit(")", 1)[1].split()[0]
    except (OSError, IndexError):
        return False
    return state not in ("Z", "X")


def replica_children():
    """Pids of this process's children that run the ``replica`` command."""
    pids = []
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
            with open(f"/proc/{entry}/cmdline", "rb") as f:
                cmd = f.read().split(b"\0")
        except (OSError, IndexError, ValueError):
            continue
        if ppid == os.getpid() and b"replica" in cmd and b"speakingstyle_torch" in cmd:
            pids.append(int(entry))
    return pids


def compute_apps():
    """``nvidia-smi --query-compute-apps=pid,used_memory``: {pid: used} (the
    container may show no pid), or the error."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return {"error": str(e)}
    rows = {}
    for line in out.stdout.strip().splitlines():
        pid, _, used = line.partition(",")
        if pid.strip().isdigit():
            rows[int(pid)] = used.strip()
    return rows


def replica_health(router):
    """{replica id: its /healthz body} of every lease of the router."""
    from speakingstyle_torch.serving.cluster import _get_json

    out = {}
    for row in router.cluster_stats():
        host, _, port = row["host"].rpartition(":")
        try:
            _, out[row["replica_id"]] = _get_json(host, int(port), "/healthz", timeout=10.0)
        except OSError as e:
            out[row["replica_id"]] = {"error": str(e)}
    return out


def state_value(state, name, labels=None):
    """A counter's value in a replica's exported registry state."""
    want = sorted((labels or {}).items())
    return sum(rec.get("value") or 0.0 for rec in state.get("metrics", [])
               if rec.get("name") == name and sorted(map(tuple, rec.get("labels") or [])) == want)


def cluster_cli_start(tmp, step, seed, wav, dev):
    """Start ``python -m speakingstyle_torch serve --replicas 2 --cluster`` in
    a subprocess (a session of its own) over the phase's checkpoint on the
    one-point lattice of ``serve_cli_check``, and a thread that reads its
    output and, once it serves, polls /healthz until both replica
    processes are READY; ``cluster_cli_check`` drives the rest. Returns its
    handle."""
    import threading

    import yaml

    out = os.path.join(tmp, "serve_cluster_cli")
    os.makedirs(out)
    os.symlink(os.path.join(tmp, "ckpt"), os.path.join(out, "ckpt"))
    cli_args = smoke_configs(out, SERVE_HTTP_MODEL)
    train_yaml = cli_args[cli_args.index("-t") + 1]
    with open(train_yaml) as f:
        train = yaml.safe_load(f)
    train["serve"] = SERVE_CLI_LATTICE
    with open(train_yaml, "w") as f:
        yaml.safe_dump(train, f)
    cli = {"t0": time.perf_counter(), "log": [], "address": None, "healthz": [], "rows": [],
           "pids": set()}
    cli["proc"] = proc = subprocess.Popen(
        [sys.executable, "-m", "speakingstyle_torch", "serve", *cli_args, "--restore_step",
         str(step), "--seed", str(seed), "--host", "127.0.0.1", "--port", "0",
         "--ref_audio", wav, "--device", dev.type, "--replicas", "2", "--cluster"],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, start_new_session=True)

    def read():
        for line in proc.stdout:
            cli["log"].append(line.rstrip())
            if cli["address"] is None and line.startswith("serving on http://"):
                host, port = line.split("http://", 1)[1].split(" ", 1)[0].rsplit(":", 1)
                cli["address"] = (host, int(port))
                threading.Thread(target=poll, daemon=True).start()

    def poll():
        deadline = time.monotonic() + 300
        while time.monotonic() < deadline and proc.poll() is None:
            try:
                st, _, hb, _ = http_call(cli["address"], "GET", "/healthz", timeout=30)
            except OSError:
                continue
            h = json.loads(hb)
            cli["rows"] = h.get("cluster", {}).get("replicas", [])
            cli["pids"] |= {r["pid"] for r in cli["rows"]}
            cli["healthz"].append((round(time.perf_counter() - cli["t0"], 3), st,
                                   h.get("replicas")))
            if st == 200 and len(cli["rows"]) == 2 and all(r["ready"] for r in cli["rows"]):
                cli["ready_s"] = time.perf_counter() - cli["t0"]
                return
            time.sleep(0.25)

    cli["reader"] = threading.Thread(target=read, daemon=True)
    cli["reader"].start()
    return cli


def cluster_cli_kill(cli):
    """Kill the ``serve --cluster`` subprocess's whole session (the command and
    its replica processes) and reap the command."""
    import signal

    try:
        os.killpg(cli["proc"].pid, signal.SIGKILL)
    except ProcessLookupError:
        pass
    for p in cli["pids"]:
        if pid_alive(p):
            os.kill(p, signal.SIGKILL)
    cli["proc"].wait(timeout=60)


def cluster_cli_check(cli):
    """Finish the subprocess ``cluster_cli_start`` started: /healthz
    answered 503 until both replica processes were READY and then 200, one
    /synthesize answers 200 with X-Served-By naming one of them, SIGTERM
    exits 0, and every replica process it spawned is gone. Returns its
    record."""
    import signal

    proc = cli["proc"]
    code, status, headers, body, secs = None, None, {}, b"", None
    try:
        deadline = time.monotonic() + 300
        while "ready_s" not in cli and time.monotonic() < deadline and proc.poll() is None:
            time.sleep(0.1)
        if "ready_s" not in cli:
            fail(f"serve_cluster: the serve --cluster command did not get ready: "
                 f"{cli['healthz'][-3:]} {cli['log'][-20:]}")
        # the batch class (2 s budget): the first answer crosses the wire
        status, headers, body, secs = http_call(cli["address"], "POST", "/synthesize",
                                                {"text": TEXTS[0], "priority": "batch"})
        proc.send_signal(signal.SIGTERM)
        code = proc.wait(timeout=120)
        cli["reader"].join(timeout=30)
    finally:
        if proc.poll() is None:
            cluster_cli_kill(cli)
    pids, log, healthz = cli["pids"], cli["log"], cli["healthz"]
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline and any(pid_alive(p) for p in pids):
        time.sleep(0.2)
    alive = sorted(p for p in pids if pid_alive(p))
    if alive:  # a stray context would sit beside the next phases
        cluster_cli_kill(cli)
    hosts = {r["host"] for r in cli["rows"]}
    statuses = [h[1] for h in healthz]
    record = {"exit_code": code, "ready_s": cli["ready_s"],
              "healthz": healthz[:2] + healthz[-1:], "healthz_polls": len(healthz),
              "status": status, "request_s": secs, "served_by": headers.get("X-Served-By"),
              "replica_pids": sorted(pids), "replica_pids_alive_after_exit": alive,
              "wav_samples": max(0, len(body) - 44) // 2, "log_tail": log[-6:]}
    if not (code == 0 and statuses and statuses[0] == 503 and statuses[-1] == 200
            and len(pids) == 2 and not alive and status == 200 and body[:4] == b"RIFF"
            and headers.get("X-Served-By") in hosts and any("replica processes" in l for l in log)
            and any("cluster control plane" in l for l in log)):
        fail(f"serve_cluster: the serve --replicas 2 --cluster command {record}")
    return record


def serve_cluster_phase(tmp, step, seed, dev, smi):
    """The cluster on one card: the LJSpeech preset at full width on the
    kernel path (bf16 compute, bf16 softmax), ``SERVE_FLEET_LATTICE``, from
    ``restored_phase``'s checkpoint, built through the serve command's
    cluster branch (``cli.serve.build_fleet(..., cluster=True)`` with
    ``serve.cluster.enabled``): the router, the StyleService and
    ``SynthesisServer`` in this process, two ``python -m speakingstyle_torch
    replica`` processes on the card.

    1. Spawn and warm: /healthz 503 until both are READY (the quorum), each
       one's spawn-to-lease seconds, ``memory_reserved`` (its /healthz),
       the card's free memory, ``nvidia-smi``'s compute apps; neither
       process built a kernel library (``build_seconds`` 0).
    2. Steady traffic (the 4 references uploaded, 4 closed-loop clients x 8
       /synthesize) inside one POST /debug/profile fan-out: in each replica
       process, and in this one (the StyleService), the port's kernels
       counted by name in its window equal the launches that process
       credited; X-Served-By names both replicas; no replica prepares
       anything (their /healthz compile counts); client p50 / p90 / max,
       the wire latency, hedges fired and won, idempotent hits.
    3. One traced request: /debug/trace/<id> joins this process's spans and
       the replica's (remote_dispatch, replica_dispatch, engine_run with its
       CUDA-event children); the federated /metrics sums the replicas'
       ``serve_wire_dispatches_total`` to the router's dispatches and the
       extra legs the replicas ran.
    4. Drills, hedging off so that a lost leg is requeued, each under
       ``SERVE_CLUSTER_DRILL_REQUESTS`` concurrent requests:
       ``replica_proc_kill`` (every request 200 and served once, the killed
       pid gone, a fresh process READY, the survivor's latency meanwhile,
       the card's free memory back within one replica's footprint);
       ``net_partition`` then ``heal`` (the lease expires, work requeued,
       the same pid re-admitted with its compile count unchanged); a
       replica's SIGTERM (the batch in flight answered by it, the process
       exits 0).
    Every 200 is a RIFF wav of mel_len x hop samples passing the quality
    gate and within ``SERVE_HTTP_LSB`` of ``run(eager=True)`` of an engine
    in this process. Every replica process is stopped and reaped in a
    ``finally``. ``serve --replicas 2 --cluster`` in a subprocess starts up
    beside the partition and SIGTERM drills (``cluster_cli_start``) and is
    then checked (``cluster_cli_check``). Returns the kernels counted in the profile
    windows, summed over the processes."""
    import dataclasses
    import http.client
    import signal
    import threading

    import numpy as np
    import torch
    import yaml

    from speakingstyle_torch.cli import config_from_args
    from speakingstyle_torch.cli.serve import build_fleet, build_parser
    from speakingstyle_torch.faults import FaultPlan
    from speakingstyle_torch.obs.quality import validate_wav
    from speakingstyle_torch.ops import kernels
    from speakingstyle_torch.serving.engine import load_engine
    from speakingstyle_torch.serving.fleet import READY
    from speakingstyle_torch.serving.frontend import TextFrontend, load_ref_mel
    from speakingstyle_torch.serving.server import SynthesisServer

    out = os.path.join(tmp, "serve_cluster")
    os.makedirs(out)
    os.symlink(os.path.join(tmp, "ckpt"), os.path.join(out, "ckpt"))
    cli_args = smoke_configs(out, SERVE_HTTP_MODEL)
    train_yaml = cli_args[cli_args.index("-t") + 1]
    with open(train_yaml) as f:
        train = yaml.safe_load(f)
    train["serve"] = dict(SERVE_FLEET_LATTICE, fleet=SERVE_CLUSTER_FLEET,
                          cluster=SERVE_CLUSTER_CFG)
    with open(train_yaml, "w") as f:
        yaml.safe_dump(train, f)
    args = build_parser().parse_args(cli_args + ["--restore_step", str(step), "--seed", str(seed),
                                                 "--device", dev.type])
    cfg = config_from_args(args)
    if not cfg.serve.cluster.enabled:
        fail("serve_cluster: serve.cluster.enabled did not load")
    sr = cfg.preprocess.preprocessing.audio.sampling_rate
    gc.collect()
    torch.cuda.empty_cache()
    free0 = torch.cuda.mem_get_info(dev)[0]
    events, plan = EventLog(), FaultPlan()
    server = router = cli = None
    seen_pids = set()
    answers, lock = [], threading.Lock()  # (what, payload, status, headers, body, seconds)
    try:
        # 1. spawn and warm, /healthz 503 until the quorum
        t0 = time.perf_counter()
        router, lifecycle, _ = build_fleet(cfg, args, SERVE_CLUSTER_REPLICAS, dev,
                                           fault_plan=plan, events=events, cluster=True)
        registry = router.registry
        wavs, _ = write_smoke_inputs(out, cfg, seed)
        frontend = TextFrontend(cfg, load_ref_mel(cfg, wavs[-1]))
        server = SynthesisServer(frontend=frontend, host="127.0.0.1", port=0, events=events,
                                 router=router, lifecycle=lifecycle,
                                 profile_dir=os.path.join(out, "profile"))
        threading.Thread(target=server.serve_forever, daemon=True).start()
        address = server.address[:2]
        healthz, deadline = [], time.monotonic() + 600
        while True:
            status, _, body, _ = http_call(address, "GET", "/healthz")
            h = json.loads(body)
            rows = h.get("cluster", {}).get("replicas", [])
            seen_pids |= {r["pid"] for r in rows}
            n_ready = list(h.get("replicas", {}).values()).count(READY)
            healthz.append((round(time.perf_counter() - t0, 3), status, n_ready))
            if status == 200:
                break
            if time.monotonic() > deadline:
                fail(f"serve_cluster: the replica processes did not warm: {h.get('replicas')}")
            time.sleep(0.25)
        ready_s = time.perf_counter() - t0
        if not (healthz[0][1] == 503 and all(n < SERVE_CLUSTER_REPLICAS for _, st, n in healthz
                                             if st == 503)
                and healthz[-1][2] >= SERVE_CLUSTER_REPLICAS):
            fail(f"serve_cluster: /healthz was not 503 until the quorum: {healthz}")
        torch.cuda.synchronize()
        free1 = torch.cuda.mem_get_info(dev)[0]
        footprint = (free0 - free1) / SERVE_CLUSTER_REPLICAS
        health = replica_health(router)
        spawn_s = {i: registry.value("serve_replica_precompile_seconds", {"replica": str(i)})
                   for i in range(SERVE_CLUSTER_REPLICAS)}
        builds = {rid: h.get("build_seconds") for rid, h in health.items()}
        emit("serve_cluster_warmup", nvidia_smi=smi, entry="cli.serve.build_fleet(cluster=True)",
             lattice=SERVE_FLEET_LATTICE, model=SERVE_HTTP_MODEL, cluster=SERVE_CLUSTER_CFG,
             ready_s=ready_s, spawn_to_lease_s=spawn_s,
             warmup_hist=hist_view(registry, "serve_replica_warmup_seconds"),
             healthz=healthz[:2] + healthz[-1:], healthz_polls=len(healthz),
             replicas={rid: {k: h.get(k) for k in ("pid", "compile_count",
                                                   "memory_reserved_bytes",
                                                   "memory_allocated_bytes", "build_seconds")}
                       for rid, h in health.items()},
             card_free_bytes={"before": free0, "replicas_ready": free1},
             footprint_per_replica_bytes=footprint, compute_apps=compute_apps(),
             router_memory_reserved_bytes=torch.cuda.memory_reserved(dev))
        if len(health) != SERVE_CLUSTER_REPLICAS or any(
                set(b or {}) != set(kernels.SOURCES) or any(v != 0.0 for v in (b or {}).values())
                for b in builds.values()):
            fail(f"serve_cluster: a replica process built its kernels (or reports none): {builds}")

        def payload(i):
            return {"text": TEXTS[i % len(TEXTS)], "style_id": style_ids[(i // 4) % 4]}

        def clients(what, n_clients, per_client):
            """Closed-loop clients on kept-alive connections."""
            def client(c):
                conn = http.client.HTTPConnection(*address, timeout=300)
                try:
                    for i in range(per_client):
                        p = payload(c + n_clients * i)
                        status, headers, body, secs = http_call(address, "POST", "/synthesize",
                                                                p, conn=conn)
                        with lock:
                            answers.append((what, p, status, headers, body, secs))
                finally:
                    conn.close()

            threads = [threading.Thread(target=client, args=(c,)) for c in range(n_clients)]
            for t in threads:
                t.start()
            return threads

        def join(threads):
            for t in threads:
                t.join(timeout=600)

        def of(what):
            with lock:
                return [a for a in answers if a[0] == what]

        # 2. steady traffic inside one profile fan-out
        style_ids = []
        router.style.clear()  # the uploads encode afresh, in the window
        engines = {e.replica_id: e for e in router.engines()}
        compiles = ({rid: e.compile_count for rid, e in engines.items()},
                    registry.value("serve_style_compiles_total"))
        dispatched0 = [registry.value("serve_replica_dispatches_total", {"replica": str(i)})
                       for i in range(SERVE_CLUSTER_REPLICAS)]
        prof = {}
        prof_thread = threading.Thread(target=lambda: prof.update(answer=http_call(
            address, "POST", f"/debug/profile?seconds={SERVE_CLUSTER_PROFILE_S}",
            timeout=600)))
        prof_thread.start()
        deadline = time.monotonic() + 60
        while not (server.profile_window_open.is_set() and all(
                h.get("profile_window_open") for h in replica_health(router).values())):
            if time.monotonic() > deadline:
                fail("serve_cluster: the profile windows did not open")
            time.sleep(0.05)
        t_traffic = time.perf_counter()
        for w in wavs:
            with open(w, "rb") as f:
                status, _, body, _ = http_call(address, "POST", "/styles", f.read(),
                                               {"Content-Type": "audio/wav"})
            if status != 200:
                fail(f"serve_cluster: POST /styles answered {status}: {body[:300]!r}")
            style_ids.append(json.loads(body)["style_id"])
        join(clients("steady", SERVE_CLUSTER_CLIENTS, SERVE_CLUSTER_REQUESTS))
        traffic_s = time.perf_counter() - t_traffic
        prof_thread.join(timeout=600)
        status, _, body, _ = prof["answer"]
        local = json.loads(body)
        if status != 200 or traffic_s > SERVE_CLUSTER_PROFILE_S - 0.5:
            fail(f"serve_cluster: the profile window ({status}) did not cover the "
                 f"{traffic_s:.2f} s of traffic")
        deadline = time.monotonic() + 120
        while True:
            health = replica_health(router)
            if all(h.get("last_profile") and not h.get("profiling") for h in health.values()):
                break
            if time.monotonic() > deadline:
                fail(f"serve_cluster: a replica's profile did not finish: {health}")
            time.sleep(0.2)
        windows = {rid: check_window(f"serve_cluster replica {rid}", h["last_profile"])
                   for rid, h in health.items()}
        windows["router"] = check_window("serve_cluster router (StyleService)", local)
        dispatched = [registry.value("serve_replica_dispatches_total", {"replica": str(i)}) - d
                      for i, d in enumerate(dispatched0)]
        after = ({rid: e.compile_count for rid, e in engines.items()},
                 registry.value("serve_style_compiles_total"))
        steady = of("steady")
        served_by = {a[3].get("X-Served-By") for a in steady}
        hosts = {r["host"]: r["replica_id"] for r in router.cluster_stats()}
        fed = router.federated_registry()
        emit("serve_cluster", nvidia_smi=smi, profile_window_s=SERVE_CLUSTER_PROFILE_S,
             traffic_s=traffic_s,
             requests={"closed_loop": len(steady), "clients": SERVE_CLUSTER_CLIENTS},
             latency_ms=quantiles_ms([a[5] for a in steady]),
             wire_latency_s=hist_view(registry, "serve_wire_latency_seconds",
                                      {"class": "interactive"}),
             hedges={"fired": registry.value("serve_hedge_fired_total",
                                             {"class": "interactive"}),
                     "won": registry.value("serve_hedge_won_total", {"class": "interactive"})},
             idempotent_hits=fed.value("fleet_serve_idempotent_hits_total"),
             replica_dispatches=dispatched, served_by=sorted(served_by),
             compiles={"before": compiles, "after": after},
             server_queue_wait_s=hist_view(registry, "serve_queue_wait_seconds"),
             kernels_in_windows=windows,
             router_window={k: local.get(k) for k in ("trace", "seconds", "launches")})
        if after != compiles:
            fail(f"serve_cluster: the traffic prepared programs: {compiles} -> {after}")
        if any(a[2] != 200 for a in steady) or served_by != set(hosts) or min(dispatched) <= 0:
            fail(f"serve_cluster: the steady traffic: statuses "
                 f"{sorted({a[2] for a in steady})}, X-Served-By {served_by}, replicas "
                 f"{sorted(hosts)}, dispatches {dispatched}")
        for rid, counts in windows.items():
            names = ("fused_attention_fwd_bf16sm", "fused_conv1d_fwd")
            if any(counts[n] <= 0 for n in names):
                fail(f"serve_cluster: {rid}'s window ran no {names}: {counts}")

        # 3. one traced request, the federation
        tid = "serve-cluster-trace"
        status, headers, body, _ = http_call(address, "POST", "/synthesize", payload(1),
                                             {"X-Trace-Id": tid})
        with lock:
            answers.append(("traced", payload(1), status, headers, body, 0.0))
        rid = hosts.get(headers.get("X-Served-By"))
        pid = {r["replica_id"]: r["pid"] for r in router.cluster_stats()}.get(rid)
        view = json.loads(http_call(address, "GET", f"/debug/trace/{tid}")[2])
        spans = []

        def walk(node, depth):
            spans.append({"name": node["name"], "depth": depth,
                          "pid": int(node["span_id"].split("-")[0], 16),
                          "ms": (node.get("duration_s") or 0.0) * 1e3,
                          "clock": (node.get("fields") or {}).get("clock")})
            for child in node["children"]:
                walk(child, depth + 1)

        for root in view.get("roots", []):
            walk(root, 0)
        by = {}
        for sp in spans:
            by.setdefault(sp["name"], []).append(sp)
        want_here = ("serve_request", "serve_queue", "fleet_dispatch", "remote_dispatch")
        want_there = ("replica_dispatch", "engine_run", "engine_acoustic", "engine_vocode")
        if not (status == 200 and pid is not None
                and all(any(s["pid"] == os.getpid() for s in by.get(n, [])) for n in want_here)
                and all(any(s["pid"] == pid for s in by.get(n, [])) for n in want_there)
                and all(s["clock"] == SERVE_CLUSTER_SPAN_CLOCK
                        for n in ("engine_acoustic", "engine_vocode") for s in by.get(n, []))):
            fail(f"serve_cluster: the trace {tid} (served by {rid}, pid {pid}): {spans}")

        def federation():
            states = dict(router.federated_states())
            wire = sum(state_value(st, "serve_wire_dispatches_total") for st in states.values())
            legs = {leg: sum(state_value(st, "serve_wire_legs_total", {"leg": leg})
                             for st in states.values()) for leg in ("primary", "hedge", "retry")}
            routed = sum(registry.value("serve_replica_dispatches_total", {"replica": str(i)})
                         for i in range(len(router.states())))
            return {"replicas": sorted(states), "wire_dispatches": wire, "legs": legs,
                    "router_dispatches": routed}

        deadline = time.monotonic() + 30
        while True:
            fed_view = federation()
            if (len(fed_view["replicas"]) == SERVE_CLUSTER_REPLICAS
                    and fed_view["legs"]["primary"] == fed_view["router_dispatches"]
                    and fed_view["wire_dispatches"] == sum(fed_view["legs"].values())):
                break
            if time.monotonic() > deadline:
                fail(f"serve_cluster: the federated wire dispatches do not add up: {fed_view}")
            time.sleep(0.2)
        metrics = http_call(address, "GET", "/metrics")[2].decode()
        fed_line = [l for l in metrics.splitlines()
                    if l.startswith("fleet_serve_wire_dispatches_total ")]
        if not fed_line or float(fed_line[0].split()[1]) < fed_view["wire_dispatches"]:
            fail(f"serve_cluster: /metrics' federated wire dispatches {fed_line}, want "
                 f"{fed_view['wire_dispatches']}")
        emit("serve_cluster_trace", trace_id=tid, served_by=rid, replica_pid=pid,
             router_pid=os.getpid(), spans=spans, federation=fed_view, metrics_line=fed_line[0])

        # 4. drills, hedging off: a lost leg is requeued, not hedged
        router.ccfg = dataclasses.replace(router.ccfg, hedge_quantile=0.0)

        def burst(what):
            threads = [threading.Thread(target=lambda i=i: _one(what, i))
                       for i in range(SERVE_CLUSTER_DRILL_REQUESTS)]
            for t in threads:
                t.start()
            return threads

        def _one(what, i):
            p = payload(i)
            status, headers, body, secs = http_call(address, "POST", "/synthesize", p)
            with lock:
                answers.append((what, p, status, headers, body, secs))

        def all_ready():
            states = router.states()
            return [i for i, s in states.items() if s == READY]

        def served():
            return sum(registry.value("serve_replica_requests_total", {"replica": str(i)})
                       for i in range(len(router.states())))

        def wait_until(pred, what, timeout=300):
            deadline = time.monotonic() + timeout
            while not pred():
                if time.monotonic() > deadline:
                    fail(f"serve_cluster: {what}: states {router.states()}, leases "
                         f"{router.cluster_stats()}")
                time.sleep(0.1)

        drills = {}
        # 4a. replica_proc_kill, then the respawn beside the survivor's traffic
        gc.collect()
        torch.cuda.synchronize()
        free_pre = torch.cuda.mem_get_info(dev)[0]
        pids_pre = {r["replica_id"]: r["pid"] for r in router.cluster_stats()}
        requeued0, served0 = registry.value("serve_requeued_total"), served()
        t0 = time.perf_counter()
        plan.arm("replica_proc_kill", router.dispatch_total + 1)
        join(burst("proc_kill"))
        killed = events.of("chaos_proc_kill")
        if len(killed) != 1:
            fail(f"serve_cluster: replica_proc_kill fired {len(killed)} times")
        killed_rid, killed_index = killed[0]["replica_id"], killed[0]["replica"]
        killed_pid = pids_pre[killed_rid]
        respawn_lat = []
        k = 0
        while len(all_ready()) < SERVE_CLUSTER_REPLICAS:
            if time.perf_counter() - t0 > 300:
                fail(f"serve_cluster: no fresh replica came back: {router.states()}")
            p = payload(k)
            status, headers, body, secs = http_call(address, "POST", "/synthesize", p)
            with lock:
                answers.append(("respawn", p, status, headers, body, secs))
            respawn_lat.append((headers.get("X-Served-By"), secs))
            k += 1
            time.sleep(SERVE_CLUSTER_PROBE_PAUSE_S)
        rows = {r["replica_id"]: r for r in router.cluster_stats()}
        seen_pids |= {r["pid"] for r in rows.values()}
        fresh = [rid for rid in rows if rid not in pids_pre]
        gc.collect()
        torch.cuda.synchronize()
        free_post = torch.cuda.mem_get_info(dev)[0]
        pk = of("proc_kill")
        drills["replica_proc_kill"] = {
            "seconds": time.perf_counter() - t0, "killed": killed_rid, "killed_pid": killed_pid,
            "killed_pid_alive": pid_alive(killed_pid), "fresh": fresh,
            "fresh_warmup_s": registry.value("serve_replica_precompile_seconds",
                                             {"replica": str(killed_index)}),
            "statuses": sorted(a[2] for a in pk), "latency_ms": quantiles_ms([a[5] for a in pk]),
            "requeued": registry.value("serve_requeued_total") - requeued0,
            "served": served() - served0 - len(respawn_lat),
            "survivor_latency_ms_during_respawn": quantiles_ms([s for _, s in respawn_lat]),
            "survivor_requests_during_respawn": len(respawn_lat),
            "card_free_bytes": {"before": free_pre, "after": free_post},
            "footprint_bytes": footprint}
        d = drills["replica_proc_kill"]
        if not (d["statuses"] == [200] * SERVE_CLUSTER_DRILL_REQUESTS and not d["killed_pid_alive"]
                and len(fresh) == 1 and d["requeued"] >= 1
                and d["served"] == SERVE_CLUSTER_DRILL_REQUESTS
                and all(a[2] == 200 for a in of("respawn"))
                and free_post >= free_pre - footprint):
            fail(f"serve_cluster: the replica_proc_kill drill: {d}")

        # the serve --cluster subprocess starts up beside the rest of the
        # phase, which measures nothing more in time or memory
        cli = cluster_cli_start(tmp, step, seed, wavs[-1], dev)

        # 4b. net_partition, the lease expires, then heal: the same process back
        t0 = time.perf_counter()
        requeued0, served0 = registry.value("serve_requeued_total"), served()
        compiled = {e.replica_id: e.compile_count for e in router.engines()}
        plan.arm("net_partition", router.dispatch_total + 1)
        join(burst("partition"))
        parted = events.of("net_partition")
        if len(parted) != 1:
            fail(f"serve_cluster: net_partition fired {len(parted)} times")
        prid = parted[0]["replica_id"]
        before = {r["replica_id"]: r for r in router.cluster_stats()}[prid]
        wait_until(lambda: {r["replica_id"]: r for r in router.cluster_stats()}[prid]["expired"],
                   "the partitioned lease did not expire", timeout=60)
        expired_s = time.perf_counter() - t0
        router.heal(prid)
        wait_until(lambda: len(all_ready()) == SERVE_CLUSTER_REPLICAS and not {
            r["replica_id"]: r for r in router.cluster_stats()}[prid]["expired"],
            "the healed replica was not re-admitted", timeout=120)
        after_row = {r["replica_id"]: r for r in router.cluster_stats()}[prid]
        engine_of = {e.replica_id: e for e in router.engines()}
        pa = of("partition")
        drills["net_partition"] = {
            "seconds": time.perf_counter() - t0, "replica": prid, "lease_expired_after_s": expired_s,
            "pid": [before["pid"], after_row["pid"]], "epoch": [before["epoch"], after_row["epoch"]],
            "compile_count": [compiled.get(prid), engine_of[prid].compile_count
                              if prid in engine_of else None],
            "statuses": sorted(a[2] for a in pa), "requeued": registry.value(
                "serve_requeued_total") - requeued0, "served": served() - served0,
            "processes": sorted(router.processes())}
        d = drills["net_partition"]
        if not (d["statuses"] == [200] * SERVE_CLUSTER_DRILL_REQUESTS and d["requeued"] >= 1
                and d["served"] == SERVE_CLUSTER_DRILL_REQUESTS
                and d["pid"][0] == d["pid"][1] and d["epoch"][1] > d["epoch"][0]
                and prid in engine_of and d["compile_count"][0] == d["compile_count"][1]
                and prid in router.processes()):
            fail(f"serve_cluster: the net_partition drill: {d}")

        # 4c. a replica's SIGTERM while it runs a dispatch: the dispatch it
        # admitted finishes there, nothing is lost, the process exits 0
        from speakingstyle_torch.serving.cluster import _get_json

        t0 = time.perf_counter()
        procs = router.processes()
        target = sorted(procs)[0]
        target_host = next(r["host"] for r in router.cluster_stats()
                           if r["replica_id"] == target)
        host, _, port = target_host.rpartition(":")
        admitted = None
        for _ in range(3):  # a burst whose dispatches all went to the other replica: again
            threads = burst("sigterm")
            while admitted is None and any(t.is_alive() for t in threads):
                try:
                    _, h = _get_json(host, int(port), "/healthz", timeout=5.0)
                except OSError:
                    h = {}
                if h.get("active_dispatches"):
                    admitted = h
            if admitted is not None:
                break
            join(threads)
        if admitted is None:
            fail(f"serve_cluster: no dispatch reached {target} for the SIGTERM drill")
        procs[target].send_signal(signal.SIGTERM)
        join(threads)
        code = procs[target].wait(timeout=60)
        st = of("sigterm")
        drills["sigterm"] = {
            "seconds": time.perf_counter() - t0, "replica": target, "exit_code": code,
            "active_at_signal": admitted["active_dispatches"],
            "wire_dispatches_at_signal": admitted["wire_dispatches"],
            "served_by_it": sum(a[3].get("X-Served-By") == target_host for a in st),
            "statuses": sorted(a[2] for a in st)}
        d = drills["sigterm"]
        if not (code == 0 and set(d["statuses"]) == {200} and d["served_by_it"] >= 1):
            fail(f"serve_cluster: the SIGTERM drill: {d}")
        emit("serve_cluster_drills", drills=drills,
             replica_failures=[{k: f.get(k) for k in ("replica", "kind", "error", "requeued",
                                                      "failed")}
                               for f in events.of("replica_failure")])

        # every answer against run(eager=True) of an engine in this process
        engine, _ = load_engine(cfg, step, device=dev, vocoder_seed=seed + 1, style=router.style)
        hop = engine.vocoder.hop_factor
        refs, bad, worst, checked = {}, [], 0, 0
        for what, p, status, headers, body, _ in answers:
            if status != 200:
                bad.append({"what": what, "status": status,
                            "body": body[:200].decode(errors="replace")})
                continue
            key = (p["text"], p["style_id"])
            if key not in refs:
                refs[key] = engine.run([frontend.request("eager", p)], eager=True)[0]
            ref = refs[key]
            wav = pcm_of(f"serve_cluster {what}", body, sr)
            verdict = validate_wav(wav, sr, cfg.serve.quality)
            if len(wav) != ref.mel_len * hop or not verdict.ok:
                bad.append({"what": what, "samples": len(wav), "want": ref.mel_len * hop,
                            "quality": verdict.as_dict()})
                continue
            lsb = int(np.abs(wav.astype(np.int32) - ref.wav.astype(np.int32)).max(initial=0))
            worst, checked = max(worst, lsb), checked + 1
            if lsb > SERVE_HTTP_LSB:
                bad.append({"what": what, "text": p["text"][:20], "max_lsb": lsb})
        emit("serve_cluster_answers", checked_wavs=checked,
             wav_vs_eager_lsb={"max": worst, "bound": SERVE_HTTP_LSB},
             by_phase={w: sum(1 for a in answers if a[0] == w)
                       for w in sorted({a[0] for a in answers})})
        engine.close()
        del engine, refs
        if bad:
            fail(f"serve_cluster: answers that fail their checks: {bad[:8]}")
    except BaseException:
        if cli is not None:
            cluster_cli_kill(cli)
        raise
    finally:
        if router is not None:
            seen_pids |= {r["pid"] for r in router.cluster_stats()}
        if server is not None:
            server.shutdown()
        elif router is not None:
            router.close()
        for pid in replica_children():  # whatever failed: no stray context stays
            os.kill(pid, signal.SIGKILL)
            os.waitpid(pid, 0)
    alive = sorted(p for p in seen_pids if pid_alive(p))
    emit("serve_cluster_cleanup", replica_pids=sorted(seen_pids), alive=alive)
    if alive:
        fail(f"serve_cluster: replica processes outlived the phase: {alive}")
    del server, router
    gc.collect()
    torch.cuda.empty_cache()
    emit("serve_cluster_cli", **cluster_cli_check(cli))
    launches = dict.fromkeys(next(iter(windows.values())), 0)
    for counts in windows.values():
        for name, n in counts.items():
            launches[name] += n
    return launches


# ---------------------------------------------------------------- phase 20: data-parallel training

# ---------------------------------------------------------------- phase 22

# the ring cell: the LJSpeech preset at full width on the kernel path in
# float32 (the ring's softmax is float32, and the dense oracle's bound is a
# float32 one), a one-point interactive lattice for the chunked tier and the
# vocoder windows (448 frames + the overlap a side fit 512; a chunk holds
# 512 / 12 = 42 phonemes), style (1, 1000), and the preset's long-form ring
# lattice on a sequence mesh of 2 ranks
SERVE_RING_MODEL = {"attention_kernel": "fused", "conv_impl": "pallas",
                    "compute_dtype": "float32"}
SERVE_RING_LATTICE = {"batch_buckets": [1], "src_buckets": [128], "mel_buckets": [512],
                      "style": {"ref_buckets": [1000]}, "fleet": {"stream_window": 448},
                      "longform": {"mesh_seq": 2, "src_buckets": [512, 1024],
                                   "mel_buckets": [6144, 12288], "max_chunks": 128}}
SERVE_RING_LABEL = "2 ranks sharing one card over gloo"
# a chapter's phonemes: past the 512-phoneme point, inside the 1024 one
SERVE_RING_PHONEMES = (600, 900)
# the ring's mel against a one-process dense free run (einsum attention)
# of the same weights, style and padded geometry, relative to max |mel|:
# float32 throughout, two softmax blocks merged against one softmax over
# 12288 keys, f32 sums in other orders through ten FFT blocks and the
# postnet: the bar of the float32 acoustic comparisons
SERVE_RING_RTOL = ACOUSTIC_RTOL
# a repeat chapter against the first (the same program on the same inputs)
SERVE_RING_REPEAT_ATOL = 1e-5
# seconds within which a chapter after a killed helper is answered (chunked)
SERVE_RING_KILL_S = 120.0


def ring_chapter(frontend, lo, hi):
    """(text, phoneme ids) of a chapter of the smoke texts in turn with
    between ``lo`` and ``hi`` phonemes, the ids as the long-form service
    plans them (each sentence's G2P, concatenated)."""
    import numpy as np

    from speakingstyle_torch.serving.longform import split_sentences

    sentences = []
    while True:
        sentences.append(TEXTS[len(sentences) % len(TEXTS)])
        text = " ".join(sentences)
        ids = np.concatenate([frontend.sequence(s) for s in split_sentences(text)])
        if ids.size >= lo:
            if ids.size > hi:
                fail(f"serve_ring: no chapter of the smoke texts has {lo}-{hi} phonemes")
            return text, ids.astype(np.int32)


def ring_inputs_of(tier, seq, style):
    """The padded inputs ``RingTier.synthesize`` stages for ``seq`` (speaker
    0, neutral controls) at the covering ring bucket."""
    import torch

    from speakingstyle_torch.serving.ring_ranks import ring_inputs

    bucket = tier.lattice.cover(1, len(seq), len(seq) * tier.cfg.serve.frames_per_phoneme)
    x = ring_inputs(tier.ring_cfg, bucket.l_src, bucket.t_mel)
    x["texts"].zero_()
    x["texts"][0, :len(seq)] = torch.from_numpy(seq).long()
    x["src_lens"][0] = len(seq)
    x["gammas"][0, 0] = torch.from_numpy(style.gamma)
    x["betas"][0, 0] = torch.from_numpy(style.beta)
    return bucket, x


def serve_ring_phase(tmp, step, seed, dev, smi):
    """The ring long-form tier on the card (``serve.longform.mesh_seq: 2``):
    the serve command's single-engine branch in this process, on
    ``restored_phase``'s checkpoint at full width (``SERVE_RING_MODEL``,
    ``SERVE_RING_LATTICE``): ``load_engine`` and ``precompile``, then
    ``RingTier`` (one helper rank process started, rank 0's weights
    broadcast and their digests checked) prepares its 4 points, attached to
    ``SynthesisServer``'s LongformService. The ranks share the card over
    gloo: a check of the path, not a multi-card measurement.

    1. A chapter of ``SERVE_RING_PHONEMES`` phonemes on
       /synthesize/longform, every kernel count set to 0 just before and
       read just after: 200 with ``X-Longform-Tier: ring`` at
       ``b1.s1024.m12288``, mel_len x hop samples (the mel_len of the same
       chapter through ``RingTier.synthesize``), nothing prepared, TTFA.
    2. The same chapter again: nothing prepared, its mel within
       ``SERVE_RING_REPEAT_ATOL`` of the first, the helper's own mel of
       that run bit-equal to rank 0's (sha256); rank 0's peak memory of a
       dispatch, the rotation and gather ms of both ranks, the helper's
       memory.
    3. A ring dispatch under torch.profiler: kernel #3's launches counted
       by name equal the credits (31), kernel #1's are 0 (the ring layers
       bypass it).
    4. The dense oracle: one process, einsum attention over the whole
       12288 frames, the same weights, style and padded inputs: the same
       durations and mel_len, the mel within ``SERVE_RING_RTOL`` x max
       |mel|; its peak memory beside the ring's.
    5. Kernel #3 at the ring's shapes (B = 1, T = 1024 and 12288) against
       its plain version, float32 and bfloat16.
    6. ``longform_ring_error`` on the next ring attempt: the chapter is
       answered chunked and counted in ``serve_longform_degraded_total``.
    7. The helper killed: the next chapter is answered chunked within
       ``SERVE_RING_KILL_S``, the ring stays down, /synthesize and /healthz
       still answer.

    Returns ({kernel: launches of step 1}, {case: kernel case})."""
    import hashlib
    import threading

    import numpy as np
    import torch
    import yaml
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from speakingstyle_torch.cli import config_from_args
    from speakingstyle_torch.cli.serve import build_parser, model_version_string
    from speakingstyle_torch.faults import FaultPlan
    from speakingstyle_torch.models.factory import build_model
    from speakingstyle_torch.obs.quality import validate_wav
    from speakingstyle_torch.serving.engine import SynthesisRequest, load_engine
    from speakingstyle_torch.serving.frontend import TextFrontend, load_ref_mel
    from speakingstyle_torch.serving.longform import RingTier
    from speakingstyle_torch.serving.ring_ranks import ring_leaves, ring_program
    from speakingstyle_torch.serving.server import SynthesisServer

    out = os.path.join(tmp, "serve_ring")
    os.makedirs(out)
    os.symlink(os.path.join(tmp, "ckpt"), os.path.join(out, "ckpt"))
    cli_args = smoke_configs(out, SERVE_RING_MODEL)
    train_yaml = cli_args[cli_args.index("-t") + 1]
    with open(train_yaml) as f:
        train = yaml.safe_load(f)
    train["serve"] = SERVE_RING_LATTICE
    with open(train_yaml, "w") as f:
        yaml.safe_dump(train, f)
    args = build_parser().parse_args(cli_args + ["--restore_step", str(step), "--seed",
                                                 str(seed)])
    cfg = config_from_args(args)
    lf = cfg.serve.longform
    sr = cfg.preprocess.preprocessing.audio.sampling_rate
    gc.collect()
    torch.cuda.empty_cache()
    engine, info = load_engine(cfg, step, device=dev, vocoder_seed=seed + 1)
    hop = engine.vocoder.hop_factor
    precompile_s = engine.precompile()
    wavs, _ = write_smoke_inputs(out, cfg, seed)
    ref = load_ref_mel(cfg, wavs[0])
    frontend = TextFrontend(cfg, ref)
    server = SynthesisServer(engine, frontend, host="127.0.0.1", port=0,
                             model_info=dict(info, version=model_version_string(info)))
    torch.cuda.synchronize()
    reserved0 = torch.cuda.memory_reserved(dev)
    # the serve command's ring branch (cli/serve.py); the server is shut
    # down whether or not it came to serve
    ring = None
    try:
        ring = RingTier(cfg, engine.model, engine)
        ring_precompile_s = ring.precompile()
        torch.cuda.synchronize()
        cards = [r for r in engine.programs() if r.get("label_kind") == "acoustic_ring"]
        want_labels = sorted(f"b1.s{l}.m{t}" for l in lf.src_buckets for t in lf.mel_buckets)
        if sorted(c["label_bucket"] for c in cards) != want_labels or any(
                c["graph"] or c["label_mesh"] != "seq2" for c in cards):
            fail(f"serve_ring: the ring's program cards {cards}")
        emit("serve_ring_start", nvidia_smi=smi, label=SERVE_RING_LABEL,
             entry="cli.serve: load_engine + precompile, RingTier + precompile",
             model=SERVE_RING_MODEL, lattice=SERVE_RING_LATTICE, restore_step=step,
             engine_precompile_s=precompile_s, helper_pids=[p.pid for p in ring.group.procs],
             spawn_to_ready_s=ring.startup_s, ring_precompile_s=ring_precompile_s,
             ring_programs=[{k: c.get(k) for k in ("name", "flops", "label_bucket",
                                                   "launches_per_replay")} for c in cards],
             weights_digest=ring.digest,
             memory_reserved_by_ring_bytes=torch.cuda.memory_reserved(dev) - reserved0)
        server.longform.ring = ring
        threading.Thread(target=server.serve_forever, daemon=True).start()
        address = server.address[:2]
        reg = server.registry
        text, seq = ring_chapter(frontend, *SERVE_RING_PHONEMES)

        # 1. the chapter over HTTP: the main path of the ring tier
        compiles = (engine.compile_count, engine.style.compile_count)
        reset_counts()
        status, headers, body, ttfa, secs = stream_call(address, {"text": text},
                                                        path="/synthesize/longform")
        launches = read_counts()
        if status != 200 or headers.get("X-Longform-Tier") != "ring":
            fail(f"serve_ring: the chapter answered {status} on tier "
                 f"{headers.get('X-Longform-Tier')}: {body[:300]!r}")
        pcm = pcm_of("serve_ring chapter", body, sr)
        style = engine.style.encode_mels([ref])[0]  # the chapter's, from the cache
        req = SynthesisRequest(id="ring_direct", sequence=seq, style=style)
        first = ring.synthesize(req)
        verdict = validate_wav(pcm, sr, cfg.serve.quality)
        chapter = {"phonemes": int(seq.size), "status": status, "tier": "ring",
                   "bucket": [first.bucket.l_src, first.bucket.t_mel], "mel_len": first.mel_len,
                   "samples": int(pcm.size), "ttfa_s": ttfa, "seconds": secs,
                   "quality_ok": verdict.ok, "launches": launches}
        if (first.bucket.l_src, first.bucket.t_mel) != (lf.src_buckets[-1], lf.mel_buckets[-1]) \
                or pcm.size != first.mel_len * hop or not verdict.ok \
                or (engine.compile_count, engine.style.compile_count) != compiles \
                or reg.value("serve_longform_degraded_total"):
            fail(f"serve_ring: the chapter {chapter}")
        for name in ("fused_attention_fwd", "fused_conv1d_fwd"):
            if not launches[name]:
                fail(f"serve_ring: {name} never launched on the ring chapter: {launches}")

        # 2. a repeat: nothing prepared, the same mel; memory and collectives
        stats0 = dict(ring.mesh.stats)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        again = ring.synthesize(req)
        ring_s = time.perf_counter() - t0
        ring_peak = torch.cuda.max_memory_allocated(dev) - base
        d = {k: ring.mesh.stats[k] - stats0[k] for k in stats0}
        helper = ring.group.helper_stats()
        # the forward across processes: the helper's own mel of that run
        # (its durations are rank 0's; its pitch and energy embeddings its
        # own) against rank 0's, bit for bit, or the ranks' blocks of the
        # ring came from different activations
        same_forward = helper[1].get("mel_digest") == hashlib.sha256(
            np.ascontiguousarray(again.mel).tobytes()).hexdigest()
        if not same_forward:
            fail(f"serve_ring: the helper's forward differs from rank 0's: {helper}")
        repeat_diff = float(np.abs(again.mel - first.mel).max()) \
            if again.mel_len == first.mel_len else None
        if engine.compile_count != compiles[0] or repeat_diff is None \
                or repeat_diff > SERVE_RING_REPEAT_ATOL:
            fail(f"serve_ring: the repeat chapter prepared {engine.compile_count - compiles[0]} "
                 f"program(s), its mel {repeat_diff} from the first")

        # 3. one ring dispatch traced: kernel #3 counted by name = credited
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        reset_counts()
        prof.start()
        try:
            prime_trace()
            ring.synthesize(req)
            torch.cuda.synchronize()
        finally:
            prof.stop()
        credited = read_counts()
        _, busy, by_name, ours = device_time(
            "serve_ring", [e for e in prof.events() if e.device_type == DeviceType.CUDA])
        in_trace = check_trace("serve_ring", by_name, credited)
        if in_trace["fused_attention_fwd"] or not in_trace["fused_conv1d_fwd"]:
            fail(f"serve_ring: a ring dispatch's trace counts {in_trace}")

        # 4. the dense oracle on the card
        bucket, x = ring_inputs_of(ring, seq, style)
        dense_cfg = dataclasses.replace(ring.ring_cfg, model=dataclasses.replace(
            ring.ring_cfg.model, attention_impl="dense", attention_kernel="einsum"))
        dense = build_model(dense_cfg, n_position=ring.lattice.max_mel + 1)
        with torch.no_grad():
            for dst, src in zip(ring_leaves(dense), ring_leaves(ring.model)):
                dst.copy_(src)
        dense = dense.to(dev).eval()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        with torch.no_grad():
            want = ring_program(dense, bucket.t_mel, True)(
                **{k: v.to(dev) for k, v in x.items()})
        want = {k: v.cpu().numpy() for k, v in want.items()}
        dense_s = time.perf_counter() - t0
        dense_peak = torch.cuda.max_memory_allocated(dev) - base
        del dense
        torch.cuda.empty_cache()
        mel_len = int(want["mel_lens"][0])
        wmel = want["mel_postnet"][0, :mel_len]
        scale = float(np.abs(wmel).max())
        same_durations = bool(np.array_equal(want["durations"][0, :seq.size], first.durations))
        err = float(np.abs(first.mel - wmel).max()) if mel_len == first.mel_len else None
        oracle = {"mel_len": mel_len, "same_durations": same_durations, "max_abs_err": err,
                  "max_abs_mel": scale, "rtol": SERVE_RING_RTOL,
                  "bound": SERVE_RING_RTOL * scale, "dense_s": dense_s,
                  "dense_peak_bytes": dense_peak, "ring_rank0_peak_bytes": ring_peak}
        if not same_durations or err is None or err > SERVE_RING_RTOL * scale:
            fail(f"serve_ring: the ring's mel against the dense free run {oracle}")

        # 5. kernel #3 at the ring's shapes
        lengths = {"src": (1, bucket.l_src, [int(seq.size)]),
                   "mel": (1, bucket.t_mel, [first.mel_len])}
        g = torch.Generator().manual_seed(seed)
        cases = []
        with strict_float32():
            for dtype in (torch.float32, torch.bfloat16):
                for case in conv_cases(cfg):
                    if case[1] != "ref":
                        cases.append(conv_case(case, lengths, dtype, g, dev, prefix="ring"))
                        emit("kernels", **cases[-1])
        bad = [c["case"] for c in cases if not c["ok"]]
        if bad:
            fail(f"serve_ring: kernel #3 disagrees with its plain version at {bad}")

        # 6. an injected ring failure degrades the chapter to chunked
        degraded0 = reg.value("serve_longform_degraded_total")
        server.longform.fault_plan = FaultPlan.parse(
            f"longform_ring_error@{server.longform._ring_attempts + 1}")
        status, headers, body, _, drill_s = stream_call(address, {"text": text},
                                                        path="/synthesize/longform")
        server.longform.fault_plan = None
        ring_error = {"status": status, "tier": headers.get("X-Longform-Tier"),
                      "chunks": headers.get("X-Longform-Chunks"), "seconds": drill_s,
                      "degraded": reg.value("serve_longform_degraded_total") - degraded0,
                      "ring_available": ring.available}
        if status != 200 or ring_error["tier"] != "chunked" or ring_error["degraded"] != 1 \
                or not ring.available:
            fail(f"serve_ring: longform_ring_error {ring_error}")

        # 7. the helper killed: chunked, within the bound; the server up
        proc = ring.group.procs[0]
        proc.kill()
        proc.wait(timeout=30)
        t0 = time.perf_counter()
        status, headers, body, _, _ = stream_call(address, {"text": text},
                                                  path="/synthesize/longform")
        kill_s = time.perf_counter() - t0
        interactive = http_call(address, "POST", "/synthesize", {"text": TEXTS[0]})[0]
        health = http_call(address, "GET", "/healthz")[0]
        killed = {"status": status, "tier": headers.get("X-Longform-Tier"), "seconds": kill_s,
                  "bound_s": SERVE_RING_KILL_S, "ring_available": ring.available,
                  "broken": ring.group.broken, "interactive": interactive, "healthz": health}
        if status != 200 or killed["tier"] != "chunked" or kill_s > SERVE_RING_KILL_S \
                or ring.available or interactive != 200 or health != 200:
            fail(f"serve_ring: after the killed helper {killed}")
        emit("serve_ring", nvidia_smi=smi, label=SERVE_RING_LABEL, chapter=chapter,
             repeat={"max_abs_diff": repeat_diff, "bound": SERVE_RING_REPEAT_ATOL,
                     "ring_s": ring_s, "prepared": engine.compile_count - compiles[0]},
             rank0_collectives={"rotations": d["rotations"],
                                "rotate_ms_each": 1e3 * d["rotate_s"] / max(d["rotations"], 1),
                                "rotate_ms": 1e3 * d["rotate_s"], "gathers": d["gathers"],
                                "gather_ms": 1e3 * d["gather_s"],
                                "bytes_sent": d["bytes_sent"]},
             helper=helper, forward_bit_equal_across_ranks=same_forward,
             memory_reserved_rank0_bytes=torch.cuda.memory_reserved(dev),
             compute_apps=compute_apps(),
             traced={"launches": in_trace, "credited": credited, "busy_ms": busy,
                     "ours_ms": ours, "top_ms": dict(sorted(
                         ((n[:80], round(ms, 3)) for n, (ms, _) in by_name.items()),
                         key=lambda kv: -kv[1])[:8])},
             dense_oracle=oracle, ring_error=ring_error, helper_killed=killed,
             ring_seconds=reg.histogram("serve_longform_ring_seconds").snapshot())
    finally:
        server.shutdown()
        if ring is not None:
            ring.close()
    return launches, {c["case"]: c for c in cases}


TRAIN_DP_RANKS = 2
TRAIN_DP_LABEL = "2 ranks sharing one card over gloo"
TRAIN_DP_STEPS = 2   # the parity steps (strict float32); the first is a warm-up for times
# the train command's drill: nan_grads on step 3's batch (rank 0's rows), a
# log line and the sentinel every step, a checkpoint at step 2 (the
# rollback's target) and the final flush at step 3
TRAIN_DP_DRILL = "nan_grads@3"
TRAIN_DP_DRILL_CFG = {"log_step": 1, "save_step": 2, "val_step": 10 ** 6}
TRAIN_DP_DRILL_STEPS = 3
TRAIN_DP_VOC = {"batch": 4, "steps": 3, "wavs": 4, "seconds": 1.0}
TRAIN_DP_TIMEOUT_S = 300  # each process of the phase
# the ranks' step against one process's step from the same state: Adam's
# first-moment step moves a parameter by lr g / (|g| + eps), so where the
# two gradients straddle 0 at rounding level the parameters land up to 2 lr
# apart (tests/test_torch_training.py's allowance); elsewhere they agree
TRAIN_DP_ADAM_FLIP = 2.0
# the BatchNorm running statistics after the step, relative to each
# buffer's largest element: the same batch's statistics summed in another
# order (3.2e-6 measured at step 1 on the H100)
TRAIN_DP_STATS_RTOL = 1e-4
# the tensor-parallel check inside the phase's two processes: (dp = 1, tp =
# TRAIN_TP), its parity steps; then `train --model_parallel TRAIN_TP` at a
# cut depth (TRAIN_TP_CMD_LAYERS encoder and decoder layers, full widths)
# for TRAIN_TP_CMD_STEPS steps, its checkpoint resumed at tp = 1
TRAIN_TP = 2
TRAIN_TP_STEPS = 2
TRAIN_TP_CMD_STEPS = 2
TRAIN_TP_CMD_LAYERS = 1
TRAIN_TP_CMD_CFG = {"log_step": 1, "save_step": 10 ** 6, "val_step": 10 ** 6}


def dp_per_step(cfg):
    """{kernel: launches a train step}: 14 attention forwards, backwards and
    delta pre-passes, 42 convs of which the reference encoder's LN convs
    write ``act``."""
    tr, re_ = cfg.model.transformer, cfg.model.reference_encoder
    attn = re_.encoder_layer + tr.encoder_layer + tr.decoder_layer
    return {"fused_attention_fwd": attn, "fused_attention_bwd": attn,
            "fused_attention_bwd_delta": attn,
            "fused_conv1d_fwd": sum(c[-1] for c in conv_cases(cfg)),
            "fused_conv1d_fwd_act": re_.conv_layer}


def dp_state(cfg, weights, dev, optimizer_state=None):
    """A TrainState on ``dev`` holding ``weights`` (a state dict, or the
    file of one) and, when given, the optimizer's state."""
    import torch

    from speakingstyle_torch.models.factory import build_model
    from speakingstyle_torch.training.optim import Optimizer
    from speakingstyle_torch.training.state import TrainState
    from speakingstyle_torch.training.trainer import trainable

    if isinstance(weights, str):
        weights = torch.load(weights, map_location="cpu", weights_only=True)
    model = build_model(cfg)
    model.load_state_dict(weights)
    model = model.to(dev)
    state = TrainState(0, model, Optimizer(trainable(model), cfg.train))
    if optimizer_state is not None:
        state.optimizer.load_state_dict(optimizer_state)
    return state


def dp_snapshot(model, grads):
    """(every trainable parameter's gradient, every parameter and buffer) on
    the host, by name, as copies (never the live tensors)."""
    named = [n for n, p in model.named_parameters() if p.requires_grad]
    copy = lambda t: t.detach().float().cpu().clone()  # noqa: E731
    return ({n: copy(g) for n, g in zip(named, grads)},
            {n: copy(t) for n, t in model.state_dict().items()})


def dp_parity_steps(cfg, state, batches, dev, mesh):
    """TRAIN_DP_STEPS chained data-parallel steps at strict float32, each
    (on rank 0) beside one process's step on the whole global batch from a
    copy of the same state, which runs while rank 1 waits at a barrier, so
    the card is the one process's: per step the logged
    losses, the agreed flag, the weights digest, the launches of the rank's
    step, its rows' valid frames, both steps' wall ms (a host clock around
    a step that ends in a synchronise) and, on rank 0, both steps'
    gradients and states after them on the host."""
    import torch

    from speakingstyle_torch.models.loss import loss_counts
    from speakingstyle_torch.obs.buildinfo import weights_digest
    from speakingstyle_torch.parallel.mesh import shard_batch
    from speakingstyle_torch.training.trainer import global_losses, make_train_step, to_device

    step, one_step = make_train_step(cfg, mesh), make_train_step(cfg)
    rows = []
    with strict_float32():
        for batch in batches:
            row = {}
            if mesh.is_main:
                one = dp_state(cfg, state.model.state_dict(), dev, state.optimizer.state_dict())
                one.step = state.step
                arrays = to_device(batch.arrays(), dev)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                losses, grads = one_step(one, arrays)
                torch.cuda.synchronize()
                row["one"] = {"losses": global_losses(losses)[0], "lr": one.optimizer.schedule(
                    one.optimizer.count - 1), "ms": (time.perf_counter() - t0) * 1e3}
                row["one"]["grads"], row["one"]["state"] = dp_snapshot(one.model, grads)
                del one, losses, grads
            arrays = to_device(shard_batch(batch.arrays(), mesh), dev)
            torch.cuda.synchronize()
            mesh.barrier()  # rank 1 waited out rank 0's reference step
            reset_counts()
            t0 = time.perf_counter()
            losses, grads = step(state, arrays, loss_counts(batch.arrays()))
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            host, finite = global_losses(losses, mesh)
            row.update(losses=host, finite=finite, launches=read_counts(), ms=ms,
                       digest=weights_digest(state.model.state_dict()),
                       frames=int(arrays["mel_lens"].sum()))
            if mesh.is_main:
                row["grads"], row["state"] = dp_snapshot(state.model, grads)
            rows.append(row)
    return rows


def dp_traced_step(cfg, state, batch, dev, mesh):
    """One rank step under torch.profiler (primed, see prime_trace): the
    port's kernels counted by name in its ``train.step`` range against the
    launches the wrappers credited, the host ms inside the mesh's
    ``<group>.all_reduce`` ranges (the reduce itself and the wait for the
    other rank), and the device's idle share within the step (the trace
    holds this process's kernels only). The window runs from the first to
    the last of the device's ``train.step`` ranges: a tp step's range came
    back as two device ranges on the H100."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from speakingstyle_torch.models.loss import loss_counts
    from speakingstyle_torch.parallel.mesh import shard_batch
    from speakingstyle_torch.training.trainer import make_train_step, to_device

    step = make_train_step(cfg, mesh)
    arrays = to_device(shard_batch(batch.arrays(), mesh), dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        prime_trace()
        mesh.barrier()  # both ranks' traces open before either steps
        reset_counts()
        with record_function("train.step"):
            step(state, arrays, loss_counts(batch.arrays()))
        torch.cuda.synchronize()
    credited = read_counts()
    events = prof.events()
    on_device = [e for e in events if e.device_type == DeviceType.CUDA]
    spans = [e.time_range for e in on_device
             if e.is_user_annotation and e.name == "train.step"]
    if not spans:
        fail(f"train_dp rank {mesh.rank}: no train.step range on the device")
    start, end = min(r.start for r in spans), max(r.end for r in spans)
    kernels = [e for e in on_device
               if not e.is_user_annotation and start <= e.time_range.start < end]
    window, busy, by_name, ours = device_time(f"train_dp rank {mesh.rank}", kernels)
    in_trace = check_trace(f"train_dp rank {mesh.rank}", by_name, credited)
    out = {"device_ranges": len(spans), "trace_window_ms": window, "device_busy_ms": busy,
           "idle_share": 1.0 - busy / window, "port_kernel_ms": ours,
           "kernels_in_trace": in_trace, "credited": credited}
    for group in ("dp", "tp"):
        reduces = [e for e in events if e.device_type == DeviceType.CPU
                   and e.name == f"{group}.all_reduce"]
        prefix = "" if group == "dp" else "tp_"
        out[f"{prefix}all_reduce_calls"] = len(reduces)
        out[f"{prefix}all_reduce_ms"] = sum(e.time_range.elapsed_us() for e in reduces) / 1e3
    return out


def tp_state(cfg, weights, dev, mesh):
    """A TrainState of ``weights`` (a state-dict file) on ``dev``, this
    rank's shards of the tensor-parallel layout."""
    import torch

    from speakingstyle_torch.models.factory import build_model
    from speakingstyle_torch.training.trainer import shard_model

    model = build_model(cfg)
    model.load_state_dict(torch.load(weights, map_location="cpu", weights_only=True))
    return shard_model(model.to(dev), cfg, mesh)


def tp_snapshot(state, grads, mesh):
    """(the gradients by name, the parameters and buffers by name), each
    gathered whole over tp on every rank (a collective), as host copies;
    and the digests of the whole state and of this rank's replicated
    leaves."""
    from speakingstyle_torch.obs.buildinfo import weights_digest
    from speakingstyle_torch.parallel.tensor import gather_whole

    lay = state.layout
    whole = lambda n, t: t if lay.dim(n) is None else gather_whole(t.detach(), lay.dim(n), mesh)  # noqa: E731
    names = [n for n, p in state.model.named_parameters() if p.requires_grad]
    copy = lambda t: t.detach().float().cpu().clone()  # noqa: E731
    sd = state.model.state_dict()
    full = {n: whole(n, t) for n, t in sd.items()}
    return ({n: copy(whole(n, g)) for n, g in zip(names, grads)},
            {n: copy(t) for n, t in full.items()}, weights_digest(full),
            weights_digest({n: t for n, t in sd.items() if lay.dim(n) is None}))


def tp_parity_steps(cfg, state, batches, dev, mesh):
    """TRAIN_TP_STEPS chained tensor-parallel steps at strict float32 (the
    dp = 1 x tp = 2 mesh: each rank its shards and the whole global batch),
    each beside (on rank 0) one process's step on the same batch from the
    same state gathered whole, run while rank 1 waits at a barrier: per step
    the losses, the agreed flag, the digests of the whole state and of the
    replicated leaves, the launches of the rank's step, both steps' wall ms
    and, on rank 0, both steps' gradients and states (whole) on the host."""
    import torch

    from speakingstyle_torch.training.trainer import (
        _SavedState, global_losses, make_train_step, to_device,
    )

    step, one_step = make_train_step(cfg, mesh), make_train_step(cfg)
    rows = []
    with strict_float32():
        for batch in batches:
            row = {}
            whole = _SavedState(state, mesh).state_dict(copy=False)  # gathered on both ranks
            if mesh.is_main:
                one = dp_state(cfg, whole["model"], dev, whole["optimizer"])
                one.step = state.step
                arrays = to_device(batch.arrays(), dev)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                losses, grads = one_step(one, arrays)
                torch.cuda.synchronize()
                row["one"] = {"losses": global_losses(losses)[0], "lr": one.optimizer.schedule(
                    one.optimizer.count - 1), "ms": (time.perf_counter() - t0) * 1e3}
                row["one"]["grads"], row["one"]["state"] = dp_snapshot(one.model, grads)
                del one, losses, grads
            del whole
            arrays = to_device(batch.arrays(), dev)
            torch.cuda.synchronize()
            mesh.barrier()  # rank 1 waited out rank 0's reference step
            reset_counts()
            t0 = time.perf_counter()
            losses, grads = step(state, arrays)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            host, finite = global_losses(losses, mesh)
            got_grads, got_state, digest, replicated = tp_snapshot(state, grads, mesh)
            row.update(losses=host, finite=finite, launches=read_counts(), ms=ms,
                       digest=digest, replicated_digest=replicated)
            if mesh.is_main:
                row["grads"], row["state"] = got_grads, got_state
            rows.append(row)
            del got_grads, got_state
    return rows


def tp_worker(cfg, job, batches, mesh, out):
    """The tensor-parallel half of a ``train_dp`` rank: the same processes
    re-formed as (dp = 1, tp = TRAIN_TP), a fresh state of the job's
    weights cut to this rank's shards, the parity steps (judged on rank 0),
    then a traced tp step."""
    import torch

    from speakingstyle_torch.parallel.mesh import regroup

    tp_mesh = regroup(mesh, TRAIN_TP)
    state = tp_state(cfg, job["weights"], mesh.device, tp_mesh)
    out["tp_split_leaves"] = sum(d is not None for d in state.layout.dims.values())
    rows = tp_parity_steps(cfg, state, [next(batches) for _ in range(TRAIN_TP_STEPS)],
                           mesh.device, tp_mesh)
    if tp_mesh.is_main:
        out["tp_judged"] = dp_judge(rows)
    out["tp_parity"] = [{k: v for k, v in p.items() if k not in ("one", "grads", "state")}
                        | {"one_ms": p.get("one", {}).get("ms")} for p in rows]
    del rows
    if mesh.device.type == "cuda":
        torch.cuda.empty_cache()
        out["tp_traced"] = dp_traced_step(cfg, state, next(batches), mesh.device, tp_mesh)
        out["tp_memory_reserved_bytes"] = torch.cuda.memory_reserved(mesh.device)


def dp_nccl_rank(cfg, weights, dev):
    """One NCCL rank at world size 1 in this process (a rendezvous on a free
    port, left again after): one train step, then its gradients all-reduced
    and its parameters broadcast through the mesh on the card (at world
    size 1 both leave every bit as it was), and a host value over the gloo
    side group."""
    import torch

    from speakingstyle_torch.parallel.launch import free_port, worker_env
    from speakingstyle_torch.parallel.mesh import ENV_KEYS, init_distributed, leave_group
    from speakingstyle_torch.training.trainer import make_train_step, to_device, train_batcher

    saved = {k: os.environ.get(k) for k in ENV_KEYS}
    os.environ.update({k: worker_env(0, 1, free_port())[k] for k in ENV_KEYS})
    try:
        mesh = init_distributed(dev.type, verbose=False)
        state = dp_state(cfg, weights, mesh.device)
        losses, grads = make_train_step(cfg)(state, to_device(
            next(iter(train_batcher(cfg))).arrays(), mesh.device))
        before = [g.clone() for g in grads]
        mesh.all_reduce_(grads)
        params = list(state.model.parameters())
        kept = [p.detach().clone() for p in params]
        with torch.no_grad():
            mesh.broadcast_(params)
        torch.cuda.synchronize()
        return {"backend": mesh.backend, "reason": mesh.backend_reason, "step": state.step,
                "total_loss": float(losses["total_loss"]),
                "grads_equal": all(torch.equal(a, b) for a, b in zip(grads, before)),
                "params_equal": all(torch.equal(a, b) for a, b in zip(params, kept)),
                "host_sum": mesh.host_all_reduce([1.5])[0], "tensors": len(grads)}
    finally:
        leave_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def dp_resume(cfg, dev, step=TRAIN_DP_DRILL_STEPS):
    """A train command's last checkpoint (``step``, saved at dp = 2 or tp =
    2, whole) restored in one process: every leaf and Adam moment as saved,
    its digest the manifest's, then one step."""
    import torch

    from speakingstyle_torch.obs.buildinfo import weights_digest
    from speakingstyle_torch.training.checkpoint import CheckpointManager
    from speakingstyle_torch.training.trainer import (
        build_state, make_train_step, to_device, train_batcher,
    )

    saved = CheckpointManager(cfg.train.path.ckpt_path)
    state = build_state(cfg, dev)
    saved.restore(state, step=step)
    _, host, manifest = saved.load_verified(step)
    out = {"digest": weights_digest(state.model.state_dict()),
           "manifest_digest": manifest["weights_digest"],
           "leaves_equal": all(torch.equal(t.cpu(), host["model"][k])
                               for k, t in state.model.state_dict().items()),
           "moments_equal": all(torch.equal(t.cpu(), h) for t, h in zip(
               state.optimizer.mu + state.optimizer.nu,
               host["optimizer"]["mu"] + host["optimizer"]["nu"])),
           "count": state.optimizer.count}
    losses, _ = make_train_step(cfg)(state, to_device(next(iter(train_batcher(cfg))).arrays(),
                                                      dev))
    out.update(total_loss=float(losses["total_loss"]), step=state.step)
    return out


def train_dp_worker(job_path):
    """One rank of the ``train_dp`` phase (``chip_smoke.py --train_dp_worker
    JOB``, started by ``parallel/launch.py::run_workers``): the parity
    steps, the timed steps and a traced step; then the same at (dp = 1, tp
    = 2) (``tp_worker``)."""
    import torch

    from speakingstyle_torch.configs.config import load_config
    from speakingstyle_torch.models.postnet import sync_batch_stats
    from speakingstyle_torch.parallel.mesh import init_distributed, leave_group
    from speakingstyle_torch.training.trainer import broadcast_state, train_batcher

    with open(job_path, encoding="utf-8") as fh:
        job = json.load(fh)
    mesh = init_distributed(job["device"])
    dev = mesh.device
    out = {"rank": mesh.rank, "backend": mesh.backend, "reason": mesh.backend_reason,
           "device": str(dev)}
    try:
        cfg = load_config(*job["yamls"][1::2])
        batches = iter(train_batcher(cfg, pad_multiple=TRAIN_DP_RANKS))
        state = dp_state(cfg, job["weights"], dev)
        sync_batch_stats(state.model, mesh)
        broadcast_state(state, mesh)
        parity = dp_parity_steps(
            cfg, state, [next(batches) for _ in range(TRAIN_DP_STEPS)], dev, mesh)
        if mesh.is_main:  # judged here: the snapshots stay in this process
            out["judged"] = dp_judge(parity)
        out["parity"] = [{k: v for k, v in p.items() if k not in ("one", "grads", "state")}
                         | {"one_ms": p.get("one", {}).get("ms")} for p in parity]
        traced = next(batches)
        if dev.type == "cuda":  # a CPU rehearsal has no device trace
            out["traced"] = dp_traced_step(cfg, state, traced, dev, mesh)
            out["memory_reserved_bytes"] = torch.cuda.memory_reserved(dev)
        del state, parity
        tp_worker(cfg, job, batches, mesh, out)
        torch.save(out, f"{job_path}.rank{mesh.rank}.pt")
    finally:
        leave_group()


def dp_judge(parity):
    """Rank 0's parity steps against its one-process steps from the same
    states, by the train phase's bounds: the losses (F32_LOSS_RTOL), each
    gradient (F32_GRAD_RTOL of its largest element; a leaf at NOISE_SHARE
    of the step's largest held below ZERO_GRAD_SHARE of it), each parameter
    after the step (TRAIN_DP_ADAM_FLIP lr), each BatchNorm statistic
    (TRAIN_DP_STATS_RTOL of its largest). Returns (a summary a step, the
    failed checks)."""
    bad, rows = [], []
    for s, got in enumerate(parity):
        want, tag = got["one"], f"step {s + 1}"
        loss_err = {k: abs(got["losses"][k] - v) / max(abs(v), 1e-30)
                    for k, v in want["losses"].items()}
        bad += [f"{tag} {k}: {got['losses'][k]} vs {want['losses'][k]}"
                for k, e in loss_err.items() if not e <= F32_LOSS_RTOL]
        top = max(g.abs().max().item() for g in want["grads"].values())
        grad_err, noise = 0.0, 0
        for name, w in want["grads"].items():
            g, scale = got["grads"][name], w.abs().max().item()
            if scale <= NOISE_SHARE * top:
                noise += 1
                if max(scale, g.abs().max().item()) > ZERO_GRAD_SHARE * top:
                    bad.append(f"{tag} {name}: |grad| above {ZERO_GRAD_SHARE} of the largest "
                               "with zero exact gradient")
                continue
            err = (g - w).abs().max().item() / scale
            grad_err = max(grad_err, err)
            if not err <= F32_GRAD_RTOL:
                bad.append(f"{tag} grad {name}: {err} of its max |grad| {scale}")
        param_err, apart, stats_err = 0.0, 0, 0.0
        for name, w in want["state"].items():
            d = (got["state"][name] - w).abs()
            if name.endswith((".mean", ".var")):  # the postnet's BatchNorm statistics
                err = d.max().item() / max(w.abs().max().item(), 1e-30)
                stats_err = max(stats_err, err)
                if not err <= TRAIN_DP_STATS_RTOL:
                    bad.append(f"{tag} {name}: {err} of its largest")
                continue
            param_err = max(param_err, d.max().item())
            apart += int((d > 0.5 * want["lr"]).sum())
            if not d.max().item() <= TRAIN_DP_ADAM_FLIP * want["lr"]:
                bad.append(f"{tag} {name}: {d.max().item()} apart after the step")
        rows.append({"step": s + 1, "loss_rel_err": max(loss_err.values()),
                     "grad_worst_rel_err": grad_err, "noise_leaves": noise,
                     "param_max_abs_diff": param_err, "params_over_half_lr": apart,
                     "param_bound": TRAIN_DP_ADAM_FLIP * want["lr"],
                     "batch_stats_rel_err": stats_err})
    return rows, bad


def tp_command_launches(cfg):
    """Rank 0's kernel launches over the tensor-parallel command's run (its
    ``train_end`` record), and what TRAIN_TP_CMD_STEPS steps of its cut
    model launch."""
    run = runs_of(cfg.train.path.log_path)[-1]
    end = of(run, "train_end")
    want = {k: 0 for k in read_counts()} | {
        k: TRAIN_TP_CMD_STEPS * n for k, n in dp_per_step(cfg).items()}
    return {"counted": end[0]["kernel_launches"] if end else None, "want": want,
            "mesh_shape": of(run, "train_start")[0].get("mesh_shape")}


def tp_checks(ranks, per_step, tpcmd, launches, resume, command_out):
    """The failed checks of the tensor-parallel half of the phase: the parity
    steps (rank 0's judge), equal whole-state and replicated-leaf digests on
    both ranks after every step, every kernel's launches a rank step (0 for
    the bf16-softmax ones) and in the traced step, by name, equal to its
    credits; the command's steps, rank 0's launches, its mesh, and its
    checkpoint resumed at tp = 1."""
    bad = [f"tp {b}" for b in ranks[0]["tp_judged"][1]]
    for s in range(TRAIN_TP_STEPS):
        for key in ("digest", "replicated_digest"):
            if len({r["tp_parity"][s][key] for r in ranks}) != 1:
                bad.append(f"tp step {s + 1}: the ranks' {key}s differ")
        for r in ranks:
            p = r["tp_parity"][s]
            if not p["finite"] or p["launches"] != per_step:
                bad.append(f"tp rank {r['rank']} step {s + 1}: finite {p['finite']}, launches "
                           f"{p['launches']}")
    for r in ranks:
        t = r.get("tp_traced", {})
        if t.get("credited") != per_step or not t.get("tp_all_reduce_calls"):
            bad.append(f"tp rank {r['rank']} traced step: credited {t.get('credited')}, "
                       f"tp all-reduces {t.get('tp_all_reduce_calls')}")
    with open(os.path.join(tpcmd.train.path.log_path, "log.txt"), encoding="utf-8") as fh:
        log = fh.read()
    steps_logged = [log.count(f"[train] Step {s + 1},") for s in range(TRAIN_TP_CMD_STEPS)]
    if launches["counted"] != launches["want"] or steps_logged != [1] * TRAIN_TP_CMD_STEPS \
            or launches["mesh_shape"] != {"data": 1, "model": TRAIN_TP}:
        bad.append(f"the tp command: launches {launches}, steps logged {steps_logged}: "
                   f"{command_out[-1500:]}")
    if not (resume["leaves_equal"] and resume["moments_equal"]
            and resume["digest"] == resume["manifest_digest"]
            and resume["step"] == TRAIN_TP_CMD_STEPS + 1 and math.isfinite(resume["total_loss"])):
        bad.append(f"the tp = 2 checkpoint at tp = 1: {resume}")
    return bad


def dp_wavs(tmp, sr, seed):
    """TRAIN_DP_VOC["wavs"] seeded int16 wavs for the vocoder command."""
    import numpy as np
    from scipy.io import wavfile

    os.makedirs(tmp, exist_ok=True)
    for i in range(TRAIN_DP_VOC["wavs"]):
        wav = reference_wav(seed + 100 + i, sr, TRAIN_DP_VOC["seconds"])
        wavfile.write(os.path.join(tmp, f"dp{i}.wav"), sr, (wav * 32767).astype(np.int16))
    return tmp


def dp_processes(procs):
    """Wait for {name: Popen}; returns ({name: output}, {name: seconds from
    now to its exit}). A process past TRAIN_DP_TIMEOUT_S is killed."""
    t0, outs, seconds = time.perf_counter(), {}, {}
    pending = dict(procs)
    while pending:
        for name, p in list(pending.items()):
            if p.poll() is not None:
                outs[name] = p.stdout.read()
                seconds[name] = time.perf_counter() - t0
                del pending[name]
        if time.perf_counter() - t0 > TRAIN_DP_TIMEOUT_S:
            for p in pending.values():
                p.kill()
            fail(f"train_dp: {sorted(pending)} ran past {TRAIN_DP_TIMEOUT_S} s")
        time.sleep(0.2)
    return outs, seconds


def train_dp_phase(cfg_of, corpus, tmp, seed, dev):
    """Phase 20 (see the module docstring); returns the launches of a
    data-parallel and of a tensor-parallel rank's train step."""
    import torch

    from speakingstyle_torch.models.factory import build_model, init_weights
    from speakingstyle_torch.parallel import launch

    root = os.path.join(tmp, "train_dp")
    os.makedirs(root, exist_ok=True)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    kernels_kw = dict(TRAIN_PATHS)["kernels"]
    cfg32 = cfg_of(corpus, os.path.join(root, "f32"), seed, compute_dtype="float32",
                   **kernels_kw)
    if cfg32.model.dropout_impl != "hash" or cfg32.train.optimizer.batch_size % TRAIN_DP_RANKS:
        fail(f"train_dp: the config has dropout {cfg32.model.dropout_impl}, batch "
             f"{cfg32.train.optimizer.batch_size}")
    rep = dataclasses.replace
    drill = cfg_of(corpus, os.path.join(root, "drill"), seed, **kernels_kw)
    drill = without_card(rep(drill, train=rep(drill.train, step=rep(drill.train.step,
                                                                    **TRAIN_DP_DRILL_CFG))))
    # the tensor-parallel command: the preset's widths at a cut depth
    tpcmd = cfg_of(corpus, os.path.join(root, "tp_cmd"), seed, **kernels_kw)
    tpcmd = rep(tpcmd, model=rep(tpcmd.model, transformer=rep(
        tpcmd.model.transformer, encoder_layer=TRAIN_TP_CMD_LAYERS,
        decoder_layer=TRAIN_TP_CMD_LAYERS)), train=rep(
        tpcmd.train, step=rep(tpcmd.train.step, **TRAIN_TP_CMD_CFG)))
    tpcmd = without_card(tpcmd)
    weights = os.path.join(root, "weights.pt")
    torch.save(init_weights(build_model(cfg32), seed).state_dict(), weights)
    job = {"device": dev.type, "weights": weights,
           "yamls": config_yamls(cfg32, os.path.join(root, "y32"))}
    job_path = os.path.join(root, "job.json")
    with open(job_path, "w", encoding="utf-8") as fh:
        json.dump(job, fh)
    # every kernel by name: those off this path (the bf16-softmax ones)
    # must stay at 0
    per_step = {k: 0 for k in read_counts()} | dp_per_step(cfg32)

    # the ranks, alone on the card
    t0 = time.perf_counter()
    launch.run_workers([os.path.abspath(__file__), "--train_dp_worker", job_path],
                       TRAIN_DP_RANKS)
    ranks = [torch.load(f"{job_path}.rank{r}.pt", weights_only=False)
             for r in range(TRAIN_DP_RANKS)]
    ranks_s = time.perf_counter() - t0

    # then at once: the train command with --data_parallel 2 and the drill,
    # and the vocoder command with --data_parallel 2; here meanwhile one NCCL
    # rank at world size 1, then (once the train command is done) its dp = 2
    # checkpoint restored at dp = 1 and stepped
    t0 = time.perf_counter()
    pp = cfg32.preprocess.preprocessing
    wav_dir = dp_wavs(os.path.join(root, "wavs"), pp.audio.sampling_rate, seed)
    run = lambda argv, mesh=("--data_parallel", str(TRAIN_DP_RANKS)): subprocess.Popen(  # noqa: E731
        [sys.executable, "-m", "speakingstyle_torch", *argv, "--device", dev.type, *mesh],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    procs = {
        "tp_command": run(["train", *config_yamls(tpcmd, os.path.join(root, "ytp")),
                           "--max_steps", str(TRAIN_TP_CMD_STEPS)],
                          ("--model_parallel", str(TRAIN_TP))),
        "command": run(["train", *config_yamls(drill, os.path.join(root, "ydrill")),
                        "--max_steps", str(TRAIN_DP_DRILL_STEPS), "--faults", TRAIN_DP_DRILL]),
        # no checkpoint path: the GAN state's pure-Python msgpack write
        # (train_vocoder_resilience drills it) is not this check's
        "vocoder": run(["train_vocoder", "--input_wavs_dir", wav_dir, "--checkpoint_path", "",
                        "--batch_size", str(TRAIN_DP_VOC["batch"]),
                        "--training_steps", str(TRAIN_DP_VOC["steps"]), "--log_every", "1",
                        "--save_every", "1000"]),
    }
    try:
        nccl = dp_nccl_rank(drill, weights, dev)
        outs, seconds = dp_processes({"command": procs["command"]})
        if procs["command"].returncode != 0:
            fail(f"train_dp: the train command exited {procs['command'].returncode}: "
                 f"{outs['command'][-3000:]}")
        resume = dp_resume(drill, dev)
        more, more_s = dp_processes({"tp_command": procs["tp_command"]})
        outs.update(more)
        seconds.update({k: seconds["command"] + v for k, v in more_s.items()})
        if procs["tp_command"].returncode != 0:
            fail(f"train_dp: the tensor-parallel command exited "
                 f"{procs['tp_command'].returncode}: {outs['tp_command'][-3000:]}")
        tp_resume = dp_resume(tpcmd, dev, TRAIN_TP_CMD_STEPS)
        t_voc = time.perf_counter() - t0
        more, more_s = dp_processes({"vocoder": procs["vocoder"]})
        outs.update(more)
        seconds.update({k: t_voc + v for k, v in more_s.items()})
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
    wave_s = time.perf_counter() - t0
    if procs["vocoder"].returncode != 0:
        fail(f"train_dp: the vocoder command exited {procs['vocoder'].returncode}: "
             f"{outs['vocoder'][-3000:]}")
    voc_digests = dict(re.findall(r"\[vocoder\] rank (\d+): step \d+, weights_digest (\w+)",
                                  outs["vocoder"]))
    voc_rows = vocoder_log(outs["vocoder"])
    with open(os.path.join(drill.train.path.log_path, "log.txt"), encoding="utf-8") as fh:
        drill_log = fh.read()
    rollbacks = re.findall(r"\[rank (\d)\] \[resilience\] non-finite losses/grads at step 3; "
                           r"rollback 1/3 to checkpoint step 2", outs["command"])

    parity, bad = ranks[0]["judged"]
    for s in range(TRAIN_DP_STEPS):
        if len({r["parity"][s]["digest"] for r in ranks}) != 1:
            bad.append(f"step {s + 1}: the ranks' weights digests differ")
        for r in ranks:
            p = r["parity"][s]
            if not p["finite"] or p["launches"] != per_step:
                bad.append(f"rank {r['rank']} step {s + 1}: finite {p['finite']}, launches "
                           f"{p['launches']}")
    frames = [r["parity"][0]["frames"] for r in ranks]
    if len(set(frames)) == 1:
        bad.append(f"the ranks' first rows hold equal valid frames {frames}")
    for r in ranks:
        t = r.get("traced", {})
        if t.get("credited") != per_step:
            bad.append(f"rank {r['rank']} traced step: credited {t.get('credited')}, want "
                       f"{per_step}")
        if r["backend"] != "gloo":
            bad.append(f"rank {r['rank']}: backend {r['backend']}, want gloo on a shared card")
    if sorted(rollbacks) != ["0", "1"] or drill_log.count("[train] Step 1,") != 1 or \
            "rollback 1/3 to checkpoint step 2" not in drill_log:
        bad.append(f"the drill: rollbacks by rank {rollbacks}, or log.txt has two writers")
    if not (resume["leaves_equal"] and resume["moments_equal"]
            and resume["digest"] == resume["manifest_digest"]
            and resume["step"] == TRAIN_DP_DRILL_STEPS + 1
            and math.isfinite(resume["total_loss"])):
        bad.append(f"the dp = 2 checkpoint at dp = 1: {resume}")
    if not (nccl["backend"] == "nccl" and nccl["grads_equal"] and nccl["params_equal"]
            and nccl["host_sum"] == 1.5 and math.isfinite(nccl["total_loss"])):
        bad.append(f"the NCCL rank: {nccl}")
    if sorted(voc_digests) != ["0", "1"] or len(set(voc_digests.values())) != 1 or sorted(
            voc_rows) != list(range(1, TRAIN_DP_VOC["steps"] + 1)) or not all(
            math.isfinite(v) for row in voc_rows.values() for v in row.values()):
        bad.append(f"the vocoder command: digests {voc_digests}, steps {sorted(voc_rows)}")
    tp_launches = tp_command_launches(tpcmd)
    tp_bad = tp_checks(ranks, per_step, tpcmd, tp_launches, tp_resume, outs["tp_command"])
    emit("train_dp", label=TRAIN_DP_LABEL, ranks=TRAIN_DP_RANKS,
         backend=ranks[0]["backend"], backend_reason=ranks[0]["reason"],
         devices=[r["device"] for r in ranks], batch=cfg32.train.optimizer.batch_size,
         rows_a_rank=cfg32.train.optimizer.batch_size // TRAIN_DP_RANKS,
         first_batch_valid_frames_a_rank=frames, parity=parity,
         total_loss=[r["losses"]["total_loss"] for r in ranks[0]["parity"]],
         digests_equal=[len({r["parity"][s]["digest"] for r in ranks}) == 1
                        for s in range(TRAIN_DP_STEPS)],
         launches_a_step=per_step,
         step_ms_one_process=[p["one_ms"] for p in ranks[0]["parity"]],
         step_ms_a_rank=[[p["ms"] for p in r["parity"]] for r in ranks],
         traced_step=[{k: v for k, v in r.get("traced", {}).items() if k != "credited"}
                      for r in ranks],
         memory_reserved_bytes_a_rank=[r.get("memory_reserved_bytes") for r in ranks],
         command={"argv": f"train --data_parallel {TRAIN_DP_RANKS} --max_steps "
                          f"{TRAIN_DP_DRILL_STEPS} --faults {TRAIN_DP_DRILL}",
                  "rollbacks_by_rank": rollbacks},
         resume_dp1=resume, nccl=nccl,
         vocoder_digests=voc_digests,
         vocoder_mel_l1={s: r.get("mel_l1") for s, r in voc_rows.items()},
         seconds={"ranks": ranks_s, "commands": wave_s, **seconds})
    emit("train_tp", label=TRAIN_DP_LABEL, mesh={"data": 1, "model": TRAIN_TP},
         batch=cfg32.train.optimizer.batch_size, split_leaves=ranks[0].get("tp_split_leaves"),
         parity=ranks[0]["tp_judged"][0],
         total_loss=[p["losses"]["total_loss"] for p in ranks[0]["tp_parity"]],
         digests_equal=[len({r["tp_parity"][s]["digest"] for r in ranks}) == 1
                        for s in range(TRAIN_TP_STEPS)],
         replicated_digests_equal=[len({r["tp_parity"][s]["replicated_digest"]
                                        for r in ranks}) == 1 for s in range(TRAIN_TP_STEPS)],
         launches_a_step=ranks[0]["tp_parity"][-1]["launches"],
         step_ms_one_process=[p["one_ms"] for p in ranks[0]["tp_parity"]],
         step_ms_a_rank=[[p["ms"] for p in r["tp_parity"]] for r in ranks],
         traced_step=[{k: v for k, v in r.get("tp_traced", {}).items() if k != "credited"}
                      for r in ranks],
         memory_reserved_bytes_a_rank=[r.get("tp_memory_reserved_bytes") for r in ranks])
    emit("train_tp_command", argv=f"train --model_parallel {TRAIN_TP} --max_steps "
                                  f"{TRAIN_TP_CMD_STEPS}",
         depth={"encoder_layer": TRAIN_TP_CMD_LAYERS, "decoder_layer": TRAIN_TP_CMD_LAYERS},
         launches=tp_launches, resume_tp1=tp_resume,
         seconds=seconds.get("tp_command"))
    bad += tp_bad
    if bad:
        fail(f"train_dp: {bad}")
    # what the runs counted (equal on every rank and step, checked above):
    # a data-parallel rank step's, a tensor-parallel rank step's
    return ranks[0]["parity"][-1]["launches"], ranks[0]["tp_parity"][-1]["launches"]


def traced_replay(engine, requests):
    """One replayed dispatch under ``torch.profiler``: (results, {device
    busy ms and idle share in the traced window, the port's kernels counted
    by name in the trace, the launches the registry credited}). Fails
    unless the two counts agree."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    reset_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        results = engine.run(requests)
        torch.cuda.synchronize()
    credited = read_counts()
    kernels = [e for e in prof.events()
               if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    window, busy, by_name, ours = device_time("traced replay", kernels)
    in_trace = check_trace("traced replay", by_name, credited)
    return results, {"trace_window_ms": window, "device_busy_ms": busy,
                     "idle_share": 1.0 - busy / window, "device_ops": len(kernels),
                     "port_kernel_ms": ours, "kernels_in_trace": in_trace,
                     "credited": credited}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--train_dp_worker", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.train_dp_worker:  # one rank of the train_dp phase
        sys.path.insert(0, REPO)
        train_dp_worker(args.train_dp_worker)
        return 0

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
    build = timed("build", kernels.build_all)
    emit("env", nvidia_smi=smi, device=torch.cuda.get_device_name(0),
         capability=list(torch.cuda.get_device_capability(0)), torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0],
         build_wall_s=time.perf_counter() - t0, build_s=build,
         ptxas={n: kernels.ptxas_report(n).splitlines() for n in kernels.SOURCES},
         tf32_in_parity_phases=False,
         tf32_in_synthesis_phases={"matmul": torch.backends.cuda.matmul.allow_tf32,
                                   "cudnn": torch.backends.cudnn.allow_tf32})

    cfg = serve_cell(load_config(preset="LJSpeech"))
    requests = make_requests(cfg, args.seed)
    # launches per dispatch of each kernel: 14 attentions, 42 convs
    attn_per = sum(c[-1] for c in attention_cases(cfg))
    conv_per = sum(c[-1] for c in conv_cases(cfg))
    xla_engine, results, _ = timed(
        "synthesize", synthesize_phase, "synthesize", cfg, requests, args.seed, dev,
        {"fused_attention_fwd": attn_per, "fused_attention_fwd_bf16sm": 0,
         "fused_conv1d_fwd": 0})

    lengths = path_lengths(xla_engine, requests, results)
    # the shipped preset's style lattice encodes these references at other
    # shapes than the serve cell's single (4, 1000) dispatch
    shipped = preset_style_dispatches(load_config(preset="LJSpeech"), requests)
    emit("style_dispatches_of_the_preset", dispatches=[
        {"batch": b, "ref": r, "lengths": lens} for b, r, lens in shipped])
    with strict_float32():
        cases = timed("kernels", kernels_phase, cfg, lengths, dev, args.seed, shipped)
        cases.update(timed("bf16_softmax", sm16_serve_cases, cfg, lengths, dev, args.seed))
    bad = [c["case"] for c in cases.values() if not c["ok"]]
    if bad:
        fail(f"kernels disagree with their plain versions: {bad}")
    with strict_float32():
        timed("kernels_nonfinite", nonfinite_phase, load_config(preset="LJSpeech_paper"), dev,
              args.seed)
    # the LJSpeech config under attention_softmax_dtype: bfloat16
    sm16_cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, attention_softmax_dtype="bfloat16"))
    _, _, sm16_counts = timed(
        "synthesize_bf16_softmax", synthesize_phase,
        "synthesize_bf16_softmax", sm16_cfg, requests, args.seed, dev,
        {"fused_attention_fwd": 0, "fused_attention_fwd_bf16sm": attn_per,
         "fused_conv1d_fwd": 0})

    pallas_cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, conv_impl="pallas"))
    engine, _, conv_counts = timed(
        "synthesize_pallas_conv", synthesize_phase,
        "synthesize_pallas_conv", pallas_cfg, requests, args.seed, dev,
        {"fused_attention_fwd": attn_per, "fused_attention_fwd_bf16sm": 0,
         "fused_conv1d_fwd": conv_per})
    with strict_float32():
        bad = timed("acoustic_parity", teacher_forced_parity, cfg, engine, requests, results,
                    dev)
    if bad:
        fail(f"acoustic parity: {bad}")
    timed("profile", lambda: (profile_dispatch("xla", xla_engine, requests),
                              profile_dispatch("pallas", engine, requests)))
    del xla_engine, engine
    serve_launches = timed("serve_core", serve_core_phase, cfg, requests, args.seed, dev,
                           attn_per, conv_per)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_restore_") as restore_tmp:
        step = timed("synthesize_restored", restored_phase, cfg, args.seed, dev, attn_per,
                     restore_tmp)
        http_launches = timed("serve_http", serve_http_phase, restore_tmp, step, args.seed, dev,
                              smi)
        fleet_launches = timed("serve_fleet", serve_fleet_phase, restore_tmp, step, args.seed,
                               dev, smi)
        tiers_launches = timed("serve_tiers", serve_tiers_phase, restore_tmp, step, args.seed,
                               dev, smi)
        cluster_launches = timed("serve_cluster", serve_cluster_phase, restore_tmp, step,
                                 args.seed, dev, smi)
        ring_launches, ring_cases = timed("serve_ring", serve_ring_phase, restore_tmp, step,
                                          args.seed, dev, smi)
    cases.update(ring_cases)
    timed("convert_reference", convert_phase, cfg, args.seed, dev, attn_per, conv_per)
    timed("train_vocoder", vocoder_phase, cfg, args.seed, dev, attn_per)
    train_counts, train_sm16_counts, train_cases, distill_per_step, (
        dp_per_rank_step, tp_per_rank_step) = timed(
        "train", train_phase, train_config, dev, args.seed)
    cases.update(train_cases)
    emit("phase_seconds", phases=PHASE_S, total_s=time.perf_counter() - T0,
         serve_http_s=PHASE_S["serve_http"], serve_fleet_s=PHASE_S["serve_fleet"],
         serve_tiers_s=PHASE_S["serve_tiers"], serve_cluster_s=PHASE_S["serve_cluster"],
         serve_ring_s=PHASE_S["serve_ring"], train_dp_s=PHASE_S["train_dp"])

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
            "distill_launches_per_step": distill_per_step[name],
            # one replayed serve dispatch (CUDA graphs, fresh references),
            # counted by name in its trace
            "serve_launches_per_replay": serve_launches["pallas"][name],
            # the serve_http phase's traffic over HTTP (replayed graphs),
            # counted by name in its trace
            "serve_http_launches": http_launches[name],
            # the serve_fleet phase's steady traffic over both replicas,
            # counted by name in its trace
            "serve_fleet_launches": fleet_launches[name],
            # the serve_tiers phase (gates, traffic, probes, the chapter,
            # the poison drill over three tier fleets), counted by name in
            # its trace
            "serve_tiers_launches": tiers_launches[name],
            # the serve_cluster phase's steady traffic, counted by name in
            # the profile windows of the two replica processes and of this
            # one (the StyleService), each equal to its process's credits
            "serve_cluster_launches": cluster_launches[name],
            # the serve_ring phase's chapter over HTTP (the StyleService's
            # encode of its reference, then one ring-attention free run on
            # rank 0 of 2 processes sharing the card), by the wrappers' counts
            "serve_ring_launches": ring_launches[name],
            # a train step of each data-parallel rank (train_dp: 2 ranks
            # sharing the card over gloo), by the wrappers' counts and, in
            # a traced step, by name in the trace
            "train_dp_launches_per_rank_step": dp_per_rank_step[name],
            # a train step of each tensor-parallel rank (train_tp: the same
            # two processes as dp = 1 x tp = 2), at the local shapes
            "train_tp_launches_per_rank_step": tp_per_rank_step[name],
        })
    print(json.dumps({"kernels": summary}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
