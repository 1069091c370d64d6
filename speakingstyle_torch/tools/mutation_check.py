"""Mutation check of the checks that hold the bf16 tensor-core kernels on
the card: the conv (``conv_fwd_mma_kernel`` in ``csrc/fused_conv.cu``), the
attention forward (``attn_fwd_mma_kernel`` in ``csrc/fused_attention.cu``)
and the rounding points of the attention kernels' bf16 softmax, forward
and backward.

    python3 -m speakingstyle_torch.tools.mutation_check [variant ...]

Run from the root of a checkout, on a machine with a CUDA card (as
``chip_smoke.py``). For the sound source and for each deliberately broken
variant of one of those kernels, it copies ``chip_smoke.py`` and the
package into ``speakingstyle_torch/build/mutants/<variant>/``, applies the
change there, and runs in that copy what ``chip_smoke.py`` holds the
kernels to: every kernel case of the serve path (untimed), the
bf16-softmax forward cases at the same shapes, the attention backward at
those shapes (it reads the forward's lse) in bfloat16 under either
softmax and in float32 under the bf16 softmax, the non-finite input cases
(``nonfinite_cases``), and the teacher-forced acoustic comparison. One JSON line per variant gives the kernel cases
that fail, each bf16-softmax backward case's error over its bound, and the
bf16 acoustic ratio (kernel-conv vs cuDNN-conv distance over cuDNN-conv
vs float32 distance); the smallest
broken conv variant's ratio against the sound one is the margin of
``chip_smoke.BF16_ACOUSTIC_RATIO``.

Exits 0 only if the sound source passes every check and each broken
variant fails the kernel cases, a conv variant the bf16 acoustic
comparison too (both sides of that comparison run the same attention
kernels, so it cannot see an attention variant), but for a variant that
changes nothing on finite inputs (``NONFINITE_ONLY``).
"""

import json
import os
import shutil
import subprocess
import sys

from speakingstyle_torch.ops.kernels import BUILD_DIR, CSRC_DIR

CONV, ATTENTION = "fused_conv.cu", "fused_attention.cu"
SOURCES = (CONV, ATTENTION)
# variant -> (source in csrc/, a text of it, its replacement); each text
# occurs once in its source (in conv_fwd_mma_kernel, attn_fwd_mma_kernel or
# the bf16 softmax's rounding) and nowhere in the other
MUTANTS = {
    "none": None,
    # the last tap of every conv is dropped (its weight tiles staged as zeros)
    "tap": (CONV, "const int w_rows = min(CONV_BK, Cin - ci0);",
            "const int w_rows = j == K - 1 ? 0 : min(CONV_BK, Cin - ci0);"),
    # the last 64-channel chunk of the input is dropped
    "chunk": (CONV, "const int n_chunks = (Cin + CONV_BK - 1) / CONV_BK;",
              "const int n_chunks = (Cin - 1) / CONV_BK;"),
    # the LayerNorm variance is taken about 0, not about the mean
    "ln_var": (CONV, "const float d = pass == 0 ? v : v - mean[mt][h];", "const float d = v;"),
    # the input halo is staged one time step late
    "halo": (CONV, "const int t = t0 - pad_lo + r;", "const int t = t0 - pad_lo + r + 1;"),
    # the LayerNorm sums are taken from the cluster's first block only
    "cluster": (CONV, "for (int rank = 0; rank < ncl; ++rank)",
                "for (int rank = 0; rank < 1; ++rank)"),
    # the forward's O accumulator is not rescaled when a row's max moves
    "fwd_rescale": (ATTENTION, "o[nt][i] *= alpha[i >> 1];", "o[nt][i] *= 1.f;"),
    # the forward skips its last key tile
    "fwd_last_tile": (ATTENTION, "const int n_tiles = (k_end + F_NS - 1) / F_NS;",
                      "const int n_tiles = (k_end - 1) / F_NS;"),
    # the forward writes lse without log(l)
    "fwd_lse": (ATTENTION, "m2[hh] * LN2 + logf(l[hh]);", "m2[hh] * LN2;"),
    # keys past L in the last tile get the padding bias instead of -inf, so
    # a fully padded row also attends over the tile's zero-filled tail
    "fwd_tail_bias": (ATTENTION, "kj >= L ? -INFINITY :", "kj >= L ? NEG2 :"),
    # the bf16 softmax does not round the scores (nor, in the backward, P)
    "sm16_no_round": (ATTENTION, "return __bfloat162float(__float2bfloat16_rn(x));",
                      "return x;"),
    # the bf16 forward rounds each score in log2 units, after the log2(e)
    "sm16_log2": (ATTENTION,
                  "x = round_bf16(fmaf(sc[nt][2 * hh + e], sm_scale, bias_e)) * LOG2E;",
                  "x = round_bf16(fmaf(sc[nt][2 * hh + e], scale2, bias));"),
    # the backward alone, bf16 (tensor-core) passes: the dK/dV pass does not
    # round S, the dQ pass does not round S, the dK/dV pass takes dS from
    # the unrounded P (its dV still rounds P for the product)
    "sm16_bwd_dkdv_s": (ATTENTION,
                        "round_bf16(fmaf(st[nt][i], sm_scale, key_bias[hh])) * LOG2E",
                        "fmaf(st[nt][i], sm_scale, key_bias[hh]) * LOG2E"),
    "sm16_bwd_dq_s": (ATTENTION,
                      "round_bf16(fmaf(sc[nt][i], sm_scale, mb[kj] ? NEG : 0.f)) * LOG2E",
                      "fmaf(sc[nt][i], sm_scale, mb[kj] ? NEG : 0.f) * LOG2E"),
    "sm16_bwd_p_ds": (ATTENTION, "pv = round_bf16(pv);  // dS from the bf16 P too",
                      "pv = pv;  // dS from the bf16 P too"),
    # the backward alone, float32 (CUDA-core) passes, which share one P
    # tile: S not rounded; P not rounded (dV and dS)
    "sm16_bwd_f32_s": (ATTENTION,
                       "p[i][j] = expf(round_bf16(s[i][j] * sm_scale + bias) - row_lse[ty + 16 * i]);",
                       "p[i][j] = expf(s[i][j] * sm_scale + bias - row_lse[ty + 16 * i]);"),
    "sm16_bwd_f32_p": (ATTENTION, "if constexpr (SM16) p[i][j] = round_bf16(p[i][j]);",
                       "if constexpr (SM16) p[i][j] = p[i][j];"),
    # the bf16 conv's ReLU as fmaxf, which maps NaN to 0 (as it was before
    # the select): visible only on non-finite inputs
    "relu_fmaxf": (CONV, "          if (relu) v = v < 0.f ? 0.f : v;",
                   "          if (relu) v = fmaxf(v, 0.f);"),
}
# variants that change nothing on finite inputs: the non-finite cases alone
# must catch them (the acoustic comparison cannot)
NONFINITE_ONLY = {"relu_fmaxf"}

# run inside a variant's copy: chip_smoke's kernel cases, the attention
# backward at the same shapes, and the acoustic comparison, on phase 2's
# engine and requests
_CHILD = """
import json
import torch
import chip_smoke as cs
from speakingstyle_torch.configs.config import load_config

cs.time_ms = lambda fn, **kw: 0.0
dev = torch.device("cuda", 0)
cfg = load_config(preset="LJSpeech")
requests = cs.make_requests(cfg, 0)
engine = cs.build_engine(cfg, 0, dev)
results = engine.run(requests)
lengths = cs.path_lengths(engine, requests, results)
with cs.strict_float32():
    cases = cs.kernels_phase(cfg, lengths, dev, 0)
    cases.update(cs.sm16_serve_cases(cfg, lengths, dev, 0))
    g = torch.Generator().manual_seed(1)
    for name, axis, H, D, _ in cs.attention_cases(cfg):
        B, L, lens = lengths[axis]
        for dtype, softmax in ((torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16),
                               (torch.bfloat16, torch.bfloat16)):
            for c in cs.attention_bwd_case(name, B, L, H, D, lens, dtype, g, dev, softmax):
                cases[c["case"]] = c
    for c in cs.nonfinite_cases(load_config(preset="LJSpeech_paper"), dev, 0):
        cases[c["case"]] = c
    parity = cs.teacher_forced_parity(cfg, engine, requests, results, dev)
print(json.dumps({"kernel_cases_failed": [c["case"] for c in cases.values() if not c["ok"]],
                  "sm16_bwd_err_over_bound": {c["case"]: max(c["err_over_bound"])
                                              for c in cases.values() if "err_over_bound" in c},
                  "parity_failed": parity}))
"""


def mutate(source: str, variant: str) -> str:
    """``source`` with ``variant``'s change applied; raises if its text is
    not in the source exactly once."""
    change = MUTANTS[variant]
    if change is None:
        return source
    _, old, new = change
    if source.count(old) != 1:
        raise ValueError(f"variant {variant!r}: its text occurs {source.count(old)} times")
    return source.replace(old, new)


def run_variant(repo: str, variant: str) -> dict:
    dst = os.path.join(BUILD_DIR, "mutants", variant)
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(os.path.dirname(CSRC_DIR), os.path.join(dst, "speakingstyle_torch"),
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    shutil.copy(os.path.join(repo, "chip_smoke.py"), dst)
    if MUTANTS[variant] is not None:
        src = os.path.join(dst, "speakingstyle_torch", "csrc", MUTANTS[variant][0])
        with open(src) as f:
            text = mutate(f.read(), variant)
        with open(src, "w") as f:
            f.write(text)
    env = dict(os.environ, PYTHONPATH=dst)
    out = subprocess.run([sys.executable, "-c", _CHILD], cwd=dst, env=env,
                         capture_output=True, text=True, timeout=900)
    lines = [json.loads(l) for l in out.stdout.splitlines() if l.startswith("{")]
    if out.returncode != 0 or not lines:
        raise RuntimeError(f"variant {variant!r} exited {out.returncode}:\n{out.stderr[-4000:]}")
    bf16 = next(l for l in lines if l.get("phase") == "acoustic_parity_bf16")
    return {"variant": variant, "bf16_ratio": bf16["ratio"],
            "bf16_kernels_vs_cudnn_conv_max_abs_err": bf16["kernels_vs_cudnn_conv_max_abs_err"],
            "bf16_cudnn_conv_vs_f32_max_abs_err": bf16["cudnn_conv_vs_f32_max_abs_err"],
            **lines[-1]}


def main(argv=None) -> int:
    """Every variant, or those named in ``argv`` (the sound source always
    runs first)."""
    import torch

    names = sys.argv[1:] if argv is None else argv
    unknown = sorted(set(names) - set(MUTANTS))
    if unknown:
        print(f"mutation_check: unknown variants {unknown}; known: {list(MUTANTS)}",
              file=sys.stderr)
        return 2
    names = ["none"] + [n for n in (names or MUTANTS) if n != "none"]
    repo = os.path.dirname(os.path.dirname(CSRC_DIR))
    if not torch.cuda.is_available():
        print("mutation_check: needs a CUDA card", file=sys.stderr)
        return 1
    ok = True
    for variant in names:
        change = MUTANTS[variant]
        row = run_variant(repo, variant)
        failed = (bool(row["kernel_cases_failed"]), bool(row["parity_failed"]))
        if change is None:
            ok &= not any(failed)
        else:
            row["caught"] = failed[0] and (failed[1] or change[0] != CONV
                                           or variant in NONFINITE_ONLY)
            ok &= row["caught"]
        print(json.dumps(row), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
