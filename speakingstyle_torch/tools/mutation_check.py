"""Mutation check of the checks that hold the bf16 conv kernel on the card.

    python3 -m speakingstyle_torch.tools.mutation_check

Run from the root of a checkout, on a machine with a CUDA card (as
``chip_smoke.py``). For the sound source and for each deliberately broken
variant of the tensor-core conv kernel (``conv_fwd_mma_kernel`` in
``csrc/fused_conv.cu``), it copies ``chip_smoke.py`` and the package into
``speakingstyle_torch/build/mutants/<variant>/``, applies the change there,
and runs in that copy what ``chip_smoke.py`` holds the kernel to: every
kernel case of the main path (untimed) and the teacher-forced acoustic
comparison. One JSON line per variant gives the kernel cases that fail and
the bf16 acoustic ratio (kernel-conv vs cuDNN-conv distance over cuDNN-conv
vs float32 distance); the smallest broken variant's ratio against the sound
one is the margin of ``chip_smoke.BF16_ACOUSTIC_RATIO``.

Exits 0 only if the sound source passes every check and each broken
variant fails both the kernel cases and the bf16 acoustic comparison.
"""

import json
import os
import shutil
import subprocess
import sys

from speakingstyle_torch.ops.kernels import BUILD_DIR, CSRC_DIR

# variant -> (text of csrc/fused_conv.cu, its replacement); each text
# occurs once, in conv_fwd_mma_kernel
MUTANTS = {
    "none": None,
    # the last tap of every conv is dropped
    "tap": ("    for (int j = 0; j < K; ++j) {\n      if (j > 0) __syncthreads();",
            "    for (int j = 0; j < K - 1; ++j) {\n      if (j > 0) __syncthreads();"),
    # the last 32-channel chunk of the input is dropped
    "chunk": ("for (int ci0 = 0; ci0 < Cin; ci0 += MMA_BK)",
              "for (int ci0 = 0; ci0 + MMA_BK < Cin; ci0 += MMA_BK)"),
    # the LayerNorm variance is taken about 0, not about the mean
    "ln_var": ("const float d = pass == 0 ? v : v - mean[mt][h];", "const float d = v;"),
    # the halo is staged one time step late (16-byte path)
    "halo": ("const int t = t0 - pad_lo + r, ci = ci0 + c;\n        uint4",
             "const int t = t0 - pad_lo + r + 1, ci = ci0 + c;\n        uint4"),
}

# run inside a variant's copy: chip_smoke's kernel cases and acoustic
# comparison, on phase 2's engine and requests
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
with cs.strict_float32():
    cases = cs.kernels_phase(cfg, cs.path_lengths(engine, requests, results), dev, 0)
    parity = cs.teacher_forced_parity(cfg, engine, requests, results, dev)
print(json.dumps({"kernel_cases_failed": [c["case"] for c in cases.values() if not c["ok"]],
                  "parity_failed": parity}))
"""


def mutate(source: str, variant: str) -> str:
    """``source`` with ``variant``'s change applied; raises if its text is
    not in the source exactly once."""
    change = MUTANTS[variant]
    if change is None:
        return source
    old, new = change
    if source.count(old) != 1:
        raise ValueError(f"variant {variant!r}: its text occurs {source.count(old)} times")
    return source.replace(old, new)


def run_variant(repo: str, variant: str) -> dict:
    dst = os.path.join(BUILD_DIR, "mutants", variant)
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(os.path.dirname(CSRC_DIR), os.path.join(dst, "speakingstyle_torch"),
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    shutil.copy(os.path.join(repo, "chip_smoke.py"), dst)
    src = os.path.join(dst, "speakingstyle_torch", "csrc", "fused_conv.cu")
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


def main() -> int:
    import torch

    repo = os.path.dirname(os.path.dirname(CSRC_DIR))
    if not torch.cuda.is_available():
        print("mutation_check: needs a CUDA card", file=sys.stderr)
        return 1
    ok = True
    for variant in MUTANTS:
        row = run_variant(repo, variant)
        failed = (bool(row["kernel_cases_failed"]), bool(row["parity_failed"]))
        row["caught"] = all(failed)
        ok &= not any(failed) if variant == "none" else all(failed)
        print(json.dumps(row), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
