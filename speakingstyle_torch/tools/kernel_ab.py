"""Times the bf16 attention forward, attention backward and conv kernels of
one or more copies of the package, in turns, on one CUDA card.

    python3 -m speakingstyle_torch.tools.kernel_ab [DIR ...] [--rounds 2] [--profile]

Each DIR holds a copy of ``speakingstyle_torch`` and ``chip_smoke.py`` (a
checkout, or a copy of an older version of the kernels); with none, the
checkout this module lies in. Each run is a fresh process that imports the
package from its DIR, builds that copy's kernels into the copy's own
``build/``, and prints one JSON line of CUDA-event times (``chip_smoke.time_ms``)
of the cases below. The DIRs run in turns, reversed every other round
(A, B, B, A for two), so that two versions are compared on one card within
one call. ``--profile`` also prints the backward's device time per kernel
(torch.profiler), for the first DIR.
"""

import argparse
import os
import subprocess
import sys

from speakingstyle_torch.ops.kernels import CSRC_DIR

# (B, L, H, D) of the attention backward: the train step's decoder,
# reference encoder and encoder
ATTENTION = [(48, 768, 2, 128), (48, 768, 8, 32), (48, 128, 2, 128)]
# (B, L, H, D, lse, valid lengths) of the attention forward: the train
# step's three (writing the lse the backward reads; lengths drawn from
# 0.8 L .. L), and the serve decoder at phase 2's mel lengths
ATTENTION_FWD = [(48, 768, 2, 128, True, None), (48, 768, 8, 32, True, None),
                 (48, 128, 2, 128, True, None), (4, 1000, 2, 128, False, [42, 156, 229, 331])]
# (B, T, K, Cin, Cout, relu, ln) of the conv: the serve and train LN convs,
# and the train step's other heavy ones
CONV = [(4, 1000, 3, 1024, 1024, True, True), (48, 768, 3, 1024, 1024, True, True),
        (48, 768, 9, 256, 1024, True, False), (48, 768, 1, 1024, 256, False, False),
        (48, 768, 5, 512, 512, False, False), (48, 768, 3, 1024, 256, False, False),
        (4, 128, 1, 1024, 256, False, False)]

_CHILD = """
import json, os, re, sys
import torch
import chip_smoke as cs
from speakingstyle_torch.ops import fused_attention as A, fused_conv as C

assert os.path.realpath(A.__file__).startswith(os.path.realpath(os.getcwd())), A.__file__
dev = torch.device("cuda")
g = torch.Generator().manual_seed(0)
res, prof = {}, {}
for (B, L, H, D, want_lse, lens) in ATTENTION_FWD:
    q, k, v = (torch.randn((B, L, H, D), generator=g).to(dev, torch.bfloat16) for _ in range(3))
    lens = torch.randint(L * 8 // 10, L + 1, (B,), generator=g) if lens is None else torch.tensor(lens)
    mask = (torch.arange(L)[None] >= lens[:, None]).to(dev)
    res[f"fwd_{B}_{L}_{H}_{D}"] = cs.time_ms(
        lambda: A.fused_mha_fwd(q, k, v, mask, D ** -0.5, want_lse=want_lse))
for (B, L, H, D) in ATTENTION:
    q, k, v, do = (torch.randn((B, L, H, D), generator=g).to(dev, torch.bfloat16) for _ in range(4))
    lens = torch.randint(L * 8 // 10, L + 1, (B,), generator=g)
    mask = (torch.arange(L)[None] >= lens[:, None]).to(dev)
    out, lse = A.fused_mha_fwd(q, k, v, mask, D ** -0.5, want_lse=True)
    run = lambda: A.fused_mha_bwd(q, k, v, mask, out, lse, do, D ** -0.5)
    res[f"bwd_{L}_{H}_{D}"] = cs.time_ms(run)
    if PROFILE:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as p:
            for _ in range(10):
                run()
            torch.cuda.synchronize()
        by = {}
        for e in p.events():
            if e.device_type == DeviceType.CUDA:
                m = re.search(r"::(\\w+)", e.name)
                n = m.group(1) if m else e.name[:40]
                by[n] = by.get(n, 0.0) + e.time_range.elapsed_us() / 1e3 / 10
        prof[f"bwd_{L}_{H}_{D}"] = by
for (B, T, K, cin, cout, relu, ln) in CONV:
    x = torch.randn((B, T, cin), generator=g).to(dev, torch.bfloat16)
    w = (torch.randn((K, cin, cout), generator=g) / (K * cin) ** 0.5).to(dev, torch.bfloat16)
    b, s, sb = (torch.randn(cout, generator=g).to(dev, torch.bfloat16) for _ in range(3))
    run = (lambda: C.fused_conv_relu_ln(x, w, b, s, sb)) if ln else (lambda: C.fused_conv1d(x, w, b, relu=relu))
    res[f"conv_{B}_{T}_{K}_{cin}_{cout}_{int(ln)}"] = cs.time_ms(run)
print(json.dumps({"dir": TAG, "ms": res, **({"profile_ms": prof} if PROFILE else {})}), flush=True)
"""


def child_code(path: str, profile: bool) -> str:
    """The program one run executes in ``path``: the cases, then _CHILD."""
    return (f"ATTENTION = {ATTENTION!r}\nATTENTION_FWD = {ATTENTION_FWD!r}\nCONV = {CONV!r}\n"
            f"PROFILE = {profile!r}\nTAG = {path!r}\n" + _CHILD)


def run_dir(path: str, profile: bool) -> str:
    code = child_code(path, profile)
    env = dict(os.environ, PYTHONPATH=path)
    out = subprocess.run([sys.executable, "-c", code], cwd=path, env=env,
                         capture_output=True, text=True, timeout=900)
    if out.returncode != 0:
        raise RuntimeError(f"{path} exited {out.returncode}:\n{out.stderr[-4000:]}")
    return out.stdout.strip().splitlines()[-1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("dirs", nargs="*")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args(argv)
    dirs = [os.path.abspath(d) for d in args.dirs] or [os.path.dirname(os.path.dirname(CSRC_DIR))]
    for r in range(args.rounds):
        for d in dirs if r % 2 == 0 else dirs[::-1]:
            print(run_dir(d, args.profile and r == 0 and d == dirs[0]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
