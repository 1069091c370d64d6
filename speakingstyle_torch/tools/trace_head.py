"""Repeat ``chip_smoke.py``'s ``serve_tiers`` phase in one process and read
each run's trace for the port kernels it lost.

    python3 -m speakingstyle_torch.tools.trace_head [--runs 8] [--primer N]

Run from the root of a checkout, on a machine with a CUDA card (as
``chip_smoke.py``). It builds the kernels, saves the seeded checkpoint
(``chip_smoke.restored_phase``), then runs ``chip_smoke.serve_tiers_phase``
``--runs`` times with ``chip_smoke.TRACE_PRIMER_KERNELS`` set to
``--primer`` (0: no plain kernels ahead of the traffic). One JSON line a
run: whether the phase's checks held, and its traced graph replays grouped
by correlation id (the kernels of one replay share the id of its launch),
with each replay whose count of port convs differs from the most common
count among the replays of its kind (a kind: the count of port attention
kernels), its rank among the replays and the kernels it lacks. A failed
run leaves its engines behind, so keep ``--runs`` to what the card's
memory holds (about 7 GB a run). The last line counts the failed runs.
"""

import argparse
import collections
import json
import os
import sys
import tempfile


def replays(kernels, trace_kernels):
    """The trace's port kernels grouped by correlation id, in start order:
    [(start us, {kernel name: count})]."""
    groups = collections.defaultdict(list)
    for e in kernels:
        if trace_kernels.search(e.name):
            groups[e.id].append(e)
    order = sorted(groups.values(), key=lambda g: min(e.time_range.start for e in g))
    return [(min(e.time_range.start for e in g), collections.Counter(e.name for e in g))
            for g in order]


def short_replays(groups):
    """Replays with fewer or more convs than the most common count of
    their kind: [{rank, start_us, lacks: {name: n}}]."""
    def split(names):
        conv = sum(n for k, n in names.items() if "conv_fwd" in k)
        return conv, sum(names.values()) - conv

    full = {}
    by_kind = collections.defaultdict(collections.Counter)
    for _, names in groups:
        conv, attn = split(names)
        by_kind[attn][conv] += 1
    for rank, (start, names) in enumerate(groups):
        conv, attn = split(names)
        if conv == by_kind[attn].most_common(1)[0][0]:
            full.setdefault(attn, names)
    out = []
    for rank, (start, names) in enumerate(groups):
        conv, attn = split(names)
        if attn in full and conv != sum(n for k, n in full[attn].items() if "conv_fwd" in k):
            lacks = {k[:120]: n - names.get(k, 0) for k, n in full[attn].items()
                     if n != names.get(k, 0)}
            out.append({"rank": rank, "of": len(groups), "start_us": start, "lacks": lacks})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=8)
    ap.add_argument("--primer", type=int, default=None,
                    help="plain kernels ahead of the traffic (default: chip_smoke's)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as cs
    from speakingstyle_torch.configs.config import load_config
    from speakingstyle_torch.ops import kernels

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: this tool needs a CUDA card")
    if args.primer is not None:
        cs.TRACE_PRIMER_KERNELS = args.primer
    traced = {}
    device_time = cs.device_time

    def keep(what, kernel_events):
        traced["kernels"] = list(kernel_events)
        return device_time(what, kernel_events)

    cs.device_time = keep
    dev = torch.device("cuda", 0)
    smi = cs.nvidia_smi()
    kernels.build_all()
    cfg = cs.serve_cell(load_config(preset="LJSpeech"))
    attn_per = sum(c[-1] for c in cs.attention_cases(cfg))
    failed = 0
    with tempfile.TemporaryDirectory(prefix="trace_head_") as tmp:
        step = cs.restored_phase(cfg, args.seed, dev, attn_per, tmp)
        for i in range(args.runs):
            run_dir = os.path.join(tmp, f"run{i}")
            os.makedirs(run_dir)
            os.symlink(os.path.join(tmp, "ckpt"), os.path.join(run_dir, "ckpt"))
            try:
                cs.serve_tiers_phase(run_dir, step, args.seed, dev, smi)
                held = True
            except SystemExit:
                held = False
                failed += 1
            groups = replays(traced.pop("kernels", []), cs.TRACE_KERNELS)
            print(json.dumps({"trace_head": i, "held": held, "nvidia_smi": smi,
                              "primer_kernels": cs.TRACE_PRIMER_KERNELS,
                              "replays": len(groups), "short": short_replays(groups)}),
                  flush=True)
    print(json.dumps({"trace_head_runs": args.runs, "failed": failed,
                      "primer_kernels": cs.TRACE_PRIMER_KERNELS}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
