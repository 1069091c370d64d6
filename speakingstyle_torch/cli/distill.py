"""``distill`` command: train the fast-tier student acoustic model on one
device (JAX counterpart: speakingstyle_tpu/cli/distill.py).

Distills the teacher checkpoint under ``train.path.ckpt_path`` into a
student of halved depth and width (training/distill.py), checkpointing
under ``<ckpt_path>/student``. Runs on ``cuda`` unless ``--device cpu`` is
given, and fails rather than fall back when no card is present.

    python -m speakingstyle_torch distill [--preset P | -p .. -m .. -t ..] \\
        [--max_steps N] [--batch_size B] [--src_len L] [--fresh_teacher] \\
        [--faults SPEC] [--device cpu]
"""

import argparse
import os

from speakingstyle_torch.cli import add_config_args, config_from_args


def build_parser(parser=None):
    parser = parser or argparse.ArgumentParser(description=__doc__)
    add_config_args(parser)
    parser.add_argument("--max_steps", type=int, default=None,
                        help="override total_step for the distill run")
    parser.add_argument("--batch_size", type=int, default=8,
                        help="synthetic distill batch size (the same shape every step)")
    parser.add_argument("--src_len", type=int, default=None,
                        help="phoneme length of the synthetic batches (default: "
                             "min(serve.src_buckets[0], 12))")
    parser.add_argument("--fresh_teacher", action="store_true",
                        help="distill against a seeded fresh teacher even if a checkpoint "
                             "exists (drills: the whole loop without a trained teacher)")
    parser.add_argument("--faults", type=str, default=None,
                        help="fault-injection spec for resilience drills, e.g. "
                             "'nan_grads@120;sigterm@500' (sets SPEAKINGSTYLE_FAULTS; "
                             "grammar in speakingstyle_torch/faults.py; ',' separates too)")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return parser


def main(args):
    from speakingstyle_torch.device import resolve_device
    from speakingstyle_torch.training.distill import fresh_teacher, run_distillation
    from speakingstyle_torch.training.faults import ENV_VAR, FaultPlan

    device = resolve_device(args.device)
    if args.faults:
        spec = args.faults.replace(",", ";")
        FaultPlan.parse(spec)  # validate the spec before training
        os.environ[ENV_VAR] = spec
    cfg = config_from_args(args)
    teacher = fresh_teacher(cfg) if args.fresh_teacher else None
    state, _ = run_distillation(cfg, teacher=teacher, max_steps=args.max_steps,
                                batch_size=args.batch_size, src_len=args.src_len,
                                device=device)
    print(f"distillation finished at step {state.step}")
    return state


if __name__ == "__main__":
    main(build_parser().parse_args())
