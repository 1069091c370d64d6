"""``train`` command: FastSpeech2 training, on one device or data- and
tensor-parallel over rank processes (JAX counterpart:
speakingstyle_tpu/cli/train.py).

Runs on ``cuda`` unless ``--device cpu`` is given, and fails rather than
fall back when no card is present. The weights start from ``train.seed``;
``--restore_step`` resumes from a checkpoint of ``train.path.ckpt_path``.
``--faults`` arms resilience drills (``SPEAKINGSTYLE_FAULTS``), e.g.
``nan_grads@7,loader_ioerror@3`` or ``sigterm@8``.

The mesh resolves as the JAX command's does: ``--data_parallel`` /
``--model_parallel`` first, then the ``train.parallel`` block (``mesh: [dp,
tp]``, ``partition_rules``), then the legacy ``train.sharding``
(``model_axis``; ``data_axis: -1`` = every card not claimed by tp, at least
one). With ``dp x tp > 1`` the command starts that many rank processes of
itself on this host (``parallel/launch.py``; ranks sharing a card use gloo,
else NCCL) and exits with their code; under torchrun, or with
``SPEAKINGSTYLE_MULTIHOST`` set, it trains as the rank the environment
names. A partition rule naming ``data`` (ROADMAP.md queue A item 6d) exits
non-zero naming it. ``seq > 1`` trains on the ``(dp, tp)`` mesh with dense
attention and a rule naming ``seq`` raises the JAX trainer's error, as the
JAX command does (it builds no sequence axis to train on).

    python -m speakingstyle_torch train -p preprocess.yaml -m model.yaml \\
        -t train.yaml [--max_steps N] [--restore_step -1] [--device cpu] \\
        [--data_parallel N] [--model_parallel N] [--faults SPEC] [--deterministic] \\
        [--synth [--vocoder_ckpt PATH]] [--profile_dir DIR] [--profile_at N]
"""

import argparse
import dataclasses
import os
from typing import Tuple


def build_parser(parser=None):
    parser = parser or argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--preset", default=None,
                        help="preset under speakingstyle_torch/configs/presets")
    parser.add_argument("-p", "--preprocess_config", default=None)
    parser.add_argument("-m", "--model_config", default=None)
    parser.add_argument("-t", "--train_config", default=None)
    parser.add_argument("--restore_step", type=int, default=0,
                        help="checkpoint step to resume from (0 = fresh start; -1 = latest)")
    parser.add_argument("--max_steps", type=int, default=None,
                        help="override train.step.total_step")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--data_parallel", type=int, default=None,
                        help="data-parallel ranks (one process each); overrides "
                             "train.parallel.mesh (default: the train.parallel block, "
                             "falling back to the legacy train.sharding derivation)")
    parser.add_argument("--model_parallel", type=int, default=None,
                        help="tensor-parallel ranks over the mesh's model axis (one process "
                             "each); overrides train.parallel.mesh and train.sharding")
    parser.add_argument("--synth", action="store_true",
                        help="render a ground-truth vs predicted sample every synth_step")
    parser.add_argument("--vocoder_ckpt", default=None,
                        help="HiFi-GAN checkpoint for --synth audio (Griffin-Lim otherwise)")
    parser.add_argument("--profile_dir", default=None,
                        help="write a torch.profiler chrome trace of steps 10-20 here")
    parser.add_argument("--profile_at", type=int, default=None,
                        help="trace steps [N, N+10) of this run (relative to the resume "
                             "point) into --profile_dir, by default <log_path>/profile")
    parser.add_argument("--deterministic", action="store_true",
                        help="deterministic algorithms: the same steps repeat bit for bit "
                             "(slower; for reproducible runs and comparisons)")
    parser.add_argument("--faults", default=None,
                        help="fault-injection spec for resilience drills, e.g. "
                             "'nan_grads@120;sigterm@500' (sets SPEAKINGSTYLE_FAULTS; "
                             "grammar in speakingstyle_torch/faults.py; ',' separates too)")
    return parser


def resolve_shape(args, cfg) -> Tuple[int, int]:
    """(dp, tp) of this run (speakingstyle_tpu/cli/train.py:84-115): the
    flags, then ``train.parallel``, then ``train.sharding`` (``data_axis:
    -1`` = the visible devices not claimed by tp, at least 1: the cards, or
    1 on the CPU); exits naming the ROADMAP item for a partition rule
    naming ``data``, and on a batch ``dp`` does not divide, before any rank
    starts."""
    from speakingstyle_torch.configs.config import check_train_supported
    from speakingstyle_torch.parallel.mesh import (
        BatchShardingError, local_batch_size, make_mesh, resolve_mesh, visible_devices,
    )

    par, sh = cfg.train.parallel, cfg.train.sharding
    n_devices = visible_devices(args.device)
    flags_given = args.data_parallel is not None or args.model_parallel is not None
    try:
        check_train_supported(cfg.train, n_devices)
        if not par.is_single() and not flags_given:
            mesh = resolve_mesh(par, n_devices=n_devices)
        else:
            tp = args.model_parallel if args.model_parallel is not None else sh.model_axis
            if args.data_parallel:
                dp = args.data_parallel
            elif sh.data_axis > 0:
                dp = sh.data_axis
            else:
                dp = max(1, n_devices // tp)
            mesh = make_mesh(data=dp, model=tp)
        dp, tp = (mesh.dp, mesh.tp) if mesh is not None else (1, 1)
        if dp * tp > 1:
            local_batch_size(cfg.train.optimizer.batch_size, mesh)
    except (NotImplementedError, BatchShardingError, ValueError) as e:
        raise SystemExit(f"train: {e}") from e
    return dp, tp


def resolve_dp(args, cfg) -> int:
    """The data-parallel ranks of this run (``resolve_shape``'s dp)."""
    return resolve_shape(args, cfg)[0]


def main(args):
    from speakingstyle_torch.configs.config import ParallelConfig, load_config
    from speakingstyle_torch.parallel import launch
    from speakingstyle_torch.training.faults import ENV_VAR, FaultPlan
    from speakingstyle_torch.training.trainer import run_training

    if args.preset is None and not (args.preprocess_config and args.model_config
                                    and args.train_config):
        raise SystemExit("train needs --preset or all of -p, -m and -t")
    if args.deterministic:
        from speakingstyle_torch.device import use_deterministic

        use_deterministic()
    if args.faults:
        spec = args.faults.replace(",", ";")
        FaultPlan.parse(spec)  # validate the spec before training
        os.environ[ENV_VAR] = spec
    cfg = load_config(args.preprocess_config, args.model_config, args.train_config,
                      preset=args.preset)
    dp, tp = resolve_shape(args, cfg)
    try:
        code = launch.launch_if_needed(dp, args.device, getattr(args, "argv", None), tp=tp)
    except launch.WorkerFailed as e:
        raise SystemExit(f"train: {e}") from e
    if code is not None:
        return None
    # this process trains: alone, or as the rank its environment names
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, parallel=ParallelConfig(
            mesh=[dp, tp], seq=cfg.train.parallel.seq,
            partition_rules=cfg.train.parallel.partition_rules)))
    vocoder = None
    if args.synth and args.vocoder_ckpt:
        from speakingstyle_torch.device import resolve_device
        from speakingstyle_torch.synthesis import get_vocoder

        vocoder = get_vocoder(cfg, args.vocoder_ckpt).to(resolve_device(args.device)).eval()
    profile_dir, profile_steps = args.profile_dir, (10, 20)
    if args.profile_at is not None:
        profile_steps = (args.profile_at, args.profile_at + 10)
        profile_dir = profile_dir or os.path.join(cfg.train.path.log_path, "profile")
    try:
        state = run_training(cfg, device=args.device,
                             restore_step=args.restore_step if args.restore_step != 0 else None,
                             max_steps=args.max_steps,
                             synth_callback="default" if args.synth else None, vocoder=vocoder,
                             profile_dir=profile_dir, profile_steps=profile_steps)
    finally:
        if dp * tp > 1:
            from speakingstyle_torch.parallel.mesh import leave_group

            leave_group()
    if int(os.environ.get("RANK", "0")) == 0:
        print(f"training finished at step {state.step}")
    return state


if __name__ == "__main__":
    main(build_parser().parse_args())
