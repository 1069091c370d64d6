"""``train_vocoder`` command: HiFi-GAN GAN training, on one device or
data-parallel over rank processes (JAX counterpart:
speakingstyle_tpu/cli/train_vocoder.py; reference: hifigan/train.py:226-267,
with the discriminators its vendored copy lacks).

Runs on ``cuda`` unless ``--device cpu`` is given, and fails rather than
fall back when no card is present. Checkpoints are the JAX package's
``vocoder_<step>.msgpack`` (the whole GAN state) and
``.generator.msgpack`` (for ``synthesize --vocoder_ckpt`` and ``vocode``).
``--data_parallel N`` (N > 1) starts N rank processes of the command on
this host (``parallel/launch.py``), each taking its rows of the global
``--batch_size``; under torchrun it trains as the environment's rank.

    python -m speakingstyle_torch train_vocoder [--preset P | -p .. -m .. -t ..] \\
        --input_wavs_dir WAVS [--checkpoint_path DIR] [--training_steps N] \\
        [--batch_size B] [--restore FILE] [--warm_start FILE] [--device cpu] \\
        [--learning_rate LR] [--log_every N] [--save_every N] [--data_parallel N]
"""

import argparse

from speakingstyle_torch.cli import add_config_args, config_from_args


def build_parser(parser=None):
    parser = parser or argparse.ArgumentParser(description=__doc__)
    add_config_args(parser)
    parser.add_argument("--input_wavs_dir", type=str, required=True,
                        help="directory tree of training wavs")
    parser.add_argument("--checkpoint_path", type=str, default="./output/vocoder")
    parser.add_argument("--training_steps", type=int, default=400000)
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--fine_tune_mel_dir", type=str, default=None,
                        help="acoustic-model mel dir: fine-tune on predicted mels")
    parser.add_argument("--warm_start", type=str, default=None,
                        help="generator checkpoint (.pth.tar or .msgpack) to fine-tune from")
    parser.add_argument("--restore", type=str, default=None,
                        help="full-state vocoder checkpoint (.msgpack) to resume from")
    parser.add_argument("--data_parallel", type=int, default=None,
                        help="data-parallel ranks, one process each (the global "
                             "--batch_size is split over them)")
    parser.add_argument("--learning_rate", type=float, default=2e-4)
    parser.add_argument("--log_every", type=int, default=100)
    parser.add_argument("--save_every", type=int, default=1000)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return parser


def main(args):
    from speakingstyle_torch.compat.from_jax import to_flax_tree
    from speakingstyle_torch.data.mel_dataset import scan_wavs
    from speakingstyle_torch.device import resolve_device
    from speakingstyle_torch.synthesis import get_vocoder
    from speakingstyle_torch.parallel import launch
    from speakingstyle_torch.parallel.mesh import (
        BatchShardingError, init_distributed, leave_group, local_batch_size, make_mesh,
    )
    from speakingstyle_torch.training.vocoder_trainer import VocoderHParams, train_vocoder

    dp = args.data_parallel or 1
    if dp > 1:
        try:
            local_batch_size(args.batch_size, make_mesh(data=dp))
        except BatchShardingError as e:
            raise SystemExit(f"train_vocoder: {e}") from e
        try:
            if launch.launch_if_needed(dp, args.device, getattr(args, "argv", None)) is not None:
                return None
        except launch.WorkerFailed as e:
            raise SystemExit(f"train_vocoder: {e}") from e
    mesh = init_distributed(args.device, dp=dp) if dp > 1 else None
    device = mesh.device if mesh is not None else resolve_device(args.device)
    cfg = config_from_args(args)
    gen_params = None
    if args.warm_start:
        gen_params = to_flax_tree(get_vocoder(cfg, args.warm_start))["params"]
    wavs = scan_wavs(args.input_wavs_dir)
    main_rank = mesh is None or mesh.is_main
    if main_rank:
        print(f"training vocoder on {len(wavs)} wavs")
    hp = VocoderHParams(learning_rate=args.learning_rate)
    try:
        state, _ = train_vocoder(cfg, wavs, hp=hp, max_steps=args.training_steps,
                                 batch_size=args.batch_size, ckpt_path=args.checkpoint_path,
                                 save_every=args.save_every, log_every=args.log_every,
                                 fine_tune_mel_dir=args.fine_tune_mel_dir,
                                 gen_params=gen_params, restore_path=args.restore,
                                 device=device, mesh=mesh)
    finally:
        if mesh is not None:
            leave_group()
    if main_rank:
        print(f"vocoder training finished at step {state.step}")
    return state


if __name__ == "__main__":
    main(build_parser().parse_args())
