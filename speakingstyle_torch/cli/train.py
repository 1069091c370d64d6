"""``train`` command: FastSpeech2 training on one device (JAX counterpart:
speakingstyle_tpu/cli/train.py).

Runs on ``cuda`` unless ``--device cpu`` is given, and fails rather than
fall back when no card is present. The weights start from ``train.seed``;
``--restore_step`` resumes from a checkpoint of ``train.path.ckpt_path``.

    python -m speakingstyle_torch train -p preprocess.yaml -m model.yaml \\
        -t train.yaml [--max_steps N] [--restore_step -1] [--device cpu]
"""

import argparse


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
    return parser


def main(args):
    from speakingstyle_torch.configs.config import load_config
    from speakingstyle_torch.training.trainer import run_training

    if args.preset is None and not (args.preprocess_config and args.model_config
                                    and args.train_config):
        raise SystemExit("train needs --preset or all of -p, -m and -t")
    cfg = load_config(args.preprocess_config, args.model_config, args.train_config,
                      preset=args.preset)
    state = run_training(cfg, device=args.device,
                         restore_step=args.restore_step if args.restore_step != 0 else None,
                         max_steps=args.max_steps)
    print(f"training finished at step {state.step}")
    return state


if __name__ == "__main__":
    main(build_parser().parse_args())
