"""Command-line entry points of the port (``python -m speakingstyle_torch
<command>``), with the JAX package's argument surface."""


def add_config_args(parser) -> None:
    """``--preset`` and ``-p``/``-m``/``-t``."""
    parser.add_argument("--preset", default=None,
                        help="preset under speakingstyle_torch/configs/presets (LJSpeech "
                             "when none of -p, -m, -t is given); -p, -m, -t override "
                             "its files")
    parser.add_argument("-p", "--preprocess_config", default=None)
    parser.add_argument("-m", "--model_config", default=None)
    parser.add_argument("-t", "--train_config", default=None)


def config_from_args(args):
    """The config of ``--preset`` and ``-p``/``-m``/``-t`` (each file
    overrides the preset's; LJSpeech when none is given)."""
    from speakingstyle_torch.configs.config import load_config

    given = args.preprocess_config or args.model_config or args.train_config
    return load_config(args.preprocess_config, args.model_config, args.train_config,
                       preset=args.preset or (None if given else "LJSpeech"))
