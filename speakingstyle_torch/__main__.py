"""``python -m speakingstyle_torch <command>`` dispatcher."""

import argparse
import importlib
import sys

COMMANDS = ("synthesize", "serve", "replica", "train", "convert", "train_vocoder", "distill",
            "vocode")


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    parser = argparse.ArgumentParser(prog="speakingstyle-torch")
    sub = parser.add_subparsers(dest="command", required=True)
    modules = {}
    for name in COMMANDS:
        mod = importlib.import_module(f"speakingstyle_torch.cli.{name}")
        modules[name] = mod
        mod.build_parser(sub.add_parser(name, help=mod.__doc__.splitlines()[0]))
    args = parser.parse_args(argv)
    # the command line again, for a command that starts copies of itself
    # (train --data_parallel N)
    args.argv = ["-m", "speakingstyle_torch", *argv]
    return modules[args.command].main(args)


if __name__ == "__main__":
    main()
