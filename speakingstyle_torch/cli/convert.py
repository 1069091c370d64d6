"""``convert`` command: PyTorch reference checkpoints -> this package (JAX
counterpart: speakingstyle_tpu/cli/convert.py).

``--kind fastspeech2`` turns an acoustic-model checkpoint (reference
format, train.py:155-165: ``torch.save({"model": ..., "optimizer": ...})``
as ``<step>.pth.tar``) into the port's checkpoint,
``<ckpt_path>/<step>/state.pt`` with its manifest, which ``synthesize
--restore_step <step>`` and ``train --restore_step <step>`` read; the
step is the file name's leading integer unless ``--step`` is given. The
config must describe the checkpoint's model: a missing, extra or
misshapen leaf stops the conversion before anything is written.

``--kind hifigan`` turns a HiFi-GAN ``generator_*.pth.tar`` (reference:
hifigan/models.py:112-174, weight norm folded) into the Flax
generator-only ``*.generator.msgpack`` sidecar that both packages'
``get_vocoder`` read.

    python -m speakingstyle_torch convert --preset LJSpeech --ckpt 900000.pth.tar
    python -m speakingstyle_torch convert --kind hifigan --ckpt generator_LJSpeech.pth.tar
"""

import argparse
import os
import re

from speakingstyle_torch.cli import add_config_args, config_from_args


def build_parser(parser=None):
    parser = parser or argparse.ArgumentParser(description=__doc__)
    add_config_args(parser)
    parser.add_argument("--ckpt", required=True,
                        help="PyTorch checkpoint (<step>.pth.tar or generator_*.pth.tar)")
    parser.add_argument("--kind", choices=("fastspeech2", "hifigan"), default="fastspeech2")
    parser.add_argument("--step", type=int, default=None,
                        help="checkpoint step (default: the file name's leading integer, "
                             "else 0)")
    parser.add_argument("--out", default=None,
                        help="fastspeech2: the checkpoint directory (default "
                             "train.path.ckpt_path); hifigan: the .msgpack path (default "
                             "<ckpt>.generator.msgpack)")
    return parser


def step_from_name(path: str) -> int:
    m = re.match(r"(\d+)", os.path.basename(path))
    return int(m.group(1)) if m else 0


def _convert_hifigan(args) -> str:
    from speakingstyle_torch.compat.flax_msgpack import to_bytes
    from speakingstyle_torch.compat.torch_convert import convert_hifigan, load_torch_state_dict

    params = convert_hifigan(load_torch_state_dict(args.ckpt, key="generator"))
    out = args.out or args.ckpt + ".generator.msgpack"
    with open(out, "wb") as f:
        f.write(to_bytes(params))
    print(f"wrote generator params to {out}")
    return out


def main(args):
    """Returns the written path: the step directory, or the .msgpack file."""
    if args.kind == "hifigan":
        return _convert_hifigan(args)

    from speakingstyle_torch.compat.from_jax import load_flax_variables
    from speakingstyle_torch.compat.torch_convert import (
        convert_fastspeech2, load_torch_state_dict,
    )
    from speakingstyle_torch.training.checkpoint import CheckpointManager
    from speakingstyle_torch.training.trainer import build_state

    cfg = config_from_args(args)
    converted = convert_fastspeech2(load_torch_state_dict(args.ckpt, key="model"))
    state = build_state(cfg, "cpu")
    try:
        load_flax_variables(state.model, converted)
    except ValueError as e:
        raise SystemExit(f"checkpoint/config mismatch: {e}")
    state.step = args.step if args.step is not None else step_from_name(args.ckpt)
    out_dir = args.out or cfg.train.path.ckpt_path
    path = CheckpointManager(out_dir).save(state.step, state)
    print(f"converted {args.ckpt} -> {path}")
    return path


if __name__ == "__main__":
    main(build_parser().parse_args())
