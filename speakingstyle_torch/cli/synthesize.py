"""``synthesize`` command: batch and single-sentence controllable TTS from a
trained checkpoint (JAX counterpart: speakingstyle_tpu/cli/synthesize.py;
reference: synthesize.py:153-292).

The acoustic model comes from ``train.path.ckpt_path`` at
``--restore_step`` (<= 0: the latest): a checkpoint the port's ``train``
wrote, or a reference ``<step>.pth.tar`` turned into one by ``convert``.
The vocoder comes from ``--vocoder_ckpt`` (HiFi-GAN ``generator_*.pth.tar``
or a Flax ``*.generator.msgpack``; MelGAN a saved hub state dict); without
one its weights are drawn from ``--seed``; ``--griffin_lim`` skips it.
Wavs go to ``<train.path.result_path>/<restore_step>/<id>.wav``.

Single mode needs ``--ref_audio`` (the style encoder always needs a
reference mel); its controls take a scalar, or with English text one
factor per word (``--duration_control 1.0,2.5,1.0``). Batch mode reads a
metadata file (``--source``, train.txt format) and each item's
preprocessed mel as its reference, or one ``--ref_audio`` for the whole
batch, encoded once. Requests go through ``SynthesisEngine.run`` in
dispatches of at most the lattice's largest batch.

Runs on ``cuda`` unless ``--device cpu`` is given, and fails rather than
fall back when no card is present.

    python -m speakingstyle_torch synthesize --preset LJSpeech --restore_step 900000 \\
        --mode single --text "hello world" --ref_audio ref.wav
"""

import argparse
import os
import re
from types import SimpleNamespace

import numpy as np

from speakingstyle_torch.cli import add_config_args, config_from_args


def build_parser(parser=None):
    parser = parser or argparse.ArgumentParser(description=__doc__)
    add_config_args(parser)
    parser.add_argument("--restore_step", type=int, required=True,
                        help="checkpoint step under train.path.ckpt_path (<= 0: the latest)")
    parser.add_argument("--mode", choices=["batch", "single"], required=True,
                        help="synthesize a whole metadata file or a single sentence")
    parser.add_argument("--source", default=None,
                        help="metadata file (train.txt / val.txt format), batch mode only")
    parser.add_argument("--text", default=None, help="raw text to synthesize, single mode only")
    parser.add_argument("--ref_audio", default=None,
                        help="reference wav for the speaking style: required in single "
                             "mode; in batch mode it replaces the per-item mels and is "
                             "encoded once for the whole batch")
    parser.add_argument("--speaker_id", default="0",
                        help="numeric id or speaker name from speakers.json (single mode)")
    parser.add_argument("--pitch_control", default="1.0",
                        help="scalar, or comma-separated per-word factors")
    parser.add_argument("--energy_control", default="1.0")
    parser.add_argument("--duration_control", default="1.0",
                        help="scalar (larger = slower), or comma-separated per-word factors")
    parser.add_argument("--vocoder_ckpt", default=None,
                        help="vocoder checkpoint (.pth.tar or .msgpack)")
    parser.add_argument("--griffin_lim", action="store_true",
                        help="skip the neural vocoder; invert mels with Griffin-Lim")
    parser.add_argument("--plot", action="store_true", help="also save mel plots")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the vocoder's weights when no --vocoder_ckpt is given")
    return parser


def _parse_control(spec: str):
    """"1.0" -> a scalar; "1.0,2.5,0.9" -> a per-word list."""
    parts = [float(x) for x in spec.split(",")]
    return parts[0] if len(parts) == 1 else parts


def _control_value(spec, spans):
    """A scalar passes through; a per-word list becomes a per-phoneme array."""
    from speakingstyle_torch.control import expand_word_controls

    if np.isscalar(spec):
        return float(spec)
    if spans is None:
        raise SystemExit("per-word controls need single mode with English text")
    return np.asarray(expand_word_controls(spans, spec), np.float32)


def _single_request(args, cfg, controls):
    from speakingstyle_torch.control import english_word_spans, spans_to_sequence
    from speakingstyle_torch.serving.engine import SynthesisRequest
    from speakingstyle_torch.serving.frontend import TextFrontend, load_ref_mel
    from speakingstyle_torch.text.g2p import preprocess_text, read_lexicon

    pp = cfg.preprocess.preprocessing
    lex_path = cfg.preprocess.path.lexicon_path
    if lex_path and not os.path.exists(lex_path):
        lex_path = ""  # no lexicon shipped: OOV words fall back per text/g2p.py
    spans = None
    if pp.text.language == "en":
        spans = english_word_spans(args.text, read_lexicon(lex_path) if lex_path else {})
        sequence = spans_to_sequence(spans, pp.text.text_cleaners)
        print("Phoneme sequence:", " ".join(p for _, ps in spans for p in ps))
    else:
        sequence = preprocess_text(args.text, pp.text.language, lex_path or None,
                                   list(pp.text.text_cleaners))
    speaker = 0
    if cfg.model.multi_speaker:
        try:
            speaker = TextFrontend(cfg).speaker(args.speaker_id)
        except ValueError as e:
            raise SystemExit(str(e))
    safe_id = re.sub(r"[^\w\-]+", "_", args.text[:100]).strip("_")[:60] or "utt"
    p_c, e_c, d_c = (_control_value(c, spans) for c in controls)
    return SynthesisRequest(
        id=safe_id, sequence=np.asarray(sequence, np.int32),
        ref_mel=load_ref_mel(cfg, args.ref_audio), speaker=speaker, raw_text=args.text,
        p_control=p_c, e_control=e_c, d_control=d_c,
    )


def _batch_requests(args, cfg, engine, controls):
    from speakingstyle_torch.data.dataset import TextBatcher
    from speakingstyle_torch.serving.engine import StyleVectors, SynthesisRequest
    from speakingstyle_torch.serving.frontend import load_ref_mel

    if not all(np.isscalar(c) for c in controls):
        raise SystemExit("per-word controls need single mode with English text")
    shared = None
    if args.ref_audio is not None:
        # one reference styles the whole batch: one encoder pass, and every
        # request carries the same FiLM (gamma, beta)
        film = engine.encode_styles([load_ref_mel(cfg, args.ref_audio)])[0].cpu().numpy()
        shared = StyleVectors(gamma=film[0], beta=film[1])
    ds = TextBatcher(args.source, cfg)
    requests = []
    for i in range(len(ds)):
        item = ds[i]
        if shared is None and item["mel"] is None:
            raise SystemExit(
                f"no reference mel for {item['id']!r}: the style encoder requires one "
                "(pass --ref_audio)"
            )
        requests.append(SynthesisRequest(
            id=item["id"], sequence=item["text"],
            ref_mel=None if shared is not None else item["mel"], style=shared,
            speaker=item["speaker"], raw_text=item["raw_text"],
            p_control=float(controls[0]), e_control=float(controls[1]),
            d_control=float(controls[2]),
        ))
    return requests


def main(args):
    """Synthesize and write the wavs; returns a namespace of the wav
    ``paths``, the ``requests`` and the engine's ``results``, the ``engine``
    and the restored checkpoint's ``info`` ({"step", "weights_digest"})."""
    import torch

    from speakingstyle_torch.device import resolve_device
    from speakingstyle_torch.serving.engine import load_engine
    from speakingstyle_torch.synthesis import render_result

    if args.mode == "batch":
        if args.source is None or args.text is not None:
            raise SystemExit("batch mode takes --source and no --text")
    elif args.text is None or args.source is not None:
        raise SystemExit("single mode takes --text and no --source")
    elif args.ref_audio is None:
        raise SystemExit("--ref_audio is required in single mode: the style encoder "
                         "extracts gamma/beta from a reference mel")

    device = resolve_device(args.device)
    cfg = config_from_args(args)
    engine, info = load_engine(cfg, args.restore_step, vocoder_ckpt=args.vocoder_ckpt,
                               griffin_lim=args.griffin_lim, device=device,
                               vocoder_seed=args.seed + 1)
    controls = [_parse_control(c) for c in
                (args.pitch_control, args.energy_control, args.duration_control)]
    if args.mode == "single":
        requests = [_single_request(args, cfg, controls)]
    else:
        requests = _batch_requests(args, cfg, engine, controls)

    most = engine.lattice.batch_buckets[-1]
    results = []
    for i in range(0, len(requests), most):
        results.extend(engine.run(requests[i:i + most]))
    result_dir = os.path.join(cfg.train.path.result_path, str(args.restore_step))
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    paths = []
    for result in results:
        paths.append(render_result(result, cfg, result_dir, plot=args.plot, device=device))
        print(f"wrote {paths[-1]}: {result.mel_len} frames on {device} ({name}), "
              f"checkpoint step {info['step']}")
    return SimpleNamespace(paths=paths, requests=requests, results=results, engine=engine,
                           info=info)


if __name__ == "__main__":
    main(build_parser().parse_args())
