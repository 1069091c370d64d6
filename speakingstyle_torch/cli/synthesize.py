"""``synthesize`` command: one sentence, text + reference wav -> wav file
(JAX counterpart: speakingstyle_tpu/cli/synthesize.py, single mode).

No trained weights are in the repository yet, so the acoustic model and
the HiFi-GAN generator are drawn from ``--seed``. The command runs on
``cuda`` unless ``--device cpu`` is given, and fails rather than fall back
when no card is present.

    python -m speakingstyle_torch synthesize --preset LJSpeech \\
        --text "hello world" --ref_audio ref.wav --out_dir out/
"""

import argparse
import os
import re

import numpy as np


def build_parser(parser=None):
    parser = parser or argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--preset", default="LJSpeech",
                        help="preset under speakingstyle_torch/configs/presets")
    parser.add_argument("-p", "--preprocess_config", default=None)
    parser.add_argument("-m", "--model_config", default=None)
    parser.add_argument("-t", "--train_config", default=None)
    parser.add_argument("--text", required=True, help="raw text to synthesize")
    parser.add_argument("--ref_audio", required=True,
                        help="reference wav for the speaking style")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the random acoustic-model and vocoder weights")
    parser.add_argument("--pitch_control", default="1.0",
                        help="scalar, or comma-separated per-word factors")
    parser.add_argument("--energy_control", default="1.0")
    parser.add_argument("--duration_control", default="1.0",
                        help="scalar (larger = slower), or comma-separated per-word factors")
    parser.add_argument("--out_dir", default="output/result")
    return parser


def _parse_control(spec: str, spans):
    from speakingstyle_torch.control import expand_word_controls

    parts = [float(x) for x in spec.split(",")]
    if len(parts) == 1:
        return parts[0]
    if spans is None:
        raise SystemExit("per-word controls need English text")
    return np.asarray(expand_word_controls(spans, parts), np.float32)


def main(args):
    import torch

    from speakingstyle_torch.audio.tools import load_wav, write_wav_int16
    from speakingstyle_torch.configs.config import load_config
    from speakingstyle_torch.control import english_word_spans, spans_to_sequence
    from speakingstyle_torch.device import resolve_device
    from speakingstyle_torch.models.factory import init_weights
    from speakingstyle_torch.models.hifigan import (
        DEFAULT_HIFIGAN_CONFIG, generator_from_config,
    )
    from speakingstyle_torch.serving.engine import SynthesisEngine, SynthesisRequest
    from speakingstyle_torch.serving.style import mel_from_wav_array
    from speakingstyle_torch.text.g2p import preprocess_text, read_lexicon

    device = resolve_device(args.device)
    cfg = load_config(args.preprocess_config, args.model_config, args.train_config,
                      preset=None if args.model_config else args.preset)
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
    wav, _ = load_wav(args.ref_audio, target_sr=pp.audio.sampling_rate)

    vocoder = generator_from_config(DEFAULT_HIFIGAN_CONFIG, pp.mel.n_mel_channels)
    engine = SynthesisEngine(cfg, vocoder=init_weights(vocoder, args.seed + 1),
                             device=device, seed=args.seed)
    safe_id = re.sub(r"[^\w\-]+", "_", args.text[:100]).strip("_")[:60] or "utt"
    request = SynthesisRequest(
        id=safe_id, sequence=np.asarray(sequence, np.int32),
        ref_mel=mel_from_wav_array(cfg, wav), raw_text=args.text,
        p_control=_parse_control(args.pitch_control, spans),
        e_control=_parse_control(args.energy_control, spans),
        d_control=_parse_control(args.duration_control, spans),
    )
    result = engine.run([request])[0]
    os.makedirs(args.out_dir, exist_ok=True)
    path = os.path.join(args.out_dir, f"{result.id}.wav")
    write_wav_int16(path, result.wav, pp.audio.sampling_rate)
    print(f"wrote {path}: {result.mel_len} frames, {len(result.wav)} samples "
          f"on {device} ({torch.cuda.get_device_name(device) if device.type == 'cuda' else 'cpu'})")
    return path


if __name__ == "__main__":
    main(build_parser().parse_args())
