"""``vocode`` command: HiFi-GAN (or MelGAN) inference without the acoustic
model (JAX counterpart: speakingstyle_tpu/cli/vocode.py).

* mel ``.npy`` dir -> wav (reference: hifigan/inference_e2e.py:36-62)
* wav dir -> mel -> wav resynthesis (reference: hifigan/inference.py:37-68)

A mel may be [T, n_mels] (the preprocessed layout) or [n_mels, T] (the
reference trainer's), told apart by its shape. Each is right-padded with
the log-mel floor to a multiple of PAD_FRAMES frames, vocoded, and trimmed
to T * hop samples. Runs on ``cuda`` unless ``--device cpu`` is given.

    python -m speakingstyle_torch vocode (--input_mels_dir D | --input_wavs_dir D) \\
        --checkpoint_file G.generator.msgpack [--output_dir OUT] [--device cpu]
"""

import argparse
import os

import numpy as np

from speakingstyle_torch.cli import add_config_args, config_from_args

PAD_FRAMES = 64
LOG_MEL_FLOOR = float(np.log(1e-5))  # dynamic_range_compression's clip floor


def build_parser(parser=None):
    parser = parser or argparse.ArgumentParser(description=__doc__)
    add_config_args(parser)
    src = parser.add_mutually_exclusive_group(required=True)
    src.add_argument("--input_mels_dir", type=str, default=None,
                     help="directory of mel .npy files to vocode")
    src.add_argument("--input_wavs_dir", type=str, default=None,
                     help="directory of .wav files to resynthesize (wav -> mel -> wav)")
    parser.add_argument("--output_dir", type=str, default="generated_files",
                        help="where the generated wavs go")
    parser.add_argument("--checkpoint_file", type=str, required=True,
                        help="HiFi-GAN generator: torch generator_*.pth.tar or a "
                             "*.generator.msgpack")
    parser.add_argument("--hifigan_config", type=str, default=None,
                        help="generator config.json (default: the LJSpeech V1 architecture)")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return parser


def _load_mel(path: str, n_mels: int) -> np.ndarray:
    """.npy -> [T, n_mels], accepting either orientation."""
    mel = np.load(path).astype(np.float32)
    if mel.ndim != 2:
        raise ValueError(f"{path}: expected 2-D mel, got shape {mel.shape}")
    if mel.shape[0] == n_mels and mel.shape[1] != n_mels:
        mel = mel.T
    return mel


def _vocode_one(gen, mel: np.ndarray, max_wav_value: float, device) -> np.ndarray:
    """[T, n_mels] -> int16 wav of T * hop samples, T padded to a bucket first."""
    import torch

    from speakingstyle_torch.models.hifigan import vocoder_infer

    T = mel.shape[0]
    pad_to = -(-T // PAD_FRAMES) * PAD_FRAMES
    mel = np.pad(mel, ((0, pad_to - T), (0, 0)), constant_values=LOG_MEL_FLOOR)
    mels = torch.from_numpy(np.ascontiguousarray(mel[None], np.float32)).to(device)
    return vocoder_infer(gen, mels, lengths=[T], max_wav_value=max_wav_value)[0]


def main(args):
    import scipy.io.wavfile

    from speakingstyle_torch.device import resolve_device
    from speakingstyle_torch.synthesis import get_vocoder

    device = resolve_device(args.device)
    cfg = config_from_args(args)
    pp = cfg.preprocess.preprocessing
    audio_cfg, n_mels = pp.audio, pp.mel.n_mel_channels
    gen = get_vocoder(cfg, args.checkpoint_file, config_path=args.hifigan_config)
    gen = gen.to(device).eval()
    os.makedirs(args.output_dir, exist_ok=True)

    written = []
    if args.input_mels_dir:
        names = sorted(f for f in os.listdir(args.input_mels_dir) if f.endswith(".npy"))
        for name in names:
            mel = _load_mel(os.path.join(args.input_mels_dir, name), n_mels)
            wav = _vocode_one(gen, mel, audio_cfg.max_wav_value, device)
            out = os.path.join(args.output_dir, os.path.splitext(name)[0] + "_generated_e2e.wav")
            scipy.io.wavfile.write(out, audio_cfg.sampling_rate, wav)
            print(out)
            written.append(out)
    else:
        from speakingstyle_torch.audio.stft import MelExtractor, get_mel_from_wav
        from speakingstyle_torch.audio.tools import load_wav

        extractor = MelExtractor(
            filter_length=pp.stft.filter_length, hop_length=pp.stft.hop_length,
            win_length=pp.stft.win_length, n_mel_channels=n_mels,
            sampling_rate=audio_cfg.sampling_rate, mel_fmin=pp.mel.mel_fmin,
            mel_fmax=pp.mel.mel_fmax)
        names = sorted(f for f in os.listdir(args.input_wavs_dir) if f.endswith(".wav"))
        for name in names:
            audio, _ = load_wav(os.path.join(args.input_wavs_dir, name),
                                target_sr=audio_cfg.sampling_rate)
            mel, _ = get_mel_from_wav(audio, extractor)  # [n_mels, T]
            wav = _vocode_one(gen, mel.T, audio_cfg.max_wav_value, device)
            out = os.path.join(args.output_dir, os.path.splitext(name)[0] + "_generated.wav")
            scipy.io.wavfile.write(out, audio_cfg.sampling_rate, wav)
            print(out)
            written.append(out)
    if not written:
        raise SystemExit("no input files found")
    return written


if __name__ == "__main__":
    main(build_parser().parse_args())
