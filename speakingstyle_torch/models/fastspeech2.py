"""FastSpeech2 + style reference encoder, the acoustic model (JAX
counterpart: speakingstyle_tpu/models/fastspeech2.py).

The reference encoder's FiLM vectors condition the encoder, the decoder
and the duration predictor; a speaker embedding (multi-speaker configs)
is added to the encoder output; the variance adaptor expands phonemes to
frames; decoder + ``mel_linear`` + postnet residual give the mel pair.
FiLM enters either from a reference mel (``mels``) or precomputed
(``gammas``/``betas``, the serve path). Teacher-forced and free-running
are the same forward, told apart by whether ``d_targets`` is None.
``deterministic=False`` (training) turns on dropout at the JAX package's
sites, with masks from ``rng`` (an ``ops.dropout.DropoutRNG``), and runs
the postnet's BatchNorm on batch statistics, updating its running ones.
``seq_mesh`` (``model.attention_impl="ring"``, through
``models/factory.build_model``) runs the encoder's and decoder's attention
as ring attention over that sequence mesh; in the free run the ranks then
take rank 0's predicted durations, so every rank regulates to the same
frames.
"""

from typing import Optional

import torch
from torch import nn

from speakingstyle_torch.configs.config import Config
from speakingstyle_torch.device import torch_dtype
from speakingstyle_torch.models.layers import linear
from speakingstyle_torch.models.postnet import PostNet
from speakingstyle_torch.models.reference_encoder import ReferenceEncoder
from speakingstyle_torch.models.transformer import Decoder, Encoder
from speakingstyle_torch.models.variance_adaptor import VarianceAdaptor
from speakingstyle_torch.ops.masking import length_to_mask
from speakingstyle_torch.parallel.tensor import param


class FastSpeech2(nn.Module):
    def __init__(self, config: Config, pitch_stats: tuple = (-3.0, 12.0),
                 energy_stats: tuple = (-2.0, 10.0), n_speakers: int = 1,
                 n_position: Optional[int] = None, seq_mesh=None):
        super().__init__()
        self.config = config
        self.seq_mesh = seq_mesh
        m, pp = config.model, config.preprocess.preprocessing
        tf, ref = m.transformer, m.reference_encoder
        self.dtype = torch_dtype(m.compute_dtype)
        n_position = n_position or (m.max_seq_len + 1)
        self.n_mels = pp.mel.n_mel_channels
        common = dict(
            conv_impl=m.conv_impl, dtype=self.dtype,
            softmax_dtype=torch_dtype(m.attention_softmax_dtype),
            attention_kernel=m.attention_kernel, dropout_impl=m.dropout_impl,
        )
        self.use_ref = m.use_reference_encoder
        if self.use_ref:
            self.reference_encoder = ReferenceEncoder(
                self.n_mels, ref.conv_layer, ref.conv_filter_size, ref.conv_kernel_size,
                ref.encoder_layer, ref.encoder_head, ref.encoder_hidden,
                n_position=n_position, dropout=ref.dropout, **common,
            )
        # train.sharding.remat checkpoints the encoder's and decoder's FFT
        # blocks (not the reference encoder's), as the JAX package does
        stack = dict(common, attention_impl=m.attention_impl, remat=config.train.sharding.remat,
                     seq_mesh=seq_mesh)
        self.encoder = Encoder(
            tf.encoder_layer, tf.encoder_hidden, tf.encoder_head, tf.conv_filter_size,
            tuple(tf.conv_kernel_size), n_position, film=self.use_ref,
            dropout=tf.encoder_dropout, **stack,
        )
        self.speaker_emb = (
            nn.Embedding(n_speakers, tf.encoder_hidden) if m.multi_speaker else None
        )
        self.variance_adaptor = VarianceAdaptor(
            pitch_stats=tuple(pitch_stats), energy_stats=tuple(energy_stats),
            n_bins=m.variance_embedding.n_bins,
            pitch_quantization=m.variance_embedding.pitch_quantization,
            energy_quantization=m.variance_embedding.energy_quantization,
            pitch_feature_level=pp.pitch.feature, energy_feature_level=pp.energy.feature,
            d_model=tf.encoder_hidden, filter_size=m.variance_predictor.filter_size,
            kernel_size=m.variance_predictor.kernel_size, film=self.use_ref,
            conv_impl=m.conv_impl, dtype=self.dtype, dropout=m.variance_predictor.dropout,
            dropout_impl=m.dropout_impl, seq_mesh=seq_mesh,
        )
        self.decoder = Decoder(
            tf.decoder_layer, tf.decoder_hidden, tf.decoder_head, tf.conv_filter_size,
            tuple(tf.conv_kernel_size), n_position, film=self.use_ref,
            dropout=tf.decoder_dropout, **stack,
        )
        self.mel_linear = nn.Linear(tf.decoder_hidden, self.n_mels)
        # the JAX package's postnet dropout is 0.5 whatever the config says
        self.postnet = PostNet(
            self.n_mels, m.postnet_embedding_dim, m.postnet_kernel_size, m.postnet_layers,
            conv_impl=m.conv_impl, dtype=self.dtype, dropout_impl=m.dropout_impl,
        )

    def forward(self, speakers, texts, src_lens, mels=None, mel_lens=None,
                max_mel_len: Optional[int] = None, p_targets=None, e_targets=None,
                d_targets=None, p_control=1.0, e_control=1.0, d_control=1.0,
                gammas=None, betas=None, deterministic: bool = True, rng=None):
        B, L_src = texts.shape
        src_pad_mask = length_to_mask(src_lens, L_src)
        if self.use_ref and gammas is None:
            if mels is None:
                raise ValueError(
                    "use_reference_encoder needs a reference: pass `mels` or "
                    "precomputed `gammas`/`betas`"
                )
            mel_pad_mask = length_to_mask(mel_lens, mels.shape[1])
            gammas, betas = self.reference_encoder(mels, mel_pad_mask, deterministic, rng)
        elif not self.use_ref:
            gammas = betas = None

        x = self.encoder(texts, src_pad_mask, gammas, betas, deterministic, rng)
        if self.speaker_emb is not None:
            x = x + param(self.speaker_emb, "weight").to(self.dtype)[speakers][:, None, :]
        va = self.variance_adaptor(
            x, src_pad_mask, max_mel_len, p_targets, e_targets, d_targets,
            p_control, e_control, d_control, gammas, betas, deterministic, rng,
        )
        dec = self.decoder(va["features"], va["mel_pad_mask"], gammas, betas, deterministic, rng)
        mel_out = linear(self.mel_linear, dec, self.dtype)
        postnet_in, keep = mel_out, None
        if d_targets is None:
            # free-running: zero past the batch-max predicted length and
            # re-zero every postnet layer there (the reference's buffer ends
            # at that length, so its convs zero-pad there)
            keep = torch.arange(mel_out.shape[1], device=mel_out.device) < va["mel_lens"].max()
            postnet_in = mel_out.masked_fill(~keep[None, :, None], 0.0)
        mel_postnet = mel_out + self.postnet(postnet_in, keep, deterministic, rng)
        return {
            "mel": mel_out.float(),
            "mel_postnet": mel_postnet.float(),
            "pitch_prediction": va["pitch_prediction"],
            "energy_prediction": va["energy_prediction"],
            "log_duration_prediction": va["log_duration_prediction"],
            "durations": va["durations"],
            "src_pad_mask": src_pad_mask,
            "mel_pad_mask": va["mel_pad_mask"],
            "src_lens": src_lens,
            "mel_lens": va["mel_lens"],
        }
