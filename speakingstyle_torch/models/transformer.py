"""Phoneme encoder and mel decoder: sinusoid PE + FFT block stacks (JAX
counterpart: speakingstyle_tpu/models/transformer.py).

The PE table is sized at construction (``n_position``); sequences longer
than the table raise.
"""

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from speakingstyle_torch.models.layers import FFTBlock, position_table
from speakingstyle_torch.ops.positional import add_position_encoding
from speakingstyle_torch.text.symbols import VOCAB_SIZE


class FFTStack(nn.Module):
    """N FiLM-modulated FFT blocks (children ``layer_{i}``) after a fixed
    sinusoid PE."""

    def __init__(self, n_layers: int, d_model: int, n_head: int, d_inner: int,
                 kernel_sizes: Tuple[int, int], n_position: int, film: bool = True,
                 conv_impl: str = "xla", dtype=torch.float32,
                 softmax_dtype=torch.float32, attention_kernel: str = "einsum",
                 attention_impl: str = "dense"):
        super().__init__()
        self.n_layers = n_layers
        self.register_buffer("pe", position_table(n_position, d_model), persistent=False)
        for i in range(n_layers):
            self.add_module(f"layer_{i}", FFTBlock(
                d_model, n_head, d_inner, kernel_sizes, film=film,
                conv_impl=conv_impl, dtype=dtype, softmax_dtype=softmax_dtype,
                attention_kernel=attention_kernel, attention_impl=attention_impl,
            ))

    def forward(self, x, pad_mask, gammas=None, betas=None):
        x = add_position_encoding(x, self.pe)
        for i in range(self.n_layers):
            x = getattr(self, f"layer_{i}")(x, pad_mask, gammas, betas)
        return x


class Encoder(nn.Module):
    """Phoneme embedding (``src_word_emb``) + FFT stack (``layer_stack``)."""

    def __init__(self, n_layers: int = 4, d_model: int = 256, n_head: int = 2,
                 d_inner: int = 1024, kernel_sizes: Tuple[int, int] = (9, 1),
                 n_position: int = 1001, vocab_size: int = VOCAB_SIZE,
                 film: bool = True, **stack_kwargs):
        super().__init__()
        self.dtype = stack_kwargs.get("dtype", torch.float32)
        self.src_word_emb = nn.Embedding(vocab_size, d_model)
        self.layer_stack = FFTStack(n_layers, d_model, n_head, d_inner, kernel_sizes,
                                    n_position, film=film, **stack_kwargs)

    def forward(self, token_ids, pad_mask, gammas=None, betas=None):
        x = F.embedding(token_ids, self.src_word_emb.weight.to(self.dtype))
        return self.layer_stack(x, pad_mask, gammas, betas)


class Decoder(nn.Module):
    """Frame-level FFT stack (``layer_stack``)."""

    def __init__(self, n_layers: int = 6, d_model: int = 256, n_head: int = 2,
                 d_inner: int = 1024, kernel_sizes: Tuple[int, int] = (9, 1),
                 n_position: int = 1001, film: bool = True, **stack_kwargs):
        super().__init__()
        self.layer_stack = FFTStack(n_layers, d_model, n_head, d_inner, kernel_sizes,
                                    n_position, film=film, **stack_kwargs)

    def forward(self, x, pad_mask, gammas=None, betas=None):
        return self.layer_stack(x, pad_mask, gammas, betas)
