"""Fine-grained prosody control: per-word / per-phone control arrays.

Reference: notebooks/control.ipynb cells 17-23 define a
``ControlledVarianceAdapter`` whose p/e/d controls are per-phone *lists*
instead of scalars. In this framework no subclass is needed: the variance
adaptor's control inputs broadcast, so a [B, L_src] array of per-phone
factors flows through the same jitted forward as a scalar
(models/variance_adaptor.py — ``pred * control`` and
``round(exp(logd)-1) * control``).

This module builds those arrays from word-level intent: G2P keeps the
word → phone-span mapping, and `expand_word_controls` turns
{word index: factor} into the per-phone array.
"""

from typing import Dict, List, Sequence, Tuple, Union

import numpy as np

from speakingstyle_torch.text import SYMBOL_TO_ID, text_to_sequence
from speakingstyle_torch.text.g2p import english_word_spans  # noqa: F401 (re-export)

ControlSpec = Union[float, Sequence[float], Dict[int, float]]


def _kept_phones(phones: Sequence[str]) -> List[str]:
    """Apply the text frontend's symbol filter so per-phone control arrays
    stay aligned with the token sequence: text_to_sequence silently drops
    phones outside the symbol inventory (text/__init__.py), and a control
    array built over the unfiltered phones would shift every later word's
    factor."""
    return [p for p in phones if "@" + p in SYMBOL_TO_ID]


def spans_to_sequence(
    spans: Sequence[Tuple[str, List[str]]], cleaners: Sequence[str]
) -> np.ndarray:
    phones = [p for _, ps in spans for p in ps]
    return np.asarray(
        text_to_sequence("{" + " ".join(phones) + "}", list(cleaners)), np.int32
    )


def expand_word_controls(
    spans: Sequence[Tuple[str, List[str]]],
    word_controls: ControlSpec,
    default: float = 1.0,
) -> np.ndarray:
    """Word-level factors -> per-phone [L] array.

    ``word_controls`` is a scalar (uniform), a per-word sequence (must match
    len(spans)), or {word index: factor} with `default` elsewhere.
    """
    kept = [(w, _kept_phones(ps)) for w, ps in spans]
    if np.isscalar(word_controls):
        n = sum(len(ps) for _, ps in kept)
        return np.full((n,), float(word_controls), np.float32)
    if isinstance(word_controls, dict):
        factors = [float(word_controls.get(i, default)) for i in range(len(kept))]
    else:
        factors = [float(c) for c in word_controls]
        if len(factors) != len(kept):
            raise ValueError(
                f"{len(factors)} word controls for {len(kept)} words: "
                f"{[w for w, _ in kept]}"
            )
    return np.concatenate(
        [np.full((len(ps),), f, np.float32) for f, (_, ps) in zip(factors, kept)]
    ) if kept else np.zeros((0,), np.float32)
