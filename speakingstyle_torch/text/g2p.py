"""Synthesis-time grapheme-to-phoneme frontends.

Reference: synthesize.py:26-90. English goes through a pronouncing lexicon
with a ``g2p_en`` fallback for OOV words; Mandarin goes through ``pypinyin``
TONE3 pinyin and a pinyin→initial/final lexicon with OOV mapped to "sp".
Both external packages are optional: without them, lexicon hits still work
and OOV handling degrades gracefully (letters-as-graphemes / "sp").
"""

import re
from string import punctuation
from typing import Dict, List, Optional, Tuple

import numpy as np

from speakingstyle_torch.text import text_to_sequence

_WORD_SPLIT_RE = re.compile(r"([,;.\-\?\!\s+])")


def read_lexicon(path: str) -> Dict[str, List[str]]:
    """word -> phone list; first pronunciation wins (reference:
    synthesize.py:26-35).

    The pinyin lexicon is self-hosting: if ``path`` names the standard
    ``pinyin-lexicon-r.txt`` and the file does not exist yet, it is
    generated in place from ``text/pinyin_lexicon.py`` (the reference
    vendors it as opaque data; we derive it from pinyin phonology).
    """
    import os

    if not os.path.exists(path) and os.path.basename(path) == "pinyin-lexicon-r.txt":
        from speakingstyle_torch.text.pinyin_lexicon import write_lexicon

        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        write_lexicon(path)
    lexicon: Dict[str, List[str]] = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = re.split(r"\s+", line.strip("\n"))
            if len(parts) < 2:
                continue
            word, phones = parts[0].lower(), parts[1:]
            lexicon.setdefault(word, phones)
    return lexicon


def _g2p_en_fallback():
    try:
        from g2p_en import G2p  # optional

        return G2p()
    except ImportError:
        return None


def english_word_spans(
    text: str, lexicon: Dict[str, List[str]], g2p=None
) -> List[Tuple[str, List[str]]]:
    """English text -> [(word, [phones])] keeping word→phone alignment.

    Lexicon lookup per word; OOV words go to g2p_en when available, else to
    the "spn" unknown marker (MFA convention); punctuation tokens become
    "sp" pauses (reference: synthesize.py:44-52). The spans feed both plain
    synthesis (joined) and per-word prosody control (control.py).
    """
    text = text.rstrip(punctuation)
    if g2p is None:
        g2p = _g2p_en_fallback()
    spans: List[Tuple[str, List[str]]] = []
    for w in _WORD_SPLIT_RE.split(text):
        if not w or w.isspace():
            continue
        lw = w.lower()
        if not re.match(r"[\w\d]", w):
            phones = ["sp"]  # punctuation -> short pause
        elif lw in lexicon:
            phones = list(lexicon[lw])
        elif g2p is not None:
            phones = [p for p in g2p(w) if p != " "]
        else:
            phones = ["spn"]
        # g2p can emit punctuation-ish phones; map those to pauses too
        phones = ["sp" if not re.match(r"[\w\d]", p) else p for p in phones]
        spans.append((w, phones))
    return spans


def english_to_phones(
    text: str, lexicon: Dict[str, List[str]], g2p=None
) -> str:
    """English text -> "{PH ON E ...}" phone string."""
    spans = english_word_spans(text, lexicon, g2p=g2p)
    return "{" + " ".join(p for _, ps in spans for p in ps) + "}"


def mandarin_to_phones(text: str, lexicon: Dict[str, List[str]]) -> str:
    """Mandarin text -> phone string via TONE3 pinyin + lexicon
    (reference: synthesize.py:65-81)."""
    try:
        from pypinyin import Style, pinyin  # optional

        pinyins = [
            p[0]
            for p in pinyin(
                text, style=Style.TONE3, strict=False, neutral_tone_with_five=True
            )
        ]
    except ImportError:
        pinyins = text.split()  # assume pre-converted pinyin tokens
    phones: List[str] = []
    for p in pinyins:
        phones += lexicon.get(p, ["sp"])
    return "{" + " ".join(phones) + "}"


def preprocess_text(
    text: str,
    language: str,
    lexicon_path: Optional[str],
    cleaners: List[str],
    g2p=None,
) -> np.ndarray:
    """Raw text -> int32 symbol-id array (reference: synthesize.py:38-90)."""
    lexicon = read_lexicon(lexicon_path) if lexicon_path else {}
    if language == "zh":
        phones = mandarin_to_phones(text, lexicon)
    else:
        phones = english_to_phones(text, lexicon, g2p=g2p)
    return np.asarray(text_to_sequence(phones, cleaners), np.int32)
