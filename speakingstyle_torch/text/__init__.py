"""Text frontend: symbol vocabulary, cleaners, sequence conversion.

API mirrors the reference frontend (reference: text/__init__.py:15-76):
``{...}``-braced phone strings bypass the cleaners and map to "@"-prefixed
phone symbols; everything else is cleaned then mapped character-wise.
"""

import re

from speakingstyle_torch.text.cleaners import clean_text
from speakingstyle_torch.text.symbols import (
    ID_TO_SYMBOL,
    PAD_ID,
    SYMBOL_TO_ID,
    VOCAB_SIZE,
    symbols,
)

_curly_re = re.compile(r"(.*?)\{(.+?)\}(.*)")


def _keep(symbol):
    return symbol in SYMBOL_TO_ID and symbol not in ("_", "~")


def _symbols_to_ids(syms):
    return [SYMBOL_TO_ID[s] for s in syms if _keep(s)]


def _phones_to_ids(phone_text):
    return _symbols_to_ids(["@" + s for s in phone_text.split()])


def text_to_sequence(text, cleaner_names):
    """Convert text (with optional {PH ON E} spans) to a list of symbol ids."""
    sequence = []
    while text:
        m = _curly_re.match(text)
        if not m:
            sequence += _symbols_to_ids(clean_text(text, cleaner_names))
            break
        sequence += _symbols_to_ids(clean_text(m.group(1), cleaner_names))
        sequence += _phones_to_ids(m.group(2))
        text = m.group(3)
    return sequence


def sequence_to_text(sequence):
    """Inverse of text_to_sequence; phone symbols are re-braced."""
    out = []
    for sid in sequence:
        s = ID_TO_SYMBOL.get(int(sid))
        if s is None:
            continue
        if len(s) > 1 and s[0] == "@":
            s = "{%s}" % s[1:]
        out.append(s)
    return "".join(out).replace("}{", " ")


__all__ = [
    "text_to_sequence",
    "sequence_to_text",
    "symbols",
    "SYMBOL_TO_ID",
    "ID_TO_SYMBOL",
    "PAD_ID",
    "VOCAB_SIZE",
]
