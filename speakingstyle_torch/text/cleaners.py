"""Text cleaners (reference: text/cleaners.py).

Same three pipelines as the reference — ``english_cleaners``,
``basic_cleaners``, ``transliteration_cleaners`` — with ASCII
transliteration done via ``unidecode`` when available and a
``unicodedata``-based fallback otherwise (the reference hard-depends on
unidecode).
"""

import re
import unicodedata

try:
    from unidecode import unidecode as _to_ascii
except ImportError:  # pragma: no cover - exercised only without unidecode
    def _to_ascii(text):
        decomposed = unicodedata.normalize("NFKD", text)
        return decomposed.encode("ascii", "ignore").decode("ascii")

_whitespace_re = re.compile(r"\s+")

_abbreviations = [
    (re.compile(r"\b%s\." % abbr, re.IGNORECASE), expansion)
    for abbr, expansion in [
        ("mrs", "misess"),
        ("mr", "mister"),
        ("dr", "doctor"),
        ("st", "saint"),
        ("co", "company"),
        ("jr", "junior"),
        ("maj", "major"),
        ("gen", "general"),
        ("drs", "doctors"),
        ("rev", "reverend"),
        ("lt", "lieutenant"),
        ("hon", "honorable"),
        ("sgt", "sergeant"),
        ("capt", "captain"),
        ("esq", "esquire"),
        ("ltd", "limited"),
        ("col", "colonel"),
        ("ft", "fort"),
    ]
]

from speakingstyle_torch.text.numbers import normalize_numbers


def expand_abbreviations(text):
    for regex, replacement in _abbreviations:
        text = re.sub(regex, replacement, text)
    return text


def lowercase(text):
    return text.lower()


def collapse_whitespace(text):
    return re.sub(_whitespace_re, " ", text)


def convert_to_ascii(text):
    return _to_ascii(text)


def basic_cleaners(text):
    """Lowercase + collapse whitespace, no transliteration."""
    return collapse_whitespace(lowercase(text))


def transliteration_cleaners(text):
    """ASCII transliteration for non-English text."""
    return collapse_whitespace(lowercase(convert_to_ascii(text)))


def english_cleaners(text):
    """Full English pipeline: ascii, lowercase, numbers, abbreviations."""
    text = convert_to_ascii(text)
    text = lowercase(text)
    text = normalize_numbers(text)
    text = expand_abbreviations(text)
    text = collapse_whitespace(text)
    return text


CLEANERS = {
    "basic_cleaners": basic_cleaners,
    "transliteration_cleaners": transliteration_cleaners,
    "english_cleaners": english_cleaners,
}


def clean_text(text, cleaner_names):
    for name in cleaner_names:
        if name not in CLEANERS:
            raise ValueError("Unknown cleaner: %s" % name)
        text = CLEANERS[name](text)
    return text
