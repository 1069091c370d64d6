"""English number normalization (dependency-free).

Behavioral equivalent of the reference's inflect-based normalizer
(reference: text/numbers.py:7-73): commas stripped, currency expanded,
decimals read as "point", ordinals spelled out, years grouped in digit
pairs, everything else read as cardinal words without "and".
"""

import re

_UNITS = [
    "zero", "one", "two", "three", "four", "five", "six", "seven", "eight",
    "nine", "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen",
    "sixteen", "seventeen", "eighteen", "nineteen",
]
_TENS = [
    "", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
    "eighty", "ninety",
]
_SCALE_NAMES = ["", "thousand", "million", "billion", "trillion", "quadrillion"]

_ORDINAL_IRREGULAR = {
    "one": "first", "two": "second", "three": "third", "five": "fifth",
    "eight": "eighth", "nine": "ninth", "twelve": "twelfth",
}

_comma_number_re = re.compile(r"([0-9][0-9\,]+[0-9])")
_decimal_number_re = re.compile(r"([0-9]+\.[0-9]+)")
_pounds_re = re.compile(r"£([0-9\,]*[0-9]+)")
_dollars_re = re.compile(r"\$([0-9\.\,]*[0-9]+)")
_ordinal_re = re.compile(r"[0-9]+(st|nd|rd|th)")
_number_re = re.compile(r"[0-9]+")


def _small_to_words(n):
    """Words for 0 <= n < 100."""
    if n < 20:
        return _UNITS[n]
    tens, unit = divmod(n, 10)
    if unit:
        return _TENS[tens] + "-" + _UNITS[unit]
    return _TENS[tens]


def _group_to_words(n, andword):
    """Words for 0 < n < 1000: "X hundred[ <andword>] YZ" (inflect style)."""
    hundreds, rest = divmod(n, 100)
    parts = []
    if hundreds:
        parts.append(_UNITS[hundreds] + " hundred")
    if rest:
        if hundreds and andword:
            parts.append(andword)
        parts.append(_small_to_words(rest))
    return " ".join(parts)


def number_to_words(n, andword=""):
    """Cardinal words matching inflect's format: scale groups joined with
    ", " and an optional andword between hundreds and tens (the reference
    calls inflect with andword="" for cardinals, text/numbers.py:63).
    e.g. 3456 -> "three thousand, four hundred fifty-six".
    """
    if n < 0:
        return "minus " + number_to_words(-n, andword)
    if n == 0:
        return "zero"
    groups = []  # (scale_index, 3-digit value), most significant first
    scale = 0
    while n:
        n, g = divmod(n, 1000)
        if g:
            groups.append((scale, g))
        scale += 1
    words = []
    for scale, g in reversed(groups):
        w = _group_to_words(g, andword)
        if scale:
            w += " " + _SCALE_NAMES[scale]
        words.append(w)
    return ", ".join(words)


def ordinal_to_words(n):
    """Ordinal words, inflect-style with "and": 101 -> "one hundred and first"."""
    words = number_to_words(n, andword="and")
    for sep in ("-", " "):
        head, found, last = words.rpartition(sep)
        if found:
            break
    if last in _ORDINAL_IRREGULAR:
        last = _ORDINAL_IRREGULAR[last]
    elif last.endswith("y"):
        last = last[:-1] + "ieth"
    else:
        last = last + "th"
    return head + found + last if found else last


def _year_to_words(n):
    """Digit-pair year reading: 1999 -> "nineteen ninety-nine"."""
    if n == 2000:
        return "two thousand"
    if 2000 < n < 2010:
        return "two thousand " + _UNITS[n % 100]
    if n % 100 == 0:
        return number_to_words(n // 100) + " hundred"
    high, low = divmod(n, 100)
    low_words = "oh " + _UNITS[low] if low < 10 else _small_to_words(low)
    return _small_to_words(high) + " " + low_words


def _remove_commas(m):
    return m.group(1).replace(",", "")


def _expand_decimal_point(m):
    integer, frac = m.group(1).split(".")
    return integer + " point " + frac


def _expand_dollars(m):
    match = m.group(1)
    parts = match.split(".")
    if len(parts) > 2:
        return match + " dollars"
    dollars = int(parts[0]) if parts[0] else 0
    cents = int(parts[1]) if len(parts) > 1 and parts[1] else 0
    if dollars and cents:
        dollar_unit = "dollar" if dollars == 1 else "dollars"
        cent_unit = "cent" if cents == 1 else "cents"
        return "%s %s, %s %s" % (dollars, dollar_unit, cents, cent_unit)
    if dollars:
        return "%s %s" % (dollars, "dollar" if dollars == 1 else "dollars")
    if cents:
        return "%s %s" % (cents, "cent" if cents == 1 else "cents")
    return "zero dollars"


def _expand_ordinal(m):
    return ordinal_to_words(int(m.group(0)[:-2]))


def _expand_number(m):
    num = int(m.group(0))
    if 1000 < num < 3000:
        return _year_to_words(num)
    return number_to_words(num)


def normalize_numbers(text):
    text = re.sub(_comma_number_re, _remove_commas, text)
    text = re.sub(_pounds_re, r"\1 pounds", text)
    text = re.sub(_dollars_re, _expand_dollars, text)
    text = re.sub(_decimal_number_re, _expand_decimal_point, text)
    text = re.sub(_ordinal_re, _expand_ordinal, text)
    text = re.sub(_number_re, _expand_number, text)
    return text
