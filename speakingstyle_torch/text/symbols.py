"""Symbol vocabulary for text input.

Layout (order matters — ids must match the reference checkpoints, see
reference: text/symbols.py:10-29): pad, "-", punctuation, ASCII letters,
"@"-prefixed ARPAbet, "@"-prefixed pinyin, silence marks. 360 symbols total;
the embedding table is sized ``len(symbols) + 1`` (vocab 361).
"""

from speakingstyle_torch.text.phonesets import ARPABET_SYMBOLS, PINYIN_SYMBOLS

PAD = "_"
SPECIAL = "-"
PUNCTUATION = "!'(),.:;? "
LETTERS = "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"
SILENCES = ["@sp", "@spn", "@sil"]

symbols = (
    [PAD]
    + list(SPECIAL)
    + list(PUNCTUATION)
    + list(LETTERS)
    + ["@" + s for s in ARPABET_SYMBOLS]
    + ["@" + s for s in PINYIN_SYMBOLS]
    + SILENCES
)

PAD_ID = 0
VOCAB_SIZE = len(symbols) + 1

SYMBOL_TO_ID = {s: i for i, s in enumerate(symbols)}
ID_TO_SYMBOL = {i: s for i, s in enumerate(symbols)}
