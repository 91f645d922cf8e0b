"""Integer → English words, matching the num2words package's `en` output.

Only the word content has to match: the surrounding phonemization pipeline
(emg_tpu_torch.text.normalize.read_phonemes) strips commas and turns hyphens into
spaces before lexicon lookup (reference data_utils.py:230-261).
"""

from __future__ import annotations

_ONES = [
    "zero", "one", "two", "three", "four", "five", "six", "seven", "eight",
    "nine", "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen",
    "sixteen", "seventeen", "eighteen", "nineteen",
]
_TENS = [
    "", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
    "eighty", "ninety",
]
_SCALES = [
    "", "thousand", "million", "billion", "trillion", "quadrillion",
    "quintillion",
]


def _under_100(n: int) -> str:
    if n < 20:
        return _ONES[n]
    tens, ones = divmod(n, 10)
    if ones:
        return f"{_TENS[tens]}-{_ONES[ones]}"
    return _TENS[tens]


def _under_1000(n: int) -> str:
    if n < 100:
        return _under_100(n)
    hundreds, rest = divmod(n, 100)
    if rest:
        return f"{_ONES[hundreds]} hundred and {_under_100(rest)}"
    return f"{_ONES[hundreds]} hundred"


def num2words(n: int) -> str:
    """British-style short-scale spelling, e.g. 1577 ->
    'one thousand, five hundred and seventy-seven'."""
    n = int(n)
    if n < 0:
        return "minus " + num2words(-n)
    if n == 0:
        return "zero"
    chunks = []  # (value, scale_index), most significant first
    scale = 0
    while n > 0:
        n, c = divmod(n, 1000)
        if c:
            chunks.append((c, scale))
        scale += 1
    chunks.reverse()
    parts = []
    for value, s in chunks:
        word = _under_1000(value)
        if s:
            word = f"{word} {_SCALES[s]}"
        parts.append((value if s == 0 else 1000, word))
    if len(parts) == 1:
        return parts[0][1]
    last_value, last_word = parts[-1]
    head = ", ".join(w for _, w in parts[:-1])
    if last_value < 100:
        return f"{head} and {last_word}"
    return f"{head}, {last_word}"
