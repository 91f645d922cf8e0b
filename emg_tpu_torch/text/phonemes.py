"""Phoneme inventory and phone/text codecs.

The 43-symbol inventory (40 ARPAbet phones + sentence end/start + pad) must
match the reference bit-for-bit: ``</S>``=40, ``<S>``=41, ``<PAD>``=42, and
the CTC blank is ``43 == len(inventory)`` (reference data_utils.py:19 and
recognition_model.py:98).
"""

from __future__ import annotations

import string
import unicodedata
from typing import Iterable, List, Sequence

# 40 ARPAbet phones in the exact order of the reference inventory,
# followed by the three control symbols.
PHONEME_INVENTORY: List[str] = [
    "AA", "AE", "AH", "AO", "AW", "AY", "B", "CH", "D", "DH",
    "EH", "ER", "EY", "F", "G", "HH", "IH", "IX", "IY", "JH",
    "K", "L", "M", "N", "NG", "OW", "OY", "P", "R", "S",
    "SH", "T", "TH", "UH", "UW", "V", "W", "Y", "Z", "ZH",
    "</S>", "<S>", "<PAD>",
]

N_PHONES = len(PHONEME_INVENTORY)  # 43
END_ID = PHONEME_INVENTORY.index("</S>")  # 40
START_ID = PHONEME_INVENTORY.index("<S>")  # 41
PAD_ID = PHONEME_INVENTORY.index("<PAD>")  # 42
BLANK_ID = N_PHONES  # 43 — CTC blank, one past the inventory

_PHONE_TO_ID = {p: i for i, p in enumerate(PHONEME_INVENTORY)}


class PhoneTransform:
    """Phone-string <-> integer-id codec (reference data_utils.py:281-292)."""

    def __init__(self):
        self.phoneme_inventory = PHONEME_INVENTORY
        self.vocabulary_size = N_PHONES

    def phone_to_int(self, phones: Sequence[str]) -> List[int]:
        return [_PHONE_TO_ID[p] for p in phones]

    def int_to_phone(self, ids: Iterable[int]) -> str:
        # NOTE: concatenates without separators, matching the reference
        return "".join(PHONEME_INVENTORY[int(i)] for i in ids)


_PUNCT_TABLE = str.maketrans("", "", string.punctuation)


def _ascii_fold(text: str) -> str:
    """unidecode-lite: NFKD-decompose and strip non-ASCII marks.

    Covers the Latin diacritics and typographic quotes/dashes that occur in
    the corpus text; a full transliteration table is unnecessary here.
    """
    replacements = {
        "‘": "'", "’": "'", "“": '"', "”": '"',
        "–": "-", "—": "-", "…": "...", " ": " ",
        "æ": "ae", "œ": "oe", "Æ": "AE", "Œ": "OE",
        "ß": "ss", "£": "PS",
    }
    for k, v in replacements.items():
        text = text.replace(k, v)
    decomposed = unicodedata.normalize("NFKD", text)
    return "".join(c for c in decomposed if ord(c) < 128)


class TextTransform:
    """Character-level text codec + cleaner (reference data_utils.py:263-279)."""

    def __init__(self):
        self.chars = "*" + string.ascii_lowercase + string.digits + " "
        self.vocabulary_size = len(self.chars)

    def clean_text(self, text: str) -> str:
        text = _ascii_fold(text)
        text = text.translate(_PUNCT_TABLE)  # jiwer.RemovePunctuation
        text = text.lower()  # jiwer.ToLowerCase
        return text

    def text_to_int(self, text: str) -> List[int]:
        text = self.clean_text(text)
        return [self.chars.index(c) for c in text]

    def int_to_text(self, ints: Iterable[int]) -> str:
        return "".join(self.chars[int(i)] for i in ints)
