"""Phone/Word value types and the bidirectional pronunciation dictionary.

Covers the reference's Phones.py, Words.py, and Dictionary.py: integer-indexed
phone and word registries plus word -> [pronunciations] lookup, used by the
prefix-tree builder and the beam-search decoder.

A copy of ``emg_tpu/text/lexicon.py``: the port imports nothing of the
JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence


@dataclass(frozen=True)
class Phone:
    idx: int
    name: str

    def __repr__(self):
        return f"Phone({self.idx}, {self.name})"


@dataclass(frozen=True)
class Word:
    idx: int
    name: str

    def __repr__(self):
        return f"Word({self.idx}, {self.name})"


class Dictionary:
    """Integer-indexed phone/word registries + pronunciations."""

    def __init__(self):
        self._phones_by_index: Dict[int, Phone] = {}
        self._phones_by_name: Dict[str, Phone] = {}
        self._words_by_index: Dict[int, Word] = {}
        self._words_by_name: Dict[str, Word] = {}
        self._prons: Dict[Word, List[List[Phone]]] = {}
        self._next_phone_id = 0
        self._next_word_id = 0

    # -- construction ------------------------------------------------------
    def add_phone(self, name: str) -> Phone:
        if name in self._phones_by_name:
            raise ValueError(f"phone already present: {name}")
        phone = Phone(self._next_phone_id, name)
        self._phones_by_index[phone.idx] = phone
        self._phones_by_name[name] = phone
        self._next_phone_id += 1
        return phone

    def add_word(self, name: str) -> Word:
        if name in self._words_by_name:
            raise ValueError(f"word already present: {name}")
        word = Word(self._next_word_id, name)
        self._words_by_index[word.idx] = word
        self._words_by_name[name] = word
        self._next_word_id += 1
        return word

    def add_pronunciation(self, word: Word, pron: Sequence[Phone]) -> None:
        self._prons.setdefault(word, []).append(list(pron))

    def read_phones_set(self, filename: str, skip_existing: bool = False) -> None:
        """Phone set file: all phones on the first line."""
        with open(filename) as f:
            for name in f.readline().split():
                if name in self._phones_by_name and skip_existing:
                    continue
                self.add_phone(name)

    def read_dictionary(self, filename: str, phone_map: Optional[Dict[str, str]] = None) -> None:
        with open(filename) as f:
            for line in f:
                elements = line.split()
                if not elements:
                    continue
                word_name = elements[0]
                phones = elements[1:]
                if phone_map is not None:
                    phones = [phone_map[p] for p in phones]
                pron = [self.lookup_phone_by_name(p) for p in phones]
                word = self._words_by_name.get(word_name)
                if word is None:
                    word = self.add_word(word_name)
                self.add_pronunciation(word, pron)

    # -- lookup ------------------------------------------------------------
    def phone_count(self) -> int:
        return len(self._phones_by_name)

    def word_count(self) -> int:
        return len(self._words_by_name)

    def lookup_phone_by_index(self, idx: int) -> Phone:
        return self._phones_by_index[idx]

    def lookup_phone_by_name(self, name: str) -> Phone:
        return self._phones_by_name[name]

    def lookup_word_by_index(self, idx: int) -> Word:
        return self._words_by_index[idx]

    def lookup_word_by_name(self, name: str) -> Word:
        return self._words_by_name[name]

    def lookup_prons(self, word) -> List[List[Phone]]:
        if not isinstance(word, Word):
            word = self.lookup_word_by_name(word)
        return self._prons[word]

    def words_by_index(self) -> Dict[int, Word]:
        return self._words_by_index

    def __str__(self):
        return (
            f"Dictionary with {len(self._phones_by_name)} phones and "
            f"{len(self._words_by_name)} vocabulary items"
        )


def load_pronunciation_dict(
    phones_file: str, vocab_file: str, dict_file: str
) -> Dictionary:
    """Build a Dictionary from the reference's descriptions/ artifacts
    (phonesSet + vocabulary + pronunciation lexicon)."""
    raw = {}
    with open(dict_file) as f:
        for line in f:
            parts = line.split()
            if parts:
                raw[parts[0]] = parts[1:]

    dct = Dictionary()
    dct.read_phones_set(phones_file)
    for w in raw:
        dct.add_word(w)
    for w, pron in raw.items():
        word = dct.lookup_word_by_name(w)
        dct.add_pronunciation(word, [dct.lookup_phone_by_name(p) for p in pron])
    return dct
