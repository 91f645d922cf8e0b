"""Sentence → phoneme-sequence normalization chain.

Reproduces the reference's ``read_phonemes`` (data_utils.py:230-261)
semantics without the jiwer/num2words dependencies:

1. pre-substitutions: ``_`` -> space, ``£`` -> ``pound``
2. digit runs -> English words (commas inside numbers dropped; note the
   reference drops *every* comma in the sentence and never flushes a
   trailing digit run — both quirks are kept for parity)
3. strip typographic punctuation, hyphens -> spaces, uppercase, split
4. lexicon lookup word-by-word (missing words logged and skipped)
5. wrap with ``<S>`` ... ``</S>``
"""

from __future__ import annotations

import logging
import re
from typing import Dict, List, Sequence

from emg_tpu_torch.text.numbers import num2words

_PRE_SUBS = [(re.compile(r"_"), " "), (re.compile(r"£"), "pound ")]
# same character class as the reference regex
_STRIP_RE = re.compile(r"[.!?,“”;:‘’\[\]\(\)\/]")
_DASH_RE = re.compile(r"—")
_HYPHEN_RE = re.compile(r"-")
_APOST_RE = re.compile(r"’(\w+)")

log = logging.getLogger(__name__)


def normalize_sentence(sentence: str) -> List[str]:
    """Apply steps 1-3 and return the upper-cased word list."""
    text = sentence
    for pat, rep in _PRE_SUBS:
        text = pat.sub(rep, text)

    # digit runs -> words; skip commas entirely; a trailing digit run is
    # dropped (reference behavior)
    digits: List[str] = []
    out = []
    for unit in text:
        if unit.isdigit():
            digits.append(unit)
        elif unit == ",":
            pass
        elif digits:
            out.append(num2words(int("".join(digits))) + " " + unit)
            digits = []
        else:
            out.append(unit)
    text = "".join(out)

    text = _DASH_RE.sub(" ", text)
    text = _HYPHEN_RE.sub(" ", text)
    text = _APOST_RE.sub(r"'\1", text)
    text = _STRIP_RE.sub("", text)
    return text.upper().split()


def read_phonemes(sentence: str, pron_dict: Dict[str, Sequence[str]]) -> List[str]:
    """Full text→phonemes pipeline, returns ['<S>', ..., '</S>']."""
    words = normalize_sentence(sentence)
    phones: List[str] = ["<S>"]
    for w in words:
        pron = pron_dict.get(w)
        if pron is None:
            log.warning(
                "Dictionary error for the word '%s' in the phrase: %s", w, sentence
            )
            continue
        phones.extend(pron)
    phones.append("</S>")
    return phones


def load_pron_dict(path: str) -> Dict[str, List[str]]:
    """word -> phone list, first column is the word (reference data_utils.py:22-24)."""
    result: Dict[str, List[str]] = {}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            result[parts[0]] = parts[1:]
    return result
