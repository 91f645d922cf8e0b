"""Prompt-sentence source for recording sessions.

Serves the sentences of a plain-text book one at a time, remembering the
reading position across sessions in a sidecar ``<book>.bookmark`` file —
the behavior of the reference's read_book.py (data_collection/read_book.py:
punkt sentence split over blank-line paragraphs, modulo advance, bookmark
persisted on close), re-expressed here as small pure helpers around a thin
stateful cursor.

Counterpart of ``emg_tpu/collect/book.py``, a copy of it on the port's
own modules.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import List

_SENTENCE_EDGE = re.compile(r"(?<=[.!?])\s+(?=[A-Z\"'])")


def _sentence_splitter():
    """Prefer the nltk punkt model when its data is installed; otherwise a
    regex splitter (punctuation followed by whitespace and a capital)."""
    try:
        import nltk

        detector = nltk.data.load("tokenizers/punkt/english.pickle")
        return detector.tokenize
    except Exception:
        return lambda text: [s for s in _SENTENCE_EDGE.split(text.strip()) if s]


def extract_sentences(text: str) -> List[str]:
    """All sentences of ``text``: paragraphs are blank-line separated, and
    intra-sentence newlines become spaces."""
    split = _sentence_splitter()
    out: List[str] = []
    for paragraph in text.split("\n\n"):
        paragraph = paragraph.strip()
        if paragraph:
            out.extend(s.replace("\n", " ") for s in split(paragraph) if s)
    return out


def _bookmark_path(book_file: str) -> Path:
    return Path(book_file + ".bookmark")


def _load_bookmark(book_file: str) -> int:
    mark = _bookmark_path(book_file)
    return int(mark.read_text().strip()) if mark.exists() else 0


class Book:
    """Cursor over a book's sentences; a context manager that persists the
    cursor to the bookmark file on exit."""

    def __init__(self, book_file: str):
        self.file = book_file
        self.sentences = extract_sentences(Path(book_file).read_text())
        self.current_index = _load_bookmark(book_file)

    def current_sentence(self) -> str:
        return self.sentences[self.current_index]

    def next(self) -> None:
        self.current_index = (self.current_index + 1) % len(self.sentences)

    def save(self) -> None:
        _bookmark_path(self.file).write_text(str(self.current_index))

    def __enter__(self) -> "Book":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.save()
