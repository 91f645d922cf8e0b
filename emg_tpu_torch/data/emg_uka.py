"""EMG-UKA corpus adapter.

The reference carries a dead, unreachable loader for the EMG-UKA corpus
(DataLoader.py — sacred config, sqlite paths, frame stacking, channel/time
dropout, a quantile-filtered batch sampler; SURVEY.md §2 C14). This module
provides a working equivalent with a documented schema instead of the
hard-coded paths: a sqlite utterance index, context frame stacking, the
augmentations (now shared with the training recipes), and a
quantile-filtered length sampler.

Counterpart of ``emg_tpu/data/emg_uka.py``, a numpy copy of it: the same
sqlite ``SCHEMA``, stacking and sampler draws.
"""

from __future__ import annotations

import sqlite3
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

import numpy as np

SCHEMA = """
CREATE TABLE IF NOT EXISTS utterances (
    id INTEGER PRIMARY KEY,
    speaker TEXT NOT NULL,
    session TEXT NOT NULL,
    path TEXT NOT NULL,       -- npy file with (frames, features)
    n_frames INTEGER NOT NULL,
    text TEXT NOT NULL
);
"""


class UtteranceIndex:
    """sqlite-backed utterance registry."""

    def __init__(self, db_path: str):
        self.db_path = db_path
        self._conn = sqlite3.connect(db_path)
        self._conn.execute(SCHEMA)
        self._conn.commit()

    def add(self, speaker: str, session: str, path: str, n_frames: int, text: str) -> int:
        cur = self._conn.execute(
            "INSERT INTO utterances (speaker, session, path, n_frames, text) "
            "VALUES (?, ?, ?, ?, ?)",
            (speaker, session, path, n_frames, text),
        )
        self._conn.commit()
        return cur.lastrowid

    def query(self, speaker: Optional[str] = None) -> List[Tuple]:
        sql = "SELECT id, speaker, session, path, n_frames, text FROM utterances"
        args: tuple = ()
        if speaker is not None:
            sql += " WHERE speaker = ?"
            args = (speaker,)
        return list(self._conn.execute(sql + " ORDER BY id", args))

    def close(self):
        self._conn.close()


def stack_frames(features: np.ndarray, left: int, right: int) -> np.ndarray:
    """Context stacking: frame t becomes the concatenation of frames
    [t-left, t+right], edge-replicated — (T, F) -> (T, F*(left+1+right))."""
    T, F = features.shape
    padded = np.concatenate(
        [np.repeat(features[:1], left, 0), features, np.repeat(features[-1:], right, 0)]
    )
    cols = [padded[i : i + T] for i in range(left + 1 + right)]
    return np.concatenate(cols, axis=1)


@dataclass
class EMGUKAExample:
    features: np.ndarray
    text: str
    speaker: str
    session: str


class EMGUKADataset:
    def __init__(self, index: UtteranceIndex, speaker: Optional[str] = None,
                 stack_left: int = 0, stack_right: int = 0):
        self.rows = index.query(speaker)
        self.stack_left = stack_left
        self.stack_right = stack_right

    def __len__(self):
        return len(self.rows)

    def lengths(self) -> List[int]:
        return [r[4] for r in self.rows]

    def __getitem__(self, i: int) -> EMGUKAExample:
        _, speaker, session, path, _, text = self.rows[i]
        feats = np.load(path)
        if self.stack_left or self.stack_right:
            feats = stack_frames(feats, self.stack_left, self.stack_right)
        return EMGUKAExample(feats.astype(np.float32), text, speaker, session)


class QuantileFilteredSampler:
    """Drop utterances above a length quantile, then emit shuffled
    fixed-size batches (the reference sampler's filtering idea, made
    deterministic)."""

    def __init__(self, dataset: EMGUKADataset, batch_size: int,
                 length_quantile: float = 0.95, seed: int = 0):
        lengths = np.asarray(dataset.lengths())
        cutoff = np.quantile(lengths, length_quantile) if len(lengths) else 0
        self._kept = [i for i, l in enumerate(lengths) if l <= cutoff]
        self.batch_size = batch_size
        self._seed = seed
        self._epoch = 0

    def set_epoch(self, epoch: int):
        self._epoch = epoch

    def __iter__(self) -> Iterator[List[int]]:
        rng = np.random.default_rng(self._seed + self._epoch)
        order = rng.permutation(len(self._kept))
        for start in range(0, len(order) - self.batch_size + 1, self.batch_size):
            yield [self._kept[j] for j in order[start : start + self.batch_size]]

    def __len__(self):
        return len(self._kept) // self.batch_size
