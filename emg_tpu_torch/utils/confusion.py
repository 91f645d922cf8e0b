"""Phone confusion accounting (reference data_utils.py:211-228).

Counterpart of ``emg_tpu/utils/confusion.py``, a numpy copy of it over the
port's own phone inventory.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from emg_tpu_torch.text.phonemes import PHONEME_INVENTORY


def confusion_matrix(predictions: Sequence[Sequence[int]],
                     targets: Sequence[Sequence[int]],
                     n_classes: int = len(PHONEME_INVENTORY)) -> np.ndarray:
    """Accumulate aligned (pred, target) id pairs into a (pred, target)
    count matrix."""
    mat = np.zeros((n_classes, n_classes), np.int64)
    for pred, tgt in zip(predictions, targets):
        for p, t in zip(pred, tgt):
            mat[int(p), int(t)] += 1
    return mat


def top_confusions(confusion_mat: np.ndarray, n: int = 10) -> List[Tuple[float, int, int]]:
    """Most-confused symmetric phone pairs, normalized by target counts."""
    target_counts = confusion_mat.sum(0) + 1e-4
    pairs = []
    for p1 in range(len(PHONEME_INVENTORY)):
        for p2 in range(p1):
            rate = (confusion_mat[p1, p2] + confusion_mat[p2, p1]) / (
                target_counts[p1] + target_counts[p2]
            )
            pairs.append((rate, p1, p2))
    pairs.sort()
    return pairs[-n:]


def print_confusion(confusion_mat: np.ndarray, n: int = 10) -> None:
    pairs = top_confusions(confusion_mat, n)
    target_counts = confusion_mat.sum(0) + 1e-4
    print("Common confusions (confusion, accuracy)")
    for rate, p1, p2 in pairs:
        acc = (confusion_mat[p1, p1] + confusion_mat[p2, p2]) / (
            target_counts[p1] + target_counts[p2]
        )
        print(f"{PHONEME_INVENTORY[p1]} {PHONEME_INVENTORY[p2]} {rate*100:.1f} {acc*100:.1f}")
