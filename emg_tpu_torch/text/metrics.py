"""Word/phoneme error rate scoring (jiwer.wer-compatible).

The reference scores PER and WER with ``jiwer.wer`` on whitespace-separated
strings (recognition_model.py:246-253, 343-350): with list inputs the result
is a single corpus-level rate, ``sum(edit distances) / sum(len(reference))``.
"""

from __future__ import annotations

from typing import List, Sequence, Union


def edit_distance(ref: Sequence, hyp: Sequence) -> int:
    """Levenshtein distance over token sequences (two-row DP)."""
    n, m = len(ref), len(hyp)
    if n == 0:
        return m
    if m == 0:
        return n
    prev = list(range(m + 1))
    for i in range(1, n + 1):
        cur = [i] + [0] * m
        r = ref[i - 1]
        for j in range(1, m + 1):
            cost = 0 if r == hyp[j - 1] else 1
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + cost)
        prev = cur
    return prev[m]


def _tokenize(x: Union[str, List[str]]) -> List[List[str]]:
    if isinstance(x, str):
        x = [x]
    return [s.split() for s in x]


def wer(reference: Union[str, List[str]], hypothesis: Union[str, List[str]]) -> float:
    """Corpus-level word error rate over whitespace-tokenized sentences."""
    refs = _tokenize(reference)
    hyps = _tokenize(hypothesis)
    assert len(refs) == len(hyps), "reference/hypothesis count mismatch"
    total_dist = sum(edit_distance(r, h) for r, h in zip(refs, hyps))
    total_ref = sum(len(r) for r in refs)
    if total_ref == 0:
        return 0.0 if total_dist == 0 else float("inf")
    return total_dist / total_ref
