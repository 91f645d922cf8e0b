"""Audio chunk splicing (reference data_utils.py:187-209).

Counterpart of ``emg_tpu/utils/audio.py``, a numpy copy of it.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def splice_audio(chunks: Sequence[np.ndarray], overlap: int) -> np.ndarray:
    """Overlap-add chunks with linear crossfade ramps; the result's own
    beginning and end are faded too (reference behavior)."""
    chunks = [c.copy() for c in chunks]
    assert all(c.shape[0] >= overlap for c in chunks), "chunk shorter than overlap"

    result_len = sum(c.shape[0] for c in chunks) - overlap * (len(chunks) - 1)
    result = np.zeros(result_len, dtype=chunks[0].dtype)
    ramp_up = np.linspace(0, 1, overlap)
    ramp_down = np.linspace(1, 0, overlap)

    i = 0
    for chunk in chunks:
        n = chunk.shape[0]
        chunk[:overlap] *= ramp_up
        chunk[-overlap:] *= ramp_down
        result[i : i + n] += chunk
        i += n - overlap
    return result
