"""Sinusoidal positional encoding, scaled by 1/d_model.

Counterpart of ``emg_tpu/models/positional.py``, matching the reference
PositionalEncoding (transformer.py:406-435): standard interleaved sin/cos,
added to the input scaled by 1/d_model. (Its dropout is a training-time
step; the port serves only, so far.)
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn


@functools.lru_cache(maxsize=None)
def sinusoid_table(max_len: int, d_model: int) -> np.ndarray:
    pe = np.zeros((max_len, d_model), np.float32)
    position = np.arange(max_len, dtype=np.float32)[:, None]
    div_term = np.exp(
        np.arange(0, d_model, 2, dtype=np.float32) * (-np.log(10000.0) / d_model)
    )
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return pe


class PositionalEncoding(nn.Module):
    """``index_axis="position"`` is the standard per-position encoding.

    ``index_axis="batch"`` replicates the reference verbatim: it calls
    pos_decoder on the batch-first tensor (architecture.py:126-127) while
    PositionalEncoding indexes ``pe[:x.size(0)]`` assuming seq-first
    (transformer.py:432-434), so every position of batch row b receives the
    constant ``pe[b]``. Converted reference checkpoints need this mode.
    """

    def __init__(self, d_model: int, max_len: int = 5000, index_axis: str = "position"):
        super().__init__()
        if index_axis not in ("position", "batch"):
            raise ValueError(f"index_axis must be 'position' or 'batch', got {index_axis!r}")
        self.d_model = d_model
        self.max_len = max_len
        self.index_axis = index_axis
        # (max_len, d_model) table on the model's device; not a parameter
        self.register_buffer("table", torch.as_tensor(sinusoid_table(max_len, d_model)),
                             persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # x: (B, T, D)
        B, T = x.shape[0], x.shape[1]
        table = self.table
        if self.index_axis == "batch":
            if B >= self.max_len:
                raise ValueError("batch too large for the positional encoding")
            pe = table[:B][:, None, :]  # (B, 1, D): constant per batch row
        else:
            if T >= self.max_len:
                raise ValueError("sequence too long for the positional encoding")
            pe = table[None, :T, :]
        return x + (1.0 / self.d_model) * pe.to(x.dtype)
