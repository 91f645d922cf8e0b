"""Per-utterance EMG preprocessing: filters -> resample -> features.

Counterpart of ``emg_tpu/dsp/pipeline.py::preprocess_emg``: the reference's
load_utterance DSP chain (read_emg.py:57-93) on the buffer's device:
60 Hz-harmonic notches + drift high-pass over the neighbor-extended signal,
context strip, dual-rate resample (689.06 Hz raw path, 516.79 Hz feature
path), and 112-dim featurization, over a fixed bucket-length buffer with
``n_total`` valid rows.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from emg_tpu_torch.dsp import filters
from emg_tpu_torch.dsp.features import get_emg_features_masked
from emg_tpu_torch.dsp.resample import subsample_masked

RAW_RATE = 689.06
FEAT_RATE = 516.79
SOURCE_RATE = 1000.0


class Preprocessed(NamedTuple):
    emg_features: torch.Tensor  # (F_max, 112); valid rows [0, n_frames)
    emg: torch.Tensor  # (T_feat_max, C) 516.79 Hz signal
    emg_orig: torch.Tensor  # (T_raw_max, C) 689.06 Hz signal
    n_frames: int
    n_feat: int  # valid rows of emg
    n_raw: int  # valid rows of emg_orig


def preprocess_emg(
    x: torch.Tensor,
    n_total: int,
    n_before: int,
    n_after: int,
    remove_channels: tuple = (),
) -> Preprocessed:
    """Filter + resample + featurize one utterance.

    Args:
      x: (T_max, C) float32 raw 1000 Hz EMG: neighbor-before ++ utterance ++
         neighbor-after, zero-padded to the bucket length T_max.
      n_total: total valid samples (before+utterance+after).
      n_before / n_after: context sample counts stripped after filtering.
      remove_channels: channel indices zeroed after resampling
        (reference read_emg.py:79-81).
    """
    y = filters.notch_harmonics(x, 60.0, SOURCE_RATE, n=n_total)
    y = filters.remove_drift(y, SOURCE_RATE, n=n_total)

    # strip the neighbor context: shift rows up by n_before
    T = y.shape[0]
    idx = (torch.arange(T, device=y.device) + n_before).clamp(0, T - 1)
    y = y.index_select(0, idx)
    n_mid = n_total - n_before - n_after

    emg_orig, n_raw = subsample_masked(y, n_mid, RAW_RATE, SOURCE_RATE)
    emg, n_feat = subsample_masked(y, n_mid, FEAT_RATE, SOURCE_RATE)

    if remove_channels:
        drop = torch.as_tensor([int(c) for c in remove_channels], device=emg.device)
        emg = emg.index_fill(1, drop, 0.0)
        emg_orig = emg_orig.index_fill(1, drop, 0.0)

    feats, n_frames = get_emg_features_masked(emg, n_feat)
    return Preprocessed(feats, emg, emg_orig, n_frames, n_feat, n_raw)


def align_lengths(n_frames: int):
    """The reference's post-featurization alignment (read_emg.py:88-93):
    emg keeps rows [6, 6+6*F), emg_orig keeps rows [8, 8+8*F)."""
    return (6, 6 * n_frames), (8, 8 * n_frames)
