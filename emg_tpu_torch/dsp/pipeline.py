"""EMG preprocessing: filters -> resample -> features.

Counterpart of ``emg_tpu/dsp/pipeline.py``: the reference's load_utterance
DSP chain (read_emg.py:57-93) on the buffer's device: 60 Hz-harmonic
notches + drift high-pass over the neighbor-extended signal, context strip,
dual-rate resample (689.06 Hz raw path, 516.79 Hz feature path), and
112-dim featurization, over a fixed bucket-length buffer with ``n_total``
valid rows (``preprocess_emg``), or over a batch of such buffers with
per-utterance lengths (``preprocess_emg_batched``); ``preprocess_emg_host``
wraps it for one exact-length utterance given as numpy arrays.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from emg_tpu_torch.dsp import filters
from emg_tpu_torch.dsp.features import get_emg_features_masked
from emg_tpu_torch.dsp.resample import subsample_masked
from emg_tpu_torch.runtime import resolve_device

RAW_RATE = 689.06
FEAT_RATE = 516.79
SOURCE_RATE = 1000.0


class Preprocessed(NamedTuple):
    """One utterance's outputs, with int counts; from
    ``preprocess_emg_batched`` every field has a leading U axis and the
    counts are (U,) int64 tensors on the device."""

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


def preprocess_emg_batched(
    xs: torch.Tensor,
    n_totals,
    n_befores,
    n_afters,
    remove_channels: tuple = (),
) -> Preprocessed:
    """Filter + resample + featurize a batch of unequal-length utterances.

    Args:
      xs: (U, T_max, C) float32 raw 1000 Hz EMG buffers, zero-padded per
        utterance.
      n_totals / n_befores / n_afters: (U,) per-utterance sample counts:
        integer tensors (on xs's device, for a call that copies nothing to
        it) or sequences of ints.

    The U utterances fold onto the channel axis, (T_max, U*C), so the IIR
    scan (kernel 1 on the card) runs once a filter pass over U*C*m rows;
    the length-dependent edge extensions, the context strip and the
    resampling use per-column valid lengths, and the features take the
    utterances as a batch axis. Nothing is read back to the host. Returns a
    ``Preprocessed`` whose fields all carry a leading U axis.
    """
    U, T, C = xs.shape
    device = xs.device
    n_totals, n_befores, n_afters = (
        torch.as_tensor(n, dtype=torch.int64, device=device)
        for n in (n_totals, n_befores, n_afters)
    )

    def per_column(n):  # (U,) -> (U*C,), utterance-major as the fold
        return n[:, None].expand(U, C).reshape(U * C)

    folded = xs.transpose(0, 1).reshape(T, U * C)
    n_cols = per_column(n_totals)
    y = filters.notch_harmonics(folded, 60.0, SOURCE_RATE, n=n_cols)
    y = filters.remove_drift(y, SOURCE_RATE, n=n_cols)

    # strip the neighbor context per column: shift rows up by n_before
    idx = (torch.arange(T, device=device)[:, None] + per_column(n_befores)[None, :]).clamp(0, T - 1)
    y = torch.gather(y, 0, idx)
    n_mid_cols = per_column(n_totals - n_befores - n_afters)

    emg_orig, n_raw = subsample_masked(y, n_mid_cols, RAW_RATE, SOURCE_RATE)
    emg, n_feat = subsample_masked(y, n_mid_cols, FEAT_RATE, SOURCE_RATE)
    emg_orig = emg_orig.reshape(-1, U, C).transpose(0, 1).contiguous()  # (U, T', C)
    emg = emg.reshape(-1, U, C).transpose(0, 1).contiguous()
    n_raw, n_feat = n_raw[::C], n_feat[::C]

    for c in remove_channels:
        emg[:, :, int(c)] = 0.0
        emg_orig[:, :, int(c)] = 0.0

    feats, n_frames = get_emg_features_masked(emg, n_feat)
    return Preprocessed(feats, emg, emg_orig, n_frames, n_feat, n_raw)


def align_lengths(n_frames: int):
    """The reference's post-featurization alignment (read_emg.py:88-93):
    emg keeps rows [6, 6+6*F), emg_orig keeps rows [8, 8+8*F)."""
    return (6, 6 * n_frames), (8, 8 * n_frames)


def preprocess_emg_host(
    raw_emg: np.ndarray,
    before: np.ndarray,
    after: np.ndarray,
    remove_channels=(),
    max_frames: Optional[int] = None,
    device="cuda",
):
    """Exact-length (not bucketed) use: one utterance and its neighbor
    context, (T, C) numpy arrays, through ``preprocess_emg`` on ``device``
    (the card unless the CPU is asked for). Returns (emg_features, emg,
    emg_orig) with the reference's slicing and frame alignment
    (``align_lengths``), as float32 numpy arrays; ``max_frames`` caps the
    frames."""
    x = np.concatenate([before, raw_emg, after], axis=0).astype(np.float32)
    out = preprocess_emg(torch.as_tensor(x, device=resolve_device(device)), x.shape[0],
                         before.shape[0], after.shape[0], tuple(remove_channels))
    F = int(out.n_frames)
    if max_frames is not None:
        F = min(F, max_frames)
    (e0, elen), (r0, rlen) = align_lengths(F)
    return (out.emg_features[:F].cpu().numpy(), out.emg[e0 : e0 + elen].cpu().numpy(),
            out.emg_orig[r0 : r0 + rlen].cpu().numpy().astype(np.float32))
