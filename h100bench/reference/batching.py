"""Batch formation for the reference, copied so that it works the batches
out again from the utterances: the length-bucketed sampler
(``emg_tpu_torch/data/sampler.py::DynamicBatchSampler``, the reference
read_emg.py:144-338), the fixed-length packing and bucket padding
(``emg_tpu_torch/data/batching.py::make_packed_batch``, data_utils.py:165-174),
the int16 staging of training rows (``quantize_packed_raw`` and its
dequantization), and the window plan (``emg_tpu_torch/train/window.py::
plan_windows``).
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass
from typing import List, Sequence

import numpy as np
from scipy.stats import lognorm

PAD_VALUE = 42.0
PAD_ID = 42
ROW_BUCKETS = [4, 8, 16, 32, 48, 64, 96, 128]
BATCH_BUCKETS = [1, 2, 4, 8, 16, 32, 64]
FRAME_BUCKETS = [64, 128, 192, 256, 384, 512, 768, 1024, 1536, 2048]
TARGET_BUCKETS = [16, 32, 64, 128, 256]
RAW_INT16_SCALE = 32767.0 / 50.0
MAX_WINDOW = 32


def bucket_up(value: int, buckets: Sequence[int]) -> int:
    i = bisect.bisect_left(buckets, value)
    if i == len(buckets):
        raise ValueError(f"value {value} exceeds largest bucket {buckets[-1]}")
    return buckets[i]


def sampler_batches(lengths: Sequence[int], max_batch_length: int, n_buckets: int,
                    seed: int, epoch: int) -> List[List[int]]:
    """One epoch's batches of example indices (shuffled, bucketed by length,
    batch order permuted), as the sampler draws them from seed + epoch."""
    nb = n_buckets + 1
    latent = np.linspace(1 / nb, n_buckets / nb, n_buckets)
    quantiles = lognorm.ppf(latent, 1)
    bounds = np.array(sorted(quantiles * max_batch_length / quantiles[-1]))
    caps = [max(1, int(max_batch_length / b)) for b in bounds] + [1]
    rng = np.random.default_rng(seed + epoch)
    order = rng.permutation(len(lengths)).tolist()
    batches, open_ = [], [[] for _ in caps]
    for idx in order:
        b = int(np.searchsorted(bounds, lengths[idx]))
        open_[b].append(idx)
        if len(open_[b]) >= caps[b]:
            batches.append(open_[b])
            open_[b] = []
    batches += [b for b in open_ if b]
    perm = np.random.default_rng(seed + epoch).permutation(len(batches))
    return [batches[i] for i in perm]


def plan_windows(batch_sizes: Sequence[int], batch_size_grad: int, report_loss: int) -> List[int]:
    """Window lengths: cut at each apply, each report boundary and MAX_WINDOW."""
    windows, accum, run = [], 0, 0
    for step, n in enumerate(batch_sizes):
        accum += n
        run += 1
        cut = run >= MAX_WINDOW or (step + 1) % report_loss == 0
        if accum >= batch_size_grad:
            accum, cut = 0, True
        if cut:
            windows.append(run)
            run = 0
    if run:
        windows.append(run)
    return windows


@dataclass
class Batch:
    packed: np.ndarray  # (rows, chunk, C) float32 as the step sees it (int16-staged)
    n_rows: int
    lengths: np.ndarray  # (B,) frames, 0 for pad utterances
    offsets: np.ndarray  # (B,)
    targets: np.ndarray  # (B, S) int64, PAD-filled
    target_lengths: np.ndarray  # (B,)
    n_examples: int
    max_frames: int


def make_batch(rows: List[np.ndarray], frames: List[int], phones: List[np.ndarray],
               chunk: int, int16: bool) -> Batch:
    total = sum(r.shape[0] for r in rows)
    tail = (-total) % chunk
    parts = list(rows)
    if tail:
        parts.append(np.full((tail, rows[0].shape[1]), PAD_VALUE, np.float32))
    flat = np.concatenate(parts, axis=0)
    packed = flat.reshape(-1, chunk, flat.shape[1])
    n_rows = packed.shape[0]
    rows_b = bucket_up(n_rows, ROW_BUCKETS)
    if rows_b > n_rows:
        packed = np.concatenate(
            [packed, np.full((rows_b - n_rows, chunk, packed.shape[2]), PAD_VALUE, np.float32)])
    B = len(rows)
    B_b = bucket_up(B, BATCH_BUCKETS)
    lengths = np.zeros(B_b, np.int64)
    lengths[:B] = frames
    offsets = np.concatenate([[0], np.cumsum(lengths)[:-1]]).astype(np.int64)
    S_b = bucket_up(max(p.shape[0] for p in phones), TARGET_BUCKETS)
    targets = np.full((B_b, S_b), PAD_ID, np.int64)
    tlens = np.zeros(B_b, np.int64)
    for i, p in enumerate(phones):
        targets[i, : p.shape[0]] = p
        tlens[i] = p.shape[0]
    packed = packed.astype(np.float32)
    if int16:
        q = np.clip(np.rint(packed * RAW_INT16_SCALE), -32767, 32767).astype(np.int16)
        packed = q.astype(np.float32) * np.float32(1.0 / RAW_INT16_SCALE)
    return Batch(packed, n_rows, lengths, offsets, targets, tlens, B,
                 bucket_up(max(frames), FRAME_BUCKETS))
