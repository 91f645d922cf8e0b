"""Fixed-length chunk packing and bucketed batch assembly.

The reference packs each batch's concatenated raw EMG into fixed 1600-sample
rows before the CNN (data_utils.py:165-174 + recognition_model.py:77), runs
the CNN over the packed rows, then re-splits to true utterance lengths and
re-pads (architecture.py:116-117). The same packing is kept here, including
the quirk that padding is filled with the value 42.0 (FLAGS.pad) and that
BatchNorm statistics are computed over packed rows with cross-utterance
content. Every dimension is padded up to the same buckets as the JAX
package, so both packages see identical batches.
"""

from __future__ import annotations

import bisect
import dataclasses
from dataclasses import dataclass
from typing import List, Sequence

import numpy as np
import torch

from emg_tpu_torch.utils.profiling import span

PAD_VALUE = 42.0  # reference pads raw EMG with FLAGS.pad == 42

# bucketed shapes (#packed rows, #utterances, max enc frames, max tgt len)
ROW_BUCKETS = [4, 8, 16, 32, 48, 64, 96, 128]
BATCH_BUCKETS = [1, 2, 4, 8, 16, 32, 64]
FRAME_BUCKETS = [64, 128, 192, 256, 384, 512, 768, 1024, 1536, 2048]
TARGET_BUCKETS = [16, 32, 64, 128, 256]


def bucket_up(value: int, buckets: Sequence[int]) -> int:
    i = bisect.bisect_left(buckets, value)
    if i == len(buckets):
        raise ValueError(f"value {value} exceeds largest bucket {buckets[-1]}")
    return buckets[i]


@dataclass
class PackedBatch:
    """Bucketed host batch for the model (numpy arrays)."""

    packed_raw: np.ndarray  # (N_rows, chunk, C) float32, PAD_VALUE-filled tail
    n_rows: np.int32  # valid packed rows (for masked BatchNorm)
    lengths: np.ndarray  # (B,) int32 encoder frame counts (0 for pad utts)
    offsets: np.ndarray  # (B,) int32 start frame of each utterance in the
    #                       concatenated post-CNN stream
    targets: np.ndarray  # (B, S) int64 phoneme ids, PAD(42)-filled
    target_lengths: np.ndarray  # (B,) int32 incl. <S>/</S> (0 for pad utts)
    n_examples: np.int32  # true batch size


def pack_raw_emg(tensors: List[np.ndarray], length: int) -> np.ndarray:
    """combine_fixed_length (data_utils.py:165-174): concatenate along time,
    pad the remainder with PAD_VALUE, reshape to rows."""
    total = sum(t.shape[0] for t in tensors)
    tail = (-total) % length
    parts = list(tensors)
    if tail:
        parts.append(np.full((tail,) + tensors[0].shape[1:], PAD_VALUE, tensors[0].dtype))
        total += tail
    flat = np.concatenate(parts, axis=0)
    return flat.reshape(total // length, length, *tensors[0].shape[1:])


def _round_up(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple


def make_packed_batch(
    raw_emg: List[np.ndarray],
    lengths: List[int],
    phonemes_int: List[np.ndarray],
    chunk: int = 1600,
    pad_id: int = 42,
    row_multiple: int = 1,
    batch_multiple: int = 1,
) -> PackedBatch:
    """Assemble a bucketed batch.

    ``lengths`` are encoder frame counts (emg feature rows); each utterance's
    raw EMG has 8x as many samples and the CNN subsamples by 8, so utterance
    b occupies frames [offsets[b], offsets[b]+lengths[b]) of the packed
    post-CNN stream.

    ``row_multiple`` / ``batch_multiple`` round the padded row count and
    batch size up to multiples of the mesh's data axis, so they split
    evenly over its ranks (``parallel/mesh.py::shard_batch``), as in the
    JAX package.
    """
    with span("data.pack"):
        B = len(raw_emg)
        rows = pack_raw_emg(raw_emg, chunk)
        n_rows = rows.shape[0]
        rows_b = _round_up(bucket_up(n_rows, ROW_BUCKETS), row_multiple)
        if rows_b > n_rows:
            pad_rows = np.full((rows_b - n_rows, chunk, rows.shape[2]), PAD_VALUE, rows.dtype)
            rows = np.concatenate([rows, pad_rows], axis=0)

        B_b = _round_up(bucket_up(B, BATCH_BUCKETS), batch_multiple)
        lengths_arr = np.zeros(B_b, np.int32)
        lengths_arr[:B] = lengths
        offsets = np.concatenate([[0], np.cumsum(lengths_arr)[:-1]]).astype(np.int32)

        S = max(p.shape[0] for p in phonemes_int)
        S_b = bucket_up(S, TARGET_BUCKETS)
        targets = np.full((B_b, S_b), pad_id, np.int64)
        tlens = np.zeros(B_b, np.int32)
        for i, p in enumerate(phonemes_int):
            targets[i, : p.shape[0]] = p
            tlens[i] = p.shape[0]

        return PackedBatch(
            packed_raw=rows.astype(np.float32),
            n_rows=np.int32(n_rows),
            lengths=lengths_arr,
            offsets=offsets,
            targets=targets,
            target_lengths=tlens,
            n_examples=np.int32(B),
        )


# -- int16 staging ----------------------------------------------------------
# The soft clip (reference read_emg.py:426-428, 50*tanh(x/50)) bounds
# |packed_raw| <= 50, so the raw rows quantize to int16 at a fixed scale
# with ~0.0015 absolute resolution, halving the bytes of the host->device
# copy. The rounding is lossy and is part of what the JAX trainer feeds its
# step, so the port's trainer stages training batches the same way and the
# step dequantizes on the device.
RAW_INT16_SCALE = 32767.0 / 50.0


def frame_bucket_for(lengths: Sequence[int]) -> int:
    """The encoder's frame bucket for a batch of these frame counts."""
    return bucket_up(max(lengths), FRAME_BUCKETS)


def quantize_packed_raw(pb: PackedBatch) -> PackedBatch:
    """Host side: packed_raw float32 -> int16."""
    with span("data.int16"):
        if pb.packed_raw.dtype == np.int16:
            return pb
        q = np.clip(np.rint(np.asarray(pb.packed_raw) * RAW_INT16_SCALE), -32767, 32767)
        return dataclasses.replace(pb, packed_raw=q.astype(np.int16))


def dequantize_packed_raw(packed_raw: torch.Tensor) -> torch.Tensor:
    """Device side: int16 packed_raw -> float32 (float32 passes through)."""
    if packed_raw.dtype != torch.int16:
        return packed_raw
    return packed_raw.float() * (1.0 / RAW_INT16_SCALE)
