"""KV-cached greedy autoregressive decoding.

Counterpart of ``emg_tpu/decode/greedy.py`` (``greedy_decode_cached``,
``matrix_to_phone_strings``, ``run_greedy``). Semantics match the reference
run_greedy (greedy_search.py:7-53): start from <S>, argmax each step, keep
extending the raw argmax chain even after a sequence emits </S>, stop when
every sequence has emitted </S> or after ``num_steps`` steps, and report
each sequence cut at its first </S> with <PAD> fill: the matrix used for
the token-accuracy metric. A Python loop replaces the JAX package's
``lax.while_loop``; the all-ended test reads one flag from the device per
step.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from emg_tpu_torch.data.batching import PackedBatch
from emg_tpu_torch.text.phonemes import END_ID, PAD_ID, PHONEME_INVENTORY, START_ID


def encode_batch(model, batch: PackedBatch, max_frames: int):
    """Move a host batch to the model's device and run the encoder.
    Returns (memory, enc_logits, src_pad_mask)."""
    device = model.device

    def t(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    return model.encode(
        t(batch.packed_raw, torch.float32), int(batch.n_rows),
        t(batch.offsets, torch.int64), t(batch.lengths, torch.int64), max_frames,
    )


def greedy_loop(model, memory, src_pad_mask, max_steps: int,
                num_steps: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy decoding from encoder memory. Returns (out_matrix, raw_tokens),
    each (B, max_steps+1): <S>, then the argmax chain cut at (and including)
    the first </S>, PAD elsewhere; and the raw chain."""
    S = max_steps + 1  # +1 for the leading <S>
    num_steps = max_steps if num_steps is None else num_steps
    B = memory.shape[0]
    device = memory.device
    cross_kvs = model.project_cross_kvs(memory)
    caches = model.init_decode_cache(B, S)
    tokens = torch.full((B, S), PAD_ID, dtype=torch.int64, device=device)
    tokens[:, 0] = START_ID
    ended = torch.zeros(B, dtype=torch.bool, device=device)
    s = 1
    while s <= num_steps and s < S:
        logits = model.decode_step(tokens[:, s - 1], s - 1, caches, cross_kvs, tokens, src_pad_mask)
        predicted = logits.argmax(dim=-1)
        tokens[:, s] = predicted
        ended |= predicted == END_ID
        s += 1
        if bool(ended.all()):
            break

    is_end = tokens == END_ID
    first_end = torch.where(is_end.any(dim=1), is_end.int().argmax(dim=1), S)
    keep = torch.arange(S, device=device)[None, :] <= first_end[:, None]
    out = torch.where(keep, tokens, PAD_ID)
    return out, tokens


@torch.inference_mode()
def greedy_decode_cached(model, batch: PackedBatch, max_frames: int, max_steps: int,
                         num_steps: Optional[int] = None):
    """Encode ``batch`` and decode it greedily with KV caches. Returns
    (out_matrix, raw_tokens), each (B, max_steps+1)."""
    memory, _, src_pad_mask = encode_batch(model, batch, max_frames)
    return greedy_loop(model, memory, src_pad_mask, max_steps, num_steps)


def matrix_to_phone_strings(matrix: np.ndarray) -> List[str]:
    """Rows of the accuracy matrix -> space-joined phone name strings."""
    out = []
    for row in np.asarray(matrix):
        names = [PHONEME_INVENTORY[int(t)] for t in row if int(t) != PAD_ID]
        out.append(" ".join(names))
    return out


def run_greedy(model, batch: PackedBatch, max_frames: int, target_len: int,
               static_cap: Optional[int] = None) -> Tuple[List[str], np.ndarray]:
    """Host wrapper mirroring the reference signature: returns
    (phone strings, accuracy matrix cut to target_len+1 columns).
    ``target_len`` is tgt.shape[1] (the padded target length minus <S>)."""
    cap = static_cap if static_cap is not None else target_len
    out, _ = greedy_decode_cached(model, batch, max_frames, cap, num_steps=target_len)
    out = out.cpu().numpy()[:, : target_len + 1]
    return matrix_to_phone_strings(out), out
