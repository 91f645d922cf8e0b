"""Greedy autoregressive decoding, KV-cached or over the full prefix.

Counterpart of ``emg_tpu/decode/greedy.py`` (``greedy_decode``,
``greedy_decode_cached``, ``matrix_to_phone_strings``, ``run_greedy``).
Semantics match the reference run_greedy (greedy_search.py:7-53): start
from <S>, argmax each step, keep extending the raw argmax chain even after
a sequence emits </S>, stop when every sequence has emitted </S> or after
``num_steps`` steps, and report each sequence cut at its first </S> with
<PAD> fill: the matrix used for the token-accuracy metric.

The JAX package runs the loop as a ``lax.while_loop``. Here its body is a
function on a state of tensors (tokens, ended, the step ``s``, the caches
or the memory, ``done``), gated on the device by JAX's condition ``s <=
num_steps & s < S & ~all(ended)``: once that fails, a step writes no token
and ``s`` stays. ``decode/graphs.py::LoopRunner`` runs k such steps between
reads of ``done``: eagerly on the CPU, as one CUDA graph per (B, S, T,
dtype) on the card. ``num_steps`` lives on the device, as JAX's traced one
does, so one graph serves every target length of a (B, S) bucket. Whatever
k is, ``out`` and the raw tokens are JAX's.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from emg_tpu_torch.data.batching import PackedBatch
from emg_tpu_torch.decode.graphs import LoopRunner
from emg_tpu_torch.text.phonemes import END_ID, PAD_ID, PHONEME_INVENTORY, START_ID


def encode_batch(model, batch: PackedBatch, max_frames: int):
    """Move a batch (numpy arrays, or tensors already on the device) to the
    model's device and run the encoder. Returns (memory, enc_logits,
    src_pad_mask)."""
    device = model.device

    def t(a, dtype):
        return torch.as_tensor(a if isinstance(a, torch.Tensor) else np.asarray(a),
                               dtype=dtype, device=device)

    return model.encode(
        t(batch.packed_raw, torch.float32), int(batch.n_rows),
        t(batch.offsets, torch.int64), t(batch.lengths, torch.int64), max_frames,
    )


def _running(st) -> torch.Tensor:
    """JAX's loop condition, on the device."""
    tokens = st["tokens"]
    return (st["s"] <= st["num_steps"]) & (st["s"] < tokens.shape[1]) & ~st["ended"].all()


def _advance(st, logits: torch.Tensor):
    """The step's argmax, written at s behind the loop's condition."""
    tokens, s = st["tokens"], st["s"]
    go = _running(st)
    predicted = logits.argmax(dim=-1)
    at_s = torch.arange(tokens.shape[1], device=tokens.device) == s
    st = dict(st, tokens=torch.where(at_s & go, predicted[:, None], tokens),
              ended=st["ended"] | (go & (predicted == END_ID)), s=s + go.long())
    st["done"] = ~_running(st)
    return st


def _cached_body(model):
    """One KV-cached step: the token at s - 1 through ``decode_step``."""
    def body(st):
        prev = st["s"] - 1
        token_in = st["tokens"].index_select(1, prev.reshape(1))[:, 0]
        logits = model.decode_step(token_in, prev, st["caches"], st["cross_kvs"], st["tokens"],
                                   st["src_pad_mask"])
        return _advance(st, logits)
    return body


def _full_body(model):
    """One uncached step: the whole prefix through ``model.decode`` (the
    reference's re-run), its logits at s - 1."""
    def body(st):
        logits = model.decode(st["tokens"], st["memory"], st["src_pad_mask"])
        return _advance(st, logits.index_select(1, (st["s"] - 1).reshape(1))[:, 0])
    return body


@torch.inference_mode()
def greedy_loop(model, memory, src_pad_mask, max_steps: int, num_steps: Optional[int] = None,
                use_cache: bool = True, runner: Optional[LoopRunner] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy decoding from encoder memory. Returns (out_matrix, raw_tokens),
    each (B, max_steps+1): <S>, then the argmax chain cut at (and including)
    the first </S>, PAD elsewhere; and the raw chain. ``runner`` (default:
    a new ``LoopRunner(model)``) runs the loop."""
    runner = LoopRunner(model) if runner is None else runner
    runner.check_model(model)
    S = max_steps + 1  # +1 for the leading <S>
    num_steps = max_steps if num_steps is None else num_steps
    B, T = memory.shape[:2]
    device = memory.device
    cross_kvs = model.project_cross_kvs(memory) if use_cache else None

    def init(old):
        tokens = torch.full((B, S), PAD_ID, dtype=torch.int64, device=device)
        tokens[:, 0] = START_ID
        st = dict(tokens=tokens, ended=torch.zeros(B, dtype=torch.bool, device=device),
                  s=torch.ones((), dtype=torch.int64, device=device),
                  num_steps=torch.full((), num_steps, dtype=torch.int64, device=device),
                  done=torch.zeros((), dtype=torch.bool, device=device),
                  src_pad_mask=src_pad_mask)
        if not use_cache:
            st["memory"] = memory
            return st
        st["cross_kvs"] = cross_kvs
        # stale rows would sit under the structural -inf mask, where a NaN
        # bit pattern still poisons 0 * v: each run starts from zeros
        st["caches"] = (model.init_decode_cache(B, S) if old is None
                        else tuple(c.zero_() for c in old["caches"]))
        return st

    body = _cached_body(model) if use_cache else _full_body(model)
    key = ("greedy", use_cache, B, S, T, model.dtype)
    tokens = runner.run(key, init, body)["tokens"].clone()
    is_end = tokens == END_ID
    first_end = torch.where(is_end.any(dim=1), is_end.int().argmax(dim=1), S)
    keep = torch.arange(S, device=device)[None, :] <= first_end[:, None]
    out = torch.where(keep, tokens, PAD_ID)
    return out, tokens


@torch.inference_mode()
def greedy_decode_cached(model, batch: PackedBatch, max_frames: int, max_steps: int,
                         num_steps: Optional[int] = None, runner: Optional[LoopRunner] = None):
    """Encode ``batch`` and decode it greedily with KV caches. Returns
    (out_matrix, raw_tokens), each (B, max_steps+1)."""
    memory, _, src_pad_mask = encode_batch(model, batch, max_frames)
    return greedy_loop(model, memory, src_pad_mask, max_steps, num_steps, True, runner)


@torch.inference_mode()
def greedy_decode(model, batch: PackedBatch, max_frames: int, max_steps: int,
                  num_steps: Optional[int] = None, runner: Optional[LoopRunner] = None):
    """Encode ``batch`` and decode it greedily, each step re-running the
    decoder over the whole prefix (the reference's way; the same result as
    ``greedy_decode_cached``). Returns (out_matrix, raw_tokens)."""
    memory, _, src_pad_mask = encode_batch(model, batch, max_frames)
    return greedy_loop(model, memory, src_pad_mask, max_steps, num_steps, False, runner)


def matrix_to_phone_strings(matrix: np.ndarray) -> List[str]:
    """Rows of the accuracy matrix -> space-joined phone name strings."""
    out = []
    for row in np.asarray(matrix):
        names = [PHONEME_INVENTORY[int(t)] for t in row if int(t) != PAD_ID]
        out.append(" ".join(names))
    return out


def run_greedy(model, batch: PackedBatch, max_frames: int, target_len: int,
               static_cap: Optional[int] = None, use_cache: bool = True,
               runner: Optional[LoopRunner] = None) -> Tuple[List[str], np.ndarray]:
    """Host wrapper mirroring the reference signature: returns
    (phone strings, accuracy matrix cut to target_len+1 columns).
    ``target_len`` is tgt.shape[1] (the padded target length minus <S>)."""
    cap = static_cap if static_cap is not None else target_len
    decode = greedy_decode_cached if use_cache else greedy_decode
    out, _ = decode(model, batch, max_frames, cap, num_steps=target_len, runner=runner)
    out = out.cpu().numpy()[:, : target_len + 1]
    return matrix_to_phone_strings(out), out
