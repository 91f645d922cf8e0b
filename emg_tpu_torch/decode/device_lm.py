"""Device-resident n-gram language model: ARPA -> hash tables -> gathers.

Counterpart of ``emg_tpu/decode/device_lm.py``. Katz-backoff scoring (the
KenLM/ngram.py contract, PrefixTree.py:288-290) expressed branchlessly over
dense tensors so the beam search scores word continuations on the card
with no host round trip: unigram probs/backoffs are direct gathers; every
higher level 2..N lives in an open-addressing hash table keyed by the
n-gram's word-id tuple and probed with a fixed number of steps (table
sizing guarantees every key is found within the probe budget at build
time). The order is taken from the ARPA file. The host table build is the
JAX package's, copied as is, so both hold the same tables.

The hash is uint32 arithmetic mod 2^32. torch has no general uint32
arithmetic, so the device side computes it in int64, masked to 32 bits
after each multiply-add, with the final multiplier split into 16-bit
halves so that no product passes 2^63.

Word identity: callers use *lexicon* word ids; the build maps them onto the
LM's vocabulary (OOV -> <unk>) so device code never touches strings.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np
import torch

from emg_tpu_torch.decode.ngram import BOS, EOS, UNK, ArpaLanguageModel
from emg_tpu_torch.runtime import resolve_device

MAX_PROBES = 16
_MASK32 = 0xFFFFFFFF
_MIX = 1000003
_FINAL = 2654435761
_FINAL_HI, _FINAL_LO = _FINAL >> 16, _FINAL & 0xFFFF


def _tuple_hash_host(keys, size: int) -> int:
    """Iterative uint32 mixing, identical (mod 2^32) to the device hash."""
    with np.errstate(over="ignore"):
        h = np.uint32(int(keys[0]) % (2**32))
        for k in keys[1:]:
            h = np.uint32((np.uint64(h) * 1000003 + np.uint64(int(k))) % (2**32))
        return int((np.uint64(h) * 2654435761) % (2**32) % size)


def _build_tuple_table(columns: Sequence[Sequence[int]], values, backoffs):
    """Open-addressing table keyed by an int32 k-tuple (one entry per
    n-gram). ``columns`` is a sequence of k equal-length id sequences.
    Grows until every key fits within MAX_PROBES probes.
    Returns (keys (size, k) int32, vals, bos, size)."""
    k = len(columns)
    n = max(len(columns[0]) if columns else 0, 1)
    size = 1
    while size < 2 * n:
        size *= 2
    rows = list(zip(*columns)) if columns and len(columns[0]) else []
    while True:
        keys = np.full((size, k), -1, np.int32)
        tvals = np.zeros(size, np.float32)
        tbos = np.zeros(size, np.float32)
        ok = True
        for row, v, b in zip(rows, values, backoffs):
            h = _tuple_hash_host(row, size)
            for probe in range(MAX_PROBES):
                slot = (h + probe) % size
                if keys[slot, 0] == -1:
                    keys[slot] = row
                    tvals[slot] = v
                    tbos[slot] = b
                    break
            else:
                ok = False
                break
        if ok:
            return keys, tvals, tbos, size
        size *= 2


def tuple_hash(cols: Sequence[torch.Tensor], size: int) -> torch.Tensor:
    """The device hash of ``_tuple_hash_host`` over int64 id tensors: each
    id is taken mod 2^32 (a negative id as its uint32 bit pattern), the
    running value masked to 32 bits after each multiply-add."""
    h = cols[0] & _MASK32
    for c in cols[1:]:
        h = (h * _MIX + (c & _MASK32)) & _MASK32  # < 2^52 before the mask
    # h * 2654435761 may pass 2^63: multiply by the multiplier's 16-bit
    # halves, each product < 2^48, and keep the high one's low 16 bits
    h = ((((h * _FINAL_HI) & 0xFFFF) << 16) + h * _FINAL_LO) & _MASK32
    return h % size


@dataclass
class NgramTable:
    """One hash table for all n-grams of a single order."""

    keys: torch.Tensor  # (size, k) int64, -1-filled empty slots
    vals: torch.Tensor  # (size,) log10 prob
    bos: torch.Tensor  # (size,) log10 backoff weight
    size: int


@dataclass
class DeviceLM:
    """All-tensor LM state on one device."""

    order: int
    n_words: int  # lexicon vocabulary size (device id space)
    lex2lm: torch.Tensor  # (n_words + 3,) lexicon id -> LM id
    bos_id: int
    eos_id: int
    word_chars: torch.Tensor  # (n_words + 3,) characters per lexicon word
    uni_logp: torch.Tensor  # (n_lm,)
    uni_bo: torch.Tensor  # (n_lm,)
    tables: List[NgramTable]  # tables[i] holds the (i+2)-grams
    n_lm: int

    @property
    def ctx_width(self) -> int:
        """Context words a caller must carry (>=1 even for unigram LMs)."""
        return max(self.order - 1, 1)

    @property
    def device(self) -> torch.device:
        return self.uni_logp.device

    # -- device-side queries -------------------------------------------------
    def _lookup(self, level: int, cols):
        """Probe the table holding ``level``-grams with the id tuple ``cols``
        (len(cols) == level). Returns (found, logp, backoff).

        All MAX_PROBES slots are examined in ONE widened gather instead of
        a sequential probe loop (fewer launches per lookup). Open addressing
        never stores duplicate keys, so "any hit" equals the loop's
        first-hit rule."""
        t = self.tables[level - 2]
        h = tuple_hash(cols, t.size)
        probes = torch.arange(MAX_PROBES, dtype=h.dtype, device=h.device)
        s = (h[..., None] + probes) % t.size
        ks = t.keys[s]  # (..., P, k)
        tgt = torch.stack(cols, dim=-1)[..., None, :]  # (..., 1, k)
        hit = (ks == tgt).all(dim=-1)  # (..., P)
        found = hit.any(dim=-1)
        first = hit.to(torch.int32).argmax(dim=-1)  # 0 when no hit (gated by found)
        slot = torch.gather(s, -1, first[..., None])[..., 0]
        return found, t.vals[slot], t.bos[slot]

    def cond_logp(self, ctx: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """log10 p(w | ctx) with Katz backoff, all LM ids.

        ``ctx``: (..., ctx_width) context ids ordered oldest -> newest; -1
        marks absent slots (contexts fill from the right, so an absent
        oldest slot implies every older slot is absent too). ``w``: (...).
        Matches ArpaLanguageModel._word_score exactly at any order.
        """
        score = self.uni_logp[w]
        CW = ctx.shape[-1]
        for k in range(2, self.order + 1):
            c_cols = [ctx[..., CW - (k - 1) + j] for j in range(k - 1)]
            has = c_cols[0] >= 0  # oldest needed slot present => all present
            cs = [c.clamp(min=0) for c in c_cols]
            found, val, _ = self._lookup(k, cs + [w])
            found = found & has
            # backoff weight of the (k-1)-word context
            if k == 2:
                bo = torch.where(has, self.uni_bo[cs[0]], 0.0)
            else:
                ctx_found, _, ctx_bo = self._lookup(k - 1, cs)
                bo = torch.where(ctx_found & has, ctx_bo, 0.0)
            score = torch.where(found, val, bo + score)
        return score

    def shift_ctx(self, ctx: torch.Tensor, new_word: torch.Tensor) -> torch.Tensor:
        """Append ``new_word`` to each context, dropping the oldest slot."""
        return torch.cat([ctx[..., 1:], new_word[..., None]], dim=-1)

    def initial_ctx(self, shape) -> torch.Tensor:
        """(-1, ..., -1, <s>) contexts of the LM's width."""
        ctx = torch.full(tuple(shape) + (self.ctx_width,), -1, dtype=torch.int64,
                         device=self.device)
        ctx[..., -1] = self.bos_id
        return ctx


def build_device_lm(lm: ArpaLanguageModel, lexicon_words: Sequence[str],
                    device="cuda") -> DeviceLM:
    """Compile an ArpaLanguageModel into tables on ``device`` over a lexicon
    vocabulary (device word id = index into lexicon_words)."""
    device = resolve_device(device)
    vocab: List[str] = []
    lm_id = {}

    def intern(w: str) -> int:
        if w not in lm_id:
            lm_id[w] = len(vocab)
            vocab.append(w)
        return lm_id[w]

    for (w,) in lm.ngrams[1]:
        intern(w)
    for special in (UNK, BOS, EOS):
        intern(special)
    n_lm = len(vocab)
    unk = lm_id[UNK]

    uni_logp = np.full(n_lm, -99.0, np.float32)
    uni_bo = np.zeros(n_lm, np.float32)
    for (w,), (p, b) in lm.ngrams[1].items():
        uni_logp[lm_id[w]] = p
        uni_bo[lm_id[w]] = b

    def wid(w: str) -> int:
        return lm_id.get(w, unk)

    def on_device(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    tables: List[NgramTable] = []
    for k in range(2, lm.order + 1):
        cols = [[] for _ in range(k)]
        vals, bos = [], []
        grams = lm.ngrams[k] if k < len(lm.ngrams) else {}
        for gram, (p, b) in grams.items():
            for j, w in enumerate(gram):
                cols[j].append(wid(w))
            vals.append(p)
            bos.append(b)
        keys, tv, tb, size = _build_tuple_table(cols, vals, bos)
        tables.append(NgramTable(
            keys=on_device(keys, torch.int64), vals=on_device(tv, torch.float32),
            bos=on_device(tb, torch.float32), size=size,
        ))

    n_words = len(lexicon_words)
    lex2lm = np.zeros(n_words + 3, np.int64)
    chars = np.zeros(n_words + 3, np.int64)
    for i, w in enumerate(lexicon_words):
        lex2lm[i] = wid(w.lower())
        chars[i] = len(w)
    return DeviceLM(
        order=lm.order,
        n_words=n_words,
        lex2lm=on_device(lex2lm, torch.int64),
        bos_id=lm_id[BOS],
        eos_id=lm_id[EOS],
        word_chars=on_device(chars, torch.int64),
        uni_logp=on_device(uni_logp, torch.float32),
        uni_bo=on_device(uni_bo, torch.float32),
        tables=tables,
        n_lm=n_lm,
    )
