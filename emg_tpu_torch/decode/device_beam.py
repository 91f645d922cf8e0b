"""Lexicon-constrained beam search on the card.

Counterpart of ``emg_tpu/decode/device_beam.py``. The whole search runs on
the device: decoder steps, prefix-tree masking/stepping, word-boundary LM
expansion with the device hash-table LM (``decode/device_lm.py``), length
penalties, and the finished-hypothesis buffer. The JAX package compiles it
into one ``lax.while_loop`` (and vmaps that over utterances); here the step
is a body on a state of tensors that carries each lane's position ``t``
((U,) on the device), and ``decode/graphs.py::LoopRunner`` runs it: on the
card as one CUDA graph of k steps per utterance count U, replayed; on the
CPU (or with ``graphed=False``) eagerly. The step body is written once over
a leading utterance (lane) axis U: ``search`` is U = 1 and ``search_many``
is U = ``len(batches)``, both with every lane at one ``t`` (lock-step), and
both give the same result for an utterance. ``decode/continuous.py`` runs
the same body with each lane at its own ``t`` (``lockstep=False``).
``search_from_raw`` starts from the raw 1 kHz signal: the device DSP, the
soft clip and the row packing of the JAX package's ``_build_raw``, then
``search``. With ``cfg.quantize_int8`` the decoder's matmul weights are
int8 (``utils/quantize.py``), quantized after the serving cast, as in JAX.

Semantics carried over from the JAX package:

- top-W of (H x 41) and the finished buffer's top-F keep ``lax.top_k``'s
  tie order (the lower flat index first) by a stable descending sort, so
  dead rows (all -inf) and -inf buffer slots order as there;
- a lane runs in lock-step with the others; from its own ``max_len`` on,
  its rows are gated dead (``alive &= t < max_len``, the JAX "static"
  variant's gate), so its finished buffer no longer changes, as a
  vmapped while-loop freezes a finished lane's carry;
- expansion rows share their parent's history (parent = row mod W), so
  only the first W rows of each lane run through ``decode_step``;
- the previous step's row selection reorders the K/V caches at the start
  of the next step, by ``index_select`` on the row axis into the other of
  two cache buffers (exact; the JAX package's one-hot matmul is exact
  too), so an even k ends each block with the caches where it began.

In lock-step, ``t`` advances only while the loop's condition holds: for
``beam_scan="early_exit"`` JAX's while condition (some lane can still make
progress), for ``"static"`` its scan's length (S-1 steps). A step behind a
failed condition is inert: every row is gated dead, so the finished buffer
does not change. ``early_exit`` reads one flag per k steps; ``"static"``
runs ceil((S-1)/k) blocks and reads nothing. Nothing else in a step
synchronizes with the host, and the final ``t`` is the number of steps the
search ran. With ``lockstep=False`` each lane's ``t`` advances while that
lane can make progress (JAX's ``_carry_done`` is false) and then stays, so
that no position reaches S (JAX clamps its cache write there). Score arithmetic is float32 (the host ``BeamSearcher``
accumulates float64), which can reorder near-tied hypotheses.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from emg_tpu_torch.config import DecodeConfig
from emg_tpu_torch.data.batching import PAD_VALUE, PackedBatch, bucket_up
from emg_tpu_torch.decode.device_lm import DeviceLM
from emg_tpu_torch.decode.graphs import READ_EVERY, LoopRunner
from emg_tpu_torch.decode.greedy import encode_batch
from emg_tpu_torch.decode.prefix_tree import CompiledTree
from emg_tpu_torch.dsp.features import n_frames as frames_of
from emg_tpu_torch.dsp.pipeline import FEAT_RATE, SOURCE_RATE, preprocess_emg
from emg_tpu_torch.dsp.resample import subsample_length
from emg_tpu_torch.text.phonemes import PAD_ID, START_ID

NEG = float("-inf")

# raw 1 kHz sample-count buckets of search_from_raw (the JAX package's);
# 1280 samples = 1.28 s, the shortest corpus utterances
RAW_SAMPLE_BUCKETS = [1280, 1920, 2560, 3840, 5120, 7680, 10240, 15360]


def top_k_stable(x: torch.Tensor, k: int):
    """Top k along the last axis, ties by the lower index (``lax.top_k``'s
    order; ``torch.topk`` promises none on the card)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


class DeviceBeamSearcher:
    def __init__(self, model, tree: CompiledTree, device_lm: DeviceLM,
                 cfg: DecodeConfig, max_frames: int, max_steps: int = 64,
                 max_words: int = None, finished_size: int = 64,
                 read_every: int = READ_EVERY, graphed: bool = True):
        """``read_every`` is the runner's k; ``graphed=False`` runs the
        step loop eagerly on the card too, for a comparison with the
        graphs."""
        if not cfg.Constrained:
            raise ValueError("the device beam requires lexicon constraints")
        if cfg.beam_scan not in ("early_exit", "static"):
            raise ValueError(f"unknown beam_scan {cfg.beam_scan!r}")
        if model.dtype == torch.bfloat16:
            # cast the per-use float32 -> bfloat16 weights once, outside the
            # step loop (numerics unchanged; see utils/serving.py)
            from emg_tpu_torch.utils.serving import cast_params_for_serving

            model = cast_params_for_serving(model)
        if cfg.quantize_int8:
            # int8 storage for the decoder's per-step weight reads, after
            # the cast as in JAX (a no-op on a model already quantized)
            from emg_tpu_torch.utils.quantize import quantize_decoder_int8

            model = quantize_decoder_int8(model)
        self.model = model
        self.device = model.device
        self.runner = LoopRunner(model, read_every, graphed)
        if device_lm.device != self.device:
            raise ValueError(f"the LM's tables are on {device_lm.device}, the model on {self.device}")
        self.cfg = cfg
        self.max_frames = max_frames
        self.S = max_steps + 1
        # every word consumes at least one phone step, so max_steps words
        # can never be exceeded: a smaller cap would silently freeze
        # hypotheses at word-end nodes where </S> is invalid
        self.MW = max_words if max_words is not None else max_steps
        self.F = finished_size

        # dense tree tables on the device; word slots per node fixed to K
        self.K = max((len(w) for w in tree.node_words), default=1)
        n_nodes = tree.child_table.shape[0]
        node_words = np.full((n_nodes, self.K), -1, np.int64)
        for i, ws in enumerate(tree.node_words):
            node_words[i, : len(ws)] = ws

        def on_device(a, dtype):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

        self.child_table = on_device(tree.child_table, torch.int64)
        self.mask_table = on_device(tree.mask_table, torch.float32)
        self.node_words = on_device(node_words, torch.int64)
        self.root = tree.root
        self.phone_count = tree.phone_count  # 40; end token id == 40
        self.lm = device_lm
        self.tree = tree
        self.W = cfg.BeamWidth
        self.H = self.W * (1 + self.K)
        # expansion rows carry the same token history as their parent
        # (row i's parent is i mod W)
        self.parent = torch.arange(self.H, device=self.device) % self.W
        self.positions = torch.arange(self.S, device=self.device)
        self.word_slots = torch.arange(self.MW, device=self.device)

    # ------------------------------------------------------------------
    def _make_ctx(self, batch: PackedBatch):
        """One utterance's search context: its encoder memory projected into
        each decoder layer's cross K/V (K as float32, which is how the step
        reads it: the exact float32 values of the compute-dtype K), and the
        source pad mask."""
        model = self.model
        memory, _, src_mask = encode_batch(model, batch, self.max_frames)
        kvs = model.project_cross_kvs(memory[:1])
        return [(k.float(), v) for k, v in kvs], src_mask[:1]

    def _stack_ctx(self, ctxs):
        kvs = [(torch.cat([c[0][i][0] for c in ctxs]), torch.cat([c[0][i][1] for c in ctxs]))
               for i in range(len(ctxs[0][0]))]
        return kvs, torch.cat([c[1] for c in ctxs])

    def _hypotheses(self, U: int) -> dict:
        """U lanes' fresh hypotheses and finished buffers, at t = 0."""
        S, H, F, MW = self.S, self.H, self.F, self.MW
        dev = self.device

        def full(shape, value, dtype):
            return torch.full(shape, value, dtype=dtype, device=dev)

        hist = full((U, H, S), PAD_ID, torch.int64)
        hist[:, :, 0] = START_ID
        alive = full((U, H), False, torch.bool)
        alive[:, 0] = True
        return dict(
            t=full((U,), 0, torch.int64),
            hist=hist, cum=full((U, H), 0.0, torch.float32),
            node=full((U, H), self.root, torch.int64), alive=alive,
            ctx=self.lm.initial_ctx((U, H)), runlm=full((U, H), 0.0, torch.float32),
            chars=full((U, H), 0, torch.int64), wc=full((U, H), 0, torch.int64),
            words=full((U, H, MW), -1, torch.int64),
            fin_scores=full((U, F), NEG, torch.float32),
            fin_hist=full((U, F, S), PAD_ID, torch.int64),
            fin_words=full((U, F, MW), -1, torch.int64), fin_wc=full((U, F), 0, torch.int64),
        )

    def _init_state(self, cross_kvs, src_mask, max_len: torch.Tensor, old=None) -> dict:
        """Fresh search state for U utterances (``src_mask``: (U, T)): the
        inputs (cross K/V, source mask, ``max_len`` (U,) int64), t = 0, and
        the hypotheses. ``old``, a state of the same U, lends its caches,
        zeroed (its spare buffer is overwritten before it is read)."""
        U = src_mask.shape[0]
        if old is None:
            k_all, v_all = self.model.init_decode_cache(U * self.W, self.S)
            k_alt, v_alt = torch.empty_like(k_all), torch.empty_like(v_all)
        else:
            k_all, v_all = old["k_all"].zero_(), old["v_all"].zero_()
            k_alt, v_alt = old["k_alt"], old["v_alt"]
        return dict(
            cross_kvs=cross_kvs, src_mask=src_mask, max_len=max_len,
            done=torch.zeros((), dtype=torch.bool, device=self.device),
            **self._hypotheses(U),
            k_all=k_all, v_all=v_all, k_alt=k_alt, v_alt=v_alt,
            # the previous step's cache row selection, applied at the next
            psel=torch.arange(U * self.W, device=self.device),
        )

    def _refill_lane(self, st: dict, lane: int, ctx, max_len: int) -> None:
        """Start a new utterance in lane ``lane`` of ``st``, in place:
        its inputs (``ctx`` from ``_make_ctx``, ``max_len``), fresh
        hypotheses at t = 0, its cache rows zeroed in the buffer the next
        step reads, and its cache selection the identity."""
        kvs, mask = ctx
        for (k, v), (k1, v1) in zip(st["cross_kvs"], kvs):
            k[lane].copy_(k1[0])
            v[lane].copy_(v1[0])
        st["src_mask"][lane].copy_(mask[0])
        st["max_len"][lane : lane + 1].fill_(max_len)  # a fill: no upload, no sync
        for name, value in self._hypotheses(1).items():
            st[name][lane].copy_(value[0])
        rows = slice(lane * self.W, (lane + 1) * self.W)
        st["k_all"][:, rows].zero_()
        st["v_all"][:, rows].zero_()
        st["psel"][rows].copy_(torch.arange(rows.start, rows.stop, device=self.device))

    def _live(self, alive: torch.Tensor, t: torch.Tensor, max_len: torch.Tensor) -> torch.Tensor:
        """Per lane, whether it can still make progress at its position:
        a row alive before its max_len and before the cache's end (the
        negation of JAX's ``_carry_done``)."""
        return (t < self.S - 1) & (alive & (t < max_len)[:, None]).any(dim=1)

    def _progress(self, alive: torch.Tensor, t: torch.Tensor, max_len: torch.Tensor):
        """The lock-step loop's condition: JAX's while condition (some
        lane can make progress) for early exit, the scan's length for
        static."""
        if self.cfg.beam_scan == "early_exit":
            return self._live(alive, t, max_len).any()
        return (t < self.S - 1).any()

    def lanes_done(self, st: dict) -> torch.Tensor:
        """(U,) bool on the device: the lanes that can make no further
        progress (JAX's ``_carry_done``)."""
        return ~self._live(st["alive"], st["t"], st["max_len"])

    def _step(self, st: dict, lockstep: bool = True) -> dict:
        """One beam step of all U lanes, each at its position st["t"];
        returns the new state. ``lockstep``: every lane at one position,
        advanced by the loop's condition; else each lane advances while it
        can make progress."""
        model, cfg, lm = self.model, self.cfg, self.lm
        S, W, K, F, MW = self.S, self.W, self.K, self.F, self.MW
        end_tok = self.phone_count
        wt = cfg.LMWeight
        t, max_len = st["t"], st["max_len"]
        U = st["cum"].shape[0]
        lanes = torch.arange(U, device=self.device)[:, None]

        def take(x, idx):  # per-lane row gather: x (U, R, ...), idx (U, N)
            return x[lanes, idx]

        # a lane past its max_len or at the cache's end is inert from here on
        go = (self._progress if lockstep else self._live)(st["alive"], t, max_len)
        alive = st["alive"] & ((t < max_len) & (t < S - 1))[:, None]
        hist, cum, node = st["hist"], st["cum"], st["node"]

        # apply the previous step's beam reorder to the K/V caches, into the
        # other buffer of each pair
        k_all = torch.index_select(st["k_all"], 1, st["psel"], out=st["k_alt"])
        v_all = torch.index_select(st["v_all"], 1, st["psel"], out=st["v_alt"])
        tokens = hist[:, :W].reshape(U * W, S)
        t_rows = t[:, None].expand(U, W).reshape(U * W)  # each decode row's position
        token_in = tokens.gather(1, t_rows[:, None])[:, 0]
        logits = model.decode_step(token_in, t_rows, (k_all, v_all), st["cross_kvs"], tokens,
                                   st["src_mask"], pe_period=W)
        step_lp_w = torch.log_softmax(logits[:, :-2], dim=-1).reshape(U, W, -1)  # (U, W, 41)
        step_lp = step_lp_w[:, self.parent]  # (U, H, 41)
        n_cls = step_lp.shape[-1]
        full = cum[..., None] + step_lp + self.mask_table[node]
        full = torch.where(alive[..., None], full, NEG)

        vals, flat_idx = top_k_stable(full.reshape(U, -1), W)
        hsel = flat_idx // n_cls
        tok = flat_idx % n_cls
        valid = torch.isfinite(vals)

        new_cum = take(cum, hsel) + step_lp[lanes, hsel, tok]
        new_hist = take(hist, hsel)
        new_hist = torch.where(self.positions == (t + 1)[:, None, None], tok[..., None], new_hist)
        node_sel = take(node, hsel)
        new_node = torch.where(
            tok == end_tok, node_sel,
            self.child_table[node_sel, tok.clamp(max=self.phone_count - 1)],
        )
        new_ctx = take(st["ctx"], hsel)
        new_runlm = take(st["runlm"], hsel)
        new_chars = take(st["chars"], hsel)
        new_wc = take(st["wc"], hsel)
        new_words = take(st["words"], hsel)

        # one batched LM call scores the eos continuation AND the K
        # word-boundary expansions together ((U, 1+K, W))
        wid = self.node_words[new_node].transpose(1, 2)  # (U, K, W) lexicon ids, -1 pad
        wid_s = wid.clamp(min=0)
        lm_w = lm.lex2lm[wid_s]  # (U, K, W)
        ctx_b = new_ctx[:, None].expand(U, K, W, new_ctx.shape[-1])
        ctx_all = torch.cat([new_ctx[:, None], ctx_b], dim=1)  # (U, 1+K, W, CW)
        w_all = torch.cat([torch.full_like(lm_w[:, :1], lm.eos_id), lm_w], dim=1)
        cond_all = lm.cond_logp(ctx_all, w_all)  # (U, 1+K, W)
        eos_cond = cond_all[:, 0]
        cond_w = cond_all[:, 1:]  # (U, K, W)

        # finished hypotheses: score = mean(per-step probs) where the last
        # step also carries the eos LM + final length penalty
        ended = valid & (tok == end_tok)
        fin_add = (new_runlm + eos_cond
                   + (new_chars.float() + 1.0) ** cfg.FinalLengthPenalty) * wt
        fin_score = torch.where(ended, (new_cum + fin_add) / (t + 1).to(new_cum.dtype)[:, None], NEG)
        # merge into the finished buffer (top-F by score)
        fin_scores, top_idx = top_k_stable(torch.cat([st["fin_scores"], fin_score], dim=1), F)
        fin_hist = take(torch.cat([st["fin_hist"], new_hist], dim=1), top_idx)
        fin_words = take(torch.cat([st["fin_words"], new_words], dim=1), top_idx)
        fin_wc = take(torch.cat([st["fin_wc"], new_wc], dim=1), top_idx)

        active = valid & ~ended

        # word-boundary expansions: duplicate each active hypo once per word
        # ending at its node, moved back to the root with the running LM +
        # length-penalty addition; row layout [base, k=0, k=1, ...]
        has = active[:, None] & (wid >= 0) & (new_wc[:, None] < MW)
        runlm_k = new_runlm[:, None] + cond_w
        chars_k = new_chars[:, None] + lm.word_chars[wid_s] + (new_wc[:, None] > 0).long()
        add = (runlm_k + (chars_k.float() + 1.0) ** cfg.RunningLengthPenalty) * wt
        w_upd = torch.where(
            self.word_slots == new_wc[:, None, :, None], wid_s[..., None], new_words[:, None],
        )  # (U, K, W, MW)

        def flat2(base, exp):  # stack [base; k-major expansions]
            return torch.cat([base, exp.reshape((U, K * W) + exp.shape[3:])], dim=1)

        alive = flat2(active, has)
        t_next = t + go.long()
        return dict(
            st,
            t=t_next, done=~self._progress(alive, t_next, max_len),
            hist=new_hist.repeat(1, 1 + K, 1),
            cum=flat2(new_cum, new_cum[:, None] + add),
            node=torch.cat([new_node, torch.full_like(wid.reshape(U, K * W), self.root)], dim=1),
            alive=alive,
            ctx=flat2(new_ctx, lm.shift_ctx(ctx_b, lm_w)),
            runlm=flat2(new_runlm, runlm_k),
            chars=flat2(new_chars, chars_k),
            wc=flat2(new_wc, (new_wc[:, None] + 1).expand(U, K, W)),
            words=flat2(new_words, w_upd),
            fin_scores=fin_scores, fin_hist=fin_hist, fin_words=fin_words, fin_wc=fin_wc,
            k_all=k_all, v_all=v_all, k_alt=st["k_all"], v_alt=st["v_all"],
            # the selected hypothesis hsel's prefix K/V live in cache row
            # hsel % W of its lane (expansion rows shared their parent's)
            psel=((hsel % W) + lanes * W).reshape(U * W),
        )

    @torch.inference_mode()
    def run(self, cross_kvs, src_mask, max_len: torch.Tensor) -> dict:
        """Run the step loop over U utterances (``max_len``: (U,) int64 on
        the device) to completion. Returns the final state, whose ``t`` is
        the number of steps run; on the card it is the runner's static
        buffers, which the next search of the same U overwrites."""
        U = src_mask.shape[0]
        blocks = None
        if self.cfg.beam_scan == "static":
            blocks = -(-(self.S - 1) // self.runner.k)
        return self.runner.run(
            ("beam", U), lambda old: self._init_state(cross_kvs, src_mask, max_len, old),
            lambda st: self._step(st), blocks)

    def _best(self, st: dict):
        """The winning finished hypothesis of each lane, on the host, in one
        fetch: [scores, histories, words, word counts], each (U, ...)."""
        fin = st["fin_scores"]
        best = fin.argmax(dim=1)  # the first of equal maxima
        lanes = torch.arange(best.shape[0], device=best.device)
        packed = torch.cat([
            fin[lanes, best].view(torch.int32).long()[:, None], st["fin_hist"][lanes, best],
            st["fin_words"][lanes, best], st["fin_wc"][lanes, best][:, None],
        ], dim=1).cpu().numpy()
        scores = packed[:, 0].astype(np.int32).view(np.float32)
        return [scores, packed[:, 1 : 1 + self.S], packed[:, 1 + self.S : -1], packed[:, -1]]

    def pack_raw(self, raw: np.ndarray) -> PackedBatch:
        """The packed rows of the raw 1 kHz signal ((n, C), no neighbour
        context), built on the device as JAX's ``_build_raw``: the signal
        padded to its raw-sample bucket Tb, the device DSP (K1), the soft
        clip 50·tanh(x/20/50) of emg_orig rows [8, 8+8F), packed into
        ceil(8·F_cap/1600) rows of 1600, padded with 42.0, where F_cap is
        the most frames a Tb-sample signal gives, at most max_frames."""
        n, C = raw.shape
        Tb = bucket_up(n, RAW_SAMPLE_BUCKETS)
        F_cap = min(frames_of(subsample_length(Tb, FEAT_RATE, SOURCE_RATE)), self.max_frames)
        rows_b = max(1, -(-(8 * F_cap) // 1600))
        buf = torch.zeros((Tb, C), dtype=torch.float32, device=self.device)
        buf[:n] = torch.as_tensor(raw, dtype=torch.float32)
        out = preprocess_emg(buf, n, 0, 0)
        F = min(out.n_frames, F_cap)
        clipped = 50.0 * torch.tanh(out.emg_orig / 20.0 / 50.0)
        pos = torch.arange(rows_b * 1600, device=self.device)
        src = (pos + 8).clamp(0, clipped.shape[0] - 1)
        flat = torch.where((pos < 8 * F)[:, None], clipped[src], PAD_VALUE)
        return PackedBatch(
            packed_raw=flat.reshape(rows_b, 1600, C), n_rows=np.int32((8 * F + 1599) // 1600),
            lengths=np.asarray([F], np.int32), offsets=np.zeros(1, np.int32),
            targets=np.full((1, 1), PAD_ID, np.int64), target_lengths=np.ones(1, np.int32),
            n_examples=np.int32(1),
        )

    def search_from_raw(self, raw: np.ndarray, target_len_tokens: int
                        ) -> Tuple[np.ndarray, float, List[str]]:
        """``search`` from the raw 1 kHz EMG signal ((n, C) float32, no
        neighbour context): only the signal is uploaded; DSP, packing
        (``pack_raw``), encode and the beam run on the device."""
        with torch.inference_mode():
            batch = self.pack_raw(raw)
        return self.search(batch, target_len_tokens)

    # ------------------------------------------------------------------
    def search_many(self, batches: List[PackedBatch], target_lens: List[int]):
        """Decode several single-utterance batches in lock-step as one
        search over a leading utterance axis. Returns a list of (history,
        score, words) like ``search``."""
        with torch.inference_mode():
            # a launch padded with repeats of one batch encodes it once
            ctxs = {}
            for b in batches:
                if id(b) not in ctxs:
                    ctxs[id(b)] = self._make_ctx(b)
            ctx_kv, mask = self._stack_ctx([ctxs[id(b)] for b in batches])
            max_len = torch.as_tensor([int(t) + self.cfg.extra_steps for t in target_lens],
                                      dtype=torch.int64, device=self.device)
            st = self.run(ctx_kv, mask, max_len)
            scores, hists, words, wcs = self._best(st)
        return [self._format(scores[u], hists[u], words[u], wcs[u]) for u in range(len(batches))]

    def _format(self, score, hist, words, wc):
        """(score, winning history, words, word count) -> search() output."""
        if not np.isfinite(score):
            return np.array([START_ID, self.phone_count]), -np.inf, []
        ends = np.where(hist == self.phone_count)[0]
        hist = hist[: ends[0] + 1] if len(ends) else hist
        names = [
            self.tree.dictionary.lookup_word_by_index(int(w)).name
            for w in words[: int(wc)]
        ]
        return hist, float(score), names

    def search(self, batch: PackedBatch, target_len_tokens: int
               ) -> Tuple[np.ndarray, float, List[str]]:
        """Decode one utterance; returns (history, score, word names), the
        contract of BeamSearcher.search."""
        return self.search_many([batch], [target_len_tokens])[0]
