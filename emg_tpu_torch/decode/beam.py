"""Lexicon-constrained beam search with n-gram LM rescoring, on the host.

Counterpart of ``emg_tpu/decode/beam.py``: the decoding scheme of the
reference run_single_bs (BeamSearch.py:41-266). The encoder runs once; each
step batches *all* hypotheses into one teacher-forced decoder call over a
bucketed token buffer; prefix-tree continuation masks and node stepping are
numpy gathers over the compiled tree tables; word-boundary LM scoring goes
through the host LM's ``score`` (the native ARPA scorer, the Python reader,
or a KenLM binary). Scores accumulate in float64. Scoring semantics:

- step logits drop <S>/<PAD> (41 classes: 40 phones + </S>)
- cumulative per-step log-prob matrix; finished score = mean over steps
- continuation masks add 0/-inf per node; </S> valid only at the root
- topk of BeamWidth over (hypos x 41), ties by flat index
- at word-end nodes hypotheses duplicate to the root, adding
  LMWeight * (lm.score(words, bos, eos=False) + (len(chars)+1)^RunningLengthPenalty)
- finished hypotheses add
  LMWeight * (lm.score(words, bos, eos=True) + (len(chars)+1)^FinalLengthPenalty)
- decode length = #non-</S> target tokens + 10

The CLI takes this searcher for ``Constrained=false``, ``device_beam=false``
and KenLM binary LMs; ``DeviceBeamSearcher`` is the default.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Tuple

import numpy as np
import torch

from emg_tpu_torch.config import DecodeConfig
from emg_tpu_torch.data.batching import PackedBatch
from emg_tpu_torch.decode.greedy import encode_batch
from emg_tpu_torch.decode.prefix_tree import CompiledTree
from emg_tpu_torch.text.phonemes import PAD_ID, START_ID

log = logging.getLogger(__name__)

HYPO_BUCKETS = [16, 32, 64, 128, 256, 512, 1024]
STEP_BUCKETS = [16, 32, 64, 128, 256]


def _bucket(n: int, buckets) -> int:
    for b in buckets:
        if n <= b:
            return b
    # beyond the listed sizes: grow by powers of two
    b = buckets[-1]
    while b < n:
        b *= 2
    return b


class BeamSearcher:
    """Host beam search over one model; the decoder runs on the model's
    device at bucketed (hypotheses, steps) shapes."""

    def __init__(self, model, tree: CompiledTree, lm, cfg: DecodeConfig, max_frames: int):
        self.model = model
        self.tree = tree
        self.lm = lm
        self.cfg = cfg
        self.max_frames = max_frames

    # -- device pieces -----------------------------------------------------
    def _encode(self, batch: PackedBatch):
        memory, _, src_mask = encode_batch(self.model, batch, self.max_frames)
        return memory[:1], src_mask[:1]

    def _decoder_logprobs(self, histories: np.ndarray, s: int) -> np.ndarray:
        """histories: (H, s) token ids -> (H, 41) step log-probs."""
        H = histories.shape[0]
        Hb = _bucket(H, HYPO_BUCKETS)
        Sb = _bucket(s + 1, STEP_BUCKETS)
        tokens = np.full((Hb, Sb), PAD_ID, np.int64)
        tokens[:H, :s] = histories
        device = self.model.device
        # every hypothesis attends to the one utterance's memory
        memory = self.memory.expand(Hb, -1, -1)
        mask = self.mem_mask.expand(Hb, -1)
        logits = self.model.decode(torch.as_tensor(tokens, device=device), memory, mask)
        out = torch.log_softmax(logits[:, s - 1, :-2], dim=-1)  # (Hb, 41)
        return out.cpu().numpy()[:H]

    # -- LM helpers --------------------------------------------------------
    def _words_to_sentence(self, word_ids: List[int]) -> str:
        names = [self.tree.dictionary.lookup_word_by_index(w).name for w in word_ids]
        return " ".join(names).lower()

    def _running_lm(self, word_ids: List[int]) -> float:
        sentence = self._words_to_sentence(word_ids)
        return self.lm.score(sentence, bos=True, eos=False) + (
            (len(sentence) + 1) ** self.cfg.RunningLengthPenalty
        )

    def _final_lm(self, word_ids: List[int]) -> float:
        sentence = self._words_to_sentence(word_ids)
        return self.lm.score(sentence, bos=True, eos=True) + (
            (len(sentence) + 1) ** self.cfg.FinalLengthPenalty
        )

    # -- the search --------------------------------------------------------
    @torch.inference_mode()
    def search(self, batch: PackedBatch, target_len_tokens: int) -> Tuple[np.ndarray, float, List[str]]:
        """Decode one utterance; returns (history, score, word names)."""
        cfg = self.cfg
        tree = self.tree
        end_tok = tree.phone_count  # 40

        self.memory, self.mem_mask = self._encode(batch)
        max_len = int(target_len_tokens) + cfg.extra_steps

        histories = np.array([[START_ID]], np.int64)  # (H, s)
        probs = np.zeros((1, 0), np.float64)  # per-step log-probs
        words: List[List[int]] = [[]]
        nodes = np.array([tree.root], np.int32)
        finished: Dict[float, Tuple[np.ndarray, List[str]]] = {}

        for step in range(max_len):
            H = histories.shape[0]
            if H == 0:
                break
            step_probs = self._decoder_logprobs(histories, histories.shape[1]).astype(
                np.float64
            )
            full = step_probs + probs.sum(axis=1, keepdims=True)
            if cfg.Constrained:
                full = full + tree.continuation_mask(nodes)

            flat = full.reshape(-1)
            k = min(cfg.BeamWidth, int(np.isfinite(flat).sum()))
            if k == 0:
                break
            order = np.argsort(-flat, kind="stable")[:k]
            hsel = (order // full.shape[1]).astype(np.int64)
            tok = (order % full.shape[1]).astype(np.int32)

            new_histories = np.concatenate(
                [histories[hsel], tok[:, None]], axis=1
            )
            new_probs = np.concatenate(
                [probs[hsel], step_probs[hsel, tok][:, None]], axis=1
            )
            new_words = [words[i] for i in hsel]
            if cfg.Constrained:
                new_nodes = tree.step(nodes[hsel], tok)
            else:
                # unconstrained search carries no tree state (the reference
                # raises here; this degrades to a plain phone beam without
                # word emission)
                new_nodes = np.full(len(hsel), tree.root, np.int32)

            # save + remove finished hypos
            end_mask = new_histories[:, -1] == end_tok
            for i in np.where(end_mask)[0]:
                final = new_probs[i].copy()
                final[-1] += self._final_lm(new_words[i]) * cfg.LMWeight
                names = [
                    tree.dictionary.lookup_word_by_index(w).name for w in new_words[i]
                ]
                finished[float(final.mean())] = (new_histories[i].copy(), names)
            active = ~end_mask
            histories = new_histories[active]
            probs = new_probs[active]
            words = [w for w, a in zip(new_words, active) if a]
            nodes = new_nodes[active]

            # word-boundary expansion: duplicate word-end hypos to the root
            add_probs, add_words, add_nodes, add_idx = [], [], [], []
            for i in range(histories.shape[0] if cfg.Constrained else 0):
                for wid in tree.node_words[nodes[i]]:
                    p = probs[i].copy()
                    p[-1] += self._running_lm(words[i] + [wid]) * cfg.LMWeight
                    add_probs.append(p)
                    add_words.append(words[i] + [wid])
                    add_nodes.append(tree.root)
                    add_idx.append(i)
            if add_idx:
                histories = np.concatenate([histories, histories[add_idx]], axis=0)
                probs = np.concatenate([probs, np.stack(add_probs)], axis=0)
                words = words + add_words
                nodes = np.concatenate([nodes, np.asarray(add_nodes, np.int32)])

            if histories.shape[0] > cfg.max_hypos:
                # hypothesis cap: keep the best-scoring hypotheses
                totals = probs.sum(axis=1)
                keep = np.argsort(-totals, kind="stable")[: cfg.max_hypos]
                keep.sort()
                histories = histories[keep]
                probs = probs[keep]
                words = [words[i] for i in keep]
                nodes = nodes[keep]
                log.warning("beam hypo cap hit at step %d", step)

        if not finished:
            # degenerate fallback (the reference would crash here): emit the
            # best active hypothesis as if it had finished
            log.warning("beam search produced no finished hypothesis")
            if histories.shape[0] == 0:
                return np.array([START_ID, end_tok]), -np.inf, []
            totals = probs.mean(axis=1) if probs.shape[1] else probs.sum(axis=1)
            best = int(np.argmax(totals))
            names = [self.tree.dictionary.lookup_word_by_index(w).name for w in words[best]]
            return histories[best], float(totals[best]), names

        best_score = max(finished.keys())
        history, names = finished[best_score]
        return history, best_score, names


def run_single_bs(model, batch: PackedBatch, tree: CompiledTree, lm,
                  cfg: DecodeConfig, max_frames: int, target_len_tokens: int):
    """One-shot convenience wrapper (reference signature parity)."""
    searcher = BeamSearcher(model, tree, lm, cfg, max_frames)
    return searcher.search(batch, target_len_tokens)
