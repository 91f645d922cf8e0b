"""ARPA n-gram language model with KenLM-compatible query semantics.

Replaces the reference's KenLM binary + python binding (PrefixTree.py:288-290,
check_language_model :211-215): ``score(sentence, bos, eos)`` returns the
sum of conditional log10 probabilities under standard Katz backoff —
longest-match n-gram probability plus backoff weights of the unmatched
longer contexts, OOV words scored as <unk>.

Two engines expose the same interface: this pure-Python reader and a native
C++ scorer (native/ngram_lm.cc via ctypes, see decode/lm_binding.py) for
production throughput; ``load_language_model`` prefers the native one and
logs a warning when it falls back to the Python reader.

A copy of ``emg_tpu/decode/ngram.py`` (the port imports nothing of the JAX
package); the scores are equal to the JAX package's.
"""

from __future__ import annotations

import logging
import subprocess
from typing import Dict, List, Sequence, Tuple

log = logging.getLogger(__name__)

UNK = "<unk>"
BOS = "<s>"
EOS = "</s>"


class ArpaLanguageModel:
    def __init__(self, path: str):
        # ngrams[n] maps a tuple of n words -> (log10 prob, log10 backoff)
        self.ngrams: List[Dict[Tuple[str, ...], Tuple[float, float]]] = []
        self.order = 0
        self._parse(path)

    def _parse(self, path: str):
        with open(path) as f:
            lines = iter(f)
            for line in lines:
                if line.strip() == "\\data\\":
                    break
            counts = []
            for line in lines:
                line = line.strip()
                if not line:
                    continue
                if line.startswith("ngram"):
                    counts.append(int(line.split("=")[1]))
                    continue
                break
            self.order = len(counts)
            self.ngrams = [dict() for _ in range(self.order + 1)]  # 1-indexed
            # `line` now holds the first section header ("\\1-grams:")
            current = line
            while current and current.strip() != "\\end\\":
                assert current.strip().endswith("-grams:"), current
                n = int(current.strip()[1:].split("-")[0])
                current = None
                for line in lines:
                    s = line.strip()
                    if not s:
                        continue
                    if s.startswith("\\"):
                        current = s
                        break
                    parts = s.split()
                    logp = float(parts[0])
                    if len(parts) == n + 2:
                        words = tuple(parts[1 : n + 1])
                        backoff = float(parts[n + 1])
                    else:
                        words = tuple(parts[1 : n + 1])
                        backoff = 0.0
                    self.ngrams[n][words] = (logp, backoff)

    # -- querying ----------------------------------------------------------
    def _word_score(self, context: Sequence[str], word: str) -> float:
        """log10 p(word | context) with Katz backoff."""
        if (word,) not in self.ngrams[1]:
            word = UNK
        context = [w if (w,) in self.ngrams[1] else UNK for w in context]
        context = tuple(context[-(self.order - 1):]) if self.order > 1 else ()
        total_backoff = 0.0
        while True:
            key = tuple(context) + (word,)
            n = len(key)
            if n <= self.order and key in self.ngrams[n]:
                return total_backoff + self.ngrams[n][key][0]
            if not context:
                # even the unigram is missing (shouldn't happen with <unk>)
                return total_backoff - 99.0
            # p(w|h) backs off to backoff(h) * p(w|h[1:]) when (h,w) absent
            bo_key = tuple(context)
            total_backoff += self.ngrams[len(bo_key)].get(bo_key, (0.0, 0.0))[1]
            context = context[1:]

    def score(self, sentence: str, bos: bool = True, eos: bool = True) -> float:
        """Total log10 probability of the sentence (KenLM .score contract)."""
        words = sentence.split()
        context: List[str] = [BOS] if bos else []
        total = 0.0
        for w in words:
            total += self._word_score(context, w)
            context.append(w)
        if eos:
            total += self._word_score(context, EOS)
        return total


def load_language_model(path: str):
    """Load an LM by sniffing the file format.

    KenLM *binary* files (the reference's actual ``descriptions/lm.binary``
    artifact, recognition_model.py:35) load through the kenlm package when
    it is installed, else through the repo's own PROBING-format reader
    (decode/kenlm_binary.py). ARPA text prefers the native C++ scorer and
    falls back to the pure-Python reader.
    """
    from emg_tpu_torch.decode.kenlm_binary import KenlmBinaryModel, is_kenlm_binary

    if is_kenlm_binary(path):
        try:
            import kenlm  # the definitely-bit-exact engine, when present

            if not getattr(kenlm, "__emg_tpu_stub__", False):
                return kenlm.Model(path)
        except ImportError:
            pass
        return KenlmBinaryModel(path)
    from emg_tpu_torch.decode.lm_binding import NativeArpaLanguageModel

    try:
        return NativeArpaLanguageModel(path)
    except (OSError, subprocess.SubprocessError) as e:
        log.warning("native ARPA scorer unavailable (%s); scoring %s with the "
                    "pure-Python reader", e, path)
        return ArpaLanguageModel(path)


def write_fixture_arpa(path: str, sentences: Sequence[str]) -> None:
    """Emit a tiny MLE bigram ARPA over the given sentences (for tests and
    synthetic-corpus decoding; real deployments pass a KenLM-trained file)."""
    import collections
    import math

    unigrams = collections.Counter()
    bigrams = collections.Counter()
    for s in sentences:
        words = [BOS] + s.lower().split() + [EOS]
        for w in words:
            unigrams[w] += 1
        for a, b in zip(words, words[1:]):
            bigrams[(a, b)] += 1
    unigrams[UNK] += 1
    total = sum(unigrams.values())

    def lp(x):
        return round(math.log10(x), 6)

    with open(path, "w") as f:
        f.write("\\data\\\n")
        f.write(f"ngram 1={len(unigrams)}\n")
        f.write(f"ngram 2={len(bigrams)}\n\n")
        f.write("\\1-grams:\n")
        for w, c in sorted(unigrams.items()):
            # smoothed unigram + flat backoff weight
            f.write(f"{lp(c / total)}\t{w}\t-0.30103\n")
        f.write("\n\\2-grams:\n")
        for (a, b), c in sorted(bigrams.items()):
            f.write(f"{lp(c / unigrams[a])}\t{a} {b}\n")
        f.write("\n\\end\\\n")
