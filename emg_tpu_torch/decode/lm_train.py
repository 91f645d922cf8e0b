"""ARPA n-gram language model training (Witten-Bell backoff).

The reference depends on a prebuilt KenLM binary that its repo does not
ship (descriptions/lm.binary is gitignored — SURVEY.md §2.2). This module
closes that gap: train a backoff n-gram model from raw text and write a
standard ARPA file consumable by both this framework's scorers and KenLM
itself. Witten-Bell smoothing keeps the estimator simple, exact, and
well-defined on small corpora (no discount tuning).

CLI: ``python -m emg_tpu_torch.decode.lm_train corpus.txt lm.arpa --order 3``

A copy of ``emg_tpu/decode/lm_train.py``: the same sentences give the same
ARPA text.
"""

from __future__ import annotations

import collections
import math
from typing import Dict, Iterable, List, Tuple

BOS, EOS, UNK = "<s>", "</s>", "<unk>"


def _count_ngrams(sentences: Iterable[List[str]], order: int):
    counts = [collections.Counter() for _ in range(order + 1)]  # 1-indexed
    for words in sentences:
        toks = [BOS] + words + [EOS]
        for n in range(1, order + 1):
            for i in range(len(toks) - n + 1):
                gram = tuple(toks[i : i + n])
                if n == 1 and gram == (BOS,):
                    counts[1][gram] += 1  # context-only; prob handled below
                    continue
                counts[n][gram] += 1
    return counts


def train_arpa(
    sentences: Iterable[str],
    order: int = 3,
    min_count: int = 1,
) -> Dict[int, Dict[Tuple[str, ...], Tuple[float, float]]]:
    """Returns {n: {gram: (log10 prob, log10 backoff)}} with Witten-Bell:

      p_WB(w|h) = (c(h,w) + T(h) * p_WB(w|h')) / (c(h) + T(h))

    where T(h) is the number of distinct continuations of context h.
    Backoff weights follow from the recursive interpolation rewritten in
    backoff form: bow(h) = T(h) / (c(h) + T(h)) covers exactly the mass the
    explicit entries leave, because every seen continuation is listed.
    """
    sents = [s.lower().split() for s in sentences if s.strip()]
    counts = _count_ngrams(sents, order)

    # unigram distribution (with <unk> absorbing one count)
    uni = collections.Counter({k[0]: v for k, v in counts[1].items() if k != (BOS,)})
    uni[UNK] += 1
    total = sum(uni.values())
    vocab_p1 = len(uni)
    # Witten-Bell at the unigram level interpolates with uniform 1/V
    t1 = len(uni)
    p_uni = {
        w: (c + t1 * (1.0 / vocab_p1)) / (total + t1) for w, c in uni.items()
    }

    models: Dict[int, Dict[Tuple[str, ...], Tuple[float, float]]] = {
        n: {} for n in range(1, order + 1)
    }

    def prob(gram: Tuple[str, ...]) -> float:
        n = len(gram)
        if n == 1:
            return p_uni.get(gram[0], p_uni[UNK])
        h = gram[:-1]
        c_h = context_counts[n - 1].get(h, 0)
        t_h = distinct_cont[n - 1].get(h, 0)
        c = counts[n].get(gram, 0)
        if c_h + t_h == 0:
            return prob(gram[1:])
        return (c + t_h * prob(gram[1:])) / (c_h + t_h)

    # context statistics
    context_counts = [collections.Counter() for _ in range(order + 1)]
    distinct_cont = [collections.Counter() for _ in range(order + 1)]
    for n in range(2, order + 1):
        for gram, c in counts[n].items():
            context_counts[n - 1][gram[:-1]] += c
            distinct_cont[n - 1][gram[:-1]] += 1

    # unigram entries (+ backoff weight for each word-as-context)
    for w in sorted(uni):
        p = p_uni[w]
        h = (w,)
        c_h = context_counts[1].get(h, 0)
        t_h = distinct_cont[1].get(h, 0)
        bow = t_h / (c_h + t_h) if (c_h + t_h) > 0 and order > 1 else 1.0
        models[1][h] = (math.log10(p), math.log10(bow) if bow > 0 else 0.0)
    # <s> carries probability only as context; ARPA convention gives it -99
    models[1][(BOS,)] = (-99.0, models[1].get((BOS,), (0.0, 0.0))[1])
    if (BOS,) in counts[1]:
        h = (BOS,)
        c_h = context_counts[1].get(h, 0)
        t_h = distinct_cont[1].get(h, 0)
        bow = t_h / (c_h + t_h) if (c_h + t_h) > 0 and order > 1 else 1.0
        models[1][(BOS,)] = (-99.0, math.log10(bow) if bow > 0 else 0.0)

    for n in range(2, order + 1):
        for gram, c in sorted(counts[n].items()):
            if c < min_count:
                continue
            p = prob(gram)
            if n < order:
                h = gram
                c_h = context_counts[n].get(h, 0)
                t_h = distinct_cont[n].get(h, 0)
                bow = t_h / (c_h + t_h) if (c_h + t_h) > 0 else 1.0
                models[n][gram] = (math.log10(p), math.log10(bow) if bow > 0 else 0.0)
            else:
                models[n][gram] = (math.log10(p), 0.0)
    return models


def write_arpa(models, path: str) -> None:
    order = max(models)
    with open(path, "w") as f:
        f.write("\\data\\\n")
        for n in range(1, order + 1):
            f.write(f"ngram {n}={len(models[n])}\n")
        for n in range(1, order + 1):
            f.write(f"\n\\{n}-grams:\n")
            for gram, (logp, bow) in sorted(models[n].items()):
                words = " ".join(gram)
                if n < order and bow != 0.0:
                    f.write(f"{logp:.6f}\t{words}\t{bow:.6f}\n")
                else:
                    f.write(f"{logp:.6f}\t{words}\n")
        f.write("\n\\end\\\n")


def train_lm_file(corpus_path: str, out_path: str, order: int = 3) -> None:
    with open(corpus_path) as f:
        sentences = [line.strip() for line in f if line.strip()]
    write_arpa(train_arpa(sentences, order), out_path)


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("corpus")
    ap.add_argument("output")
    ap.add_argument("--order", type=int, default=3)
    args = ap.parse_args()
    train_lm_file(args.corpus, args.output, args.order)
