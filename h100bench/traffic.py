"""The general traffic generator: a mix's parameters (``traffic/<name>.json``)
and a seed -> utterances.

Every seed gets the same set of utterance lengths and target counts (the
log-normal's quantiles, clipped), in an order the seed permutes, so two
seeds give the same work in another order; the seed draws the signal (noise
plus a 60 Hz hum, as ``bench.py``'s ``synth_utterances``, with an amplitude of
each drawn per utterance) and the phone ids.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
from scipy.stats import norm

START_ID, END_ID, N_PHONES = 41, 40, 40  # <S>, </S>, and the 40 phones drawn


@dataclass
class Utterance:
    raw: np.ndarray  # (samples, channels) float32 at the mix's sample rate
    phones: np.ndarray  # (n,) int64: <S>, phone ids, </S>
    seconds: float


def length_set(spec: dict, n: int) -> np.ndarray:
    """The n utterance lengths in seconds, the same for every seed: the
    log-normal's quantiles at (i + 0.5) / n, clipped to [min, max]."""
    q = (np.arange(n) + 0.5) / n
    s = spec["median"] * np.exp(spec["sigma"] * norm.ppf(q))
    return np.clip(s, spec["min"], spec["max"])


def make_utterances(spec: dict, n: int, seed: int) -> List[Utterance]:
    """``n`` utterances of the mix ``spec`` (its ``utterance`` group), drawn
    from ``seed``."""
    u = spec["utterance"]
    rate, channels = u["sample_rate"], u["channels"]
    rng = np.random.default_rng(seed)
    seconds = length_set(u["length_s"], n)[rng.permutation(n)]
    out = []
    for s in seconds:
        samples = int(round(s * rate))
        t = np.arange(samples) / rate
        noise = rng.uniform(*u["noise_scale"])
        hum = rng.uniform(*u["hum_scale"])
        raw = (noise * rng.standard_normal((samples, channels))
               + hum * np.sin(2 * np.pi * u["hum_hz"] * t)[:, None]).astype(np.float32)
        n_ph = max(1, int(round(u["phones_per_s"] * s)))
        phones = np.concatenate([[START_ID], rng.integers(0, N_PHONES, n_ph), [END_ID]])
        out.append(Utterance(raw, phones.astype(np.int64), float(s)))
    return out
