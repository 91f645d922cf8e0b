"""The traffic generator: deterministic by seed, one set of sizes for every
seed, the stated length distribution and phone rate."""

import json

import numpy as np

from h100bench.traffic import length_set, make_utterances
from h100bench.tests.conftest import HERE

MIX = json.loads((HERE / "traffic" / "train512.json").read_text())


def small(n=64):
    return make_utterances(MIX, n, 2 ** 31 + 5)


def test_same_seed_same_utterances():
    a, b = small(), small()
    assert all(np.array_equal(x.raw, y.raw) and np.array_equal(x.phones, y.phones)
               for x, y in zip(a, b))


def test_seeds_share_sizes_in_another_order():
    a = make_utterances(MIX, 64, 1)
    b = make_utterances(MIX, 64, 2)
    assert sorted(u.raw.shape[0] for u in a) == sorted(u.raw.shape[0] for u in b)
    assert [u.raw.shape[0] for u in a] != [u.raw.shape[0] for u in b]
    assert not np.array_equal(a[0].raw[:100], b[0].raw[:100])


def test_length_distribution():
    spec = MIX["utterance"]["length_s"]
    s = length_set(spec, MIX["utterances"])
    assert s.min() == spec["min"] and s.max() == spec["max"]
    assert abs(np.median(s) - spec["median"]) < 0.05
    # the log-normal's spread: the quartiles at median * exp(+-0.674 sigma)
    q1, q3 = np.quantile(s, [0.25, 0.75])
    assert abs(np.log(q3 / q1) - 2 * 0.6745 * spec["sigma"]) < 0.02


def test_utterance_shapes_and_phones():
    u = MIX["utterance"]
    for utt in small(16):
        assert utt.raw.dtype == np.float32 and utt.raw.shape[1] == u["channels"]
        assert utt.raw.shape[0] == round(utt.seconds * u["sample_rate"])
        assert utt.phones[0] == 41 and utt.phones[-1] == 40
        assert ((utt.phones[1:-1] >= 0) & (utt.phones[1:-1] < 40)).all()
        assert len(utt.phones) - 2 == max(1, round(u["phones_per_s"] * utt.seconds))
