"""The port's device LM (hash-table n-gram scoring in torch) against the JAX
package's ``DeviceLM``.

- The tables ``build_device_lm`` builds equal the JAX package's.
- ``cond_logp`` over random full and partial contexts, at orders 3 and 4,
  is bitwise equal to JAX ``DeviceLM.cond_logp`` at float32.
- The int64 hash equals ``_tuple_hash_host`` and the JAX uint32 device
  hash on keys near 2^32 and on negative (masked) ids.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emg_tpu.decode import device_lm as jax_device_lm
from emg_tpu.decode.lm_train import train_arpa, write_arpa
from emg_tpu.decode.ngram import ArpaLanguageModel as JaxArpaLanguageModel

from emg_tpu_torch.decode import device_lm
from emg_tpu_torch.decode.ngram import ArpaLanguageModel
from tests.test_torch_model import one_torch_thread  # noqa: F401

SENTS = ["the cat sat on the mat", "the dog ran to the cat",
         "the cat ran home now", "a dog sat on a mat",
         "we go to the moon", "the moon is cold and far"] * 2
WORDS = sorted({w for s in SENTS for w in s.split()}) + ["zzz"]  # zzz: out of the LM


@pytest.fixture(scope="module", params=[3, 4])
def lms(request, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("dlm") / "lm.arpa")
    write_arpa(train_arpa(SENTS, order=request.param), path)
    lex = [w.upper() for w in WORDS]
    port = device_lm.build_device_lm(ArpaLanguageModel(path), lex, device="cpu")
    ref = jax_device_lm.build_device_lm(JaxArpaLanguageModel(path), lex)
    return request.param, port, ref, ArpaLanguageModel(path)


def test_tables_equal_jax(lms):
    order, port, ref, _ = lms
    assert (port.order, port.n_words, port.n_lm, port.bos_id, port.eos_id, port.ctx_width) == (
        order, ref.n_words, ref.n_lm, ref.bos_id, ref.eos_id, ref.ctx_width)
    for name in ("lex2lm", "word_chars", "uni_logp", "uni_bo"):
        np.testing.assert_array_equal(getattr(port, name).numpy(), np.asarray(getattr(ref, name)))
    assert len(port.tables) == len(ref.tables) == order - 1
    for a, b in zip(port.tables, ref.tables):
        assert a.size == b.size
        for name in ("keys", "vals", "bos"):
            np.testing.assert_array_equal(getattr(a, name).numpy(), np.asarray(getattr(b, name)))


def random_contexts(port, rng, n=400):
    """(n, ctx_width) LM-id contexts with 0..ctx_width words, -1 filled on
    the left, and (n,) words; some contexts start with <s>."""
    CW = port.ctx_width
    lex2lm = port.lex2lm.numpy()
    ctx = np.full((n, CW), -1, np.int64)
    for i in range(n):
        k = int(rng.integers(0, CW + 1))
        ids = lex2lm[rng.integers(0, len(WORDS), size=k)]
        if k and rng.random() < 0.3:
            ids[0] = port.bos_id
        ctx[i, CW - k:] = ids
    w = lex2lm[rng.integers(0, len(WORDS), size=n)]
    w[::7] = port.eos_id
    return ctx, w


def test_cond_logp_bitwise_equal_jax(lms):
    order, port, ref, _ = lms
    ctx, w = random_contexts(port, np.random.default_rng(order))
    got = port.cond_logp(torch.as_tensor(ctx), torch.as_tensor(w)).numpy()
    want = np.asarray(ref.cond_logp(jnp.asarray(ctx, jnp.int32), jnp.asarray(w, jnp.int32)))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    # the beam's layout: a (U, 1+K, W) batch with contexts (U, 1+K, W, CW)
    shape = (2, 3, len(w) // 6)
    n = int(np.prod(shape))
    got = port.cond_logp(torch.as_tensor(ctx[:n].reshape(shape + (-1,))),
                         torch.as_tensor(w[:n].reshape(shape))).numpy()
    np.testing.assert_array_equal(got, want[:n].reshape(shape))


def test_sentence_accumulation_equals_host_score(lms):
    """initial_ctx / shift_ctx accumulation over a sentence equals the host
    scorer's sentence score (float32 against float64)."""
    _, port, _, host = lms
    sent = "the cat sat on the mat zzz"
    ctx = port.initial_ctx((1,))
    total = 0.0
    for word in sent.split():
        w = port.lex2lm[torch.tensor([WORDS.index(word)])]
        total += float(port.cond_logp(ctx, w)[0])
        ctx = port.shift_ctx(ctx, w)
    total += float(port.cond_logp(ctx, torch.tensor([port.eos_id]))[0])
    assert total == pytest.approx(host.score(sent, bos=True, eos=True), abs=1e-4)


KEYS = [
    [0], [1, 2], [2**32 - 1, 2**32 - 2], [2**32 - 5, 7, 2**32 - 3],
    [2**31 - 1, 2**31, 2**31 + 1, 2**32 - 1], [12345, 67890, 2**32 - 1],
]


@pytest.mark.parametrize("size", [1, 64, 2**20])
def test_hash_equals_host_near_2_32(size):
    for key in KEYS:
        got = int(device_lm.tuple_hash([torch.tensor(k, dtype=torch.int64) for k in key], size))
        assert got == device_lm._tuple_hash_host(key, size), key


@pytest.mark.parametrize("size", [64, 2**16])
def test_hash_equals_jax_device_hash_on_negative_ids(size):
    rng = np.random.default_rng(size)
    cols = [rng.integers(-2**31, 2**31, size=200, dtype=np.int64) for _ in range(3)]
    for c in cols:
        c[::5] = -1  # the masked slot value
    for k in (1, 2, 3):
        got = device_lm.tuple_hash([torch.as_tensor(c) for c in cols[:k]], size).numpy()
        want = np.asarray(jax_device_lm.DeviceLM._tuple_hash(
            [jnp.asarray(c, jnp.int32) for c in cols[:k]], size))
        np.testing.assert_array_equal(got, want)
        first = [int(c[0]) for c in cols[:k]]
        if all(v >= 0 for v in first[1:]):  # the host hash takes ids >= 0 after the first
            assert int(got[0]) == device_lm._tuple_hash_host(first, size)


def test_build_tuple_table_large_ids():
    big = 80_000
    k1 = [big - 1, big - 2, 7]
    k2 = [big - 3, 5, big - 4]
    got = device_lm._build_tuple_table([k1, k2], [0.1, 0.2, 0.3], [0.0] * 3)
    ref = jax_device_lm._build_tuple_table([k1, k2], [0.1, 0.2, 0.3], [0.0] * 3)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
