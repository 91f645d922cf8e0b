"""The port's host scipy DSP and its batched device DSP on the CPU, against
the JAX package's.

- ``emg_tpu_torch.dsp.host_dsp`` (the scipy front-end ``data.dsp_backend=
  "scipy"`` runs) equals ``emg_tpu.dsp.host_dsp`` bitwise, helper by
  helper: both make the same numpy and scipy calls.
- ``subsample_masked`` with per-column lengths against JAX's vector-n
  path (1e-6), and ``masked_output_length`` over a tensor of n = 1..20000
  equal to JAX's ``_masked_output_length``, for both rates of the DSP and a
  rate outside its exact-rational form.
- ``preprocess_emg_batched`` at U = 3 (unequal lengths, neighbour context
  on both sides, one removed channel) against JAX's
  ``preprocess_emg_batched`` on the CPU, at test_torch_dsp.py's bounds
  (features 1.6e-3, signals 2e-4, at the reference's ~50 signal scale),
  with equal counts; at U = 1 against the same JAX program's row for that
  utterance (JAX's rows do not depend on U; one program keeps the file to
  one JAX compile). Each row of the batch equals the port's single
  ``preprocess_emg`` to 1e-6, and bitwise at U = 1.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emg_tpu.data.fixtures import _synth_emg
from emg_tpu.dsp import host_dsp as jax_host_dsp
from emg_tpu.dsp.pipeline import preprocess_emg_batched as jax_preprocess_emg_batched
from emg_tpu.dsp.resample import _masked_output_length as jax_masked_output_length
from emg_tpu.dsp.resample import subsample_masked as jax_subsample_masked

from emg_tpu_torch.dsp import host_dsp
from emg_tpu_torch.dsp.pipeline import (
    FEAT_RATE,
    RAW_RATE,
    SOURCE_RATE,
    preprocess_emg,
    preprocess_emg_batched,
)
from emg_tpu_torch.dsp.resample import masked_output_length, subsample_masked
from tests.test_torch_dsp import FEATURE_BOUND, SIGNAL_BOUND, assert_close_at_scale
from tests.test_torch_model import one_torch_thread  # noqa: F401

BUCKET = 4096
# (before, utterance, after) samples of each utterance: the neighbour
# context of tests/test_torch_dsp.py's utterance, so that the 2 Hz
# high-pass's float32 transient stays outside the utterance
SPANS = [(1000, 2000, 900), (900, 1600, 800), (1000, 1200, 1000)]
REMOVE = (3,)
OUTPUTS = (("emg_features", "n_frames", FEATURE_BOUND), ("emg", "n_feat", SIGNAL_BOUND),
           ("emg_orig", "n_raw", SIGNAL_BOUND))


@pytest.fixture(scope="module")
def host_input():
    rng = np.random.default_rng(7)
    return tuple(_synth_emg(rng, n, sentence_id=i) for i, n in enumerate((700, 1500, 600)))


@pytest.mark.parametrize("name, call", [
    ("notch_harmonics", lambda m, x: m.notch_harmonics(x, 60.0, 1000.0)),
    ("remove_drift", lambda m, x: m.remove_drift(x, 1000.0)),
    ("subsample_raw", lambda m, x: m.subsample(x, RAW_RATE, 1000.0)),
    ("subsample_feat", lambda m, x: m.subsample(x, FEAT_RATE, 1000.0)),
    ("double_average", lambda m, x: m.double_average(x[:, 0])),
    ("get_emg_features", lambda m, x: m.get_emg_features(x)),
])
def test_host_dsp_helpers_equal_jax(host_input, name, call):
    x = host_input[1].astype(np.float64)
    got, ref = call(host_dsp, x.copy()), call(jax_host_dsp, x.copy())
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("remove_channels", [(), (2, 5)], ids=["all", "removed"])
def test_preprocess_emg_scipy_equals_jax(host_input, remove_channels):
    before, raw, after = host_input
    assert host_dsp.HAVE_SCIPY == jax_host_dsp.HAVE_SCIPY
    got = host_dsp.preprocess_emg_scipy(raw, before, after, remove_channels)
    ref = jax_host_dsp.preprocess_emg_scipy(raw, before, after, remove_channels)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype == np.float32
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("rate", [RAW_RATE, FEAT_RATE])
def test_subsample_masked_per_column_matches_jax(rate):
    x = np.random.default_rng(3).normal(size=(1000, 6)).astype(np.float32)
    n = np.asarray([1000, 999, 640, 17, 2, 500], np.int32)
    out, out_len = subsample_masked(torch.tensor(x), torch.tensor(n), rate, SOURCE_RATE)
    ref, ref_len = jax_subsample_masked(jnp.asarray(x), jnp.asarray(n), rate, SOURCE_RATE)
    np.testing.assert_array_equal(out_len.numpy(), np.asarray(ref_len))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-6)
    # each column as a scalar-n call
    for c in range(x.shape[1]):
        one, one_len = subsample_masked(torch.tensor(x[:, c : c + 1]), int(n[c]), rate, SOURCE_RATE)
        assert one_len == int(out_len[c])
        np.testing.assert_array_equal(one[:one_len, 0].numpy(), out[:one_len, c].numpy())


@pytest.mark.parametrize("rate", [RAW_RATE, FEAT_RATE, 123.456], ids=["raw", "feat", "float"])
def test_masked_output_length_matches_jax(rate):
    n = np.arange(1, 20001, dtype=np.int32)
    got = masked_output_length(torch.tensor(n), rate, SOURCE_RATE)
    ref = np.asarray(jax_masked_output_length(jnp.asarray(n), rate, SOURCE_RATE))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), ref)
    for k in (1, 2, 17, 4095, 20000):
        assert masked_output_length(k, rate, SOURCE_RATE) == ref[k - 1]


@pytest.fixture(scope="module")
def batch():
    """U = 3 utterances in one bucket: (xs, n_totals, n_befores, n_afters),
    and JAX's ``preprocess_emg_batched`` of them."""
    rng = np.random.default_rng(0)
    xs = np.zeros((len(SPANS), BUCKET, 8), np.float32)
    n_totals = []
    for u, spans in enumerate(SPANS):
        x = np.concatenate([_synth_emg(rng, k, sentence_id=3 * u + j) for j, k in enumerate(spans)])
        xs[u, : len(x)] = x
        n_totals.append(len(x))
    counts = [np.asarray(c, np.int32) for c in
              (n_totals, [s[0] for s in SPANS], [s[2] for s in SPANS])]
    assert len(set(n_totals)) == len(SPANS)
    ref = jax_preprocess_emg_batched(jnp.asarray(xs), *counts, REMOVE)
    return (xs, *counts), ref


def batched(xs, n_totals, n_befores, n_afters):
    return preprocess_emg_batched(torch.tensor(xs), torch.tensor(n_totals),
                                  torch.tensor(n_befores), torch.tensor(n_afters), REMOVE)


@pytest.mark.parametrize("U", [1, 3])
def test_preprocess_emg_batched_matches_jax(batch, U):
    inputs, ref = batch
    out = batched(*(a[:U] for a in inputs))
    for field, count, bound in OUTPUTS:
        np.testing.assert_array_equal(getattr(out, count).numpy(),
                                      np.asarray(getattr(ref, count))[:U])
        assert getattr(out, field).shape[0] == U
        for u in range(U):
            n = int(getattr(out, count)[u])
            assert_close_at_scale(getattr(out, field)[u, :n].numpy(),
                                  np.asarray(getattr(ref, field))[u, :n], bound)
    assert torch.all(out.emg[..., REMOVE] == 0) and torch.all(out.emg_orig[..., REMOVE] == 0)


@pytest.mark.parametrize("U", [1, 3])
def test_preprocess_emg_batched_rows_match_single_calls(batch, U):
    (xs, n_totals, n_befores, n_afters), _ = batch
    out = batched(xs[:U], n_totals[:U], n_befores[:U], n_afters[:U])
    for u in range(U):
        one = preprocess_emg(torch.tensor(xs[u]), int(n_totals[u]), int(n_befores[u]),
                             int(n_afters[u]), REMOVE)
        for field, count, _ in OUTPUTS:
            n = getattr(one, count)
            assert int(getattr(out, count)[u]) == n
            got, want = getattr(out, field)[u, :n], getattr(one, field)[:n]
            if U == 1:
                assert torch.equal(got, want), field
            else:
                np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-6)
