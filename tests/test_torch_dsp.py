"""The port's DSP chain (emg_tpu_torch/dsp) on the CPU, where the IIR scan
is kernel 1's plain version, against three references:

- the JAX package's ``preprocess_emg`` on the CPU (its XLA Hillis-Steele
  scan path) on one fixture utterance in a 4096-sample bucket;
- the scipy front-end ``emg_tpu.dsp.host_dsp.preprocess_emg_scipy``;
- ``scipy.signal.filtfilt`` for single filters over a masked buffer.

Bounds are PARITY.md's, stated at the reference's ~±50 signal scale
(features ~1.6e-3 absolute, signals ~2e-4) and scaled with the fixture's
amplitude; filtfilt ~1e-5 in the bulk and ~1e-3 at the edges.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal
import torch

from emg_tpu.data.fixtures import _synth_emg
from emg_tpu.dsp.host_dsp import preprocess_emg_scipy
from emg_tpu.dsp.pipeline import preprocess_emg as jax_preprocess_emg

from emg_tpu_torch.data.dataset import dsp_input
from emg_tpu_torch.dsp import filters
from emg_tpu_torch.dsp.pipeline import align_lengths, preprocess_emg
from tests.test_torch_model import one_torch_thread  # noqa: F401

FEATURE_BOUND = 1.6e-3
SIGNAL_BOUND = 2e-4


def assert_close_at_scale(got, ref, bound):
    scale = max(1.0, float(np.abs(ref).max()) / 50.0)
    np.testing.assert_allclose(got, ref, rtol=0, atol=bound * scale)


@pytest.fixture(scope="module")
def utterance():
    rng = np.random.default_rng(0)
    before = _synth_emg(rng, 1000, sentence_id=0)
    raw = _synth_emg(rng, 2000, sentence_id=1)
    after = _synth_emg(rng, 900, sentence_id=2)
    buf, n_total, n_before, n_after = dsp_input(raw, before, after)
    assert buf.shape == (4096, 8)
    out = preprocess_emg(torch.tensor(buf), n_total, n_before, n_after)
    return (raw, before, after), (buf, n_total, n_before, n_after), out


def test_preprocess_matches_jax(utterance):
    _, (buf, n_total, n_before, n_after), out = utterance
    ref = jax_preprocess_emg(jnp.asarray(buf), n_total, n_before, n_after)
    assert (out.n_frames, out.n_feat, out.n_raw) == (
        int(ref.n_frames), int(ref.n_feat), int(ref.n_raw))
    F = out.n_frames
    assert_close_at_scale(out.emg_features.numpy()[:F], np.asarray(ref.emg_features)[:F],
                          FEATURE_BOUND)
    assert_close_at_scale(out.emg.numpy()[: out.n_feat], np.asarray(ref.emg)[: out.n_feat],
                          SIGNAL_BOUND)
    assert_close_at_scale(out.emg_orig.numpy()[: out.n_raw],
                          np.asarray(ref.emg_orig)[: out.n_raw], SIGNAL_BOUND)


def test_preprocess_matches_scipy(utterance):
    (raw, before, after), _, out = utterance
    feats, emg, emg_orig = preprocess_emg_scipy(raw, before, after)
    assert feats.shape[0] == out.n_frames
    assert emg.shape[0] == out.n_feat and emg_orig.shape[0] == out.n_raw
    assert_close_at_scale(out.emg_features.numpy()[: out.n_frames], feats, FEATURE_BOUND)
    assert_close_at_scale(out.emg.numpy()[: out.n_feat], emg, SIGNAL_BOUND)
    assert_close_at_scale(out.emg_orig.numpy()[: out.n_raw], emg_orig, SIGNAL_BOUND)
    (e0, elen), (r0, rlen) = align_lengths(out.n_frames)
    assert e0 + elen <= out.n_feat and r0 + rlen <= out.n_raw


def test_remove_channels_zeroes_columns(utterance):
    _, (buf, n_total, n_before, n_after), out = utterance
    dropped = preprocess_emg(torch.tensor(buf), n_total, n_before, n_after, (2, 5))
    assert torch.all(dropped.emg[:, [2, 5]] == 0) and torch.all(dropped.emg_orig[:, [2, 5]] == 0)
    keep = [0, 1, 3, 4, 6, 7]
    np.testing.assert_array_equal(dropped.emg[:, keep].numpy(), out.emg[:, keep].numpy())


# The 2 Hz high-pass's float32 transients decay slowly (its poles sit near
# 1) and reach through these short buffers: it is held to the JAX package's
# own bound for it (tests/test_dsp.py, 2e-3) everywhere. Against the JAX
# package's filtfilt_masked on the CPU the port agrees to float32 rounding.
@pytest.mark.parametrize("design,bulk_atol,edge_atol",
                         [("notch", 1e-5, 1e-3), ("highpass", 2e-3, 2e-3)])
@pytest.mark.parametrize("n", [300, 700])
def test_filtfilt_masked_matches_scipy(design, bulk_atol, edge_atol, n):
    from emg_tpu.dsp.filters import filtfilt_masked as jax_filtfilt_masked

    b, a = (filters.design_notch(120.0, 30.0, 1000.0) if design == "notch"
            else filters.design_highpass(3, 2.0, 1000.0))
    x = np.zeros((700, 3), np.float32)
    x[:n] = np.random.default_rng(42).normal(size=(n, 3))
    got = filters.filtfilt_masked(b, a, torch.tensor(x), n).numpy()[:n]
    ref = scipy.signal.filtfilt(b, a, x[:n].astype(np.float64), axis=0)
    edge = 100
    np.testing.assert_allclose(got[edge:-edge], ref[edge:-edge], rtol=0, atol=bulk_atol)
    np.testing.assert_allclose(got, ref, rtol=0, atol=edge_atol)
    jax_out = np.asarray(jax_filtfilt_masked(b, a, jnp.asarray(x), n))[:n]
    np.testing.assert_allclose(got, jax_out, rtol=0, atol=1e-5)


def test_filtfilt_masked_per_column_lengths():
    """A (C,) vector of valid lengths filters each column as if it ended
    there, exactly as per-column scalar calls do."""
    b, a = filters.design_notch(60.0, 30.0, 1000.0)
    x = torch.tensor(np.random.default_rng(1).normal(size=(512, 3)).astype(np.float32))
    lengths = [512, 400, 123]
    got = filters.filtfilt_masked(b, a, x, torch.tensor(lengths))
    for c, n in enumerate(lengths):
        one = filters.filtfilt_masked(b, a, x[:, c : c + 1], n)
        np.testing.assert_allclose(got[:n, c].numpy(), one[:n, 0].numpy(), rtol=1e-6, atol=1e-6)
