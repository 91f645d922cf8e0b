"""The port's remaining public DSP and data functions against the JAX
package's, on seeded numpy inputs, on the CPU (where the IIR scan is
kernel 1's plain version).

- ``dsp/recurrence.py``: ``linear_recurrence`` and ``diagonal_recurrence``
  against JAX's associative scans, to 1e-5 of the states' largest
  magnitude (another summation order, float32); ``diagonal_recurrence_tlast``
  bitwise (the same doubling scan).
- ``dsp/filters.py``: ``lfilter`` (with and without ``zi``) and
  ``filtfilt`` in 1-D and 2-D, for the drift high-pass and a notch,
  bitwise JAX's (the same float32 operations) and against scipy in float64
  to PARITY.md's float32 bounds, of the output's peak: 1e-5 for
  ``lfilter`` (2.4e-6 seen: the 2 Hz high-pass's poles near 1 carry a
  float32 state from ``zi``) and its ~1e-3 edge figure for ``filtfilt``
  (2.7e-4 seen, at the odd-extended edges);
  ``remove_drift``, ``notch`` and ``notch_harmonics`` with ``n=None``
  (the whole length) bitwise JAX's.
- ``subsample`` bitwise JAX's, and np.interp's grid to 1e-6;
  the unmasked ``get_emg_features`` to 1e-6 of the features' peak;
  ``mel_spectrogram`` to 1e-5 (absolute, of log-mels) of JAX's and of
  ``mel_spectrogram_np``, with ``mel_frame_count`` frames.
- ``preprocess_emg_host`` against JAX's at two lengths: with neighbor
  context and a removed channel, to tests/test_torch_dsp.py's bounds;
  alone, whose unpadded ends carry the 2 Hz high-pass's float32 transient
  (ROADMAP.md's "unpadded utterance ends"), to PARITY.md's edge figure,
  1e-3 of each output's peak.
- ``frame_bucket_for`` equals JAX's; ``EMGDataset.silent_subset`` and
  ``subset`` hold JAX's examples, in order, on the synthetic corpus.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal
import torch

from emg_tpu.data.batching import frame_bucket_for as jax_frame_bucket_for
from emg_tpu.data.fixtures import _synth_emg
from emg_tpu.dsp import features as jax_features
from emg_tpu.dsp import filters as jax_filters
from emg_tpu.dsp import mel as jax_mel
from emg_tpu.dsp import recurrence as jax_recurrence
from emg_tpu.dsp import resample as jax_resample
from emg_tpu.dsp.pipeline import preprocess_emg_host as jax_preprocess_emg_host
from tests.test_torch_dsp import FEATURE_BOUND, SIGNAL_BOUND, assert_close_at_scale
from tests.test_torch_model import one_torch_thread  # noqa: F401

from emg_tpu_torch.data.batching import FRAME_BUCKETS, frame_bucket_for
from emg_tpu_torch.dsp import features, filters, mel, recurrence, resample
from emg_tpu_torch.dsp.pipeline import preprocess_emg_host

DESIGNS = {"highpass": filters.design_highpass(3, 2.0, 1000.0),
           "notch": filters.design_notch(120.0, 30.0, 1000.0)}
SHAPES = {"1d": (900,), "2d": (900, 3)}
EDGE_REL = 1e-3  # PARITY.md's filtfilt edge figure, of the peak


def signal(shape, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(shape[0])[(slice(None),) + (None,) * (len(shape) - 1)]
    return (40.0 * rng.normal(size=shape) + 30.0 * np.sin(2 * np.pi * 60.0 * t / 1000.0)
            + 15.0).astype(np.float32)


def peak_rel(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_linear_recurrence_matches_jax():
    rng = np.random.default_rng(0)
    T, m = 45, 3
    A = (0.4 * rng.normal(size=(m, m))).astype(np.float32)
    u = rng.normal(size=(T, m)).astype(np.float32)
    z = rng.normal(size=m).astype(np.float32)
    want = np.asarray(jax_recurrence.linear_recurrence(jnp.asarray(A), jnp.asarray(u),
                                                       jnp.asarray(z)))
    got = recurrence.linear_recurrence(torch.tensor(A), torch.tensor(u), torch.tensor(z))
    assert got.shape == (T, m)
    assert peak_rel(got.numpy(), want) <= 1e-5


def _complex(rng, shape):
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(np.complex64)


def test_diagonal_recurrences_match_jax():
    rng = np.random.default_rng(1)
    T, m, C = 45, 3, 4
    lam = (0.95 * np.exp(1j * rng.uniform(0, 3, m))).astype(np.complex64)
    u, w0 = _complex(rng, (T, m)), _complex(rng, (m,))
    want = np.asarray(jax_recurrence.diagonal_recurrence(jnp.asarray(lam), jnp.asarray(u),
                                                         jnp.asarray(w0)))
    got = recurrence.diagonal_recurrence(torch.tensor(lam), torch.tensor(u), torch.tensor(w0))
    assert got.dtype == torch.complex64 and got.shape == (T, m)
    assert peak_rel(got.numpy(), want) <= 1e-5
    u, w0 = _complex(rng, (C, m, T)), _complex(rng, (C, m))
    want = np.asarray(jax_recurrence.diagonal_recurrence_tlast(
        jnp.asarray(lam), jnp.asarray(u), jnp.asarray(w0)))
    got = recurrence.diagonal_recurrence_tlast(torch.tensor(lam), torch.tensor(u),
                                               torch.tensor(w0))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("design", DESIGNS)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("with_zi", [False, True], ids=["zero_state", "zi"])
def test_lfilter_matches_jax_and_scipy(design, shape, with_zi):
    b, a = DESIGNS[design]
    x = signal(SHAPES[shape])
    zi = scipy.signal.lfilter_zi(b, a) if with_zi else None
    got = filters.lfilter(b, a, torch.tensor(x),
                          zi=None if zi is None else torch.tensor(zi, dtype=torch.float32))
    want = jax_filters.lfilter(b, a, jnp.asarray(x), zi=None if zi is None else jnp.asarray(zi))
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    sp_zi = None if zi is None else (zi if x.ndim == 1 else zi[:, None] * np.ones(x.shape[1]))
    ref = (scipy.signal.lfilter(b, a, x.astype(np.float64), axis=0) if zi is None
           else scipy.signal.lfilter(b, a, x.astype(np.float64), axis=0, zi=sp_zi)[0])
    assert peak_rel(got.numpy(), ref) <= 1e-5


@pytest.mark.parametrize("design", DESIGNS)
@pytest.mark.parametrize("shape", SHAPES)
def test_filtfilt_matches_jax_and_scipy(design, shape):
    b, a = DESIGNS[design]
    x = signal(SHAPES[shape], seed=2)
    got = filters.filtfilt(b, a, torch.tensor(x))
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_filters.filtfilt(b, a,
                                                                               jnp.asarray(x))))
    ref = scipy.signal.filtfilt(b, a, x.astype(np.float64), axis=0)
    assert peak_rel(got.numpy(), ref) <= EDGE_REL
    with pytest.raises(ValueError, match="padlen"):
        filters.filtfilt(b, a, torch.tensor(x[:9]))


def test_filter_chains_over_the_whole_length_match_jax():
    x = signal((1200, 2), seed=3)
    for got, want in (
        (filters.remove_drift(torch.tensor(x)), jax_filters.remove_drift(jnp.asarray(x))),
        (filters.notch(torch.tensor(x), 180.0), jax_filters.notch(jnp.asarray(x), 180.0)),
        (filters.notch_harmonics(torch.tensor(x)), jax_filters.notch_harmonics(jnp.asarray(x))),
    ):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("shape", SHAPES)
def test_subsample_matches_jax(shape):
    x = signal(SHAPES[shape], seed=4)
    got = resample.subsample(torch.tensor(x), 689.06, 1000.0)
    assert got.shape[0] == resample.subsample_length(x.shape[0], 689.06, 1000.0)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jax_resample.subsample(jnp.asarray(x), 689.06, 1000.0)))
    grid = np.arange(got.shape[0]) / 689.06
    col = x if x.ndim == 1 else x[:, 0]
    ref = np.interp(grid, np.arange(x.shape[0]) / 1000.0, col.astype(np.float64))
    assert peak_rel((got if x.ndim == 1 else got[:, 0]).numpy(), ref) <= 1e-6


def test_get_emg_features_matches_jax():
    x = signal((800, 8), seed=5)
    got = features.get_emg_features(torch.tensor(x))
    want = np.asarray(jax_features.get_emg_features(jnp.asarray(x)))
    assert got.dtype == torch.float32 and got.shape == want.shape == (features.n_frames(800), 112)
    assert peak_rel(got.numpy(), want) <= 1e-6


def test_mel_spectrogram_matches_jax():
    y = (0.1 * np.random.default_rng(6).normal(size=5003)).astype(np.float32)
    got = mel.mel_spectrogram(torch.tensor(y))
    want = np.asarray(jax_mel.mel_spectrogram(jnp.asarray(y)))
    assert got.shape == want.shape == (mel.mel_frame_count(5003), 80)
    assert mel.mel_frame_count(5003) == jax_mel.mel_frame_count(5003)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), mel.mel_spectrogram_np(y), rtol=0, atol=1e-5)


@pytest.mark.parametrize("lengths", [(0, 1500, 0, ()), (700, 2300, 500, (3,))],
                         ids=["alone", "context"])
def test_preprocess_emg_host_matches_jax(lengths):
    n_before, n_raw, n_after, remove = lengths
    rng = np.random.default_rng(7)
    before, raw, after = (_synth_emg(rng, n, sentence_id=i).astype(np.float32) if n
                          else np.zeros((0, 8), np.float32)
                          for i, n in enumerate((n_before, n_raw, n_after)))
    got = preprocess_emg_host(raw, before, after, remove, device="cpu")
    want = jax_preprocess_emg_host(raw, before, after, remove)
    for g, w, bound in zip(got, want, (FEATURE_BOUND, SIGNAL_BOUND, SIGNAL_BOUND)):
        assert isinstance(g, np.ndarray) and g.dtype == np.float32 and g.shape == w.shape
        if n_before:
            assert_close_at_scale(g, w, bound)
        else:  # unpadded ends: the edge figure (3.1e-4 of the peak seen)
            assert peak_rel(g, w) <= EDGE_REL
    capped = preprocess_emg_host(raw, before, after, remove, max_frames=10, device="cpu")
    assert capped[0].shape[0] == 10 and capped[1].shape[0] == 60 and capped[2].shape[0] == 80
    for c in remove:
        assert not got[1][:, c].any() and not got[2][:, c].any()


def test_frame_bucket_for_matches_jax():
    for lengths in ([1], [63, 64], [65], [100, 191, 3], [384], [1500, 2048]):
        assert frame_bucket_for(lengths) == jax_frame_bucket_for(lengths)
    assert frame_bucket_for([70]) == FRAME_BUCKETS[1]
    with pytest.raises(ValueError):
        frame_bucket_for([FRAME_BUCKETS[-1] + 1])


def test_subsets_match_jax(tmp_path):
    from emg_tpu.config import Config as JaxConfig
    from emg_tpu.data.dataset import EMGDataset as JaxEMGDataset

    from emg_tpu_torch.config import Config
    from emg_tpu_torch.data.dataset import EMGDataset
    from emg_tpu_torch.data.fixtures import make_synthetic_corpus

    paths = make_synthetic_corpus(str(tmp_path), n_sentences=4, seed=0)

    def config(cls):
        cfg = cls()
        cfg.data.silent_data_directories = [paths["silent_data_directories"]]
        cfg.data.voiced_data_directories = paths["voiced_data_directories"].split(",")
        cfg.data.testset_file = paths["testset_file"]
        cfg.paths.dict = paths["dict"]
        return cfg

    ours = EMGDataset(config(Config), no_normalizers=True, device="cpu")
    ref = JaxEMGDataset(config(JaxConfig), no_normalizers=True)

    def examples(ds):
        return [(d.directory, d.silent, i) for d, i in ds.example_indices]

    silent = ours.silent_subset()
    assert examples(silent) == examples(ref.silent_subset())
    assert 0 < len(silent) < len(ours) and all(d.silent for d, _ in silent.example_indices)
    for fraction in (0.0, 0.5, 0.75, 1.0):
        part = ours.subset(fraction)
        assert examples(part) == examples(ref.subset(fraction))
        assert len(part) == int(fraction * len(ours))
    # a subset keeps a cache of its own and loads as the whole dataset does
    part = ours.subset(0.5)
    ours[0]
    assert 0 in ours._cache and not part._cache
    np.testing.assert_array_equal(part[0]["emg"], ours[0]["emg"])
    assert len(ours) == len(examples(ref))
