"""The port's utilities and EMG-UKA adapter against the JAX package's.

- ``splice_audio``, ``confusion_matrix``, ``top_confusions`` and
  ``print_confusion`` (its printed text) equal JAX's on the same inputs.
- ``profile_trace`` writes a torch.profiler trace into its directory whose
  events hold a ``span`` region's name, and nothing when disabled.
- The EMG-UKA adapter: JAX's ``test_emg_uka_adapter`` on the port, and
  ``stack_frames`` and the quantile-filtered sampler's batches (same seed
  and epoch) equal to JAX's.
"""

import json
import os

import numpy as np
import pytest
import torch

from emg_tpu.data import emg_uka as jax_emg_uka
from emg_tpu.utils import audio as jax_audio
from emg_tpu.utils import confusion as jax_confusion

from emg_tpu_torch.data.emg_uka import (
    SCHEMA,
    EMGUKADataset,
    QuantileFilteredSampler,
    UtteranceIndex,
    stack_frames,
)
from emg_tpu_torch.utils import (
    confusion_matrix,
    print_confusion,
    profile_trace,
    span,
    splice_audio,
)
from emg_tpu_torch.utils.confusion import top_confusions


@pytest.mark.parametrize("lengths, overlap", [((100, 100), 20), ((300, 57, 120), 57), ((64,), 8)])
def test_splice_audio_equals_jax(lengths, overlap):
    rng = np.random.default_rng(len(lengths))
    chunks = [rng.normal(size=n) for n in lengths]
    got = splice_audio(chunks, overlap)
    np.testing.assert_array_equal(got, jax_audio.splice_audio(chunks, overlap))
    assert got[0] == 0.0 and got[-1] == 0.0  # the result's own ends are faded
    if lengths == (100, 100):
        np.testing.assert_allclose(splice_audio([np.ones(100), np.ones(100)], 20)[90], 1.0,
                                   atol=0.1)


def test_confusion_equals_jax(capsys):
    rng = np.random.default_rng(5)
    preds = [rng.integers(0, 43, size=n) for n in (30, 12, 50)]
    tgts = [np.where(rng.random(len(p)) < 0.6, p, rng.integers(0, 43, size=len(p))) for p in preds]
    mat = confusion_matrix(preds, tgts)
    np.testing.assert_array_equal(mat, jax_confusion.confusion_matrix(preds, tgts))
    assert mat.sum() == sum(len(p) for p in preds)
    assert top_confusions(mat, 7) == jax_confusion.top_confusions(mat, 7)
    print_confusion(mat, n=7)
    got = capsys.readouterr().out
    jax_confusion.print_confusion(mat, n=7)
    assert got == capsys.readouterr().out
    assert got.startswith("Common confusions") and len(got.splitlines()) == 8


def test_profile_trace_writes_annotated_regions(tmp_path):
    log_dir = tmp_path / "trace"
    with profile_trace(str(log_dir)) as prof:
        with span("torch_utils_region"):
            x = torch.ones(64) * 3.0
    assert float(x.sum()) == 192.0
    files = os.listdir(log_dir)
    assert files == [os.path.basename(prof.trace_path)] and files[0].endswith(".pt.trace.json")
    with open(prof.trace_path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "torch_utils_region" in names

    off = tmp_path / "off"
    with profile_trace(str(off), enabled=False) as prof:
        with span("torch_utils_region"):
            torch.ones(4).sum()
    assert prof is None and not off.exists()


@pytest.fixture
def uka_index(tmp_path):
    """JAX's test's index: 10 utterances of speaker 901, the last a
    2000-frame outlier; the same rows in a port and a JAX index."""
    rng = np.random.default_rng(0)
    idx = UtteranceIndex(str(tmp_path / "uka.db"))
    jax_idx = jax_emg_uka.UtteranceIndex(str(tmp_path / "uka_jax.db"))
    for i in range(10):
        n = int(rng.integers(20, 200 if i < 9 else 2000))
        path = str(tmp_path / f"utt{i}.npy")
        np.save(path, rng.normal(size=(n, 32)).astype(np.float32))
        idx.add("901", "s1", path, n, f"text {i}")
        jax_idx.add("901", "s1", path, n, f"text {i}")
    yield idx, jax_idx
    idx.close()
    jax_idx.close()


def test_emg_uka_adapter(uka_index):
    idx, _ = uka_index
    assert SCHEMA == jax_emg_uka.SCHEMA
    ds = EMGUKADataset(idx, speaker="901", stack_left=2, stack_right=2)
    assert len(ds) == 10
    ex = ds[0]
    assert ex.features.shape[1] == 32 * 5 and ex.features.dtype == np.float32
    assert (ex.speaker, ex.session, ex.text) == ("901", "s1", "text 0")
    f = np.arange(12).reshape(4, 3).astype(float)
    st = stack_frames(f, 1, 1)
    np.testing.assert_allclose(st[0, :3], f[0])  # left edge replicated
    np.testing.assert_allclose(st[0, 3:6], f[0])
    sampler = QuantileFilteredSampler(ds, batch_size=2, length_quantile=0.9)
    batches = list(sampler)
    assert batches and all(len(b) == 2 for b in batches)
    assert 9 not in {i for b in batches for i in b}  # the 2000-frame outlier was filtered


@pytest.mark.parametrize("left, right", [(0, 0), (1, 1), (3, 0), (2, 5)])
def test_stack_frames_equals_jax(left, right):
    feats = np.random.default_rng(left + 7 * right).normal(size=(9, 4))
    np.testing.assert_array_equal(stack_frames(feats, left, right),
                                  jax_emg_uka.stack_frames(feats, left, right))


@pytest.mark.parametrize("seed, epoch", [(0, 0), (0, 3), (11, 1)])
def test_sampler_and_examples_equal_jax(uka_index, seed, epoch):
    idx, jax_idx = uka_index
    ds = EMGUKADataset(idx, stack_left=1, stack_right=2)
    jds = jax_emg_uka.EMGUKADataset(jax_idx, stack_left=1, stack_right=2)
    assert ds.rows == jds.rows and ds.lengths() == jds.lengths()
    sampler = QuantileFilteredSampler(ds, batch_size=3, length_quantile=0.8, seed=seed)
    jax_sampler = jax_emg_uka.QuantileFilteredSampler(jds, batch_size=3, length_quantile=0.8,
                                                      seed=seed)
    sampler.set_epoch(epoch)
    jax_sampler.set_epoch(epoch)
    batches = list(sampler)
    assert batches == list(jax_sampler) and len(batches) == len(sampler) == len(jax_sampler)
    for i in batches[0]:
        np.testing.assert_array_equal(ds[i].features, jds[i].features)
