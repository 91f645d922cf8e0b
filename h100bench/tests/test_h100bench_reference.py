"""The reference against the port at a tiny size on the CPU: its DSP, its
batches and a whole training cell's check."""

import json

import numpy as np
import pytest

from h100bench import run
from h100bench.reference import batching, dsp
from h100bench.tests.conftest import HERE
from h100bench.traffic import make_utterances

MIX = json.loads((HERE / "traffic" / "train512.json").read_text())


def test_reference_dsp_is_the_port_host_dsp():
    from emg_tpu_torch.dsp.host_dsp import preprocess_emg_scipy
    from emg_tpu_torch.dsp.pipeline import align_lengths

    utt = make_utterances(MIX, 3, 7)[0]
    rows, frames = dsp.training_input(utt.raw)
    feats, _, emg_orig = preprocess_emg_scipy(utt.raw, np.zeros((0, 8)), np.zeros((0, 8)))
    assert frames == feats.shape[0]
    (_, _), (r0, rlen) = align_lengths(frames)
    want = emg_orig[r0: r0 + rlen] / 20.0
    np.testing.assert_allclose(rows, 50.0 * np.tanh(want / 50.0), rtol=1e-6, atol=1e-6)


def test_reference_batches_are_the_port_sampler(tmp_path):
    from emg_tpu_torch.data.sampler import DynamicBatchSampler
    from emg_tpu_torch.train.window import plan_windows

    from h100bench.cells.train import _Corpus

    raw = [u.raw.shape[0] for u in make_utterances(MIX, 512, 3)]
    sampler = DynamicBatchSampler(_Corpus(str(tmp_path), raw), 80000, 16, seed=42, epoch=0)

    class Cfg:
        report_loss, batch_size_grad = 50, 100

    for epoch in (0, 1, 7):
        sampler.set_epoch(epoch)
        port = list(sampler)
        assert batching.sampler_batches(raw, 80000, 16, 42, epoch) == port
        assert batching.plan_windows([len(b) for b in port], 100, 50) == plan_windows(port, 0, Cfg)


def test_reference_packing_is_the_port_packing():
    import torch

    from emg_tpu_torch.data.batching import (dequantize_packed_raw, make_packed_batch,
                                             quantize_packed_raw)

    utts = make_utterances(MIX, 5, 9)
    inputs = [dsp.training_input(u.raw) for u in utts]
    rows, frames = [r for r, _ in inputs], [f for _, f in inputs]
    phones = [u.phones for u in utts]
    b = batching.make_batch(rows, frames, phones, 1600, True)
    pb = quantize_packed_raw(make_packed_batch(rows, frames, phones, chunk=1600))
    staged = dequantize_packed_raw(torch.as_tensor(pb.packed_raw)).numpy()
    np.testing.assert_array_equal(b.packed, staged)
    np.testing.assert_array_equal(b.targets, pb.targets)
    np.testing.assert_array_equal(b.lengths, pb.lengths)
    np.testing.assert_array_equal(b.offsets, pb.offsets)
    assert b.n_rows == pb.n_rows and b.n_examples == pb.n_examples


@pytest.mark.parametrize("cell", ["tiny_tf_train", "tiny_conformer_train"])
def test_program_matches_reference_on_the_cpu(tiny, cell):
    home, bench = tiny
    result = run.run_cell(bench, cell, 2 ** 31 + 3, 0.5, False, device="cpu", home=home)
    assert result["correct"], result["checks"]
    # dropout masks, DSP, batches and losses are the same: the loss differs
    # by bfloat16 rounding alone
    assert result["checks"]["loss_gap"]["value"] < 2e-3
    assert list(result)[-1] == "checks"

