"""The port's training loop end to end on the CPU, and its data plumbing
against the JAX package's.

- ``DynamicBatchSampler`` gives the JAX sampler's batches for the same
  dataset, seed and epoch; int16 staging rounds as the JAX package does.
- ``python -m emg_tpu_torch.cli --device cpu`` trains a tiny model (d=16,
  1+1 layers) for one epoch on a 4-sentence synthetic corpus, writes
  ``latest`` and ``model.pt``, and ``--evaluate_saved_greedy_search`` serves
  the model.pt it wrote. Without ``--device cpu`` (and without a card) it
  raises.
- ``--resume`` from that ``latest`` for a second epoch ends at the
  parameters, BatchNorm statistics and AdamW state of an uninterrupted
  two-epoch run, exactly (the same float32 operations in the same order).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from emg_tpu.data.batching import PackedBatch as JaxPackedBatch
from emg_tpu.data.batching import quantize_packed_raw as jax_quantize
from emg_tpu.data.sampler import DynamicBatchSampler as JaxSampler
from emg_tpu.data.sampler import SizeAwareSampler as JaxSizeAwareSampler
from tests.test_torch_model import one_torch_thread  # noqa: F401

from emg_tpu_torch import cli
from emg_tpu_torch.config import Config, ModelConfig
from emg_tpu_torch.data.batching import (
    PackedBatch,
    dequantize_packed_raw,
    make_packed_batch,
    quantize_packed_raw,
)
from emg_tpu_torch.data.dataset import EMGDataset, make_normalizers
from emg_tpu_torch.data.fixtures import make_synthetic_corpus
from emg_tpu_torch.data.sampler import DynamicBatchSampler, SizeAwareSampler
from emg_tpu_torch.models.model import EMGModel
from emg_tpu_torch.train.checkpoint import load_weights, merge_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--model.model_size", "16", "--feed_forward_layer_size", "32",
        "--num_layers_encoder", "1", "--num_layers_decoder", "1",
        "--n_heads_encoder", "2", "--n_heads_decoder", "2", "--relative_distance", "8"]
TRAIN = ["--max_batch_length", "6000", "--batch_size_grad", "2", "--report_loss", "2",
         "--per_train_batches", "1", "--learning_rate_warmup", "4"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_corpus")
    paths = make_synthetic_corpus(str(root), n_sentences=4, seed=0)
    argv = ["--silent_data_directories", paths["silent_data_directories"],
            "--voiced_data_directories", paths["voiced_data_directories"],
            "--testset_file", paths["testset_file"], "--dict", paths["dict"],
            "--normalizers_file", os.path.join(str(root), "normalizers.pkl")] + TINY
    make_normalizers(Config.from_args(argv), device="cpu")
    return root, argv


def run_dir(root, name):
    return ["--output_directory", str(root / name)]


def test_sampler_matches_jax(corpus):
    _, argv = corpus
    trainset = EMGDataset(Config.from_args(argv), device="cpu")
    for max_len, seed in ((6000, 42), (3000, 7)):
        ours = DynamicBatchSampler(trainset, max_len, 16, seed=seed)
        ref = JaxSampler(trainset, max_len, 16, seed=seed)
        for epoch in range(3):
            ours.set_epoch(epoch)
            ref.set_epoch(epoch)
            assert list(ours) == list(ref)
            assert len(ours) == len(ref) > 1


def test_size_aware_sampler_matches_jax(corpus):
    _, argv = corpus
    trainset = EMGDataset(Config.from_args(argv), device="cpu")
    for max_len, seed in ((6000, 3), (9000, 11)):
        ours = list(SizeAwareSampler(trainset, max_len, seed=seed))
        assert ours == list(JaxSizeAwareSampler(trainset, max_len, seed=seed)) and ours


def test_warm_start_takes_matching_tensors(tmp_path):
    """--start_training_from: tensors whose name and shape match are copied
    (a DataParallel ``module.`` prefix is dropped); the rest keep their
    initial values."""
    small = EMGModel(ModelConfig(model_size=16, feed_forward_layer_size=32, num_layers_encoder=1,
                                 num_layers_decoder=1, n_heads_encoder=2, n_heads_decoder=2),
                     device="cpu", generator=torch.Generator().manual_seed(1))
    target = EMGModel(ModelConfig(model_size=16, feed_forward_layer_size=64, num_layers_encoder=1,
                                  num_layers_decoder=1, n_heads_encoder=2, n_heads_decoder=2),
                      device="cpu")
    before = {k: v.clone() for k, v in target.state_dict().items()}
    path = tmp_path / "model.pt"
    torch.save({"module." + k: v for k, v in small.state_dict().items()}, path)
    n = merge_params(target, load_weights(str(path)))
    src = small.state_dict()
    copied = [k for k, v in target.state_dict().items() if src[k].shape == v.shape]
    assert n == len(copied) and "transformerEncoder.layers.0.linear1.weight" not in copied
    for k, v in target.state_dict().items():
        torch.testing.assert_close(v, src[k] if k in copied else before[k], rtol=0, atol=0)


def test_int16_staging_matches_jax():
    rng = np.random.default_rng(0)
    raw = [(50 * np.tanh(rng.normal(size=(n, 8)) * 3 / 50)).astype(np.float32)
           for n in (1700, 900)]
    pb = make_packed_batch(raw, [212, 112], [np.arange(9), np.arange(5)], chunk=400)
    ours = quantize_packed_raw(pb)
    ref = jax_quantize(JaxPackedBatch(**vars(pb)))
    assert isinstance(ours, PackedBatch) and ours.packed_raw.dtype == np.int16
    np.testing.assert_array_equal(ours.packed_raw, np.asarray(ref.packed_raw))
    back = dequantize_packed_raw(torch.as_tensor(ours.packed_raw))
    assert back.dtype == torch.float32
    np.testing.assert_allclose(back.numpy(), pb.packed_raw, atol=0.5 / (32767 / 50) + 1e-6)


def test_cli_trains_serves_and_resumes(corpus):
    root, argv = corpus
    # one epoch through the module entry point, in its own interpreter
    first = argv + TRAIN + run_dir(root, "first") + ["--n_epochs", "1", "--device", "cpu"]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")  # one thread, as in-process
    subprocess.run([sys.executable, "-m", "emg_tpu_torch.cli", *first], cwd=REPO, env=env,
                   check=True, capture_output=True, timeout=300)
    out = root / "first"
    assert (out / "latest").exists() and (out / "model.pt").exists()
    assert "finished epoch 1" in (out / "log.txt").read_text()

    per, acc = cli.main(argv + run_dir(root, "eval") + [
        "--device", "cpu", "--decode.compute_dtype", "float32",
        "--evaluate_saved_greedy_search", str(out / "model.pt")])
    assert 0.0 <= per < float("inf") and 0.0 <= acc <= 100.0

    # the same epoch 1 twice: resumed from the first run's latest, and as
    # the second epoch of an uninterrupted run
    two = TRAIN + ["--n_epochs", "2", "--device", "cpu"]
    resumed = cli.main(argv + two + run_dir(root, "first") + ["--resume"])
    straight = cli.main(argv + two + run_dir(root, "straight"))
    a, b = resumed.ckpt, straight.ckpt
    ta = torch.load(os.path.join(a.directory, "latest"), weights_only=True)
    tb = torch.load(os.path.join(b.directory, "latest"), weights_only=True)
    assert ta["microbatches"] == tb["microbatches"] > 0
    assert ta["updates"] == tb["updates"] > 0
    assert ta["extra"]["epoch"] == tb["extra"]["epoch"] == 1
    for k in tb["model"]:
        torch.testing.assert_close(ta["model"][k], tb["model"][k], rtol=0, atol=0, msg=k)
    for i, s in tb["optimizer"]["state"].items():
        for key in ("exp_avg", "exp_avg_sq"):
            torch.testing.assert_close(ta["optimizer"]["state"][i][key], s[key], rtol=0, atol=0)
    for k in tb["accum_grads"]:
        torch.testing.assert_close(ta["accum_grads"][k], tb["accum_grads"][k], rtol=0, atol=0)


def test_cli_needs_a_card_or_cpu(corpus, monkeypatch):
    root, argv = corpus
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(argv + TRAIN + run_dir(root, "nocard") + ["--n_epochs", "1"])
