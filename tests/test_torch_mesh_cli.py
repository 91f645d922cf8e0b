"""The port's CLI trains on a mesh of CPU ranks.

``python -m emg_tpu_torch.cli --device cpu --parallel.data_axis 2`` trains
the tiny model (d=16, 1+1 layers, dropout 0) for one epoch on a
4-sentence synthetic corpus as two gloo ranks that the CLI launches:
log.txt, the metrics and model.pt are written once, by rank 0, and
model.pt equals the single-device run's to 1e-5 of each tensor's largest
magnitude (BatchNorm-fed conv biases, whose gradient is float32 noise, to
Adam's step bound, and the running means those biases feed to a fifth of
it). ``--resume`` on the mesh continues from the saved counters.
"""

import glob
import os

import numpy as np
import pytest
import torch

from tests.test_torch_model import one_torch_thread  # noqa: F401

from emg_tpu_torch import cli
from emg_tpu_torch.config import Config
from emg_tpu_torch.data.dataset import make_normalizers
from emg_tpu_torch.data.fixtures import make_synthetic_corpus

TINY = ["--model.model_size", "16", "--feed_forward_layer_size", "32",
        "--num_layers_encoder", "1", "--num_layers_decoder", "1",
        "--n_heads_encoder", "2", "--n_heads_decoder", "2", "--relative_distance", "8",
        "--dropout_model", "0", "--dropout_pos_emb", "0"]
TRAIN = ["--max_batch_length", "6000", "--batch_size_grad", "2", "--report_loss", "2",
         "--per_train_batches", "1", "--learning_rate_warmup", "4", "--device", "cpu"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh_corpus")
    paths = make_synthetic_corpus(str(root), n_sentences=4, seed=0)
    argv = ["--silent_data_directories", paths["silent_data_directories"],
            "--voiced_data_directories", paths["voiced_data_directories"],
            "--testset_file", paths["testset_file"], "--dict", paths["dict"],
            "--normalizers_file", os.path.join(str(root), "normalizers.pkl")] + TINY
    make_normalizers(Config.from_args(argv), device="cpu")
    return root, argv


@pytest.fixture(scope="module")
def trained(corpus):
    """One epoch on the 2x1 mesh and on one device."""
    root, argv = corpus
    mesh_out, single_out = root / "mesh", root / "single"
    assert cli.main(argv + TRAIN + ["--n_epochs", "1", "--parallel.data_axis", "2",
                                    "--output_directory", str(mesh_out)]) is None
    trainer = cli.main(argv + TRAIN + ["--n_epochs", "1", "--output_directory", str(single_out)])
    assert trainer.mesh is None
    return argv, mesh_out, single_out


def test_cli_trains_on_a_data_axis_of_two(trained):
    _, mesh_out, single_out = trained
    # rank 0 alone wrote the log and the metrics
    log_lines = (mesh_out / "log.txt").read_text().splitlines()
    assert sum("finished epoch 1" in line for line in log_lines) == 1
    assert any("parallel mesh: 2 data x 1 model" in line for line in log_lines)
    assert len(glob.glob(str(mesh_out / "logs" / "run" / "*" / "metrics.jsonl"))) == 1
    # model.pt: the single-device run's weights
    got = torch.load(mesh_out / "model.pt", weights_only=True)
    want = torch.load(single_out / "model.pt", weights_only=True)
    assert got.keys() == want.keys()
    latest = torch.load(mesh_out / "latest", weights_only=True)
    assert latest["updates"] >= 1
    lr_sum = 1e-3 * latest["updates"]  # warmup LRs never exceed the peak rate
    for name, w in want.items():
        if name.endswith("num_batches_tracked"):
            assert torch.equal(got[name], w)
            continue
        g, w = got[name].numpy(), w.numpy()
        if name.startswith("conv_blocks") and name.endswith(("conv1.bias", "conv2.bias",
                                                            "residual_path.bias")):
            np.testing.assert_allclose(g, w, rtol=0, atol=2 * lr_sum, err_msg=name)
            continue
        atol = max(1e-5 * float(np.abs(w).max()), 1e-6)
        if name.endswith("running_mean"):
            atol += 0.2 * lr_sum
        np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=name)


def test_cli_resumes_on_the_mesh(trained):
    argv, mesh_out, _ = trained
    latest = torch.load(mesh_out / "latest", weights_only=True)
    assert cli.main(argv + TRAIN + ["--n_epochs", "2", "--parallel.data_axis", "2", "--resume",
                                    "--output_directory", str(mesh_out)]) is None
    resumed = torch.load(mesh_out / "latest", weights_only=True)
    assert resumed["extra"]["epoch"] == 1
    assert resumed["microbatches"] > latest["microbatches"]
    assert resumed["updates"] > latest["updates"]
