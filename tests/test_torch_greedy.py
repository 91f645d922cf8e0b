"""The slice as a whole: the port's serving path against the JAX package's.

A tiny synthetic corpus (the JAX package's ``make_synthetic_corpus``, 4
sentences) and a small model (d=32, 2+2 layers) whose JAX variables are
carried into the port. Float32 on both sides.

- The port's ``run_greedy`` and the JAX ``run_greedy`` give identical phone
  strings and accuracy matrices on the same ``PackedBatch``es.
- The port's CLI entry point ``evaluate_saved_greedy_search`` (device DSP
  -> encoder -> KV-cached greedy -> PER, on the CPU) runs end to end and
  returns the same PER and accuracy as the JAX ``run_greedy`` on the very
  batches the port's dataset built (``data.dsp_backend="device"``: "auto"
  would take the scipy host DSP on the CPU). The comparison shares batches rather
  than crossing the two DSP paths, whose ~2e-4 signal difference may flip
  an argmax under random weights.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from emg_tpu.config import ModelConfig as JaxModelConfig
from emg_tpu.data.batching import PackedBatch as JaxPackedBatch
from emg_tpu.data.fixtures import make_synthetic_corpus
from emg_tpu.decode.greedy import run_greedy as jax_run_greedy
from emg_tpu.models.model import EMGModel as JaxEMGModel
from emg_tpu.text.metrics import wer as jax_wer

from emg_tpu_torch import cli
from emg_tpu_torch.config import Config, ModelConfig
from emg_tpu_torch.data.dataset import EMGDataset, make_normalizers
from emg_tpu_torch.decode.greedy import run_greedy
from emg_tpu_torch.models.model import EMGModel
from emg_tpu_torch.utils.convert import state_dict_from_flax
from tests.test_torch_model import GEOMETRY, one_torch_thread, perturbed  # noqa: F401


def as_jax_batch(pb) -> JaxPackedBatch:
    return JaxPackedBatch(**dataclasses.asdict(pb))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    paths = make_synthetic_corpus(str(root), n_sentences=4, seed=0)
    cfg = Config()
    cfg.data.silent_data_directories = [paths["silent_data_directories"]]
    cfg.data.voiced_data_directories = paths["voiced_data_directories"].split(",")
    cfg.data.testset_file = paths["testset_file"]
    cfg.paths.dict = paths["dict"]
    cfg.data.normalizers_file = os.path.join(str(root), "normalizers.pkl")
    cfg.paths.output_directory = str(root / "out")
    cfg.model = ModelConfig(**GEOMETRY)
    cfg.decode.compute_dtype = "float32"
    cfg.data.dsp_backend = "device"
    make_normalizers(cfg, device="cpu")

    testset = EMGDataset(cfg, test=True, device="cpu")
    prepared = [cli.prepare_single(cfg, testset, i) for i in range(len(testset))]
    pb0 = prepared[0][0]

    jm = JaxEMGModel(JaxModelConfig(**GEOMETRY))
    variables = jm.init(
        {"params": jax.random.PRNGKey(0)}, pb0.packed_raw, pb0.n_rows, pb0.offsets,
        pb0.lengths, pb0.targets[:, :-1], prepared[0][1], False,
    )
    variables = perturbed(
        {"params": variables["params"], "batch_stats": variables["batch_stats"]},
        np.random.default_rng(11),
    )
    state = state_dict_from_flax(variables, 2, 2)
    ckpt = str(root / "model.pt")
    torch.save(state, ckpt)
    cfg.paths.evaluate_saved_greedy_search = ckpt
    tm = EMGModel(ModelConfig(**GEOMETRY), device="cpu")
    tm.load_state_dict(state)
    return cfg, prepared, jm, variables, tm.eval()


def test_run_greedy_matches_jax(setup):
    _, prepared, jm, variables, tm = setup
    assert prepared, "the corpus has no test utterance"
    for pb, max_frames, raw in prepared:
        target_len = int(raw["phonemes_int_lengths"][0]) - 1
        cap = pb.targets.shape[1] - 1
        strings, matrix = run_greedy(tm, pb, max_frames, target_len, cap)
        jstrings, jmatrix = jax_run_greedy(jm, variables, as_jax_batch(pb), max_frames,
                                           target_len, cap)
        assert strings == jstrings
        np.testing.assert_array_equal(matrix, np.asarray(jmatrix))


def test_cli_per_matches_jax_on_shared_batches(setup):
    cfg, prepared, jm, variables, _ = setup
    argv = ["--device", "cpu", "--decode.compute_dtype", "float32", "--data.dsp_backend", "device"]
    argv += [f"--model.{k}={v}" for k, v in GEOMETRY.items()]
    for key in ("silent_data_directories", "voiced_data_directories"):
        argv += [f"--data.{key}", ",".join(getattr(cfg.data, key))]
    argv += ["--testset_file", cfg.data.testset_file, "--normalizers_file",
             cfg.data.normalizers_file, "--dict", cfg.paths.dict, "--output_directory",
             cfg.paths.output_directory, "--evaluate_saved_greedy_search",
             cfg.paths.evaluate_saved_greedy_search]
    per, acc = cli.main(argv)

    references, predictions, total, correct = [], [], 0, 0
    for pb, max_frames, raw in prepared:
        S_true = int(raw["phonemes_int_lengths"][0])
        strings, matrix = jax_run_greedy(jm, variables, as_jax_batch(pb), max_frames,
                                         S_true - 1, pb.targets.shape[1] - 1)
        y = np.asarray(raw["phonemes_int"][0])[None, :S_true]
        predictions += strings[:1]
        references += raw["phonemes"]
        total += y.size
        correct += int((np.asarray(matrix)[:1, :S_true] == y).sum())
    assert per == jax_wer(references, predictions)
    assert acc == round(100 * correct / max(total, 1), 1)
    assert os.path.exists(os.path.join(cfg.paths.output_directory, "log_greedy_search.txt"))
