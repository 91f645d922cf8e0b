"""The slice as a whole: the port's beam evaluation entry point against the
JAX package's.

A synthetic corpus (the JAX package's ``make_synthetic_corpus``, 8
sentences, 2 of them in the test split), a small model (d=32, 2+2 layers)
whose perturbed JAX weights are carried into the port, and an order-3 ARPA
that the port's ``lm_train`` trains on the corpus's sentences. Float32 on
both sides, beam width 16, two utterances per device-beam launch.

``python -m emg_tpu_torch.cli --evaluate_saved_beam_search`` (device DSP,
``--data.dsp_backend device`` -> encoder -> beam -> WER, on the CPU) writes log_beam_search.txt with the
same prediction lines and the same WER as ``emg_tpu.cli``'s, through the
device beam and through the host beam, and through the device beam with
``--quantize_int8 true`` and with ``--continuous_lanes 2`` (on a 12-sentence
corpus whose three test utterances share a geometry group, so that two
lanes serve them with one refill). ``--evaluate_saved_greedy_search
--quantize_int8 true`` writes the JAX CLI's log_greedy_search.txt. The JAX
side is given the batches the port's dataset built, as
tests/test_torch_greedy.py does: the two DSP paths differ by ~2e-4, which
may flip a near tie under random weights.
"""

import dataclasses
import os
from unittest import mock

import jax
import numpy as np
import pytest
import torch

import emg_tpu.cli as jax_cli
from emg_tpu.config import ModelConfig as JaxModelConfig
from emg_tpu.data.batching import PackedBatch as JaxPackedBatch
from emg_tpu.data.fixtures import make_synthetic_corpus
from emg_tpu.models.model import EMGModel as JaxEMGModel
from emg_tpu.train.checkpoint import CheckpointManager

from emg_tpu_torch import cli
from emg_tpu_torch.config import Config, ModelConfig
from emg_tpu_torch.data.dataset import EMGDataset, make_normalizers
from emg_tpu_torch.data.fixtures import FIXTURE_SENTENCES
from emg_tpu_torch.decode import ContinuousBeamServer, lm_train
from emg_tpu_torch.decode.kenlm_binary import write_kenlm_binary
from emg_tpu_torch.utils.convert import state_dict_from_flax
from tests.test_torch_model import GEOMETRY, one_torch_thread, perturbed  # noqa: F401


def make_setup(tmp_path_factory, n_sentences: int):
    root = tmp_path_factory.mktemp("corpus")
    paths = make_synthetic_corpus(str(root), n_sentences=n_sentences, seed=0)
    arpa = str(root / "lm.arpa")
    lm_train.write_arpa(lm_train.train_arpa(FIXTURE_SENTENCES, order=3), arpa)
    argv = ["--decode.compute_dtype", "float32", "--BeamWidth", "16",
            "--batch_utterances", "2", "--lang_model", arpa, "--data.dsp_backend", "device"]
    argv += [f"--model.{k}={v}" for k, v in GEOMETRY.items()]
    argv += ["--silent_data_directories", paths["silent_data_directories"],
             "--voiced_data_directories", paths["voiced_data_directories"],
             "--testset_file", paths["testset_file"], "--dict", paths["dict"],
             "--phonesSet", paths["phonesSet"], "--vocabulary", paths["vocabulary"],
             "--normalizers_file", str(root / "normalizers.pkl")]
    cfg = Config.from_args(argv)
    make_normalizers(cfg, max_samples=2, device="cpu")
    testset = EMGDataset(cfg, test=True, device="cpu")
    prepared = [cli.prepare_single(cfg, testset, i) for i in range(len(testset))]

    pb0, frames0, _ = prepared[0]
    jm = JaxEMGModel(JaxModelConfig(**GEOMETRY))
    variables = jm.init(
        {"params": jax.random.PRNGKey(0)}, pb0.packed_raw, pb0.n_rows, pb0.offsets,
        pb0.lengths, pb0.targets[:, :-1], frames0, False,
    )
    variables = perturbed(
        {"params": variables["params"], "batch_stats": variables["batch_stats"]},
        np.random.default_rng(17),
    )
    ckpt = str(root / "model.pt")
    torch.save(state_dict_from_flax(variables, 2, 2), ckpt)
    jax_ckpt = str(root / "jax_ckpt")
    CheckpointManager(jax_ckpt).save_params(variables["params"], variables["batch_stats"])
    return dict(root=root, argv=argv, ckpt=ckpt, jax_ckpt=jax_ckpt, prepared=prepared, arpa=arpa)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    out = make_setup(tmp_path_factory, 8)
    assert len(out["prepared"]) == 2
    return out


@pytest.fixture(scope="module")
def pooled(tmp_path_factory):
    """12 sentences: three test utterances in one geometry group, so that
    continuous lanes serve them (two lanes, one refill)."""
    out = make_setup(tmp_path_factory, 12)
    assert len(out["prepared"]) == 3
    return out


def predictions(log_path):
    with open(log_path) as f:
        lines = [line.rstrip("\n") for line in f]
    return [line for line in lines if line.startswith(("Prediction:", "Final WER:"))]


def run_jax_cli(setup, argv):
    """emg_tpu.cli.main on the port's test batches (see the module doc)."""
    prepared = setup["prepared"]

    def prepare_single(cfg, testset, i):
        pb, max_frames, raw = prepared[i]
        return JaxPackedBatch(**dataclasses.asdict(pb)), max_frames, raw

    with mock.patch("emg_tpu.data.dataset.EMGDataset", lambda cfg, test: prepared), \
            mock.patch.object(jax_cli, "_prepare_single", prepare_single):
        jax_cli.main(argv)


@pytest.fixture(scope="module")
def port_logs(setup):
    """The port's CLI through the device beam and through the host beam:
    {device_beam flag: (final WER, prediction lines)}."""
    out = {}
    for device_beam in ("true", "false"):
        directory = str(setup["root"] / f"port_{device_beam}")
        final = cli.main(setup["argv"] + [
            "--device_beam", device_beam, "--device", "cpu", "--output_directory", directory,
            "--evaluate_saved_beam_search", setup["ckpt"]])
        out[device_beam] = final, predictions(os.path.join(directory, "log_beam_search.txt"))
    return out


@pytest.mark.parametrize("device_beam", ["true", "false"], ids=["device_beam", "host_beam"])
def test_beam_cli_matches_jax(setup, port_logs, device_beam):
    out_jax = str(setup["root"] / f"jax_{device_beam}")
    run_jax_cli(setup, setup["argv"] + ["--device_beam", device_beam, "--output_directory",
                                        out_jax, "--evaluate_saved_beam_search",
                                        setup["jax_ckpt"]])
    final, got = port_logs[device_beam]
    want = predictions(os.path.join(out_jax, "log_beam_search.txt"))
    assert len(got) == 3 and got[-1] == f"Final WER: {final}"
    assert got == want
    assert 0.0 <= final < float("inf")


@pytest.mark.parametrize("option, corpus", [(["--continuous_lanes", "2"], "pooled"),
                                            (["--quantize_int8", "true"], "setup")],
                         ids=["continuous_lanes", "quantize_int8"])
def test_beam_cli_options_match_jax(request, tmp_path, option, corpus):
    setup = request.getfixturevalue(corpus)
    argv = setup["argv"] + ["--device_beam", "true"] + option
    with mock.patch.object(ContinuousBeamServer, "serve", autospec=True,
                           side_effect=ContinuousBeamServer.serve) as served:
        final = cli.main(argv + ["--device", "cpu", "--output_directory", str(tmp_path / "port"),
                                 "--evaluate_saved_beam_search", setup["ckpt"]])
    assert served.call_count == (option[0] == "--continuous_lanes")
    run_jax_cli(setup, argv + ["--output_directory", str(tmp_path / "jax"),
                               "--evaluate_saved_beam_search", setup["jax_ckpt"]])
    got = predictions(str(tmp_path / "port" / "log_beam_search.txt"))
    assert got == predictions(str(tmp_path / "jax" / "log_beam_search.txt"))
    assert got[-1] == f"Final WER: {final}"


def test_greedy_cli_int8_matches_jax(setup, tmp_path):
    """``--quantize_int8 true`` reaches greedy decoding too (the checkpoint's
    float32 decoder weights quantized at load, as the JAX CLI does)."""
    argv = setup["argv"] + ["--quantize_int8", "true"]
    per, acc = cli.main(argv + ["--device", "cpu", "--output_directory", str(tmp_path / "port"),
                                "--evaluate_saved_greedy_search", setup["ckpt"]])
    run_jax_cli(setup, argv + ["--output_directory", str(tmp_path / "jax"),
                               "--evaluate_saved_greedy_search", setup["jax_ckpt"]])

    def lines(directory):
        with open(os.path.join(directory, "log_greedy_search.txt")) as f:
            return [line.rstrip("\n") for line in f if line.startswith(("Prediction:", "PER:"))]
    got = lines(str(tmp_path / "port"))
    assert got == lines(str(tmp_path / "jax"))
    assert len(got) == 3 and got[-1] == f"PER: {per} and accuracy: {acc}"


def test_beam_cli_kenlm_binary_takes_host_beam(setup, port_logs, tmp_path):
    """A KenLM binary LM cannot fill the device tables: the CLI says so and
    decodes with the host beam, which gives what it gives from the ARPA."""
    binary = str(tmp_path / "lm.binary")
    write_kenlm_binary(setup["arpa"], binary)
    final = cli.main(setup["argv"] + [
        "--device", "cpu", "--evaluate_saved_beam_search", setup["ckpt"], "--device_beam",
        "true", "--output_directory", str(tmp_path), "--lang_model", binary])
    log_path = str(tmp_path / "log_beam_search.txt")
    with open(log_path) as f:
        assert "falling back to the host beam searcher" in f.read()
    assert (final, predictions(log_path)) == port_logs["false"]
