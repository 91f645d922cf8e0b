"""Options the port does not act on yet refuse, and ``--debug`` runs on the
CPU, as the JAX package's CLI does (``emg_tpu/cli.py``: ``--debug`` forces
the CPU platform).

- ``model.remat`` (the JAX package rematerializes encoder layers) raises
  ``NotImplementedError`` when the model is built, rather than being
  accepted and ignored.
- ``--debug`` hands ``device="cpu"`` to both CLI modes, whatever
  ``--device`` says.
- ``data.dsp_backend="scipy"`` (the JAX package's host scipy DSP) raises
  ``NotImplementedError`` when the dataset is built; "auto" and "device"
  build it, on the port's device DSP.
- The trainer refuses a device mesh wider than one device
  (``parallel.data_axis`` not -1 or 1, ``parallel.model_axis`` not 1) and
  ``parallel.coordinator_address`` (multi-process training) with
  ``NotImplementedError``; the single-device defaults build it.
"""

from __future__ import annotations

import os

import pytest

from emg_tpu_torch import cli
from emg_tpu_torch.config import Config, ModelConfig
from emg_tpu_torch.data.dataset import EMGDataset
from emg_tpu_torch.data.fixtures import make_synthetic_corpus
from emg_tpu_torch.models.model import EMGModel
from emg_tpu_torch.train.trainer import Trainer

SMALL = dict(model_size=16, feed_forward_layer_size=32, num_layers_encoder=1,
             num_layers_decoder=1, n_heads_encoder=2, n_heads_decoder=2, relative_distance=8)


@pytest.mark.parametrize("option, pattern", [
    (dict(remat=True), "remat"),
], ids=["remat"])
def test_unported_model_options_raise(option, pattern):
    with pytest.raises(NotImplementedError, match=pattern):
        EMGModel(ModelConfig(**SMALL, **option), device="cpu")


@pytest.mark.parametrize("mode, extra", [
    ("train", []),
    ("evaluate_saved_greedy_search", ["--evaluate_saved_greedy_search", "model.pt"]),
])
@pytest.mark.parametrize("flags, expected", [
    (["--debug"], "cpu"),
    (["--debug", "--device", "cuda"], "cpu"),
    (["--device", "cpu"], "cpu"),
    ([], "cuda"),
], ids=["debug", "debug_over_device", "device_cpu", "default"])
def test_debug_runs_on_the_cpu(tmp_path, monkeypatch, mode, extra, flags, expected):
    seen = []
    monkeypatch.setattr(cli, mode, lambda cfg, device="cuda": seen.append((cfg, device)))
    cli.main(["--output_directory", str(tmp_path)] + extra + flags)
    assert [device for _, device in seen] == [expected]
    assert seen[0][0].paths.debug == ("--debug" in flags)


@pytest.mark.parametrize("backend", ["scipy", "auto", "device"])
def test_only_the_scipy_dsp_backend_raises(tmp_path, backend):
    paths = make_synthetic_corpus(str(tmp_path), n_sentences=2, seed=0)
    cfg = Config()
    cfg.data.silent_data_directories = [paths["silent_data_directories"]]
    cfg.data.voiced_data_directories = paths["voiced_data_directories"].split(",")
    cfg.data.testset_file = paths["testset_file"]
    cfg.paths.dict = paths["dict"]
    cfg.data.dsp_backend = backend
    if backend == "scipy":
        with pytest.raises(NotImplementedError, match="dsp_backend"):
            EMGDataset(cfg, test=True, no_normalizers=True, device="cpu")
    else:
        assert len(EMGDataset(cfg, test=True, no_normalizers=True, device="cpu")) > 0


@pytest.mark.parametrize("parallel, pattern", [
    (dict(data_axis=2), "mesh"),
    (dict(data_axis=0), "mesh"),
    (dict(model_axis=2), "mesh"),
    (dict(data_axis=4, model_axis=2), "mesh"),
    (dict(coordinator_address="localhost:12345", num_processes=2, process_id=0),
     "coordinator_address"),
    (dict(), None),
    (dict(data_axis=1), None),
], ids=["data_axis_2", "data_axis_0", "model_axis_2", "mesh_4x2", "coordinator", "defaults",
        "data_axis_1"])
def test_unported_parallel_options_raise(tmp_path, parallel, pattern):
    cfg = Config()
    cfg.paths.output_directory = str(tmp_path / "out")
    for key, value in parallel.items():
        setattr(cfg.parallel, key, value)
    if pattern is None:
        trainer = Trainer(cfg, None, None, None, device="cpu")
        assert trainer.device.type == "cpu" and os.path.isdir(cfg.paths.output_directory)
    else:
        with pytest.raises(NotImplementedError, match=pattern):
            Trainer(cfg, None, None, None, device="cpu")
