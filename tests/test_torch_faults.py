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
- The trainer builds on a device mesh as one of its ranks: 2x1, 1x2 and
  2x2 meshes of CPU ranks that ``parallel.distributed.launch`` starts (the
  JAX case ``mesh_4x2`` runs here as a 2x2 of four ranks), and two
  processes started apart that join through
  ``parallel.coordinator_address``; ``data_axis=0`` and a mesh larger than
  the cards present raise the mesh error, as JAX's assert; the
  single-device defaults build it with no mesh.
"""

from __future__ import annotations

import os

import pytest

from emg_tpu_torch import cli
from emg_tpu_torch.config import Config, ModelConfig
from emg_tpu_torch.data.dataset import EMGDataset
from emg_tpu_torch.data.fixtures import make_synthetic_corpus
from emg_tpu_torch.models.model import EMGModel
from emg_tpu_torch.parallel.distributed import launch, rank_device
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


def _config(out, parallel):
    cfg = Config()
    cfg.paths.output_directory = out
    for key, value in parallel.items():
        setattr(cfg.parallel, key, value)
    return cfg


def _build_trainer_rank(out, parallel, shape):
    """A mesh rank: the trainer builds, on the mesh of ``shape``."""
    import torch

    trainer = Trainer(_config(out, parallel), None, None, None, device=rank_device("cpu"))
    assert trainer.device.type == "cpu" and os.path.isdir(out)
    got = None if trainer.mesh is None else (trainer.mesh.data, trainer.mesh.model)
    assert got == shape, (got, shape)
    assert torch.distributed.get_world_size() == shape[0] * shape[1]


def _coordinated_rank(index, port, out):
    """A process started apart, joining rank ``index`` of two through
    parallel.coordinator_address."""
    import torch.distributed as dist

    from emg_tpu_torch.parallel.distributed import join_runtime

    parallel = dict(data_axis=2, coordinator_address=f"127.0.0.1:{port}", num_processes=2,
                    process_id=index)
    assert join_runtime(_config(out, parallel).parallel, "cpu")
    try:
        _build_trainer_rank(out, parallel, (2, 1))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("parallel, shape", [
    (dict(data_axis=2), (2, 1)),
    (dict(data_axis=0), "mesh 0x1 does not cover"),
    (dict(model_axis=2), (1, 2)),
    (dict(data_axis=2, model_axis=2), (2, 2)),
    (dict(coordinator_address="127.0.0.1", num_processes=2), (2, 1)),
    (dict(), None),
    (dict(data_axis=1), None),
    (dict(data_axis=2, device="cuda"), "mesh 2x1 does not cover 1 devices"),
], ids=["data_axis_2", "data_axis_0", "model_axis_2", "mesh_4x2", "coordinator", "defaults",
        "data_axis_1", "more_than_the_cards"])
def test_unported_parallel_options_raise(tmp_path, monkeypatch, parallel, shape):
    out = str(tmp_path / "out")
    parallel = dict(parallel)
    device = parallel.pop("device", "cpu")
    if device == "cuda":  # one card present: a 2-device mesh is larger
        import torch

        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    if isinstance(shape, str):
        with pytest.raises(ValueError, match=shape):
            Trainer(_config(out, parallel), None, None, None, device=device)
    elif shape is None:
        trainer = Trainer(_config(out, parallel), None, None, None, device=device)
        assert trainer.device.type == "cpu" and trainer.mesh is None
        assert os.path.isdir(out)
    elif "coordinator_address" in parallel:
        import torch.multiprocessing as mp

        from emg_tpu_torch.parallel.distributed import _free_port

        mp.spawn(_coordinated_rank, args=(_free_port(), out), nprocs=2, join=True)
    else:
        launch(_build_trainer_rank, (out, parallel, shape), shape[0] * shape[1], "cpu")
