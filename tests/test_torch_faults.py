"""Options the port does not act on yet refuse, and ``--debug`` runs on the
CPU, as the JAX package's CLI does (``emg_tpu/cli.py``: ``--debug`` forces
the CPU platform).

- ``model.remat`` (the JAX package rematerializes encoder layers) builds
  and trains: the model takes a train step (tests/test_torch_remat.py
  holds the step to JAX's and to the step without remat).
- ``--debug`` hands ``device="cpu"`` to both CLI modes, whatever
  ``--device`` says.
- ``data.dsp_backend`` resolves as the JAX package's: each backend builds
  the dataset; "scipy" and, on the CPU, "auto" run the host scipy DSP and
  load JAX's host-DSP utterance bitwise; "device" runs the device DSP and
  matches it to the DSP bounds (tests/test_torch_dsp.py).
- The trainer builds on a device mesh as one of its ranks: 2x1, 1x2 and
  2x2 meshes of CPU ranks that ``parallel.distributed.launch`` starts (the
  JAX case ``mesh_4x2`` runs here as a 2x2 of four ranks), and two
  processes started apart that join through
  ``parallel.coordinator_address``; ``data_axis=0`` and a mesh larger than
  the cards present raise the mesh error, as JAX's assert; the
  single-device defaults build it with no mesh.
- The bfloat16 ResNet rounds as the JAX package's: each conv's output is
  rounded to bfloat16 before its bias is added (Flax's
  ``nn.Conv(dtype=bfloat16)``). With nonzero conv biases, in train mode,
  the port's conv stack at bfloat16 differs from JAX's in under 1% of its
  elements and by at most 2^-8 of its peak, bfloat16's unit roundoff (it
  is bitwise JAX's on this CPU; the bounds leave room for another conv
  algorithm); with the bias folded into the conv, as the port had it, 43%
  of them differed, by up to 1.03e-2 of the peak.
"""

from __future__ import annotations

import os

import pytest
import torch

from emg_tpu_torch import cli
from emg_tpu_torch.config import Config, ModelConfig
from emg_tpu_torch.data.dataset import EMGDataset
from emg_tpu_torch.data.fixtures import make_synthetic_corpus
from emg_tpu_torch.models.model import EMGModel
from emg_tpu_torch.parallel.distributed import launch, rank_device
from emg_tpu_torch.train.trainer import Trainer

SMALL = dict(model_size=16, feed_forward_layer_size=32, num_layers_encoder=1,
             num_layers_decoder=1, n_heads_encoder=2, n_heads_decoder=2, relative_distance=8)


@pytest.mark.parametrize("option, attribute", [
    (dict(remat=True), "remat"),
], ids=["remat"])
def test_unported_model_options_raise(option, attribute):
    """Each model option of the JAX package builds and trains (none
    raises)."""
    from emg_tpu_torch.config import TrainConfig
    from emg_tpu_torch.parallel.train_step import make_train_step
    from emg_tpu_torch.train.state import create_train_state
    from tests.test_torch_sharded_step import MAX_FRAMES, toy_batch

    model = EMGModel(ModelConfig(**SMALL, **option), device="cpu")
    assert getattr(model.transformerEncoder, attribute) is True
    cfg = TrainConfig(batch_size_grad=10 ** 6)
    metrics = make_train_step(cfg)(create_train_state(model, cfg), toy_batch(), MAX_FRAMES,
                                   torch.Generator())
    assert torch.isfinite(metrics["loss"])


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
def test_each_dsp_backend_builds_and_matches_jax(tmp_path, backend):
    import numpy as np

    from emg_tpu.config import Config as JaxConfig
    from emg_tpu.data.dataset import EMGDataset as JaxEMGDataset
    from tests.test_torch_dsp import FEATURE_BOUND, SIGNAL_BOUND, assert_close_at_scale

    paths = make_synthetic_corpus(str(tmp_path), n_sentences=2, seed=0)

    def config(cls, backend):
        cfg = cls()
        cfg.data.silent_data_directories = [paths["silent_data_directories"]]
        cfg.data.voiced_data_directories = paths["voiced_data_directories"].split(",")
        cfg.data.testset_file = paths["testset_file"]
        cfg.paths.dict = paths["dict"]
        cfg.data.dsp_backend = backend
        return cfg

    dataset = EMGDataset(config(Config, backend), test=True, no_normalizers=True, device="cpu")
    assert len(dataset) > 0
    assert dataset._use_host_dsp() == (backend != "device")
    ref = JaxEMGDataset(config(JaxConfig, "scipy"), test=True, no_normalizers=True)
    for (d, i), (jd, ji) in zip(dataset.example_indices, ref.example_indices):
        got, want = dataset.load_utterance(d, i), ref.load_utterance(jd, ji)
        assert got[2:5] == want[2:5]  # text, book location, phonemes
        np.testing.assert_array_equal(got[0], want[0])  # the audio features
        for g, w, bound in ((got[1], want[1], FEATURE_BOUND), (got[5], want[5], SIGNAL_BOUND),
                            (got[6], want[6], SIGNAL_BOUND)):
            assert g.dtype == w.dtype == np.float32 and g.shape == w.shape
            if backend == "device":
                assert_close_at_scale(g, w, bound)
            else:
                np.testing.assert_array_equal(g, w)


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


def test_bf16_conv_stack_rounds_as_jax():
    """The conv stack at bfloat16 in train mode (batch statistics) against
    JAX's, from the same weights with nonzero conv biases."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from emg_tpu.models import EMGModel as JaxEMGModel
    from tests.test_train_step import tiny_model, toy_batch
    from emg_tpu_torch.utils.convert import state_dict_from_flax

    jcfg = tiny_model().cfg
    jax_model = JaxEMGModel(type(jcfg)(**{**jcfg.__dict__, "compute_dtype": "bfloat16"}))
    b = toy_batch(n_rows=4, chunk=256, seed=2)
    variables = jax_model.init({"params": jax.random.PRNGKey(0)}, b.packed_raw, b.n_rows,
                               b.offsets, b.lengths, b.targets[:, :-1], 64, False)
    rng = np.random.default_rng(0)
    variables = jax.tree_util.tree_map_with_path(
        lambda path, x: x + 0.3 * rng.normal(size=x.shape).astype(np.float32)
        if "bias" in jax.tree_util.keystr(path) and "conv" in jax.tree_util.keystr(path) else x,
        variables)
    x = 3.0 * np.asarray(b.packed_raw)
    n_rows = 3
    want, _ = jax_model.apply(
        variables, x, n_rows, mutable=["batch_stats"],
        method=lambda m, x, n: m.conv_blocks(x, n, use_running_average=False))
    want = np.asarray(want.astype(jnp.float32))

    model = EMGModel(ModelConfig(**SMALL, compute_dtype="bfloat16"), device="cpu")
    model.load_state_dict(state_dict_from_flax(variables, 1, 1))
    model.train()
    with torch.no_grad():
        got = model.conv_blocks(torch.tensor(x), n_rows, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    peak = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= 2.0 ** -8 * peak
    assert float(np.mean(got != want)) < 0.01
