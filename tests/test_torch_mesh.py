"""The port's mesh and multi-process runtime against the JAX package's.

- ``make_mesh`` / ``mesh_from_config`` give JAX's mesh shape, ``None`` or
  raise, for the same flags over the same device count (the conftest's 8
  virtual devices).
- ``param_pspec`` is JAX's rule, parameter by parameter: each JAX
  parameter's spec, carried through ``utils/convert.py``'s name and layout
  map (a Dense kernel (in, out) is torch's (out, in) weight; the relative
  table gains a trailing dim), is the port's spec of that tensor.
- ``process_local_rows`` and ``initialize_distributed``'s arguments to
  ``init_process_group`` (monkeypatched), mirroring
  tests/test_distributed.py.
- On a 2x2 mesh of CPU ranks (gloo): the process groups, and each
  autograd collective's forward and backward against the same function of
  the whole tensors on one process.

The CLI on a mesh is tests/test_torch_mesh_cli.py.
"""

import os

import numpy as np
import pytest
import torch

from emg_tpu_torch.config import Config
from emg_tpu_torch.parallel import distributed
from emg_tpu_torch.parallel.distributed import initialize_distributed, launch, process_local_rows
from emg_tpu_torch.parallel.mesh import Mesh, MeshShape, make_mesh, mesh_from_config, param_pspec

MESH_FLAGS = [(-1, 1), (8, 1), (4, 2), (2, 4), (-1, 2), (-1, 4), (1, 8), (2, 1), (0, 1),
              (3, 1), (1, 1), (-1, 3)]


@pytest.mark.parametrize("data_axis, model_axis", MESH_FLAGS)
def test_mesh_matches_jax(data_axis, model_axis):
    import jax

    from emg_tpu.config import ParallelConfig as JaxParallelConfig
    from emg_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from emg_tpu.parallel.mesh import mesh_from_config as jax_mesh_from_config

    from emg_tpu_torch.config import ParallelConfig

    devices = jax.devices()[:8]
    assert len(devices) == 8
    try:
        want = dict(jax_make_mesh(data_axis, model_axis, devices).shape)
    except AssertionError:
        want = None
    if want is None:
        with pytest.raises(ValueError, match="does not cover 8 devices"):
            make_mesh(data_axis, model_axis, 8)
    else:
        assert make_mesh(data_axis, model_axis, 8).shape == want
    jcfg = JaxParallelConfig(data_axis=data_axis, model_axis=model_axis)
    pcfg = ParallelConfig(data_axis=data_axis, model_axis=model_axis)
    try:
        jm = jax_mesh_from_config(jcfg, devices)
        want = None if jm is None else dict(jm.shape)
    except AssertionError:
        with pytest.raises(ValueError, match="does not cover"):
            mesh_from_config(pcfg, 8)
        return
    got = mesh_from_config(pcfg, 8)
    assert (None if got is None else got.shape) == want
    # one device: None wherever JAX's mesh is one device
    one = ParallelConfig(data_axis=1, model_axis=1)
    assert mesh_from_config(one, 1) is None
    assert jax_mesh_from_config(JaxParallelConfig(data_axis=1, model_axis=1), devices[:1]) is None


def _spec_by_torch_name(jax_params):
    """Each port parameter name -> its JAX leaf's PartitionSpec carried to
    the torch layout (through convert's map: every JAX leaf filled with its
    own index identifies where it lands)."""
    import jax

    from emg_tpu.parallel.mesh import param_pspec as jax_param_pspec
    from emg_tpu_torch.utils.convert import state_dict_from_flax

    leaves = jax.tree_util.tree_leaves_with_path(jax_params)
    specs = [tuple(jax_param_pspec(tuple(k.key for k in path), leaf)) for path, leaf in leaves]
    shapes = [tuple(leaf.shape) for _, leaf in leaves]
    marked = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(jax_params),
        [np.full(leaf.shape, i + 1, np.float32) for i, (_, leaf) in enumerate(leaves)])
    stats = jax.tree.map(lambda x: np.zeros(x.shape, np.float32), jax_params["conv_blocks"])
    stats = {"conv_blocks": {b: {n: {"mean": 0, "var": 0} for n in v} for b, v in stats.items()}}
    n_enc = len(jax_params["transformerEncoder"])
    n_dec = len(jax_params["transformerDecoder"])
    out = {}
    for name, t in state_dict_from_flax({"params": marked, "batch_stats": stats}, n_enc,
                                        n_dec).items():
        if name.endswith(("running_mean", "running_var", "num_batches_tracked")):
            continue
        i = int(t.reshape(-1)[0]) - 1
        spec = specs[i] + (None,) * (len(shapes[i]) - len(specs[i]))
        if tuple(t.shape) == shapes[i][::-1] and tuple(t.shape) != shapes[i]:
            spec = spec[::-1]
        out[name] = spec + (None,) * (t.dim() - len(spec))
    return out


@pytest.mark.parametrize("encoder_kind", ["transformer", "conformer"])
def test_param_pspec_matches_jax(encoder_kind):
    import jax

    from emg_tpu.config import ModelConfig as JaxModelConfig
    from emg_tpu.models import EMGModel as JaxModel

    cfg = JaxModelConfig(model_size=16, feed_forward_layer_size=32, num_layers_encoder=2,
                         num_layers_decoder=1, n_heads_encoder=4, n_heads_decoder=2,
                         relative_distance=8, encoder_kind=encoder_kind,
                         conformer_conv_kernel_size=3)
    x = np.zeros((2, 64, 8), np.float32)
    variables = jax.eval_shape(  # the parameters' shapes: nothing is computed
        lambda: JaxModel(cfg).init({"params": jax.random.PRNGKey(0)}, x, 2, np.array([0, 8]),
                                   np.array([8, 8]), np.full((2, 4), 42), 64, False))
    want = _spec_by_torch_name(variables["params"])
    assert sum("model" in s for s in want.values()) >= 4
    for name, spec in want.items():
        got = param_pspec(name)
        assert got + (None,) * (len(spec) - len(got)) == spec, name


def _mesh_stub(data, model, data_index):
    mesh = object.__new__(Mesh)
    mesh.shape, mesh.data_index, mesh.model_index = MeshShape(data, model), data_index, 0
    return mesh


def test_process_local_rows():
    assert process_local_rows(8) == slice(0, 8)
    assert process_local_rows(8, _mesh_stub(4, 2, 1)) == slice(2, 4)
    with pytest.raises(ValueError, match="divide"):
        process_local_rows(6, _mesh_stub(4, 2, 1))


def test_initialize_distributed_contract(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda **kwargs: calls.append(kwargs))
    cfg = Config()
    assert cfg.parallel.coordinator_address == ""
    assert initialize_distributed(cfg.parallel) is False and calls == []
    cfg.parallel.coordinator_address = "10.0.0.1:8476"
    cfg.parallel.num_processes = 4
    cfg.parallel.process_id = 2
    assert initialize_distributed(cfg.parallel, "cuda") is True
    assert calls.pop() == {"backend": "nccl", "init_method": "tcp://10.0.0.1:8476",
                           "world_size": 4, "rank": 2}
    # -1: the world size and rank torchrun puts in the environment
    cfg.parallel.num_processes = cfg.parallel.process_id = -1
    monkeypatch.setenv("WORLD_SIZE", "8")
    monkeypatch.setenv("RANK", "5")
    assert initialize_distributed(cfg.parallel, "cpu") is True
    assert calls.pop() == {"backend": "gloo", "init_method": "tcp://10.0.0.1:8476",
                           "world_size": 8, "rank": 5}
    monkeypatch.delenv("RANK")
    with pytest.raises(ValueError, match="RANK"):
        initialize_distributed(cfg.parallel, "cpu")


def _check_collectives(out_dir):
    """A 2x2 mesh rank: its groups and each collective against the whole
    tensors' function on one process (every rank derives every rank's
    block from one seed)."""
    torch.set_num_threads(1)
    mesh = Mesh(MeshShape(2, 2), "cpu")
    r, d, m = mesh.rank, mesh.data_index, mesh.model_index
    assert (d, m) == divmod(r, 2) and distributed.is_primary() == (r == 0)
    g = torch.Generator().manual_seed(0)
    whole = torch.randn(4, 6, 3, generator=g)  # rank i's block: whole[i]
    weight = torch.randn(2, 12, 3, generator=g)  # d(loss)/d(output) of each model rank
    checks = {}

    def run(fn, x, w):
        x = x.clone().requires_grad_(True)
        y = fn(x)
        (y * w).sum().backward()
        return y.detach(), x.grad

    # the model group of this data index holds ranks 2d, 2d + 1
    mine = whole[r]
    peers = whole[2 * d: 2 * d + 2]
    w_full = weight[m]
    y, gx = run(lambda x: mesh.gather_seq(x, dim=0), mine, w_full)  # (12, 3)
    checks["gather_seq"] = (torch.equal(y, torch.cat(list(peers))),
                            torch.allclose(gx, weight[:, 6 * m: 6 * m + 6].sum(0)))
    y, gx = run(lambda x: mesh.gather_seq_replicated(x, dim=0), mine, w_full)
    checks["gather_seq_replicated"] = (torch.equal(y, torch.cat(list(peers))),
                                       torch.equal(gx, w_full[6 * m: 6 * m + 6]))
    y, gx = run(lambda x: mesh.scatter_seq(x, dim=0), mine, w_full[:3])
    checks["scatter_seq"] = (torch.allclose(y, peers.sum(0)[3 * m: 3 * m + 3]),
                             torch.equal(gx, torch.cat([weight[0, :3], weight[1, :3]])))
    y, gx = run(lambda x: mesh.split_seq(x, dim=0), mine, w_full[:3])
    checks["split_seq"] = (torch.equal(y, mine[3 * m: 3 * m + 3]),
                           torch.equal(gx, torch.cat([weight[0, :3], weight[1, :3]])))
    y, gx = run(mesh.copy_to_model, mine, w_full[:6])
    checks["copy_to_model"] = (torch.equal(y, mine),
                               torch.allclose(gx, weight[0, :6] + weight[1, :6]))
    y, gx = run(mesh.reduce_from_model, mine, w_full[:6])
    checks["reduce_from_model"] = (torch.allclose(y, peers.sum(0)), torch.equal(gx, w_full[:6]))
    # the data group of this model index holds ranks m, m + 2
    col = whole[[m, m + 2]]
    y, gx = run(mesh.gather_data, mine, weight[d])  # (12, 3): each data rank's own weight
    checks["gather_data"] = (torch.equal(y, torch.cat(list(col))),
                             torch.allclose(gx, weight[:, 6 * d: 6 * d + 6].sum(0)))
    y, gx = run(mesh.sum_over_data, mine, weight[d, :6])
    checks["sum_over_data"] = (torch.allclose(y, col.sum(0)),
                               torch.allclose(gx, weight[0, :6] + weight[1, :6]))
    torch.save(checks, os.path.join(out_dir, f"{r}.pt"))


def test_collectives_on_a_2x2_mesh(tmp_path):
    launch(_check_collectives, (str(tmp_path),), 4, "cpu")
    for r in range(4):
        checks = torch.load(tmp_path / f"{r}.pt")
        assert checks and all(all(v) for v in checks.values()), (r, checks)
