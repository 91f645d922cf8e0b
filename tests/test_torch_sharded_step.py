"""The port's sharded train step against the JAX package's step.

Every geometry runs as its ranks: CPU processes over gloo, started by
``parallel.distributed.launch``, on a batch of five utterances (packed
rows and utterances padded to multiples of the data axis, so utterances
cross the ranks' row blocks and one data rank holds a single real
utterance). The tiny model of tests/test_sharded_e2e.py: d=16, 1+1
layers, 2 heads, FF 32.

- Dropout 0, weights converted from JAX's: one microbatch and one AdamW
  apply on the 2x1, 1x2, 2x2 meshes and on 1x2 and 2x2 with
  sequence_shard, against the JAX single-device step from the same
  weights, batch and time shift: the loss to rtol 1e-5; every parameter
  after the apply, gathered whole, to 1e-5 of its largest magnitude (the
  BatchNorm-fed conv biases, whose true gradient is 0, to Adam's step
  bound, as tests/test_torch_train_step.py); the BatchNorm running
  statistics bitwise equal on every rank, and to JAX's as the parameters.
  The 2x2 loss also against JAX's own 2x2 mesh step (the conftest's
  virtual devices).
- Dropout 0.2 (the attention dropout through K3's plain version at the
  ranks' batch and head offsets; every other dropout drawn at the global
  shape and sliced): each sharded step against the port's single-rank step
  from the same seed, loss to rtol 1e-5 and the gradient sums to 1e-5 of
  each tensor's largest (the BN-fed conv biases to 1e-6 of the largest
  gradient).
- K4's and K5's plain versions at nonzero offsets give the corresponding
  blocks of the whole batch's, bitwise.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from emg_tpu_torch.config import ModelConfig, TrainConfig
from emg_tpu_torch.data.batching import make_packed_batch
from emg_tpu_torch.models.model import EMGModel
from emg_tpu_torch.parallel.distributed import launch
from emg_tpu_torch.parallel.mesh import Mesh, MeshShape, full_state_dict, gather_full, shard_params
from emg_tpu_torch.parallel.train_step import make_train_step
from emg_tpu_torch.train.state import create_train_state

MAX_FRAMES = 64
TINY = dict(model_size=16, feed_forward_layer_size=32, num_layers_encoder=1,
            num_layers_decoder=1, n_heads_encoder=2, n_heads_decoder=2, relative_distance=8)
LR = 1e-3
GEOMETRIES = {"2x1": (2, 1, False), "1x2": (1, 2, False), "2x2": (2, 2, False),
              "1x2_seq": (1, 2, True), "2x2_seq": (2, 2, True)}
DROPOUT = 0.2


def toy_batch():
    """Five utterances of 7-20 frames in 64-sample packed rows: 8 rows and 8
    utterances after bucketing (multiples of 2), so rank blocks split
    utterances across rows and data rank 1 holds one real utterance."""
    rng = np.random.default_rng(3)
    lengths = [13, 9, 20, 7, 11]
    raw = [rng.normal(size=(8 * n, 8)).astype(np.float32) for n in lengths]
    phonemes = [np.array([41] + list(rng.integers(0, 40, int(rng.integers(3, 7)))) + [40],
                         np.int64) for _ in lengths]
    return make_packed_batch(raw, lengths, phonemes, chunk=64, row_multiple=2, batch_multiple=2)


def _no_step_apply():
    return TrainConfig(batch_size_grad=10 ** 6)


def _rank_steps(runs, r, out_dir):
    """One rank: for each (name, geometry, model kwargs, weights or None,
    train config) run one step on the mesh and save what the test reads."""
    import emg_tpu_torch.models.model as model_module

    torch.set_num_threads(1)
    if r is not None:
        model_module.draw_shift = lambda generator, device: torch.tensor([r], device=device)
    batch = toy_batch()
    for name, (data, model_axis, seq), kwargs, weights, tcfg in runs:
        mesh = Mesh(MeshShape(data, model_axis), "cpu")
        model = EMGModel(ModelConfig(**kwargs), device="cpu")
        if weights is not None:
            model.load_state_dict(weights)
        shard_params(model, mesh, sequence_shard=seq)
        state = create_train_state(model, tcfg)
        metrics = make_train_step(tcfg)(state, batch, MAX_FRAMES, torch.Generator())
        grads = {n: gather_full(n, p.grad, mesh) for n, p in model.named_parameters()}
        result = {"loss": float(metrics["loss"]), "applied": metrics["applied"],
                  "weights": full_state_dict(model, mesh), "grads": grads,
                  "buffers": {n: b.clone() for n, b in model.named_buffers()
                              if n.endswith(("running_mean", "running_var"))}}
        torch.save(result, os.path.join(out_dir, f"{name}.{mesh.rank}.pt"))


def _jax_reference():
    """The JAX tiny model's initial weights, its single-device step from
    them (loss, parameters and statistics after one apply), the time shift
    that step drew and its 2x2 mesh step's loss."""
    import jax

    import emg_tpu.models.model as jax_model_module
    from emg_tpu.config import TrainConfig as JaxTrainConfig
    from emg_tpu.data.batching import PackedBatch as JaxPackedBatch
    from emg_tpu.parallel import make_train_step as jax_make_train_step
    from emg_tpu.parallel.mesh import make_mesh, replicated
    from emg_tpu.parallel.mesh import shard_batch as jax_shard_batch
    from emg_tpu.parallel.mesh import shard_params as jax_shard_params
    from emg_tpu.train.state import create_train_state as jax_create_state
    from emg_tpu_torch.utils.convert import state_dict_from_flax
    from tests.test_train_step import tiny_model

    model = tiny_model()
    pb = toy_batch()
    jb = JaxPackedBatch(**{f.name: getattr(pb, f.name) for f in dataclasses.fields(pb)})
    variables = model.init({"params": jax.random.PRNGKey(0)}, jb.packed_raw, jb.n_rows,
                           jb.offsets, jb.lengths, jb.targets[:, :-1], MAX_FRAMES, False)
    weights = state_dict_from_flax(variables, 1, 1)
    # host copies: the step donates the state it is given
    params, stats = (jax.tree.map(np.array, variables[k]) for k in ("params", "batch_stats"))
    jcfg = JaxTrainConfig(batch_size_grad=4, learning_rate=LR, learning_rate_warmup=10)
    step = jax_make_train_step(model, jcfg, MAX_FRAMES)
    rng = jax.random.PRNGKey(0)

    drawn = []
    real = jax_model_module._shift_rows

    def spy(x, r):
        jax.debug.callback(lambda r: drawn.append(int(r)), r)
        return real(x, r)

    jax_model_module._shift_rows = spy
    try:
        state, m = step(jax_create_state(variables["params"], variables["batch_stats"], jcfg),
                        jb, rng)
        jax.effects_barrier()
    finally:
        jax_model_module._shift_rows = real
    mesh = make_mesh(2, 2, jax.devices()[:4])
    after = state_dict_from_flax({"params": state.params, "batch_stats": state.batch_stats}, 1, 1)
    sharded = jax_create_state(jax_shard_params(params, mesh),
                               jax.device_put(stats, replicated(mesh)), jcfg)
    _, m_mesh = step(sharded, jax_shard_batch(jb, mesh), rng)
    return dict(weights=weights, r=drawn[0] if drawn else 0,
                loss=float(m["loss"]), applied=bool(m["applied"]), after=after,
                mesh_loss=float(m_mesh["loss"]), lr=float(m["lr"]))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every geometry's rank results: two launches (two ranks, four ranks),
    each running its geometries at dropout 0 on JAX's weights, then at
    dropout 0.2 on the port's seeded weights; the single-rank port step at
    dropout 0.2 for those."""
    out = str(tmp_path_factory.mktemp("sharded_step"))
    ref = _jax_reference()
    jax_tcfg = TrainConfig(batch_size_grad=4, learning_rate=LR, learning_rate_warmup=10)
    dropout = dict(TINY, dropout_model=DROPOUT, dropout_pos_emb=DROPOUT)
    tiny = dict(TINY, dropout_model=0.0, dropout_pos_emb=0.0)
    for world in (2, 4):
        geoms = {n: g for n, g in GEOMETRIES.items() if g[0] * g[1] == world}
        plan = ([(n, g, tiny, ref["weights"], jax_tcfg) for n, g in geoms.items()]
                + [(f"{n}_dropout", g, dropout, None, _no_step_apply()) for n, g in geoms.items()])
        launch(_rank_steps, (plan, ref["r"], out), world, "cpu")
    import emg_tpu_torch.models.model as model_module

    real = model_module.draw_shift
    model_module.draw_shift = lambda generator, device: torch.tensor([ref["r"]], device=device)
    try:
        single = EMGModel(ModelConfig(**dropout), device="cpu")
        state = create_train_state(single, _no_step_apply())
        metrics = make_train_step(_no_step_apply())(state, toy_batch(), MAX_FRAMES,
                                                    torch.Generator())
    finally:
        model_module.draw_shift = real
    ref["dropout"] = {"loss": float(metrics["loss"]),
                      "grads": {n: p.grad.detach().clone() for n, p in single.named_parameters()}}

    def load(name):
        data, model_axis, _ = GEOMETRIES[name.split("_dropout")[0]]
        return [torch.load(os.path.join(out, f"{name}.{i}.pt")) for i in range(data * model_axis)]

    return ref, load


def _bn_fed_bias(name: str) -> bool:
    return name.startswith("conv_blocks") and name.endswith(("conv1.bias", "conv2.bias",
                                                              "residual_path.bias"))


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_sharded_step_matches_jax(runs, geometry):
    ref, load = runs
    ranks = load(geometry)
    assert ref["applied"] and all(r["applied"] for r in ranks)
    for r in ranks:
        np.testing.assert_allclose(r["loss"], ref["loss"], rtol=1e-5)
    got, want = ranks[0]["weights"], ref["after"]
    bias_tol = 2 * ref["lr"]
    for name, w in want.items():
        if name.endswith("num_batches_tracked"):
            continue
        g, w = got[name].numpy(), w.numpy()
        if _bn_fed_bias(name):
            np.testing.assert_allclose(g, w, rtol=0, atol=bias_tol, err_msg=name)
            continue
        atol = max(1e-5 * float(np.abs(w).max()), 1e-6)
        if name.endswith("running_mean"):
            atol += 0.1 * bias_tol
        np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=name)
    # every rank holds the same (gathered) weights and BatchNorm statistics
    for r in ranks[1:]:
        for name, b in ranks[0]["buffers"].items():
            assert torch.equal(r["buffers"][name], b), name
        for name, w in ranks[0]["weights"].items():
            assert torch.equal(r["weights"][name], w), name


def test_2x2_loss_matches_jax_mesh_step(runs):
    ref, load = runs
    np.testing.assert_allclose(ref["mesh_loss"], ref["loss"], rtol=1e-5)
    np.testing.assert_allclose(load("2x2")[0]["loss"], ref["mesh_loss"], rtol=1e-5)


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_sharded_dropout_matches_single_rank(runs, geometry):
    ref, load = runs
    want = ref["dropout"]
    ranks = load(f"{geometry}_dropout")
    largest = max(float(g.abs().max()) for g in want["grads"].values())
    for r in ranks:
        np.testing.assert_allclose(r["loss"], want["loss"], rtol=1e-5)
        for name, w in want["grads"].items():
            atol = 1e-6 * largest if _bn_fed_bias(name) else 1e-5 * float(w.abs().max())
            np.testing.assert_allclose(r["grads"][name].numpy(), w.numpy(), rtol=0,
                                       atol=max(atol, 1e-7), err_msg=name)


def test_backward_plain_versions_take_offsets():
    """K4's and K5's plain versions on a rank's block (batch 1, heads 2-3)
    at its offsets equal that block of the whole batch's, bitwise; so does
    K3's."""
    from emg_tpu_torch.ops import flash_attention as fa

    g = torch.Generator().manual_seed(0)
    B, H, T, Dh = 2, 4, 64, 64
    q, k, v, dout = (torch.randn(B, H, T, Dh, generator=g) for _ in range(4))
    used = torch.randn(H, 2 * T - 1, Dh, generator=g) * 0.1
    oob = torch.zeros(2 * T - 1)
    kp = torch.zeros(B, T, dtype=torch.bool)
    kp[1, 50:] = True
    seed = torch.tensor([1234], dtype=torch.int32)
    rate = 0.3
    o, lse = fa.flash_train_fwd_plain(q, k, v, used, oob, kp, rate, seed)
    delta = (dout * o).sum(-1)
    full_dq = fa.flash_train_bwd_dq_plain(q, k, v, used, oob, kp, dout, lse, delta, rate, seed)
    full_dkv = fa.flash_train_bwd_dkv_plain(q, k, v, used, oob, kp, dout, lse, delta, rate, seed)
    b, h = slice(1, 2), slice(2, 4)
    part = [t[b, h] for t in (q, k, v)]
    o_p, lse_p = fa.flash_train_fwd_plain(*part, used[h], oob, kp[b], rate, seed, 1, 2)
    assert torch.equal(o_p, o[b, h]) and torch.equal(lse_p, lse[b, h])
    args = (*part, used[h], oob, kp[b], dout[b, h], lse[b, h], delta[b, h], rate, seed, 1, 2)
    dq, dused = fa.flash_train_bwd_dq_plain(*args)
    dk, dv = fa.flash_train_bwd_dkv_plain(*args)
    assert torch.equal(dq, full_dq[0][b, h])
    assert torch.equal(dk, full_dkv[0][b, h]) and torch.equal(dv, full_dkv[1][b, h])
    # d_used sums over the batch: the block's share at its heads
    _, dused_b0 = fa.flash_train_bwd_dq_plain(*(t[:1, h] for t in (q, k, v)), used[h], oob,
                                              kp[:1], dout[:1, h], lse[:1, h], delta[:1, h],
                                              rate, seed, 0, 2)
    torch.testing.assert_close(dused + dused_b0, full_dq[1][h], rtol=1e-5, atol=1e-5)
    # at offsets 0 the mask is the unsharded one: a different block draws differently
    o_0, _ = fa.flash_train_fwd_plain(*part, used[h], oob, kp[b], rate, seed)
    assert not torch.equal(o_0, o_p)
