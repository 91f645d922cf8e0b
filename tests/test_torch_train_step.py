"""The port's optimizer and train step against the JAX package's.

- ``warmup_lr`` equals the JAX schedule; the port's AdamW
  (``torch.optim.AdamW``) follows JAX's ``fused_adamw`` over several
  applies at changing LRs, to float32 rounding (rtol 1e-5).
- The step as a whole: the JAX tiny model of tests/test_train_step.py
  (d=16, 1+1 layers, dropout 0) runs two microbatches of
  ``make_train_step`` (batch_size_grad 4: one apply), and its train state
  (parameters, BatchNorm statistics, AdamW moments and counters) is
  carried into the port. Then both run three more microbatches on the same
  batches: the second applies, the third leaves a pending sum. Per
  microbatch the losses agree to rtol 1e-5; at the end the parameters, the
  running statistics and the pending gradient sums agree to 1e-5 of each
  tensor's largest magnitude (atol 1e-6 absolute floor).
  The time shift r that each JAX step drew is read through a
  ``jax.debug.callback`` on ``_shift_rows`` (absent: r = 0), and the
  port's shift draw is patched to return it.
  Exception: a conv bias that feeds a BatchNorm has a true gradient of 0,
  so its computed gradient is float32 noise and Adam's normalized step
  moves it by up to lr in either direction; those biases are held to
  2 * lr summed over the applies, and the running means of their
  BatchNorms, which take in the bias at momentum 0.1, to 0.1 of that more.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import emg_tpu.models.model as jax_model_module
import emg_tpu_torch.models.model as port_model_module
from emg_tpu.config import TrainConfig as JaxTrainConfig
from emg_tpu.parallel import make_train_step as jax_make_train_step
from emg_tpu.train.state import create_train_state as jax_create_state
from emg_tpu.train.state import fused_adamw
from emg_tpu.train.state import warmup_lr as jax_warmup_lr
from tests.test_torch_model import one_torch_thread  # noqa: F401
from tests.test_train_step import tiny_model, toy_batch

from emg_tpu_torch.config import ModelConfig, TrainConfig
from emg_tpu_torch.data.batching import PackedBatch
from emg_tpu_torch.models.model import EMGModel
from emg_tpu_torch.parallel.train_step import make_train_step
from emg_tpu_torch.train.state import create_train_state, make_optimizer, warmup_lr
from emg_tpu_torch.utils.convert import load_adamw_from_flax, state_dict_from_flax

MAX_FRAMES = 16


def test_warmup_lr_matches_jax():
    cfg = TrainConfig(learning_rate=3e-4, learning_rate_warmup=1500)
    jcfg = JaxTrainConfig(learning_rate=3e-4, learning_rate_warmup=1500)
    for mb in (0, 1, 7, 1498, 1499, 1500, 10_000):
        assert warmup_lr(cfg, mb) == float(jax_warmup_lr(jcfg, jnp.asarray(mb)))


def test_adamw_matches_fused_adamw():
    rng = np.random.default_rng(0)
    shapes = {"a": (4, 3), "b": (5,)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    tx = fused_adamw(1e-3)
    jstate = tx.init(jax.tree.map(jnp.asarray, params))
    jparams = jax.tree.map(jnp.asarray, params)
    tparams = [torch.tensor(params[k], requires_grad=True) for k in shapes]
    opt = make_optimizer(tparams, TrainConfig())
    for step, lr in enumerate((1e-3, 2e-3, 5e-4, 3e-3)):
        grads = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
        jstate = jstate._replace(hyperparams={"learning_rate": jnp.float32(lr)})
        updates, jstate = tx.update(jax.tree.map(jnp.asarray, grads), jstate, jparams)
        jparams = jax.tree.map(jnp.add, jparams, updates)
        for p, k in zip(tparams, shapes):
            p.grad = torch.tensor(grads[k])
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()
        for p, k in zip(tparams, shapes):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[k]), rtol=1e-5,
                                       atol=1e-7, err_msg=f"apply {step}, {k}")


def _port_cfg():
    jm = tiny_model()
    return ModelConfig(**{f.name: getattr(jm.cfg, f.name) for f in dataclasses.fields(ModelConfig)})


def _as_port_batch(b) -> PackedBatch:
    return PackedBatch(**{f.name: getattr(b, f.name) for f in dataclasses.fields(PackedBatch)})


def _flat(sd):
    return {k: v.detach().numpy() for k, v in sd.items()}


@pytest.fixture()
def shift_spy(monkeypatch):
    """Records the time shift r of each JAX step (the branch that calls
    _shift_rows runs only for r > 0)."""
    drawn = []
    orig = jax_model_module._shift_rows

    def spy(x, r):
        jax.debug.callback(lambda r: drawn.append(int(r)), r)
        return orig(x, r)

    monkeypatch.setattr(jax_model_module, "_shift_rows", spy)
    return drawn


def test_train_step_matches_jax(shift_spy, monkeypatch):
    model = tiny_model()
    jcfg = JaxTrainConfig(batch_size_grad=4, learning_rate=1e-3, learning_rate_warmup=10)
    batches = [toy_batch(seed=s) for s in range(5)]
    b0 = batches[0]
    variables = model.init({"params": jax.random.PRNGKey(0)}, b0.packed_raw, b0.n_rows,
                           b0.offsets, b0.lengths, b0.targets[:, :-1], MAX_FRAMES, False)
    jstate = jax_create_state(variables["params"], variables["batch_stats"], jcfg)
    jstep = jax_make_train_step(model, jcfg, MAX_FRAMES)
    rng = jax.random.PRNGKey(0)

    def jax_microbatch(state, batch):
        shift_spy.clear()
        state, m = jstep(state, batch, rng)
        jax.effects_barrier()
        return state, m, (shift_spy[0] if shift_spy else 0)

    for b in batches[:2]:  # the JAX run before the carry: one apply
        jstate, m, _ = jax_microbatch(jstate, b)
    assert int(jstate.updates) == 1 and int(jstate.accum_examples) == 0

    cfg = TrainConfig(batch_size_grad=4, learning_rate=1e-3, learning_rate_warmup=10)
    tm = EMGModel(_port_cfg(), device="cpu")
    tm.load_state_dict(state_dict_from_flax(
        {"params": jstate.params, "batch_stats": jstate.batch_stats}, 1, 1))
    state = create_train_state(tm, cfg)
    load_adamw_from_flax(state.optimizer, tm, jstate.opt_state, jstate.batch_stats, 1, 1)
    state.microbatches, state.updates = int(jstate.microbatches), int(jstate.updates)
    step = make_train_step(cfg)
    gen = torch.Generator()

    applied, applied_lr = [], 0.0
    for b in batches[2:]:
        jstate, jm, r = jax_microbatch(jstate, b)
        monkeypatch.setattr(port_model_module, "draw_shift",
                            lambda generator, device, r=r: torch.tensor([r], device=device))
        tmet = step(state, _as_port_batch(b), MAX_FRAMES, gen)
        for k in ("loss", "dec_loss", "enc_loss"):
            np.testing.assert_allclose(float(tmet[k]), float(jm[k]), rtol=1e-5, err_msg=k)
        assert tmet["lr"] == float(jm["lr"])
        assert tmet["applied"] == bool(jm["applied"])
        applied.append(tmet["applied"])
        applied_lr += tmet["lr"] if tmet["applied"] else 0.0
    assert applied == [False, True, False]
    assert state.updates == int(jstate.updates) == 2
    assert state.accum_examples == int(jstate.accum_examples) == 2

    ref = _flat(state_dict_from_flax({"params": jstate.params, "batch_stats": jstate.batch_stats},
                                     1, 1))
    ref_acc = _flat(state_dict_from_flax({"params": jstate.accum_grads,
                                          "batch_stats": jstate.batch_stats}, 1, 1))
    got = _flat(tm.state_dict())
    got_acc = {k: g.numpy() for k, g in state.accum_grads().items()}
    bias_tol = 2 * applied_lr
    for k, p in tm.named_parameters():
        if k.startswith("conv_blocks") and k.endswith(("conv1.bias", "conv2.bias",
                                                       "residual_path.bias")):
            # feeds a BatchNorm: noise gradient, bounded by Adam's step
            np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=bias_tol, err_msg=k)
            continue
        scale = float(np.abs(ref[k]).max())
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=max(1e-5 * scale, 1e-6),
                                   err_msg=k)
        scale = float(np.abs(ref_acc[k]).max())
        np.testing.assert_allclose(got_acc[k], ref_acc[k], rtol=0,
                                   atol=max(1e-5 * scale, 1e-6), err_msg=f"pending sum {k}")
    for k in got:
        if k.endswith(("running_mean", "running_var")):
            scale = float(np.abs(ref[k]).max())
            atol = 1e-5 * scale + (0.1 * bias_tol if k.endswith("running_mean") else 0.0)
            np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=atol, err_msg=k)
