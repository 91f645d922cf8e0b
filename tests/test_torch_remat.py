"""Rematerialized encoder layers (``model.remat``) against the JAX
package's ``nn.remat`` and against the port without remat.

The tiny model of tests/test_sharded_e2e.py (d=16, 1+1 layers, 2 heads,
FF 32) on the sharded-step test's five-utterance batch, one microbatch with
no apply, the gradients read from ``.grad``.

- Dropout 0, JAX's weights carried across, the time shift held at 0 on
  both sides (JAX's ``_shift_rows`` made the identity): the port's
  transformer with ``remat=True`` against JAX's ``remat=True`` step, the
  loss to rtol 1e-5 and every gradient to 1e-5 of its largest magnitude
  (the conv biases that feed a BatchNorm, true gradient 0, to 1e-6 of the
  largest gradient).
- The port with remat is bitwise the port without, at dropout 0 and 0.2
  (the masks and the attention seed are drawn once and read back by the
  recompute: a recompute that drew again would differ), with two encoder
  layers; the training attention runs twice a layer with remat (the
  forward and the backward's recompute) and once without.
- The conformer with ``remat=True`` is bitwise the conformer without, as
  JAX builds it without the flag.
- Remat on a gloo 1x2 mesh with sequence_shard (two CPU ranks; each
  layer's recompute replays its all-gather and reduce-scatter inside the
  backward) at dropout 0.2: the loss to rtol 1e-5 and the gathered
  gradients to 1e-5 of each tensor's largest magnitude against the
  single-rank step without remat (the BatchNorm-fed conv biases to 1e-6
  of the largest gradient).
"""

import os

import numpy as np
import pytest
import torch

import emg_tpu_torch.models.model as port_model_module
from tests.test_torch_model import one_torch_thread  # noqa: F401
from tests.test_torch_sharded_step import MAX_FRAMES, TINY, _rank_steps, toy_batch

from emg_tpu_torch.config import ModelConfig, TrainConfig
from emg_tpu_torch.models import attention as attention_module
from emg_tpu_torch.models.model import EMGModel
from emg_tpu_torch.parallel.distributed import launch
from emg_tpu_torch.parallel.train_step import make_train_step
from emg_tpu_torch.train.state import create_train_state

NO_APPLY = TrainConfig(batch_size_grad=10 ** 6)
DROPOUT = dict(dropout_model=0.2, dropout_pos_emb=0.2)
NO_DROPOUT = dict(dropout_model=0.0, dropout_pos_emb=0.0)


@pytest.fixture
def no_shift(monkeypatch):
    monkeypatch.setattr(port_model_module, "draw_shift",
                        lambda generator, device: torch.zeros(1, dtype=torch.int64, device=device))


def _bn_fed_bias(name: str) -> bool:
    return name.startswith("conv_blocks") and name.endswith(("conv1.bias", "conv2.bias",
                                                              "residual_path.bias"))


def port_step(kwargs, weights=None):
    """One microbatch of the port (no apply): (loss, gradients by name, the
    training attention's calls)."""
    model = EMGModel(ModelConfig(**kwargs), device="cpu")
    if weights is not None:
        model.load_state_dict(weights)
    state = create_train_state(model, NO_APPLY)
    calls = []
    real = attention_module.flash_attention_relpos_train

    def counted(*args):
        calls.append(1)
        return real(*args)

    attention_module.flash_attention_relpos_train = counted
    try:
        metrics = make_train_step(NO_APPLY)(state, toy_batch(), MAX_FRAMES, torch.Generator())
    finally:
        attention_module.flash_attention_relpos_train = real
    return (float(metrics["loss"]), {n: p.grad.clone() for n, p in model.named_parameters()},
            len(calls))


def test_remat_matches_jax_remat(monkeypatch, no_shift):
    import dataclasses

    import jax

    import emg_tpu.models.model as jax_model_module
    from emg_tpu.data.batching import PackedBatch as JaxPackedBatch
    from emg_tpu.ops import combined_loss
    from emg_tpu.parallel.train_step import compute_losses
    from tests.test_train_step import tiny_model

    from emg_tpu_torch.utils.convert import state_dict_from_flax

    monkeypatch.setattr(jax_model_module, "_shift_rows", lambda x, r: x)
    plain = tiny_model()
    model = jax_model_module.EMGModel(dataclasses.replace(plain.cfg, remat=True))
    pb = toy_batch()
    jb = JaxPackedBatch(**{f.name: getattr(pb, f.name) for f in dataclasses.fields(pb)})
    variables = model.init({"params": jax.random.PRNGKey(0)}, jb.packed_raw, jb.n_rows,
                           jb.offsets, jb.lengths, jb.targets[:, :-1], MAX_FRAMES, False)

    def loss_fn(params):
        (dec, enc), _ = compute_losses(
            model, params, variables["batch_stats"], jb, MAX_FRAMES, train=True,
            rngs={"dropout": jax.random.PRNGKey(1), "shift": jax.random.PRNGKey(2)})
        return combined_loss(dec, enc, NO_APPLY.alpha_loss)

    loss, grads = jax.value_and_grad(loss_fn)(variables["params"])
    ref = state_dict_from_flax({"params": grads, "batch_stats": variables["batch_stats"]}, 1, 1)
    got_loss, got, calls = port_step(dict(TINY, remat=True, **NO_DROPOUT),
                                     state_dict_from_flax(variables, 1, 1))
    assert calls == 2  # the forward and the recompute
    np.testing.assert_allclose(got_loss, float(loss), rtol=1e-5)
    largest = max(float(g.abs().max()) for g in got.values())
    for name, g in got.items():
        want = ref[name].numpy()
        atol = (1e-6 * largest if _bn_fed_bias(name)
                else max(1e-5 * float(np.abs(want).max()), 1e-7))
        np.testing.assert_allclose(g.numpy(), want, rtol=0, atol=atol, err_msg=name)


@pytest.mark.parametrize("encoder, dropout", [
    ("transformer", NO_DROPOUT), ("transformer", DROPOUT), ("conformer", DROPOUT),
], ids=["transformer_dropout0", "transformer_dropout0.2", "conformer_dropout0.2"])
def test_remat_is_bitwise_the_plain_step(encoder, dropout):
    kwargs = dict(TINY, num_layers_encoder=2, **dropout)
    if encoder == "conformer":
        kwargs.update(encoder_kind="conformer", conformer_conv_kernel_size=5)
    plain_loss, plain, plain_calls = port_step(kwargs)
    loss, grads, calls = port_step(dict(kwargs, remat=True))
    assert loss == plain_loss
    for name, g in plain.items():
        assert torch.equal(grads[name], g), name
    if encoder == "transformer":
        assert (plain_calls, calls) == (2, 4)


def test_remat_on_a_sequence_sharded_mesh(tmp_path):
    """Two CPU ranks, a 1x2 mesh with sequence_shard, remat at dropout 0.2,
    against the single-rank step without remat (the shift held at 0)."""
    kwargs = dict(TINY, num_layers_encoder=2, **DROPOUT)
    plan = [("remat_1x2_seq", (1, 2, True), dict(kwargs, remat=True), None, NO_APPLY, 0)]
    launch(_rank_steps, (plan, str(tmp_path)), 2, "cpu")
    real = port_model_module.draw_shift
    port_model_module.draw_shift = lambda generator, device: torch.zeros(
        1, dtype=torch.int64, device=device)
    try:
        want_loss, want, _ = port_step(kwargs)
    finally:
        port_model_module.draw_shift = real
    largest = max(float(g.abs().max()) for g in want.values())
    for rank in range(2):
        got = torch.load(os.path.join(tmp_path, f"remat_1x2_seq.{rank}.pt"))
        np.testing.assert_allclose(got["loss"], want_loss, rtol=1e-5)
        for name, w in want.items():
            atol = 1e-6 * largest if _bn_fed_bias(name) else 1e-5 * float(w.abs().max())
            np.testing.assert_allclose(got["grads"][name].numpy(), w.numpy(), rtol=0,
                                       atol=max(atol, 1e-7), err_msg=name)
