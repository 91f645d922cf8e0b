"""Kernels 3-5's plain versions (the training attention of
emg_tpu_torch/ops/flash_attention.py) against the JAX package's Pallas
training kernels in interpret mode, plus the hash mask and the wrapper's
checks.

- The keep mask equals ``_keep_mask`` of the JAX package bit for bit.
- Output and the gradients for q, k, v and the relative-position table
  match ``flash_attention_relpos_train(..., interpret=True)`` at dropout 0
  and 0.1 with one seed, with key pads: B=2, H=2, T=256, Dh=16, bq=bk=128,
  relative distance 100 (out-of-range window rows active). Tolerances as
  tests/test_pallas.py holds the TPU kernel: the loss to rtol 1e-5, each
  gradient to 2e-4 of its largest magnitude (atol 2e-5 after scaling).
- K4's and K5's plain versions (what the CUDA kernels are held to on the
  card) equal autograd through K3's plain forward, in float32, to 1e-5 of
  each gradient's largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emg_tpu.ops.pallas.flash_attention import _keep_mask
from emg_tpu.ops.pallas.flash_attention import flash_attention_relpos_train as jax_train
from tests.test_pallas import _window
from tests.test_torch_model import one_torch_thread  # noqa: F401

from emg_tpu_torch.models.attention import LearnedRelativePositionalBias, relpos_self_attention
from emg_tpu_torch.ops.flash_attention import (
    flash_attention_relpos_train,
    flash_train_bwd_dkv,
    flash_train_bwd_dq,
    flash_train_fwd,
    keep_mask,
)

B, H, T, Dh, MAXPOS = 2, 2, 256, 16, 100
SEED = 123


def inputs(seed):
    rng = np.random.default_rng(seed)
    q, k, v, w = (rng.normal(size=(B, H, T, Dh)).astype(np.float32) * s for s in (0.5, 0.5, 1, 1))
    table = (rng.normal(size=(H, 2 * MAXPOS - 1, Dh)) * 0.2).astype(np.float32)
    kpad = np.zeros((B, T), bool)
    kpad[0, -40:] = True
    return q, k, v, w, table, kpad


def relpos_module(table):
    mod = LearnedRelativePositionalBias(MAXPOS, H, Dh)
    with torch.no_grad():
        mod.embeddings.copy_(torch.tensor(table)[..., None])
    return mod


@pytest.mark.parametrize("seed", [0, 123, -7, 2 ** 31 - 1])
@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_keep_mask_bit_exact(seed, rate):
    """Several tiles (b, h, query block, key block) of the JAX mask."""
    bq = bk = 64
    for b, h, i, kb in ((0, 0, 0, 0), (1, 3, 2, 1), (5, 7, 9, 11)):
        ref = np.asarray(_keep_mask(jnp.int32(seed), b, h, i, kb, bq, bk, rate))
        qg = torch.arange(bq)[:, None] + i * bq
        kg = torch.arange(bk)[None, :] + kb * bk
        got = keep_mask(seed, b, h, qg, kg, rate).float().numpy()
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_plain_matches_pallas_interpret(rate):
    q, k, v, w, table, kpad = inputs(seed=int(rate * 10) + 1)

    def jax_loss(q, k, v, table):
        used, oob = _window(table, MAXPOS, T)
        o = jax_train(q, k, v, used, oob, jnp.asarray(kpad), rate, SEED,
                      bq=128, bk=128, interpret=True)
        return jnp.sum(o * w)

    jloss, jgrads = jax.value_and_grad(jax_loss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in (q, k, v, table)))

    mod = relpos_module(table)
    qt, kt, vt = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    used, oob = mod.window(T)
    o = flash_attention_relpos_train(qt, kt, vt, used, oob, torch.tensor(kpad), rate,
                                     torch.tensor([SEED], dtype=torch.int32))
    loss = (o * torch.tensor(w)).sum()
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    tgrads = (qt.grad, kt.grad, vt.grad, mod.embeddings.grad[..., 0])
    for name, a, b in zip("qkvt", jgrads, tgrads):
        scale = float(np.abs(np.asarray(a)).max()) + 1e-9
        np.testing.assert_allclose(b.numpy() / scale, np.asarray(a) / scale,
                                   rtol=2e-4, atol=2e-5, err_msg=f"grad of {name}")


@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_plain_backward_kernels_match_autograd(rate):
    """K4 (dq, d_used) and K5 (dk, dv) recompute p from K3's lse; with
    delta = rowsum(dO * o) they give autograd's gradients."""
    q, k, v, w, table, kpad = inputs(seed=5)
    used, oob = relpos_module(table).window(T)
    qt, kt, vt = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    ut = used.detach().requires_grad_()
    kp = torch.tensor(kpad)
    seed = torch.tensor([SEED], dtype=torch.int32)
    o, lse = flash_train_fwd(qt, kt, vt, ut, oob, kp, rate, seed)
    dout = torch.tensor(w)
    grads = torch.autograd.grad((o * dout).sum(), (qt, kt, vt, ut))
    with torch.no_grad():
        args = (qt, kt, vt, ut, oob, kp, dout, lse, (dout * o).sum(-1), rate, seed)
        dq, dused = flash_train_bwd_dq(*args)
        dk, dv = flash_train_bwd_dkv(*args)
    for name, a, b in zip(("q", "k", "v", "used"), grads, (dq, dk, dv, dused)):
        scale = float(a.abs().max())
        np.testing.assert_allclose(b.numpy() / scale, a.numpy() / scale, atol=1e-5,
                                   err_msg=f"grad of {name}")


def test_ragged_bucket_trains_through_padding():
    """T=192 pads to 256 on the training path too: the output's valid rows
    equal the unpadded plain attention's, and the table gradient arrives
    through the window's pad and slice."""
    q, k, v, w, table, kpad = inputs(seed=9)
    Tn = 192
    q, k, v, w, kpad = q[:, :, :Tn], k[:, :, :Tn], v[:, :, :Tn], w[:, :, :Tn], kpad[:, :Tn]
    seed = torch.tensor([SEED], dtype=torch.int32)
    mod = relpos_module(table)
    o = relpos_self_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v), mod,
                              torch.tensor(kpad), 0.0, seed)
    assert o.shape == (B, H, Tn, Dh)
    (o * torch.tensor(w)).sum().backward()
    assert float(mod.embeddings.grad.abs().max()) > 0
    used, oob = relpos_module(table).window(Tn)
    ref = flash_attention_relpos_train(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                                       used.detach(), oob, torch.tensor(kpad), 0.0, seed)
    valid = ~torch.tensor(kpad)[:, None, :, None].expand_as(o)
    np.testing.assert_allclose(o.detach()[valid].numpy(), ref[valid].numpy(), atol=1e-5)


def test_wrapper_rejects_bad_inputs():
    q, k, v, _, table, kpad = inputs(seed=2)
    used, oob = relpos_module(table).window(T)
    used, oob = used.detach(), oob.detach()
    qt, kt, vt, kp = (torch.tensor(a) for a in (q, k, v, kpad))
    seed = torch.tensor([1], dtype=torch.int32)
    with pytest.raises(ValueError):  # shapes
        flash_attention_relpos_train(qt, kt[:, :, :128], vt, used, oob, kp, 0.1, seed)
    with pytest.raises(ValueError):  # window length
        flash_attention_relpos_train(qt, kt, vt, used[:, 1:], oob, kp, 0.1, seed)
    with pytest.raises(TypeError):  # dtype
        flash_attention_relpos_train(qt.double(), kt.double(), vt.double(), used, oob, kp, 0.1, seed)
    with pytest.raises(ValueError):  # rate
        flash_attention_relpos_train(qt, kt, vt, used, oob, kp, 1.0, seed)
    with pytest.raises(ValueError):  # seed: a one-element int32 tensor
        flash_attention_relpos_train(qt, kt, vt, used, oob, kp, 0.1, 7)
    with pytest.raises(ValueError):
        flash_attention_relpos_train(qt, kt, vt, used, oob, kp, 0.1, seed.long())
    # the CPU path is the plain version and never counts as a launch
    before = (flash_train_fwd.launches, flash_train_bwd_dq.launches, flash_train_bwd_dkv.launches)
    qg = qt.clone().requires_grad_()
    flash_attention_relpos_train(qg, kt, vt, used, oob, kp, 0.1, seed).sum().backward()
    assert qg.grad is not None
    assert (flash_train_fwd.launches, flash_train_bwd_dq.launches,
            flash_train_bwd_dkv.launches) == before
