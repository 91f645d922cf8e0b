"""The port's losses (emg_tpu_torch/ops/{ctc,losses}.py) against the JAX
package's, on the same seeded numpy inputs, float32.

Batches carry bucket-padding examples (rows past ``n_examples``, target
length 0) and a true teacher length ``seq_len`` below the bucketed S, as
the train step builds them. Tolerance rtol 1e-5: both sides sum in
float32 in different orders.

The CTC inputs keep every alignment feasible (frames >= 2 * labels + 1):
for an infeasible one torch gives ``inf`` (the reference's value), where
optax gives a large finite number, so the two cannot be compared there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emg_tpu.ops.ctc import ctc_loss as jax_ctc
from emg_tpu.ops.losses import combined_loss as jax_combined
from emg_tpu.ops.losses import label_smoothing_loss as jax_ls
from tests.test_torch_model import one_torch_thread  # noqa: F401

from emg_tpu_torch.ops.ctc import ctc_loss
from emg_tpu_torch.ops.losses import combined_loss, label_smoothing_loss

TOL = dict(rtol=1e-5, atol=1e-6)


def ctc_inputs(seed, B=4, n=3, T=24, S=8):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(B, T, 44)).astype(np.float32) * 2
    log_probs = np.asarray(torch.log_softmax(torch.tensor(logits), -1))
    input_lengths = np.zeros(B, np.int64)
    input_lengths[:n] = rng.integers(2 * S + 1, T + 1, n)
    target_lengths = np.zeros(B, np.int64)
    target_lengths[:n] = rng.integers(1, S + 1, n)
    targets = np.full((B, S), 42, np.int64)
    for b in range(n):
        targets[b, : target_lengths[b]] = rng.integers(0, 40, target_lengths[b])
    return log_probs, input_lengths, targets, target_lengths, n


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ctc_matches_jax(seed):
    lp, il, tg, tl, n = ctc_inputs(seed)
    ref = jax_ctc(jnp.asarray(lp), jnp.asarray(il), jnp.asarray(tg), jnp.asarray(tl),
                  batch_mask=jnp.arange(lp.shape[0]) < n)
    got = ctc_loss(torch.tensor(lp), torch.tensor(il), torch.tensor(tg), torch.tensor(tl), n)
    np.testing.assert_allclose(float(got), float(ref), **TOL)


def test_ctc_gradient_matches_jax():
    import jax

    lp, il, tg, tl, n = ctc_inputs(4)
    mask = jnp.arange(lp.shape[0]) < n
    g_ref = jax.grad(lambda x: jax_ctc(jax.nn.log_softmax(x), jnp.asarray(il), jnp.asarray(tg),
                                       jnp.asarray(tl), batch_mask=mask))(jnp.asarray(lp))
    x = torch.tensor(lp, requires_grad=True)
    ctc_loss(torch.log_softmax(x, -1), torch.tensor(il), torch.tensor(tg), torch.tensor(tl),
             n).backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(g_ref), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("seq_len", [5, 9])
def test_label_smoothing_matches_jax(seq_len):
    rng = np.random.default_rng(seq_len)
    B, S, n = 4, 12, 3
    logits = rng.normal(size=(B, S, 43)).astype(np.float32)
    targets = np.full((B, S), 42, np.int64)
    for b in range(n):
        L = int(rng.integers(2, seq_len + 1))
        targets[b, :L] = rng.integers(0, 41, L)
    ref = jax_ls(jnp.asarray(logits), jnp.asarray(targets), epsilon=0.1,
                 batch_mask=jnp.arange(B) < n, seq_len=seq_len)
    n_tokens = int((targets[:n] != 42).sum())
    got = label_smoothing_loss(torch.tensor(logits), torch.tensor(targets), n, seq_len, n_tokens,
                               0.1)
    np.testing.assert_allclose(float(got), float(ref), **TOL)


def test_combined_loss_matches_jax():
    got = combined_loss(torch.tensor(1.5), torch.tensor(4.0), 0.2)
    np.testing.assert_allclose(float(got), float(jax_combined(1.5, 4.0, 0.2)), **TOL)
