"""Kernel 2's plain version (emg_tpu_torch/ops/flash_attention.py) against
the JAX package's Pallas kernel in interpret mode and against the naive
formula of tests/test_pallas.py, plus the wrapper's checks.

B=2, H=2, Dh=32, float32, T in {256, 384} and the ragged 192 -> 256 case,
relative distance 100 (window narrower than T: out-of-range -1e8 active)
and 300 (window covering T). Valid query rows are compared; tolerance 2e-3
as tests/test_pallas.py holds the TPU kernel.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emg_tpu.ops.pallas.flash_attention import flash_attention_relpos as jax_flash

from emg_tpu_torch.models.attention import LearnedRelativePositionalBias, relpos_self_attention
from emg_tpu_torch.ops.flash_attention import (
    flash_attention_relpos,
    flash_attention_relpos_plain,
)
from tests.test_pallas import _naive
from tests.test_torch_model import one_torch_thread  # noqa: F401

TOL = dict(rtol=2e-3, atol=2e-3)
B, H, Dh = 2, 2, 32


def inputs(T, maxpos, seed):
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=(B, H, T, Dh)) * 0.3).astype(np.float32)
    k = (rng.normal(size=(B, H, T, Dh)) * 0.3).astype(np.float32)
    v = rng.normal(size=(B, H, T, Dh)).astype(np.float32)
    kpad = np.zeros((B, T), bool)
    kpad[0, -30:] = True
    table = (rng.normal(size=(H, 2 * maxpos - 1, Dh)) * 0.2).astype(np.float32)
    return q, k, v, kpad, table


def relpos_module(table, maxpos):
    mod = LearnedRelativePositionalBias(maxpos, H, Dh)
    with torch.no_grad():
        mod.embeddings.copy_(torch.tensor(table)[..., None])
    return mod


def assert_valid_rows_close(got, ref, kpad):
    for b in range(B):
        rows = ~kpad[b]
        np.testing.assert_allclose(got[b][:, rows, :], ref[b][:, rows, :], **TOL)


@pytest.mark.parametrize("T,maxpos", [(256, 100), (256, 300), (384, 100), (384, 300)])
def test_plain_matches_pallas_interpret_and_naive(T, maxpos):
    q, k, v, kpad, table = inputs(T, maxpos, seed=T + maxpos)
    used, oob = relpos_module(table, maxpos).window(T)
    used, oob = used.detach(), oob.detach()
    got = flash_attention_relpos(
        torch.tensor(q), torch.tensor(k), torch.tensor(v), used, oob, torch.tensor(kpad),
    ).numpy()
    ref_naive = _naive(q, k, v, used.numpy(), oob.numpy(), kpad)
    blk = 256 if T % 256 == 0 else T
    ref_pallas = np.asarray(jax_flash(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(used.numpy()),
        jnp.asarray(oob.numpy()), jnp.asarray(kpad), bq=blk, bk=blk, interpret=True,
    ))
    assert_valid_rows_close(got, ref_naive, kpad)
    assert_valid_rows_close(got, ref_pallas, kpad)


@pytest.mark.parametrize("maxpos", [100, 300])
def test_ragged_bucket_pads_to_tile(maxpos):
    """Native T=192 goes through the encoder's padding (to 256, pad keys
    masked, pad query rows sliced off, window at the padded length) and
    equals the naive formula at the true length."""
    T = 192
    q, k, v, kpad, table = inputs(T, maxpos, seed=maxpos)
    mod = relpos_module(table, maxpos)
    with torch.no_grad():
        got = relpos_self_attention(
            torch.tensor(q), torch.tensor(k), torch.tensor(v), mod, torch.tensor(kpad),
        ).numpy()
        used, oob = mod.window(T)
    assert got.shape == (B, H, T, Dh)
    ref = _naive(q, k, v, used.numpy(), oob.numpy(), kpad)
    assert_valid_rows_close(got, ref, kpad)


def test_plain_bf16_rounds_like_the_kernel():
    """bfloat16 inputs: the plain version computes in float32 on the
    bf16-rounded values (probabilities rounded to bf16 before p.v), so it
    stays within bf16 rounding (1e-2) of the float32 result."""
    T, maxpos = 256, 100
    q, k, v, kpad, table = inputs(T, maxpos, seed=1)
    used, oob = relpos_module(table, maxpos).window(T)
    used, oob = used.detach(), oob.detach()
    args32 = [torch.tensor(a) for a in (q, k, v)]
    out32 = flash_attention_relpos(*args32, used, oob, torch.tensor(kpad))
    out16 = flash_attention_relpos(
        *[a.to(torch.bfloat16) for a in args32], used.to(torch.bfloat16), oob, torch.tensor(kpad),
    )
    assert out16.dtype == torch.float32
    for b in range(B):
        rows = ~kpad[b]
        np.testing.assert_allclose(out16[b][:, rows].numpy(), out32[b][:, rows].numpy(),
                                   atol=1e-2, rtol=1e-2)


def test_wrapper_rejects_bad_inputs():
    T, maxpos = 256, 100
    q, k, v, kpad, table = inputs(T, maxpos, seed=2)
    used, oob = relpos_module(table, maxpos).window(T)
    used, oob = used.detach(), oob.detach()
    qt, kt, vt, kp = (torch.tensor(a) for a in (q, k, v, kpad))
    with pytest.raises(ValueError):
        flash_attention_relpos(qt, kt[:, :, :128], vt, used, oob, kp)
    with pytest.raises(ValueError):
        flash_attention_relpos(qt, kt, vt, used[:, 1:], oob, kp)
    with pytest.raises(TypeError):
        flash_attention_relpos(qt.double(), kt.double(), vt.double(), used, oob, kp)
    with pytest.raises(ValueError):
        flash_attention_relpos(qt, kt, vt, used, oob, kp.float())
    # the CPU path is the plain version, and never counts as a launch
    before = flash_attention_relpos.launches
    np.testing.assert_array_equal(
        flash_attention_relpos(qt, kt, vt, used, oob, kp).numpy(),
        flash_attention_relpos_plain(qt, kt, vt, used, oob, kp).numpy(),
    )
    assert flash_attention_relpos.launches == before
