"""Kernel 1's plain version (emg_tpu_torch/ops/iir_scan.py) against the
JAX package's Pallas iir_scan in interpret mode, a direct numpy recurrence,
and the reverse <-> flipped-causal identity; plus the wrapper's checks.

R=16 rows, T=512 (interpret block 128), forward and reverse, random
|lam| < 1 with nonzero initial states. Tolerance 2e-4 (float32 doubling
scan against sequential float32/complex64 recurrences).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emg_tpu.ops.pallas.iir_scan import iir_scan as jax_iir_scan

from emg_tpu_torch.ops.iir_scan import iir_scan, iir_scan_plain
from tests.test_torch_model import one_torch_thread  # noqa: F401

TOL = dict(rtol=2e-4, atol=2e-4)
R, T = 16, 512


def inputs(seed):
    rng = np.random.default_rng(seed)
    radius = rng.uniform(0.8, 0.995, R)
    angle = rng.uniform(-0.3, 0.3, R)
    lam = (radius * np.exp(1j * angle)).astype(np.complex64)
    u = (rng.normal(size=(R, T)) + 1j * rng.normal(size=(R, T))).astype(np.complex64)
    w0 = (rng.normal(size=R) + 1j * rng.normal(size=R)).astype(np.complex64)
    return lam, u, w0


def split(*arrays):
    out = []
    for a in arrays:
        out += [torch.tensor(a.real.copy()), torch.tensor(a.imag.copy())]
    return out


def numpy_recurrence(lam, u, w0, reverse):
    expect = np.empty(u.shape, np.complex64)
    carry = w0.copy()
    steps = range(T - 1, -1, -1) if reverse else range(T)
    for t in steps:
        carry = lam * carry + u[:, t]
        expect[:, t] = carry
    return expect


@pytest.mark.parametrize("reverse", [False, True])
def test_plain_matches_pallas_interpret(reverse):
    lam, u, w0 = inputs(seed=1 + reverse)
    lr, li, ur, ui, wr0, wi0 = split(lam, u, w0)
    got_r, got_i = iir_scan(lr, li, ur, ui, wr0, wi0, reverse=reverse)
    ref_r, ref_i = jax_iir_scan(
        *(jnp.asarray(t.numpy()) for t in (lr, li, ur, ui, wr0, wi0)),
        bt=128, reverse=reverse, interpret=True,
    )
    np.testing.assert_allclose(got_r.numpy(), np.asarray(ref_r), **TOL)
    np.testing.assert_allclose(got_i.numpy(), np.asarray(ref_i), **TOL)


@pytest.mark.parametrize("reverse", [False, True])
def test_plain_matches_numpy_recurrence(reverse):
    lam, u, w0 = inputs(seed=3 + reverse)
    got_r, got_i = iir_scan(*split(lam, u, w0), reverse=reverse)
    expect = numpy_recurrence(lam, u, w0, reverse)
    np.testing.assert_allclose(got_r.numpy(), expect.real, **TOL)
    np.testing.assert_allclose(got_i.numpy(), expect.imag, **TOL)


def test_reverse_equals_flipped_causal():
    lam, u, w0 = inputs(seed=5)
    lr, li, ur, ui, wr0, wi0 = split(lam, u, w0)
    rev_r, rev_i = iir_scan(lr, li, ur, ui, wr0, wi0, reverse=True)
    fwd_r, fwd_i = iir_scan(lr, li, ur.flip(1), ui.flip(1), wr0, wi0)
    np.testing.assert_allclose(rev_r.numpy(), fwd_r.flip(1).numpy(), **TOL)
    np.testing.assert_allclose(rev_i.numpy(), fwd_i.flip(1).numpy(), **TOL)


def test_wrapper_rejects_bad_inputs():
    lam, u, w0 = inputs(seed=6)
    lr, li, ur, ui, wr0, wi0 = split(lam, u, w0)
    with pytest.raises(ValueError):
        iir_scan(lr[:4], li, ur, ui, wr0, wi0)
    with pytest.raises(ValueError):
        iir_scan(lr, li, ur, ui[:, :7], wr0, wi0)
    with pytest.raises(TypeError):
        iir_scan(lr.double(), li, ur, ui, wr0, wi0)
    with pytest.raises(ValueError):
        iir_scan(lr, li, ur[0], ui[0], wr0, wi0)
    # the CPU path is the plain version, and never counts as a launch
    before = iir_scan.launches
    a = iir_scan(lr, li, ur, ui, wr0, wi0)
    b = iir_scan_plain(lr, li, ur, ui, wr0, wi0)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    assert iir_scan.launches == before
