"""Kernel 1's cluster decomposition (emg_tpu_torch/ops/csrc/iir_scan.cu),
replayed on the CPU, where the kernel cannot run.

``replay`` below repeats the kernel's arithmetic in float32 torch for a
given ``layout``: a row's S segments of L logical indices (the logical
index j is time T-1-j in reverse), n consecutive items a thread, each
thread's fold into an affine map, the Kogge-Stone scans across a warp's
lanes and across the block's warps, the segment aggregates composed with
w0 in segment order, and the sequential apply. It is held against the JAX
package's Pallas iir_scan in interpret mode and a numpy recurrence, both
directions, at T in {1, 7, L-1, L, L+1, S*L+19} with S and L of the 16384
bucket's layout, tolerance 2e-4 (float32 scans against sequential
float32/complex64 recurrences). Also: every layout the DSP's buckets ask
for fits a block's shared memory and covers [0, T) exactly once, layouts
with empty segments and with 16 segments replay right, and the source's
constants are the wrapper's.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emg_tpu.ops.pallas.iir_scan import iir_scan as jax_iir_scan

from emg_tpu_torch.data.dataset import _DSP_BUCKETS
from emg_tpu_torch.ops import build
from emg_tpu_torch.ops.iir_scan import (
    MAX_CLUSTER, PORTABLE_CLUSTER, SMEM_BUDGET, THREADS, Layout, layout, segments,
)
from tests.test_torch_model import one_torch_thread  # noqa: F401

TOL = dict(rtol=2e-4, atol=2e-4)
R = 16
WARPS = THREADS // 32
BASE = layout(R, 16384 + 19)  # S = 8, L = 2051
REPLAY_T = [1, 7, BASE.L - 1, BASE.L, BASE.L + 1, BASE.S * BASE.L + 19]


def inputs(T, seed):
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
    T = u.shape[1]
    expect = np.empty(u.shape, np.complex64)
    carry = w0.copy()
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        carry = lam * carry + u[:, t]
        expect[:, t] = carry
    return expect


# ---------------------------------------------------------------------------
# the replay
# ---------------------------------------------------------------------------

def item_indices(T, lay):
    """Logical index of each (segment, thread, item) slot, and whether the
    slot holds one: thread k of block s owns [k*n, k*n + n) of its
    segment's first min(L, T - s*L) indices."""
    s = torch.arange(lay.S)[:, None, None]
    local = torch.arange(THREADS)[None, :, None] * lay.n + torch.arange(lay.n)[None, None, :]
    seg_len = (T - torch.clamp(s * lay.L, max=T)).clamp(max=lay.L)
    return s * lay.L + local, local < seg_len


def then(a, b):
    """The map that applies a first and b second; maps are (pr, pi, br, bi)."""
    apr, api, abr, abi = a
    bpr, bpi, bbr, bbi = b
    return (bpr * apr - bpi * api, bpr * api + bpi * apr,
            bpr * abr - bpi * abi + bbr, bpr * abi + bpi * abr + bbi)


def where(cond, a, b):
    return tuple(torch.where(cond, x, y) for x, y in zip(a, b))


def identity_like(x):
    return (torch.ones_like(x), torch.zeros_like(x), torch.zeros_like(x), torch.zeros_like(x))


def inclusive_scan(m):
    """Kogge-Stone along the last axis, as the shuffles run it: at distance
    d, lane l >= d takes then(lane l-d, lane l)."""
    lanes = m[0].shape[-1]
    lane = torch.arange(lanes)
    d = 1
    while d < lanes:
        prev = tuple(torch.roll(x, d, dims=-1) for x in m)
        m = where(lane >= d, then(prev, m), m)
        d *= 2
    return m


def exclusive(incl):
    """shfl_up by one, the identity at lane 0."""
    lane = torch.arange(incl[0].shape[-1])
    prev = tuple(torch.roll(x, 1, dims=-1) for x in incl)
    return where(lane >= 1, prev, identity_like(incl[0]))


def apply(m, cr, ci):
    pr, pi, br, bi = m
    return pr * cr - pi * ci + br, pr * ci + pi * cr + bi


def replay(lam_r, lam_i, u_r, u_i, w0_r, w0_i, reverse, lay):
    """The kernel's decomposition in float32 torch. Returns (w_r, w_i)."""
    rows, T = u_r.shape
    xr, xi = (u.flip(1) if reverse else u for u in (u_r, u_i))  # logical order
    j, valid = item_indices(T, lay)
    idx = j.clamp(max=T - 1)
    itr, iti = xr[:, idx], xi[:, idx]  # (R, S, THREADS, n)
    lr = lam_r[:, None, None].expand(rows, lay.S, THREADS)
    li = lam_i[:, None, None].expand(rows, lay.S, THREADS)

    # fold each thread's items
    mine = identity_like(lr)
    for i in range(lay.n):
        mine = where(valid[..., i], then(mine, (lr, li, itr[..., i], iti[..., i])), mine)

    # scan across each warp's lanes, then across the block's warps
    shape = (rows, lay.S, WARPS, 32)
    incl = inclusive_scan(tuple(x.reshape(shape) for x in mine))
    excl = exclusive(incl)
    totals = inclusive_scan(tuple(x[..., 31] for x in incl))  # (R, S, WARPS)
    warp_prefix = exclusive(totals)
    segment = tuple(x[..., WARPS - 1] for x in totals)  # (R, S)

    # the state entering segment s: w0 through the aggregates 0..s-1
    cr, ci = w0_r, w0_i
    carries_r, carries_i = [], []
    for s in range(lay.S):
        carries_r.append(cr)
        carries_i.append(ci)
        cr, ci = apply(tuple(x[:, s] for x in segment), cr, ci)
    carry_r = torch.stack(carries_r, 1)[:, :, None, None]
    carry_i = torch.stack(carries_i, 1)[:, :, None, None]

    # each thread's entry state, then the sequential recurrence
    pre = then(tuple(x[..., None] for x in warp_prefix), excl)
    sr, si = (x.reshape(rows, lay.S, THREADS) for x in apply(pre, carry_r, carry_i))
    out_r, out_i = torch.zeros_like(itr), torch.zeros_like(iti)
    for i in range(lay.n):
        nr = lr * sr - li * si + itr[..., i]
        ni = lr * si + li * sr + iti[..., i]
        sr = torch.where(valid[..., i], nr, sr)
        si = torch.where(valid[..., i], ni, si)
        out_r[..., i], out_i[..., i] = sr, si

    w_r, w_i = torch.zeros_like(u_r), torch.zeros_like(u_i)
    w_r[:, j[valid]] = out_r[:, valid]
    w_i[:, j[valid]] = out_i[:, valid]
    return (w_r.flip(1), w_i.flip(1)) if reverse else (w_r, w_i)


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rows", [16, 24, 384])
@pytest.mark.parametrize("T", [b + pad for b in _DSP_BUCKETS for pad in (19, 25)])
def test_layout_fits_and_covers_each_index_once(rows, T):
    lay = layout(rows, T)
    assert 1 <= lay.S <= MAX_CLUSTER and lay.S * lay.L >= T
    assert lay.smem_bytes == 8 * lay.L <= SMEM_BUDGET
    assert lay.n % 2 == 1 and lay.n * THREADS >= lay.L
    j, valid = item_indices(T, lay)
    counts = np.bincount(j[valid].numpy(), minlength=T)
    assert len(counts) == T and (counts == 1).all()


def test_layout_rejects_what_the_kernel_cannot_take():
    with pytest.raises(ValueError):
        layout(0, 100)
    with pytest.raises(ValueError):
        layout(65_536, 100)
    with pytest.raises(ValueError):
        layout(16, 0)
    with pytest.raises(ValueError):
        layout(16, MAX_CLUSTER * SMEM_BUDGET // 8 + 1)  # a segment past shared memory


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
@pytest.mark.parametrize("T", REPLAY_T)
def test_replay_matches_pallas_interpret_and_numpy(T, reverse):
    lam, u, w0 = inputs(T, seed=T + reverse)
    lr, li, ur, ui, wr0, wi0 = split(lam, u, w0)
    got_r, got_i = replay(lr, li, ur, ui, wr0, wi0, reverse, layout(R, T))

    # the Pallas kernel takes whole 128-blocks: pad past the row's far end
    # (zeros after it in time forward, before it reversed), so the padding
    # never reaches the row's outputs
    pad = -T % 128
    at = (0, pad) if not reverse else (pad, 0)
    ref_r, ref_i = jax_iir_scan(
        *(jnp.asarray(t.numpy()) for t in (lr, li)),
        *(jnp.asarray(np.pad(t.numpy(), ((0, 0), at))) for t in (ur, ui)),
        *(jnp.asarray(t.numpy()) for t in (wr0, wi0)),
        bt=128, reverse=reverse, interpret=True,
    )
    keep = slice(0, T) if not reverse else slice(pad, pad + T)
    np.testing.assert_allclose(got_r.numpy(), np.asarray(ref_r)[:, keep], **TOL)
    np.testing.assert_allclose(got_i.numpy(), np.asarray(ref_i)[:, keep], **TOL)

    expect = numpy_recurrence(lam, u, w0, reverse)
    np.testing.assert_allclose(got_r.numpy(), expect.real, **TOL)
    np.testing.assert_allclose(got_i.numpy(), expect.imag, **TOL)


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
@pytest.mark.parametrize("T, lay", [
    (1, Layout(8, 1, 1, 8)),  # seven empty segments
    (300, Layout(8, 100, 1, 800)),  # the last five empty
    (1000, Layout(2, 500, 3, 4000)),  # none empty: three items a thread
    (5000, segments(5000, 16)),  # a cluster past the portable size
], ids=["T1_S8", "T300_S8", "T1000_S2", "T5000_S16"])
def test_replay_at_other_layouts(T, lay, reverse):
    lam, u, w0 = inputs(T, seed=7 + reverse)
    got_r, got_i = replay(*split(lam, u, w0), reverse, lay)
    expect = numpy_recurrence(lam, u, w0, reverse)
    np.testing.assert_allclose(got_r.numpy(), expect.real, **TOL)
    np.testing.assert_allclose(got_i.numpy(), expect.imag, **TOL)


def test_source_constants_are_the_wrappers():
    source = (build.CSRC / "iir_scan.cu").read_text()

    def constant(name):
        return re.search(rf"constexpr int {name} = ([^;]+);", source).group(1)

    assert constant("kThreads") == str(THREADS)
    assert constant("kPortableCluster") == str(PORTABLE_CLUSTER)
    assert constant("kMaxCluster") == str(MAX_CLUSTER)
    assert eval(constant("kMaxDynamicSmem")) == SMEM_BUDGET
    assert "cudaLaunchAttributeClusterDimension" in source and "map_shared_rank" in source
