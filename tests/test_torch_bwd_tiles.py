"""The index algebra of the attention backward's dq kernel (K4,
emg_tpu_torch/ops/csrc/flash_bwd_relpos.cuh), emulated in torch on the CPU.

The kernel cannot run here, so its tiling is replayed with the same indices
and checked against the plain version ``flash_train_bwd_dq_plain``:

- a block owns 64 query rows q0 .. and walks key tiles k0 .. of 64; the
  tile's band is rows k0 - q0 - 64 + T .. + 127 of ``used`` (zero past
  2T - 2);
- ds[il][jj] goes to the skewed tile S_T[jj - il + 63][il] (band row x
  query, row stride 72);
- dq = scale * ds.K (summed over two key halves, as eight-warp float32
  blocks do) + S_w . Band_w, where warp w's 16 queries read band rows
  48 - 16w .. + 79;
- d_used[h, band row] += S_T . Q, rows past 2T - 2 dropped.

Summed over blocks and tiles, dq and d_used equal the plain version to
1e-5 of their largest magnitude (float32 summation order), with dropout 0
and 0.2, with and without a padded key tail. A second test checks that the
k-steps the kernel skips in S_T . Q hold only zeros.
"""

import numpy as np
import pytest
import torch

from tests.test_torch_model import one_torch_thread  # noqa: F401

from emg_tpu_torch.ops import flash_attention as fa

B, H, T, DH = 2, 2, 128, 8
BQ = BK = 64  # query rows a block, keys a tile
BAND = BQ + BK  # band rows a tile: 127 used, padded
TS = BQ + 8  # S_T's row stride
WARP_BAND = 16 + BK  # band rows a warp's 16 queries touch: 79, padded


def skewed(tile: torch.Tensor) -> torch.Tensor:
    """S_T of one (64 queries x 64 keys) ds tile."""
    s_t = torch.zeros(BAND, TS, dtype=tile.dtype)
    il = torch.arange(BQ)[:, None].expand(BQ, BK)
    jj = torch.arange(BK)[None, :].expand(BQ, BK)
    s_t[jj - il + BQ - 1, il] = tile
    return s_t


def warp_band(w: int) -> slice:
    return slice(BQ - 16 - 16 * w, BQ - 16 - 16 * w + WARP_BAND)


def emulate_dq(q, k, used, ds):
    scale = DH ** -0.5
    last_row = 2 * T - 2
    dq = torch.zeros(B, H, T, DH)
    dused = torch.zeros(H, 2 * T - 1, DH)
    for b in range(B):
        for h in range(H):
            for q0 in range(0, T, BQ):
                qb = q[b, h, q0:q0 + BQ]
                dqk = torch.zeros(BQ, DH)
                dqr = torch.zeros(BQ, DH)
                for k0 in range(0, T, BK):
                    rb0 = k0 - q0 - BQ + T
                    valid = min(BAND, last_row - rb0 + 1)
                    band = torch.zeros(BAND, DH)
                    band[:valid] = used[h, rb0:rb0 + valid]
                    tile = ds[b, h, q0:q0 + BQ, k0:k0 + BK]
                    kt = k[b, h, k0:k0 + BK]
                    for half in (slice(0, BK // 2), slice(BK // 2, BK)):
                        dqk += tile[:, half] @ kt[half]
                    s_t = skewed(tile)
                    for w in range(BQ // 16):
                        rows = slice(16 * w, 16 * w + 16)
                        cols = warp_band(w)
                        outside = torch.ones(BAND, dtype=torch.bool)
                        outside[cols] = False
                        assert not s_t[outside, rows].any(), "a warp's band misses a nonzero"
                        dqr[rows] += s_t[cols, rows].T @ band[cols]
                    du = s_t[:, :BQ] @ qb
                    dused[h, rb0:rb0 + valid] += du[:valid]
                    assert not du[valid:].any()
                dq[b, h, q0:q0 + BQ] = dqk * scale + dqr
    return dq, dused


def inputs(rate, pad_tail):
    rng = np.random.default_rng(7)
    q, k, v, dout = (torch.tensor(rng.normal(size=(B, H, T, DH)), dtype=torch.float32)
                     for _ in range(4))
    used = torch.tensor(rng.normal(size=(H, 2 * T - 1, DH)) * 0.3, dtype=torch.float32)
    oob = torch.tensor(rng.normal(size=(2 * T - 1,)) * 0.1, dtype=torch.float32)
    key_pad = torch.zeros(B, T, dtype=torch.bool)
    if pad_tail:
        key_pad[0, T - 40:] = True
        key_pad[1, T - 70:] = True
    seed = torch.tensor([99], dtype=torch.int32)
    o, lse = fa.flash_train_fwd_plain(q, k, v, used, oob, key_pad, rate, seed)
    delta = (dout * o).sum(-1)
    return q, k, v, used, oob, key_pad, dout, lse, delta, rate, seed


@pytest.mark.parametrize("pad_tail", [False, True], ids=["no_pad", "pad_tail"])
@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_tiled_dq_equals_plain(rate, pad_tail):
    args = inputs(rate, pad_tail)
    q, k, v, used, oob, key_pad, dout, lse, delta = args[:9]
    _, _, ds = fa._train_ds(*args)
    dq, dused = emulate_dq(q, k, used, ds)
    dq_ref, dused_ref = fa.flash_train_bwd_dq_plain(*args)
    for got, ref in ((dq, dq_ref), (dused, dused_ref)):
        assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


@pytest.mark.parametrize("k_step", [8, 16], ids=["f32_k8", "bf16_k16"])
def test_skipped_k_steps_of_s_t_q_are_zero(k_step):
    """S_T . Q runs band rows 16m .. + 15 over the k-steps of queries
    max(0, 48 - 16m) .. min(63, 126 - 16m) only; the rest of S_T is zero,
    whatever the tile's ds."""
    s_t = skewed(torch.ones(BQ, BK))
    covered = torch.zeros_like(s_t, dtype=torch.bool)
    for m in range(BAND // 16):
        lo = max(0, BQ - 16 - 16 * m) // k_step
        hi = min(BQ - 1, 2 * (BQ - 1) - 16 * m) // k_step
        covered[16 * m:16 * m + 16, lo * k_step:(hi + 1) * k_step] = True
    assert s_t[~covered].eq(0).all()
    assert s_t.sum() == BQ * BK
