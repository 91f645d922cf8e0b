"""IIR diagonal-recurrence scan: CUDA kernel, plain version, wrapper.

Counterpart of the Pallas TPU kernel ``emg_tpu/ops/pallas/iir_scan.py::
iir_scan``. Computes, per row, the complex recurrence
``w[t] = lam * w[t-1] + u[t]`` from ``w[-1] = w0`` or, with
``reverse=True``, the anti-causal ``w[t] = lam * w[t+1] + u[t]`` from
``w[T] = w0``, with real and imaginary parts split, in float32.

On the card it is the kernel in ``csrc/iir_scan.cu``: each row is spread
over one thread-block cluster of S blocks on neighbouring SMs. Each block
stages its segment of the row in shared memory (one HBM read), scans it,
takes the state entering its segment from its peers' aggregates through
the cluster's distributed shared memory, and writes its outputs once; one
launch a call (the source says what bounds it: bytes, 16 * R * T).
``layout`` picks the cluster size and the segments. On a CPU tensor it is
the plain version, the Hillis-Steele scan of ``dsp/recurrence.py``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from emg_tpu_torch.dsp.recurrence import diagonal_recurrence_plain
from emg_tpu_torch.ops import build


THREADS = 256  # threads of a block (kThreads in the source)
PORTABLE_CLUSTER = 8  # the largest cluster every Hopper part schedules
MAX_CLUSTER = 16  # with the non-portable opt-in (kMaxCluster)
# dynamic shared memory a block may take: Hopper's 227 KB a block, less
# 1 KB for the kernel's static shared memory (kMaxDynamicSmem)
SMEM_BUDGET = 232_448 - 1024
# the longest segment of an 8-block cluster: past it, a row takes 16
SEGMENT_8 = 4096
MAX_ROWS = 65_535  # the grid's second dimension


class Layout(NamedTuple):
    S: int  # blocks a row: the cluster size
    L: int  # logical indices a block owns: [s*L, min((s+1)*L, T))
    n: int  # consecutive items a thread owns within its segment
    smem_bytes: int  # the staged segment: u_r and u_i, float32


def segments(T: int, S: int) -> Layout:
    """Rows of length T cut into S segments. A thread owns an odd number
    of items, so a warp's reads at that stride are free of bank conflicts.
    Raises if a segment does not fit a block's shared memory."""
    if T <= 0 or not 1 <= S <= MAX_CLUSTER:
        raise ValueError(f"iir_scan cannot cut rows of {T} samples into {S} segments")
    L = -(-T // S)
    n = -(-L // THREADS)
    n += 1 - n % 2
    smem_bytes = 2 * 4 * L
    if smem_bytes > SMEM_BUDGET:
        raise ValueError(f"iir_scan rows of {T} samples do not fit a cluster's shared memory")
    return Layout(S, L, n, smem_bytes)


def layout(R: int, T: int) -> Layout:
    """The kernel's segments for R rows of length T.

    S = 8, the portable cluster size, puts the DSP's 16 rows on 128 of the
    card's 132 SMs; at large R, small segments let several blocks share an
    SM, one's loads beside another's stores. Past 8 segments of 4096
    samples (rows from the 32768 bucket up) S = 16, non-portable: it halves
    each thread's serial walk over its items, and at the 131072 bucket an
    eighth of a row (131 KB staged) would hold an SM alone, so that the
    card would hold 15 clusters and 16 rows would take two waves. A row
    shorter than 8 * 256 samples takes fewer blocks, so that none holds
    fewer samples than it has threads. chip_k1_layouts.py times the kernel
    at every S. Raises if the rows do not fit the grid or shared memory.
    """
    if not 0 < R <= MAX_ROWS or T <= 0:
        raise ValueError(f"iir_scan takes 1 to {MAX_ROWS} rows of positive length, got ({R}, {T})")
    S = min(PORTABLE_CLUSTER, -(-T // THREADS))
    if -(-T // S) > SEGMENT_8:
        S = MAX_CLUSTER
    return segments(T, S)


def max_active_clusters(R: int, lay: Layout) -> int:
    """How many clusters of ``lay`` the current card holds at once."""
    count = ctypes.c_int(0)
    build.check("iir_scan", build.library("iir_scan").iir_scan_max_active_clusters(
        R, lay.S, lay.smem_bytes, ctypes.byref(count)))
    return count.value


def iir_scan_plain(lam_r, lam_i, u_r, u_i, w0_r, w0_i, reverse: bool = False):
    """The plain PyTorch version of the kernel (any device)."""
    return diagonal_recurrence_plain(lam_r, lam_i, u_r, u_i, w0_r, w0_i, reverse=reverse)


def _check(lam_r, lam_i, u_r, u_i, w0_r, w0_i):
    if u_r.dim() != 2 or u_i.shape != u_r.shape:
        raise ValueError(f"u must be two equal (R, T) tensors, got {tuple(u_r.shape)}, {tuple(u_i.shape)}")
    R = u_r.shape[0]
    for name, t in (("lam_r", lam_r), ("lam_i", lam_i), ("w0_r", w0_r), ("w0_i", w0_i)):
        if t.shape != (R,):
            raise ValueError(f"{name} must have shape ({R},), got {tuple(t.shape)}")
    tensors = (lam_r, lam_i, u_r, u_i, w0_r, w0_i)
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("iir_scan takes float32 tensors")
    if any(t.device != u_r.device for t in tensors):
        raise ValueError("iir_scan inputs must share one device")


def iir_scan(lam_r, lam_i, u_r, u_i, w0_r, w0_i, reverse: bool = False):
    """lam/w0: (R,) float32; u: (R, T) float32. Returns (w_r, w_i), (R, T).

    A CPU tensor takes the plain version. A CUDA tensor launches the kernel
    or raises; there is no fallback.
    """
    _check(lam_r, lam_i, u_r, u_i, w0_r, w0_i)
    device = u_r.device
    if device.type == "cpu":
        return iir_scan_plain(lam_r, lam_i, u_r, u_i, w0_r, w0_i, reverse=reverse)
    if device.type != "cuda":
        raise ValueError(f"iir_scan runs on cuda or cpu, not {device}")
    lam_r, lam_i, u_r, u_i, w0_r, w0_i = (
        t.contiguous() for t in (lam_r, lam_i, u_r, u_i, w0_r, w0_i)
    )
    R, T = u_r.shape
    S, L, n, smem_bytes = layout(R, T)
    w_r = torch.empty_like(u_r)
    w_i = torch.empty_like(u_i)
    lib = build.library("iir_scan")
    code = lib.iir_scan_f32(
        lam_r.data_ptr(), lam_i.data_ptr(), w0_r.data_ptr(), w0_i.data_ptr(),
        u_r.data_ptr(), u_i.data_ptr(), w_r.data_ptr(), w_i.data_ptr(),
        R, T, S, L, n, smem_bytes, int(reverse), build.current_stream_ptr(device),
    )
    build.check("iir_scan", code)
    build.count_launch(iir_scan)
    return w_r, w_i


iir_scan.launches = 0
