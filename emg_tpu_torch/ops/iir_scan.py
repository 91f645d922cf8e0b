"""IIR diagonal-recurrence scan: CUDA kernel, plain version, wrapper.

Counterpart of the Pallas TPU kernel ``emg_tpu/ops/pallas/iir_scan.py::
iir_scan``. Computes, per row, the complex recurrence
``w[t] = lam * w[t-1] + u[t]`` from ``w[-1] = w0`` or, with
``reverse=True``, the anti-causal ``w[t] = lam * w[t+1] + u[t]`` from
``w[T] = w0``, with real and imaginary parts split, in float32.

On the card it is the kernel in ``csrc/iir_scan.cu``: one thread block per
row walks time in chunks with the carry in registers (the source says what
bounds it: bytes, 16 * R * T). On a CPU tensor it is the plain version,
the Hillis-Steele scan of ``dsp/recurrence.py``.
"""

from __future__ import annotations

import torch

from emg_tpu_torch.dsp.recurrence import diagonal_recurrence_plain
from emg_tpu_torch.ops import build


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
    w_r = torch.empty_like(u_r)
    w_i = torch.empty_like(u_i)
    lib = build.library("iir_scan")
    code = lib.iir_scan_f32(
        lam_r.data_ptr(), lam_i.data_ptr(), w0_r.data_ptr(), w0_i.data_ptr(),
        u_r.data_ptr(), u_i.data_ptr(), w_r.data_ptr(), w_i.data_ptr(),
        R, T, int(reverse), build.current_stream_ptr(device),
    )
    build.check("iir_scan", code)
    iir_scan.launches += 1
    return w_r, w_i


iir_scan.launches = 0
