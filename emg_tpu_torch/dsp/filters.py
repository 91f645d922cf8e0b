"""Zero-phase IIR filtering with scipy.signal.filtfilt semantics, in torch.

Counterpart of ``emg_tpu/dsp/filters.py``. The reference front-end runs, per
EMG channel, seven 60 Hz-harmonic notch filters (Q=30 biquads) followed by
a 3rd-order 2 Hz Butterworth high-pass, each applied forward-backward with
scipy's default odd-extension edge handling (reference read_emg.py:32-43).
The filters are designed on the host (scipy, float64) and run on the
tensor's device as complex diagonal recurrences in each filter's eigenbasis
through ``ops.iir_scan`` (the CUDA kernel on the card, its plain version on
the CPU). ``filtfilt_masked`` filters the first ``n`` rows of a fixed-size
buffer, so one bucketed buffer serves utterances of any length up to it;
``lfilter`` and ``filtfilt`` are scipy's exact-length forms, over the same
recurrence.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import scipy.signal
import torch

from emg_tpu_torch.ops.iir_scan import iir_scan


# ---------------------------------------------------------------------------
# Host-side filter design (tiny, float64, cached)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def design_highpass(order: int = 3, cutoff: float = 2.0, fs: float = 1000.0):
    b, a = scipy.signal.butter(order, cutoff, "highpass", fs=fs)
    return np.asarray(b), np.asarray(a)


@functools.lru_cache(maxsize=None)
def design_notch(freq: float, q: float = 30.0, fs: float = 1000.0):
    b, a = scipy.signal.iirnotch(freq, q, fs)
    return np.asarray(b), np.asarray(a)


@functools.lru_cache(maxsize=None)
def _filter_constants(b_key: tuple, a_key: tuple):
    """The DF2T recurrence in diagonalized (eigen) form.

    Returns (A, g, b0, zi, lam, w_in, c_out, Vinv) where the filter state
    evolves as w[t] = lam*w[t-1] + w_in*x[t] in the eigenbasis, the DF2T
    state is recovered via z = V w, and y[t] = b0*x[t] + Re(c_out . w[t-1]).
    """
    b = np.asarray(b_key, dtype=np.float64)
    a = np.asarray(a_key, dtype=np.float64)
    b = b / a[0]
    a = a / a[0]
    m = max(len(a), len(b)) - 1
    b = np.concatenate([b, np.zeros(m + 1 - len(b))])
    a = np.concatenate([a, np.zeros(m + 1 - len(a))])
    # Direct-form II transposed:
    #   y[t]   = b0 x[t] + z0[t-1]
    #   z_i[t] = b_{i+1} x[t] + z_{i+1}[t-1] - a_{i+1} y[t]
    # substituting y gives z[t] = A z[t-1] + g x[t]
    A = np.zeros((m, m))
    for i in range(m):
        A[i, 0] = -a[i + 1]
        if i + 1 < m:
            A[i, i + 1] += 1.0
    g = b[1:] - a[1:] * b[0]
    zi = scipy.signal.lfilter_zi(b, a)
    lam, V = np.linalg.eig(A)
    if np.abs(lam).max() >= 1.0:
        raise ValueError("unstable filter")
    Vinv = np.linalg.inv(V)
    w_in = Vinv @ g.astype(np.complex128)
    c_out = V[0, :]
    return A, g, float(b[0]), zi, lam, w_in, c_out, Vinv


def _key(arr) -> tuple:
    return tuple(np.asarray(arr, dtype=np.float64).tolist())


class DeviceFilter:
    """Float32 constants of one (b, a) filter on one device, split real/imag."""

    def __init__(self, b, a, device):
        A, g, b0, zi, lam, w_in, c_out, Vinv = _filter_constants(_key(b), _key(a))

        def f32(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=device)

        self.m = A.shape[0]
        self.b0 = b0
        self.zi = f32(zi)
        self.lam_r, self.lam_i = f32(np.real(lam)), f32(np.imag(lam))
        self.w_in_r, self.w_in_i = f32(np.real(w_in)), f32(np.imag(w_in))
        self.c_out_r, self.c_out_i = f32(np.real(c_out)), f32(np.imag(c_out))
        self.Vinv_r, self.Vinv_i = f32(np.real(Vinv)), f32(np.imag(Vinv))

    def to_eigen(self, z):
        """(C, m) real DF2T states -> eigenbasis (w_r, w_i), each (C, m)."""
        w_r = (z[:, None, :] * self.Vinv_r[None]).sum(dim=2)
        w_i = (z[:, None, :] * self.Vinv_i[None]).sum(dim=2)
        return w_r, w_i


@functools.lru_cache(maxsize=64)
def device_filter(b_key: tuple, a_key: tuple, device: torch.device) -> DeviceFilter:
    return DeviceFilter(b_key, a_key, device)


def _lfilter_core(flt: DeviceFilter, x, z_init, reverse: bool = False,
                  inject_pos=None, inject_wr=None, inject_wi=None):
    """x: (T, C) float32; z_init: (C, m) float32 DF2T state. Returns (T, C).

    The recurrence runs over R = C*m rows of length T, one row per
    (channel, eigen-state) pair. ``reverse=True`` runs the anti-causal
    mirror w[t] = lam w[t+1] + u[t] (the zero-phase backward pass without
    reversing the data); it requires ``z_init == 0``, and a state enters at
    a per-column row ``inject_pos`` (C,) with eigen-space values
    ``inject_wr/wi`` (C, m): the scan input there is replaced by the state,
    so w[inject_pos] == inject_w exactly (all u at and beyond inject_pos
    must be zero, which ``filtfilt_masked`` guarantees).
    """
    T, C = x.shape
    m = flt.m
    xt = x.t()  # (C, T)
    ur = xt[:, None, :] * flt.w_in_r[None, :, None]  # (C, m, T)
    ui = xt[:, None, :] * flt.w_in_i[None, :, None]
    if inject_pos is not None:
        hit = torch.arange(T, device=x.device)[None, None, :] == inject_pos[:, None, None]
        ur = torch.where(hit, inject_wr[:, :, None], ur)
        ui = torch.where(hit, inject_wi[:, :, None], ui)
    w0_r, w0_i = flt.to_eigen(z_init)

    lam_r = flt.lam_r[None, :].expand(C, m).reshape(C * m)
    lam_i = flt.lam_i[None, :].expand(C, m).reshape(C * m)
    wr, wi = iir_scan(
        lam_r, lam_i, ur.reshape(C * m, T), ui.reshape(C * m, T),
        w0_r.reshape(C * m), w0_i.reshape(C * m), reverse=reverse,
    )
    wr, wi = wr.reshape(C, m, T), wi.reshape(C, m, T)

    # z0[t] = Re(c_out . w[t]) per channel
    z0 = (wr * flt.c_out_r[None, :, None] - wi * flt.c_out_i[None, :, None]).sum(dim=1)
    z0_init = (w0_r * flt.c_out_r[None, :] - w0_i * flt.c_out_i[None, :]).sum(dim=1)
    if reverse:
        # y[t] = b0 x[t] + Re(c_out . w[t+1]); w[T] = z_init-state (zero)
        z0_adj = torch.cat([z0[:, 1:], z0_init[:, None]], dim=1)
    else:
        z0_adj = torch.cat([z0_init[:, None], z0[:, :-1]], dim=1)
    return flt.b0 * x + z0_adj.t()


def lfilter(b, a, x: torch.Tensor, zi: Optional[torch.Tensor] = None) -> torch.Tensor:
    """scipy.signal.lfilter along axis 0 of ``x`` with shape (T,) or (T, C),
    computed in float32 and returned at x's dtype. ``zi`` is the initial
    DF2T state, (m,) or (C, m) (default zero)."""
    flt = device_filter(_key(b), _key(a), x.device)
    squeeze = x.dim() == 1
    xf = (x[:, None] if squeeze else x).to(torch.float32)
    C = xf.shape[1]
    z_init = (xf.new_zeros((C, flt.m)) if zi is None else
              torch.as_tensor(zi, dtype=torch.float32, device=x.device).expand(C, flt.m))
    y = _lfilter_core(flt, xf, z_init).to(x.dtype)
    return y[:, 0] if squeeze else y


def _default_padlen(b, a) -> int:
    return 3 * max(len(np.atleast_1d(a)), len(np.atleast_1d(b)))


def filtfilt(b, a, x: torch.Tensor, padlen: Optional[int] = None) -> torch.Tensor:
    """Zero-phase filtering of axis 0 of ``x`` ((T,) or (T, C)) with
    scipy.signal.filtfilt's defaults (method 'pad', padtype 'odd'): the
    odd extension, a forward pass from ``zi * ext[0]``, then the same over
    the reversed output. Computed in float32, returned at x's dtype."""
    flt = device_filter(_key(b), _key(a), x.device)
    p = _default_padlen(b, a) if padlen is None else padlen
    squeeze = x.dim() == 1
    xf = (x[:, None] if squeeze else x).to(torch.float32)
    T = xf.shape[0]
    if T <= p:
        raise ValueError(f"input length {T} must exceed padlen {p}")
    left = 2.0 * xf[0] - xf[1 : p + 1].flip(0)
    right = 2.0 * xf[-1] - xf[T - p - 1 : T - 1].flip(0)
    y = torch.cat([left, xf, right], dim=0)
    for _ in range(2):  # forward, then backward over the reversed output
        y = _lfilter_core(flt, y, flt.zi[None, :] * y[0][:, None]).flip(0)
    y = y[p : p + T].to(x.dtype)
    return y[:, 0] if squeeze else y


def filtfilt_masked(b, a, x: torch.Tensor, n) -> torch.Tensor:
    """filtfilt over the first ``n`` rows of a fixed-size (T_max, C) float32
    buffer, with scipy's defaults (odd extension, padlen 3*max(len(a), len(b))).

    ``n`` is an int or a (C,) integer tensor of per-column valid lengths.
    Rows [0, n) of each column of the result equal scipy.signal.filtfilt of
    that column's x[:n]; the remaining rows are unspecified.

    Everything stays front-aligned: the backward pass runs as an
    anti-causal scan (``iir_scan(reverse=True)``) on the forward output with
    its junk tail zeroed and the scipy ``zi * y[valid-1]`` initial state
    injected at the valid boundary, so no full-height reversal is needed.
    """
    T, C = x.shape
    device = x.device
    flt = device_filter(_key(b), _key(a), device)
    p = 3 * max(len(a), len(b))
    if T <= p:
        raise ValueError(f"input length {T} must exceed padlen {p}")
    nv = torch.as_tensor(n, dtype=torch.int64, device=device).expand(C)
    Text = T + 2 * p + 1  # +1 row so the state injection slot exists at n==T

    # odd extension: the left edge is static; the right edge is p rows at
    # per-column positions [n+p, n+2p): ext[n+p+j] = 2*x[n-1] - x[n-2-j]
    left = 2.0 * x[0][None, :] - x[1 : p + 1].flip(0)
    ext = torch.cat([left, x, x.new_zeros((p + 1, C))], dim=0)
    xn1 = torch.gather(x, 0, (nv - 1).clamp(0, T - 1)[None, :])  # (1, C)
    j = torch.arange(p, device=device)[:, None]
    src_rows = nv[None, :] - 2 - j  # (p, C)
    src = torch.gather(x, 0, src_rows.clamp(0, T - 1))
    src = torch.where(src_rows >= 0, src, 0.0)
    ext = ext.scatter(0, nv[None, :] + p + j, 2.0 * xn1 - src)
    valid = nv + 2 * p  # (C,) true extended length; rows beyond are junk

    z0 = flt.zi[None, :] * ext[0][:, None]
    y = _lfilter_core(flt, ext, z0)  # causal: rows [0, valid) correct

    # backward pass: zero the junk tail, inject zi * y[valid-1] at row
    # ``valid`` (u there and beyond is zero, so w[valid] equals it exactly)
    t_idx = torch.arange(Text, device=device)[:, None]
    yb = torch.where(t_idx < valid[None, :], y, 0.0)
    ylast = torch.gather(y, 0, (valid - 1)[None, :])[0]  # (C,)
    w_inj_r, w_inj_i = flt.to_eigen(flt.zi[None, :] * ylast[:, None])
    y2 = _lfilter_core(
        flt, yb, x.new_zeros((C, flt.m)), reverse=True,
        inject_pos=valid, inject_wr=w_inj_r, inject_wi=w_inj_i,
    )

    return y2[p : p + T]


# ---------------------------------------------------------------------------
# The reference front-end's specific chains
# ---------------------------------------------------------------------------

def remove_drift(x: torch.Tensor, fs: float = 1000.0, n=None) -> torch.Tensor:
    """3rd-order 2 Hz high-pass, zero-phase (reference read_emg.py:32-34),
    over the first ``n`` rows (``filtfilt_masked``) or, with ``n`` None,
    the whole length (``filtfilt``)."""
    b, a = design_highpass(3, 2.0, fs)
    return filtfilt(b, a, x) if n is None else filtfilt_masked(b, a, x, n)


def notch(x: torch.Tensor, freq: float, fs: float = 1000.0, n=None) -> torch.Tensor:
    """Q=30 notch, zero-phase (reference read_emg.py:36-38); ``n`` as in
    ``remove_drift``."""
    b, a = design_notch(freq, 30.0, fs)
    return filtfilt(b, a, x) if n is None else filtfilt_masked(b, a, x, n)


def notch_harmonics(x: torch.Tensor, freq: float = 60.0, fs: float = 1000.0,
                    n=None) -> torch.Tensor:
    """Notch at harmonics 1..7 of ``freq`` (reference read_emg.py:40-43)."""
    for harmonic in range(1, 8):
        x = notch(x, freq * harmonic, fs, n=n)
    return x
