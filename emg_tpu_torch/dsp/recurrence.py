"""Parallel linear recurrences (the plain version of the IIR scan).

The DSP front-end's IIR filters run in each filter's eigenbasis as the
complex diagonal recurrence ``w[t] = lam * w[t-1] + u[t]`` (see
``dsp/filters.py``). ``hillis_steele_affine_last`` computes it as a
Hillis-Steele doubling scan of complex affine maps along the last axis, in
split real/imaginary float32 arithmetic: log2(T) shift-and-combine passes
of elementwise ops. It is the counterpart of
``emg_tpu/dsp/recurrence.py::_hillis_steele_affine_last`` and the plain
PyTorch version that ``ops/iir_scan.py`` holds its CUDA kernel against
(``diagonal_recurrence_plain``).

The JAX package's public forms are here too, as plain tensor code on the
inputs' device: ``linear_recurrence`` (a general (m, m) transition),
``diagonal_recurrence`` (time-major complex) and
``diagonal_recurrence_tlast`` (time in the last axis).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def linear_recurrence(A: torch.Tensor, u: torch.Tensor, z_init: torch.Tensor) -> torch.Tensor:
    """Run z[t] = A @ z[t-1] + u[t] for t = 0..T-1 in parallel.

    A: (m, m) constant transition matrix; u: (T, m) per-step inputs;
    z_init: (m,) initial state z[-1]. Returns the (T, m) states z[0..T-1].
    A Hillis-Steele doubling scan of the affine maps z -> A z + u[t], the
    matrix products at the inputs' full precision.
    """
    T, m = u.shape
    P = A.expand(T, m, m)
    B = u
    s = 1
    while s < T:
        # compose with the cumulative map at t-s (the identity shifts in)
        P_prev = torch.cat([torch.eye(m, dtype=A.dtype, device=A.device).expand(s, m, m),
                            P[: T - s]])
        B_prev = F.pad(B, (0, 0, s, 0))[:T]
        B = torch.einsum("tij,tj->ti", P, B_prev) + B
        P = torch.matmul(P, P_prev)
        s *= 2
    return torch.einsum("tij,j->ti", P, z_init) + B


def diagonal_recurrence(lam: torch.Tensor, u: torch.Tensor, w_init: torch.Tensor) -> torch.Tensor:
    """Run w[t] = lam * w[t-1] + u[t] (elementwise, complex) in parallel.

    lam: (m,) complex eigenvalues, |lam| < 1; u: (T, m) complex per-step
    inputs; w_init: (m,) complex initial state w[-1]. Returns the (T, m)
    complex states w[0..T-1].
    """
    return diagonal_recurrence_tlast(lam, u.t()[None], w_init[None])[0].t()


def diagonal_recurrence_tlast(lam: torch.Tensor, u: torch.Tensor,
                              w_init: torch.Tensor) -> torch.Tensor:
    """The diagonal recurrence batched, with time in the last axis.

    lam: (m,) complex eigenvalues; u: (C, m, T) complex per-step inputs;
    w_init: (C, m) complex initial states. Returns the (C, m, T) complex
    states, computed in split real/imaginary arithmetic
    (``hillis_steele_affine_last``).
    """
    C, m, T = u.shape
    lr = lam.real[None, :, None].expand(C, m, T)
    li = lam.imag[None, :, None].expand(C, m, T)
    pr, pi, br, bi = hillis_steele_affine_last(lr, li, u.real, u.imag)
    wr0, wi0 = w_init.real[:, :, None], w_init.imag[:, :, None]
    return torch.complex(pr * wr0 - pi * wi0 + br, pr * wi0 + pi * wr0 + bi)


def hillis_steele_affine_last(pr, pi, br, bi, reverse: bool = False):
    """Inclusive scan of complex affine maps (P, B) along the last axis.

    Element t holds the map x -> P[t] * x + B[t]; the result at t is the
    composition of the maps up to t (from the right with ``reverse=True``,
    the anti-causal ``w[t] = lam * w[t+1] + u[t]``). Shifted-in elements
    are the identity map (P = 1, B = 0).
    """
    T = pr.shape[-1]
    s = 1
    while s < T:
        # previous cumulative at t-s (t+s reversed); identity shifts in
        pad = (0, s) if reverse else (s, 0)
        sl = slice(s, None) if reverse else slice(None, T)
        pr_p = F.pad(pr, pad, value=1.0)[..., sl]
        pi_p = F.pad(pi, pad, value=0.0)[..., sl]
        br_p = F.pad(br, pad, value=0.0)[..., sl]
        bi_p = F.pad(bi, pad, value=0.0)[..., sl]
        # B = P * B_prev + B ; P = P * P_prev  (complex, expanded)
        br, bi = (
            pr * br_p - pi * bi_p + br,
            pr * bi_p + pi * br_p + bi,
        )
        pr, pi = (
            pr * pr_p - pi * pi_p,
            pr * pi_p + pi * pr_p,
        )
        s *= 2
    return pr, pi, br, bi


def diagonal_recurrence_plain(lam_r, lam_i, u_r, u_i, w0_r, w0_i, reverse: bool = False):
    """Rows of ``w[t] = lam * w[t-1] + u[t]`` from ``w[-1] = w0`` (or the
    anti-causal mirror from ``w[T] = w0``). lam/w0: (R,); u: (R, T).
    Returns (w_r, w_i), each (R, T) float32."""
    R, T = u_r.shape
    lr = lam_r[:, None].expand(R, T)
    li = lam_i[:, None].expand(R, T)
    pr, pi, br, bi = hillis_steele_affine_last(lr, li, u_r, u_i, reverse=reverse)
    wr = pr * w0_r[:, None] - pi * w0_i[:, None] + br
    wi = pr * w0_i[:, None] + pi * w0_r[:, None] + bi
    return wr, wi
