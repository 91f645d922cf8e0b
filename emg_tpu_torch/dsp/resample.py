"""Linear-interpolation resampling (np.interp parity), in torch.

Counterpart of ``emg_tpu/dsp/resample.py``. The reference subsamples
filtered EMG from 1000 Hz to 689.06 Hz (raw path) and 516.79 Hz (feature
path) with np.interp over a uniform grid (reference read_emg.py:45-49).
Here it is a gather + lerp over a grid computed in float64 on the host
once per (buffer length, rates, device) and kept on the device, so a call
copies nothing to the card.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def subsample_length(n: int, new_freq: float, old_freq: float) -> int:
    """Output length of the reference's np.arange(0, (n-1)/old, 1/new) grid."""
    times_end = np.float64(n - 1) / np.float64(old_freq)
    return int(np.arange(0, times_end, 1.0 / np.float64(new_freq)).shape[0])


@functools.lru_cache(maxsize=64)
def _grid(T: int, new_freq: float, old_freq: float, device: torch.device):
    """The interpolation grid of a (T, ...) buffer: each output row's lower
    input row (int64) and its fraction (float32), on ``device``."""
    M = subsample_length(T, new_freq, old_freq)  # max possible output length
    sample_times = np.arange(M, dtype=np.float64) / np.float64(new_freq)
    pos = sample_times * np.float64(old_freq)
    i0 = np.floor(pos).astype(np.int64)
    frac = (pos - i0).astype(np.float32)
    return torch.as_tensor(i0, device=device), torch.as_tensor(frac, device=device)


def subsample(x: torch.Tensor, new_freq: float, old_freq: float) -> torch.Tensor:
    """Resample axis 0 of ``x`` ((T,) or (T, C)) by linear interpolation,
    at the exact length (``subsample_length``): the masked form with every
    row valid."""
    return subsample_masked(x, x.shape[0], new_freq, old_freq)[0]


def subsample_masked(x: torch.Tensor, n, new_freq: float, old_freq: float):
    """Resample axis 0 of a fixed (T_max, ...) buffer as if the signal were
    x[:n]. Returns (out, out_len); rows of ``out`` at or beyond ``out_len``
    are unspecified.

    ``n`` is an int, or a (C,) integer tensor of per-column valid lengths of
    a (T_max, C) buffer (unequal-length utterances folded onto the channel
    axis), and then ``out_len`` is a (C,) tensor.
    """
    i0_static, frac = _grid(x.shape[0], float(new_freq), float(old_freq), x.device)
    # where i0 is clipped to n-1 the true position lies past the end; with
    # i0 == i1 == n-1 the lerp degenerates to x[n-1] regardless of frac
    if isinstance(n, torch.Tensor):
        if x.dim() != 2 or n.shape != (x.shape[1],):
            raise ValueError(f"per-column lengths {tuple(n.shape)} do not fit a buffer "
                             f"{tuple(x.shape)}")
        last = (n.to(torch.int64) - 1)[None, :]
        i0 = i0_static[:, None].clamp(min=0).minimum(last)
        i1 = (i0 + 1).minimum(last)
        x0 = torch.gather(x, 0, i0)
        x1 = torch.gather(x, 0, i1)
    else:
        i0 = i0_static.clamp(0, n - 1)
        i1 = (i0 + 1).clamp(0, n - 1)
        x0 = x.index_select(0, i0)
        x1 = x.index_select(0, i1)
    frac = frac.reshape((-1,) + (1,) * (x.dim() - 1))
    out = x0 + (x1 - x0) * frac
    return out, masked_output_length(n, new_freq, old_freq)


def masked_output_length(n, new_freq: float, old_freq: float):
    """len(np.arange(0, (n-1)/old_freq, 1/new_freq)), in the JAX package's
    exact-rational form ceil((n-1) * new/old) for centihertz rates.

    ``n`` is an int (returns an int) or an integer tensor (returns an int64
    tensor on its device, computed there)."""
    is_tensor = isinstance(n, torch.Tensor)
    num = round(float(new_freq) * 100)
    den = round(float(old_freq) * 100)
    if (abs(num - float(new_freq) * 100) > 1e-9
            or abs(den - float(old_freq) * 100) > 1e-9
            or den % 1000 != 0):
        # float math for non-centihertz rates, in float32 as JAX's
        if is_tensor:
            return torch.ceil((n - 1).to(torch.float32) / np.float32(old_freq)
                              * np.float32(new_freq)).to(torch.int64)
        return int(np.ceil(np.float32(n - 1) / np.float32(old_freq) * np.float32(new_freq)))
    a = n.to(torch.int64) - 1 if is_tensor else n - 1
    a_hi, a_lo = a // 1000, a % 1000
    X = a_hi * num
    Y = a_lo * num
    scale = den // 1000
    W = X + Y // 1000
    s = Y % 1000
    q, r = W // scale, W % scale
    if is_tensor:
        return q + ((r > 0) | (s > 0)).to(torch.int64)
    return q + int((r > 0) or (s > 0))
