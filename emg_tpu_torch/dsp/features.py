"""Time-domain EMG featurization, in torch.

Counterpart of ``emg_tpu/dsp/features.py``. Per channel the reference
computes five frame-level time-domain features and a 16-point STFT
magnitude over frames of length 16 / hop 6 (center=False): low-frequency
envelope mean ``w_h``, envelope power ``p_w``, rectified high-frequency
power ``p_r``, zero-crossing rate ``z_p``, rectified mean ``r_h``, plus 9
STFT bins: 14 features x 8 channels = 112 dims (reference
data_utils.py:92-143).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

FRAME_LENGTH = 16
HOP_LENGTH = 6
N_FFT = 16
ZCR_THRESHOLD = 1e-10


def n_frames(n: int) -> int:
    """Number of center=False frames of length 16 / hop 6."""
    return 1 + (n - FRAME_LENGTH) // HOP_LENGTH


@functools.lru_cache(maxsize=None)
def _hann_window(n: int) -> np.ndarray:
    # periodic Hann (fftbins=True), as used by librosa.stft's default window
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)


@functools.lru_cache(maxsize=16)
def _device_window(dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_hann_window(N_FFT), dtype=dtype, device=device)


def _frame(x: torch.Tensor, num_frames: int) -> torch.Tensor:
    """Frame the time axis of (..., T, C) into (..., num_frames, FRAME_LENGTH, C)."""
    return x.unfold(-2, FRAME_LENGTH, HOP_LENGTH)[..., :num_frames, :, :].transpose(-1, -2)


def _valid_rows(x: torch.Tensor, n) -> torch.Tensor:
    """(..., T, 1) mask of the rows below ``n``: an int, or a tensor of the
    lengths of x's leading axes."""
    t = torch.arange(x.shape[-2], device=x.device)
    if isinstance(n, torch.Tensor):
        return (t < n[..., None])[..., None]
    return (t < n)[:, None]


def double_average(x: torch.Tensor, n) -> torch.Tensor:
    """Two passes of a 9-tap moving average, 'same' mode per pass
    (reference data_utils.py:92-97), over the first ``n`` rows of x
    (..., T, C); ``n`` as in ``get_emg_features_masked``.

    Each pass behaves as if the signal ended at row ``n``: the first pass
    spills nonzero values past ``n`` that the exact computation never sees,
    so they are re-zeroed between passes.
    """
    kernel = torch.full((1, 1, 9), 1.0 / 9.0, dtype=x.dtype, device=x.device)
    T, C = x.shape[-2:]

    def smooth(v):  # (..., T, C); symmetric kernel: correlation == convolution
        rows = v.transpose(-1, -2).reshape(-1, 1, T)
        return F.conv1d(rows, kernel, padding=4).reshape(v.shape[:-2] + (C, T)).transpose(-1, -2)

    v = smooth(x)
    v = torch.where(_valid_rows(x, n), v, 0.0)
    return smooth(v)


def get_emg_features(emg: torch.Tensor) -> torch.Tensor:
    """(T, C) filtered and resampled EMG -> (n_frames(T), 14*C) float32
    features over the whole length. Per channel the order is the
    reference's: the 5 time-domain features, then the 9 STFT bins."""
    x = emg - emg.mean(dim=0, keepdim=True)
    return _features_centered(x, n=x.shape[0])


def get_emg_features_masked(emg: torch.Tensor, n):
    """(T_max, C) buffer with ``n`` valid rows -> (features, num_valid_frames).

    With a leading batch axis, (U, T_max, C) and a (U,) integer tensor of
    lengths, it is the JAX package's ``jax.vmap(get_emg_features_masked)``:
    (U, F, 14*C) features and (U,) counts, computed on the buffer's device
    with no read back to the host.

    Feature rows past the count are computed from junk samples and must be
    dropped by the caller.
    """
    valid = 1 + (n - FRAME_LENGTH) // HOP_LENGTH
    # mean-center with a masked mean and zero the tail so the valid feature
    # rows match the exact-length computation ('same' mode zero-pads, which
    # the zeroed tail reproduces)
    mask = _valid_rows(emg, n)
    count = n.to(emg.dtype)[..., None, None] if isinstance(n, torch.Tensor) else n
    mean = torch.where(mask, emg, 0.0).sum(dim=-2, keepdim=True) / count
    x = torch.where(mask, emg - mean, 0.0)
    return _features_centered(x, n=n), valid


def _features_centered(x: torch.Tensor, n) -> torch.Tensor:
    T, C = x.shape[-2:]
    nf = n_frames(T)
    w = double_average(x, n=n)
    p = x - w
    r = p.abs()
    fw = _frame(w, nf)
    fp = _frame(p, nf)
    fr = _frame(r, nf)
    fx = _frame(x, nf)
    w_h = fw.mean(dim=-2)
    p_w = (fw * fw).mean(dim=-2).sqrt()
    p_r = (fr * fr).mean(dim=-2).sqrt()
    r_h = fr.mean(dim=-2)
    p_z = torch.where(fp.abs() <= ZCR_THRESHOLD, 0.0, fp)
    sign = torch.signbit(p_z)
    d = sign[..., 1:, :] != sign[..., :-1, :]
    crossings = torch.cat([d[..., :1, :], d], dim=-2)
    z_p = crossings.to(torch.float32).mean(dim=-2)
    window = _device_window(x.dtype, x.device)
    s = torch.fft.rfft(fx * window[:, None], n=N_FFT, dim=-2).abs()
    td = torch.stack([w_h, p_w, p_r, z_p, r_h], dim=-2)
    feats = torch.cat([td, s], dim=-2)  # (..., F, 14, C)
    return feats.transpose(-1, -2).reshape(x.shape[:-2] + (nf, 14 * C)).to(torch.float32)
