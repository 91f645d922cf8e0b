"""Log-mel spectrogram front-end for the audio stream.

Matches the reference's mel_spectrogram (data_utils.py:46-69): reflect pad
by (n_fft - hop)/2, periodic-Hann STFT with center=False, magnitude
sqrt(re^2 + im^2 + 1e-9), Slaney-normalized mel filterbank (librosa
defaults: htk=False, norm='slaney'), then log(clamp(x, 1e-5)).
``mel_spectrogram`` runs on the signal's device; ``mel_spectrogram_np``,
its numpy twin, is what the host loader (``dsp/audio_io.py``) calls.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _hz_to_mel(f: np.ndarray) -> np.ndarray:
    """Slaney mel scale (librosa htk=False)."""
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3
    mels = f / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    with np.errstate(divide="ignore"):
        log_branch = min_log_mel + np.log(np.maximum(f, 1e-30) / min_log_hz) / logstep
    return np.where(f >= min_log_hz, log_branch, mels)


def _mel_to_hz(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3
    freqs = f_sp * m
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)


@functools.lru_cache(maxsize=None)
def mel_filterbank(
    sr: int = 22050,
    n_fft: int = 1024,
    n_mels: int = 80,
    fmin: float = 0.0,
    fmax: float = 8000.0,
) -> np.ndarray:
    """(n_mels, 1 + n_fft//2) triangular filterbank, Slaney-normalized."""
    fft_freqs = np.linspace(0, sr / 2, 1 + n_fft // 2)
    mel_pts = np.linspace(_hz_to_mel(np.array(fmin)), _hz_to_mel(np.array(fmax)), n_mels + 2)
    hz_pts = _mel_to_hz(mel_pts)

    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    weights = np.zeros((n_mels, len(fft_freqs)))
    for i in range(n_mels):
        lower = -ramps[i] / fdiff[i]
        upper = ramps[i + 2] / fdiff[i + 1]
        weights[i] = np.maximum(0, np.minimum(lower, upper))
    # Slaney normalization: each triangle integrates to ~constant energy
    enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _hann_periodic(n: int) -> np.ndarray:
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)).astype(np.float32)


def mel_spectrogram(
    y: torch.Tensor,
    n_fft: int = 1024,
    num_mels: int = 80,
    sampling_rate: int = 22050,
    hop_size: int = 256,
    win_size: int = 1024,
    fmin: float = 0.0,
    fmax: float = 8000.0,
) -> torch.Tensor:
    """(T,) float32 audio -> (frames, num_mels) log-mel features, on y's
    device."""
    pad = (n_fft - hop_size) // 2
    # reflect padding (torch 'reflect' excludes the edge sample)
    y = torch.cat([y[1 : pad + 1].flip(0), y, y[-pad - 1 : -1].flip(0)])
    frames = y.unfold(0, n_fft, hop_size)  # (frames, n_fft)
    window = torch.as_tensor(_hann_periodic(win_size), device=y.device)
    spec = torch.fft.rfft(frames * window, n=n_fft, dim=1)
    mag = torch.sqrt(spec.real ** 2 + spec.imag ** 2 + 1e-9)
    basis = torch.as_tensor(mel_filterbank(sampling_rate, n_fft, num_mels, fmin, fmax),
                            device=y.device)
    return torch.log(torch.clamp(mag @ basis.t(), min=1e-5))


def mel_spectrogram_np(
    y: np.ndarray,
    n_fft: int = 1024,
    num_mels: int = 80,
    sampling_rate: int = 22050,
    hop_size: int = 256,
    win_size: int = 1024,
    fmin: float = 0.0,
    fmax: float = 8000.0,
) -> np.ndarray:
    """(T,) audio -> (frames, num_mels) log-mel features, on the host."""
    pad = (n_fft - hop_size) // 2
    y = np.concatenate([y[1 : pad + 1][::-1], y, y[-pad - 1 : -1][::-1]])
    num_frames = 1 + (y.shape[0] - n_fft) // hop_size
    starts = np.arange(num_frames) * hop_size
    idx = starts[:, None] + np.arange(n_fft)[None, :]
    frames = y[idx] * _hann_periodic(win_size)
    spec = np.fft.rfft(frames, n=n_fft, axis=1)
    mag = np.sqrt(np.real(spec) ** 2 + np.imag(spec) ** 2 + 1e-9)
    mel = mag @ mel_filterbank(sampling_rate, n_fft, num_mels, fmin, fmax).T
    return np.log(np.clip(mel, 1e-5, None)).astype(np.float32)


def mel_frame_count(n_samples: int, n_fft: int = 1024, hop_size: int = 256) -> int:
    """The number of frames ``mel_spectrogram`` gives ``n_samples``."""
    padded = n_samples + 2 * ((n_fft - hop_size) // 2)
    return 1 + (padded - n_fft) // hop_size
