"""A frozen copy of the scipy/numpy EMG front-end (``emg_tpu_torch/dsp/host_dsp.py``,
itself the reference read_emg.py:32-102 and data_utils.py:92-143 in
scipy calls), for the benchmark's reference: float64 throughout.
"""
from __future__ import annotations

import numpy as np
import scipy.signal as _signal

FRAME_LENGTH = 16
HOP_LENGTH = 6


def notch_harmonics(x: np.ndarray, freq: float = 60.0, fs: float = 1000.0) -> np.ndarray:
    """Zero-phase notches at harmonics 1..7 (reference read_emg.py:40-43)."""
    for harmonic in range(1, 8):
        b, a = _signal.iirnotch(freq * harmonic, 30, fs)
        x = _signal.filtfilt(b, a, x, axis=0)
    return x


def remove_drift(x: np.ndarray, fs: float = 1000.0) -> np.ndarray:
    """Zero-phase 3rd-order 2 Hz high-pass (reference read_emg.py:32-34)."""
    b, a = _signal.butter(3, 2, "highpass", fs=fs)
    return _signal.filtfilt(b, a, x, axis=0)


def subsample(x: np.ndarray, new_freq: float, old_freq: float) -> np.ndarray:
    """Linear-interp resample of (T, C) columns (reference read_emg.py:45-49)."""
    times = np.arange(x.shape[0]) / old_freq
    sample_times = np.arange(0, times[-1], 1 / new_freq)
    return np.stack(
        [np.interp(sample_times, times, x[:, c]) for c in range(x.shape[1])], axis=1
    )


def _frame(x: np.ndarray) -> np.ndarray:
    """(T,) -> (n_frames, FRAME_LENGTH) strided frames, hop 6."""
    n = 1 + (len(x) - FRAME_LENGTH) // HOP_LENGTH
    idx = np.arange(n)[:, None] * HOP_LENGTH + np.arange(FRAME_LENGTH)[None, :]
    return x[idx]


def double_average(x: np.ndarray) -> np.ndarray:
    """Two 9-tap 'same'-mode moving averages (reference data_utils.py:92-97)."""
    f = np.ones(9) / 9.0
    v = np.convolve(x, f, mode="same")
    return np.convolve(v, f, mode="same")


def get_emg_features(emg: np.ndarray) -> np.ndarray:
    """(T, C) -> (n_frames, 14*C): 5 time-domain features + 9 STFT magnitude
    bins per channel (reference data_utils.py:99-143)."""
    xs = emg - emg.mean(axis=0, keepdims=True)
    hann = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(FRAME_LENGTH) / FRAME_LENGTH)
    feats = []
    for i in range(emg.shape[1]):
        x = xs[:, i]
        w = double_average(x)
        p = x - w
        r = np.abs(p)
        fw = _frame(w)
        fr = _frame(r)
        w_h = fw.mean(axis=1)
        p_w = np.sqrt((fw ** 2).mean(axis=1))
        p_r = np.sqrt((fr ** 2).mean(axis=1))
        # zero-crossing rate with librosa's zero-clamp semantics
        fp = _frame(p).copy()
        fp[np.abs(fp) <= 1e-10] = 0
        sign = np.signbit(fp)
        d = sign[:, 1:] != sign[:, :-1]
        z_p = np.concatenate([d[:, :1], d], axis=1).mean(axis=1)
        r_h = fr.mean(axis=1)
        s = np.abs(np.fft.rfft(_frame(x) * hann, n=FRAME_LENGTH, axis=1))
        feats.append(np.stack([w_h, p_w, p_r, z_p, r_h], axis=1))
        feats.append(s)
    return np.concatenate(feats, axis=1).astype(np.float32)


def preprocess_emg_scipy(
    raw_emg: np.ndarray,
    before: np.ndarray,
    after: np.ndarray,
    remove_channels=(),
):
    """The full load_utterance DSP chain on the host.

    Returns (emg_features, emg, emg_orig) UN-truncated — (F, 14*C) features
    plus the 516.79 Hz and 689.06 Hz signals — mirroring the device
    pipeline's outputs before the caller's mfcc alignment slicing
    (`pipeline.align_lengths`).
    """
    x = np.concatenate([before, raw_emg, after], axis=0)
    x = notch_harmonics(x, 60.0, 1000.0)
    x = remove_drift(x, 1000.0)
    x = x[before.shape[0] : x.shape[0] - after.shape[0]]
    emg_orig = subsample(x, 689.06, 1000.0)
    emg = subsample(x, 516.79, 1000.0)
    for c in remove_channels:
        emg[:, int(c)] = 0.0
        emg_orig[:, int(c)] = 0.0
    feats = get_emg_features(emg)
    return feats, emg.astype(np.float32), emg_orig.astype(np.float32)


def training_input(raw: np.ndarray):
    """One utterance's training input from its raw 1 kHz EMG (no neighbour
    context), as the port's dataset builds it (read_emg.py:57-93, 426-427):
    the 689.06 Hz signal's rows [8, 8 + 8F) for the F feature frames, soft
    clipped. Returns (rows (8F, C) float32, F)."""
    x = remove_drift(notch_harmonics(raw.astype(np.float64), 60.0, 1000.0), 1000.0)
    emg_orig = subsample(x, 689.06, 1000.0)
    emg = subsample(x, 516.79, 1000.0)
    frames = 1 + (emg.shape[0] - FRAME_LENGTH) // HOP_LENGTH
    rows = emg_orig[8: 8 + 8 * frames].astype(np.float32) / np.float32(20.0)
    return (np.float32(50.0) * np.tanh(rows / np.float32(50.0))).astype(np.float32), frames
