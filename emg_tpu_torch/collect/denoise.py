"""Offline session audio cleaning: spectral noise reduction + volume
normalization (reference data_collection/clean_audio.py:9-63).

Per session: the leading silence clip (index 0) provides the noise profile;
every ``{i}_audio`` file is denoised by spectral gating against it (the role
the noisereduce package plays in the reference, implemented here directly),
resampled to 22050 Hz, volume-normalized against a +-20-clip smoothed
running maximum RMS, and written as ``{i}_audio_clean``.

Counterpart of ``emg_tpu/collect/denoise.py``, a copy of it on the port's
own modules.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np
import scipy.signal

from emg_tpu_torch.dsp.audio_io import read_audio


def _stft(x: np.ndarray, n_fft: int = 2048, hop: int = 512):
    window = np.hanning(n_fft + 1)[:-1]
    pad = n_fft // 2
    xp = np.pad(x, pad, mode="reflect")
    frames = 1 + (len(xp) - n_fft) // hop
    idx = np.arange(frames)[:, None] * hop + np.arange(n_fft)[None, :]
    return np.fft.rfft(xp[idx] * window, axis=1), window, pad


def _istft(spec: np.ndarray, window: np.ndarray, pad: int, length: int, hop: int = 512):
    n_fft = len(window)
    frames = spec.shape[0]
    out = np.zeros(pad * 2 + length + n_fft)
    norm = np.zeros_like(out)
    chunks = np.fft.irfft(spec, n=n_fft, axis=1) * window
    for i in range(frames):
        out[i * hop : i * hop + n_fft] += chunks[i]
        norm[i * hop : i * hop + n_fft] += window ** 2
    norm[norm < 1e-10] = 1e-10
    return (out / norm)[pad : pad + length]


def reduce_noise(audio: np.ndarray, noise: np.ndarray, n_std: float = 1.5,
                 prop_decrease: float = 1.0) -> np.ndarray:
    """Spectral gating: threshold = noise mean + n_std * noise std per
    frequency (dB); signal bins below it are attenuated with a smoothed
    time-frequency mask."""
    spec_noise, window, pad = _stft(noise)
    noise_db = 20 * np.log10(np.abs(spec_noise) + 1e-10)
    thresh = noise_db.mean(axis=0) + n_std * noise_db.std(axis=0)

    spec, window, pad = _stft(audio)
    sig_db = 20 * np.log10(np.abs(spec) + 1e-10)
    mask = sig_db < thresh[None, :]
    # smooth the mask over time and frequency so gating does not flutter
    kernel = np.outer(np.hanning(5)[1:-1], np.hanning(9)[1:-1])
    kernel /= kernel.sum()
    mask_f = scipy.signal.convolve2d(mask.astype(float), kernel, mode="same")
    gain = 1.0 - prop_decrease * np.clip(mask_f, 0, 1)
    return _istft(spec * gain, window, pad, len(audio))


def clean_directory(directory: str, target_rms: float = 0.2,
                    silent_cutoff: float = 0.02, smoothing_width: int = 20,
                    clip_to: float = 0.99) -> List[str]:
    """Denoise + normalize every audio clip of a session directory."""

    def audio_path(i: int):
        for ext in (".flac", ".wav"):
            p = os.path.join(directory, f"{i}_audio{ext}")
            if os.path.exists(p):
                return p
        return None

    silence_path = audio_path(0)
    assert silence_path is not None, "session must start with a silence clip"
    silence, _ = read_audio(silence_path)

    paths = []
    while (p := audio_path(len(paths))) is not None:
        paths.append(p)

    # per-clip maximum frame RMS for volume normalization
    def max_rms(x):
        frame, hop = 2048, 512
        if len(x) < frame:
            return float(np.sqrt(np.mean(x ** 2) + 1e-12))
        idx = np.arange(1 + (len(x) - frame) // hop)[:, None] * hop + np.arange(frame)
        return float(np.sqrt((x[idx] ** 2).mean(axis=1)).max())

    clips = []
    maxes = []
    for p in paths:
        audio, rate = read_audio(p)
        clips.append((audio, rate))
        maxes.append(max_rms(audio))

    smoothed, is_silent = [], False
    for i in range(len(maxes)):
        vs = [
            maxes[j]
            for j in range(max(0, i - smoothing_width), min(i + 1 + smoothing_width, len(maxes)))
            if maxes[j] > silent_cutoff
        ]
        if not vs:
            is_silent = True
            break
        smoothed.append(np.mean(vs))

    written = []
    for i, (p, (audio, rate)) in enumerate(zip(paths, clips)):
        clean = reduce_noise(audio, silence)
        if rate != 22050:
            clean = scipy.signal.resample_poly(clean, 22050, rate)
            rate = 22050
        if not is_silent:
            clean = clean * (target_rms / smoothed[i])
            mv = np.abs(clean).max()
            if mv > clip_to:
                clean = clean / mv * clip_to
        base = p.rsplit("_audio", 1)[0] + "_audio_clean"
        from emg_tpu_torch.collect.session import _write_audio

        written.append(_write_audio(base, clean, rate))
    return written
