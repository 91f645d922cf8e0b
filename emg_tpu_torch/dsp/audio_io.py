"""Audio file IO and the audio-feature path.

The reference reads FLAC via soundfile, resamples 16 kHz -> 22.05 kHz via
librosa/soxr, and computes log-mels (data_utils.py:71-90). Here: WAV via the
stdlib, FLAC via soundfile when importable (gated), polyphase resampling via
scipy, mels via emg_tpu_torch.dsp.mel on the host.
"""

from __future__ import annotations

import wave
from typing import Optional, Tuple

import numpy as np
import scipy.signal

from emg_tpu_torch.dsp.mel import mel_spectrogram_np

def read_audio(filename: str) -> Tuple[np.ndarray, int]:
    """Return (float64 mono samples in [-1, 1], sample_rate)."""
    if filename.endswith(".wav"):
        with wave.open(filename, "rb") as w:
            rate = w.getframerate()
            n = w.getnframes()
            width = w.getsampwidth()
            channels = w.getnchannels()
            raw = w.readframes(n)
        if width == 2:
            data = np.frombuffer(raw, dtype="<i2").astype(np.float64) / 32768.0
        elif width == 4:
            data = np.frombuffer(raw, dtype="<i4").astype(np.float64) / 2147483648.0
        else:
            raise ValueError(f"unsupported wav sample width: {width}")
        if channels > 1:
            data = data.reshape(-1, channels)[:, 0]
        return data, rate
    try:  # optional dependency, imported at first use: present in full deployments
        import soundfile
    except ImportError:
        raise RuntimeError(
            f"reading {filename} requires the optional 'soundfile' package "
            "(only .wav is supported without it)"
        ) from None
    data, rate = soundfile.read(filename)
    if data.ndim > 1:
        data = data[:, 0]
    return data, rate


def normalize_volume(audio: np.ndarray, frame_length: int = 2048, hop_length: int = 512) -> np.ndarray:
    """RMS-based renormalization (reference data_utils.py:26-34)."""
    pad = frame_length // 2
    padded = np.pad(audio, pad, mode="constant")
    num = 1 + (len(padded) - frame_length) // hop_length
    idx = np.arange(num)[:, None] * hop_length + np.arange(frame_length)[None, :]
    rms = np.sqrt(np.mean(padded[idx] ** 2, axis=1))
    max_rms = rms.max() + 0.01
    audio = audio * (0.2 / max_rms)
    max_val = np.abs(audio).max()
    if max_val > 1.0:
        audio = audio / max_val
    return audio


def load_audio(
    filename: str,
    start: Optional[int] = None,
    end: Optional[int] = None,
    max_frames: Optional[int] = None,
    renormalize_volume: bool = False,
) -> np.ndarray:
    """File -> (frames, 80) log-mel features (reference data_utils.py:71-90)."""
    audio, r = read_audio(filename)
    if start is not None or end is not None:
        audio = audio[start:end]
    if renormalize_volume:
        audio = normalize_volume(audio)
    if r == 16000:
        # 22050/16000 = 441/320 polyphase resample (librosa-equivalent path)
        audio = scipy.signal.resample_poly(audio, 441, 320)
    else:
        assert r == 22050, f"unexpected sample rate {r}"
    audio = np.clip(audio, -1, 1)
    mspec = mel_spectrogram_np(audio.astype(np.float32), 1024, 80, 22050, 256, 1024, 0, 8000)
    if max_frames is not None and mspec.shape[0] > max_frames:
        mspec = mspec[:max_frames, :]
    return mspec
