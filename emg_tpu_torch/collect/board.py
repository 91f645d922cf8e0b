"""Acquisition-board and microphone abstractions.

The reference records 8-channel EMG from an OpenBCI Cyton via brainflow
(WiFi at 1000 Hz / serial at 250 Hz / synthetic board for debugging) plus a
16 kHz sounddevice microphone stream (record_data.py:54-99). Hardware
packages are optional here: ``make_board``/``AudioInput`` use brainflow and
sounddevice when importable and fall back to fully synthetic sources (the
reference's ``debug`` board, generalized) so the capture pipeline is
testable anywhere.

Counterpart of ``emg_tpu/collect/board.py``, a copy of it on the port's
own modules.
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np


class SyntheticBoard:
    """Fake EMG board: smooth noise + mains hum + a sample counter channel,
    produced in real time. Mirrors the brainflow board surface the recorder
    needs (prepare/start/get_board_data/stop/release)."""

    def __init__(self, sample_rate: int = 1000, num_channels: int = 8, seed: int = 0):
        self.sample_rate = sample_rate
        self.num_channels = num_channels
        self.emg_channels = list(range(1, num_channels + 1))
        self._rng = np.random.default_rng(seed)
        self._last = None
        self._sample_counter = 0
        self._running = False

    def prepare_session(self):
        pass

    def config_board(self, cfg: str):
        pass

    def start_stream(self):
        self._running = True
        self._last = time.monotonic()

    def get_board_data(self) -> np.ndarray:
        """Rows: [sample_number, emg x C, ..., digital marker, ..., button]."""
        assert self._running
        now = time.monotonic()
        n = max(int((now - self._last) * self.sample_rate), 0)
        self._last = now
        rows = 17
        data = np.zeros((rows, n))
        sn = (self._sample_counter + np.arange(n)) % 256
        self._sample_counter += n
        data[0] = sn
        t = (self._sample_counter - n + np.arange(n)) / self.sample_rate
        for i, ch in enumerate(self.emg_channels):
            hum = 20 * np.sin(2 * np.pi * 60 * t + i)
            data[ch] = 100 * self._rng.normal(size=n) + hum
        data[12] = 193  # digital-read marker rows are always valid here
        data[16] = 0  # button not pressed
        return data

    def stop_stream(self):
        self._running = False

    def release_session(self):
        pass


class SyntheticAudio:
    """Fake microphone: silence + low noise, real-time paced."""

    def __init__(self, samplerate: int = 16000, seed: int = 1):
        self.samplerate = samplerate
        self._rng = np.random.default_rng(seed)
        self._last = None

    def start(self):
        self._last = time.monotonic()

    @property
    def read_available(self) -> int:
        if self._last is None:
            return 0
        return max(int((time.monotonic() - self._last) * self.samplerate), 0)

    def read(self, n: int) -> Tuple[np.ndarray, bool]:
        self._last = time.monotonic()
        return 0.001 * self._rng.normal(size=(n, 1)), False

    def stop(self):
        pass

    def close(self):
        pass


class AudioInput:
    """sounddevice InputStream when available, synthetic otherwise."""

    def __new__(cls, samplerate: int = 16000, synthetic: bool = False):
        if not synthetic:
            try:
                import sounddevice as sd

                return sd.InputStream(device=None, channels=1, samplerate=samplerate)
            except Exception:
                pass
        return SyntheticAudio(samplerate)


def make_board(debug: bool = False, wifi: bool = True, num_channels: Optional[int] = None):
    """Returns (board, sample_rate, emg_channels). Mirrors the reference's
    board selection (record_data.py:62-77): synthetic when debugging or when
    brainflow is unavailable, Cyton serial (250 Hz) or Cyton WiFi (1000 Hz)
    otherwise."""
    if not debug:
        try:
            from brainflow.board_shim import BoardIds, BoardShim, BrainFlowInputParams

            params = BrainFlowInputParams()
            if wifi:
                board_id = BoardIds.CYTON_WIFI_BOARD.value
                params.ip_port = 8001
                params.ip_address = "192.168.4.1"
                sample_rate = 1000
            else:
                board_id = BoardIds.CYTON_BOARD.value
                params.serial_port = "/dev/ttyUSB0"
                sample_rate = 250
            emg_channels = BoardShim.get_emg_channels(board_id)
            if num_channels is not None:
                emg_channels = emg_channels[:num_channels]
            board = BoardShim(board_id, params)
            return board, sample_rate, emg_channels
        except Exception:
            pass
    board = SyntheticBoard(sample_rate=256 if debug else 1000,
                           num_channels=num_channels or 8)
    return board, board.sample_rate, board.emg_channels
