"""Real-time dual-stream (EMG + microphone) capture.

Capability parity with the reference Recorder (record_data.py:54-184):
chunked audio/EMG/button buffers with per-chunk size bookkeeping, EMG
sample-counter continuity checking (the dropped-sample detector), button
press extraction from the digital-read rows, an optional live matplotlib
scope with a zero-phase-filtered preview, and ``get_data`` draining the
buffers into (emg, audio, button, chunk_sizes).

Counterpart of ``emg_tpu/collect/recorder.py``, a copy of it on the port's
own modules.
"""

from __future__ import annotations

import logging
import time
from typing import List, Tuple

import numpy as np
import scipy.signal

from emg_tpu_torch.collect.board import AudioInput, make_board

log = logging.getLogger(__name__)


def filter_signal(signals: np.ndarray, fs: float) -> np.ndarray:
    """Zero-phase notch-harmonic + drift filtering for the live scope
    (preview only; the training front-end uses the device kernels)."""
    result = np.zeros_like(signals)
    bhp, ahp = scipy.signal.butter(3, 2, "highpass", fs=fs)
    for i in range(signals.shape[1]):
        x = signals[:, i]
        for f in range(60, int(fs) // 2, 60):
            b, a = scipy.signal.iirnotch(f, 30, fs)
            x = scipy.signal.filtfilt(b, a, x)
        x = scipy.signal.filtfilt(bhp, ahp, x)
        result[:, i] = x
    return result


def get_last_sequence(chunk_list: List[np.ndarray], n: int, k: int,
                      do_filtering: bool, fs: float) -> np.ndarray:
    """Last n samples across chunks, left-zero-padded, optionally filtered."""
    selected = [np.zeros((0, k))]
    total = 0
    for chunk in reversed(chunk_list):
        selected.append(chunk)
        total += chunk.shape[0]
        if total > n:
            break
    selected.reverse()
    result = np.concatenate(selected, 0)[-n:, :]
    if do_filtering and result.shape[0] > 12:
        result = filter_signal(result, fs)
    if result.shape[0] < n:
        result = np.concatenate(
            [np.zeros((n - result.shape[0], result.shape[1])), result], 0
        )
    return result


class Recorder:
    def __init__(self, debug: bool = False, display: bool = False,
                 num_channels: int = None, wifi: bool = True):
        self.audio_stream = AudioInput(16000, synthetic=debug)
        board, sample_rate, emg_channels = make_board(debug, wifi, num_channels)
        self.board = board
        self.sample_rate = sample_rate
        self.emg_channels = emg_channels
        board.prepare_session()
        board.config_board("/3")  # digital read mode (button channel)
        board.start_stream()

        self.audio_data: List[np.ndarray] = []
        self.emg_data: List[np.ndarray] = []
        self.button_data: List[np.ndarray] = []
        self.debug = debug
        self.previous_sample_number = -1
        self.dropped_samples = 0

        self.display = display
        if display:
            self._setup_scope()

    def _setup_scope(self):  # pragma: no cover - needs a display
        import matplotlib.pyplot as plt
        from matplotlib.animation import FuncAnimation

        window = self.sample_rate * 5
        mult = int(16000 / self.sample_rate)
        plt.ion()
        fig, (audio_ax, emg_ax) = plt.subplots(2)
        audio_ax.axis((0, window * mult, -1, 1))
        emg_ax.axis((0, window, -300, 300))
        self._audio_lines = audio_ax.plot(np.zeros(window * mult))
        self._emg_lines = emg_ax.plot(np.zeros((window, len(self.emg_channels))))
        self._rms_text = emg_ax.text(50, -250, "RMS: 0")

        def update_plot(_):
            a = get_last_sequence(self.audio_data, window * mult, 1, False, self.sample_rate)
            self._audio_lines[0].set_ydata(a[:, 0])
            e = get_last_sequence(
                self.emg_data, window, len(self.emg_channels), True, self.sample_rate
            )
            for c, line in enumerate(self._emg_lines):
                line.set_ydata(e[:, c])
            self._rms_text.set_text(
                "RMS: " + str(e[-self.sample_rate * 2 : -self.sample_rate // 2].std())
            )
            return self._audio_lines + self._emg_lines

        self._ani = FuncAnimation(fig, update_plot, interval=30)
        self._plt = plt

    def update(self):
        """Poll both streams once; call frequently from the UI loop."""
        if self.display:  # pragma: no cover
            self._plt.gcf().canvas.draw_idle()
            self._plt.gcf().canvas.start_event_loop(0.005)
        else:
            time.sleep(0.005)

        current_audio = []
        while self.audio_stream.read_available > 0:
            data, overflowed = self.audio_stream.read(self.audio_stream.read_available)
            assert not overflowed, "audio stream overflow"
            current_audio.append(np.asarray(data))
        if not current_audio:
            return
        self.audio_data.append(np.concatenate(current_audio, 0))
        data = self.board.get_board_data()
        self.emg_data.append(data[self.emg_channels, :].T)

        # dropped-sample detection via the 8-bit sample counter
        for sn in data[0, :]:
            if self.previous_sample_number != -1 and sn != (self.previous_sample_number + 1) % 256:
                self.dropped_samples += 1
                log.warning("skip from %s to %s", self.previous_sample_number, sn)
            self.previous_sample_number = sn

        is_digital = data[12, :] == 193
        button = data[16, is_digital].astype(bool)
        self.button_data.append(button)
        if button.any():
            log.info("button pressed")

    def get_data(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray, list]:
        """Drain buffers -> (emg, audio, button, chunk_sizes)."""
        emg = (np.concatenate(self.emg_data, 0) if self.emg_data
               else np.zeros((0, len(self.emg_channels))))
        audio = (np.concatenate(self.audio_data, 0)[:, 0] if self.audio_data
                 else np.zeros(0))
        button = (np.concatenate(self.button_data, 0) if self.button_data
                  else np.zeros(0, bool))
        chunks = [
            (int(e.shape[0]), int(a.shape[0]), int(b.shape[0]))
            for e, a, b in zip(self.emg_data, self.audio_data, self.button_data)
        ]
        self.emg_data, self.audio_data, self.button_data = [], [], []
        return emg, audio, button, chunks

    def __enter__(self):
        self.audio_stream.start()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.audio_stream.stop()
        self.audio_stream.close()
        self.board.stop_stream()
        self.board.release_session()
