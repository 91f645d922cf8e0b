"""Recording sessions: prompt sentences, capture, write session files.

The on-disk contract matches the reference exactly
(record_reading.py:30-52): per utterance ``{i}_emg.npy``, ``{i}_audio.flac``
(or ``.wav`` without the soundfile package), ``{i}_button.npy`` and
``{i}_info.json`` with {book, sentence_index, text, chunks}; silence
boundary clips carry ``sentence_index = -1``. The key protocol is the
reference's (q quit / n or space next / r restart), driven either by the
curses UI (``run_curses``) or programmatically (``RecordingSession`` —
also how tests exercise it headlessly).

Counterpart of ``emg_tpu/collect/session.py``, a copy of it on the port's
own modules.
"""

from __future__ import annotations

import json
import os
import wave
from typing import Optional, Tuple

import numpy as np

from emg_tpu_torch.collect.book import Book
from emg_tpu_torch.collect.recorder import Recorder


def _write_audio(path_base: str, audio: np.ndarray, rate: int) -> str:
    try:
        import soundfile as sf

        path = path_base + ".flac"
        sf.write(path, audio, rate)
        return path
    except Exception:
        path = path_base + ".wav"
        pcm = (np.clip(audio, -1, 1) * 32767).astype("<i2")
        with wave.open(path, "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(rate)
            w.writeframes(pcm.tobytes())
        return path


def save_data(output_directory: str, output_idx: int, data, book: Optional[Book],
              audio_rate: int = 16000) -> None:
    emg, audio, button, chunk_info = data
    emg_file = os.path.join(output_directory, f"{output_idx}_emg.npy")
    assert not os.path.exists(emg_file), "trying to overwrite existing file"
    np.save(emg_file, emg)
    _write_audio(os.path.join(output_directory, f"{output_idx}_audio"), audio, audio_rate)
    np.save(os.path.join(output_directory, f"{output_idx}_button.npy"), button)

    if book is None:  # silence segment
        bf, bi, t = "", -1, ""
    else:
        bf, bi, t = book.file, book.current_index, book.current_sentence()
    with open(os.path.join(output_directory, f"{output_idx}_info.json"), "w") as f:
        json.dump({"book": bf, "sentence_index": bi, "text": t, "chunks": chunk_info}, f)


def get_ends(data) -> Tuple[tuple, tuple]:
    """Split off 500-sample silence clips from the segment boundaries."""
    emg, audio, button, chunk_info = data
    dummy_audio = np.zeros(8000)
    dummy_button = np.zeros(500, bool)
    info = [(500, 8000, 500)]
    return (
        (emg[:500, :], dummy_audio, dummy_button, info),
        (emg[-500:, :], dummy_audio, dummy_button, info),
    )


class RecordingSession:
    """Headless session state machine (UI-independent)."""

    def __init__(self, output_directory: str, book: Book, recorder: Recorder):
        os.makedirs(output_directory, exist_ok=False)
        self.output_directory = output_directory
        self.book = book
        self.recorder = recorder
        self.output_idx = 0
        self.recording = False

    def begin(self):
        """First keypress: start recording the leading silence clip."""
        self.recording = True
        self.recorder.get_data()  # clear buffers

    def next(self) -> str:
        """'n' / space: save the current segment and advance."""
        data = self.recorder.get_data()
        if self.output_idx == 0:
            save_data(self.output_directory, 0, data, None)
        else:
            save_data(self.output_directory, self.output_idx, data, self.book)
            self.book.next()
        self.output_idx += 1
        return self.book.current_sentence()

    def restart(self):
        """'r': discard the segment, bracketing it with silence clips."""
        if self.output_idx == 0:
            self.recorder.get_data()
            return
        start_data, end_data = get_ends(self.recorder.get_data())
        save_data(self.output_directory, self.output_idx, start_data, None)
        self.output_idx += 1
        save_data(self.output_directory, self.output_idx, end_data, None)
        self.output_idx += 1

    def quit(self):
        """'q': save a final silence clip and stop."""
        start_data, _ = get_ends(self.recorder.get_data())
        save_data(self.output_directory, self.output_idx, start_data, None)
        self.recording = False


def run_curses(output_directory: str, book_file: str, debug: bool = False):  # pragma: no cover
    """Interactive curses UI (reference record_reading.py:64-119)."""
    import curses
    import textwrap

    def main(stdscr):
        curses.curs_set(False)
        stdscr.nodelay(True)
        text_win = curses.newwin(curses.LINES - 1, curses.COLS, 0, 0)

        def show(sentence):
            h, w = text_win.getmaxyx()
            text_win.clear()
            for i, line in enumerate(textwrap.wrap(sentence, w)):
                if i >= h:
                    break
                text_win.addstr(i, 0, line)
            text_win.refresh()

        with Recorder(debug=debug) as r, Book(book_file) as book:
            session = RecordingSession(output_directory, book, r)
            stdscr.clear()
            stdscr.addstr(0, 0, "<Press any key to begin.>")
            stdscr.refresh()
            while True:
                r.update()
                c = stdscr.getch()
                if not session.recording:
                    if c >= 0:
                        session.begin()
                        stdscr.addstr(
                            curses.LINES - 1, 0,
                            "Type 'q' to quit, 'n' or ' ' for next, 'r' to restart segment",
                        )
                        show("<silence>")
                        stdscr.refresh()
                elif c == ord("q"):
                    session.quit()
                    break
                elif c in (ord("n"), ord(" ")):
                    show(session.next())
                elif c == ord("r"):
                    session.restart()

    curses.wrapper(main)
