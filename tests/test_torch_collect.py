"""The port's capture layer (``emg_tpu_torch.collect``) on the synthetic
board, against the JAX package's.

The counterparts of tests/test_collect.py's six tests (streaming, the last
sequence, the book's bookmark, a session's files, the denoiser's gating,
and capture -> clean -> dataset), plus:
- ``reduce_noise`` and the live scope's ``filter_signal`` equal JAX's
  bitwise on the same inputs;
- a session the port records and cleans is cleaned bitwise as JAX's
  ``clean_directory`` cleans it, and the port's ``EMGDataset`` (CPU,
  ``data.dsp_backend="scipy"``) loads it bitwise as JAX's ``EMGDataset``
  does.
"""

import json
import os
import shutil

import numpy as np
import pytest

from emg_tpu.collect import denoise as jax_denoise
from emg_tpu.collect import recorder as jax_recorder

from emg_tpu_torch.collect import (
    Book,
    Recorder,
    RecordingSession,
    clean_directory,
    filter_signal,
    get_last_sequence,
    reduce_noise,
)
from emg_tpu_torch.config import Config
from emg_tpu_torch.data.dataset import EMGDataset
from tests.test_torch_model import one_torch_thread  # noqa: F401

LEXICON = os.path.join(os.path.dirname(__file__), "fixtures", "lexicon.txt")


def test_synthetic_recorder_streams():
    with Recorder(debug=True) as r:
        for _ in range(12):
            r.update()
        emg, audio, button, chunks = r.get_data()
    assert emg.shape[0] > 0 and emg.shape[1] == 8
    assert audio.shape[0] > 0
    assert len(chunks) > 0
    assert all(len(c) == 3 for c in chunks)
    assert r.dropped_samples == 0  # synthetic counter is continuous


def test_get_last_sequence_pads_and_trims():
    chunks = [np.ones((30, 2)), 2 * np.ones((50, 2))]
    out = get_last_sequence(chunks, 60, 2, False, 1000)
    assert out.shape == (60, 2)
    np.testing.assert_allclose(out[-50:], 2.0)
    out = get_last_sequence([np.ones((10, 2))], 60, 2, False, 1000)
    assert out.shape == (60, 2)
    np.testing.assert_allclose(out[:50], 0.0)


def test_book_bookmark(tmp_path):
    book_file = tmp_path / "book.txt"
    book_file.write_text("First sentence. Second one! Third?\n\nFourth paragraph.")
    with Book(str(book_file)) as b:
        assert len(b.sentences) == 4
        assert b.current_sentence().startswith("First")
        b.next()
        b.next()
    with Book(str(book_file)) as b2:  # the bookmark persisted
        assert b2.current_index == 2
        assert b2.current_sentence().startswith("Third")


def test_recording_session_files(tmp_path):
    book_file = tmp_path / "book.txt"
    book_file.write_text("The cat sat. A dog ran. We go now.")
    out = tmp_path / "session"
    with Recorder(debug=True) as r, Book(str(book_file)) as book:
        session = RecordingSession(str(out), book, r)
        session.begin()
        for _ in range(6):
            r.update()
        session.next()  # writes 0_* (silence)
        for _ in range(6):
            r.update()
        session.next()  # writes 1_* (first sentence)
        for _ in range(6):
            r.update()
        session.restart()  # writes two silence boundary clips
        session.quit()

    files = sorted(os.listdir(out))
    assert "0_info.json" in files and "1_info.json" in files
    info0 = json.load(open(out / "0_info.json"))
    assert info0["sentence_index"] == -1
    info1 = json.load(open(out / "1_info.json"))
    assert info1["sentence_index"] == 0
    assert info1["text"].startswith("The cat")
    assert sum(c[0] for c in info1["chunks"]) == np.load(out / "1_emg.npy").shape[0]
    # restart wrote silence clips 2 and 3, quit wrote 4
    assert json.load(open(out / "2_info.json"))["sentence_index"] == -1
    assert json.load(open(out / "4_info.json"))["sentence_index"] == -1
    assert {f.split("_", 1)[1] for f in files} == {"emg.npy", "audio.wav", "button.npy",
                                                   "info.json"}


def test_reduce_noise_attenuates_noise_floor():
    rng = np.random.default_rng(0)
    rate = 16000
    noise = 0.05 * rng.normal(size=rate)
    t = np.arange(rate) / rate
    tone = 0.5 * np.sin(2 * np.pi * 440 * t)
    noisy = tone + 0.05 * rng.normal(size=rate)
    clean = reduce_noise(noisy, noise)
    assert np.abs(clean).max() > 0.2  # the tone largely kept
    np.testing.assert_array_equal(clean, jax_denoise.reduce_noise(noisy, noise))
    quiet = 0.05 * rng.normal(size=rate)
    cleaned_quiet = reduce_noise(quiet, noise, n_std=1.0, prop_decrease=0.8)
    assert np.sqrt((cleaned_quiet ** 2).mean()) < 0.5 * np.sqrt((quiet ** 2).mean())
    np.testing.assert_array_equal(
        cleaned_quiet, jax_denoise.reduce_noise(quiet, noise, n_std=1.0, prop_decrease=0.8))


@pytest.mark.parametrize("fs", [250.0, 1000.0])
def test_filter_signal_equals_jax(fs):
    signals = 100 * np.random.default_rng(int(fs)).normal(size=(400, 3))
    got = filter_signal(signals, fs)
    np.testing.assert_array_equal(got, jax_recorder.filter_signal(signals, fs))
    tail = get_last_sequence([signals[:150], signals[150:]], 500, 3, True, fs)
    np.testing.assert_array_equal(tail[100:], got)
    np.testing.assert_array_equal(tail[:100], 0.0)


def record_session(tmp_path, updates=(10, 80)):
    """A session on the synthetic board: a silence clip, one utterance per
    entry of ``updates`` after the first (that many polls each), and the
    final silence clip."""
    book_file = tmp_path / "book.txt"
    book_file.write_text("The cat sat on a mat. The dog ran.")
    out = tmp_path / "sess0"
    with Recorder(debug=True) as r, Book(str(book_file)) as book:
        session = RecordingSession(str(out), book, r)
        session.begin()
        for n in updates:
            for _ in range(n):
                r.update()
            session.next()
        session.quit()
    return out


def dataset_config(cls, backend="scipy"):
    cfg = cls()
    cfg.paths.dict = LEXICON
    cfg.data.dsp_backend = backend
    return cfg


def test_clean_directory_and_dataset_roundtrip(tmp_path):
    """Record with the synthetic board, denoise, then load the session with
    the port's EMGDataset on the CPU: the capture-to-training-data path,
    cleaned and loaded bitwise as the JAX package's."""
    from emg_tpu.config import Config as JaxConfig
    from emg_tpu.data.dataset import EMGDataset as JaxEMGDataset

    out = record_session(tmp_path)
    jax_out = tmp_path / "sess0_jax"
    shutil.copytree(out, jax_out)
    written = clean_directory(str(out))
    jax_written = jax_denoise.clean_directory(str(jax_out))
    assert any(w.endswith(("_audio_clean.wav", "_audio_clean.flac")) for w in written)
    assert [os.path.basename(w) for w in written] == [os.path.basename(w) for w in jax_written]
    for w, j in zip(written, jax_written):
        with open(w, "rb") as a, open(j, "rb") as b:
            assert a.read() == b.read(), w

    ds = EMGDataset(dataset_config(Config), base_dir=str(out), no_testset=True,
                    no_normalizers=True, device="cpu")
    ref = JaxEMGDataset(dataset_config(JaxConfig), base_dir=str(out), no_testset=True,
                        no_normalizers=True)
    assert len(ds) == len(ref) >= 1
    ex = ds[0]
    assert ex["emg"].shape[1] == 112
    assert ex["phonemes_int"][0] == 41
    for i in range(len(ds)):
        got, want = ds[i], ref[i]
        assert sorted(got) == sorted(want)
        for key, value in want.items():
            if isinstance(value, np.ndarray):
                assert value.dtype == got[key].dtype, key
                np.testing.assert_array_equal(got[key], value, err_msg=key)
            else:
                assert got[key] == value, key
