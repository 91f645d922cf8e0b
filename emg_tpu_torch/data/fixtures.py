"""Synthetic corpus generator in the reference on-disk session format.

Produces session directories of ``{i}_emg.npy`` / ``{i}_audio_clean.wav`` /
``{i}_info.json`` files (reference data_collection/record_reading.py:30-52
writes the same layout, with flac audio), plus descriptions/ artifacts and a
testset split json — enough to drive the full train/eval stack end-to-end
without the (non-redistributable) real corpus.
"""

from __future__ import annotations

import json
import os
import wave
from typing import Dict, List, Sequence

import numpy as np

# a small closed vocabulary with hand-written ARPAbet pronunciations
FIXTURE_LEXICON: Dict[str, str] = {
    "THE": "DH AH", "CAT": "K AE T", "SAT": "S AE T", "ON": "AA N",
    "A": "AH", "MAT": "M AE T", "DOG": "D AO G", "RAN": "R AE N",
    "AND": "AE N D", "MAN": "M AE N", "MEN": "M EH N", "SAW": "S AO",
    "I": "AY", "ONE": "W AH N", "TWO": "T UW", "THREE": "TH R IY",
    "BIG": "B IH G", "RED": "R EH D", "SUN": "S AH N", "MOON": "M UW N",
    "IS": "IH Z", "HOT": "HH AA T", "COLD": "K OW L D", "RUN": "R AH N",
    "WE": "W IY", "GO": "G OW", "NOW": "N AW", "HOME": "HH OW M",
}

FIXTURE_SENTENCES: List[str] = [
    "the cat sat on a mat",
    "the dog ran home",
    "a big red sun",
    "the moon is cold",
    "we go now",
    "one man and two men",
    "I saw the dog run",
    "the sun is hot",
    "three men sat",
    "the big dog and the cat",
    "we ran on and on",
    "a man saw the moon",
]

PHONES_LINE = (
    "AA AE AH AO AW AY B CH D DH EH ER EY F G HH IH IX IY JH K L M N NG "
    "OW OY P R S SH T TH UH UW V W Y Z ZH"
)


def _write_wav(path: str, audio: np.ndarray, rate: int) -> None:
    pcm = np.clip(audio, -1, 1)
    pcm = (pcm * 32767).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(pcm.tobytes())


def _synth_emg(rng: np.random.Generator, n: int, channels: int = 8, sentence_id: int = 0) -> np.ndarray:
    """Plausible raw EMG: smooth envelope x noise + mains hum + drift."""
    t = np.arange(n) / 1000.0
    emg = np.zeros((n, channels))
    for c in range(channels):
        envelope = 1.0 + 0.5 * np.sin(2 * np.pi * (0.7 + 0.13 * c + 0.05 * sentence_id) * t)
        noise = rng.normal(size=n)
        # light smoothing for muscle-band content
        kernel = np.ones(4) / 4.0
        band = np.convolve(noise, kernel, mode="same")
        hum = 0.8 * np.sin(2 * np.pi * 60.0 * t + c)
        drift = 3.0 * np.sin(2 * np.pi * 0.3 * t + 0.4 * c)
        emg[:, c] = 120.0 * envelope * band + 20.0 * hum + 15.0 * drift
    return emg


def _synth_audio(rng: np.random.Generator, seconds: float, rate: int, voiced: bool) -> np.ndarray:
    n = int(seconds * rate)
    if not voiced:
        return 0.001 * rng.normal(size=n)
    t = np.arange(n) / rate
    f0 = 110 + 30 * np.sin(2 * np.pi * 0.8 * t)
    sig = 0.25 * np.sin(2 * np.pi * np.cumsum(f0) / rate)
    sig += 0.05 * rng.normal(size=n)
    return sig


def make_session(
    directory: str,
    sentences: Sequence[str],
    book: str,
    rng: np.random.Generator,
    voiced: bool,
    audio_rate: int = 22050,
    min_len: int = 1400,
    max_len: int = 2600,
    sentence_offset: int = 0,
) -> None:
    """Write one session directory with a leading silence clip (index 0,
    sentence_index = -1) followed by one utterance per sentence."""
    os.makedirs(directory, exist_ok=True)

    def write_clip(i: int, sentence_index: int, text: str, n_emg: int, is_voiced: bool):
        emg = _synth_emg(rng, n_emg, sentence_id=max(sentence_index, 0))
        np.save(os.path.join(directory, f"{i}_emg.npy"), emg)
        seconds = n_emg / 1000.0
        audio = _synth_audio(rng, seconds, audio_rate, is_voiced)
        _write_wav(os.path.join(directory, f"{i}_audio_clean.wav"), audio, audio_rate)
        info = {
            "book": book,
            "sentence_index": int(sentence_index),
            "text": text,
            "chunks": [[int(n_emg), int(len(audio)), 0]],
        }
        with open(os.path.join(directory, f"{i}_info.json"), "w") as f:
            json.dump(info, f)

    write_clip(0, -1, "", rng.integers(900, 1200), False)
    for k, sentence in enumerate(sentences):
        n_emg = int(rng.integers(min_len, max_len))
        write_clip(k + 1, sentence_offset + k, sentence, n_emg, voiced)


def make_synthetic_corpus(
    root: str,
    n_sentences: int = 8,
    seed: int = 0,
    dev_fraction: float = 0.25,
    test_fraction: float = 0.25,
) -> Dict[str, str]:
    """Create silent+voiced parallel sessions, a nonparallel voiced session,
    descriptions/ artifacts, and a testset split.

    Returns a dict of the created paths keyed like the reference flags
    (silent_data_directories, voiced_data_directories, testset_file, dict,
    phonesSet, vocabulary).
    """
    rng = np.random.default_rng(seed)
    sentences = [FIXTURE_SENTENCES[i % len(FIXTURE_SENTENCES)] for i in range(n_sentences)]
    book = "books/synthetic.txt"

    silent_root = os.path.join(root, "silent_parallel_data")
    voiced_root = os.path.join(root, "voiced_parallel_data")
    nonpar_root = os.path.join(root, "nonparallel_data")
    make_session(os.path.join(voiced_root, "sess0"), sentences, book, rng, voiced=True)
    make_session(os.path.join(silent_root, "sess1"), sentences, book, rng, voiced=False)
    extra = [FIXTURE_SENTENCES[(i + 3) % len(FIXTURE_SENTENCES)] for i in range(max(2, n_sentences // 2))]
    make_session(
        os.path.join(nonpar_root, "sess2"), extra, book, rng, voiced=True,
        sentence_offset=100,
    )

    desc = os.path.join(root, "descriptions")
    os.makedirs(desc, exist_ok=True)
    with open(os.path.join(desc, "phonesSet"), "w") as f:
        f.write(PHONES_LINE + "\n")
    with open(os.path.join(desc, "lexicon.txt"), "w") as f:
        for w, p in FIXTURE_LEXICON.items():
            f.write(f"{w}\t{p}\n")
    with open(os.path.join(desc, "vocabulary"), "w") as f:
        f.write(" ".join(FIXTURE_LEXICON.keys()) + "\n")

    # dev/test split over sentence indices (parallel sessions share them)
    n_test = max(1, int(n_sentences * test_fraction))
    n_dev = max(1, int(n_sentences * dev_fraction))
    idx = list(range(n_sentences))
    test_idx = idx[:n_test]
    dev_idx = idx[n_test : n_test + n_dev]
    testset = {
        "dev": [[book, i] for i in dev_idx],
        "test": [[book, i] for i in test_idx],
    }
    testset_file = os.path.join(root, "testset.json")
    with open(testset_file, "w") as f:
        json.dump(testset, f)

    return {
        "silent_data_directories": silent_root,
        "voiced_data_directories": f"{voiced_root},{nonpar_root}",
        "testset_file": testset_file,
        "dict": os.path.join(desc, "lexicon.txt"),
        "phonesSet": os.path.join(desc, "phonesSet"),
        "vocabulary": os.path.join(desc, "vocabulary"),
        "root": root,
    }


def make_reference_scale_corpus(
    root: str,
    seed: int = 0,
    n_sessions: int = 8,
    sentences_per_session: int = 500,
    n_dev: int = 200,
    n_test: int = 100,
    n_nonparallel: int = 355,
    min_len: int = 1400,
    max_len: int = 4200,
) -> Dict[str, str]:
    """The full-scale dress-rehearsal corpus: the reference's 8,055-train /
    200-dev / 100-test geometry (reference output/log.txt:1 'train / dev
    split: 8055 200') in the real session-directory layout.

    Default shape: 8 silent sessions x 500 sentences (300 of the sentence
    indices reserved for dev+test — each appears in ONE silent session) +
    8 parallel voiced sessions x 500 + one 355-utterance nonparallel voiced
    session. Voiced sessions are excluded from dev/test membership (the
    reference's exclude_from_testset rule), so
    train = (4000 - 300) silent + 4000 voiced + 355 nonparallel = 8055.
    """
    rng = np.random.default_rng(seed)
    book = "books/synthetic.txt"
    total = n_sessions * sentences_per_session

    silent_root = os.path.join(root, "silent_parallel_data")
    voiced_root = os.path.join(root, "voiced_parallel_data")
    nonpar_root = os.path.join(root, "nonparallel_data")
    for s in range(n_sessions):
        sents = [
            FIXTURE_SENTENCES[(s * sentences_per_session + i) % len(FIXTURE_SENTENCES)]
            for i in range(sentences_per_session)
        ]
        off = s * sentences_per_session
        make_session(os.path.join(voiced_root, f"sess{s:03d}v"), sents, book,
                     rng, voiced=True, min_len=min_len, max_len=max_len,
                     sentence_offset=off)
        make_session(os.path.join(silent_root, f"sess{s:03d}s"), sents, book,
                     rng, voiced=False, min_len=min_len, max_len=max_len,
                     sentence_offset=off)
    extra = [FIXTURE_SENTENCES[i % len(FIXTURE_SENTENCES)]
             for i in range(n_nonparallel)]
    make_session(os.path.join(nonpar_root, "sess_np"), extra, book, rng,
                 voiced=True, min_len=min_len, max_len=max_len,
                 sentence_offset=total)

    desc = os.path.join(root, "descriptions")
    os.makedirs(desc, exist_ok=True)
    with open(os.path.join(desc, "phonesSet"), "w") as f:
        f.write(PHONES_LINE + "\n")
    with open(os.path.join(desc, "lexicon.txt"), "w") as f:
        for w, p in FIXTURE_LEXICON.items():
            f.write(f"{w}\t{p}\n")
    with open(os.path.join(desc, "vocabulary"), "w") as f:
        f.write(" ".join(FIXTURE_LEXICON.keys()) + "\n")

    held = rng.choice(total, size=n_dev + n_test, replace=False)
    testset = {
        "dev": [[book, int(i)] for i in held[:n_dev]],
        "test": [[book, int(i)] for i in held[n_dev:]],
    }
    testset_file = os.path.join(root, "testset.json")
    with open(testset_file, "w") as f:
        json.dump(testset, f)

    return {
        "silent_data_directories": silent_root,
        "voiced_data_directories": f"{voiced_root},{nonpar_root}",
        "testset_file": testset_file,
        "dict": os.path.join(desc, "lexicon.txt"),
        "phonesSet": os.path.join(desc, "phonesSet"),
        "vocabulary": os.path.join(desc, "vocabulary"),
        "root": root,
    }
