"""EMG corpus reader: session directories -> preprocessed utterances.

Counterpart of ``emg_tpu/data/dataset.py``, mirroring the reference
EMGDataset (read_emg.py:340-517): directory scan with dev/test split
membership, silent->voiced target aliasing (the "heterogeneous data"
mechanism: silent EMG borrows phoneme targets and audio features from the
parallel voiced recording of the same sentence), per-utterance DSP through
``emg_tpu_torch.dsp.pipeline`` on the dataset's device, normalizer and tanh
soft-clip transforms, and a collate function. ``data.dsp_backend`` picks
the DSP as the JAX package does: the device pipeline, or the scipy host
front-end (``dsp/host_dsp.py``), which "auto" takes for a dataset on the
CPU.
"""

from __future__ import annotations

import copy
import json
import logging
import os
import random
import re
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from emg_tpu_torch.config import Config
from emg_tpu_torch.runtime import resolve_device
from emg_tpu_torch.dsp.audio_io import load_audio
from emg_tpu_torch.dsp.host_dsp import HAVE_SCIPY, preprocess_emg_scipy
from emg_tpu_torch.dsp.normalizer import FeatureNormalizer, load_normalizers, save_normalizers
from emg_tpu_torch.dsp.pipeline import preprocess_emg, align_lengths
from emg_tpu_torch.text.normalize import load_pron_dict, read_phonemes
from emg_tpu_torch.text.phonemes import PhoneTransform, TextTransform

log = logging.getLogger(__name__)

# input-length buckets of the DSP buffers (the JAX package's buckets, so
# both packages filter identical buffers)
_DSP_BUCKETS = [4096, 8192, 16384, 32768, 65536, 131072]


def _dsp_bucket(n: int) -> int:
    for b in _DSP_BUCKETS:
        if n <= b:
            return b
    raise ValueError(f"utterance too long for DSP buckets: {n}")


class EMGDirectory:
    def __init__(self, session_index: int, directory: str, silent: bool,
                 exclude_from_testset: bool = False):
        self.session_index = session_index
        self.directory = directory
        self.silent = silent
        self.exclude_from_testset = exclude_from_testset

    def __lt__(self, other):
        return self.session_index < other.session_index

    def __repr__(self):
        return self.directory


def dsp_input(raw_emg: np.ndarray, before: np.ndarray, after: np.ndarray):
    """Lay neighbor-before ++ utterance ++ neighbor-after into a zeroed
    bucket-length float32 buffer. Returns (buf, n_total, n_before, n_after)
    as ``preprocess_emg`` takes them."""
    n_total = before.shape[0] + raw_emg.shape[0] + after.shape[0]
    buf = np.zeros((_dsp_bucket(n_total), raw_emg.shape[1]), np.float32)
    buf[: before.shape[0]] = before
    buf[before.shape[0] : before.shape[0] + raw_emg.shape[0]] = raw_emg
    buf[before.shape[0] + raw_emg.shape[0] : n_total] = after
    return buf, n_total, before.shape[0], after.shape[0]


def _audio_path(base_dir: str, index: int) -> str:
    for ext in (".flac", ".wav"):
        p = os.path.join(base_dir, f"{index}_audio_clean{ext}")
        if os.path.exists(p):
            return p
    raise FileNotFoundError(f"no audio for {base_dir}/{index}")


class EMGDataset:
    """Session-directory dataset with the reference's split semantics."""

    def __init__(
        self,
        config: Config,
        base_dir: Optional[str] = None,
        limit_length: bool = False,
        dev: bool = False,
        test: bool = False,
        no_testset: bool = False,
        no_normalizers: bool = False,
        device="cuda",
    ):
        self.config = config
        self.device = resolve_device(device)
        dcfg = config.data

        if no_testset:
            devset, testset = [], []
        else:
            with open(dcfg.testset_file) as f:
                testset_json = json.load(f)
                devset = testset_json["dev"]
                testset = testset_json["test"]

        directories: List[EMGDirectory] = []
        if base_dir is not None:
            directories.append(EMGDirectory(0, base_dir, False))
        else:
            for sd in dcfg.silent_data_directories:
                for session_dir in sorted(os.listdir(sd)):
                    directories.append(
                        EMGDirectory(len(directories), os.path.join(sd, session_dir), True)
                    )
            has_silent = len(dcfg.silent_data_directories) > 0
            for vd in dcfg.voiced_data_directories:
                for session_dir in sorted(os.listdir(vd)):
                    directories.append(
                        EMGDirectory(
                            len(directories), os.path.join(vd, session_dir), False,
                            exclude_from_testset=has_silent,
                        )
                    )

        self.example_indices: List[Tuple[EMGDirectory, int]] = []
        self.voiced_data_locations: Dict[Tuple[str, int], Tuple[EMGDirectory, int]] = {}
        for directory_info in directories:
            for fname in os.listdir(directory_info.directory):
                m = re.match(r"(\d+)_info.json", fname)
                if m is None:
                    continue
                with open(os.path.join(directory_info.directory, fname)) as f:
                    info = json.load(f)
                if info["sentence_index"] < 0:  # silence boundary clips
                    continue
                loc = [info["book"], info["sentence_index"]]
                in_test = loc in testset
                in_dev = loc in devset
                if (
                    (test and in_test and not directory_info.exclude_from_testset)
                    or (dev and in_dev and not directory_info.exclude_from_testset)
                    or (not test and not dev and not in_test and not in_dev)
                ):
                    self.example_indices.append((directory_info, int(m.group(1))))
                if not directory_info.silent:
                    self.voiced_data_locations[(info["book"], info["sentence_index"])] = (
                        directory_info, int(m.group(1))
                    )

        # deterministic order: sort then seed-0 shuffle (read_emg.py:388-390)
        self.example_indices.sort(key=lambda e: (e[0].session_index, e[1]))
        random.Random(0).shuffle(self.example_indices)

        self.pron_dict = load_pron_dict(config.paths.dict)
        self.no_normalizers = no_normalizers
        if not no_normalizers:
            self.mfcc_norm, self.emg_norm = load_normalizers(dcfg.normalizers_file)

        self.limit_length = limit_length
        self.num_sessions = len(directories)
        self.text_transform = TextTransform()
        self.phone_transform = PhoneTransform()
        # bounded LRU over loaded examples. The reference caches every
        # example forever (read_emg.py:422 lru_cache(maxsize=None)) — at the
        # real corpus scale (8,055 train utterances x ~400 KB of mfccs +
        # features + raw EMG) that is multi-GB host RSS before epoch 1 ends,
        # so this rebuild evicts least-recently-used examples past a byte
        # budget (data.cache_bytes; 0 disables caching).
        self._cache: "OrderedDict[int, dict]" = OrderedDict()
        self._cache_bytes = 0
        self._cache_budget = int(dcfg.cache_bytes)
        self._host_dsp = None  # resolved by the first _use_host_dsp()

        sample = self.load_utterance(*self.example_indices[0])
        self.num_speech_features = sample[0].shape[1]
        self.num_features = sample[1].shape[1]

    def _use_host_dsp(self) -> bool:
        """The per-utterance DSP path (``data.dsp_backend``), resolved once:
        "scipy" the host front-end, "device" the device pipeline, and
        "auto" (anything else, as JAX's) the host front-end when the
        dataset's device is the CPU, the JAX package's choice on a CPU-only
        backend. On a card, "auto" takes the device pipeline (kernel 1)."""
        if self._host_dsp is None:
            mode = self.config.data.dsp_backend
            if mode == "scipy":
                if not HAVE_SCIPY:
                    raise RuntimeError("dsp_backend='scipy' but scipy is unavailable")
                self._host_dsp = True
            elif mode == "device":
                self._host_dsp = False
            else:
                self._host_dsp = HAVE_SCIPY and self.device.type == "cpu"
        return self._host_dsp

    # -- per-utterance loading ---------------------------------------------
    def load_utterance(self, directory_info_or_dir, index: int, limit_length: bool = False):
        base_dir = (
            directory_info_or_dir.directory
            if isinstance(directory_info_or_dir, EMGDirectory)
            else directory_info_or_dir
        )
        index = int(index)
        raw_emg = np.load(os.path.join(base_dir, f"{index}_emg.npy"))
        before_path = os.path.join(base_dir, f"{index-1}_emg.npy")
        after_path = os.path.join(base_dir, f"{index+1}_emg.npy")
        before = (
            np.load(before_path) if os.path.exists(before_path)
            else np.zeros([0, raw_emg.shape[1]])
        )
        after = (
            np.load(after_path) if os.path.exists(after_path)
            else np.zeros([0, raw_emg.shape[1]])
        )

        rm = tuple(int(c) for c in self.config.data.remove_channels)
        # the valid rows of the features and of the two signals, un-truncated
        if self._use_host_dsp():
            emg_features, emg_full, emg_orig_full = preprocess_emg_scipy(raw_emg, before, after, rm)
        else:
            buf, n_total, n_before, n_after = dsp_input(raw_emg, before, after)
            out = preprocess_emg(
                torch.as_tensor(buf, device=self.device), n_total, n_before, n_after, rm
            )
            emg_features, emg_full, emg_orig_full = (
                t[:n].cpu().numpy() for t, n in ((out.emg_features, out.n_frames),
                                                 (out.emg, out.n_feat), (out.emg_orig, out.n_raw))
            )

        mfccs = load_audio(
            _audio_path(base_dir, index),
            max_frames=min(emg_features.shape[0], 800 if limit_length else 10**9),
        )

        if emg_features.shape[0] > mfccs.shape[0]:
            emg_features = emg_features[: mfccs.shape[0], :]
        if emg_features.shape[0] != mfccs.shape[0]:
            raise ValueError(f"EMG/audio frame misalignment in {base_dir}/{index}")
        F = emg_features.shape[0]
        (e0, elen), (r0, rlen) = align_lengths(F)
        emg = emg_full[e0 : e0 + elen]
        emg_orig = emg_orig_full[r0 : r0 + rlen]
        if emg.shape[0] != F * 6:
            raise ValueError(f"EMG too short for its frames in {base_dir}/{index}")

        with open(os.path.join(base_dir, f"{index}_info.json")) as f:
            info = json.load(f)
        phonemes = read_phonemes(info["text"], self.pron_dict)
        return (
            mfccs, emg_features, info["text"],
            (info["book"], info["sentence_index"]),
            phonemes, emg_orig.astype(np.float32), emg,
        )

    # -- dataset protocol --------------------------------------------------
    def _with_examples(self, example_indices) -> "EMGDataset":
        """A shallow copy over ``example_indices``, with a cache of its own."""
        result = copy.copy(self)
        result.example_indices = example_indices
        result._cache = OrderedDict()
        result._cache_bytes = 0
        return result

    def silent_subset(self) -> "EMGDataset":
        """The examples from silent sessions."""
        return self._with_examples([e for e in self.example_indices if e[0].silent])

    def subset(self, fraction: float) -> "EMGDataset":
        """The first ``fraction`` of the examples, in the dataset's order."""
        return self._with_examples(self.example_indices[: int(fraction * len(self.example_indices))])

    def __len__(self):
        return len(self.example_indices)

    @staticmethod
    def _example_nbytes(result: dict) -> int:
        n = 512  # dict + string overhead, roughly
        for v in result.values():
            if isinstance(v, np.ndarray):
                n += v.nbytes
        return n

    def _cache_put(self, i: int, result: dict) -> None:
        if self._cache_budget <= 0:
            return
        self._cache[i] = result
        self._cache_bytes += self._example_nbytes(result)
        while self._cache_bytes > self._cache_budget and len(self._cache) > 1:
            _, evicted = self._cache.popitem(last=False)
            self._cache_bytes -= self._example_nbytes(evicted)

    def __getitem__(self, i: int) -> dict:
        if i in self._cache:
            self._cache.move_to_end(i)
            return self._cache[i]
        directory_info, idx = self.example_indices[i]
        mfccs, emg_feats, text, book_location, phonemes, raw_emg, _ = self.load_utterance(
            directory_info, idx, self.limit_length
        )
        # raw-EMG soft clip (read_emg.py:426-427)
        raw_emg = raw_emg / 20.0
        raw_emg = 50.0 * np.tanh(raw_emg / 50.0)

        emg = emg_feats
        if not self.no_normalizers:
            mfccs = self.mfcc_norm.normalize(mfccs)
            emg = self.emg_norm.normalize(emg)
            emg = 8.0 * np.tanh(emg / 8.0)

        session_ids = np.full(emg.shape[0], directory_info.session_index, dtype=np.int64)
        audio_file = _audio_path(directory_info.directory, idx)

        result = {
            "audio_features": mfccs.astype(np.float32),
            "emg": emg.astype(np.float32),
            "text": text,
            "words": [w for w in text],
            "text_int": np.array(self.text_transform.text_to_int(text), dtype=np.int64),
            "file_label": idx,
            "session_ids": session_ids,
            "book_location": book_location,
            "silent": directory_info.silent,
            "raw_emg": raw_emg.astype(np.float32),
        }

        if directory_info.silent:
            voiced_dir, voiced_idx = self.voiced_data_locations[book_location]
            v_mfccs, v_emg, _, _, phonemes, _, _ = self.load_utterance(voiced_dir, voiced_idx)
            if not self.no_normalizers:
                v_mfccs = self.mfcc_norm.normalize(v_mfccs)
                v_emg = self.emg_norm.normalize(v_emg)
                v_emg = 8.0 * np.tanh(v_emg / 8.0)
            result["parallel_voiced_audio_features"] = v_mfccs.astype(np.float32)
            result["parallel_voiced_emg"] = v_emg.astype(np.float32)
            audio_file = _audio_path(voiced_dir.directory, voiced_idx)

        result["phonemes"] = " ".join(phonemes)
        result["phonemes_int"] = np.array(
            self.phone_transform.phone_to_int(phonemes), dtype=np.int64
        )
        result["audio_file"] = audio_file
        self._cache_put(i, result)
        return result

    @staticmethod
    def collate_raw(batch: List[dict]) -> dict:
        """List of examples -> dict of lists (reference read_emg.py:463-504)."""
        audio_features, audio_feature_lengths, parallel_emg = [], [], []
        for ex in batch:
            if ex["silent"]:
                audio_features.append(ex["parallel_voiced_audio_features"])
                audio_feature_lengths.append(ex["parallel_voiced_audio_features"].shape[0])
                parallel_emg.append(ex["parallel_voiced_emg"])
            else:
                audio_features.append(ex["audio_features"])
                audio_feature_lengths.append(ex["audio_features"].shape[0])
                parallel_emg.append(np.zeros(1))
        return {
            "audio_features": audio_features,
            "audio_feature_lengths": audio_feature_lengths,
            "emg": [ex["emg"] for ex in batch],
            "raw_emg": [ex["raw_emg"] for ex in batch],
            "parallel_voiced_emg": parallel_emg,
            "phonemes": [ex["phonemes"] for ex in batch],
            "phonemes_int": [ex["phonemes_int"] for ex in batch],
            "phonemes_int_lengths": [ex["phonemes_int"].shape[0] for ex in batch],
            "session_ids": [ex["session_ids"] for ex in batch],
            "lengths": [ex["emg"].shape[0] for ex in batch],
            "silent": [ex["silent"] for ex in batch],
            "text": [ex["text"] for ex in batch],
            "text_int": [ex["text_int"] for ex in batch],
            "text_int_lengths": [ex["text_int"].shape[0] for ex in batch],
        }


def make_normalizers(config: Config, path: Optional[str] = None, max_samples: int = 51,
                     device="cuda"):
    """Compute and pickle (mfcc_norm, emg_norm) from the first examples
    (reference read_emg.py:506-517)."""
    dataset = EMGDataset(config, no_normalizers=True, device=device)
    mfcc_samples, emg_samples = [], []
    for i in range(len(dataset)):
        d = dataset[i]
        mfcc_samples.append(d["audio_features"])
        emg_samples.append(d["emg"])
        if len(emg_samples) > max_samples - 1:
            break
    mfcc_norm = FeatureNormalizer(mfcc_samples, share_scale=True)
    emg_norm = FeatureNormalizer(emg_samples, share_scale=False)
    out = path or config.data.normalizers_file
    save_normalizers(out, mfcc_norm, emg_norm)
    return mfcc_norm, emg_norm
