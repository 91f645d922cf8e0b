"""Feature normalization (mean/std), with reference-pickle compatibility.

The reference pickles a pair of FeatureNormalizer objects into
normalizers.pkl (read_emg.py:506-517; class at data_utils.py:145-163):
mfcc stats with a shared scalar stddev, EMG stats per-dimension. We load
that exact pickle format without the reference module being importable.
"""

from __future__ import annotations

import pickle
from typing import Sequence, Tuple

import numpy as np


class FeatureNormalizer:
    def __init__(self, feature_samples: Sequence[np.ndarray] = (), share_scale: bool = False):
        """feature_samples: list of (time, feature) matrices."""
        if len(feature_samples):
            stacked = np.concatenate(list(feature_samples), axis=0)
            self.feature_means = stacked.mean(axis=0, keepdims=True)
            if share_scale:
                self.feature_stddevs = stacked.std()
            else:
                self.feature_stddevs = stacked.std(axis=0, keepdims=True)
        else:
            self.feature_means = None
            self.feature_stddevs = None

    def normalize(self, sample):
        sample = sample - self.feature_means
        sample = sample / self.feature_stddevs
        return sample

    def inverse(self, sample):
        return sample * self.feature_stddevs + self.feature_means


class _CompatUnpickler(pickle.Unpickler):
    """Maps the reference's ``data_utils.FeatureNormalizer`` onto ours."""

    def find_class(self, module, name):
        if name == "FeatureNormalizer":
            return FeatureNormalizer
        return super().find_class(module, name)


def load_normalizers(path: str) -> Tuple[FeatureNormalizer, FeatureNormalizer]:
    """Load (mfcc_norm, emg_norm) from a reference-format normalizers.pkl."""
    with open(path, "rb") as f:
        mfcc_norm, emg_norm = _CompatUnpickler(f).load()
    return mfcc_norm, emg_norm


def save_normalizers(path: str, mfcc_norm: FeatureNormalizer, emg_norm: FeatureNormalizer):
    with open(path, "wb") as f:
        pickle.dump((mfcc_norm, emg_norm), f)
