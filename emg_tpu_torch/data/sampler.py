"""Length-bucketed dynamic batch sampler.

Counterpart of ``emg_tpu/data/sampler.py``, with the same draws (numpy's
Generator seeded from seed + epoch), so both packages form the same
batches from the same dataset. It re-implements the reference
DynamicBatchSampler (read_emg.py:144-338): per-example raw-EMG lengths
come from the info.json chunk metadata, bucket
boundaries from lognormal quantile warping of max_batch_length, bucket
capacities from how often a boundary fits in max_batch_length, and batch
order is deterministically re-shuffled per epoch from (seed + epoch).
"""

from __future__ import annotations

import json
import logging
import os
import string
from typing import List, Optional

import numpy as np
from scipy.stats import lognorm

log = logging.getLogger(__name__)


class DynamicBatchSampler:
    def __init__(
        self,
        dataset,
        max_batch_length: int,
        num_buckets: Optional[int] = None,
        shuffle: bool = True,
        batch_ordering: str = "random",
        max_batch_ex: Optional[int] = None,
        bucket_boundaries: List[int] = (),
        seed: int = 42,
        epoch: int = 0,
        drop_last: bool = False,
    ):
        self._dataset = dataset
        self.lengths_list: List[int] = []
        self._texts: List[str] = []
        for directory_info, file_idx in dataset.example_indices:
            with open(os.path.join(directory_info.directory, f"{file_idx}_info.json")) as f:
                info = json.load(f)
            self.lengths_list.append(sum(c[0] for c in info["chunks"]))
            self._texts.append(info["text"])

        self._ex_lengths = {str(i): l for i, l in enumerate(self.lengths_list)}

        if len(bucket_boundaries) > 0:
            bb = list(bucket_boundaries)
            if not all(x >= 0 for x in bb):
                raise ValueError("bucket boundaries must be non-negative")
            if len(set(bb)) != len(bb):
                raise ValueError("bucket boundaries must not contain duplicates")
            if bb != sorted(bb):
                raise ValueError("bucket boundaries must be ascending")
            self._bucket_boundaries = np.array(sorted(bb))
        else:
            self._bucket_boundaries = np.array(
                self._get_boundaries_through_warping(max_batch_length, num_buckets)
            )

        self._max_batch_length = max_batch_length
        self._shuffle_ex = shuffle
        self._batch_ordering = batch_ordering
        self._seed = seed
        self._drop_last = drop_last
        self._max_batch_ex = np.inf if max_batch_ex is None else max_batch_ex
        self._bucket_lens = [
            max(1, int(max_batch_length / self._bucket_boundaries[i]))
            for i in range(len(self._bucket_boundaries))
        ] + [1]
        self._epoch = epoch
        self._generate_batches()

    def get_durations(self, batch):
        return [self._ex_lengths[str(idx)] for idx in batch]

    @staticmethod
    def _get_boundaries_through_warping(max_batch_length: int, num_quantiles: int) -> List[float]:
        num_boundaries = num_quantiles + 1
        latent = np.linspace(
            1 / num_boundaries, num_quantiles / num_boundaries, num_quantiles
        )
        quantiles = lognorm.ppf(latent, 1)
        return sorted(quantiles * max_batch_length / quantiles[-1])

    def _permute_batches(self):
        if self._batch_ordering == "random":
            rng = np.random.default_rng(self._seed + self._epoch)
            order = rng.permutation(len(self._batches))
            self._batches = [self._batches[i] for i in order]
        elif self._batch_ordering == "ascending":
            self._batches.sort(key=lambda b: max(self._ex_lengths[str(i)] for i in b))
        elif self._batch_ordering == "descending":
            self._batches.sort(
                key=lambda b: max(self._ex_lengths[str(i)] for i in b), reverse=True
            )
        else:
            raise NotImplementedError(self._batch_ordering)

    def _generate_batches(self):
        if self._shuffle_ex:
            rng = np.random.default_rng(self._seed + self._epoch)
            sampler = rng.permutation(len(self._dataset)).tolist()
        else:
            sampler = range(len(self._dataset))

        self._batches = []
        bucket_batches = [[] for _ in self._bucket_lens]
        for idx in sampler:
            # skip textless clips (reference read_emg.py:288-289)
            if not any(c in string.ascii_letters for c in self._texts[idx]):
                continue
            item_len = self._ex_lengths[str(idx)]
            bucket_id = int(np.searchsorted(self._bucket_boundaries, item_len))
            bucket_batches[bucket_id].append(idx)
            if (
                len(bucket_batches[bucket_id]) >= self._bucket_lens[bucket_id]
                or len(bucket_batches[bucket_id]) >= self._max_batch_ex
            ):
                self._batches.append(bucket_batches[bucket_id])
                bucket_batches[bucket_id] = []
        if not self._drop_last:
            for batch in bucket_batches:
                if batch:
                    self._batches.append(batch)
        self._permute_batches()

    def __iter__(self):
        yield from self._batches

    def set_epoch(self, epoch: int):
        self._epoch = epoch
        if self._shuffle_ex:
            self._generate_batches()

    def __len__(self):
        return len(self._batches)


class SizeAwareSampler:
    """Legacy greedy length-capped batcher (reference read_emg.py:117-142,
    unused by the live training path but kept for capability parity):
    shuffle, then pack examples into batches whose summed raw-EMG length
    stays under ``max_len``; the trailing incomplete batch is dropped."""

    def __init__(self, emg_dataset, max_len: int, seed: int = None):
        self.dataset = emg_dataset
        self.max_len = max_len
        self._seed = seed
        self._lengths = []
        self._texts = []
        for directory_info, file_idx in emg_dataset.example_indices:
            with open(os.path.join(directory_info.directory, f"{file_idx}_info.json")) as f:
                info = json.load(f)
            self._lengths.append(sum(c[0] for c in info["chunks"]))
            self._texts.append(info["text"])

    def __iter__(self):
        rng = np.random.default_rng(self._seed)
        indices = rng.permutation(len(self.dataset)).tolist()
        batch, batch_length = [], 0
        for idx in indices:
            if not any(c in string.ascii_letters for c in self._texts[idx]):
                continue
            length = self._lengths[idx]
            if length > self.max_len:
                log.warning(
                    "example %d cannot fit within desired batch length", idx
                )
            if length + batch_length > self.max_len:
                yield batch
                batch, batch_length = [], 0
            batch.append(idx)
            batch_length += length
        # trailing incomplete batch dropped (reference behavior)
