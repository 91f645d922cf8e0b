"""Scalar metric writer: a JSONL file, plus TensorBoard event files where
``torch.utils.tensorboard`` imports.

Counterpart of ``emg_tpu/train/metrics_writer.py``: the reference's tags
Loss{,_Decoder,_Encoder}/{Training,Evaluation},
PhonemeErrorRate{,_Epoch}/{Training,Evaluation} and Accuracy_Epoch/*
(recognition_model.py:177-251, 397), and the same JSONL mirror
(``metrics.jsonl``: one {"tag", "value", "step", "time"} object a line).
"""

from __future__ import annotations

import datetime
import json
import os
import time


class MetricsWriter:
    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:  # the tensorboard package is optional
            return
        self._tb = SummaryWriter(log_dir)

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), int(step))
        self._jsonl.write(json.dumps({"tag": tag, "value": float(value), "step": int(step),
                                      "time": time.time()}) + "\n")

    def flush(self) -> None:
        if self._tb is not None:
            self._tb.flush()
        self._jsonl.flush()

    def close(self) -> None:
        self.flush()
        if self._tb is not None:
            self._tb.close()
        self._jsonl.close()


class NullMetricsWriter:
    """The writer of a mesh rank other than 0: it writes nothing (rank 0
    owns the files; the reported scalars are the same on every rank)."""

    log_dir = ""

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        pass

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


def default_log_dir(base: str = "logs/run") -> str:
    return os.path.join(base, datetime.datetime.now().strftime("%Y%m%d-%H%M%S"))
