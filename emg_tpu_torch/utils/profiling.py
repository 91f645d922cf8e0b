"""Profiling hooks: torch.profiler traces + named annotations.

Counterpart of ``emg_tpu/utils/profiling.py``. The reference has no
profiler integration (torch-tb-profiler installed but never imported,
SURVEY.md §5). ``profile_trace`` wraps a code region in a torch.profiler
trace of the host and, where a card is present, of CUDA activity, and
writes it into the given directory as a Chrome trace
(``*.pt.trace.json``: ui.perfetto.dev, or TensorBoard's profiler plugin
over the directory); ``annotate`` names a region so the operations and
kernels under it attribute to it.
"""

from __future__ import annotations

import contextlib
import os
import socket
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function


@contextlib.contextmanager
def profile_trace(log_dir: str, enabled: bool = True):
    """``with profile_trace(dir) as prof: ...`` traces the block and writes
    the trace into ``dir`` on exit; ``prof`` is the torch.profiler run (its
    ``trace_path`` the file written). With ``enabled=False`` it traces and
    writes nothing, and ``prof`` is None."""
    if not enabled:
        yield None
        return
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    # tensorboard_trace_handler's naming: worker, then milliseconds
    name = f"{socket.gethostname()}_{os.getpid()}.{time.time_ns() // 1_000_000}.pt.trace.json"
    prof.trace_path = os.path.join(log_dir, name)
    prof.export_chrome_trace(prof.trace_path)


def annotate(name: str):
    """Named trace region: ``with annotate('train_step'): ...``"""
    return record_function(name)
