"""Fused accumulation windows: the JAX trainer's plan, without graphs of
their own.

Counterpart of the JAX trainer's fused windows
(``emg_tpu/train/trainer.py:133-181, 420-445``, the program of
``emg_tpu/parallel/train_step.py:108-131``). The sampler is deterministic
per (seed, epoch), so the epoch's optimizer applies are known before any
step runs; ``plan_windows`` cuts the epoch's microbatches into windows at
each apply, at each ``report_loss`` boundary and at ``MAX_WINDOW``
microbatches, as JAX's ``_plan_windows`` does.

The port runs no window as one program. Where ``train.fused_window``
resolves on (``parallel/train_step.py::windows_enabled``), every microbatch
replays its signature's step graph (``parallel/train_step.py::
StepGraphs``), as JAX runs a step jitted once per shape. A graph of a whole
window, keyed by its microbatches' shapes in order, was slower on every
corpus measured on an H100: a window's composition seldom repeats under
the sampler's shuffle, so each is captured anew (an eager run, then the
capture, the card idle while the host records), and the held windows'
memory grows with their count. ``WindowRunner`` stays for callers that
offer a planned window as a whole: it declines each, and they run its
microbatches through the step.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from emg_tpu_torch.parallel.train_step import windows_enabled  # noqa: F401 (callers' switch)
from emg_tpu_torch.utils.profiling import span

MAX_WINDOW = 32  # JAX's cap on a window's microbatches


def plan_windows(batch_lists: Sequence[Sequence[int]], start_accum: int, cfg) -> List[int]:
    """The epoch's microbatches cut into windows (their lengths, in order):
    at each optimizer apply (the summed example count reaching
    ``batch_size_grad``, from ``start_accum``), at every ``report_loss``
    boundary and at ``MAX_WINDOW`` microbatches. JAX's
    ``Trainer._plan_windows``."""
    with span("window.plan"):
        windows: List[int] = []
        accum = start_accum
        run = 0
        for step, idxs in enumerate(batch_lists):
            accum += len(idxs)
            run += 1
            cut = run >= MAX_WINDOW or (step + 1) % cfg.report_loss == 0
            if accum >= cfg.batch_size_grad:
                accum = 0
                cut = True
            if cut:
                windows.append(run)
                run = 0
        if run:
            windows.append(run)
        return windows


class WindowRunner:
    """What a caller offers a planned window of microbatches to. It runs
    none (``run`` returns None): the caller runs the window's microbatches
    through ``make_train_step``, whose step graphs replay one CUDA graph a
    microbatch signature."""

    def __init__(self, cfg, device: torch.device):
        self.cfg = cfg
        self.device = torch.device(device)

    def run(self, state, group) -> Optional[List[dict]]:
        """None, having run nothing of the window ``group``."""
        return None
