"""Fused accumulation windows: a run of microbatch steps replayed as one
CUDA graph.

Counterpart of the JAX trainer's fused windows
(``emg_tpu/train/trainer.py:133-181, 420-445``, the program of
``emg_tpu/parallel/train_step.py:108-131``). The sampler is deterministic
per (seed, epoch), so the epoch's optimizer applies are known before any
step runs; ``plan_windows`` cuts the epoch's microbatches into windows at
each apply, at each ``report_loss`` boundary and at ``MAX_WINDOW``
microbatches, as JAX's ``_plan_windows`` does. A window longer than one
microbatch runs through ``WindowRunner``:

- on a CUDA device, as one captured CUDA graph of its microbatch steps
  (``parallel/train_step.py::microbatch_body``), AdamW's apply at its end
  when it applies, per signature: each microbatch's padded shapes (its
  packed rows, utterances, frame and target buckets) and whether the
  window applies. The first window of a signature runs its steps eagerly on
  the capture stream, which is the warm-up the capture needs, and is then
  captured; every later window of that signature copies its batches into
  the graph's input buffers (from page-locked memory, outside the graph),
  seeds its generators and writes its scheduled-sampling probabilities and
  LR into device tensors, and replays. A failed capture or replay raises.
  Once ``train.window_max_compiles`` signatures are held, a window of a new
  signature runs as per-microbatch steps, as JAX's does past its cap;
- on the CPU, eagerly, step by step, through the same staging, generators
  and body (``LoopRunner``'s convention for decode loops).

Either way the numbers are those of the per-microbatch steps: the same
body, the same draws (one generator per window position, seeded with
``step_seed(train.seed, microbatch)`` as the per-microbatch path reseeds
its one generator; each is registered with the graph, so a replay draws
from the seed set before it), the same counters. Nothing in the body reads
the device from the host (``microbatch_body``), and the graph's kernels
launch on the capturing stream (``ops/build.py::current_stream_ptr`` is
the current stream). A kernel wrapper counts only the launches it makes
(``ops/build.py::count_launch``): not its calls under capture, and not a
replay's launches, which no wrapper sees.

``train.fused_window``: None (auto) turns windows on for a CUDA device and
off for the CPU, as JAX's auto does for accelerators and CPU backends. On
a mesh over NCCL the graph holds the collectives too; over gloo (CPU
ranks, or ranks sharing one card) the collectives pass through the host,
which no graph can hold: there auto is off and ``True`` raises.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from emg_tpu_torch.parallel.train_step import (
    Schedule,
    advance,
    microbatch_body,
    schedule,
    set_lr,
    stage_batch,
    step_seed,
)
from emg_tpu_torch.utils.profiling import span

log = logging.getLogger(__name__)

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


def windows_enabled(cfg, device: torch.device, mesh=None) -> bool:
    """Resolve ``train.fused_window``: None is on for a CUDA device and off
    for the CPU; on a mesh whose collectives pass through the host (gloo)
    it is off, and ``True`` raises."""
    fw = cfg.fused_window
    if mesh is not None and not mesh.native:
        if fw:
            raise ValueError("train.fused_window needs the mesh's collectives on the device "
                             "(NCCL): over gloo they pass through the host, which a CUDA graph "
                             "cannot hold")
        return False
    if fw is None:
        return device.type == "cuda"
    return bool(fw)


@dataclass
class CapturedWindow:
    """One signature's graph: its input buffers (the staged tensors and
    host facts of each position), each position's generator and
    scheduled-sampling probability, its outputs (each position's loss
    metrics), the seconds the first window took (its eager run and the
    capture), the device memory the capture reserved for the runner's pool
    and its replays so far."""

    graph: "torch.cuda.CUDAGraph"
    inputs: List[Tuple[Dict[str, torch.Tensor], Dict[str, object]]]
    generators: List[torch.Generator]
    ss_probs: List[Optional[torch.Tensor]]
    outputs: List[Dict[str, torch.Tensor]]
    capture_s: float
    pool_bytes: int
    replays: int = 0


def signature(group, plans: Sequence[Schedule]) -> tuple:
    """A window's key: each microbatch's padded shapes and dtype, its frame
    bucket and whether it applies."""
    return tuple((tuple(pb.packed_raw.shape), str(pb.packed_raw.dtype), tuple(pb.targets.shape),
                  max_frames, plan.applied) for (pb, max_frames), plan in zip(group, plans))


class WindowRunner:
    """Runs a trainer's windows longer than one microbatch (``run``):
    graphed on a CUDA device, eagerly on the CPU. ``captures``,
    ``replays``, ``eager_windows`` and ``graphs`` say what it did."""

    def __init__(self, cfg, device: torch.device):
        self.cfg = cfg
        self.device = torch.device(device)
        self.graphed = self.device.type == "cuda"
        self.graphs: Dict[tuple, CapturedWindow] = {}
        self.signatures: set = set()
        self.captures = 0
        self.replays = 0
        self.eager_windows = 0
        self._pool = None
        self._generators: List[torch.Generator] = []

    def run(self, state, group) -> Optional[List[dict]]:
        """Run the window ``group`` ([(PackedBatch, max_frames)], the
        microbatches in order) on ``state`` and return each microbatch's
        metrics, as the per-microbatch step returns them; None, having run
        nothing, for a new signature past ``window_max_compiles``."""
        plans = self._plans(state, group)
        key = signature(group, plans)
        if key not in self.signatures:
            if len(self.signatures) >= self.cfg.window_max_compiles:
                return None
            self.signatures.add(key)
        if not self.graphed:
            return self._eager(state, group, plans)
        captured = self.graphs.get(key)
        if captured is None:
            metrics, self.graphs[key] = self._capture(state, group, plans)
            return metrics
        return self._replay(captured, state, group, plans)

    def _plans(self, state, group) -> List[Schedule]:
        """Each microbatch's host values, from the counters as they will
        stand before it."""
        counters = (state.accum_examples, state.microbatches, state.updates)
        plans = []
        try:
            for pb, _ in group:
                n = int(pb.n_examples)
                plans.append(schedule(state, self.cfg, n))
                advance(state, n, plans[-1].applied)
        finally:
            state.accum_examples, state.microbatches, state.updates = counters
        return plans

    def _seed(self, generator: torch.Generator, state) -> None:
        generator.manual_seed(step_seed(state.cfg.seed, state.microbatches))

    def _steps(self, state, group, plans, inputs, generators, ss_probs, seed: bool):
        """The window's microbatch bodies, in order, advancing the host
        counters; ``seed``: reseed each position's generator first (not
        while capturing: the replay's seeds are set before it)."""
        outputs = []
        for i, ((_, max_frames), plan) in enumerate(zip(group, plans)):
            tensors, host = inputs[i]
            if seed:
                self._seed(generators[i], state)
                if ss_probs[i] is not None:
                    ss_probs[i].fill_(plan.ss_prob)
                if plan.applied:
                    set_lr(state.optimizer, plan.lr)
            outputs.append(microbatch_body(state, self.cfg, tensors, host, max_frames,
                                           generators[i], ss_probs[i], plan.applied))
            advance(state, host["n_examples"], plan.applied)
        return outputs

    def _new_inputs(self, state, group, pin: bool):
        inputs = []
        for pb, _ in group:
            tensors, host = stage_batch(pb, state.model.mesh, pin=pin)
            inputs.append(({k: v.to(self.device, non_blocking=pin) for k, v in tensors.items()},
                           host))
        return inputs

    def _ss_probs(self, n: int) -> List[Optional[torch.Tensor]]:
        on = self.cfg.scheduled_sampling_max_prob > 0
        return [torch.zeros((), dtype=torch.float32, device=self.device) if on else None
                for _ in range(n)]

    @staticmethod
    def _with_host(outputs, plans) -> List[dict]:
        return [{**out, "lr": plan.lr, "applied": plan.applied} for out, plan in zip(outputs, plans)]

    def _eager(self, state, group, plans) -> List[dict]:
        while len(self._generators) < len(group):
            self._generators.append(torch.Generator(device=self.device))
        outputs = self._steps(state, group, plans, self._new_inputs(state, group, pin=False),
                              self._generators, self._ss_probs(len(group)), seed=True)
        self.eager_windows += 1
        return self._with_host(outputs, plans)

    def _capture(self, state, group, plans) -> Tuple[List[dict], CapturedWindow]:
        from emg_tpu_torch.decode.graphs import capture_stream

        t0 = time.perf_counter()
        inputs = self._new_inputs(state, group, pin=True)
        generators = [torch.Generator(device=self.device) for _ in group]
        ss_probs = self._ss_probs(len(group))
        counters = (state.accum_examples, state.microbatches, state.updates)
        grads = [p.grad.data_ptr() for p in state.model.parameters()]
        side = capture_stream(self.device.index)
        side.wait_stream(torch.cuda.current_stream(self.device))
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        with torch.cuda.stream(side):
            # this window's own steps, eagerly: the warm-up of the capture
            first = self._steps(state, group, plans, inputs, generators, ss_probs, seed=True)
            after = (state.accum_examples, state.microbatches, state.updates)
            side.synchronize()
            reserved = torch.cuda.memory_reserved(self.device)
            # the capture records the same steps from the same counters
            state.accum_examples, state.microbatches, state.updates = counters
            graph = torch.cuda.CUDAGraph()
            for g in generators:
                graph.register_generator_state(g)
            graph.capture_begin(pool=self._pool)
            try:
                outputs = self._steps(state, group, plans, inputs, generators, ss_probs,
                                      seed=False)
            finally:
                graph.capture_end()
                state.accum_examples, state.microbatches, state.updates = after
        torch.cuda.current_stream(self.device).wait_stream(side)
        pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
        if [p.grad.data_ptr() for p in state.model.parameters()] != grads:
            raise RuntimeError("the window's capture replaced a gradient buffer: a replay would "
                               "accumulate into the old one")
        torch.cuda.synchronize(self.device)
        self.captures += 1
        captured = CapturedWindow(graph, inputs, generators, ss_probs, outputs,
                                  time.perf_counter() - t0, pool_bytes)
        log.info("captured a window of %d microbatches in %.2f s (%d bytes of pool)",
                 len(group), captured.capture_s, pool_bytes)
        return self._with_host(first, plans), captured

    def _replay(self, captured: CapturedWindow, state, group, plans) -> List[dict]:
        for i, ((pb, _), plan) in enumerate(zip(group, plans)):
            tensors, _ = stage_batch(pb, state.model.mesh, pin=True)
            for k, v in tensors.items():
                captured.inputs[i][0][k].copy_(v, non_blocking=True)
            self._seed(captured.generators[i], state)
            if captured.ss_probs[i] is not None:
                captured.ss_probs[i].fill_(plan.ss_prob)
            if plan.applied:
                set_lr(state.optimizer, plan.lr)
            advance(state, int(pb.n_examples), plan.applied)
        captured.graph.replay()
        captured.replays += 1
        self.replays += 1
        outputs = [{k: v.clone() for k, v in out.items()} for out in captured.outputs]
        return self._with_host(outputs, plans)
