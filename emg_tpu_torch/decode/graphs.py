"""Decode loops run to their end, k steps between reads of the device.

The JAX package compiles each decode loop into one XLA program: greedy
decoding and the device beam are ``lax.while_loop``s whose condition the
device evaluates. PyTorch's counterpart of a compiled device loop is a CUDA
graph. A loop here is a *body*: one step from a state (a dict whose values
are tensors, or tuples and lists of tensors) to the next, gated on the
device so that a step after the loop's end changes nothing a caller reads,
and setting ``state["done"]``, a 0-dim bool tensor. ``LoopRunner.run`` runs
k bodies, reads ``done`` once, and repeats until it is set (or runs a fixed
number of k-step blocks and reads nothing):

- on the CPU, or with ``graphed=False``, the bodies run eagerly;
- on a CUDA device, the k-step block is captured once per geometry with
  ``torch.cuda.CUDAGraph`` over static buffers and replayed. The first run
  of a geometry fills the buffers, runs the block once on a side stream
  (the warm-up PyTorch's documentation asks for), captures it into a pool
  that all of the runner's graphs share, and fills the buffers again.
  Later runs write their inputs into the same buffers, outside the graph.
  A failed capture or replay raises: nothing falls back to the eager loop.

A body hands back each of its state's tensors either as the same object
(updated in place, like the K/V caches, or only read, like the inputs) or
as a new tensor, which the captured block copies into the static buffer
after its k-th step. A cache that the body writes into a second buffer each
step (the beam's ping-pong) is back in its own buffer after an even k, and
is never copied. After an odd k the pair has swapped: the block hands back
each static buffer under its partner's name. The runner then copies
neither; it captures a second graph of the block from the state with the
pair's names swapped, and replays the two in turn, so that each block
starts where the last one ended (``CapturedLoop.replay``).

A runner's graphs read the parameters of the model they were captured on.
Build one per evaluation pass (a CLI call, a PER report) on the model that
pass decodes with, and never carry it across a ``cast_params_for_serving``
copy, a ``load_state_dict``, or a model whose parameters were replaced.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch

# k, the steps between two reads of ``done``. A read idles the card while
# the host launches the next block; a step past the loop's end costs a
# whole step. At k = 4 a loop runs (k - 1) / 2 = 1.5 steps past its end on
# average and reads once per 4 steps. Even, so that the beam's ping-pong
# caches end each block where they began.
READ_EVERY = 4

State = Dict[str, object]

# one side stream per device for every warm-up and capture: cuBLAS keeps a
# workspace per (handle, stream), allocated on the stream's first GEMM, so a
# new stream for each capture would take, and keep, a new workspace each time
_capture_streams: Dict[int, "torch.cuda.Stream"] = {}


def capture_stream(device: int) -> "torch.cuda.Stream":
    """The side stream on which every warm-up and capture of ``device``
    runs (decode loops and training step graphs alike)."""
    if device not in _capture_streams:
        _capture_streams[device] = torch.cuda.Stream(device)
    return _capture_streams[device]


def _leaves(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for item in x for t in _leaves(item)]
    raise TypeError(f"a loop state holds tensors, not {type(x).__name__}")


def copy_into(static: State, state: State) -> None:
    """Write ``state``'s tensors into ``static``'s, name by name, skipping
    each that already is a static tensor: the same one, or the partner of a
    ping-pong pair that swapped."""
    held = {id(t) for value in static.values() for t in _leaves(value)}
    for name, dst in static.items():
        for d, s in zip(_leaves(dst), _leaves(state[name])):
            if id(s) not in held:
                d.copy_(s)


def _swapped(static: State, state: State) -> State:
    """The names under which ``state`` holds another name's static tensor:
    the ping-pong pairs after an odd number of steps."""
    held = {id(v) for v in static.values() if isinstance(v, torch.Tensor)}
    return {name: v for name, v in state.items()
            if isinstance(v, torch.Tensor) and v is not static[name] and id(v) in held}


@dataclass
class CapturedLoop:
    """One geometry's k-step block: its graph, the static state it reads
    and writes, the seconds its first run took to warm up and capture, and
    the device memory the capture reserved for the shared pool. For an odd
    k, ``other`` is the (graph, state) captured from the state whose
    ping-pong pairs are swapped; ``graph`` and ``state`` are always the
    ones the next block starts from."""

    graph: "torch.cuda.CUDAGraph"
    state: State
    capture_s: float
    pool_bytes: int
    other: Optional[Tuple["torch.cuda.CUDAGraph", State]] = None

    def replay(self) -> None:
        self.graph.replay()
        if self.other is not None:
            # the pairs swapped: the next block starts from the other names
            self.other, (self.graph, self.state) = (self.graph, self.state), self.other


class LoopRunner:
    """Runs decode loops on ``model``: eagerly on the CPU or with
    ``graphed=False`` (which only a comparison with the graphs asks for),
    as captured CUDA graphs on a CUDA device. ``k`` steps run between two
    reads of ``done``."""

    def __init__(self, model, k: int = READ_EVERY, graphed: bool = True):
        if k < 1:
            raise ValueError(f"a block runs at least one step, not {k}")
        self.model = model
        self.k = k
        self.graphed = graphed
        self.graphs: Dict[tuple, CapturedLoop] = {}
        self.replays = 0  # graph replays, over the runner's life
        self.reads = 0  # reads of ``done``, over the runner's life
        self.blocks = 0  # k-step blocks of the last run
        self._pool = None

    def check_model(self, model) -> None:
        if model is not self.model:
            raise ValueError("this LoopRunner was built for another model object")

    def run(self, key: tuple, init: Callable[[Optional[State]], State],
            body: Callable[[State], State], blocks: Optional[int] = None,
            k: Optional[int] = None) -> State:
        """Run one loop to its end and return its last state.

        ``key`` names the geometry: every shape and every Python value the
        body depends on. ``init(old)`` returns this run's initial state;
        ``old`` is None, or on the graphed path the static state of an
        earlier run of ``key``, which init may refill in place (the caches:
        zeroed) and hand back. ``blocks``: run that many k-step blocks and
        read nothing; by default read ``done`` after each block. ``k``: the
        steps of a block, for this geometry (``key`` names it too); by
        default the runner's. On the graphed path the state returned is the
        static buffers, which the next run of ``key`` overwrites."""
        k = self.k if k is None else k
        if not (self.graphed and self.model.device.type == "cuda"):
            st = init(None)
            n = 0
            while True:
                st = self._block(body, st, k)
                n += 1
                if self._finished(st, n, blocks):
                    break
            self.blocks = n
            return st
        captured = self.graphs.get(key)
        if captured is None:
            captured = self.graphs[key] = self._capture(init, body, k)
        else:
            copy_into(captured.state, init(captured.state))
        n = 0
        while True:
            captured.replay()
            self.replays += 1
            n += 1
            if self._finished(captured.state, n, blocks):
                break
        self.blocks = n
        return captured.state

    def _finished(self, st: State, n: int, blocks: Optional[int]) -> bool:
        if blocks is not None:
            return n >= blocks
        self.reads += 1
        return bool(st["done"])

    @staticmethod
    def _block(body, st: State, k: int) -> State:
        for _ in range(k):
            st = body(st)
        return st

    def _capture(self, init, body, k: int) -> CapturedLoop:
        t0 = time.perf_counter()
        static = init(None)

        def block(state: State) -> State:
            out = self._block(body, state, k)
            copy_into(state, out)
            return out

        def capture(state: State) -> "torch.cuda.CUDAGraph":
            graph = torch.cuda.CUDAGraph()
            graph.capture_begin(pool=self._pool)
            try:
                block(state)
            finally:
                graph.capture_end()
            return graph

        side = capture_stream(self.model.device.index)
        side.wait_stream(torch.cuda.current_stream())
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        # warm up and capture on one side stream. Not through
        # ``torch.cuda.graph``, which empties the allocator's cache first:
        # after a trainer's PER report, the next train step would then get
        # all its memory from cudaMalloc again
        with torch.cuda.stream(side):
            swapped = _swapped(static, block(static))
            side.synchronize()
            reserved = torch.cuda.memory_reserved()
            graph = capture(static)
            other = None
            if swapped:
                alt = dict(static, **swapped)
                other = (capture(alt), alt)
        torch.cuda.current_stream().wait_stream(side)
        # the private pool takes new segments only
        pool_bytes = torch.cuda.memory_reserved() - reserved
        # the warm-up ran the block on the buffers: start the run afresh
        copy_into(static, init(static))
        torch.cuda.synchronize()
        return CapturedLoop(graph, static, time.perf_counter() - t0, pool_bytes, other)
