"""Profiling hooks: torch.profiler traces, and the program's spans and
counters.

Counterpart of ``emg_tpu/utils/profiling.py``. The reference has no
profiler integration (torch-tb-profiler installed but never imported,
SURVEY.md §5). ``profile_trace`` wraps a code region in a torch.profiler
trace of the host and, where a card is present, of CUDA activity, and
writes it into the given directory as a Chrome trace
(``*.pt.trace.json``: ui.perfetto.dev, or TensorBoard's profiler plugin
over the directory).

``span(name, **attrs)`` names a region of host work and ``count(name, n)``
adds to a counter. They record only while a torch profiler runs, or inside
``recording()`` (for tests, and to read the spans without a profiler):

- off, ``span`` returns one shared no-op context (``with span(...) as s``
  gives None, so a caller computes an attribute only where ``s`` is a
  span) and ``count`` returns at once: no allocation, no
  ``record_function``, no sync;
- on, each span is kept in memory (name, id, parent id, the microbatch it
  belongs to, its start and end on the host's ``perf_counter_ns`` clock,
  small attributes) and opens a ``record_function`` region of its name, so
  it also shows on a profiler's timeline.

No span synchronizes with the device: a span times the host's work, which
on the card is issuing work the device runs later, unless the span wraps a
call that itself waits for the device. ``recorded()`` returns what was kept
since the last ``clear()``; nothing is written out.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import socket
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler
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


@dataclass(eq=False)
class Span:
    """One recorded region of host work. ``microbatch`` is the one given
    to the span, else its parent's (None outside any); times are
    ``time.perf_counter_ns()``; ``end_ns`` is None while it is open."""

    name: str
    id: int
    parent: Optional[int]
    microbatch: Optional[int]
    start_ns: int
    end_ns: Optional[int] = None
    attrs: Dict[str, object] = field(default_factory=dict)

    @property
    def duration_ns(self) -> int:
        return self.end_ns - self.start_ns


@dataclass
class Recording:
    """What was recorded since the last ``clear()``: the spans in the
    order they opened, and the counters."""

    spans: List[Span]
    counts: Dict[str, int]

    def children(self, span: Span) -> List[Span]:
        return [s for s in self.spans if s.parent == span.id]

    def self_ns(self, span: Span) -> int:
        """The span's duration less its children's (they nest inside it)."""
        return span.duration_ns - sum(c.duration_ns for c in self.children(span))


class _Recorder:
    """The process's spans and counters (one recorder, as the profiler it
    follows is one per process), with each thread's stack of open spans."""

    def __init__(self):
        self.forced = 0  # open recording() blocks
        self.spans: List[Span] = []
        self.counts: Dict[str, int] = {}
        self.ids = itertools.count()
        self.lock = threading.Lock()
        self.local = threading.local()

    def stack(self) -> List[Span]:
        stack = getattr(self.local, "stack", None)
        if stack is None:
            stack = self.local.stack = []
        return stack


_recorder = _Recorder()
_OFF = contextlib.nullcontext()


def enabled() -> bool:
    """Whether spans and counters record: a torch profiler runs (torch's
    own fast flag for this) or a ``recording()`` block is open."""
    return bool(_recorder.forced) or _autograd_profiler._is_profiler_enabled


class _Open:
    """The context of one recording span."""

    __slots__ = ("span", "region")

    def __init__(self, name: str, microbatch: Optional[int], attrs: dict):
        stack = _recorder.stack()
        parent = stack[-1] if stack else None
        if microbatch is None and parent is not None:
            microbatch = parent.microbatch
        self.span = Span(name, next(_recorder.ids), None if parent is None else parent.id,
                         microbatch, 0, attrs=attrs)
        self.region = record_function(name)

    def __enter__(self) -> Span:
        with _recorder.lock:
            _recorder.spans.append(self.span)
        _recorder.stack().append(self.span)
        self.region.__enter__()
        self.span.start_ns = time.perf_counter_ns()
        return self.span

    def __exit__(self, *exc) -> bool:
        self.span.end_ns = time.perf_counter_ns()
        self.region.__exit__(*exc)
        _recorder.stack().pop()
        return False


def span(name: str, microbatch: Optional[int] = None, **attrs):
    """``with span("step", microbatch=k) as s: ...`` records the block as a
    span while tracing is on (``enabled``); ``s`` is the ``Span`` (its
    ``attrs`` may be added to inside the block), or None when off."""
    if not enabled():
        return _OFF
    return _Open(name, microbatch, attrs)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while tracing is on."""
    if not enabled():
        return
    with _recorder.lock:
        _recorder.counts[name] = _recorder.counts.get(name, 0) + n


@contextlib.contextmanager
def recording():
    """Record spans and counters inside the block, with no profiler."""
    with _recorder.lock:
        _recorder.forced += 1
    try:
        yield
    finally:
        with _recorder.lock:
            _recorder.forced -= 1


def recorded() -> Recording:
    """The spans and counters recorded since the last ``clear()``."""
    with _recorder.lock:
        return Recording(list(_recorder.spans), dict(_recorder.counts))


def clear() -> None:
    """Forget what was recorded."""
    with _recorder.lock:
        _recorder.spans.clear()
        _recorder.counts.clear()
