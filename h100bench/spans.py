"""The program's spans and counters, and the traced segment's device events
on one clock.

The program (``emg_tpu_torch/utils/profiling.py``) records its spans and
counters while a torch profiler runs, which in a run of a cell is the
traced segment's alone (``trace.traced``): what it holds once the segment
is over is the segment's. Spans are on the host's ``perf_counter_ns``; the
segment's device events in the profiler's microseconds.

The anchors that join the two clocks: each ``sync`` span of a step's
staging (``step.stage``) wraps one copy of pageable host memory to the
card, which returns once the stream has run it, so the copy runs on the
device inside its span and ends just before the span does. Paired in order
with the segment's pageable host-to-device copies, each pair gives an
offset, host clock less device clock: the span's end less the copy's, that
is the true offset plus the host's wake-up after the copy. Each step's
anchors give the offset at that step, their least (the step's quickest
wake-up, so no copy ends after its span). Held to ``MAX_MISFIT_US``: every
copy, start and end, lies inside its span on the shared clock (a pairing
that is off by a copy puts copies a step away from their spans). Where the
counts differ or a copy lies outside, there is no offset (None).

The two clocks do not keep one offset through a segment. On an H100 under
torch 2.11 the device's drifts from the host's at a rate that holds
through a segment (20-310 ppm), and now and then jumps back by what it
gathered (79 us between two steps after 96 us over 4.1 s; at 310 ppm a
few seconds gather a ms): its conversion to the host's time is set anew.
Between two steps' anchors the offset is interpolated; the drift, the
median of the steps' rates, carries it past the first and the last. Where
the clocks jumped between two steps, the instant is not known: any instant
between them lies on the earlier step's line (the jump came later) or on
the later step's (it came sooner), which differ by the jump.
``idle_in_step`` reads None where that leaves more than ``MAX_UNSURE`` of
the segment's wall unsure.

On that clock the segment's device-idle time (its wall less the union of
its events, as ``device_idle_pct.train`` takes it) is put down to the
innermost span open on the host at each instant. The segment's window is
its wall from the first span's start: the segment's first host work is
the first window's batch assembly, a span.
"""

from __future__ import annotations

import bisect
import statistics
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

MAX_MISFIT_US = 100.0
MAX_UNSURE = 0.01  # of the segment's wall: idle is put down to spans to 1% of it
COPY = ("Memcpy HtoD", "Pageable")  # a pageable host-to-device copy's trace name holds both
BATCH_SPANS = ("data.sampler", "window.plan", "data.pack", "data.int16")
ISSUE_SPANS = ("step.forward", "step.backward", "step.optimizer")


def program_recording():
    """What the program recorded (``profiling.recorded()``), or None for a
    program that records no spans."""
    try:
        from emg_tpu_torch.utils import profiling

        recorded = profiling.recorded
    except (ImportError, AttributeError):
        return None
    return recorded()


def segment_recording(ctx):
    """(segment, recording, microbatches) of a traced run: None without a
    device trace (no profiler ran: no spans were recorded either), without
    spans, or without a ``step`` span."""
    seg = ctx.get("segment")
    if seg is None or not seg.events:
        return None
    rec = program_recording()
    if rec is None:
        return None
    steps = sum(s.name == "step" for s in rec.spans if s.end_ns is not None)
    return (seg, rec, steps) if steps else None


@dataclass
class Alignment:
    times_us: List[float]  # host us of each step's anchor (the span end of its quickest wake-up)
    offsets_us: List[float]  # host clock less device clock there (us)
    rate: float  # the drift: host us the offset gains a host us (the median of the steps')
    wake_us: float  # the latest wake-up: a pair's offset less its step's
    misfit_us: float  # the farthest any copy lies outside its span on the shared clock
    jump_us: float  # the largest jump between two steps: off the drift's line
    pairs: int

    def offset(self, host_us: float, side: Optional[str] = None) -> float:
        """Host clock less device clock at ``host_us``: between two steps'
        anchors on the line through them, or with ``side`` "early" on the
        earlier step's drift line and "late" on the later's; before the
        first and past the last on the nearest step's drift line."""
        t, d = self.times_us, self.offsets_us
        i = bisect.bisect_right(t, host_us)
        if i == 0 or i == len(t):
            k = min(i, len(t) - 1)
            return d[k] + self.rate * (host_us - t[k])
        if side == "early":
            return d[i - 1] + self.rate * (host_us - t[i - 1])
        if side == "late":
            return d[i] + self.rate * (host_us - t[i])
        return d[i - 1] + (d[i] - d[i - 1]) * (host_us - t[i - 1]) / (t[i] - t[i - 1])


def anchors(rec) -> List:
    """The ``sync`` spans of the steps' staging, in the order they opened."""
    stage = {s.id for s in rec.spans if s.name == "step.stage"}
    return [s for s in rec.spans if s.name == "sync" and s.parent in stage]


def copies(seg) -> List[Tuple[str, float, float]]:
    """The segment's pageable host-to-device copies, in start order."""
    return sorted((e for e in seg.events if all(k in e[0] for k in COPY)), key=lambda e: e[1])


def align(seg, rec) -> Optional[Alignment]:
    """The offsets that put the spans on the segment's clock, or None."""
    spans, events = anchors(rec), copies(seg)
    if not spans or len(spans) != len(events):
        return None
    stage_of = {s.id: s.parent for s in rec.spans if s.name == "step.stage"}
    steps: Dict[int, List[Tuple[object, Tuple[str, float, float]]]] = {}
    for span, event in zip(spans, events):
        steps.setdefault(stage_of[span.parent], []).append((span, event))
    times, offsets, wake, misfit = [], [], 0.0, 0.0
    for pairs in steps.values():
        d, t = min((s.end_ns / 1e3 - e[2], s.end_ns / 1e3) for s, e in pairs)
        for s, e in pairs:
            wake = max(wake, s.end_ns / 1e3 - e[2] - d)
            misfit = max(misfit, s.start_ns / 1e3 - (e[1] + d), (e[2] + d) - s.end_ns / 1e3)
        times.append(t)
        offsets.append(d)
    if misfit > MAX_MISFIT_US:
        return None
    rates = [(offsets[i + 1] - offsets[i]) / (times[i + 1] - times[i])
             for i in range(len(times) - 1)]
    rate = statistics.median(rates) if rates else 0.0
    jump = max((abs(offsets[i + 1] - offsets[i] - rate * (times[i + 1] - times[i]))
                for i in range(len(times) - 1)), default=0.0)
    return Alignment(times, offsets, rate, wake, misfit, jump, len(spans))


def idle_intervals(seg, start: float, end: float) -> List[Tuple[float, float]]:
    """The gaps in the union of the segment's events within [start, end]
    (device microseconds)."""
    gaps, at = [], start
    for _, s, e in sorted(seg.events, key=lambda ev: ev[1]):
        if s > at:
            gaps.append((at, min(s, end)))
        at = max(at, e)
        if at >= end:
            break
    if at < end:
        gaps.append((at, end))
    return [(a, b) for a, b in gaps if b > a]


def innermost(rec, alignment: Alignment) -> Tuple[List[float], List[Tuple[Optional[str], bool]]]:
    """The innermost open span as a step function on the device clock:
    change times and, from each on, (its name or None, whether a ``step``
    is open)."""
    times, labels, stack = [], [], []

    def mark(t_ns):
        t = t_ns / 1e3
        times.append(t - alignment.offset(t))
        labels.append((stack[-1].name if stack else None, any(s.name == "step" for s in stack)))

    for s in sorted((s for s in rec.spans if s.end_ns is not None), key=lambda s: s.start_ns):
        while stack and stack[-1].end_ns <= s.start_ns:
            mark(stack.pop().end_ns)
        stack.append(s)
        mark(s.start_ns)
    while stack:
        mark(stack.pop().end_ns)
    return times, labels


@dataclass
class Idle:
    by_span: Dict[Optional[str], float]  # idle us by the innermost open span (None: outside all)
    in_step_us: float  # idle us while a ``step`` span is open
    idle_us: float  # idle us in the window
    window: Tuple[float, float]  # the segment's window on the device clock


def idle_by_span(seg, rec, alignment: Alignment) -> Idle:
    first = min(s.start_ns for s in rec.spans) / 1e3
    start = first - alignment.offset(first)
    end = start + seg.wall_s * 1e6
    times, labels = innermost(rec, alignment)
    by_span: Dict[Optional[str], float] = {}
    in_step = total = 0.0
    for a, b in idle_intervals(seg, start, end):
        total += b - a
        i = bisect.bisect_right(times, a) - 1
        while a < b:
            name, stepping = labels[i] if i >= 0 else (None, False)
            nxt = times[i + 1] if i + 1 < len(times) else float("inf")
            piece = min(b, nxt) - a
            by_span[name] = by_span.get(name, 0.0) + piece
            in_step += piece if stepping else 0.0
            a, i = min(b, nxt), i + 1
    return Idle(by_span, in_step, total, (start, end))


def idle_in_step(seg, rec, alignment: Alignment) -> Optional[float]:
    """Device-idle us while a ``step`` span is open, or None where it is
    unsure by more than ``MAX_UNSURE`` of the segment's wall: a step's
    start or end between two anchors lies on the device clock anywhere
    between the earlier and the later step's line (where the clocks jumped
    between them), and the idle time in that range may fall on either side
    of it."""
    idle = idle_by_span(seg, rec, alignment)
    gaps = idle_intervals(seg, *idle.window)
    starts = [a for a, _ in gaps]
    unsure = 0.0
    for s in rec.spans:
        if s.name != "step" or s.end_ns is None:
            continue
        for t in (s.start_ns / 1e3, s.end_ns / 1e3):
            a, b = sorted((t - alignment.offset(t, "early"), t - alignment.offset(t, "late")))
            i = max(bisect.bisect_right(starts, a) - 1, 0)
            while i < len(gaps) and gaps[i][0] < b:  # the idle within [a, b]
                unsure += max(0.0, min(b, gaps[i][1]) - max(a, gaps[i][0]))
                i += 1
    return idle.in_step_us if unsure <= MAX_UNSURE * seg.wall_s * 1e6 else None
