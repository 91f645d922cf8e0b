"""Reading a torch.profiler trace of the card: device events by name, busy
seconds (the union of their intervals) and launches by kernel.

Rewritten from ``chip_smoke.py``'s ``profiled``, ``device_events`` and
``device_work`` (chip_smoke.py:1627-1670) and ``trace_launches``
(chip_smoke.py:3219), which also sees a CUDA graph's replayed kernels. A
trace can miss its first kernels, so a segment starts with a marker kernel
(a short sleep) and only what starts after it counts.
"""

from __future__ import annotations

import re
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

import torch

MARK = "spin"  # the name of torch.cuda._sleep's kernel holds it
FWD_KERNEL_TRAIN = re.compile(r"flash_fwd_kernel(?:<[^,]+, (true|false)|I\w{1,24}?Lb([01])E)")


@dataclass
class Segment:
    wall_s: float  # host seconds from the synchronized start to the synchronized end
    events: List[Tuple[str, float, float]] = field(default_factory=list)  # (name, start us, end us)

    def busy_s(self) -> float:
        spans = sorted((s, e) for _, s, e in self.events)
        busy, cur_s, cur_e = 0.0, None, None
        for s, e in spans:
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            busy += cur_e - cur_s
        return busy / 1e6

    def by_name(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, s, e in self.events:
            out[name] = out.get(name, 0.0) + (e - s) / 1e6
        return out

    def idle_gaps(self, n: int = 10) -> List[Tuple[str, float]]:
        """The longest gaps between device events, named by the event that
        ends each."""
        spans = sorted(self.events, key=lambda x: x[1])
        gaps, end = [], None
        for name, s, e in spans:
            if end is not None and s > end:
                gaps.append((f"before {name[:80]}", (s - end) / 1e6))
            end = e if end is None else max(end, e)
        return sorted(gaps, key=lambda g: -g[1])[:n]


def _device_events(prof):
    """The device's events, each (name, start us, end us)."""
    from torch.autograd import DeviceType

    return [(e.name, float(e.time_range.start), float(e.time_range.end))
            for e in prof.events()
            if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]


def traced(run: Callable[[], None], device) -> Segment:
    """``run()`` under torch.profiler (the card's activity alone), between
    two synchronizations: its wall seconds and the device events that start
    after the marker kernel. On the CPU, ``run()`` alone: no device events."""
    from torch.profiler import ProfilerActivity, profile

    if torch.device(device).type != "cuda":
        t0 = time.perf_counter()
        run()
        return Segment(time.perf_counter() - t0)

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(100_000)
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    events = _device_events(prof)
    marks = [e for n, _, e in events if MARK in n.lower()]
    if not marks:
        raise RuntimeError("the trace holds no marker kernel: no device events were recorded")
    after = max(marks)
    return Segment(wall, [ev for ev in events if ev[1] >= after and MARK not in ev[0].lower()])


def attention_kernel(name: str):
    """"K2".."K5" for an attention kernel's trace name, else None."""
    if "flash_bwd_dkv_kernel" in name:
        return "K5"
    if "flash_bwd_dq_kernel" in name:
        return "K4"
    if "flash_fwd_kernel" in name:
        m = FWD_KERNEL_TRAIN.search(name)
        if m is None:
            raise RuntimeError(f"cannot tell K2 from K3 in the trace's name {name}")
        return "K3" if ("true" in m.groups() or "1" in m.groups()) else "K2"
    return None
