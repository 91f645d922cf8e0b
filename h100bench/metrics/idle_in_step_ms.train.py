"""Device-idle milliseconds a microbatch that fall inside the program's
``step`` spans: the traced segment's idle time (its wall less the union of
its events, as ``device_idle_pct.train`` takes it) on the spans' clock
(``spans.align``; nothing where the anchors do not line up, or where a
jump of the clocks between two steps leaves it unsure: ``spans.idle_in_step``),
over the segment's ``step`` spans."""

from h100bench.spans import align, idle_in_step, segment_recording


def read(ctx):
    found = segment_recording(ctx)
    if found is None:
        return None
    seg, rec, steps = found
    alignment = align(seg, rec)
    if alignment is None:
        return None
    idle = idle_in_step(seg, rec, alignment)
    return None if idle is None else idle / 1e3 / steps
