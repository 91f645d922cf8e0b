"""Blocking host-device calls a microbatch in the traced segment: the
program's ``host_syncs`` counter over the segment's ``step`` spans."""

from h100bench.spans import segment_recording


def read(ctx):
    found = segment_recording(ctx)
    if found is None:
        return None
    _, rec, steps = found
    return rec.counts.get("host_syncs", 0) / steps
