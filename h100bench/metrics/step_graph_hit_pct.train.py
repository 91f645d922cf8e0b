"""Share of the traced segment's microbatches that replayed a step graph
captured at an earlier microbatch: the program's ``step_graphs.replay``
counter over the segment's ``step`` spans, x100. None for a program that
counts no step graph (neither a capture nor a replay): one that steps
eagerly."""

from h100bench.spans import segment_recording


def read(ctx):
    found = segment_recording(ctx)
    if found is None:
        return None
    _, rec, steps = found
    if not {"step_graphs.capture", "step_graphs.replay"} & set(rec.counts):
        return None
    return 100.0 * rec.counts.get("step_graphs.replay", 0) / steps
