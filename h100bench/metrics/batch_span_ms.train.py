"""Host milliseconds a microbatch of the traced segment spent assembling
batches, timed from inside the program: its ``data.sampler`` (an epoch's
batch lists), ``window.plan``, ``data.pack`` and ``data.int16`` spans, over
the segment's ``step`` spans (``host_batch_ms.train`` times the same work
from the benchmark's side, the sampler aside)."""

from h100bench.spans import BATCH_SPANS, segment_recording


def read(ctx):
    found = segment_recording(ctx)
    if found is None:
        return None
    _, rec, steps = found
    return sum(s.duration_ns for s in rec.spans if s.name in BATCH_SPANS) / 1e6 / steps
