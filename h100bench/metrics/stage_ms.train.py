"""Host milliseconds a microbatch of the traced segment spent in the step's
``step.stage`` span: ``stage_batch`` and the batch's copies to the card,
each of which waits for the stream to run it."""

from h100bench.spans import segment_recording


def read(ctx):
    found = segment_recording(ctx)
    if found is None:
        return None
    _, rec, steps = found
    return sum(s.duration_ns for s in rec.spans if s.name == "step.stage") / 1e6 / steps
