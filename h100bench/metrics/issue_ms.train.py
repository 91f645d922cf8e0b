"""Host milliseconds a microbatch of the traced segment spent issuing the
step's work: its ``step.forward``, ``step.backward`` and ``step.optimizer``
spans, less the ``sync`` spans inside them (waits for the card)."""

from h100bench.spans import ISSUE_SPANS, segment_recording


def read(ctx):
    found = segment_recording(ctx)
    if found is None:
        return None
    _, rec, steps = found
    phases = {s.id: s for s in rec.spans if s.name in ISSUE_SPANS}
    waits = sum(s.duration_ns for s in rec.spans if s.name == "sync" and s.parent in phases)
    return (sum(s.duration_ns for s in phases.values()) - waits) / 1e6 / steps
