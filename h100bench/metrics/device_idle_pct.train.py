"""Share of the traced segment's wall time in which no device operation
ran (the union of the trace's kernel, copy and fill intervals)."""


def read(ctx):
    seg = ctx.get("segment")
    if seg is None or seg.wall_s <= 0 or not seg.events:
        return None
    return 100.0 * (1.0 - seg.busy_s() / seg.wall_s)
