"""Peak device memory allocated in the window (torch's allocator counter
after a reset at the window's start), in GB (1e9 bytes)."""


def read(ctx):
    peak = ctx.get("window_peak_bytes")
    return peak / 1e9 if peak else None
