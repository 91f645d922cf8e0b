"""Host milliseconds a microbatch spent assembling batches in the window:
the sampler's epoch lists, packing (``make_packed_batch``) and int16
staging, on the benchmark's own host-clock span around them."""


def read(ctx):
    if ctx.get("host_batch_s") is None or not ctx.get("microbatches"):
        return None
    return 1e3 * ctx["host_batch_s"] / ctx["microbatches"]
