"""K3-K5's share of their roofline in the traced segment: the sum of each
launch's bound (``flops.train_attention_bounds`` at the launch's B, H, T,
Dh, bf16: T is the microbatch's frame bucket, as the encoder attends over
it, whatever tile a kernel pads it to) over the sum of those launches'
device time, by kernel name. Each microbatch launches K3, K4 and K5 once
an encoder layer; a segment whose launch counts differ from that reads
nothing."""

from h100bench.flops import train_attention_bounds
from h100bench.trace import attention_kernel


def read(ctx):
    seg, shapes = ctx.get("segment"), ctx.get("segment_shapes")
    if seg is None or not shapes:
        return None
    times = {"K3": 0.0, "K4": 0.0, "K5": 0.0}
    counts = dict.fromkeys(times, 0)
    for name, start, end in seg.events:
        k = attention_kernel(name)
        if k in times:
            times[k] += (end - start) / 1e6
            counts[k] += 1
    want = ctx["layers"] * len(shapes)
    if any(c != want for c in counts.values()):
        return None
    total = 0.0
    for B, T in shapes:
        total += ctx["layers"] * sum(
            train_attention_bounds(B, ctx["heads"], T, ctx["head_dim"]).values())
    return 100.0 * total / sum(times.values())
