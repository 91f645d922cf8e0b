"""The window's share of the card's bf16 peak: 3x the analytic forward
FLOPs of every microbatch at its real frame and target counts
(``flops.forward_flops``) over the window's seconds and 989 TFLOP/s."""

from h100bench.flops import PEAK_BF16_FLOPS


def read(ctx):
    if not ctx.get("train_flops") or not ctx.get("window_s"):
        return None
    return 100.0 * ctx["train_flops"] / ctx["window_s"] / PEAK_BF16_FLOPS
