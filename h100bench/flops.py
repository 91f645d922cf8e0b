"""The yardstick's arithmetic: the card's peaks, a forward pass's analytic
FLOPs at real lengths, and the attention kernels' bounds.

``forward_flops`` is ``bench.py::analytic_fwd_flops`` (bench.py:356-390)
rewritten per utterance at its real frame and target counts, with a
conformer branch (Gulati et al.: two half-step feed-forwards, the relative
self-attention, and the convolution module's pointwise, depthwise and
pointwise products). ``bound`` and ``train_attention_bounds`` are copies of
``chip_smoke.py``'s (chip_smoke.py:300, :533).
"""

from __future__ import annotations

# NVIDIA H100 SXM, dense (the data sheet), at the card's full 700 W
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def forward_flops(cfg: dict, frames: int, targets: int) -> float:
    """2 x multiply-adds of one utterance's forward pass: ``frames`` encoder
    frames (8 raw samples each), ``targets`` decoder positions."""
    d, ff, C = cfg["model_size"], cfg["feed_forward_layer_size"], cfg["num_channels"]
    M = cfg["relative_distance"]
    T, S = frames, targets
    samples = 8 * T
    t1, t2, t3 = samples // 2, samples // 4, samples // 8
    conv = (t1 * (3 * C * d + 3 * d * d + C * d) + t2 * (3 * d * d + 3 * d * d + d * d)
            + t3 * (3 * d * d + 3 * d * d + d * d))
    conv *= 2
    w_raw_in = 2 * T * d * d
    relw = min(2 * M - 1, 2 * T - 1)
    attn = 8 * T * d * d + 4 * T * T * d + 2 * T * relw * d
    if cfg["encoder_kind"] == "conformer":
        k = cfg["conformer_conv_kernel_size"]
        conv_module = 4 * T * d * d + 2 * T * d * k + 2 * T * d * d
        enc_layer = 2 * (4 * T * d * ff) + attn + conv_module
    else:
        enc_layer = attn + 4 * T * d * ff
    dec_layer = (8 * S * d * d + 4 * S * S * d + 4 * S * d * d + 4 * T * d * d + 4 * S * T * d
                 + 4 * S * d * ff)
    heads = 2 * T * d * 44 + 2 * S * d * 43
    return float(conv + w_raw_in + cfg["num_layers_encoder"] * enc_layer
                 + cfg["num_layers_decoder"] * dec_layer + heads)


def bound(bytes_moved: float, flops: float, peak: float):
    """(least seconds, what bounds it): bytes at the HBM rate or operations
    at ``peak``."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = flops / peak
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def train_attention_bounds(B: int, H: int, T: int, Dh: int, size: int = 2) -> dict:
    """Least seconds of K3, K4 and K5 at one launch's shape: each input read
    once, each output written once, against 6, 12 and 10 * B*H*T*T*Dh
    operations at the bf16 peak (``size``: bytes of an element)."""
    n, rows, window = B * H * T * Dh, B * H * T * 4, H * (2 * T - 1) * Dh
    common = window * size + (2 * T - 1) * 4 + B * T + 4  # used, oob, key pads, seed
    bwd_in = 4 * n * size + common + 2 * rows  # q, k, v, dO, lse, delta
    work = B * H * T * T * Dh
    return {
        "K3": bound(3 * n * size + common + n * 4 + rows, 6.0 * work, PEAK_BF16_FLOPS)[0],
        "K4": bound(bwd_in + n * 4 + window * 4, 12.0 * work, PEAK_BF16_FLOPS)[0],
        "K5": bound(bwd_in + 2 * n * 4, 10.0 * work, PEAK_BF16_FLOPS)[0],
    }

