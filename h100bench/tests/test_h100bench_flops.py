"""The yardstick's arithmetic against hand counts at small shapes."""

import pytest

from h100bench.flops import HBM_BYTES_PER_S, PEAK_BF16_FLOPS, forward_flops, train_attention_bounds

CFG = {"model_size": 4, "feed_forward_layer_size": 8, "num_channels": 2,
       "relative_distance": 3, "num_layers_encoder": 1, "num_layers_decoder": 1,
       "encoder_kind": "transformer", "conformer_conv_kernel_size": 3}


def hand_common(T, S, d=4, ff=8, C=2):
    samples = 8 * T  # 16 raw samples: 8, 4 and 2 conv outputs
    conv = 2 * (8 * (3 * C * d + 3 * d * d + C * d) + 4 * (7 * d * d) + 2 * (7 * d * d))
    w_raw_in = 2 * T * d * d
    dec = (8 * S * d * d + 4 * S * S * d + 4 * S * d * d + 4 * T * d * d + 4 * S * T * d
           + 4 * S * d * ff)
    heads = 2 * T * d * 44 + 2 * S * d * 43
    assert samples == 16
    return conv + w_raw_in + dec + heads


def test_transformer_forward_flops():
    T, S, d, ff = 2, 3, 4, 8
    relw = min(2 * 3 - 1, 2 * T - 1)  # 3
    enc = 8 * T * d * d + 4 * T * T * d + 2 * T * relw * d + 4 * T * d * ff
    assert forward_flops(CFG, T, S) == hand_common(T, S) + enc


def test_conformer_forward_flops():
    T, S, d, ff, k = 2, 3, 4, 8, 3
    cfg = dict(CFG, encoder_kind="conformer")
    attn = 8 * T * d * d + 4 * T * T * d + 2 * T * 3 * d
    conv_module = 2 * T * d * (2 * d) + 2 * T * d * k + 2 * T * d * d
    enc = 2 * 4 * T * d * ff + attn + conv_module
    assert forward_flops(cfg, T, S) == hand_common(T, S) + enc


def test_attention_bounds_by_hand():
    B, H, T, Dh = 1, 1, 2, 2
    b = train_attention_bounds(B, H, T, Dh)
    work = B * H * T * T * Dh  # 8
    n, rows, window = 4, 8, 6
    common = window * 2 + 3 * 4 + B * T + 4
    fwd_bytes = 3 * n * 2 + common + n * 4 + rows
    # tiny shapes are bound by their bytes
    assert b["K3"] == pytest.approx(max(fwd_bytes / HBM_BYTES_PER_S, 6 * work / PEAK_BF16_FLOPS))
    bwd_in = 4 * n * 2 + common + 2 * rows
    assert b["K4"] == pytest.approx(max((bwd_in + n * 4 + window * 4) / HBM_BYTES_PER_S,
                                        12 * work / PEAK_BF16_FLOPS))
    assert b["K5"] == pytest.approx(max((bwd_in + 2 * n * 4) / HBM_BYTES_PER_S,
                                        10 * work / PEAK_BF16_FLOPS))


def test_flagship_bounds_match_the_kernel_table():
    # PERF.md's bf16 rows at B=32, H=8, T=384, Dh=96: K3 0.0286 ms (bytes),
    # K4 0.0440 ms (operations)
    b = train_attention_bounds(32, 8, 384, 96)
    assert b["K3"] * 1e3 == pytest.approx(0.0286, abs=5e-5)
    assert b["K4"] == pytest.approx(12 * 32 * 8 * 384 * 384 * 96 / PEAK_BF16_FLOPS)
    assert b["K4"] * 1e3 == pytest.approx(0.0440, abs=5e-5)


@pytest.mark.parametrize("T", [192, 384])
def test_attention_roofline_counts_the_launch_t(T):
    """K3-K5's share counts the work at the microbatch's own frame bucket,
    not at a kernel's tile: at T=192 the bound is that of T=192."""
    from h100bench import run
    from h100bench.trace import Segment

    B, H, Dh, layers = 13, 8, 96, 2
    names = ["flash_fwd_kernel<bf16, true, 96>", "flash_bwd_dq_kernel<bf16>",
             "flash_bwd_dkv_kernel<bf16>"]
    events, t = [], 0.0
    for _ in range(layers):
        for name in names:
            events.append((name, t, t + 100.0))  # 100 us each
            t += 200.0
    ctx = {"segment": Segment(1.0, events), "segment_shapes": [(B, T)], "layers": layers,
           "heads": H, "head_dim": Dh}
    share = run.load_module("metrics", "attn_roofline_pct.train").read(ctx)
    want = layers * sum(train_attention_bounds(B, H, T, Dh).values())
    assert share == pytest.approx(100.0 * want / (3 * layers * 100e-6))
