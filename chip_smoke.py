"""Drive the PyTorch port (emg_tpu_torch) on one NVIDIA GPU, end to end.

    python3 chip_smoke.py [--out PATH]

Phases, in order; any failure exits non-zero:
  1. build the CUDA kernels from ops/csrc (one nvcc per source, in parallel)
     and print the card's name and power limit;
  2. kernel 1 (iir_scan) against its plain PyTorch version on the card;
  3. kernel 2 (flash_attention_relpos) against its plain version, with
     scaled_dot_product_attention over a materialized bias timed beside it
     as a yardstick (the port never calls it);
  4. the serving path at full width (768-d, 6+6 layers, 8 heads, bfloat16,
     random weights from a seeded torch.Generator) through the port's CLI
     entry point on a synthetic corpus, with the kernels' launch counts
     taken over that run alone, and the per-utterance time of DSP, encode
     and decode;
  5. the same path in float32 with the kernels and with their plain
     versions: DSP outputs and encoder memory agree, greedy strings match.
The second-to-last line is a JSON object with one record per kernel; the
last line is {"ok": true, "device": {...}}. ``--out`` also writes every
measurement to a JSON file.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense, no TF32
K1_TOL = 2e-4  # relative to the output's magnitude
K2_TOL = {torch.float32: 2e-3, torch.bfloat16: 2e-2}  # bf16: ~2 bf16 ulps of |out|
MEMORY_TOL = 2e-3
DSP_TOL = {"features": 1.6e-3, "signal": 2e-4, "edge_rel": 1e-3}  # PARITY.md
MARGIN_TOL = 1e-3
DEVICE = "cuda"
SPIN_CYCLES = 400_000_000  # ~0.2 s at the H100's boost clock


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device time per call of fn(), by CUDA events over ``iters`` warm
    calls. The calls queue behind a spin kernel, so the card runs them back
    to back and the host's launch overhead stays out of the figure."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def call_ms(fn, iters: int = 20) -> float:
    """Host wall time per synchronized call: what a caller waits for one
    call, the wrapper's Python and launch overhead included."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def bound(bytes_moved: float, flops: float, peak: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 2: kernel 1
# ---------------------------------------------------------------------------

def check_iir_scan(record):
    from emg_tpu_torch.ops.iir_scan import iir_scan, iir_scan_plain

    gen = torch.Generator().manual_seed(1)
    rows = []
    for R in (16, 24):
        for T in (4096 + 25, 16384 + 19):
            radius = 0.8 + 0.199 * torch.rand(R, generator=gen)
            angle = 0.6 * torch.rand(R, generator=gen) - 0.3
            args = [radius * torch.cos(angle), radius * torch.sin(angle),
                    torch.randn(R, T, generator=gen), torch.randn(R, T, generator=gen),
                    torch.randn(R, generator=gen), torch.randn(R, generator=gen)]
            args = [a.to(DEVICE) for a in args]
            for reverse in (False, True):
                got = iir_scan(*args, reverse=reverse)
                ref = iir_scan_plain(*args, reverse=reverse)
                torch.cuda.synchronize()
                err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
                scale = max(float(r.abs().max()) for r in ref)
                ms = time_ms(lambda: iir_scan(*args, reverse=reverse))
                wrapper_ms = call_ms(lambda: iir_scan(*args, reverse=reverse))
                plain_ms = time_ms(lambda: iir_scan_plain(*args, reverse=reverse))
                b_ms, b_by = bound(16.0 * R * T, 8.0 * R * T, PEAK_FLOPS[torch.float32])
                row = dict(R=R, T=T, reverse=reverse, max_abs_err=err, rel_err=err / scale,
                           ms=ms, call_ms=wrapper_ms, plain_ms=plain_ms, bound_ms=b_ms,
                           bound_by=b_by)
                rows.append(row)
                log(f"K1 iir_scan {json.dumps(row)}")
                if not err <= K1_TOL * scale:
                    raise AssertionError(f"iir_scan disagrees with its plain version: {row}")
    record["iir_scan"] = rows
    # the JSON line reports the notch filters' shape at the 16384 bucket
    # (R = 8 channels x 2 states, T = 16384 + 2*9 + 1), forward
    return next(r for r in rows if r["R"] == 16 and r["T"] == 16384 + 19 and not r["reverse"])


# ---------------------------------------------------------------------------
# phase 3: kernel 2
# ---------------------------------------------------------------------------

def check_flash_attention(record):
    import torch.nn.functional as F

    from emg_tpu_torch.models.attention import LearnedRelativePositionalBias, relpos_self_attention
    from emg_tpu_torch.ops.flash_attention import (
        flash_attention_relpos,
        flash_attention_relpos_plain,
        relative_index,
    )

    H, Dh, maxpos = 8, 96, 300
    gen = torch.Generator().manual_seed(2)
    relpos = LearnedRelativePositionalBias(maxpos, H, Dh)
    with torch.no_grad():
        relpos.embeddings.copy_(torch.randn(relpos.embeddings.shape, generator=gen) * Dh ** -0.5)
    relpos = relpos.to(DEVICE)
    rows = []
    for B in (1, 8):
        for T in (192, 256, 384, 512):
            for dtype in (torch.float32, torch.bfloat16):
                q, k, v = (torch.randn(B, H, T, Dh, generator=gen).to(DEVICE, dtype)
                           for _ in range(3))
                kp = torch.zeros(B, T, dtype=torch.bool)
                for b in range(B):
                    kp[b, T - (b * 37) % (T // 2):] = True
                kp = kp.to(DEVICE)
                with torch.no_grad():
                    if T % 128:  # ragged bucket: the encoder's padding path
                        def run():
                            return relpos_self_attention(q, k, v, relpos, kp)
                        with mock.patch("emg_tpu_torch.models.attention.flash_attention_relpos",
                                        flash_attention_relpos_plain):
                            ref = run()
                        got = run()
                    else:
                        used, oob = relpos.window(T)
                        used = used.to(dtype)

                        def run():
                            return flash_attention_relpos(q, k, v, used, oob, kp)
                        ref = flash_attention_relpos_plain(q, k, v, used, oob, kp)
                        got = run()
                        plain_ms = time_ms(lambda: flash_attention_relpos_plain(q, k, v, used, oob, kp))
                        # yardstick: SDPA over the same logits, the relative
                        # term and key pads materialized as an additive mask
                        rel = torch.einsum("bhqd,hmd->bhqm", q.float(), used.float()) + oob
                        bias = torch.gather(rel, 3, relative_index(T, q.device).expand(B, H, T, T))
                        bias = (bias + torch.where(kp, -1e8, 0.0)[:, None, None, :]).to(dtype)
                        library_ms = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias))
                        lib_out = F.scaled_dot_product_attention(q, k, v, attn_mask=bias).float()
                    torch.cuda.synchronize()
                valid = ~kp[:, None, :, None].expand_as(got)
                err = float((got - ref).abs()[valid].max())
                row = dict(B=B, H=H, T=T, Dh=Dh, dtype=str(dtype).split(".")[-1], max_abs_err=err)
                if T % 128 == 0:
                    size = 2 if dtype == torch.bfloat16 else 4
                    bytes_moved = (3 * B * H * T * Dh + H * (2 * T - 1) * Dh) * size \
                        + (2 * T - 1) * 4 + B * T + B * H * T * Dh * 4
                    flops = 6.0 * B * H * T * T * Dh  # q.k, q.used and p.v per (i, j)
                    b_ms, b_by = bound(bytes_moved, flops, PEAK_FLOPS[dtype])
                    row.update(ms=time_ms(run), call_ms=call_ms(run), plain_ms=plain_ms,
                               library_ms=library_ms,
                               bound_ms=b_ms, bound_by=b_by,
                               library_err=float((lib_out - ref).abs()[valid].max()))
                rows.append(row)
                log(f"K2 flash_attention_relpos {json.dumps(row)}")
                if not err <= K2_TOL[dtype]:
                    raise AssertionError(f"flash_attention_relpos disagrees with its plain version: {row}")
    record["flash_attention_relpos"] = rows
    # the JSON line reports batch-1 bfloat16 serving at the 256 bucket
    return next(r for r in rows if r["B"] == 1 and r["T"] == 256 and r["dtype"] == "bfloat16")


# ---------------------------------------------------------------------------
# phases 4 and 5: the serving path
# ---------------------------------------------------------------------------

def make_corpus(root: str):
    from emg_tpu_torch.config import Config
    from emg_tpu_torch.data.dataset import make_normalizers
    from emg_tpu_torch.data.fixtures import make_reference_scale_corpus

    paths = make_reference_scale_corpus(
        root, seed=0, n_sessions=1, sentences_per_session=24, n_dev=2, n_test=8,
        n_nonparallel=2, min_len=1400, max_len=4200,
    )
    argv = [
        "--silent_data_directories", paths["silent_data_directories"],
        "--voiced_data_directories", paths["voiced_data_directories"],
        "--testset_file", paths["testset_file"], "--dict", paths["dict"],
        "--normalizers_file", os.path.join(root, "normalizers.pkl"),
        "--output_directory", os.path.join(root, "out"),
    ]
    make_normalizers(Config.from_args(argv), device=DEVICE)
    return argv


def utterance_input(testset, i):
    """The DSP buffer the dataset builds for test utterance i: the utterance
    between its neighbors, zero-padded to its bucket."""
    from emg_tpu_torch.data.dataset import dsp_input

    directory, idx = testset.example_indices[i]
    base = directory.directory
    raw = np.load(os.path.join(base, f"{idx}_emg.npy"))
    before, after = (
        np.load(p) if os.path.exists(p) else np.zeros([0, raw.shape[1]])
        for p in (os.path.join(base, f"{idx - 1}_emg.npy"), os.path.join(base, f"{idx + 1}_emg.npy"))
    )
    return dsp_input(raw, before, after)


def stage_times(cfg, model, testset):
    """Per-utterance device time of DSP, encode and decode (host clock
    around synchronized work), over the test split, warm."""
    from emg_tpu_torch.cli import prepare_single
    from emg_tpu_torch.decode.greedy import encode_batch, greedy_loop
    from emg_tpu_torch.dsp.pipeline import preprocess_emg

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    totals = {"dsp": [], "encode": [], "decode": []}
    buckets = []
    for i in range(len(testset)):
        buf, n, n_before, n_after = utterance_input(testset, i)
        x = torch.as_tensor(buf, device=DEVICE)
        pb, max_frames, example = prepare_single(cfg, testset, i)
        S_true = int(example["phonemes_int_lengths"][0])
        with torch.inference_mode():
            for _ in range(2):  # the second pass is warm
                _, dsp_ms = timed(lambda: preprocess_emg(x, n, n_before, n_after))
                (mem, _, mask), enc_ms = timed(lambda: encode_batch(model, pb, max_frames))
                _, dec_ms = timed(lambda: greedy_loop(model, mem, mask, pb.targets.shape[1] - 1,
                                                      S_true - 1))
        totals["dsp"].append(dsp_ms)
        totals["encode"].append(enc_ms)
        totals["decode"].append(dec_ms)
        buckets.append((buf.shape[0], max_frames))
    return {k: float(np.mean(v)) for k, v in totals.items()}, buckets


def serve(argv, ckpt, record):
    from emg_tpu_torch import cli
    from emg_tpu_torch.config import Config
    from emg_tpu_torch.data.dataset import EMGDataset
    from emg_tpu_torch.ops.flash_attention import flash_attention_relpos
    from emg_tpu_torch.ops.iir_scan import iir_scan

    full = argv + ["--device", DEVICE, "--evaluate_saved_greedy_search", ckpt]
    iir_scan.launches = 0
    flash_attention_relpos.launches = 0
    t0 = time.perf_counter()
    per, acc = cli.main(full)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"iir_scan": iir_scan.launches,
                "flash_attention_relpos": flash_attention_relpos.launches}
    logging.getLogger().handlers.clear()

    cfg = Config.from_args(argv)
    testset = EMGDataset(cfg, test=True, device=DEVICE)
    model = cli.load_model_for_eval(cfg, ckpt, DEVICE)
    times, buckets = stage_times(cfg, model, testset)
    result = dict(per=per, accuracy=acc, utterances=len(testset), cli_wall_s=wall,
                  launches=launches, ms_per_utterance=times,
                  buckets=[{"dsp_samples": d, "frames": f} for d, f in buckets])
    record["serving"] = result
    log(f"serving {json.dumps(result)}")
    if not all(n > 0 for n in launches.values()):
        raise AssertionError(f"a kernel of the main path was never launched: {launches}")
    if not 0.0 <= per < float("inf"):
        raise AssertionError(f"PER is not a finite rate: {per}")
    return launches


def first_divergence_margin(model, memory, mask, a, b):
    """Teacher-force the common prefix of token rows a and b; return the
    logit gap between their two choices at the first differing step."""
    s = int(np.nonzero(a != b)[0][0])
    caches = model.init_decode_cache(1, len(a))
    kvs = model.project_cross_kvs(memory)
    tokens = torch.as_tensor(a[None], device=memory.device)
    for step in range(s):
        logits = model.decode_step(tokens[:, step], step, caches, kvs, tokens, mask)
    return float((logits[0, int(a[s])] - logits[0, int(b[s])]).abs())


def whole_path_kernels_vs_plain(argv, ckpt, record):
    from emg_tpu_torch import cli
    from emg_tpu_torch.config import Config
    from emg_tpu_torch.data.dataset import EMGDataset
    from emg_tpu_torch.decode.greedy import encode_batch, greedy_loop
    from emg_tpu_torch.dsp.pipeline import preprocess_emg
    from emg_tpu_torch.ops.flash_attention import flash_attention_relpos_plain
    from emg_tpu_torch.ops.iir_scan import iir_scan_plain

    plain = [mock.patch("emg_tpu_torch.dsp.filters.iir_scan", iir_scan_plain),
             mock.patch("emg_tpu_torch.models.attention.flash_attention_relpos",
                        flash_attention_relpos_plain)]
    cfg = Config.from_args(argv + ["--decode.compute_dtype", "float32"])
    testset = EMGDataset(cfg, test=True, device=DEVICE)
    model = cli.load_model_for_eval(cfg, ckpt, DEVICE)
    worst = {"features": 0.0, "signal": 0.0, "edge_rel": 0.0, "memory": 0.0}
    differing = []
    for i in range(len(testset)):
        buf, n, n_before, n_after = utterance_input(testset, i)
        x = torch.as_tensor(buf, device=DEVICE)
        pb, max_frames, example = cli.prepare_single(cfg, testset, i)
        cap, steps = pb.targets.shape[1] - 1, int(example["phonemes_int_lengths"][0]) - 1
        with torch.inference_mode():
            dk = preprocess_emg(x, n, n_before, n_after)
            mk, _, mask = encode_batch(model, pb, max_frames)
            ok, _ = greedy_loop(model, mk, mask, cap, steps)
            with plain[0], plain[1]:
                dp = preprocess_emg(x, n, n_before, n_after)
                mp, _, _ = encode_batch(model, pb, max_frames)
                op, _ = greedy_loop(model, mp, mask, cap, steps)
        # PARITY.md's DSP bounds. Padded by neighbors on both sides (the
        # usual case), an utterance is held to the bulk bounds: features
        # ~1.6e-3 and signals ~2e-4 absolute at the reference's ~±50 signal
        # scale, scaled with its amplitude. An utterance with an end that
        # no neighbor pads is held to filtfilt's edge bound, ~1e-3 of its
        # peak: the 2 Hz high-pass's float32 transient from that end reaches
        # through the whole short utterance, and differs as much between
        # two runs of the plain version (on the card and on the CPU).
        padded = n_before > 0 and n_after > 0
        for key, a, b in (
            ("features", dk.emg_features[: dk.n_frames], dp.emg_features[: dp.n_frames]),
            ("signal", dk.emg[: dk.n_feat], dp.emg[: dp.n_feat]),
            ("signal", dk.emg_orig[: dk.n_raw], dp.emg_orig[: dp.n_raw]),
        ):
            err, peak = float((a - b).abs().max()), float(b.abs().max())
            if padded:
                worst[key] = max(worst[key], err / max(1.0, peak / 50.0))
            else:
                worst["edge_rel"] = max(worst["edge_rel"], err / peak)
        valid = ~mask
        worst["memory"] = max(worst["memory"], float((mk - mp).abs()[valid].max()))
        ok, op = ok.cpu().numpy()[0], op.cpu().numpy()[0]
        if not np.array_equal(ok, op):
            with torch.inference_mode():
                margin = first_divergence_margin(model, mk, mask, ok, op)
            differing.append({"utterance": i, "margin": margin})
            log(f"whole path: utterance {i} greedy tokens differ; logit margin {margin}")
    result = dict(utterances=len(testset), worst=worst, differing=differing)
    record["whole_path_f32"] = result
    log(f"whole path kernels vs plain (float32) {json.dumps(result)}")
    if not (worst["features"] <= DSP_TOL["features"] and worst["signal"] <= DSP_TOL["signal"]
            and worst["edge_rel"] <= DSP_TOL["edge_rel"]):
        raise AssertionError(f"DSP with kernel 1 disagrees with its plain version: {worst}")
    if not worst["memory"] <= MEMORY_TOL:
        raise AssertionError(f"encoder memory with kernel 2 disagrees: {worst}")
    if any(d["margin"] >= MARGIN_TOL for d in differing):
        raise AssertionError(f"greedy strings differ at a clear margin: {differing}")


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", help="also write every measurement to this JSON file")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on a GPU", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from emg_tpu_torch.models.model import EMGModel
    from emg_tpu_torch.config import ModelConfig
    from emg_tpu_torch.ops import build

    logging.basicConfig(level=logging.INFO, format="%(message)s")
    started = time.perf_counter()
    record = {"torch": torch.__version__, "cuda": torch.version.cuda}

    log("phase 1: build")
    t0 = time.perf_counter()
    build.load_kernels()
    record["build_s"] = time.perf_counter() - t0
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    record["card"] = smi
    log(f"built in {record['build_s']:.1f} s; torch {torch.__version__}, CUDA {torch.version.cuda}")

    log("phase 2: kernel 1 vs plain")
    k1 = check_iir_scan(record)
    log("phase 3: kernel 2 vs plain")
    k2 = check_flash_attention(record)

    with tempfile.TemporaryDirectory() as root:
        log("phase 4: serving path at full width")
        argv = make_corpus(root)
        ckpt = os.path.join(root, "model.pt")
        model = EMGModel(ModelConfig(), device=DEVICE, generator=torch.Generator().manual_seed(0))
        torch.save(model.state_dict(), ckpt)
        del model
        launches = serve(argv, ckpt, record)
        log("phase 5: whole path, kernels vs plain, float32")
        whole_path_kernels_vs_plain(argv, ckpt, record)

    kernels = []
    for name, row, source, replaces, lib in (
        ("iir_scan", k1, "emg_tpu_torch/ops/csrc/iir_scan.cu",
         "emg_tpu/ops/pallas/iir_scan.py:96", None),
        ("flash_attention_relpos", k2, "emg_tpu_torch/ops/csrc/flash_attention_relpos.cu",
         "emg_tpu/ops/pallas/flash_attention.py:125", "library_ms"),
    ):
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row[lib] if lib else None,
        })
    record["kernels"] = kernels
    record["total_s"] = time.perf_counter() - started
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    log(f"total {record['total_s']:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
