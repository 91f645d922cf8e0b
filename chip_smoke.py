"""Drive the PyTorch port (emg_tpu_torch) on one NVIDIA GPU, end to end.

    python3 chip_smoke.py [--out PATH]

Phases, in order; any failure exits non-zero:
  1. build the CUDA kernels from ops/csrc (one nvcc per source, in parallel)
     and print the card's name and power limit; per kernel, ptxas's
     registers and spill bytes and whether its SASS holds tensor-core
     instructions (HMMA: mma.sync, HGMMA: wgmma); the forward attention
     kernels (K2, K3) and the backward dq and dk/dv kernels (K4, K5) must;
  2. kernel 1 (iir_scan) against its plain PyTorch version on the card, at
     the DSP's rows (16 and 24) over the 4096-131072 buckets and at 384
     rows (24 utterances folded onto rows): error, two calls bitwise equal,
     times beside the bytes bound and a copy of the same bytes, the
     cluster layout and how many such clusters the card holds at once;
  3. kernel 2 (flash_attention_relpos) against its plain version, with
     scaled_dot_product_attention over a materialized bias timed beside it
     as a yardstick (the port never calls it);
  4. kernels 3-5 (the training attention: forward with lse and dropout,
     backward dq/d_used, backward dk/dv) against the plain version's
     autograd, float32 and bfloat16, dropout 0 and 0.2, T 128-512, with
     SDPA's forward and forward+backward over a materialized bias timed
     beside them;
  5. the serving path at full width (768-d, 6+6 layers, 8 heads, bfloat16,
     random weights from a seeded torch.Generator) through the port's CLI
     entry point on a synthetic corpus, with the kernels' launch counts
     taken over that run alone (K1 272, K2 48: no kernel sits in a decode
     graph) and its greedy decode through CUDA graphs (a runner that
     replayed), and the per-utterance time of DSP, encode and decode;
     greedy decode three ways, warm: the CUDA graphs (k = 4 steps a
     replay), the eager loop at the same cadence (``graphed=False``) and
     the eager loop reading the card every step (the parent's loop): ms,
     steps, host reads (CUDA's sync debug mode), bitwise equal results,
     capture seconds and pool memory per geometry, one replay's device ms
     and kernels (CUDA events, torch.profiler); a torch.profiler trace of
     one warm preprocess_emg at the 16384-sample bucket (device busy ms,
     kernel 1's share, kernel count);
  6. the same path in float32 with the kernels and with their plain
     versions: DSP outputs and encoder memory agree, greedy strings match;
     greedy decode through the graphs and eagerly, bitwise equal;
  7. training at full width (the flagship at its defaults: float32,
     dropout 0.2) through the CLI's train mode on the same corpus, at the
     reference's max_batch_length, with the five kernels' launch counts over
     that run alone, its epochs' wall time, frames per second and peak
     memory; then greedy evaluation of the model.pt it wrote; the same run
     again with a synchronization between forward, backward and optimizer
     for their split; kernels 3-5 against their plain versions at every
     shape the run launched them with, timed;
  8. one float32 train step (the run's largest microbatch) with the kernels
     and with their plain versions, from the same weights, batch and
     generator seeds (dropout 0.2): losses and every parameter gradient
     agree; its unprofiled wall time and a torch.profiler trace of it;
  9. beam serving at full width: an order-3 ARPA trained by the port's
     lm_train on the corpus's sentences; the beam evaluation through the
     CLI at its defaults (bfloat16, W = 100, the device beam, 8 utterances
     a launch; its step loop through CUDA graphs) with K1's and K2's
     launches over that run alone, a finite WER and lexicon words only;
     per test utterance, warm, the encode and search ms, steps, ms per
     step and host reads per step (at most one a k-step block), three ways
     as phase 5's greedy decode, with equal finished scores and words; one
     warm eager step and one graph replay under torch.profiler; one search
     over a seeded 5,000-word lexicon with three-word homophone groups
     (K = 3, H = 400), graphed and eager with equal results, and the LM's
     share of a step; the search in float32 on two utterances with K1 and
     K2 and with their plain versions: the words agree;
 10. the training recipes: the conformer recipe at full width (768-d, 6+6,
     kernel 31, float32, dropout 0.2) with electrode rotation, channel and
     time drop and scheduled sampling (ramp 1) on, through the CLI's train
     mode at the reference's max_batch_length (3 updates): losses, launches
     (K1 only: the conformer's attention is never fused), peak memory,
     frames/s; one warm step under torch.profiler with the unfused
     attention's time at its shape; greedy evaluation of its model.pt in
     bf16 through the CLI (``--recipe conformer_model``), the same path in
     float32 with K1 and with its plain version (greedy strings agree), and
     one beam CLI run (W = 10); the Parallel_Schedule_Sampling recipe with
     channel and time drop on the flagship at 2+2 layers through the CLI,
     K2 held against its plain version at every shape scheduled sampling's
     first passes launched it with; one float32 microbatch (B=32, T=384,
     dropout 0) with the unfused transformer attention against the fused
     kernels (losses, encoder rows, gradients, each layer's attention at
     the model's inputs against float64) and each variant's device ms;
 11. the beam's remainder: greedy serving through the CLI with
     --quantize_int8 true (K1 and K2 launches as phase 5's; the decoder's
     weight bytes int8 against bf16; layer 0's dequantized weights on the
     card bitwise the CPU's; warm greedy decode through the graphs with
     the int8 and the bf16 model on each test utterance, ms and strings,
     the first divergence margin where they differ); the beam CLI with
     --quantize_int8 true (finite WER, lexicon words) and one graph replay
     int8 against bf16 (device ms and kernels a step); search_from_raw on
     each test utterance's raw signal against the packed path of the same
     DSP (equal history, words and score; ms; K1 and K2 launches); the
     beam CLI with --continuous_lanes 4 (words and launches equal to phase
     9's lock-step run), then all test utterances at one geometry,
     lock-step (8 a launch) against 4 lanes: ms, utterances/s, equal
     words, advances, refills, host reads an advance;
 12. multi-device training: K3-K5 on a block of a batch at its batch and
     head offsets, bitwise the whole batch's launch's block, and their
     plain versions at the same offsets; then two ranks sharing the one
     card (gloo, started by the port's launcher with
     ``share_card=True``): phase 8's microbatch
     (float32, dropout 0.2; rows and utterances padded to multiples of 2)
     on the 2x1, 1x2 and 1x2 sequence-sharded meshes at full width, each
     rank's attention through K3-K5 at its batch and head offsets, held
     against the single-rank step on the card (loss, whole gradient and
     each parameter's, as phase 8; BatchNorm statistics equal on both
     ranks), with each rank's K3-K5 launches and step ms (the first, and
     a warm second's CUDA-event ms, started by every rank together); then
     the same two ranks run one epoch of the CLI's train mode with
     --parallel.data_axis 2 (each joins through cli.main, as ranks that
     torchrun starts do; K1-K5 counted a rank), whose model.pt the greedy
     path serves. After the ranks, K3-K5 at the shapes, offsets, key
     padding and relative window the ranks' steps launched them with:
     each rank's block of the whole launch at its offsets, bitwise that
     launch's block, and their plain versions at the same offsets. The
     ranks' collectives go through the host (gloo): no NVLink is measured.
The second-to-last line is a JSON object with one record per kernel; the
last line is {"ok": true, "device": {...}}. ``--out`` also writes every
measurement to a JSON file.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import contextlib
import glob
import json
import logging
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
F32_CUDA_CORE_FLOPS = 67e12  # K1's recurrence: scalar float32
# the attention kernels (K2-K5), dense tensor-core rates: bf16, and float32
# at float32 accuracy as 3xTF32 (three TF32 passes: 495 / 3)
ATTN_PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 495e12 / 3}
K1_TOL = 2e-4  # relative to the output's magnitude
K2_TOL = {torch.float32: 2e-3, torch.bfloat16: 2e-2}  # bf16: ~2 bf16 ulps of |out|
MEMORY_TOL = 2e-3
DSP_TOL = {"features": 1.6e-3, "signal": 2e-4, "edge_rel": 1e-3}  # PARITY.md
MARGIN_TOL = 1e-3
# kernels 3-5 vs the plain version's autograd, each tensor's largest error
# relative to its largest magnitude. float32: summation order and d_used's
# atomics (~1e-6). bfloat16: both round p and ds to bfloat16 at the same
# points, but a last-bit difference before a rounding moves one bf16 ulp.
TRAIN_ATTN_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
TRAIN_ATTN_B = (1, 8)
TRAIN_ATTN_T = (128, 192, 256, 384, 512)  # 192: the ragged bucket, padded to 256
TRAIN_ATTN_SEED = 20240611
# the training phase: the flagship at its defaults (no model flags) and the
# reference's max_batch_length (80000 raw samples), which cuts the synthetic
# corpus's 30 training utterances (83,748 samples) into two microbatches an
# epoch, of 21 and 9 utterances. Three epochs: 6 microbatches. Cut:
# batch_size_grad 20 (the reference's 100 would need four epochs of this
# corpus for one apply) applies 3 times. report_loss 2: an evaluation pass
# at each epoch's end; a PER report every epoch (the default)
TRAIN_ARGS = ["--n_epochs", "3", "--max_batch_length", "80000", "--batch_size_grad", "20",
              "--report_loss", "2", "--per_train_batches", "2"]
# one train step, kernels vs plain, float32, dropout 0.2. The attention
# outputs differ at ~1e-7 (phase 4), and a ReLU whose input lies within that
# of zero switches between the two runs, moving one token's share of the
# gradient: up to ~6e-3 of a feed-forward weight's largest gradient, and
# ~1e-4 of the whole gradient's norm (two kernel runs differ at ~2e-7).
# So: the losses to rtol 1e-4; the whole gradient to 1e-3 of its norm;
# each parameter's gradient to 2e-2 of its largest magnitude; the conv
# biases that feed a BatchNorm (true gradient 0, float32 noise that differs
# as much between two kernel runs) to 1e-5 of the model's largest gradient.
STEP_LOSS_RTOL = 1e-4
STEP_NORM_TOL = 1e-3
STEP_GRAD_TOL = 2e-2
STEP_NOISE_TOL = 1e-5
# the greedy serving run's launches (8 test utterances: DSP in the 4096-16384
# buckets, the encoder's six layers); the decode graphs hold no K1-K5, so a
# kernel counted once per capture instead of per call would show here
GREEDY_LAUNCHES = {"iir_scan": 272, "flash_attention_relpos": 48}
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


def timed_sync(fn):
    """fn() on the host clock around synchronized work: (its result, ms)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def bound(bytes_moved: float, flops: float, peak: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 1: what the kernels compiled to
# ---------------------------------------------------------------------------

def demangle(names):
    """C++ names of the mangled ``names``, by the toolkit's cu++filt."""
    from emg_tpu_torch.ops import build

    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cu++filt")
    return subprocess.run([tool], input="\n".join(names), capture_output=True, text=True,
                          check=True, timeout=60).stdout.splitlines()


def kernel_resources(record):
    """Per kernel of each library: ptxas's registers, spill bytes and static
    shared memory (from the build's log) and the tensor-core instructions in
    its SASS (cuobjdump -sass): HMMA is mma.sync, HGMMA wgmma. Fails if the
    iir_scan kernel (K1) spills, and unless every forward attention kernel
    (flash_fwd_kernel: K2 and K3) and every backward kernel
    (flash_bwd_dq_kernel: K4, flash_bwd_dkv_kernel: K5) has some."""
    from emg_tpu_torch.ops import build

    cuobjdump = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    rows = []
    for lib in build.SOURCES:
        kernels, current = {}, None
        for line in build.build_log(lib).splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", line)
            if m:
                current = kernels.setdefault(m.group(1), {})
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m and current is not None:
                current["spill_store_bytes"], current["spill_load_bytes"] = map(int, m.groups())
            m = re.search(r"Used (\d+) registers", line)
            if m and current is not None:
                current["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            if m and current is not None:
                current["static_smem_bytes"] = int(m.group(1))
        sass = subprocess.run([cuobjdump, "-sass", str(build._library_path(lib))],
                              capture_output=True, text=True, check=True, timeout=120).stdout
        current = None
        for line in sass.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                current = kernels.setdefault(m.group(1), {})
                current.update(HMMA=0, HGMMA=0)
            elif current is not None:
                for op in ("HGMMA", "HMMA"):
                    if re.search(rf"\b{op}\.", line):
                        current[op] += 1
                        break
        for mangled, name in zip(kernels, demangle(list(kernels))):
            row = dict(library=lib, kernel=name, **kernels[mangled])
            rows.append(row)
            log(f"kernel {json.dumps(row)}")
    record["kernel_resources"] = rows
    scan = [r for r in rows if "iir_scan_kernel" in r["kernel"]]
    if not scan or any(r.get("spill_store_bytes", 0) + r.get("spill_load_bytes", 0) for r in scan):
        raise AssertionError(f"the iir_scan kernel is missing or spills: {scan}")
    for kernel in ("flash_fwd_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel"):
        found = [r for r in rows if kernel in r["kernel"]]
        if not found or not all(r.get("HMMA", 0) + r.get("HGMMA", 0) > 0 for r in found):
            raise AssertionError(f"a {kernel} holds no tensor-core instruction: {found}")


# ---------------------------------------------------------------------------
# phase 2: kernel 1
# ---------------------------------------------------------------------------

# (R, T): the DSP's notch (16 rows) and high-pass (24) over the DSP
# buckets (T = bucket + 2*9 + 1 and + 2*12 + 1), and 24 utterances x 8
# channels x 2 states folded onto rows
K1_SHAPES = [(R, T) for R in (16, 24)
             for T in (4096 + 25, 16384 + 19, 65536 + 19, 131072 + 19)] + [(384, 16384 + 19)]


def k1_rows(shapes):
    """Kernel 1 against its plain version at each (R, T), both directions:
    its error, whether two calls are bitwise equal, its device and wrapper
    times, the plain version's, a copy of the same 16*R*T bytes (u_r and
    u_i into two buffers: no PyTorch call computes the recurrence) and the
    bound. Uses only the wrapper and the plain version, so it also times an
    earlier tree's kernel."""
    from emg_tpu_torch.ops.iir_scan import iir_scan, iir_scan_plain

    gen = torch.Generator().manual_seed(1)
    rows = []
    for R, T in shapes:
        radius = 0.8 + 0.199 * torch.rand(R, generator=gen)
        angle = 0.6 * torch.rand(R, generator=gen) - 0.3
        args = [radius * torch.cos(angle), radius * torch.sin(angle),
                torch.randn(R, T, generator=gen), torch.randn(R, T, generator=gen),
                torch.randn(R, generator=gen), torch.randn(R, generator=gen)]
        args = [a.to(DEVICE) for a in args]
        copies = [torch.empty_like(args[2]), torch.empty_like(args[3])]

        def copy():
            copies[0].copy_(args[2])
            copies[1].copy_(args[3])
        for reverse in (False, True):
            got = iir_scan(*args, reverse=reverse)
            again = iir_scan(*args, reverse=reverse)
            ref = iir_scan_plain(*args, reverse=reverse)
            torch.cuda.synchronize()
            err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
            scale = max(float(r.abs().max()) for r in ref)
            repeatable = all(torch.equal(a, b) for a, b in zip(got, again))
            b_ms, b_by = bound(16.0 * R * T, 8.0 * R * T, F32_CUDA_CORE_FLOPS)
            row = dict(R=R, T=T, reverse=reverse, max_abs_err=err, rel_err=err / scale,
                       bitwise_repeatable=repeatable,
                       ms=time_ms(lambda: iir_scan(*args, reverse=reverse)),
                       call_ms=call_ms(lambda: iir_scan(*args, reverse=reverse)),
                       plain_ms=time_ms(lambda: iir_scan_plain(*args, reverse=reverse)),
                       copy_ms=time_ms(copy), bound_ms=b_ms, bound_by=b_by)
            rows.append(row)
            log(f"K1 iir_scan {json.dumps(row)}")
    return rows


def check_iir_scan(record):
    from emg_tpu_torch.ops.iir_scan import layout, max_active_clusters

    layouts = []
    for R, T in K1_SHAPES:
        lay = layout(R, T)
        lay = dict(R=R, T=T, **lay._asdict(), max_active_clusters=max_active_clusters(R, lay))
        layouts.append(lay)
        log(f"K1 layout {json.dumps(lay)}")
    rows = k1_rows(K1_SHAPES)
    record["iir_scan_layouts"] = layouts
    record["iir_scan"] = rows
    for row in rows:
        if not row["rel_err"] <= K1_TOL:
            raise AssertionError(f"iir_scan disagrees with its plain version: {row}")
        if not row["bitwise_repeatable"]:
            raise AssertionError(f"two iir_scan calls differ: {row}")
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
        for T in (128, 192, 256, 384, 512):
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
                    b_ms, b_by = bound(bytes_moved, flops, ATTN_PEAK_FLOPS[dtype])
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
# phase 4: kernels 3-5
# ---------------------------------------------------------------------------

def rel_err(got, ref) -> float:
    return float((got.float() - ref.float()).abs().max() / ref.float().abs().max().clamp(min=1e-30))


def train_attention_bounds(B, H, T, Dh, dtype):
    """(bound ms, bound_by) of K3, K4 and K5: each input read once, each
    output written once, against 6, 12 and 10 * B*H*T*T*Dh flops."""
    size = 2 if dtype == torch.bfloat16 else 4
    n, rows, window = B * H * T * Dh, B * H * T * 4, H * (2 * T - 1) * Dh
    common = window * size + (2 * T - 1) * 4 + B * T + 4  # used, oob, key pads, seed
    bwd_in = 4 * n * size + common + 2 * rows  # q, k, v, dO, ..., lse, delta
    work = B * H * T * T * Dh
    return {
        "flash_train_fwd": bound(3 * n * size + common + n * 4 + rows, 6.0 * work, ATTN_PEAK_FLOPS[dtype]),
        "flash_train_bwd_dq": bound(bwd_in + n * 4 + window * 4, 12.0 * work, ATTN_PEAK_FLOPS[dtype]),
        "flash_train_bwd_dkv": bound(bwd_in + 2 * n * 4, 10.0 * work, ATTN_PEAK_FLOPS[dtype]),
    }


def make_relpos(seed: int):
    from emg_tpu_torch.models.attention import LearnedRelativePositionalBias

    H, Dh, maxpos = 8, 96, 300
    gen = torch.Generator().manual_seed(seed)
    relpos = LearnedRelativePositionalBias(maxpos, H, Dh)
    with torch.no_grad():
        relpos.embeddings.copy_(torch.randn(relpos.embeddings.shape, generator=gen) * Dh ** -0.5)
    return relpos.to(DEVICE), gen


def compare_train_attention(relpos, gen, B, T, dtype, rate, timed):
    """Kernels 3-5 against the plain version's autograd at one shape,
    through the encoder's call (which pads a ragged T to 256): o and the
    gradients of q, k, v and the relative-position table (through
    window()); at a T the kernels take unpadded, also lse and d_used, and
    with ``timed`` each kernel's times (and SDPA's at dropout 0)."""
    import torch.nn.functional as F

    from emg_tpu_torch.models import attention as attention_module
    from emg_tpu_torch.models.attention import relpos_self_attention
    from emg_tpu_torch.ops import flash_attention as fa

    H, Dh = relpos.embeddings.shape[0], relpos.embeddings.shape[2]
    seed = torch.tensor([TRAIN_ATTN_SEED], dtype=torch.int32, device=DEVICE)
    q, k, v, g = (torch.randn(B, H, T, Dh, generator=gen).to(DEVICE, dtype) for _ in range(4))
    kp = torch.zeros(B, T, dtype=torch.bool)
    for b in range(B):
        kp[b, T - (b * 37) % (T // 2):] = True
    kp = kp.to(DEVICE)

    def through_module(plain):
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        relpos.embeddings.grad = None
        with (mock.patch.object(attention_module, "flash_attention_relpos_train",
                                fa.flash_attention_relpos_train_plain)
              if plain else contextlib.nullcontext()):
            o = relpos_self_attention(*leaves, relpos, kp, rate, seed)
        (o * g.float()).sum().backward()
        return [o.detach()] + [t.grad for t in leaves] + [relpos.embeddings.grad.clone()]

    row = dict(B=B, H=H, T=T, Dh=Dh, dtype=str(dtype).split(".")[-1], rate=rate)
    got, ref = through_module(plain=False), through_module(plain=True)
    valid = ~kp[:, None, :, None].expand_as(got[0])
    errs = {"o": rel_err(got[0][valid], ref[0][valid])}
    errs.update({name: rel_err(a, b) for name, a, b in
                 zip(("dq", "dk", "dv", "d_table"), got[1:], ref[1:])})
    abs_err = {"flash_train_fwd": float((got[0] - ref[0]).abs()[valid].max()),
               "flash_train_bwd_dq": float((got[1].float() - ref[1].float()).abs().max()),
               "flash_train_bwd_dkv": max(float((a.float() - b.float()).abs().max())
                                          for a, b in zip(got[2:4], ref[2:4]))}
    del got, ref
    if T % 128 == 0:
        # the kernels one by one: lse and d_used, then times
        used_graph, oob = relpos.window(T)
        used = used_graph.detach().to(dtype)
        args = (q, k, v, used, oob, kp)
        o_k, lse_k = fa.flash_train_fwd(*args, rate, seed)
        with torch.no_grad():
            _, lse_p = fa.flash_train_fwd_plain(*args, rate, seed)
        delta = (g.float() * o_k).sum(-1)
        bwd = args + (g, lse_k, delta, rate, seed)
        dq_k, dused_k = fa.flash_train_bwd_dq(*bwd)
        leaves = [t.detach().requires_grad_() for t in (q, k, v, used)]
        o_p = fa.flash_attention_relpos_train_plain(*leaves[:3], leaves[3], oob, kp, rate, seed)
        dused_p = torch.autograd.grad((o_p * g.float()).sum(), leaves[3])[0]
        del o_p, leaves
        errs["lse"] = rel_err(lse_k, lse_p)
        errs["d_used"] = rel_err(dused_k, dused_p)
        abs_err["flash_train_bwd_dq"] = max(abs_err["flash_train_bwd_dq"],
                                            float((dused_k - dused_p.float()).abs().max()))
        if timed:
            with torch.no_grad():
                kernels = {
                    "flash_train_fwd": (lambda: fa.flash_train_fwd(*args, rate, seed),
                                        lambda: fa.flash_train_fwd_plain(*args, rate, seed)),
                    "flash_train_bwd_dq": (lambda: fa.flash_train_bwd_dq(*bwd),
                                           lambda: fa.flash_train_bwd_dq_plain(*bwd)),
                    "flash_train_bwd_dkv": (lambda: fa.flash_train_bwd_dkv(*bwd),
                                            lambda: fa.flash_train_bwd_dkv_plain(*bwd)),
                }
                bounds = train_attention_bounds(B, H, T, Dh, dtype)
                for name, (kernel, plain) in kernels.items():
                    row[name] = dict(ms=time_ms(kernel), call_ms=call_ms(kernel),
                                     plain_ms=time_ms(plain), bound_ms=bounds[name][0],
                                     bound_by=bounds[name][1], max_abs_err=abs_err[name])
            if rate == 0.0:
                # yardstick: SDPA over the materialized relative term and
                # key pads; forward beside K3, forward + backward (q, k, v
                # and the bias) beside K4 + K5
                with torch.no_grad():
                    rel = torch.einsum("bhqd,hmd->bhqm", q.float(), used.float()) + oob
                    bias = torch.gather(rel, 3, fa.relative_index(T, q.device).expand(B, H, T, T))
                    bias = (bias + torch.where(kp, -1e8, 0.0)[:, None, None, :]).to(dtype)
                    del rel
                    row["sdpa_fwd_ms"] = time_ms(
                        lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias))
                lib = [t.detach().requires_grad_() for t in (q, k, v, bias)]

                def sdpa_fwd_bwd():
                    o = F.scaled_dot_product_attention(*lib[:3], attn_mask=lib[3])
                    return torch.autograd.grad(o, lib, g)
                row["sdpa_fwd_bwd_ms"] = time_ms(sdpa_fwd_bwd)
    row["rel_err"] = errs
    log(f"K3-K5 flash_attention_relpos_train {json.dumps(row)}")
    if not all(e <= TRAIN_ATTN_TOL[dtype] for e in errs.values()):
        raise AssertionError(f"the training attention kernels disagree with the "
                             f"plain version's autograd: {row}")
    return row


def check_train_attention(record):
    relpos, gen = make_relpos(3)
    rows = [compare_train_attention(relpos, gen, B, T, dtype, rate, timed=True)
            for B in TRAIN_ATTN_B for T in TRAIN_ATTN_T
            for dtype in (torch.float32, torch.bfloat16) for rate in (0.0, 0.2)]
    record["flash_attention_relpos_train"] = rows


def check_launched_shapes(shapes, record):
    """Kernels 3-5 against the plain version at every (B, T, dtype, rate)
    the training run launched them with, and at dropout 0 for the SDPA
    yardstick, timed. Returns the kernels line's rows: the largest shape
    (B*T*T) at the training run's rate."""
    relpos, gen = make_relpos(4)
    rows = []
    for B, T, dtype, rate in sorted(shapes):
        dt = getattr(torch, dtype)
        for r in sorted({rate, 0.0}):
            rows.append(compare_train_attention(relpos, gen, B, T, dt, r, timed=True))
            torch.cuda.empty_cache()
    record["flash_attention_relpos_train_launched"] = rows
    B, T, dtype, rate = max(shapes, key=lambda s: s[0] * s[1] * s[1])
    rep = next(r for r in rows if (r["B"], r["T"], r["dtype"], r["rate"]) == (B, T, dtype, rate))
    lib = next(r for r in rows if (r["B"], r["T"], r["dtype"], r["rate"]) == (B, T, dtype, 0.0))
    rep = {name: dict(rep[name], B=B, T=T, dtype=dtype, rate=rate)
           for name in ("flash_train_fwd", "flash_train_bwd_dq", "flash_train_bwd_dkv")}
    rep["flash_train_fwd"]["library_ms"] = lib["sdpa_fwd_ms"]
    # SDPA's forward + backward has no one kernel to sit beside: PERF.md
    # reports it beside K4 + K5 together
    record["flash_attention_relpos_train_sdpa_fwd_bwd_ms"] = lib["sdpa_fwd_bwd_ms"]
    return rep


# ---------------------------------------------------------------------------
# phases 5 and 6: the serving path
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
        "--phonesSet", paths["phonesSet"], "--vocabulary", paths["vocabulary"],
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
    """Per-utterance device time of DSP and encode (host clock around
    synchronized work), over the test split, warm. Returns the mean ms of
    each, the buckets, and each utterance's decode case (memory, mask,
    buffer steps, num_steps) for ``greedy_graphs_vs_eager``."""
    from emg_tpu_torch.cli import prepare_single
    from emg_tpu_torch.decode.greedy import encode_batch
    from emg_tpu_torch.dsp.pipeline import preprocess_emg

    totals = {"dsp": [], "encode": []}
    buckets, cases = [], []
    for i in range(len(testset)):
        buf, n, n_before, n_after = utterance_input(testset, i)
        x = torch.as_tensor(buf, device=DEVICE)
        pb, max_frames, example = prepare_single(cfg, testset, i)
        S_true = int(example["phonemes_int_lengths"][0])
        with torch.inference_mode():
            for _ in range(2):  # the second pass is warm
                _, dsp_ms = timed_sync(lambda: preprocess_emg(x, n, n_before, n_after))
                (mem, _, mask), enc_ms = timed_sync(lambda: encode_batch(model, pb, max_frames))
        totals["dsp"].append(dsp_ms)
        totals["encode"].append(enc_ms)
        buckets.append((buf.shape[0], max_frames))
        cases.append((mem, mask, pb.targets.shape[1] - 1, S_true - 1))
    return {k: float(np.mean(v)) for k, v in totals.items()}, buckets, cases


# ---------------------------------------------------------------------------
# the decode loops: CUDA graphs against the eager loop (phases 5, 6 and 9)
# ---------------------------------------------------------------------------

def counted_reads(fn):
    """fn() timed on the host clock (synchronized) under CUDA's sync debug
    mode, which warns at every operation that waits for the card. Returns
    (its result, ms, host reads)."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            t0 = time.perf_counter()
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return out, ms, sum("synchroniz" in str(w.message) for w in caught)


def decode_runners(model, searcher=None):
    """The three ways a loop runs, for one pass: the CUDA graphs (the
    default), the eager loop at the same read cadence (``graphed=False``,
    reachable only as a keyword argument), and the eager loop reading the
    card every step (the parent's loop). With ``searcher`` (a device beam
    searcher's constructor of ``read_every`` and ``graphed``), searchers."""
    from emg_tpu_torch.decode.graphs import READ_EVERY, LoopRunner

    variants = {"graphed": (READ_EVERY, True), "eager": (READ_EVERY, False), "eager_k1": (1, False)}
    if searcher is None:
        return {name: LoopRunner(model, k, graphed) for name, (k, graphed) in variants.items()}
    return {name: searcher(read_every=k, graphed=graphed) for name, (k, graphed) in variants.items()}


def graph_report(runner) -> dict:
    """A runner's captures (seconds and pool memory per geometry), replays
    and reads; one replay of its first graph timed by CUDA events (device
    ms) and traced by torch.profiler (device busy ms and kernels)."""
    graphs = list(runner.graphs.items())
    if not graphs or runner.replays == 0:
        raise AssertionError(f"the graphed loop never replayed a graph: {runner.replays} replays")
    captured = graphs[0][1]

    def replay():
        captured.graph.replay()
        torch.cuda.synchronize()
    replay()
    prof, wall = profiled(replay)
    by_name, span, kernels = device_work(prof, "a graph replay")
    busy = sum(by_name.values())
    replay_ms = time_ms(captured.graph.replay, iters=10, warmup=2)
    return dict(k=runner.k, replays=runner.replays, reads=runner.reads,
                captures=[dict(geometry=str(key), capture_s=c.capture_s,
                               pool_MB=c.pool_bytes / 2**20) for key, c in graphs],
                replay=dict(geometry=str(graphs[0][0]), device_ms=replay_ms,
                            device_ms_per_step=replay_ms / runner.k, profiled_busy_ms=busy,
                            profiled_span_ms=span, profiled_wall_ms=wall, kernels=kernels,
                            kernels_per_step=kernels / runner.k,
                            longest=sorted(by_name.items(), key=lambda kv: -kv[1])[:5]))


def greedy_graphs_vs_eager(model, cases, label: str) -> dict:
    """Each case (memory, mask, buffer steps, num_steps) decoded greedily
    three ways (``decode_runners``), each warm (the second of two runs) and
    under the sync debug mode: ms, host reads, blocks; steps from the
    every-step loop. The three must give bitwise the same matrix and raw
    tokens."""
    from emg_tpu_torch.decode.greedy import greedy_loop

    runners = decode_runners(model)
    rows = []
    for i, (mem, mask, cap, steps) in enumerate(cases):
        row, outs = dict(utterance=i, S=cap + 1, num_steps=steps), {}
        for name, runner in runners.items():
            for _ in range(2):
                (out, raw), ms, reads = counted_reads(
                    lambda: greedy_loop(model, mem, mask, cap, steps, runner=runner))
            outs[name] = (out.cpu().numpy(), raw.cpu().numpy())
            row[name] = dict(ms=ms, host_reads=reads, blocks=runner.blocks)
        row["steps"] = runners["eager_k1"].blocks
        row["extra_steps_graphed"] = runners["graphed"].blocks * runners["graphed"].k - row["steps"]
        row["equal"] = all(np.array_equal(a, b) for name in ("eager", "eager_k1")
                           for a, b in zip(outs["graphed"], outs[name]))
        rows.append(row)
    mean = {name: dict(ms=float(np.mean([r[name]["ms"] for r in rows])),
                       median_ms=float(np.median([r[name]["ms"] for r in rows])),
                       host_reads_per_step=float(np.mean([r[name]["host_reads"] / max(r["steps"], 1)
                                                          for r in rows])))
            for name in runners}
    mean["steps"] = float(np.mean([r["steps"] for r in rows]))
    mean["extra_steps_graphed"] = float(np.mean([r["extra_steps_graphed"] for r in rows]))
    result = dict(label=label, utterances=rows, mean=mean, graphs=graph_report(runners["graphed"]))
    log(f"greedy decode, graphs vs eager ({label}) {json.dumps(result)}")
    if not all(r["equal"] for r in rows):
        raise AssertionError(f"greedy decoding through the graphs differs from the eager loop: {rows}")
    return result


def profile_dsp(testset, bucket: int = 16384) -> dict:
    """One warm preprocess_emg of the first test utterance at ``bucket``:
    its synchronized host wall (median of three) and, from a torch.profiler
    trace of one more, the device's busy ms, kernel 1's ms and share of it,
    and the number of kernels it launched."""
    from emg_tpu_torch.dsp.pipeline import preprocess_emg

    i = next(i for i in range(len(testset)) if utterance_input(testset, i)[0].shape[0] == bucket)
    buf, n, n_before, n_after = utterance_input(testset, i)
    x = torch.as_tensor(buf, device=DEVICE)

    def run():
        with torch.inference_mode():
            preprocess_emg(x, n, n_before, n_after)
        torch.cuda.synchronize()
    run()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        run()
        walls.append((time.perf_counter() - t0) * 1e3)
    prof, profiled_wall = profiled(run)
    by_name, span, count = device_work(prof, "preprocess_emg")
    busy = sum(by_name.values())
    scan = sum(ms for name, ms in by_name.items() if "iir_scan" in name)
    result = dict(utterance=i, bucket=bucket, wall_ms=float(np.median(walls)), walls_ms=walls,
                  profiled_wall_ms=profiled_wall, device_busy_ms=busy, device_span_ms=span,
                  device_kernels=count, iir_scan_ms=scan, iir_scan_share_of_busy=scan / busy,
                  device_idle_share_of_wall=1.0 - busy / float(np.median(walls)),
                  device_idle_share_of_span=1.0 - busy / span,
                  longest_kernels=sorted(by_name.items(), key=lambda kv: -kv[1])[:5])
    log(f"preprocess_emg profile {json.dumps(result)}")
    if scan == 0.0:
        raise AssertionError("the trace of preprocess_emg holds no iir_scan kernel")
    return result


def runners_summary(runners) -> dict:
    """What the runners a CLI run built did: replays, reads, and each
    capture's geometry, seconds and pool memory."""
    return dict(runners=len(runners), replays=sum(r.replays for r in runners),
                reads=sum(r.reads for r in runners),
                captures=[dict(geometry=str(key), capture_s=c.capture_s, pool_MB=c.pool_bytes / 2**20)
                          for r in runners for key, c in r.graphs.items()])


@contextlib.contextmanager
def runners_built(sink: list):
    """Collect every LoopRunner built inside the block into sink."""
    from emg_tpu_torch.decode.graphs import LoopRunner

    real = LoopRunner.__init__

    def init(self, *args, **kwargs):
        real(self, *args, **kwargs)
        sink.append(self)
    with mock.patch.object(LoopRunner, "__init__", init):
        yield


def serve(argv, ckpt, record):
    from emg_tpu_torch import cli
    from emg_tpu_torch.config import Config
    from emg_tpu_torch.data.dataset import EMGDataset
    from emg_tpu_torch.ops.flash_attention import flash_attention_relpos
    from emg_tpu_torch.ops.iir_scan import iir_scan
    from emg_tpu_torch.utils.serving import cast_params_for_serving

    full = argv + ["--device", DEVICE, "--evaluate_saved_greedy_search", ckpt]
    iir_scan.launches = 0
    flash_attention_relpos.launches = 0
    runners = []
    t0 = time.perf_counter()
    with runners_built(runners):
        per, acc = cli.main(full)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"iir_scan": iir_scan.launches,
                "flash_attention_relpos": flash_attention_relpos.launches}
    logging.getLogger().handlers.clear()
    cli_graphs = runners_summary(runners)

    cfg = Config.from_args(argv)
    testset = EMGDataset(cfg, test=True, device=DEVICE)
    # the CLI's serving model: bf16 weights cast once
    model = cast_params_for_serving(cli.load_model_for_eval(cfg, ckpt, DEVICE))
    times, buckets, cases = stage_times(cfg, model, testset)
    decode = greedy_graphs_vs_eager(model, cases, "bf16 serving")
    times.update(decode=decode["mean"]["graphed"]["ms"], decode_eager=decode["mean"]["eager"]["ms"],
                 decode_eager_every_step=decode["mean"]["eager_k1"]["ms"])
    result = dict(per=per, accuracy=acc, utterances=len(testset), cli_wall_s=wall,
                  launches=launches, cli_graphs=cli_graphs, ms_per_utterance=times,
                  buckets=[{"dsp_samples": d, "frames": f} for d, f in buckets],
                  dsp_profile=profile_dsp(testset))
    record["serving"] = result
    record["greedy_graphs"] = decode
    log(f"serving {json.dumps(result)}")
    if launches != GREEDY_LAUNCHES:
        raise AssertionError(f"the greedy run's kernel launches moved: {launches}, "
                             f"expected {GREEDY_LAUNCHES} (no kernel sits in a graph)")
    if cli_graphs["runners"] != 1 or cli_graphs["replays"] == 0:
        raise AssertionError(f"the CLI's greedy decode did not run through its graphs: {cli_graphs}")
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


def whole_path_kernels_vs_plain(argv, ckpt, record, record_key="whole_path_f32"):
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
    differing, cases = [], []
    for i in range(len(testset)):
        buf, n, n_before, n_after = utterance_input(testset, i)
        x = torch.as_tensor(buf, device=DEVICE)
        pb, max_frames, example = cli.prepare_single(cfg, testset, i)
        cap, steps = pb.targets.shape[1] - 1, int(example["phonemes_int_lengths"][0]) - 1
        with torch.inference_mode():
            dk = preprocess_emg(x, n, n_before, n_after)
            mk, _, mask = encode_batch(model, pb, max_frames)
            ok, _ = greedy_loop(model, mk, mask, cap, steps)
            cases.append((mk, mask, cap, steps))
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
    result = dict(utterances=len(testset), worst=worst, differing=differing,
                  graphs_vs_eager=greedy_graphs_vs_eager(model, cases, f"{record_key}, float32"))
    record[record_key] = result
    log(f"whole path kernels vs plain (float32) {json.dumps(result)}")
    if not (worst["features"] <= DSP_TOL["features"] and worst["signal"] <= DSP_TOL["signal"]
            and worst["edge_rel"] <= DSP_TOL["edge_rel"]):
        raise AssertionError(f"DSP with kernel 1 disagrees with its plain version: {worst}")
    if not worst["memory"] <= MEMORY_TOL:
        raise AssertionError(f"encoder memory with kernel 2 disagrees: {worst}")
    if any(d["margin"] >= MARGIN_TOL for d in differing):
        raise AssertionError(f"greedy strings differ at a clear margin: {differing}")


# ---------------------------------------------------------------------------
# phase 9: beam serving
# ---------------------------------------------------------------------------

def train_arpa_file(sentences, path: str, order: int = 3) -> str:
    from emg_tpu_torch.decode.lm_train import train_arpa, write_arpa

    write_arpa(train_arpa(sentences, order=order), path)
    return path


def cli_config(args):
    """The config the CLI builds from ``args``: its ``--device`` dropped,
    its ``--recipe`` applied after the flags, as ``cli.main`` does."""
    from emg_tpu_torch.config import Config
    from emg_tpu_torch.train.recipes import apply_recipe

    args, opts = list(args), {}
    for name in ("--device", "--recipe"):
        if name in args:
            i = args.index(name)
            opts[name] = args[i + 1]
            del args[i : i + 2]
    cfg = Config.from_args(args)
    return apply_recipe(cfg, opts["--recipe"]) if "--recipe" in opts else cfg


def beam_cli(argv, ckpt, arpa, out_dir, record, cli_extra=(), key="beam_cli",
             kernels=("iir_scan", "flash_attention_relpos")):
    """The beam evaluation through the CLI at its defaults (bfloat16, W = 100,
    the device beam, batch_utterances 8) and ``cli_extra``, K1's and K2's
    launches counted over the run alone; each of ``kernels`` must launch,
    the others must not. Returns the launch counts."""
    from emg_tpu_torch import cli
    from emg_tpu_torch.decode.prefix_tree import init_tree
    from emg_tpu_torch.ops.flash_attention import flash_attention_relpos
    from emg_tpu_torch.ops.iir_scan import iir_scan
    from emg_tpu_torch.text.phonemes import TextTransform

    full = argv + ["--device", DEVICE, "--evaluate_saved_beam_search", ckpt, "--lang_model", arpa,
                   "--output_directory", out_dir, *cli_extra]
    iir_scan.launches = 0
    flash_attention_relpos.launches = 0
    runners = []
    t0 = time.perf_counter()
    with runners_built(runners):
        final = cli.main(full)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"iir_scan": iir_scan.launches,
                "flash_attention_relpos": flash_attention_relpos.launches}
    logging.getLogger().handlers.clear()

    cfg = cli_config(full)
    dct = init_tree(cfg.paths.phonesSet, cfg.paths.vocabulary, cfg.paths.dict).compile_tables().dictionary
    tt = TextTransform()
    vocabulary = {tt.clean_text(dct.lookup_word_by_index(i).name) for i in range(dct.word_count())}
    with open(os.path.join(out_dir, "log_beam_search.txt")) as f:
        lines = [line for line in f if line.startswith("Prediction:")]
    predicted = [line[len("Prediction:"):].split(" ---> ")[0].split() for line in lines]
    result = dict(wer=final, utterances=len(lines), cli_wall_s=wall, launches=launches,
                  cli_graphs=runners_summary(runners),
                  decode=dict(BeamWidth=cfg.decode.BeamWidth, compute_dtype=cfg.decode.compute_dtype,
                              batch_utterances=cfg.decode.batch_utterances,
                              beam_scan=cfg.decode.beam_scan),
                  predictions=[" ".join(w) for w in predicted])
    record[key] = result
    log(f"beam serving through the CLI {json.dumps(result)}")
    if not all((n > 0) == (name in kernels) for name, n in launches.items()):
        raise AssertionError(f"the beam path's kernels are not {kernels}: {launches}")
    if not 0.0 <= final < float("inf"):
        raise AssertionError(f"WER is not a finite rate: {final}")
    if result["cli_graphs"]["replays"] == 0:
        raise AssertionError(f"the beam CLI's search did not run through its graphs: {result['cli_graphs']}")
    if not lines or any(w not in vocabulary for words in predicted for w in words):
        raise AssertionError(f"a prediction holds a word outside the lexicon: {predicted}")
    return launches


def beam_setup(argv, arpa, extra=(), lexicon=None):
    """The config, tree and device LM of the beam evaluation; the tree from
    ``lexicon`` (phone set, vocabulary and dictionary files) where given,
    else from the corpus's description files."""
    from emg_tpu_torch.config import Config
    from emg_tpu_torch.decode.device_lm import build_device_lm
    from emg_tpu_torch.decode.ngram import ArpaLanguageModel
    from emg_tpu_torch.decode.prefix_tree import init_tree

    cfg = Config.from_args(argv + ["--lang_model", arpa, *extra])
    files = lexicon or (cfg.paths.phonesSet, cfg.paths.vocabulary, cfg.paths.dict)
    tree = init_tree(*files).compile_tables()
    words = [tree.dictionary.lookup_word_by_index(i).name for i in range(tree.dictionary.word_count())]
    dlm = build_device_lm(ArpaLanguageModel(arpa), words, device=DEVICE)
    return cfg, tree, dlm, set(words)


def serving_model(cfg, ckpt):
    """The CLI's serving model, with its weights cast once (as the CLI
    does) so that the searchers share one copy."""
    from emg_tpu_torch import cli
    from emg_tpu_torch.utils.serving import cast_params_for_serving

    model = cli.load_model_for_eval(cfg, ckpt, DEVICE)
    return cast_params_for_serving(model) if model.dtype == torch.bfloat16 else model


def searchers_for(cfg, model, tree, dlm, max_frames, target_len, cache: dict) -> dict:
    """The three searchers (``decode_runners``) of the CLI's geometry group
    for an utterance, one set per (max_frames, step cap), as the CLI keeps
    one searcher per group."""
    from emg_tpu_torch.decode.device_beam import DeviceBeamSearcher

    step_cap = 16 * ((target_len + cfg.decode.extra_steps + 15) // 16)
    if (max_frames, step_cap) not in cache:
        cache[max_frames, step_cap] = decode_runners(model, lambda **kw: DeviceBeamSearcher(
            model, tree, dlm, cfg.decode, max_frames, max_steps=step_cap, **kw))
    return cache[max_frames, step_cap]


def timed_search(searcher, pb, target_len):
    """One search of one utterance, its encode and its step loop each
    synchronized and timed, the loop under the sync debug mode
    (``counted_reads``). Returns (encode ms, loop ms, steps, host reads,
    (state, cross K/V, mask, max_len), the winner and the finished scores
    read from the state)."""
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        kvs, mask = searcher._stack_ctx([searcher._make_ctx(pb)])
        max_len = torch.tensor([target_len + searcher.cfg.extra_steps], device=DEVICE)
        torch.cuda.synchronize()
        enc_ms = (time.perf_counter() - t0) * 1e3
        st, loop_ms, reads = counted_reads(lambda: searcher.run(kvs, mask, max_len))
        # read now: a graphed searcher's next search overwrites its state
        best, fin_scores = searcher._best(st), st["fin_scores"].cpu().numpy()
    return enc_ms, loop_ms, int(st["t"]), reads, (st, kvs, mask, max_len), best, fin_scores


def profile_beam_step(searcher, ctx, t: int = 4) -> dict:
    """One warm beam step at position t, run eagerly, under torch.profiler:
    the card's busy ms, the kernels it launched, its unprofiled and
    profiled wall, the five longest device entries, and the LM's part
    (``cond_logp`` at this step's inputs, traced on its own)."""
    _, kvs, mask, max_len = ctx
    with torch.inference_mode():
        st = searcher._init_state(kvs, mask, max_len)
        for _ in range(t):
            st = searcher._step(st)
        seen = []
        real = searcher.lm.cond_logp

        def record_inputs(c, w):
            seen.append((c, w))
            return real(c, w)
        with mock.patch.object(searcher.lm, "cond_logp", record_inputs):
            searcher._step(st)

        def step():
            searcher._step(st)
            torch.cuda.synchronize()

        def lm_call():
            real(*seen[0])
            torch.cuda.synchronize()
        step()
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            step()
            walls.append((time.perf_counter() - t0) * 1e3)
        prof, profiled_wall = profiled(step)
        lm_call()
        lm_prof, _ = profiled(lm_call)
    by_name, span, count = device_work(prof, "a beam step")
    lm_by_name, _, lm_count = device_work(lm_prof, "the beam's LM call")
    busy, lm_busy = sum(by_name.values()), sum(lm_by_name.values())
    wall = float(np.median(walls))
    result = dict(t=t, wall_ms=wall, walls_ms=walls, profiled_wall_ms=profiled_wall,
                  device_busy_ms=busy, device_span_ms=span, device_kernels=count,
                  device_idle_share_of_wall=1.0 - busy / wall,
                  lm_device_ms=lm_busy, lm_kernels=lm_count, lm_share_of_kernels=lm_count / count,
                  lm_share_of_busy=lm_busy / busy,
                  longest=sorted(by_name.items(), key=lambda kv: -kv[1])[:5])
    log(f"beam step profile {json.dumps(result)}")
    return result


def beam_timings(argv, ckpt, arpa, record):
    """Per-utterance encode and search over the test split at the CLI's
    defaults, warm (the second of two passes), three ways
    (``decode_runners``): ms, steps, ms per step, host reads per step;
    each way's finished scores and words must be equal. One eager step and
    one graph replay under the profiler."""
    from emg_tpu_torch import cli
    from emg_tpu_torch.data.dataset import EMGDataset

    cfg, tree, dlm, words = beam_setup(argv, arpa)
    testset = EMGDataset(cfg, test=True, device=DEVICE)
    model = serving_model(cfg, ckpt)
    rows, ctx, cache = [], None, {}
    for i in range(len(testset)):
        pb, max_frames, raw = cli.prepare_single(cfg, testset, i)
        target_len = int((raw["phonemes_int"][0][1:] != 40).sum())
        group = searchers_for(cfg, model, tree, dlm, max_frames, target_len, cache)
        row, results = dict(utterance=i, frames=max_frames,
                            max_len=target_len + cfg.decode.extra_steps), {}
        for name, searcher in group.items():
            for _ in range(2):  # the second pass is warm
                enc_ms, loop_ms, steps, reads, ctx, best, fin = timed_search(searcher, pb, target_len)
            results[name] = (best, fin)
            row[name] = dict(encode_ms=enc_ms, search_ms=loop_ms, steps=steps,
                             ms_per_step=loop_ms / steps, host_reads=reads,
                             host_reads_per_step=reads / steps, blocks=searcher.runner.blocks)
        _, score, found = group["graphed"]._format(*[a[0] for a in results["graphed"][0]])
        row.update(score=score, words=found, equal=all(
            np.array_equal(results["graphed"][1], results[name][1])
            and all(np.array_equal(a, b) for a, b in zip(results["graphed"][0], results[name][0]))
            for name in ("eager", "eager_k1")))
        row["extra_steps_graphed"] = row["graphed"]["blocks"] * group["graphed"].runner.k - row["graphed"]["steps"]
        rows.append(row)
        log(f"beam utterance {json.dumps(row)}")
    mean = {name: {key: float(np.mean([r[name][key] for r in rows]))
                   for key in ("encode_ms", "search_ms", "steps", "ms_per_step", "host_reads_per_step")}
            for name in ("graphed", "eager", "eager_k1")}
    for name in ("graphed", "eager", "eager_k1"):
        mean[name]["median_ms_per_step"] = float(np.median([r[name]["ms_per_step"] for r in rows]))
    mean["extra_steps_graphed"] = float(np.mean([r["extra_steps_graphed"] for r in rows]))
    graphed = [g["graphed"] for g in cache.values()]
    result = dict(utterances=rows, mean=mean, H=graphed[0].H, K=graphed[0].K, W=graphed[0].W,
                  step_profile=profile_beam_step(group["eager"], ctx),
                  graphs=graph_report(graphed[0].runner),
                  capture_s=[c.capture_s for g in graphed for c in g.runner.graphs.values()],
                  pool_MB=[c.pool_bytes / 2**20 for g in graphed for c in g.runner.graphs.values()])
    record["beam_timings"] = result
    log(f"beam per-utterance means {json.dumps(result['mean'])}")
    if not all(r["equal"] for r in rows):
        raise AssertionError(f"the beam through the graphs differs from the eager loop: {rows}")
    if any(r[name]["host_reads"] > r[name]["blocks"] for r in rows
           for name in ("graphed", "eager", "eager_k1")):
        raise AssertionError(f"a beam loop read the card more than once a block: {rows}")
    if any(w not in words for r in rows for w in r["words"]):
        raise AssertionError("a search emitted a word outside the lexicon")


def synthetic_lexicon(root: str, seed: int = 0, n_words: int = 5000):
    """A seeded lexicon of ``n_words`` words over the 40 phones, pronounced
    with 2-8 phones, a tenth of them in homophone groups of three (so the
    prefix tree's nodes end at most K = 3 words), and 3000 seeded sentences
    over it with a Zipf-like word distribution. Returns (its phone set,
    vocabulary and dictionary files, sentences)."""
    from emg_tpu_torch.data.fixtures import PHONES_LINE

    rng = np.random.default_rng(seed)
    phones = PHONES_LINE.split()
    prons, seen = [], set()
    while len(prons) < n_words:
        pron = " ".join(rng.choice(phones, size=int(rng.integers(2, 9))))
        if pron in seen:
            continue
        seen.add(pron)
        # a group of three with probability 1/28: a tenth of the words
        prons.extend([pron] * (3 if rng.random() < 1 / 28 else 1))
    prons = prons[:n_words]
    names = [f"W{i:04d}" for i in range(n_words)]
    desc = os.path.join(root, "lexicon_scale")
    os.makedirs(desc, exist_ok=True)
    with open(os.path.join(desc, "phonesSet"), "w") as f:
        f.write(PHONES_LINE + "\n")
    with open(os.path.join(desc, "lexicon.txt"), "w") as f:
        f.writelines(f"{w}\t{p}\n" for w, p in zip(names, prons))
    with open(os.path.join(desc, "vocabulary"), "w") as f:
        f.write(" ".join(names) + "\n")
    weights = 1.0 / np.arange(1, n_words + 1)
    weights /= weights.sum()
    sentences = [" ".join(rng.choice(names, size=int(rng.integers(3, 13)), p=weights))
                 for _ in range(3000)]
    files = tuple(os.path.join(desc, f) for f in ("phonesSet", "vocabulary", "lexicon.txt"))
    return files, sentences


def beam_lexicon_scale(argv, ckpt, root, record):
    """One search at W = 100 over a ~5,000-word lexicon with K = 3 (H = 400)
    and an order-3 ARPA over it, on the first test utterance."""
    from emg_tpu_torch import cli
    from emg_tpu_torch.data.dataset import EMGDataset

    lexicon, sentences = synthetic_lexicon(root)
    t0 = time.perf_counter()
    arpa = train_arpa_file(sentences, os.path.join(root, "lexicon_scale.arpa"))
    cfg, tree, dlm, words = beam_setup(argv, arpa, lexicon=lexicon)
    setup_s = time.perf_counter() - t0
    testset = EMGDataset(cfg, test=True, device=DEVICE)
    model = serving_model(cfg, ckpt)
    pb, max_frames, raw = cli.prepare_single(cfg, testset, 0)
    target_len = int((raw["phonemes_int"][0][1:] != 40).sum())
    group = searchers_for(cfg, model, tree, dlm, max_frames, target_len, {})
    runs = {}
    for name in ("graphed", "eager"):
        for _ in range(2):
            runs[name] = timed_search(group[name], pb, target_len)
    searcher = group["graphed"]
    enc_ms, loop_ms, steps, reads, ctx, best, fin = runs["graphed"]
    _, score, found = searcher._format(*[a[0] for a in best])
    e_best, e_fin = runs["eager"][5:]
    equal = np.array_equal(fin, e_fin) and all(np.array_equal(a, b) for a, b in zip(best, e_best))
    result = dict(words=len(words), tree_nodes=int(tree.child_table.shape[0]), K=searcher.K,
                  H=searcher.H, W=searcher.W,
                  ngrams=[int((t.keys[:, 0] >= 0).sum()) for t in dlm.tables],
                  table_slots=[t.size for t in dlm.tables],
                  setup_s=setup_s, encode_ms=enc_ms, search_ms=loop_ms, steps=steps,
                  ms_per_step=loop_ms / steps, host_reads=reads, score=score,
                  emitted=len(found), graphed_equals_eager=equal,
                  eager=dict(search_ms=runs["eager"][1], steps=runs["eager"][2],
                             ms_per_step=runs["eager"][1] / runs["eager"][2],
                             host_reads=runs["eager"][3]),
                  step_profile=profile_beam_step(group["eager"], ctx),
                  graphs=graph_report(searcher.runner))
    record["beam_lexicon_scale"] = result
    log(f"beam at lexicon scale {json.dumps(result)}")
    if searcher.K != 3 or reads > searcher.runner.blocks:
        raise AssertionError(f"the lexicon-scale search is not as set up: {result}")
    if not equal:
        raise AssertionError("the lexicon-scale search through the graphs differs from the eager loop")
    if any(w not in words for w in found):
        raise AssertionError("the lexicon-scale search emitted a word outside the lexicon")


def beam_divergence(searcher, ctx_a, ctx_b, max_len):
    """Step two searches of one utterance (contexts ``(cross K/V, mask)``)
    side by side; at the first step where their beams differ, the margin
    between the two candidates that swapped: the scores at the first rank
    whose hypothesis differs, or the two best finished scores where only
    the finished buffers differ. None if the searches never differ."""
    W = searcher.W
    with torch.inference_mode():
        a, b = searcher._init_state(*ctx_a, max_len), searcher._init_state(*ctx_b, max_len)
        for t in range(searcher.S - 1):
            a, b = searcher._step(a), searcher._step(b)
            rows = (a["hist"][0, :W] != b["hist"][0, :W]).any(dim=1) & a["alive"][0, :W]
            if bool(rows.any()):
                i = int(rows.int().argmax())
                return dict(step=t, rank=i, margin=float((a["cum"][0, i] - b["cum"][0, i]).abs()))
            if not torch.equal(a["fin_hist"][0, 0], b["fin_hist"][0, 0]):
                return dict(step=t, rank="finished", margin=float(
                    (a["fin_scores"][0, 0] - b["fin_scores"][0, 0]).abs()))
    return None


def beam_kernels_vs_plain(argv, ckpt, arpa, record, n: int = 2):
    """The same search in float32 on the first n test utterances, with the
    DSP and the encoder through K1 and K2 and through their plain versions
    (phase 6's switch): the words must be equal, or the two candidates that
    swapped at the first step where the beams differ within MARGIN_TOL (a
    near tie)."""
    from emg_tpu_torch import cli
    from emg_tpu_torch.data.dataset import EMGDataset
    from emg_tpu_torch.ops.flash_attention import flash_attention_relpos_plain
    from emg_tpu_torch.ops.iir_scan import iir_scan_plain

    cfg, tree, dlm, _ = beam_setup(argv, arpa, ["--decode.compute_dtype", "float32"])
    model = serving_model(cfg, ckpt)

    cache = {}

    def contexts():
        """Per utterance: its searcher, search context and max_len."""
        testset = EMGDataset(cfg, test=True, device=DEVICE)
        out = []
        for i in range(n):
            pb, max_frames, raw = cli.prepare_single(cfg, testset, i)
            target_len = int((raw["phonemes_int"][0][1:] != 40).sum())
            searcher = searchers_for(cfg, model, tree, dlm, max_frames, target_len, cache)["graphed"]
            with torch.inference_mode():
                ctx = searcher._stack_ctx([searcher._make_ctx(pb)])
            max_len = torch.tensor([target_len + cfg.decode.extra_steps], device=DEVICE)
            out.append((searcher, ctx, max_len))
        return out

    def search(searcher, ctx, max_len):
        st = searcher.run(*ctx, max_len)
        return searcher._format(*[a[0] for a in searcher._best(st)])

    kernels = contexts()
    with mock.patch("emg_tpu_torch.dsp.filters.iir_scan", iir_scan_plain), \
            mock.patch("emg_tpu_torch.models.attention.flash_attention_relpos",
                       flash_attention_relpos_plain):
        plain = contexts()
    rows = []
    for i, ((searcher, ck, max_len), (_, cp, _)) in enumerate(zip(kernels, plain)):
        (hk, sk, wk), (hp, sp, wp) = search(searcher, ck, max_len), search(searcher, cp, max_len)
        row = dict(utterance=i, equal=wk == wp and list(hk) == list(hp), words=wk,
                   plain_words=wp, score=sk, plain_score=sp)
        if not row["equal"]:
            row["first_divergence"] = beam_divergence(searcher, ck, cp, max_len)
            log(f"beam kernels vs plain: utterance {i} differs: {row['first_divergence']}")
        rows.append(row)
    record["beam_f32_kernels_vs_plain"] = rows
    log(f"beam kernels vs plain (float32) {json.dumps(rows)}")
    for r in rows:
        if not r["equal"] and not (r["first_divergence"] is not None
                                   and r["first_divergence"]["margin"] < MARGIN_TOL):
            raise AssertionError(f"the beam's words differ at a clear margin: {rows}")


def beam_serving(argv, ckpt, root, record):
    from emg_tpu_torch.data.fixtures import FIXTURE_SENTENCES

    t0 = time.perf_counter()
    arpa = train_arpa_file(FIXTURE_SENTENCES, os.path.join(root, "lm.arpa"))
    launches = beam_cli(argv, ckpt, arpa, os.path.join(root, "beam_out"), record)
    beam_timings(argv, ckpt, arpa, record)
    beam_lexicon_scale(argv, ckpt, root, record)
    beam_kernels_vs_plain(argv, ckpt, arpa, record)
    record["beam_phase_s"] = time.perf_counter() - t0
    log(f"phase 9 took {record['beam_phase_s']:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# phases 7 and 8: the training path
# ---------------------------------------------------------------------------

def kernel_counters():
    from emg_tpu_torch.ops import flash_attention as fa
    from emg_tpu_torch.ops.iir_scan import iir_scan

    return {"iir_scan": iir_scan, "flash_attention_relpos": fa.flash_attention_relpos,
            "flash_train_fwd": fa.flash_train_fwd, "flash_train_bwd_dq": fa.flash_train_bwd_dq,
            "flash_train_bwd_dkv": fa.flash_train_bwd_dkv}


def timed_method(cls, name: str, sink: list):
    """Patch a Trainer method to append (epoch, synchronized wall seconds)
    of each call to sink."""
    real = getattr(cls, name)

    def run(self, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            return real(self, *args, **kwargs)
        finally:
            torch.cuda.synchronize()
            sink.append((len(self.epoch_seconds), time.perf_counter() - t0))
    return mock.patch.object(cls, name, run)


def recording_shapes(shapes: set):
    """Patch the encoder's training attention to record the (B, T, dtype,
    rate) of each call; the call itself is unchanged."""
    from emg_tpu_torch.models import attention as attention_module

    real = attention_module.flash_attention_relpos_train

    def record(q, k, v, used, oob, kp, rate, seed, *offsets):
        shapes.add((q.shape[0], q.shape[2], str(q.dtype).split(".")[-1], float(rate)))
        return real(q, k, v, used, oob, kp, rate, seed, *offsets)
    return mock.patch.object(attention_module, "flash_attention_relpos_train", record)


def train_through_cli(argv, root, record):
    """Train through the CLI's train mode, then serve the model.pt it wrote;
    train again with the step's phases synchronized for their split.
    Returns the launch counts of the first run and the (B, T, dtype, rate)
    set it gave kernels 3-5."""
    from emg_tpu_torch import cli
    from emg_tpu_torch.train.trainer import Trainer

    # run 1, as a user runs it: no synchronization inside a step
    out = os.path.join(root, "train")
    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    shapes, eval_s, per_s = set(), [], []
    t0 = time.perf_counter()
    with recording_shapes(shapes), timed_method(Trainer, "evaluation_loop", eval_s), \
            timed_method(Trainer, "report_PER", per_s):
        trainer = cli.main(argv + TRAIN_ARGS + ["--device", DEVICE, "--output_directory", out])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    logging.getLogger().handlers.clear()

    # run 2: the same run (same batches, seeds and masks), each step's
    # forward, backward and optimizer synchronized and timed
    step_times = []
    with mock.patch.object(Trainer, "step_times", step_times):
        timed_trainer = cli.main(argv + TRAIN_ARGS + ["--device", DEVICE, "--output_directory",
                                                      os.path.join(root, "train_timed")])
    logging.getLogger().handlers.clear()

    latest = torch.load(os.path.join(out, "latest"), map_location="cpu", weights_only=True)
    tags = set()
    for path in glob.glob(os.path.join(out, "logs", "run", "*", "metrics.jsonl")):
        with open(path) as f:
            tags.update(json.loads(line)["tag"] for line in f)
    losses = trainer.train_losses
    n = len(losses)
    frames = sum(s["frames"] for s in step_times)
    epochs_s = sum(trainer.epoch_seconds)
    # each epoch's train loop: its wall less its evaluation passes and PER
    # report (every epoch covers the whole training split: frames / epochs)
    loop_by_epoch = [t - sum(s for e, s in eval_s + per_s if e == i)
                     for i, t in enumerate(trainer.epoch_seconds)]
    epoch_frames = frames / len(trainer.epoch_seconds)
    # per batch shape, the step's phases in the epochs after the first (the
    # first meets each shape cold: allocations, cuDNN's plans, AdamW's
    # moments on the first apply)
    per_shape = {}
    for i, st in enumerate(step_times):
        key = f"{st['examples']}x{st['max_frames']}"
        per_shape.setdefault(key, {"frames": st["frames"], "warm": []})
        if i >= len(step_times) // len(trainer.epoch_seconds):
            per_shape[key]["warm"].append({k: st[k] for k in ("forward", "backward", "optimizer",
                                                              "applied")})
    result = dict(
        microbatches=n, updates=int(latest["updates"]), losses=losses, launches=launches,
        cli_wall_s=wall, peak_mem_bytes=peak, epoch_seconds=trainer.epoch_seconds,
        evaluation_s=eval_s, per_report_s=per_s, frames=frames,
        train_loop_s_by_epoch=loop_by_epoch,
        # all frames over the epochs' wall time (host batch preparation and
        # every microbatch included), without and with the evaluation
        # passes and PER reports; and each epoch's train loop alone (the
        # first meets every shape cold)
        frames_per_s_train_loop=frames / sum(loop_by_epoch),
        frames_per_s_epochs=frames / epochs_s,
        frames_per_s_train_loop_by_epoch=[epoch_frames / t for t in loop_by_epoch],
        # the same frames over the synchronized steps' time alone (run 2)
        frames_per_s_steps=frames / sum(s["forward"] + s["backward"] + s["optimizer"]
                                        for s in step_times) * 1e3,
        timed_run_epoch_seconds=timed_trainer.epoch_seconds,
        ms_by_shape=per_shape, steps=step_times, metric_tags=sorted(tags),
        attention_shapes=sorted(shapes))
    log(f"training {json.dumps(result)}")
    if not (n >= 4 and result["updates"] >= 2 and len(step_times) == n):
        raise AssertionError(f"training ran {n} microbatches and {result['updates']} updates")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"training losses are not {n} finite values: {losses}")
    # the same run: its losses differ only by d_used's atomics and cuDNN's
    # summation order, which move the weights at ~1e-6 from the first apply
    if not np.allclose(timed_trainer.train_losses, losses, rtol=1e-3, atol=0):
        raise AssertionError(f"the timed run's losses differ from the first run's: "
                             f"{timed_trainer.train_losses} vs {losses}")
    if not all(c > 0 for c in launches.values()):
        raise AssertionError(f"a kernel of the training path was never launched: {launches}")
    layers = trainer.config.model.num_layers_encoder
    for name in ("flash_train_fwd", "flash_train_bwd_dq", "flash_train_bwd_dkv"):
        if launches[name] != layers * n:
            raise AssertionError(f"{name}: {launches[name]} launches, not {layers} per microbatch")
    if not {"Loss/Evaluation", "PhonemeErrorRate/Evaluation"} <= tags:
        raise AssertionError(f"no evaluation pass or PER report was logged: {sorted(tags)}")

    per, acc = cli.main(argv + ["--device", DEVICE, "--output_directory", os.path.join(root, "eval"),
                         "--evaluate_saved_greedy_search", os.path.join(out, "model.pt")])
    logging.getLogger().handlers.clear()
    result["served"] = dict(per=per, accuracy=acc)
    log(f"served the trained model.pt: PER {per}, accuracy {acc}")
    if not 0.0 <= per < float("inf"):
        raise AssertionError(f"PER of the trained model is not a finite rate: {per}")
    record["training"] = result
    return launches, shapes


def profiled(run):
    """A torch.profiler trace of one call of run(), and its host wall ms."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        profiled_wall = (time.perf_counter() - t0) * 1e3
    return prof, profiled_wall


def device_work(prof, what: str):
    """From a trace: device ms by name (kernels, copies and fills), the span
    from the first device event's start to the last one's end, and the
    number of kernels (copies and fills aside). Fails if there were none."""
    from torch.autograd import DeviceType

    by_name, first, last, count = {}, float("inf"), 0.0, 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
            first, last = min(first, e.time_range.start), max(last, e.time_range.end)
            count += not e.name.startswith(("Memcpy", "Memset"))
    if not by_name:
        raise AssertionError(f"the profiler saw no device work in {what}")
    return by_name, (last - first) / 1e3, count


def profile_step(run) -> dict:
    """One warm train step: its wall ms without the profiler (median of
    three synchronized runs) and, from a torch.profiler trace of one more,
    the card's busy ms (kernels, copies and fills, one stream), the span
    from the first device event's start to the last one's end, the share of
    the training attention kernels, and the five longest kernels. The idle
    share is read against the unprofiled wall (the profiler's host tracing
    slows the host) and against the device span."""
    run()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        run()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall = float(np.median(walls))
    prof, profiled_wall = profiled(run)
    by_name, span, _ = device_work(prof, "a train step")
    busy = sum(by_name.values())
    attention = {name: ms for name, ms in by_name.items() if "flash_" in name}
    result = dict(wall_ms=wall, walls_ms=walls, profiled_wall_ms=profiled_wall,
                  device_busy_ms=busy, device_span_ms=span,
                  device_idle_share_of_wall=1.0 - busy / wall,
                  device_idle_share_of_span=1.0 - busy / span,
                  train_attention_kernels_ms=sum(attention.values()),
                  train_attention_kernels_by_name=attention,
                  longest_kernels=sorted(by_name.items(), key=lambda kv: -kv[1])[:5])
    log(f"train step profile {json.dumps(result)}")
    return result


def largest_batch(cfg, multiple: int = 1):
    """The training split's largest microbatch at the config's
    max_batch_length, staged int16 as the trainer stages it, its rows and
    utterances padded to multiples of ``multiple`` (a mesh's data axis):
    (its utterances, the PackedBatch, max_frames)."""
    from emg_tpu_torch.data.batching import FRAME_BUCKETS, bucket_up, make_packed_batch, quantize_packed_raw
    from emg_tpu_torch.data.dataset import EMGDataset
    from emg_tpu_torch.data.sampler import DynamicBatchSampler

    trainset = EMGDataset(cfg, device=DEVICE)
    sampler = DynamicBatchSampler(trainset, cfg.train.max_batch_length, cfg.train.n_buckets,
                                  seed=cfg.train.seed)
    idxs = max(sampler, key=len)
    batch = EMGDataset.collate_raw([trainset[i] for i in idxs])
    pb = quantize_packed_raw(make_packed_batch(batch["raw_emg"], batch["lengths"],
                                               batch["phonemes_int"], chunk=cfg.data.packed_chunk,
                                               row_multiple=multiple, batch_multiple=multiple))
    return idxs, pb, bucket_up(max(batch["lengths"]), FRAME_BUCKETS)


def train_step_kernels_vs_plain(argv, record):
    """One float32 train step of the flagship (dropout 0.2) from the same
    weights, batch and generator seeds, with the kernels and with their
    plain versions."""
    from emg_tpu_torch.config import Config
    from emg_tpu_torch.models.model import EMGModel
    from emg_tpu_torch.ops import flash_attention as fa
    from emg_tpu_torch.parallel.train_step import make_train_step
    from emg_tpu_torch.train.state import create_train_state

    cfg = Config.from_args(argv + TRAIN_ARGS + ["--batch_size_grad", str(10 ** 9)])
    idxs, pb, max_frames = largest_batch(cfg)
    step = make_train_step(cfg.train)

    def one_step(state, plain):
        fa.flash_train_fwd.launches = 0
        with (mock.patch("emg_tpu_torch.models.attention.flash_attention_relpos_train",
                         fa.flash_attention_relpos_train_plain)
              if plain else contextlib.nullcontext()):
            metrics = step(state, pb, max_frames, torch.Generator(device=DEVICE))
        torch.cuda.synchronize()
        return metrics, fa.flash_train_fwd.launches

    # two kernel steps (their difference is the noise floor: d_used's
    # atomics, cuDNN's and the embedding's) and one plain step
    states = [create_train_state(EMGModel(cfg.model, device=DEVICE,
                                          generator=torch.Generator().manual_seed(0)), cfg.train)
              for _ in range(3)]
    runs = [one_step(st, plain) for st, plain in zip(states, (False, False, True))]
    if (runs[0][1] == 0 or runs[2][1] != 0) or any(m["applied"] for m, _ in runs):
        raise AssertionError(f"the kernel and plain steps did not run as set up: "
                             f"{[n for _, n in runs]} K3 launches")
    gk, gk2, gp = ({name: p.grad.detach().clone() for name, p in st.model.named_parameters()}
                   for st in states)
    record["train_step_profile"] = profile_step(lambda: one_step(states[0], plain=False))
    mk, mp = runs[0][0], runs[2][0]
    losses = {k: (float(mk[k]), float(mp[k])) for k in ("loss", "dec_loss", "enc_loss")}
    largest = max(float(g.abs().max()) for g in gp.values())

    def compare(got, ref):
        """(whole-gradient norm error, each parameter's max error over its
        largest magnitude, BN-fed biases' max error over the model's
        largest gradient)"""
        worst, noise, diff_sq, ref_sq = {}, 0.0, 0.0, 0.0
        for name, g in ref.items():
            err = float((got[name] - g).abs().max())
            if name.startswith("conv_blocks") and name.endswith(("conv1.bias", "conv2.bias",
                                                                "residual_path.bias")):
                noise = max(noise, err / largest)
                continue
            worst[name] = err / max(float(g.abs().max()), 1e-30)
            diff_sq += float((got[name] - g).pow(2).sum())
            ref_sq += float(g.pow(2).sum())
        return (diff_sq / ref_sq) ** 0.5, dict(sorted(worst.items(), key=lambda kv: -kv[1])[:5]), noise

    norm_err, worst, noise = compare(gk, gp)
    floor_norm, floor_worst, floor_noise = compare(gk, gk2)
    result = dict(examples=len(idxs), max_frames=max_frames, losses=losses,
                  grad_norm_rel_err=norm_err, worst_grad_rel_err=worst,
                  bn_fed_bias_err_of_largest=noise, largest_grad=largest,
                  kernel_vs_kernel=dict(grad_norm_rel_err=floor_norm, worst_grad_rel_err=floor_worst,
                                        bn_fed_bias_err_of_largest=floor_noise))
    record["train_step_f32"] = result
    log(f"train step kernels vs plain (float32) {json.dumps(result)}")
    for k, (a, b) in losses.items():
        if not abs(a - b) <= STEP_LOSS_RTOL * abs(b):
            raise AssertionError(f"{k} differs between the kernel and plain steps: {losses}")
    if not (norm_err <= STEP_NORM_TOL and max(worst.values()) <= STEP_GRAD_TOL
            and noise <= STEP_NOISE_TOL):
        raise AssertionError(f"parameter gradients differ between the kernel and plain steps: {result}")

# ---------------------------------------------------------------------------
# phase 10: the training recipes
# ---------------------------------------------------------------------------

# every recipe knob on; ramp 1, so scheduled sampling mixes from the second
# microbatch on (the recipe's own ramp of 10000 would keep it off here)
RECIPE_KNOBS = ["--train.electrode_rotation_prob", "0.3", "--train.channel_drop_prob", "0.1",
                "--train.time_drop_prob", "0.3", "--train.scheduled_sampling_max_prob", "0.3",
                "--train.scheduled_sampling_ramp", "1"]
CONFORMER = ["--recipe", "conformer_model"]
# the transformer recipe path at full width and reduced depth
SS_RECIPE = ["--recipe", "Parallel_Schedule_Sampling", "--train.channel_drop_prob", "0.1",
             "--train.time_drop_prob", "0.3", "--num_layers_encoder", "2",
             "--num_layers_decoder", "2"]
# unfused vs fused transformer attention, float32, dropout 0: the losses to
# rtol 1e-4; the encoder's valid rows to 1e-4 of their largest magnitude;
# the whole gradient to 1e-4 of its norm; each parameter's gradient to
# STEP_GRAD_TOL of its largest magnitude (phase 8's bound: a ReLU kink, or a
# deeply cancelling sum such as a relative-position table's gradient, moves
# one tensor by up to ~1e-2 of itself; unfused_vs_fused reports each
# tensor over 1e-4 beside its float32 floor); BatchNorm-fed conv biases
# (true gradient 0) to STEP_NOISE_TOL of the model's largest gradient; and,
# directly, the first and last attention layers at the model's own inputs
# and output gradients to 1e-4 of the unfused path in float64
UNFUSED_TOL = 1e-4


def attention_ms(B, T, D, H, maxpos, use_flash: bool, rate: float, key_pads_only: bool):
    """One encoder self-attention module (projections included) at (B, T),
    random weights, every row's key pads from T/2 on for odd rows: device ms
    of its train-mode forward + backward (input and parameter gradients) at
    dropout ``rate``, and of its eval-mode forward (no grad)."""
    from emg_tpu_torch.models.attention import MultiHeadAttention

    gen = torch.Generator().manual_seed(11)
    mha = MultiHeadAttention(D, H, relative_positional=True, relative_positional_distance=maxpos,
                             dropout=rate, use_flash=use_flash)
    with torch.no_grad():
        for p in mha.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * D ** -0.5)
    mha = mha.to(DEVICE)
    x = torch.randn(B, T, D, generator=gen).to(DEVICE).requires_grad_()
    pad = (torch.arange(T)[None, :] >= T // 2) & (torch.arange(B)[:, None] % 2 == 1)
    pad = pad.to(DEVICE)
    g = torch.Generator(device=DEVICE).manual_seed(0)
    qp = None if key_pads_only else pad
    leaves = [x] + list(mha.parameters())

    def fwd_bwd():
        out = mha.train()(x, x, key_padding_mask=pad, query_padding_mask=qp, generator=g)
        return torch.autograd.grad(out.sum(), leaves)

    def fwd():
        with torch.no_grad():
            return mha.eval()(x, x, key_padding_mask=pad, query_padding_mask=qp)
    return dict(train_fwd_bwd_ms=time_ms(fwd_bwd, iters=10), eval_fwd_ms=time_ms(fwd, iters=10))


def recipe_train(args, out, record, key):
    """Train through the CLI's train mode with ``args`` (step phases
    synchronized, for the frames they count), the five kernels' launches
    counted over the run alone. Returns (the Trainer, its result dict)."""
    from emg_tpu_torch import cli
    from emg_tpu_torch.train.trainer import Trainer

    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    step_times, eval_s, per_s = [], [], []
    t0 = time.perf_counter()
    with mock.patch.object(Trainer, "step_times", step_times), \
            timed_method(Trainer, "evaluation_loop", eval_s), timed_method(Trainer, "report_PER", per_s):
        trainer = cli.main(args + ["--device", DEVICE, "--output_directory", out])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    logging.getLogger().handlers.clear()
    latest = torch.load(os.path.join(out, "latest"), map_location="cpu", weights_only=True)
    losses = trainer.train_losses
    frames = sum(st["frames"] for st in step_times)
    loop_s = sum(trainer.epoch_seconds) - sum(t for _, t in eval_s + per_s)
    result = dict(
        microbatches=len(losses), updates=int(latest["updates"]), losses=losses,
        launches={name: fn.launches for name, fn in counters.items()},
        cli_wall_s=wall, peak_mem_bytes=torch.cuda.max_memory_allocated(),
        epoch_seconds=trainer.epoch_seconds, frames=frames,
        # all frames over the train loops' wall (each epoch less its
        # evaluation pass and PER report), and over the synchronized steps
        frames_per_s_train_loop=frames / loop_s,
        frames_per_s_steps=frames / sum(st["forward"] + st["backward"] + st["optimizer"]
                                        for st in step_times) * 1e3,
        ms_by_step=[{k: st[k] for k in ("examples", "max_frames", "forward", "backward",
                                         "optimizer")} for st in step_times],
        config={k: getattr(trainer.config.train, k) for k in (
            "electrode_rotation_prob", "channel_drop_prob", "time_drop_prob",
            "scheduled_sampling_max_prob", "scheduled_sampling_ramp")}
        | {"encoder_kind": trainer.config.model.encoder_kind,
           "num_layers_encoder": trainer.config.model.num_layers_encoder})
    record[key] = result
    log(f"{key} {json.dumps(result)}")
    if not (len(losses) >= 4 and result["updates"] >= 2 and len(step_times) == len(losses)):
        raise AssertionError(f"{key} ran {len(losses)} microbatches and {result['updates']} updates")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{key}: the losses are not finite: {losses}")
    return trainer, result


def conformer_step_profile(argv, record):
    """One warm conformer train step with every recipe knob on (the largest
    microbatch, scheduled sampling at its full 0.3) under torch.profiler,
    and the unfused self-attention's part of it: per layer one train-mode
    forward + backward and one eval-mode forward (scheduled sampling's
    first pass), timed alone at the step's shape."""
    from emg_tpu_torch.models.model import EMGModel
    from emg_tpu_torch.parallel.train_step import make_train_step
    from emg_tpu_torch.train.state import create_train_state

    cfg = cli_config(argv + TRAIN_ARGS + RECIPE_KNOBS + CONFORMER + ["--batch_size_grad", str(10 ** 9)])
    idxs, pb, max_frames = largest_batch(cfg)
    state = create_train_state(EMGModel(cfg.model, device=DEVICE,
                                        generator=torch.Generator().manual_seed(0)), cfg.train)
    state.microbatches = 1  # past the ramp
    step = make_train_step(cfg.train)
    gen = torch.Generator(device=DEVICE)
    profile = profile_step(lambda: step(state, pb, max_frames, gen))
    m = cfg.model
    attn = attention_ms(len(pb.lengths), max_frames, m.model_size, m.n_heads_encoder,
                        m.relative_distance, use_flash=False, rate=m.dropout_model,
                        key_pads_only=True)
    attn_ms = m.num_layers_encoder * (attn["train_fwd_bwd_ms"] + attn["eval_fwd_ms"])
    result = dict(examples=len(idxs), B=len(pb.lengths), max_frames=max_frames, step=profile,
                  attention_per_layer=attn, attention_ms=attn_ms,
                  attention_share_of_busy=attn_ms / profile["device_busy_ms"])
    record["conformer_step"] = result
    log(f"conformer step {json.dumps(result)}")


def k2_at_shapes(shapes, record):
    """K2 against its plain version at every (B, T, dtype) scheduled
    sampling's first passes launched it with, timed."""
    from emg_tpu_torch.ops.flash_attention import flash_attention_relpos, flash_attention_relpos_plain

    relpos, gen = make_relpos(5)
    H, Dh = relpos.embeddings.shape[0], relpos.embeddings.shape[2]
    rows = []
    for B, T, dtype in sorted(shapes):
        dt = getattr(torch, dtype)
        q, k, v = (torch.randn(B, H, T, Dh, generator=gen).to(DEVICE, dt) for _ in range(3))
        kp = torch.zeros(B, T, dtype=torch.bool)
        for b in range(B):
            kp[b, T - (b * 37) % (T // 2):] = True
        kp = kp.to(DEVICE)
        with torch.no_grad():
            used, oob = relpos.window(T)
            used = used.to(dt)
            got = flash_attention_relpos(q, k, v, used, oob, kp)
            ref = flash_attention_relpos_plain(q, k, v, used, oob, kp)
            valid = ~kp[:, None, :, None].expand_as(got)
            err = float((got - ref).abs()[valid].max())
            size = 2 if dt == torch.bfloat16 else 4
            bytes_moved = (3 * B * H * T * Dh + H * (2 * T - 1) * Dh) * size \
                + (2 * T - 1) * 4 + B * T + B * H * T * Dh * 4
            b_ms, b_by = bound(bytes_moved, 6.0 * B * H * T * T * Dh, ATTN_PEAK_FLOPS[dt])
            row = dict(B=B, H=H, T=T, Dh=Dh, dtype=dtype, max_abs_err=err,
                       ms=time_ms(lambda: flash_attention_relpos(q, k, v, used, oob, kp)),
                       plain_ms=time_ms(lambda: flash_attention_relpos_plain(q, k, v, used, oob, kp)),
                       bound_ms=b_ms, bound_by=b_by)
        rows.append(row)
        log(f"K2 at a scheduled-sampling shape {json.dumps(row)}")
        if not err <= K2_TOL[dt]:
            raise AssertionError(f"flash_attention_relpos disagrees with its plain version: {row}")
    record["k2_scheduled_sampling_shapes"] = rows


def transformer_recipe(argv, root, record):
    """Parallel_Schedule_Sampling with channel and time drop on the flagship
    at 2+2 layers through the CLI: K2's shapes in scheduled sampling's first
    passes, then K2 against its plain version at each."""
    from emg_tpu_torch.models import attention as attention_module
    from emg_tpu_torch.parallel import train_step as train_step_module

    first_pass, shapes, first_pass_launches = [False], set(), [0]
    real_ss = train_step_module.scheduled_sampling_inputs
    real_k2 = attention_module.flash_attention_relpos

    def ss(*args):
        first_pass[0] = True
        try:
            return real_ss(*args)
        finally:
            first_pass[0] = False

    def k2(q, k, v, used, oob, kp):
        if first_pass[0]:
            shapes.add((q.shape[0], q.shape[2], str(q.dtype).split(".")[-1]))
            first_pass_launches[0] += 1
        return real_k2(q, k, v, used, oob, kp)
    with mock.patch.object(train_step_module, "scheduled_sampling_inputs", ss), \
            mock.patch.object(attention_module, "flash_attention_relpos", k2):
        trainer, result = recipe_train(argv + TRAIN_ARGS + SS_RECIPE,
                                       os.path.join(root, "ss_train"), record, "transformer_recipe")
    n, layers = result["microbatches"], trainer.config.model.num_layers_encoder
    result.update(first_pass_k2_launches=first_pass_launches[0], k2_shapes=sorted(shapes))
    if not all(c > 0 for c in result["launches"].values()):
        raise AssertionError(f"a kernel of the recipe's path was never launched: {result['launches']}")
    if first_pass_launches[0] != layers * n:
        raise AssertionError(f"scheduled sampling's first passes launched K2 {first_pass_launches[0]} "
                             f"times, not {layers} per microbatch")
    for name in ("flash_train_fwd", "flash_train_bwd_dq", "flash_train_bwd_dkv"):
        if result["launches"][name] != layers * n:
            raise AssertionError(f"{name}: {result['launches'][name]} launches, not {layers} per microbatch")
    k2_at_shapes(shapes, record)


def attention_at_model_inputs(mha, x, kwargs, dout) -> dict:
    """One encoder self-attention module at the input and output gradient
    the model gave it: its output (valid rows) and its input and parameter
    gradients with the fused kernels (K3-K5) and on the unfused path, both
    float32, each against the unfused path in float64, relative to the
    reference's largest magnitude."""
    import copy

    def run(use_flash, dtype, d):
        m = copy.deepcopy(mha).to(dtype).train()
        m.use_flash = use_flash
        xx = x.to(dtype).requires_grad_()
        out = m(xx, xx, **kwargs)
        names = ["input"] + [n for n, _ in m.named_parameters()]
        grads = torch.autograd.grad(out, [xx] + list(m.parameters()), d.to(dtype))
        return out.detach(), dict(zip(names, grads))

    valid = ~kwargs["key_padding_mask"]
    ref_out, ref = run(False, torch.float64, dout)
    errs = {}
    for label, flash in (("kernels", True), ("unfused", False)):
        out, grads = run(flash, torch.float32, dout)
        errs[label] = {"output": rel_err(out[valid], ref_out[valid])}
        errs[label].update({n: rel_err(g, ref[n]) for n, g in grads.items()})
    return errs


def unfused_vs_fused(argv, record):
    """One flagship microbatch (the largest, float32, dropout 0) through the
    train-mode forward and backward with the unfused encoder attention and
    with the fused kernels (K3-K5), from the same weights and generator
    seed; a third, fused, on the raw input moved by a relative 1e-6 shows
    each gradient's float32 floor. The first and last encoder layers'
    attention is also held, at the inputs and output gradient of the first
    run, against the unfused path in float64 (see UNFUSED_TOL)."""
    import dataclasses

    from emg_tpu_torch.models.model import EMGModel
    from emg_tpu_torch.ops.losses import combined_loss
    from emg_tpu_torch.parallel.train_step import batch_to_device, compute_losses

    cfg = cli_config(argv + TRAIN_ARGS + ["--dropout_model", "0", "--dropout_pos_emb", "0"])
    idxs, pb, max_frames = largest_batch(cfg)
    sd = EMGModel(cfg.model, device=DEVICE, generator=torch.Generator().manual_seed(0)).state_dict()
    runs, layer_inputs = [], {}
    for flash, nudge in ((True, 0.0), (False, 0.0), (True, 1e-6)):
        model = EMGModel(dataclasses.replace(cfg.model, use_flash_attention=flash), device=DEVICE)
        model.load_state_dict(sd)
        seen, hooks = {}, []

        def keep_memory(module, inputs, output):
            seen["memory"] = output.detach()
        hooks.append(model.transformerEncoder.register_forward_hook(keep_memory))
        layers = model.transformerEncoder.layers
        if not runs:  # the first layer's and the last layer's attention
            for i in (0, len(layers) - 1):
                def keep_inputs(module, args, kwargs, output, i=i):
                    rec = layer_inputs[i] = dict(mha=module, x=args[0].detach(), kwargs={
                        k: kwargs[k] for k in ("key_padding_mask", "query_padding_mask")})
                    output.register_hook(lambda g: rec.__setitem__("dout", g.detach()))
                hooks.append(layers[i].self_attn.register_forward_hook(keep_inputs, with_kwargs=True))
        dev = batch_to_device(pb, DEVICE)
        if nudge:  # the floor: the raw input moved by a relative 1e-6
            noise = torch.randn(dev["packed_raw"].shape, generator=torch.Generator(device=DEVICE).manual_seed(2),
                                device=DEVICE)
            dev["packed_raw"] = dev["packed_raw"] * (1.0 + nudge * noise)
        dec, enc = compute_losses(model.train(), dev, max_frames,
                                  torch.Generator(device=DEVICE).manual_seed(1))
        loss = combined_loss(dec, enc, cfg.train.alpha_loss)
        loss.backward()
        for hook in hooks:
            hook.remove()
        valid = torch.arange(max_frames, device=DEVICE)[None, :] < dev["lengths"][:, None]
        runs.append(dict(losses=[float(t.detach()) for t in (loss, dec, enc)], memory=seen["memory"][valid],
                         grads={k: p.grad.detach().clone() for k, p in model.named_parameters()}))
    largest = max(float(g.abs().max()) for g in runs[0]["grads"].values())

    def compare(a, b):
        """Losses, the encoder's valid rows, the whole gradient (norm), and
        each gradient's largest error over its largest magnitude; the
        BatchNorm-fed conv biases (true gradient 0) over the model's
        largest gradient instead."""
        each, noise, diff_sq, ref_sq = {}, 0.0, 0.0, 0.0
        for name, g in b["grads"].items():
            d = a["grads"][name] - g
            diff_sq += float(d.pow(2).sum())
            ref_sq += float(g.pow(2).sum())
            if name.startswith("conv_blocks") and name.endswith(("conv1.bias", "conv2.bias",
                                                                "residual_path.bias")):
                noise = max(noise, float(d.abs().max()) / largest)
            else:
                each[name] = float(d.abs().max()) / max(float(g.abs().max()), 1e-30)
        return dict(loss_rel_err=[abs(x - y) / abs(y) for x, y in zip(a["losses"], b["losses"])],
                    memory_rel_err=rel_err(a["memory"], b["memory"]),
                    grad_norm_rel_err=(diff_sq / ref_sq) ** 0.5,
                    bn_fed_bias_err_of_largest=noise, each=each)
    unfused, floor = compare(runs[1], runs[0]), compare(runs[2], runs[0])
    # the gradients over 1e-4 of their largest magnitude, beside how far
    # each moves when the raw input moves by a relative 1e-6 (its float32
    # floor): deeply cancelling sums (the relative-position tables, the
    # BatchNorm shifts) sit near their floor; a feed-forward weight far over
    # it has a ReLU whose input lay within the attention's ~1e-6 of zero
    over = {name: dict(err=e, floor=floor["each"][name]) for name, e in unfused["each"].items()
            if e > UNFUSED_TOL}
    worst_each = max(unfused["each"].values())
    for c in (unfused, floor):
        c["worst"] = dict(sorted(c.pop("each").items(), key=lambda kv: -kv[1])[:8])
    B, m = len(pb.lengths), cfg.model
    result = dict(examples=len(idxs), B=B, max_frames=max_frames, largest_grad=largest,
                  losses={"fused": runs[0]["losses"], "unfused": runs[1]["losses"]},
                  unfused_vs_fused=unfused, nudged_vs_fused=floor, over_1e_4=over,
                  layer_attention_vs_float64={
                      f"layer{i}": attention_at_model_inputs(r["mha"], r["x"], r["kwargs"], r["dout"])
                      for i, r in sorted(layer_inputs.items())},
                  attention_ms={variant: attention_ms(B, max_frames, m.model_size, m.n_heads_encoder,
                                                      m.relative_distance, use_flash=flash, rate=0.0,
                                                      key_pads_only=False)
                                for variant, flash in (("fused", True), ("unfused", False))})
    record["unfused_vs_fused"] = result
    log(f"unfused vs fused attention (float32) {json.dumps(result)}")
    layer_errs = [e for layer in result["layer_attention_vs_float64"].values()
                  for label in ("kernels", "unfused") for e in layer[label].values()]
    if not (max(unfused["loss_rel_err"]) <= UNFUSED_TOL and unfused["memory_rel_err"] <= UNFUSED_TOL
            and unfused["grad_norm_rel_err"] <= UNFUSED_TOL and worst_each <= STEP_GRAD_TOL
            and unfused["bn_fed_bias_err_of_largest"] <= STEP_NOISE_TOL
            and max(layer_errs) <= UNFUSED_TOL):
        raise AssertionError(f"the unfused attention disagrees with the fused one: {unfused}, {over}, "
                             f"{result['layer_attention_vs_float64']}")


def recipes_phase(argv, root, record):
    """Phase 10: the conformer recipe with every knob on at full width
    through the CLI, its step's profile, its model.pt greedy- (bf16, and
    float32 kernels vs plain) and beam-evaluated; the transformer's
    scheduled-sampling recipe; the unfused attention against the fused."""
    from emg_tpu_torch import cli
    from emg_tpu_torch.ops.flash_attention import flash_attention_relpos
    from emg_tpu_torch.ops.iir_scan import iir_scan

    t0 = time.perf_counter()
    out = os.path.join(root, "conformer_train")
    trainer, result = recipe_train(argv + TRAIN_ARGS + RECIPE_KNOBS + CONFORMER, out, record,
                                   "conformer_recipe")
    launches = result["launches"]
    if trainer.config.model.encoder_kind != "conformer" or launches["iir_scan"] == 0 or any(
            launches[name] for name in launches if name != "iir_scan"):
        raise AssertionError(f"the conformer recipe did not run as set up: {result['config']}, "
                             f"{launches} (its attention is never fused)")
    conformer_step_profile(argv, record)

    ckpt = os.path.join(out, "model.pt")
    iir_scan.launches = flash_attention_relpos.launches = 0
    per, acc = cli.main(argv + CONFORMER + ["--device", DEVICE, "--evaluate_saved_greedy_search", ckpt,
                                            "--output_directory", os.path.join(root, "conformer_eval")])
    logging.getLogger().handlers.clear()
    record["conformer_greedy"] = dict(per=per, accuracy=acc, launches={
        "iir_scan": iir_scan.launches, "flash_attention_relpos": flash_attention_relpos.launches})
    log(f"conformer greedy (bf16) {json.dumps(record['conformer_greedy'])}")
    if not (0.0 <= per < float("inf") and iir_scan.launches > 0 and flash_attention_relpos.launches == 0):
        raise AssertionError(f"conformer greedy serving: {record['conformer_greedy']}")
    whole_path_kernels_vs_plain(argv + ["--encoder_kind", "conformer"], ckpt, record,
                                record_key="conformer_whole_path_f32")
    beam_cli(argv, ckpt, os.path.join(root, "lm.arpa"), os.path.join(root, "conformer_beam"), record,
             cli_extra=CONFORMER + ["--BeamWidth", "10"], key="conformer_beam_cli",
             kernels=("iir_scan",))

    transformer_recipe(argv, root, record)
    unfused_vs_fused(argv, record)
    record["recipes_phase_s"] = time.perf_counter() - t0
    log(f"phase 10 took {record['recipes_phase_s']:.1f} s")
    summary = {k: record[k] for k in ("conformer_recipe", "conformer_step", "conformer_greedy",
                                      "transformer_recipe", "k2_scheduled_sampling_shapes",
                                      "unfused_vs_fused", "recipes_phase_s")}
    summary["conformer_beam_wer"] = record["conformer_beam_cli"]["wer"]
    print(json.dumps({"recipes": summary}, default=str), flush=True)


# ---------------------------------------------------------------------------
# phase 11: the beam's remainder (int8 decoder weights, search_from_raw,
# continuous lanes)
# ---------------------------------------------------------------------------

def int8_weights(model) -> dict:
    from emg_tpu_torch.utils.quantize import Int8Weight

    return {name: m for name, m in model.named_modules() if isinstance(m, Int8Weight)}


def int8_greedy(argv, ckpt, record) -> dict:
    """Greedy serving with --quantize_int8 true through the CLI (K1 and K2
    launches over that run alone, as phase 5's); the decoder's weight
    bytes int8 against bf16; layer 0's dequantized weights on the card
    against the CPU, bitwise; per test utterance, warm greedy decode
    through the graphs with the int8 and the bf16 model from one encoder
    memory (the encoder is not quantized): ms, and the first divergence
    margin where the strings differ."""
    from emg_tpu_torch import cli
    from emg_tpu_torch.config import Config
    from emg_tpu_torch.data.dataset import EMGDataset
    from emg_tpu_torch.decode.graphs import LoopRunner
    from emg_tpu_torch.decode.greedy import encode_batch, greedy_loop
    from emg_tpu_torch.ops.flash_attention import flash_attention_relpos
    from emg_tpu_torch.ops.iir_scan import iir_scan
    from emg_tpu_torch.utils.quantize import Int8Weight

    full = argv + ["--device", DEVICE, "--evaluate_saved_greedy_search", ckpt, "--quantize_int8", "true"]
    iir_scan.launches = 0
    flash_attention_relpos.launches = 0
    runners = []
    with runners_built(runners):
        per, acc = cli.main(full)
    launches = {"iir_scan": iir_scan.launches, "flash_attention_relpos": flash_attention_relpos.launches}
    logging.getLogger().handlers.clear()

    cfg = Config.from_args(argv)
    bf16 = serving_model(cfg, ckpt)
    int8 = serving_model(Config.from_args(argv + ["--quantize_int8", "true"]), ckpt)
    weights = int8_weights(int8)
    layer0 = {n: w for n, w in weights.items() if ".layers.0." in n}
    dequant_equal = all(torch.equal(w.dequantize().cpu(), Int8Weight(
        w.data.cpu(), w.scale.cpu(), w.dequant_dtype).dequantize()) for w in layer0.values())
    weight_bytes = dict(
        count=len(weights),
        bf16=sum(bf16.get_parameter(n).nbytes for n in weights),
        int8=sum(w.data.nbytes for w in weights.values()),
        scales=sum(w.scale.nbytes for w in weights.values()))

    testset = EMGDataset(cfg, test=True, device=DEVICE)
    runner = {"bf16": LoopRunner(bf16), "int8": LoopRunner(int8)}
    rows = []
    for i in range(len(testset)):
        pb, max_frames, example = cli.prepare_single(cfg, testset, i)
        cap, steps = pb.targets.shape[1] - 1, int(example["phonemes_int_lengths"][0]) - 1
        row, outs = dict(utterance=i), {}
        with torch.inference_mode():
            mem, _, mask = encode_batch(bf16, pb, max_frames)
            for name, model in (("bf16", bf16), ("int8", int8)):
                for _ in range(2):  # the second run is warm
                    (out, _), ms = timed_sync(lambda: greedy_loop(model, mem, mask, cap, steps,
                                                                  runner=runner[name]))
                outs[name] = out.cpu().numpy()[0]
                row[f"{name}_ms"] = ms
            row["equal"] = bool(np.array_equal(outs["bf16"], outs["int8"]))
            if not row["equal"]:
                row["margin"] = first_divergence_margin(bf16, mem, mask, outs["bf16"], outs["int8"])
        rows.append(row)
    result = dict(per=per, accuracy=acc, launches=launches, cli_graphs=runners_summary(runners),
                  weight_bytes=weight_bytes, layer0_dequant_cpu_equals_card=dequant_equal,
                  layer0_weights=len(layer0), utterances=rows,
                  greedy_ms=dict(bf16=float(np.mean([r["bf16_ms"] for r in rows])),
                                 int8=float(np.mean([r["int8_ms"] for r in rows]))),
                  strings_equal=sum(r["equal"] for r in rows))
    log(f"int8 greedy {json.dumps(result)}")
    if launches != GREEDY_LAUNCHES:
        raise AssertionError(f"the int8 greedy run's kernel launches moved: {launches}")
    if not (dequant_equal and layer0 and weight_bytes["count"] == 10 * cfg.model.num_layers_decoder):
        raise AssertionError(f"the int8 weights are not as quantized: {result}")
    if not 0.0 <= per < float("inf"):
        raise AssertionError(f"the int8 PER is not a finite rate: {per}")
    return result


def int8_beam(argv, ckpt, arpa, root, record) -> dict:
    """The beam CLI at W = 100 with --quantize_int8 true (a finite WER,
    lexicon words, K1 and K2 launched), and one graph replay of the first
    test utterance's search with the int8 and the bf16 model: device ms a
    step (CUDA events) and kernels a step (torch.profiler)."""
    from emg_tpu_torch import cli
    from emg_tpu_torch.data.dataset import EMGDataset
    from emg_tpu_torch.decode.device_beam import DeviceBeamSearcher

    launches = beam_cli(argv, ckpt, arpa, os.path.join(root, "beam_int8"), record,
                        cli_extra=("--quantize_int8", "true"), key="beam_cli_int8")
    cfg, tree, dlm, _ = beam_setup(argv, arpa)
    testset = EMGDataset(cfg, test=True, device=DEVICE)
    pb, max_frames, raw = cli.prepare_single(cfg, testset, 0)
    target_len = int((raw["phonemes_int"][0][1:] != 40).sum())
    step_cap = 16 * ((target_len + cfg.decode.extra_steps + 15) // 16)
    steps = {}
    for name, dc in (("bf16", cfg.decode), ("int8", dataclasses.replace(cfg.decode, quantize_int8=True))):
        searcher = DeviceBeamSearcher(serving_model(cfg, ckpt), tree, dlm, dc, max_frames,
                                      max_steps=step_cap)
        searcher.search(pb, target_len)
        report = graph_report(searcher.runner)["replay"]
        steps[name] = dict(device_ms_per_step=report["device_ms_per_step"],
                           kernels_per_step=report["kernels_per_step"],
                           longest=report["longest"])
    result = dict(wer=record["beam_cli_int8"]["wer"], launches=launches, step=steps)
    log(f"int8 beam {json.dumps(result)}")
    return result


def raw_searches(argv, ckpt, arpa, record) -> dict:
    """search_from_raw on each test utterance's raw signal (no neighbour
    context) against the packed path of the same DSP (the DSP on the card,
    the soft clip, the rows packed on the host, ``search``): the history,
    words and score must be equal; warm ms of each; K1's and K2's launches
    over one pass of search_from_raw alone."""
    from emg_tpu_torch import cli
    from emg_tpu_torch.data.batching import PackedBatch, bucket_up
    from emg_tpu_torch.data.dataset import EMGDataset
    from emg_tpu_torch.decode.device_beam import RAW_SAMPLE_BUCKETS, DeviceBeamSearcher
    from emg_tpu_torch.dsp.features import n_frames
    from emg_tpu_torch.dsp.pipeline import FEAT_RATE, SOURCE_RATE, preprocess_emg
    from emg_tpu_torch.dsp.resample import subsample_length
    from emg_tpu_torch.ops.flash_attention import flash_attention_relpos
    from emg_tpu_torch.ops.iir_scan import iir_scan

    cfg, tree, dlm, words = beam_setup(argv, arpa)
    model = serving_model(cfg, ckpt)
    testset = EMGDataset(cfg, test=True, device=DEVICE)
    cases, searchers = [], {}
    for i in range(len(testset)):
        directory, idx = testset.example_indices[i]
        signal = np.load(os.path.join(directory.directory, f"{idx}_emg.npy")).astype(np.float32)
        _, max_frames, example = cli.prepare_single(cfg, testset, i)
        target_len = int((example["phonemes_int"][0][1:] != 40).sum())
        step_cap = 16 * ((target_len + cfg.decode.extra_steps + 15) // 16)
        if (max_frames, step_cap) not in searchers:
            searchers[max_frames, step_cap] = DeviceBeamSearcher(model, tree, dlm, cfg.decode,
                                                                 max_frames, max_steps=step_cap)
        cases.append((searchers[max_frames, step_cap], signal, target_len))

    def packed_path(searcher, signal, target_len):
        n, C = signal.shape
        Tb = bucket_up(n, RAW_SAMPLE_BUCKETS)
        F_cap = min(n_frames(subsample_length(Tb, FEAT_RATE, SOURCE_RATE)), searcher.max_frames)
        rows_b = max(1, -(-(8 * F_cap) // 1600))
        buf = torch.zeros((Tb, C), device=DEVICE)
        buf[:n] = torch.as_tensor(signal)
        with torch.inference_mode():
            out = preprocess_emg(buf, n, 0, 0)
            F = min(out.n_frames, F_cap)
            clipped = (50.0 * torch.tanh(out.emg_orig[8 : 8 + 8 * F] / 20.0 / 50.0)).cpu().numpy()
        flat = np.full((rows_b * 1600, C), 42.0, np.float32)
        flat[: 8 * F] = clipped
        batch = PackedBatch(
            packed_raw=flat.reshape(rows_b, 1600, C), n_rows=np.int32((8 * F + 1599) // 1600),
            lengths=np.asarray([F], np.int32), offsets=np.zeros(1, np.int32),
            targets=np.full((1, 1), 42, np.int64), target_lengths=np.ones(1, np.int32),
            n_examples=np.int32(1))
        return searcher.search(batch, target_len)

    rows = []
    for i, (searcher, signal, target_len) in enumerate(cases):
        row = dict(utterance=i, samples=signal.shape[0], frames=searcher.max_frames)
        raw_ms, packed_ms = [], []
        for rep in range(4):  # the first pair warms up; the others alternate
            runs = [("raw", raw_ms, lambda: searcher.search_from_raw(signal, target_len)),
                    ("packed", packed_ms, lambda: packed_path(searcher, signal, target_len))]
            for name, times, fn in (runs if rep % 2 else runs[::-1]):
                out, ms = timed_sync(fn)
                times.append(ms)
                row[name] = out
        row["raw_ms"], row["packed_ms"] = float(np.median(raw_ms[1:])), float(np.median(packed_ms[1:]))
        (h1, s1, w1), (h2, s2, w2) = row.pop("raw"), row.pop("packed")
        row.update(score=s1, words=w1, equal=list(h1) == list(h2) and w1 == w2 and s1 == s2)
        rows.append(row)
    iir_scan.launches = 0
    flash_attention_relpos.launches = 0
    for searcher, signal, target_len in cases:
        searcher.search_from_raw(signal, target_len)
    torch.cuda.synchronize()
    launches = {"iir_scan": iir_scan.launches, "flash_attention_relpos": flash_attention_relpos.launches}
    result = dict(utterances=rows, launches=launches,
                  raw_ms=float(np.mean([r["raw_ms"] for r in rows])),
                  packed_ms=float(np.mean([r["packed_ms"] for r in rows])))
    log(f"search_from_raw {json.dumps(result)}")
    if not all(r["equal"] for r in rows):
        raise AssertionError(f"search_from_raw differs from the packed path: {rows}")
    if not (launches["iir_scan"] > 0 and launches["flash_attention_relpos"] > 0):
        raise AssertionError(f"search_from_raw did not launch K1 and K2: {launches}")
    if any(w not in words for r in rows for w in r["words"]):
        raise AssertionError("search_from_raw emitted a word outside the lexicon")
    return result


def continuous_lanes(argv, ckpt, arpa, root, record, lanes: int = 4) -> dict:
    """The beam CLI with --continuous_lanes: words per utterance equal to
    the lock-step CLI run of phase 9, and the same K1 and K2 launches.
    Then all test utterances at one geometry (the largest frame bucket and
    step cap among them), warm: lock-step (``search_many``, the CLI's 8 a
    launch) against ``lanes`` continuous lanes of 16 steps an advance:
    ms, utterances/s, equal words; advances, refills, fetches, and host
    reads per advance under CUDA's sync debug mode, less the encodes'
    (counted on their own: their uploads)."""
    from emg_tpu_torch import cli
    from emg_tpu_torch.data.dataset import EMGDataset
    from emg_tpu_torch.decode.continuous import ContinuousBeamServer
    from emg_tpu_torch.decode.device_beam import DeviceBeamSearcher

    launches = beam_cli(argv, ckpt, arpa, os.path.join(root, "beam_continuous"), record,
                        cli_extra=("--continuous_lanes", str(lanes)), key="beam_cli_continuous")
    lockstep_words = record["beam_cli"]["predictions"]
    words_equal = record["beam_cli_continuous"]["predictions"] == lockstep_words

    cfg, tree, dlm, _ = beam_setup(argv, arpa)
    model = serving_model(cfg, ckpt)
    testset = EMGDataset(cfg, test=True, device=DEVICE)
    prepared = []
    for i in range(len(testset)):
        pb, max_frames, raw = cli.prepare_single(cfg, testset, i)
        prepared.append((pb, max_frames, int((raw["phonemes_int"][0][1:] != 40).sum())))
    max_frames = max(p[1] for p in prepared)
    step_cap = max(16 * ((L + cfg.decode.extra_steps + 15) // 16) for _, _, L in prepared)
    # the same batches at the common frame bucket
    searcher = DeviceBeamSearcher(model, tree, dlm, cfg.decode, max_frames, max_steps=step_cap)
    pbs, lens = [p[0] for p in prepared], [p[2] for p in prepared]
    server = ContinuousBeamServer(searcher, lanes=lanes)
    # an odd chunk: two graphs replayed in turn, the caches never copied
    odd = ContinuousBeamServer(searcher, lanes=lanes, chunk=3)
    with torch.inference_mode():
        _, _, encode_reads = counted_reads(lambda: [searcher._make_ctx(pb) for pb in pbs])
    for _ in range(2):  # the second run is warm
        lock, lock_ms, lock_reads = counted_reads(lambda: searcher.search_many(pbs, lens))
        before = (server.advances, server.fetches, server.refills)
        cont, cont_ms, cont_reads = counted_reads(lambda: server.serve(list(zip(pbs, lens))))
        odd_out, odd_ms = timed_sync(lambda: odd.serve(list(zip(pbs, lens))))
    advances, fetches, refills = (after - b for after, b in
                                  zip((server.advances, server.fetches, server.refills), before))
    n = len(pbs)
    result = dict(cli_words_equal=words_equal, cli_launches=launches,
                  lockstep_cli_launches=record["beam_cli"]["launches"],
                  geometry=dict(max_frames=max_frames, step_cap=step_cap, utterances=n, lanes=lanes,
                                chunk=server.chunk),
                  lockstep=dict(ms=lock_ms, utterances_per_s=n / lock_ms * 1e3, host_reads=lock_reads),
                  continuous=dict(ms=cont_ms, utterances_per_s=n / cont_ms * 1e3, host_reads=cont_reads,
                                  advances=advances, fetches=fetches, refills=refills,
                                  encode_reads=encode_reads,
                                  host_reads_per_advance=(cont_reads - encode_reads) / advances),
                  words_equal=[a[2] == b[2] for a, b in zip(lock, cont)],
                  odd_chunk=dict(chunk=odd.chunk, ms=odd_ms, advances=odd.advances // 2,
                                 equal=[a[2] == b[2] for a, b in zip(cont, odd_out)],
                                 score_diff=max([abs(a[1] - b[1]) for a, b in zip(cont, odd_out)
                                                 if np.isfinite(a[1]) and np.isfinite(b[1])],
                                                default=0.0)),
                  captures=[dict(geometry=str(key), capture_s=c.capture_s, pool_MB=c.pool_bytes / 2**20,
                                 graphs=1 + (c.other is not None))
                            for key, c in searcher.runner.graphs.items()])
    log(f"continuous lanes {json.dumps(result)}")
    if not words_equal or not all(result["words_equal"]) or not all(result["odd_chunk"]["equal"]):
        raise AssertionError(f"continuous lanes differ from the lock-step run: {result}")
    odd_graphs = [c["graphs"] for c in result["captures"] if c["geometry"] == str(("continuous", lanes, 3))]
    if odd_graphs != [2]:
        raise AssertionError(f"an odd chunk did not run as two graphs in turn: {result['captures']}")
    if launches != record["beam_cli"]["launches"]:
        raise AssertionError(f"the continuous CLI run's K1/K2 launches moved: {launches}")
    # one read of the done flags an advance, one fetch an advance with a
    # finished lane, one upload of the first lanes' max_len
    if cont_reads - encode_reads > advances + fetches + 1 or refills != n - lanes:
        raise AssertionError(f"the continuous server read the card more than it should: {result}")
    return result


def beam_remainder(argv, ckpt, root, record):
    t0 = time.perf_counter()
    arpa = os.path.join(root, "lm.arpa")  # phase 9's
    result = dict(int8_greedy=int8_greedy(argv, ckpt, record),
                  int8_beam=int8_beam(argv, ckpt, arpa, root, record),
                  search_from_raw=raw_searches(argv, ckpt, arpa, record),
                  continuous=continuous_lanes(argv, ckpt, arpa, root, record))
    result["phase_s"] = time.perf_counter() - t0
    record["beam_remainder"] = result
    log(f"phase 11 took {result['phase_s']:.1f} s")
    summary = dict(
        weight_bytes=result["int8_greedy"]["weight_bytes"],
        greedy_ms=result["int8_greedy"]["greedy_ms"],
        greedy_strings_equal=result["int8_greedy"]["strings_equal"],
        int8_wer=result["int8_beam"]["wer"],
        beam_step={k: v["device_ms_per_step"] for k, v in result["int8_beam"]["step"].items()},
        raw_ms=result["search_from_raw"]["raw_ms"], packed_ms=result["search_from_raw"]["packed_ms"],
        lockstep_utt_s=result["continuous"]["lockstep"]["utterances_per_s"],
        continuous_utt_s=result["continuous"]["continuous"]["utterances_per_s"],
        phase_s=result["phase_s"])
    print(json.dumps({"beam_remainder": summary}, default=str), flush=True)


# ---------------------------------------------------------------------------
# phase 12: multi-device training, two ranks sharing the one card
# ---------------------------------------------------------------------------

# (name, data axis, model axis, sequence_shard): two ranks each
MESH_GEOMETRIES = (("2x1", 2, 1, False), ("1x2", 1, 2, False), ("1x2_seq", 1, 2, True))
MESH_EPOCH_ARGS = ["--n_epochs", "1", "--max_batch_length", "80000", "--batch_size_grad", "20",
                   "--report_loss", "2", "--per_train_batches", "2"]


def grad_errors(got, ref, largest):
    """(whole-gradient norm error, each parameter's max error over its
    largest magnitude (the five worst), BN-fed biases' max error over the
    model's largest gradient), as phase 8 holds them."""
    worst, noise, diff_sq, ref_sq = {}, 0.0, 0.0, 0.0
    for name, g in ref.items():
        err = float((got[name] - g).abs().max())
        if name.startswith("conv_blocks") and name.endswith(("conv1.bias", "conv2.bias",
                                                            "residual_path.bias")):
            noise = max(noise, err / largest)
            continue
        worst[name] = err / max(float(g.abs().max()), 1e-30)
        diff_sq += float((got[name] - g).pow(2).sum())
        ref_sq += float(g.pow(2).sum())
    return (diff_sq / ref_sq) ** 0.5, dict(sorted(worst.items(), key=lambda kv: -kv[1])[:5]), noise


def k345_block(q, k, v, used, oob, kp, dout, rate, seed, b: slice, h: slice, whole) -> dict:
    """K3-K5 on the block (batch rows ``b``, heads ``h``) of the inputs at
    its offsets: bitwise ``whole``'s block (``k345_whole``), and the plain
    versions at the same offsets within the phase 4 tolerance (their
    backward fed the kernels' lse and delta)."""
    from emg_tpu_torch.ops import flash_attention as fa

    args = (*(t[b, h].contiguous() for t in (q, k, v)), used[h].contiguous(), oob,
            kp[b].contiguous())
    o, lse = fa.flash_train_fwd(*args, rate, seed, b.start, h.start)
    delta = (dout[b, h].float() * o).sum(-1)
    bwd = (*args, dout[b, h].contiguous(), lse, delta, rate, seed, b.start, h.start)
    dq, d_used = fa.flash_train_bwd_dq(*bwd)
    block = (o, lse, dq, *fa.flash_train_bwd_dkv(*bwd))
    plain_dq, plain_d_used = fa.flash_train_bwd_dq_plain(*bwd)
    plain = (fa.flash_train_fwd_plain(*args, rate, seed, b.start, h.start)[0], None, plain_dq,
             *fa.flash_train_bwd_dkv_plain(*bwd))
    names = ("o", "lse", "dq", "dk", "dv")
    vs_plain = {n: rel_err(x, p) for n, x, p in zip(names, block, plain) if p is not None}
    vs_plain["d_used"] = rel_err(d_used, plain_d_used)
    return dict(B=int(q.shape[0]), H=int(q.shape[1]), T=int(q.shape[2]),
                dtype=str(q.dtype).split(".")[-1], rows=[b.start, b.stop], heads=[h.start, h.stop],
                block_bitwise={n: torch.equal(x, w[b, h]) for n, x, w in zip(names, block, whole)},
                vs_plain=vs_plain)


def k345_whole(q, k, v, used, oob, kp, dout, rate, seed):
    """o, lse, dq, dk, dv of one K3-K5 launch over the whole inputs."""
    from emg_tpu_torch.ops import flash_attention as fa

    o, lse = fa.flash_train_fwd(q, k, v, used, oob, kp, rate, seed)
    delta = (dout.float() * o).sum(-1)
    bwd = (q, k, v, used, oob, kp, dout, lse, delta, rate, seed)
    return (o, lse, fa.flash_train_bwd_dq(*bwd)[0], *fa.flash_train_bwd_dkv(*bwd))


def k345_failed(rows) -> list:
    return [r for r in rows if not all(r["block_bitwise"].values())
            or max(r["vs_plain"].values()) > TRAIN_ATTN_TOL[getattr(torch, r["dtype"])]]


def k345_at_offsets(record) -> dict:
    """K3-K5 on a block of a batch (batch rows 2-3, heads 4-7 of B=4, H=8,
    T=256, Dh=96, dropout 0.2), float32 and bfloat16, at its offsets
    (2, 4), by ``k345_block``."""
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        g = torch.Generator(device=DEVICE).manual_seed(0)
        B, H, T, Dh, rate = 4, 8, 256, 96, 0.2
        q, k, v, dout = (torch.randn(B, H, T, Dh, generator=g, device=DEVICE).to(dtype)
                         for _ in range(4))
        used = (torch.randn(H, 2 * T - 1, Dh, generator=g, device=DEVICE) * 0.1).to(dtype)
        oob = torch.zeros(2 * T - 1, device=DEVICE)
        kp = torch.zeros(B, T, dtype=torch.bool, device=DEVICE)
        kp[3, 200:] = True
        seed = torch.tensor([987], dtype=torch.int32, device=DEVICE)
        inputs = (q, k, v, used, oob, kp, dout, rate, seed)
        rows.append(k345_block(*inputs, slice(2, 4), slice(4, 8), k345_whole(*inputs)))
    record["k345_offsets"] = rows
    log(f"K3-K5 at batch and head offsets {json.dumps(rows)}")
    if k345_failed(rows):
        raise AssertionError(f"K3-K5 at offsets: {k345_failed(rows)}")
    return rows


def recording_launches(sink: list):
    """Patch the encoder's training attention to keep each call's inputs
    as the kernels get them: q's shape and dtype, the rate, the batch and
    head offsets, and the relative window's mask, the key padding and the
    seed tensors. The call itself is unchanged."""
    from emg_tpu_torch.models import attention as attention_module

    real = attention_module.flash_attention_relpos_train

    def record(q, k, v, used, oob, kp, rate, seed, b_off=0, h_off=0):
        sink.append(dict(shape=tuple(q.shape), dtype=str(q.dtype).split(".")[-1],
                         rate=float(rate), b_off=int(b_off), h_off=int(h_off), oob=oob, kp=kp,
                         seed=seed))
        return real(q, k, v, used, oob, kp, rate, seed, b_off, h_off)
    return mock.patch.object(attention_module, "flash_attention_relpos_train", record)


def distinct_launches(calls: list) -> list:
    """One of each distinct set of inputs (the seed aside; every encoder
    layer of a step gives the same), its tensors on the host."""
    seen = {}
    for c in calls:
        key = (c["shape"], c["dtype"], c["rate"], c["b_off"], c["h_off"],
               c["oob"].cpu().numpy().tobytes(), c["kp"].cpu().numpy().tobytes())
        seen.setdefault(key, {**c, **{n: c[n].cpu() for n in ("oob", "kp", "seed")}})
    return list(seen.values())


def k345_at_mesh_launches(out, geometries, world, record) -> list:
    """K3-K5 at the shapes, offsets, key padding and relative window that
    the ranks of each geometry launched them with (``recording_launches``):
    the whole (data x B, model x H) launch, every rank's key padding in its
    rows, and each rank's block of it at its offsets, by ``k345_block``
    (fresh q, k, v, dout and table from a seeded generator)."""
    rows = []
    for name, data, model_axis, _ in geometries:
        launches = [c for r in range(world)
                    for c in torch.load(os.path.join(out, f"{name}.run0.{r}.launches.pt"))]
        B, H, T, Dh = launches[0]["shape"]
        Bg, Hg = B * data, H * model_axis
        kp = torch.zeros(Bg, T, dtype=torch.bool)
        for c in launches:
            kp[c["b_off"]: c["b_off"] + B] = c["kp"]
        for c in launches:
            if not torch.equal(kp[c["b_off"]: c["b_off"] + B], c["kp"]):
                raise AssertionError(f"{name}: the ranks' key padding disagrees")
        g = torch.Generator(device=DEVICE).manual_seed(0)
        dtype = getattr(torch, launches[0]["dtype"])
        q, k, v, dout = (torch.randn(Bg, Hg, T, Dh, generator=g, device=DEVICE).to(dtype)
                         for _ in range(4))
        used = (torch.randn(Hg, 2 * T - 1, Dh, generator=g, device=DEVICE) * 0.1).to(dtype)
        oob, seed, rate = launches[0]["oob"].to(DEVICE), launches[0]["seed"].to(DEVICE), \
            launches[0]["rate"]
        inputs = (q, k, v, used, oob, kp.to(DEVICE), dout, rate, seed)
        whole = k345_whole(*inputs)
        for c in launches:
            if (c["shape"], c["dtype"], c["rate"]) != (launches[0]["shape"], launches[0]["dtype"],
                                                      rate):
                raise AssertionError(f"{name}: the ranks launched K3-K5 at different shapes")
            row = k345_block(*inputs, slice(c["b_off"], c["b_off"] + B),
                             slice(c["h_off"], c["h_off"] + H), whole)
            rows.append(dict(row, geometry=name, offsets=[c["b_off"], c["h_off"]], rate=rate))
        del whole, inputs, q, k, v, dout
        torch.cuda.empty_cache()
    record["k345_mesh_launches"] = rows
    log(f"K3-K5 at the mesh's launches {json.dumps(rows)}")
    if k345_failed(rows):
        raise AssertionError(f"K3-K5 at the mesh's launches: {k345_failed(rows)}")
    return rows


def mesh_rank_steps(cfg_argv, pb, max_frames, out_dir, geometries, cli_argv=None, seeds=(0,),
                    patches=None):
    """A rank of a mesh (here two on card 0; one a card in
    chip_mesh_cards.py). For each seed s of ``seeds`` (run i): rank 0
    takes the single-rank step from weights drawn from s, at train seed s;
    then, for each geometry, every rank takes the sharded step from the
    same weights and seed (K3-K5 counted over it alone, and its launches'
    inputs kept), then, after a barrier that follows rank 0's check, a
    second (warm) one for its CUDA-event time; rank 0 holds the first's
    gathered gradients against the single-rank step's. Each rank writes
    ``{geometry}.run{i}.{rank}`` files (a JSON, its BatchNorm statistics,
    its K3-K5 launches) to ``out_dir``. A geometry's steps run under
    ``patches[name]()`` where given (a mutation check's context). Then,
    with ``cli_argv``, the ranks run the CLI's train mode on it, as ranks
    that torchrun or a coordinator started do (``cli.main`` joins their
    process group), with the kernels counted over that run alone."""
    import torch.distributed as dist

    from emg_tpu_torch.config import Config
    from emg_tpu_torch.models.model import EMGModel
    from emg_tpu_torch.parallel.distributed import rank_device
    from emg_tpu_torch.parallel.mesh import Mesh, MeshShape, gather_full, shard_params
    from emg_tpu_torch.parallel.train_step import make_train_step
    from emg_tpu_torch.train.state import create_train_state

    rank, device = dist.get_rank(), rank_device(DEVICE)
    counters = kernel_counters()
    # a process's first optimizer imports torch's compiler stack (~10 s on
    # the card's host): every rank pays it here, side by side, not while
    # another rank waits for it in a collective
    torch.optim.AdamW([torch.nn.Parameter(torch.zeros(1, device=device))])
    for run, seed in enumerate(seeds):
        # host-clock marks (seconds since the epoch, one clock for all ranks)
        timeline = {"start": time.time()}
        cfg = Config.from_args(cfg_argv + ["--seed", str(seed)])
        step = make_train_step(cfg.train)
        # the seeded weights, drawn once; each step starts from a copy
        t0 = time.perf_counter()
        base = EMGModel(cfg.model, device=device, generator=torch.Generator().manual_seed(seed))
        init_s = time.perf_counter() - t0
        timeline["base_built"] = time.time()

        def fresh_state(mesh=None, seq=False):
            model = copy.deepcopy(base)
            if mesh is not None:
                shard_params(model, mesh, sequence_shard=seq)
            return create_train_state(model, cfg.train)

        def timed_step(state, mark=None):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            if mark:
                timeline[mark] = time.time()
            t0 = time.perf_counter()
            start.record()
            metrics = step(state, pb, max_frames, torch.Generator(device=device))
            end.record()
            torch.cuda.synchronize()
            return metrics, start.elapsed_time(end), (time.perf_counter() - t0) * 1e3

        ref = None
        if rank == 0:
            state = fresh_state()
            metrics, ms, _ = timed_step(state)
            ref = dict(loss=float(metrics["loss"]), ms=ms,
                       grads={n: p.grad.detach().clone() for n, p in state.model.named_parameters()})
            del state
        timeline["reference_done"] = time.time()
        for name, data, model_axis, seq in geometries:
            tag = os.path.join(out_dir, f"{name}.run{run}.{rank}")
            mesh = Mesh(MeshShape(data, model_axis), device)
            timeline[f"{name}_mesh_built"] = time.time()
            state = fresh_state(mesh, seq)
            for fn in counters.values():
                fn.launches = 0
            calls = []
            with (patches or {}).get(name, contextlib.nullcontext)(), recording_launches(calls):
                metrics, ms, wall = timed_step(state, f"{name}_step_start")
            timeline[f"{name}_step_end"] = time.time()
            launches = {k: fn.launches for k, fn in counters.items()}
            torch.save(distinct_launches(calls), f"{tag}.launches.pt")
            del calls
            row = dict(rank=rank, seed=seed, loss=float(metrics["loss"]), launches=launches,
                       step_ms=ms, step_wall_ms=wall,
                       heads_a_rank=cfg.model.n_heads_encoder // model_axis,
                       model_init_s=init_s, timeline=dict(timeline))
            # the first step's gradients, whole (a collective), before the
            # warm step adds into them
            grads = {n: gather_full(n, p.grad.detach(), mesh) for n, p in
                     state.model.named_parameters()}
            if ref is not None:
                largest = max(float(g.abs().max()) for g in ref["grads"].values())
                norm_err, worst, noise = grad_errors(grads, ref["grads"], largest)
                row.update(single_rank_loss=ref["loss"], single_rank_step_ms=ref["ms"],
                           loss_rel_err=abs(row["loss"] - ref["loss"]) / abs(ref["loss"]),
                           grad_norm_rel_err=norm_err, worst_grad_rel_err=worst,
                           bn_fed_bias_err_of_largest=noise)
            del grads
            dist.barrier()  # every rank starts the warm step together
            with (patches or {}).get(name, contextlib.nullcontext)():
                _, row["warm_step_ms"], row["warm_step_wall_ms"] = timed_step(state)
            torch.save({n: b.detach().cpu() for n, b in state.model.named_buffers()
                        if n.endswith(("running_mean", "running_var"))}, f"{tag}.stats.pt")
            with open(f"{tag}.json", "w") as f:
                json.dump(row, f)
            del state
            torch.cuda.empty_cache()
        del base, ref
        torch.cuda.empty_cache()
    if cli_argv is None:
        return

    from emg_tpu_torch import cli

    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    cli.main(cli_argv)
    epoch = dict(wall_s=time.perf_counter() - t0,
                 launches={k: fn.launches for k, fn in counters.items()})
    with open(os.path.join(out_dir, f"cli.{rank}.json"), "w") as f:
        json.dump(epoch, f)


def mesh_geometry_result(out, name, world, layers, run=0):
    """What the ranks of one geometry wrote for run ``run``, and the list
    of its failures against phase 8's bounds: the loss, the whole gradient
    and each parameter's against the single-rank step, the ranks' losses
    and BatchNorm statistics alike, K3-K5 launched once an encoder layer."""
    ranks = []
    for r in range(world):
        with open(os.path.join(out, f"{name}.run{run}.{r}.json")) as f:
            ranks.append(json.load(f))
    stats = [torch.load(os.path.join(out, f"{name}.run{run}.{r}.stats.pt")) for r in range(world)]
    equal_stats = all(torch.equal(st[k], stats[0][k]) for st in stats[1:] for k in st)
    result = dict(ranks=ranks, bn_stats_equal_on_ranks=equal_stats)
    head, failures = ranks[0], []
    if not (head["loss_rel_err"] <= STEP_LOSS_RTOL and head["grad_norm_rel_err"] <= STEP_NORM_TOL
            and max(head["worst_grad_rel_err"].values()) <= STEP_GRAD_TOL
            and head["bn_fed_bias_err_of_largest"] <= STEP_NOISE_TOL):
        failures.append(f"{name}: the sharded step differs from the single-rank step")
    if any(abs(r["loss"] - head["loss"]) > STEP_LOSS_RTOL * abs(head["loss"]) for r in ranks):
        failures.append(f"{name}: the ranks report different losses")
    if not equal_stats:
        failures.append(f"{name}: BatchNorm statistics differ between the ranks")
    for r in ranks:
        for k in ("flash_train_fwd", "flash_train_bwd_dq", "flash_train_bwd_dkv"):
            if r["launches"][k] != layers:
                failures.append(f"{name}: rank {r['rank']} launched {k} "
                                f"{r['launches'][k]} times, not {layers}")
    return result, failures


def mesh_steps(argv, root, record, geometries=MESH_GEOMETRIES, share_card=True,
               mesh_flags=("--parallel.data_axis", "2"), cli_epoch=True) -> dict:
    """The sharded steps of ``mesh_rank_steps`` (by default on two ranks
    sharing card 0; else one rank a card over NCCL), then K3-K5 at the
    inputs they launched with (``k345_at_mesh_launches``); with
    ``cli_epoch`` the ranks then run the CLI epoch that ``mesh_cli_epoch``
    checks. The steps are checked here from what the ranks wrote."""
    from emg_tpu_torch.config import Config
    from emg_tpu_torch.parallel.distributed import launch

    cfg_argv = argv + TRAIN_ARGS + ["--batch_size_grad", str(10 ** 9)]
    cfg = Config.from_args(cfg_argv)
    data = max(g[1] for g in geometries)
    idxs, pb, max_frames = largest_batch(cfg, multiple=data)
    out = os.path.join(root, "mesh_steps")
    os.makedirs(out, exist_ok=True)
    torch.cuda.empty_cache()
    world = geometries[0][1] * geometries[0][2]
    cli_argv = argv + MESH_EPOCH_ARGS + list(mesh_flags) + [
        "--device", DEVICE, "--output_directory", os.path.join(root, "mesh_train")]
    t0 = time.perf_counter()
    launch(mesh_rank_steps, (cfg_argv, pb, max_frames, out, geometries,
                             cli_argv if cli_epoch else None), world, DEVICE,
           share_card=share_card)
    result = dict(examples=len(idxs), max_frames=max_frames, rows=int(pb.packed_raw.shape[0]),
                  utterances=int(pb.lengths.shape[0]), launch_s=time.perf_counter() - t0,
                  geometries={})
    failures = []
    for name, *_ in geometries:
        result["geometries"][name], failed = mesh_geometry_result(
            out, name, world, cfg.model.num_layers_encoder)
        failures += failed
    record["mesh_steps"] = result
    log(f"mesh steps {json.dumps(result)}")
    for name, g in result["geometries"].items():
        log(f"{name}: K3-K5 a rank {[r['launches']['flash_train_fwd'] for r in g['ranks']]}, "
            f"warm step CUDA-event ms {[round(r['warm_step_ms'], 1) for r in g['ranks']]}")
    if failures:
        raise AssertionError("; ".join(failures))
    result["k345_launches"] = k345_at_mesh_launches(out, geometries, world, record)
    return result


def mesh_cli_epoch(argv, root, record, world: int = 2, own_launch_s=None) -> dict:
    """The CLI epoch on a mesh (one epoch, by default on a 2x1 mesh of two
    ranks sharing card 0, which ran in ``mesh_rank_steps``' ranks after
    their steps; with ``own_launch_s``, the seconds of a CLI process that
    launched its own ranks, whose launches are not counted): each rank's
    kernel launches, rank 0's log and checkpoints; then the greedy path
    serving the model.pt it wrote (K1 and K2 counted over the serving
    run)."""
    from emg_tpu_torch import cli

    out = os.path.join(root, "mesh_train")
    ranks = []
    for r in range(world if own_launch_s is None else 0):
        with open(os.path.join(root, "mesh_steps", f"cli.{r}.json")) as f:
            ranks.append(json.load(f))
    latest = torch.load(os.path.join(out, "latest"), map_location="cpu", weights_only=True)
    with open(os.path.join(out, "log.txt")) as f:
        lines = f.read().splitlines()
    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    per, acc = cli.main(argv + ["--device", DEVICE, "--output_directory",
                                os.path.join(root, "mesh_eval"),
                                "--evaluate_saved_greedy_search", os.path.join(out, "model.pt")])
    logging.getLogger().handlers.clear()
    launches = {k: counters[k].launches for k in ("iir_scan", "flash_attention_relpos")}
    result = dict(cli_wall_s=own_launch_s or max(r["wall_s"] for r in ranks),
                  rank_launches=[r["launches"] for r in ranks],
                  microbatches=int(latest["microbatches"]), updates=int(latest["updates"]),
                  finished_epoch_lines=sum("finished epoch" in line for line in lines),
                  mesh_line=next((line for line in lines if "parallel mesh" in line), None),
                  served=dict(per=per, accuracy=acc, launches=launches))
    record["mesh_cli_epoch"] = result
    log(f"mesh CLI epoch {json.dumps(result)}")
    if result["finished_epoch_lines"] != 1 or not result["mesh_line"]:
        raise AssertionError(f"the mesh CLI run did not train one epoch on rank 0's log: {result}")
    if result["microbatches"] < 2 or not 0.0 <= per < float("inf") or min(launches.values()) == 0:
        raise AssertionError(f"the mesh-trained model.pt was not trained or served: {result}")
    if not all(n > 0 for r in ranks for n in r["launches"].values()):
        raise AssertionError(f"a kernel of the mesh CLI epoch was never launched: {result}")
    return result


def multi_device(argv, root, record):
    t0 = time.perf_counter()
    k345_at_offsets(record)
    steps = mesh_steps(argv, root, record)
    epoch = mesh_cli_epoch(argv, root, record)
    record["mesh_phase_s"] = time.perf_counter() - t0
    log(f"phase 12 took {record['mesh_phase_s']:.1f} s")
    summary = {name: dict(loss_rel_err=g["ranks"][0]["loss_rel_err"],
                          grad_norm_rel_err=g["ranks"][0]["grad_norm_rel_err"],
                          k3_k5_launches_a_rank=[r["launches"]["flash_train_fwd"] for r in g["ranks"]],
                          step_ms=[r["step_ms"] for r in g["ranks"]],
                          warm_step_cuda_event_ms=[r["warm_step_ms"] for r in g["ranks"]])
               for name, g in steps["geometries"].items()}
    k345 = {f"{r['geometry']}@{r['offsets']}": max(r["vs_plain"].values())
            for r in steps["k345_launches"]}
    print(json.dumps({"multi_device": dict(geometries=summary, k345_at_launches_vs_plain=k345,
                                           cli_epoch=epoch, phase_s=record["mesh_phase_s"])},
                     default=str),
          flush=True)


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
    kernel_resources(record)

    log("phase 2: kernel 1 vs plain")
    k1 = check_iir_scan(record)
    log("phase 3: kernel 2 vs plain")
    k2 = check_flash_attention(record)
    log("phase 4: kernels 3-5 vs plain")
    check_train_attention(record)

    with tempfile.TemporaryDirectory() as root:
        log("phase 5: serving path at full width")
        argv = make_corpus(root)
        ckpt = os.path.join(root, "model.pt")
        model = EMGModel(ModelConfig(), device=DEVICE, generator=torch.Generator().manual_seed(0))
        torch.save(model.state_dict(), ckpt)
        del model
        launches = serve(argv, ckpt, record)
        log("phase 6: whole path, kernels vs plain, float32")
        whole_path_kernels_vs_plain(argv, ckpt, record)
        log("phase 7: training at full width through the CLI")
        train_launches, shapes = train_through_cli(argv, root, record)
        log("phase 7: kernels 3-5 vs plain at the shapes training launched")
        k345 = check_launched_shapes(shapes, record)
        log("phase 8: one train step, kernels vs plain, float32")
        train_step_kernels_vs_plain(argv, record)
        log("phase 9: beam serving at full width")
        beam_launches = beam_serving(argv, ckpt, root, record)
        log("phase 10: the training recipes")
        recipes_phase(argv, root, record)
        log("phase 11: the beam's remainder")
        beam_remainder(argv, ckpt, root, record)
        log("phase 12: multi-device training, two ranks sharing the card")
        multi_device(argv, root, record)

    # K1 and K2 count over the greedy serving run (phase 9's JSON holds
    # their counts over the beam run), K3-K5 over the training run
    log(f"K1 and K2 launches over the beam run: {json.dumps(beam_launches)}")
    launches.update({name: train_launches[name] for name in k345})
    rows = {"iir_scan": dict(k1, library_ms=None), "flash_attention_relpos": k2, **k345}
    train_source = "emg_tpu_torch/ops/csrc/flash_attention_relpos_train.cu"
    bwd_source = "emg_tpu_torch/ops/csrc/flash_bwd_relpos.cuh"
    kernels = []
    for name, source, replaces in (
        ("iir_scan", "emg_tpu_torch/ops/csrc/iir_scan.cu", "emg_tpu/ops/pallas/iir_scan.py:96"),
        ("flash_attention_relpos", "emg_tpu_torch/ops/csrc/flash_attention_relpos.cu",
         "emg_tpu/ops/pallas/flash_attention.py:125"),
        ("flash_train_fwd", train_source, "emg_tpu/ops/pallas/flash_attention.py:468"),
        ("flash_train_bwd_dq", bwd_source, "emg_tpu/ops/pallas/flash_attention.py:525"),
        ("flash_train_bwd_dkv", bwd_source, "emg_tpu/ops/pallas/flash_attention.py:567"),
    ):
        row = rows[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row.get("library_ms"),
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
