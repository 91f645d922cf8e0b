"""Drive the PyTorch port (emg_tpu_torch) on one NVIDIA GPU, end to end.

    python3 chip_smoke.py [--out PATH]

Phases, in order; any failure exits non-zero:
  1. build the CUDA kernels from ops/csrc (one nvcc per source, in parallel)
     and print the card's name and power limit; per kernel, ptxas's
     registers and spill bytes and whether its SASS holds tensor-core
     instructions (HMMA: mma.sync, HGMMA: wgmma); the forward attention
     kernels (K2, K3) and the backward dq and dk/dv kernels (K4, K5) must;
  2. kernel 1 (iir_scan) against its plain PyTorch version on the card;
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
     taken over that run alone, and the per-utterance time of DSP, encode
     and decode;
  6. the same path in float32 with the kernels and with their plain
     versions: DSP outputs and encoder memory agree, greedy strings match;
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
     agree; its unprofiled wall time and a torch.profiler trace of it.
The second-to-last line is a JSON object with one record per kernel; the
last line is {"ok": true, "device": {...}}. ``--out`` also writes every
measurement to a JSON file.
"""

from __future__ import annotations

import argparse
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
# phase 1: what the kernels compiled to
# ---------------------------------------------------------------------------

def demangle(names):
    """C++ names of the mangled ``names``, by the toolkit's cu++filt."""
    from emg_tpu_torch.ops import build

    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cu++filt")
    return subprocess.run([tool], input="\n".join(names), capture_output=True, text=True,
                          check=True, timeout=60).stdout.splitlines()


def kernel_resources(record):
    """Per kernel of each library: ptxas's registers and spill bytes (from
    the build's log) and the tensor-core instructions in its SASS
    (cuobjdump -sass): HMMA is mma.sync, HGMMA wgmma. Fails unless every
    forward attention kernel (flash_fwd_kernel: K2 and K3) and every
    backward kernel (flash_bwd_dq_kernel: K4, flash_bwd_dkv_kernel: K5) has
    some."""
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
    for kernel in ("flash_fwd_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel"):
        found = [r for r in rows if kernel in r["kernel"]]
        if not found or not all(r.get("HMMA", 0) + r.get("HGMMA", 0) > 0 for r in found):
            raise AssertionError(f"a {kernel} holds no tensor-core instruction: {found}")


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
                b_ms, b_by = bound(16.0 * R * T, 8.0 * R * T, F32_CUDA_CORE_FLOPS)
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

    def record(q, k, v, used, oob, kp, rate, seed):
        shapes.add((q.shape[0], q.shape[2], str(q.dtype).split(".")[-1], float(rate)))
        return real(q, k, v, used, oob, kp, rate, seed)
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


def profile_step(run) -> dict:
    """One warm train step: its wall ms without the profiler (median of
    three synchronized runs) and, from a torch.profiler trace of one more,
    the card's busy ms (kernels, copies and fills, one stream), the span
    from the first device event's start to the last one's end, the share of
    the training attention kernels, and the five longest kernels. The idle
    share is read against the unprofiled wall (the profiler's host tracing
    slows the host) and against the device span."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        run()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall = float(np.median(walls))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        profiled_wall = (time.perf_counter() - t0) * 1e3
    by_name, first, last = {}, float("inf"), 0.0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
            first, last = min(first, e.time_range.start), max(last, e.time_range.end)
    if not by_name:
        raise AssertionError("the profiler saw no device work in a train step")
    busy = sum(by_name.values())
    span = (last - first) / 1e3
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


def train_step_kernels_vs_plain(argv, record):
    """One float32 train step of the flagship (dropout 0.2) from the same
    weights, batch and generator seeds, with the kernels and with their
    plain versions."""
    from emg_tpu_torch.config import Config
    from emg_tpu_torch.data.batching import FRAME_BUCKETS, bucket_up, make_packed_batch, quantize_packed_raw
    from emg_tpu_torch.data.dataset import EMGDataset
    from emg_tpu_torch.data.sampler import DynamicBatchSampler
    from emg_tpu_torch.models.model import EMGModel
    from emg_tpu_torch.ops import flash_attention as fa
    from emg_tpu_torch.parallel.train_step import make_train_step
    from emg_tpu_torch.train.state import create_train_state

    cfg = Config.from_args(argv + TRAIN_ARGS + ["--batch_size_grad", str(10 ** 9)])
    trainset = EMGDataset(cfg, device=DEVICE)
    sampler = DynamicBatchSampler(trainset, cfg.train.max_batch_length, cfg.train.n_buckets,
                                  seed=cfg.train.seed)
    idxs = max(sampler, key=len)
    batch = EMGDataset.collate_raw([trainset[i] for i in idxs])
    pb = quantize_packed_raw(make_packed_batch(batch["raw_emg"], batch["lengths"],
                                               batch["phonemes_int"], chunk=cfg.data.packed_chunk))
    max_frames = bucket_up(max(batch["lengths"]), FRAME_BUCKETS)

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

    # K1 and K2 count over the serving run, K3-K5 over the training run
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
