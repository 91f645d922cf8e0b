"""Time the attention backward's dq kernel (K4) with four- and eight-warp
blocks, on one NVIDIA GPU.

    python3 chip_k4_warps.py [--out PATH]

K4 (``emg_tpu_torch/ops/csrc/flash_bwd_relpos.cuh``) fixes its block at
build time by dtype: eight warps, the two of each 16-row group recomputing
half a key tile each, for float32, and four for bfloat16. This script
builds the training library once with four-warp blocks for both dtypes and
once with eight (``-DEMG_K4_SPLIT_F32`` / ``-DEMG_K4_SPLIT_BF16`` set to 1 or
2), prints ptxas's registers and spills of each K4 instance, and times K4
at H=8, Dh=96, dropout 0.2 over chip_smoke.py's phase-4 grid (B 1 and 8, T
128-512) and the training run's B=16 and 32 at T=384, after holding dq and
d_used against the plain version with chip_smoke.py's tolerances. One JSON
line per (warps, dtype, B, T), then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

SHAPES = [(B, T) for B in (1, 8) for T in (128, 256, 384, 512)] + [(16, 384), (32, 384)]
H, DH, RATE = 8, 96, 0.2


def inputs(gen, B, T, dtype):
    q, k, v, g = (torch.randn(B, H, T, DH, generator=gen).to("cuda", dtype) for _ in range(4))
    used = (torch.randn(H, 2 * T - 1, DH, generator=gen) * DH ** -0.5).to("cuda", dtype)
    oob = torch.zeros(2 * T - 1, device="cuda")
    kp = torch.zeros(B, T, dtype=torch.bool)
    for b in range(B):
        kp[b, T - (b * 37) % (T // 2):] = True
    return q, k, v, used, oob, kp.to("cuda"), g


def dq_resources(log: str):
    """(kernel, registers, spill store bytes, spill load bytes) of each K4
    instance in nvcc's output."""
    rows, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']*flash_bwd_dq_kernel[^']*)'", line)
        if m:
            name, spills = m.group(1), (0, 0)
        elif name and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            spills = tuple(map(int, m.groups()))
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            rows.append((name, int(m.group(1))) + spills)
            name = None
    return rows


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", help="also write the rows to this JSON file")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_k4_warps: CUDA is not available; this script runs on a GPU", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from chip_smoke import TRAIN_ATTN_TOL, rel_err, time_ms
    from emg_tpu_torch.ops import build
    from emg_tpu_torch.ops import flash_attention as fa

    flags = build.NVCC_FLAGS
    build.SOURCES = ("flash_attention_relpos_train",)
    seed = torch.tensor([20240611], dtype=torch.int32, device="cuda")
    rows = []
    for split in (1, 2):
        build.NVCC_FLAGS = flags + (f"-DEMG_K4_SPLIT_F32={split}", f"-DEMG_K4_SPLIT_BF16={split}")
        build.load_kernels.cache_clear()
        build.load_kernels()
        for name, regs, stores, loads in dq_resources(build.build_log("flash_attention_relpos_train")):
            print(json.dumps(dict(warps=4 * split, kernel=name, registers=regs,
                                  spill_store_bytes=stores, spill_load_bytes=loads)), flush=True)
        gen = torch.Generator().manual_seed(7)
        for dtype in (torch.float32, torch.bfloat16):
            for B, T in SHAPES:
                q, k, v, used, oob, kp, g = inputs(gen, B, T, dtype)
                o, lse = fa.flash_train_fwd(q, k, v, used, oob, kp, RATE, seed)
                delta = (g.float() * o).sum(-1)
                bwd = (q, k, v, used, oob, kp, g, lse, delta, RATE, seed)
                got = fa.flash_train_bwd_dq(*bwd)
                ref = fa.flash_train_bwd_dq_plain(*bwd)
                errs = [rel_err(a, b) for a, b in zip(got, ref)]
                del got, ref, o
                row = dict(warps=4 * split, dtype=str(dtype).split(".")[-1], B=B, T=T,
                           rel_err=max(errs), ms=time_ms(lambda: fa.flash_train_bwd_dq(*bwd)))
                rows.append(row)
                print(json.dumps(row), flush=True)
                if not max(errs) <= TRAIN_ATTN_TOL[dtype]:
                    raise AssertionError(f"K4 disagrees with its plain version: {row}")
                torch.cuda.empty_cache()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(dict(card=card, rows=rows), indent=1))
    print(card)


if __name__ == "__main__":
    main()
