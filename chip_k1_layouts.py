"""Time the IIR scan kernel (K1) at each cluster size, on one NVIDIA GPU.

    python3 chip_k1_layouts.py [--out PATH]

K1 (``emg_tpu_torch/ops/csrc/iir_scan.cu``) spreads each row over a cluster
of S blocks, and ``layout`` in ``emg_tpu_torch/ops/iir_scan.py`` picks S
from the row length. This script builds the iir_scan library alone and, at
chip_smoke.py's phase-2 shapes, runs the kernel through its wrapper with
``layout`` replaced by each S in 1, 2, 4, 8 and 16 whose segment fits a
block's shared memory: it holds each against the plain version with
chip_smoke.py's tolerance, checks that two calls are bitwise equal, and
times it beside how many such clusters the card holds at once. One JSON
line per (R, T, reverse, S), marking the S that ``layout`` picks, then the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path
from unittest import mock

import torch

CLUSTER_SIZES = (1, 2, 4, 8, 16)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", help="also write the rows to this JSON file")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_k1_layouts: CUDA is not available; this script runs on a GPU", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from chip_smoke import K1_SHAPES, K1_TOL, time_ms
    from emg_tpu_torch.ops import build
    from emg_tpu_torch.ops import iir_scan as k1

    build.SOURCES = ("iir_scan",)
    build.load_kernels()
    gen = torch.Generator().manual_seed(1)
    rows = []
    for R, T in K1_SHAPES:
        radius = 0.8 + 0.199 * torch.rand(R, generator=gen)
        angle = 0.6 * torch.rand(R, generator=gen) - 0.3
        inputs = [radius * torch.cos(angle), radius * torch.sin(angle),
                  torch.randn(R, T, generator=gen), torch.randn(R, T, generator=gen),
                  torch.randn(R, generator=gen), torch.randn(R, generator=gen)]
        inputs = [a.to("cuda") for a in inputs]
        picked = k1.layout(R, T).S
        for reverse in (False, True):
            ref = k1.iir_scan_plain(*inputs, reverse=reverse)
            scale = max(float(r.abs().max()) for r in ref)
            for S in CLUSTER_SIZES:
                try:
                    lay = k1.segments(T, S)
                except ValueError:  # a segment past a block's shared memory
                    continue
                with mock.patch.object(k1, "layout", lambda R, T: lay):
                    got = k1.iir_scan(*inputs, reverse=reverse)
                    again = k1.iir_scan(*inputs, reverse=reverse)
                    torch.cuda.synchronize()
                    err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
                    row = dict(R=R, T=T, reverse=reverse, picked=S == picked, **lay._asdict(),
                               max_active_clusters=k1.max_active_clusters(R, lay),
                               rel_err=err / scale,
                               bitwise_repeatable=all(torch.equal(a, b) for a, b in zip(got, again)),
                               ms=time_ms(lambda: k1.iir_scan(*inputs, reverse=reverse)))
                rows.append(row)
                print(json.dumps(row), flush=True)
                if not (row["rel_err"] <= K1_TOL and row["bitwise_repeatable"]):
                    raise AssertionError(f"iir_scan is wrong at this layout: {row}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(dict(card=smi, rows=rows), indent=1))
    print(smi)


if __name__ == "__main__":
    main()
