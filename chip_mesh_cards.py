"""Train the flagship on a mesh of four H100s, one rank a card (NCCL).

    python3 chip_mesh_cards.py [--out PATH]

Run on a machine with four cards of one host. It builds the CUDA kernels,
makes chip_smoke.py's synthetic corpus and, over NCCL with one rank a
card:
  1. runs chip_smoke.py's phase 12 step check on the 2x2 and 2x2
     sequence-sharded meshes: phase 8's microbatch (float32, dropout 0.2,
     rows and utterances padded to multiples of 2) from the seeded
     flagship weights, against the single-rank step on card 0 (loss,
     whole gradient and each parameter's, as phase 8; BatchNorm statistics
     equal on every rank), with each rank's K3-K5 launches and warm step
     CUDA-event ms, and K3-K5 at the inputs the ranks launched them with;
  2. trains one epoch as a user would, `python -m emg_tpu_torch.cli ...
     --parallel.data_axis 2 --parallel.model_axis 2` in a process of its
     own, which launches its four ranks (one a card, NCCL), checks rank
     0's log and checkpoints, and serves the model.pt it wrote through
     the greedy path.
It prints the cards' names and power limits, a JSON line of the results
and {"ok": true, ...} last; a failed check, or fewer than four cards,
exits non-zero.
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

import torch

CARD_GEOMETRIES = (("2x2", 2, 2, False), ("2x2_seq", 2, 2, True))


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", help="also write every measurement to this JSON file")
    args = parser.parse_args()
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        print("chip_mesh_cards: needs four CUDA cards", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import chip_smoke
    from emg_tpu_torch.ops import build

    logging.basicConfig(level=logging.INFO, format="%(message)s")
    started = time.perf_counter()
    record = {"torch": torch.__version__, "cuda": torch.version.cuda}
    t0 = time.perf_counter()
    build.load_kernels()
    record["build_s"] = time.perf_counter() - t0
    cards = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    record["cards"] = cards
    with tempfile.TemporaryDirectory() as root:
        argv = chip_smoke.make_corpus(root)
        chip_smoke.mesh_steps(argv, root, record, geometries=CARD_GEOMETRIES, share_card=False,
                              cli_epoch=False)
        t0 = time.perf_counter()
        run = subprocess.run(
            [sys.executable, "-m", "emg_tpu_torch.cli", *argv, *chip_smoke.MESH_EPOCH_ARGS,
             "--parallel.data_axis", "2", "--parallel.model_axis", "2",
             "--output_directory", os.path.join(root, "mesh_train")],
            cwd=Path(__file__).resolve().parent, capture_output=True, text=True, timeout=900)
        if run.returncode != 0:
            raise RuntimeError(f"the CLI's mesh epoch exited {run.returncode}: "
                               f"{run.stderr[-4000:]}")
        epoch = chip_smoke.mesh_cli_epoch(argv, root, record, world=4,
                                          own_launch_s=time.perf_counter() - t0)
        if "2 data x 2 model" not in epoch["mesh_line"] or "nccl" not in epoch["mesh_line"]:
            raise AssertionError(f"rank 0's log does not name a 2x2 NCCL mesh: {epoch}")
    record["total_s"] = time.perf_counter() - started
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    steps = record["mesh_steps"]["geometries"]
    print(json.dumps({"mesh_cards": {
        name: dict(loss_rel_err=g["ranks"][0]["loss_rel_err"],
                   grad_norm_rel_err=g["ranks"][0]["grad_norm_rel_err"],
                   k3_k5_launches_a_rank=[r["launches"]["flash_train_fwd"] for r in g["ranks"]],
                   warm_step_cuda_event_ms=[r["warm_step_ms"] for r in g["ranks"]],
                   single_rank_step_ms=g["ranks"][0]["single_rank_step_ms"])
        for name, g in steps.items()}, "cli_epoch": record["mesh_cli_epoch"],
        "total_s": record["total_s"]}, default=str))
    print("\n".join(cards))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
