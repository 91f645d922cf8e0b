"""Measure the margin of chip_smoke.py's sharded-step check.

    python3 chip_mesh_margin.py [--out PATH]

Run on one card. Two ranks share it over gloo, as in chip_smoke.py's
phase 12, and take phase 8's microbatch (float32, dropout 0.2) on the
2x1, 1x2 and sequence-sharded 1x2 meshes against the single-rank step,
for weight and train seeds 0, 0, 1 and 2 (seed 0 twice: two runs of the
same inputs differ only by the rounding of K4's atomic d_used sums). It
reports each check's readings beside phase 12's bounds, and the worst
over all. Then, as a mutation check, it takes the 2x1 and 1x2 steps
with K3-K5's batch and head offsets forced to 0, so that each rank
hashes its local (b, h) and draws another dropout mask than one device:
the check must fail them. It prints the card's name and power limit, a
JSON line of the readings and {"ok": true, ...} last; it exits non-zero
if a seed's sharded step fails the check or a mutant passes it.
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

import torch

SEEDS = (0, 0, 1, 2)
MUTANTS = (("2x1_offsets0", 2, 1, False), ("1x2_offsets0", 1, 2, False))


def zero_offsets():
    """K3-K5 called with batch and head offsets 0, whatever the model asks."""
    from emg_tpu_torch.models import attention as attention_module

    real = attention_module.flash_attention_relpos_train

    def local(q, k, v, used, oob, kp, rate, seed, b_off=0, h_off=0):
        return real(q, k, v, used, oob, kp, rate, seed, 0, 0)
    return mock.patch.object(attention_module, "flash_attention_relpos_train", local)


def readings(g: dict) -> dict:
    head = g["ranks"][0]
    name, worst = max(head["worst_grad_rel_err"].items(), key=lambda kv: kv[1])
    return dict(loss_rel_err=head["loss_rel_err"], grad_norm_rel_err=head["grad_norm_rel_err"],
                worst_tensor=name, worst_tensor_rel_err=worst,
                bn_fed_bias_err_of_largest=head["bn_fed_bias_err_of_largest"],
                bn_stats_equal_on_ranks=g["bn_stats_equal_on_ranks"])


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", help="also write every measurement to this JSON file")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_mesh_margin: CUDA is not available; this script runs on a GPU",
              file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import chip_smoke
    from emg_tpu_torch.config import Config
    from emg_tpu_torch.ops import build
    from emg_tpu_torch.parallel.distributed import launch

    logging.basicConfig(level=logging.INFO, format="%(message)s")
    started = time.perf_counter()
    build.load_kernels()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    geometries = chip_smoke.MESH_GEOMETRIES + MUTANTS
    record = dict(card=card, seeds=SEEDS, bounds=dict(
        loss_rel_err=chip_smoke.STEP_LOSS_RTOL, grad_norm_rel_err=chip_smoke.STEP_NORM_TOL,
        worst_tensor_rel_err=chip_smoke.STEP_GRAD_TOL,
        bn_fed_bias_err_of_largest=chip_smoke.STEP_NOISE_TOL), runs=[])
    problems = []
    with tempfile.TemporaryDirectory() as root:
        argv = chip_smoke.make_corpus(root)
        cfg_argv = argv + chip_smoke.TRAIN_ARGS + ["--batch_size_grad", str(10 ** 9)]
        cfg = Config.from_args(cfg_argv)
        _, pb, max_frames = chip_smoke.largest_batch(cfg, multiple=2)
        out = os.path.join(root, "mesh_steps")
        os.makedirs(out)
        launch(chip_smoke.mesh_rank_steps,
               (cfg_argv, pb, max_frames, out, geometries, None, SEEDS,
                {name: zero_offsets for name, *_ in MUTANTS}), 2, "cuda", share_card=True)
        for run, seed in enumerate(SEEDS):
            for name, *_ in geometries:
                g, failures = chip_smoke.mesh_geometry_result(
                    out, name, 2, cfg.model.num_layers_encoder, run)
                row = dict(run=run, seed=seed, geometry=name, **readings(g), failures=failures)
                record["runs"].append(row)
                mutant = name.endswith("_offsets0")
                if mutant and not failures:
                    problems.append(f"run {run}: the mutant {name} passed the check")
                if not mutant and failures:
                    problems.append(f"run {run}: {failures}")
    real = [r for r in record["runs"] if not r["geometry"].endswith("_offsets0")]
    mutants = [r for r in record["runs"] if r["geometry"].endswith("_offsets0")]
    keys = ("loss_rel_err", "grad_norm_rel_err", "worst_tensor_rel_err",
            "bn_fed_bias_err_of_largest")
    record["worst_of_seeds"] = {k: max(r[k] for r in real) for k in keys}
    record["least_of_mutants"] = {k: min(r[k] for r in mutants) for k in keys}
    record["total_s"] = time.perf_counter() - started
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    for r in record["runs"]:
        print(json.dumps({k: v for k, v in r.items() if k != "failures"}))
    print(card)
    print(json.dumps({"mesh_margin": dict(bounds=record["bounds"],
                                          worst_of_seeds=record["worst_of_seeds"],
                                          least_of_mutants=record["least_of_mutants"],
                                          total_s=record["total_s"])}))
    if problems:
        print("\n".join(problems), file=sys.stderr)
        sys.exit(1)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
