#!/usr/bin/env python3
"""The readings that the limits of a training cell are set from, on the card
at the cell's own size, several seeds in one process (the benchmark's runs
do not run this):

- ``program``: the program's first steps (the set-up's windows) against the
  float32 reference;
- ``control``: the reference computed with float8 e4m3 operands in the
  program's place, against the float32 reference;
- ``fault:unchanged``: the program with AdamW's step doing nothing (a step
  that returns its state unchanged);
- ``fault:half_batch``: the program with the losses taken over the first
  half of each batch's examples.

    python3 h100bench/control.py --workload train_tf_bf16 --seeds 1 2 3 \\
        [--what program control fault:unchanged fault:half_batch]

Prints one JSON line a seed and reading.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from h100bench import judge  # noqa: E402
from h100bench.run import Cell, HERE, load_benchmark, load_module  # noqa: E402

WHAT = ("program", "control", "fault:unchanged", "fault:half_batch")


@contextlib.contextmanager
def fault(name: str):
    """The program's timed path broken underneath while the block runs."""
    if name == "fault:unchanged":
        import torch

        step = torch.optim.AdamW.step
        torch.optim.AdamW.step = lambda self, *a, **k: None
        try:
            yield
        finally:
            torch.optim.AdamW.step = step
        return
    if name == "fault:half_batch":
        import torch

        from emg_tpu_torch.parallel import train_step

        original = train_step.device_batch

        def halved(tensors, host):
            dev = original(tensors, host)
            n = torch.div(dev["n_examples"], 2, rounding_mode="floor").clamp(min=1)
            rows = torch.arange(dev["targets"].shape[0], device=n.device)[:, None] < n
            dev["n_examples"] = n
            dev["n_tokens"] = ((dev["targets"][:, 1:] != 42) & rows).sum()
            return dev

        train_step.device_batch = halved
        try:
            yield
        finally:
            train_step.device_batch = original
        return
    yield


def readings(bench, workload: str, seed: int, what, device="cuda", home: Path = HERE):
    cell = Cell(bench, workload, seed, 0.0, False, device, home)
    cells = load_module("cells", cell.traffic["kind"], home)
    out = {}
    ref = None
    for name in what:
        if name == "control":
            continue
        with fault(name):
            utts, weight_seed, loop = cells.build(cell)
            prog = cells.program_readings(loop, cells.CHECK_STEPS)
        del loop
        cell.free()
        if ref is None:
            ref = cells.reference(cell, utts, weight_seed)
            cell.free()  # the reference's cached blocks, before the next capture
        out[name] = judge.train_numbers(prog, ref)
    if "control" in what:
        utts, weight_seed = cells.inputs_of(cell)
        if ref is None:
            ref = cells.reference(cell, utts, weight_seed)
        out["control"] = judge.train_numbers(cells.reference(cell, utts, weight_seed, "fp8"), ref)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--what", nargs="+", default=list(WHAT), choices=WHAT)
    args = p.parse_args(argv)
    bench = load_benchmark()
    limits = judge.load_limits(args.workload)
    for seed in args.seeds:
        for name, numbers in readings(bench, args.workload, seed, args.what).items():
            ok, _ = judge.verdict(numbers, limits)
            print(json.dumps({"workload": args.workload, "seed": seed, "what": name,
                              "numbers": numbers, "correct_under_limits": ok}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
