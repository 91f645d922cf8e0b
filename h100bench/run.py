#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` once on the card and print its result.

    python3 h100bench/run.py --workload NAME --seed N --seconds S --trace 0|1

The cell's entry names its configuration (``configs/<config>.json``) and its
traffic mix (``traffic/<traffic>.json``), whose ``kind`` names the cell's module
(``cells/<kind>.py``); each per-layer metric is read by
``metrics/<name>.py``, and the limits of the check are
``limits/<workload>.json``. With ``--trace 0`` the result carries the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics, read from the
same run with a traced segment after its window. Standard error ends with
each number the check compared beside its limit.

Exits non-zero, printing no result, without a CUDA card (or fewer than the
cell asks for), without the program, or when JAX, flax or the JAX package
are loaded in the process once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
HERE = ROOT / "h100bench"
# every kernel cache of the run at a fixed path inside the checkout
CACHE = ROOT / "build" / "h100bench_cache"
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "emg_tpu")


def load_benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def load_module(kind: str, name: str, home: Path = HERE):
    """``<home>/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = home / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file for {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(f"h100bench_{kind}_{name.replace('.', '_')}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name is JAX's, jaxlib's, flax's or the
    JAX package's, compared whole."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names if m.split(".")[0] in FORBIDDEN})


class Cell:
    """One run's view of its cell: names, files, seed and the device."""

    def __init__(self, bench: dict, workload: str, seed: int, seconds: float, trace: bool,
                 device: str = "cuda", home: Path = HERE):
        entries = {w["name"]: w for w in bench["workloads"]}
        if workload not in entries:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        self.entry = entries[workload]
        self.name = workload
        self.home = home
        self.config = json.loads((home / "configs" / f"{self.entry['config']}.json").read_text())
        self.traffic = json.loads((home / "traffic" / f"{self.entry['traffic']}.json").read_text())
        self.seed, self.seconds, self.trace = int(seed), float(seconds), bool(trace)
        import torch

        self.torch = torch
        self.device = torch.device(device)
        self.window_start = None

    @property
    def cuda(self) -> bool:
        return self.device.type == "cuda"

    def sync(self):
        if self.cuda:
            self.torch.cuda.synchronize(self.device)

    def memory_peak(self) -> int:
        return int(self.torch.cuda.max_memory_allocated(self.device)) if self.cuda else 0

    def reset_memory_peak(self):
        if self.cuda:
            self.torch.cuda.reset_peak_memory_stats(self.device)

    def free(self):
        gc.collect()
        if self.cuda:
            self.torch.cuda.empty_cache()

    def window_starts(self) -> float:
        """Marks the end of set-up; returns the window's start on the host clock."""
        self.sync()
        self.window_start = time.perf_counter()
        return self.window_start


def applies(metric: dict, workload: str, reported: set) -> bool:
    if "workloads" in metric:
        return workload in metric["workloads"]
    return metric["moves"] in reported if "moves" in metric else True


def run_cell(bench: dict, workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", home: Path = HERE) -> dict:
    """Run the cell and assemble its result (without printing it); ``home``
    is the folder its files are found in."""
    from h100bench import judge

    cell = Cell(bench, workload, seed, seconds, trace, device, home)
    res = load_module("cells", cell.traffic["kind"], home).run(cell)
    correct, checks = judge.verdict(res["numbers"], judge.load_limits(workload, home))
    setup_s = cell.window_start - T_START
    e2e = {**res["metrics"], "setup_s": setup_s}
    reported = {m["name"] for m in bench["end_to_end"] if applies(m, workload, set(e2e))}
    if trace:
        ctx = dict(res["context"], workload=workload)
        metrics = {}
        for m in bench["per_layer"]:
            if applies(m, workload, reported):
                value = load_module("metrics", m["name"], home).read(ctx)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in bench["end_to_end"] if m["name"] in reported}
    torch = cell.torch
    dev = {"platform": "gpu" if cell.cuda else "cpu",
           "kind": torch.cuda.get_device_name(cell.device) if cell.cuda else "cpu",
           "count": int(cell.entry["chips"]), "memory_peak_bytes": int(res["memory_peak"])}
    result = {"correct": bool(correct), "attempted": int(res["attempted"]),
              "failed": int(res["failed"]), "metrics": metrics, "device": dev}
    if trace:
        seg = res["context"]["segment"]
        dev.update(busy_s=seg.busy_s(), window_s=seg.wall_s)
        ops = sorted(seg.by_name().items(), key=lambda kv: -kv[1])[:10]
        result["breakdown"] = {"device_ops": [[k[:120], v] for k, v in ops],
                               "idle_gaps": [[k, v] for k, v in seg.idle_gaps(10)]}
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    bench = load_benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if entry is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(entry["chips"]):
        print(f"{args.workload} needs {entry['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"modules loaded that the benchmark must not load: {found}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
