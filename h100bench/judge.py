"""The comparison that decides ``correct``: the program's readings against
the reference's, each number with its limit (``limits/<workload>.json``).

Training (a step is one accumulation window, up to an optimizer apply):

- ``loss_gap``: the largest relative gap of a microbatch's loss over the
  first steps;
- ``grad1_gap``: over the leaves, the largest gap between the program's
  and the reference's norm of the first step's gradient (the program's as
  its AdamW holds it after one step: exp_avg / (1 - beta1)), over the
  reference's norm of that leaf or of the median leaf, whichever is larger;
- ``delta_gap``: the same for the norm of each leaf's change over the
  steps, leaving out leaves whose first reference gradient is under a
  thousandth of the median leaf's (moved by round-off alone under AdamW).
"""

from __future__ import annotations

import json
import statistics
from pathlib import Path
from typing import Dict, List

HERE = Path(__file__).resolve().parent
MOVED_SHARE = 1e-3  # a leaf's gradient under this share of the median leaf's has not moved


def load_limits(workload: str, home: Path = HERE) -> Dict[str, float]:
    path = home / "limits" / f"{workload}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no limits for {workload!r} ({path})")
    return {k: float(v) for k, v in json.loads(path.read_text())["limits"].items()}


def _leaf_gap(prog: Dict[str, float], ref: Dict[str, float], names: List[str]) -> float:
    med = statistics.median(ref[k] for k in names)
    return max(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in names)


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    if len(prog["losses"]) != len(ref["losses"]):
        return {"loss_gap": float("inf"), "grad1_gap": float("inf"), "delta_gap": float("inf")}
    loss_gap = max(abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog["losses"], ref["losses"]))
    names = sorted(ref["grad1"])
    if sorted(prog["grad1"]) != names:
        raise KeyError("the program's parameters are not the reference's")
    med = statistics.median(ref["grad1"][k] for k in names)
    moved = [k for k in names if ref["grad1"][k] >= MOVED_SHARE * med]
    return {"loss_gap": loss_gap, "grad1_gap": _leaf_gap(prog["grad1"], ref["grad1"], names),
            "delta_gap": _leaf_gap(prog["delta"], ref["delta"], moved)}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]):
    """(correct, {name: {"value", "limit"}}): correct when every number is
    finite and at most its limit."""
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    ok = all(v["value"] <= v["limit"] for v in checks.values())  # NaN compares False
    return ok, checks
