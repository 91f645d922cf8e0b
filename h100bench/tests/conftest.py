"""Fixtures of the benchmark's CPU tests: a folder laid out as ``h100bench/``
holding tiny copies of the cells (widths cut for the CPU). No test needs a
card: the cells run on it through ``run.py`` and ``control.py``."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "h100bench"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# the tiny cells' limits, from their CPU readings at the test's seeds (the
# program's gaps read higher at these widths than at the real ones)
TINY_LIMITS = {"tiny_tf_train": {"loss_gap": 0.0015, "grad1_gap": 0.3, "delta_gap": 0.06},
               "tiny_conformer_train": {"loss_gap": 0.0015, "grad1_gap": 0.3, "delta_gap": 0.06}}
TINY = {"model_size": 32, "feed_forward_layer_size": 64, "num_layers_encoder": 2,
        "num_layers_decoder": 2, "n_heads_encoder": 2, "n_heads_decoder": 2,
        "relative_distance": 20, "conformer_conv_kernel_size": 5}


def tiny_home(root: Path) -> Path:
    """A benchmark folder at ``root``: the real cell modules and metric readers,
    tiny configurations, a tiny mix of 24 short utterances and the
    training cells' limits, with a bench dict naming its cells."""
    home = root / "h100bench"
    for sub in ("cells", "metrics"):
        shutil.copytree(HERE / sub, home / sub)
    for sub in ("configs", "traffic", "limits"):
        (home / sub).mkdir(parents=True)
    for name, real in (("tiny_tf", "best_model"), ("tiny_conformer", "conformer_model")):
        cfg = json.loads((HERE / "configs" / f"{real}.json").read_text())
        (home / "configs" / f"{name}.json").write_text(json.dumps(dict(cfg, name=name, **TINY)))
    mix = json.loads((HERE / "traffic" / "train512.json").read_text())
    mix["utterances"] = 24
    mix["utterance"]["length_s"] = {"median": 1.5, "sigma": 0.4, "min": 1.0, "max": 3.0}
    # windows offered to the runner, as on the card (auto is off on the CPU)
    mix["train"].update(max_batch_length=6000, batch_size_grad=6, fused_window=True)
    mix["trace_windows"] = 2
    (home / "traffic" / "tiny_train.json").write_text(json.dumps(mix))

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"] = []
    for cell, cfg in (("tiny_tf_train", "tiny_tf"), ("tiny_conformer_train", "tiny_conformer")):
        bench["workloads"].append({"name": cell, "config": cfg, "traffic": "tiny_train",
                                   "chips": 1, "why": "a CPU test"})
    for cell, limits in TINY_LIMITS.items():
        (home / "limits" / f"{cell}.json").write_text(json.dumps({"limits": limits}))
    renamed = {"train_tf_bf16": "tiny_tf_train", "train_conformer_bf16": "tiny_conformer_train"}
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [renamed[w] for w in m["workloads"] if w in renamed]
    return home, bench


@pytest.fixture(scope="session")
def tiny(tmp_path_factory):
    return tiny_home(tmp_path_factory.mktemp("bench"))

