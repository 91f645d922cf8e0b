"""A cell, its configuration, traffic mix and per-layer metric are found by
name: a test-only entry made of new files alone runs and reports."""

import json

from h100bench import run


def test_test_only_entry_is_discovered(tiny):
    home, bench = tiny
    (home / "configs" / "only_here.json").write_text(
        (home / "configs" / "tiny_tf.json").read_text())
    mix = json.loads((home / "traffic" / "tiny_train.json").read_text())
    mix["utterance"]["hum_scale"] = [5.0, 10.0]
    (home / "traffic" / "only_here_mix.json").write_text(json.dumps(mix))
    (home / "limits" / "only_here_cell.json").write_text(
        (home / "limits" / "tiny_tf_train.json").read_text())
    (home / "metrics" / "microbatches.only_here.py").write_text(
        "def read(ctx):\n    return float(ctx['microbatches'])\n")
    bench = json.loads(json.dumps(bench))
    bench["workloads"].append({"name": "only_here_cell", "config": "only_here",
                               "traffic": "only_here_mix", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "microbatches.only_here", "unit": "n", "better": "higher",
                               "source": "program_counter", "layer": "trainer and data",
                               "moves": "train_frames_per_s", "workloads": ["only_here_cell"]})
    result = run.run_cell(bench, "only_here_cell", 12, 0.5, True, device="cpu", home=home)
    assert result["metrics"]["microbatches.only_here"]["value"] >= 1
    # a metric whose workloads do not list the cell is not read there
    assert "host_batch_ms.train" not in result["metrics"]
    assert result["device"]["busy_s"] >= 0 and result["device"]["window_s"] > 0
