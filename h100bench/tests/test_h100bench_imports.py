"""Nothing the benchmark loads is JAX, jaxlib, flax or the JAX package, by
whole top-level names; the reference loads nothing of the program."""

import subprocess
import sys

from h100bench import run
from h100bench.tests.conftest import ROOT


def test_forbidden_names_compare_whole():
    assert run.forbidden_modules(["emg_tpu_torch", "emg_tpu_torch.ops", "jaxtyping",
                                  "flaxen.x"]) == []
    assert run.forbidden_modules(["emg_tpu.models", "jax.numpy", "jaxlib", "flax"]) == [
        "emg_tpu", "flax", "jax", "jaxlib"]


def test_a_tiny_run_loads_no_jax(tmp_path):
    code = (
        "import sys; sys.path.insert(0, %r); sys.path.insert(0, %r)\n"
        "from conftest import tiny_home\n"
        "from pathlib import Path\n"
        "from h100bench import run\n"
        "home, bench = tiny_home(Path(%r))\n"
        "r = run.run_cell(bench, 'tiny_tf_train', 5, 0.3, True, device='cpu', home=home)\n"
        "print('FOUND', run.forbidden_modules())\n"
    ) % (str(ROOT), str(ROOT / "h100bench" / "tests"), str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FOUND []" in out.stdout


def test_reference_loads_nothing_of_the_program():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import h100bench.reference.model, h100bench.reference.train\n"
        "import h100bench.reference.dsp, h100bench.reference.batching\n"
        "import h100bench.reference.weights\n"
        "print(sorted({m.split('.')[0] for m in sys.modules if m.split('.')[0] in "
        "('emg_tpu_torch', 'emg_tpu', 'jax', 'jaxlib', 'flax')}))\n"
    ) % str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip() == "[]"
