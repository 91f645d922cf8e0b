"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points refuse to fall back to the CPU silently."""

import ast
import json
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import emg_tpu_torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "emg_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "emg_tpu")


def port_modules():
    return sorted(
        m.name for m in pkgutil.walk_packages([str(PORT)], prefix="emg_tpu_torch.")
    )


def test_import_pulls_in_no_jax():
    """In a fresh interpreter (the test process has JAX loaded already),
    importing every module of the port loads no JAX and no emg_tpu module."""
    code = (
        "import importlib, sys\n"
        f"for name in {['emg_tpu_torch', *port_modules()]!r}:\n"
        "    importlib.import_module(name)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT), env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert len(port_modules()) >= 20


BEAM_MODULES = [
    "emg_tpu_torch.decode.prefix_tree", "emg_tpu_torch.decode.ngram",
    "emg_tpu_torch.decode.lm_train", "emg_tpu_torch.decode.kenlm_binary",
    "emg_tpu_torch.decode.lm_binding", "emg_tpu_torch.decode.device_lm",
    "emg_tpu_torch.decode.device_beam", "emg_tpu_torch.decode.beam",
    "emg_tpu_torch.text.lexicon", "emg_tpu_torch.utils.serving",
]


@pytest.fixture(scope="module")
def beam_imports():
    """A fresh interpreter imports the beam path's modules one after
    another; after each, the JAX or emg_tpu modules loaded so far."""
    code = (
        "import importlib, json, sys\n"
        "out = {}\n"
        f"for name in {BEAM_MODULES!r}:\n"
        "    importlib.import_module(name)\n"
        f"    out[name] = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(json.dumps(out))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT), env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("name", BEAM_MODULES)
def test_beam_modules_import_no_jax(beam_imports, name):
    assert name in port_modules()
    assert beam_imports[name] == []


CAPTURE_MODULES = [
    "emg_tpu_torch.collect", "emg_tpu_torch.collect.board", "emg_tpu_torch.collect.book",
    "emg_tpu_torch.collect.recorder", "emg_tpu_torch.collect.session",
    "emg_tpu_torch.collect.denoise", "emg_tpu_torch.utils", "emg_tpu_torch.utils.profiling",
    "emg_tpu_torch.data.emg_uka", "emg_tpu_torch.dsp.host_dsp", "emg_tpu_torch.dsp.audio_io",
]
# capture hardware and UI packages: imported inside the functions that use them
HARDWARE = ("brainflow", "sounddevice", "soundfile", "nltk", "matplotlib", "curses")


@pytest.fixture(scope="module")
def capture_imports():
    """A fresh interpreter imports the capture layer, the utilities and the
    adapters one after another; after each, the JAX, emg_tpu and hardware
    modules loaded so far."""
    code = (
        "import importlib, json, sys\n"
        "out = {}\n"
        f"for name in {CAPTURE_MODULES!r}:\n"
        "    importlib.import_module(name)\n"
        f"    out[name] = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN + HARDWARE!r})\n"
        "print(json.dumps(out))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT), env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("name", CAPTURE_MODULES)
def test_capture_modules_import_no_jax_or_hardware(capture_imports, name):
    assert name in port_modules()
    assert capture_imports[name] == []


def test_lm_binding_builds_under_build_only(tmp_path, monkeypatch):
    """The native ARPA scorer compiles native/ngram_lm.cc into the
    gitignored build/ tree and writes nothing into native/."""
    from emg_tpu_torch.decode import lm_binding

    native = ROOT / "native"

    def listing():
        return {p.name: p.stat().st_mtime_ns for p in native.iterdir()}

    before = listing()
    build_dir = ROOT / "build" / "emg_tpu_torch_kernels"
    assert lm_binding.library_path().parent == build_dir
    assert lm_binding.SOURCE == native / "ngram_lm.cc"
    # a fresh build into a scratch build tree
    monkeypatch.setattr(lm_binding, "BUILD_DIR", tmp_path / "build")
    built = lm_binding.build_library()
    assert built.parent == tmp_path / "build" and built.exists()
    assert sorted(p.name for p in (tmp_path / "build").iterdir()) == [built.name]
    assert listing() == before


@pytest.mark.parametrize("path", [PORT, ROOT / "chip_smoke.py", ROOT / "chip_k4_warps.py",
                                  ROOT / "chip_k1_layouts.py", ROOT / "chip_mesh_cards.py",
                                  ROOT / "chip_mesh_margin.py"],
                         ids=["package", "chip_smoke", "chip_k4_warps", "chip_k1_layouts",
                              "chip_mesh_cards", "chip_mesh_margin"])
def test_sources_import_no_jax(path):
    files = [path] if path.is_file() else sorted(path.rglob("*.py"))
    assert files
    for f in files:
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in FORBIDDEN, f"{f}: imports {name}"


def test_float32_stays_float32_on_the_card():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert emg_tpu_torch.__version__


def test_entry_points_refuse_missing_cuda(tmp_path):
    """Without a card, an entry point called without device= raises rather
    than running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal needs a machine without one")
    from emg_tpu_torch import cli
    from emg_tpu_torch.config import Config, ModelConfig
    from emg_tpu_torch.data.dataset import EMGDataset
    from emg_tpu_torch.models.model import EMGModel

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        EMGModel(ModelConfig(model_size=16, feed_forward_layer_size=16, num_layers_encoder=1,
                             num_layers_decoder=1, n_heads_encoder=2, n_heads_decoder=2))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        EMGDataset(Config(), no_testset=True, no_normalizers=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["--evaluate_saved_greedy_search", str(tmp_path / "missing.pt"),
                  "--output_directory", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["--evaluate_saved_beam_search", str(tmp_path / "missing.pt"),
                  "--output_directory", str(tmp_path)])
    from emg_tpu_torch.decode.device_lm import build_device_lm
    from emg_tpu_torch.decode.ngram import ArpaLanguageModel, write_fixture_arpa

    write_fixture_arpa(str(tmp_path / "lm.arpa"), ["the cat sat"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_device_lm(ArpaLanguageModel(str(tmp_path / "lm.arpa")), ["THE", "CAT"])
