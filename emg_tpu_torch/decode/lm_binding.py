"""ctypes binding for the native ARPA scorer (native/ngram_lm.cc).

Counterpart of ``emg_tpu/decode/lm_binding.py``. The port compiles the same
C++ source with ``g++ -O3 -std=c++17 -fPIC -shared`` on first use, into
``build/emg_tpu_torch_kernels/`` at the root of the checkout (beside the
CUDA libraries of ``ops/build.py``), and never writes into ``native/``. The
library's name carries a hash of its source, and it is written under a
temporary name and renamed into place, so concurrent first uses cannot load
a half-written file. Callers that cannot build fall back to the
pure-Python ArpaLanguageModel (``ngram.load_language_model``, which warns).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

from emg_tpu_torch.ops.build import BUILD_DIR

SOURCE = Path(__file__).resolve().parents[2] / "native" / "ngram_lm.cc"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")

_lib = None


def library_path() -> Path:
    """Where the scorer's shared library lives: under ``build/``, named
    after a hash of the source and the flags."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libngram_lm-{digest[:16]}.so"


def build_library() -> Path:
    """Compile native/ngram_lm.cc into ``library_path()`` unless it exists."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, str(SOURCE)], check=True,
                       capture_output=True, timeout=300)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def _load_lib():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build_library()))
    lib.lm_load.restype = ctypes.c_void_p
    lib.lm_load.argtypes = [ctypes.c_char_p]
    lib.lm_free.restype = None
    lib.lm_free.argtypes = [ctypes.c_void_p]
    lib.lm_order.restype = ctypes.c_int
    lib.lm_order.argtypes = [ctypes.c_void_p]
    lib.lm_score.restype = ctypes.c_double
    lib.lm_score.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
    _lib = lib
    return lib


class NativeArpaLanguageModel:
    """Same .score contract as ngram.ArpaLanguageModel, C++ inside."""

    def __init__(self, path: str):
        self._lib = _load_lib()
        self._handle = self._lib.lm_load(path.encode())
        if not self._handle:
            raise IOError(f"failed to load ARPA model: {path}")
        self.order = self._lib.lm_order(self._handle)

    def score(self, sentence: str, bos: bool = True, eos: bool = True) -> float:
        return self._lib.lm_score(self._handle, sentence.encode(), int(bos), int(eos))

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.lm_free(self._handle)
            self._handle = None

    def __del__(self):
        self.close()
