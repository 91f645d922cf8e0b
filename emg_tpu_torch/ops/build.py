"""Build and load the port's CUDA kernels.

Each source under ``ops/csrc/`` has a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into its own shared library under
``build/emg_tpu_torch_kernels/`` at the root of the checkout, then loaded
with ``ctypes``. All sources compile in parallel, one ``nvcc`` each, on
first use; a library is named after a hash of its source, every header
under ``csrc/`` and the flags, so a later process reuses it and a change to
a shared header rebuilds every library. nvcc's output (ptxas's registers
and spills per kernel) is kept beside each library as ``.log``. Nothing
here runs at import time, and nothing includes PyTorch's headers, so a
build takes seconds.

A wrapper passes tensor pointers (``tensor.data_ptr()``) and PyTorch's
current stream; each C entry point returns ``cudaGetLastError()`` after its
launch, and ``check`` raises on anything but 0.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import logging
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict

log = logging.getLogger(__name__)

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "emg_tpu_torch_kernels"
SOURCES = ("iir_scan", "flash_attention_relpos", "flash_attention_relpos_train")
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# training attention: tensor pointers, (B, H, T, Dh, keep threshold),
# keep probability, the hash's (batch, head) offsets, stream
_TRAIN_FWD = [_P] * 9 + [_I] * 5 + [_F, _I, _I, _P]
_TRAIN_BWD = [_P] * 12 + [_I] * 5 + [_F, _I, _I, _P]
# argument types of every C entry point, by library
SIGNATURES = {
    "flash_attention_relpos_train": {
        "flash_train_fwd_f32": _TRAIN_FWD,
        "flash_train_fwd_bf16": _TRAIN_FWD,
        "flash_train_bwd_dq_f32": _TRAIN_BWD,
        "flash_train_bwd_dq_bf16": _TRAIN_BWD,
        "flash_train_bwd_dkv_f32": _TRAIN_BWD,
        "flash_train_bwd_dkv_bf16": _TRAIN_BWD,
    },
    "iir_scan": {
        # pointers; R, T, the layout (S, L, n, shared memory bytes), reverse; stream
        "iir_scan_f32": [_P] * 8 + [_I] * 7 + [_P],
        "iir_scan_max_active_clusters": [_I, _I, _I, _P],
    },
    "flash_attention_relpos": {
        "flash_attention_relpos_f32": [_P] * 7 + [_I] * 4 + [_P],
        "flash_attention_relpos_bf16": [_P] * 7 + [_I] * 4 + [_P],
    },
}


def nvcc_path() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = []
    if CUDA_HOME:
        candidates.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    for c in candidates:
        if os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_log(name: str) -> str:
    """nvcc's output for the library ``name`` (built by ``load_kernels``)."""
    return _library_path(name).with_suffix(".log").read_text()


@functools.lru_cache(maxsize=1)
def load_kernels() -> Dict[str, ctypes.CDLL]:
    """Compile every missing library (in parallel), load all of them, and
    declare their argument types. Raises if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    pending = {}
    for name in SOURCES:
        target = _library_path(name)
        if target.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        pending[name] = (proc, tmp, target)
    failures = []
    for name, (proc, tmp, target) in pending.items():
        out, _ = proc.communicate()
        log.info("nvcc %s:\n%s", name, out.strip())
        if proc.returncode != 0:
            os.unlink(tmp)
            failures.append(f"{name} (exit {proc.returncode}):\n{out}")
        else:
            target.with_suffix(".log").write_text(out)
            os.replace(tmp, target)
    if failures:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failures))

    libs = {}
    for name in SOURCES:
        lib = ctypes.CDLL(str(_library_path(name)))
        for fn, argtypes in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def library(name: str) -> ctypes.CDLL:
    return load_kernels()[name]


def check(name: str, code: int) -> None:
    """Raise if a launch returned a CUDA error."""
    if code != 0:
        msg = getattr(library(name), f"{name}_error_string")(code).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({code})")


def current_stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
