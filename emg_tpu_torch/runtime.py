"""Device selection for the port's entry points.

Every entry point (``EMGModel``, ``EMGDataset``, ``make_normalizers``, the
CLI) takes a ``device`` argument that defaults to ``"cuda"``. Without a
card they raise instead of running on the CPU: only a caller that asks for
``"cpu"`` (the tests) gets the CPU, where every kernel wrapper takes its
plain PyTorch version.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (--device cpu) to run "
            "the port's plain PyTorch path on the CPU"
        )
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


def compute_dtype(name: str) -> torch.dtype:
    if name == "bfloat16":
        return torch.bfloat16
    if name == "float32":
        return torch.float32
    raise ValueError(f"unsupported compute dtype {name!r}")
