"""The weights of a run, made by the benchmark from the seed on the device:
one ``randn`` over every normal-initialised parameter from one CUDA
``torch.Generator`` (a CPU one where the device is the CPU), sliced and
scaled per parameter; norms start at one and biases at zero. The program
and the reference are both handed these."""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch


def make_weights(spec: List[Tuple[str, tuple, object]], seed: int,
                 device) -> Dict[str, torch.Tensor]:
    device = torch.device(device)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    n = sum(math.prod(shape) for _, shape, init in spec if not isinstance(init, str))
    flat = torch.randn(n, generator=g, device=device)
    out, at = {}, 0
    for name, shape, init in spec:
        if init == "one":
            out[name] = torch.ones(shape, device=device)
        elif init == "zero":
            out[name] = torch.zeros(shape, device=device)
        else:
            size = math.prod(shape)
            out[name] = flat[at: at + size].view(shape) * float(init)
            at += size
    return out
