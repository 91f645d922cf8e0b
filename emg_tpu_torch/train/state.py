"""Training state: model (parameters + BatchNorm buffers), AdamW with
warmup, and gradient accumulation.

Counterpart of ``emg_tpu/train/state.py``, with the reference's optimizer
semantics (recognition_model.py:52-118, 293): AdamW over every parameter
(betas 0.9/0.999, eps 1e-8, weight decay 0.01 on every tensor), a linear
LR warmup over the first ``learning_rate_warmup`` *microbatches* (the
reference schedules on the per-batch counter, not the update counter), and
accumulation that sums the raw per-microbatch gradients and applies them
once the summed example count reaches ``batch_size_grad``.

The JAX package's ``fused_adamw`` is ``torch.optim.AdamW``'s update written
as one XLA pass per leaf, so the port uses ``torch.optim.AdamW`` itself. On
a CUDA device it is built ``capturable`` with its LR a device tensor, so
that a CUDA graph holds the apply (``train/window.py``) and every apply,
graphed or not, runs the same arithmetic; on the CPU it takes host floats.
The accumulated gradients live in each parameter's ``.grad``: ``backward``
adds every microbatch's gradient into it, and an apply zeroes it. Every
parameter starts with a zero ``.grad``, so AdamW updates every tensor at
every apply, as the JAX package does. The counters are host integers: the
host knows each batch's example count, so the apply decision needs no sync.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from emg_tpu_torch.config import TrainConfig


def warmup_lr(cfg: TrainConfig, microbatches: int) -> float:
    """Reference schedule_lr: the LR ramps linearly over the first
    learning_rate_warmup microbatches, then stays at learning_rate
    (float32 arithmetic, as in the JAX package)."""
    it = np.minimum(np.float32(microbatches) + np.float32(1.0),
                    np.float32(cfg.learning_rate_warmup))
    return float(it * np.float32(cfg.learning_rate) / np.float32(cfg.learning_rate_warmup))


def make_optimizer(params, cfg: TrainConfig) -> torch.optim.AdamW:
    params = list(params)
    device = params[0].device
    if device.type != "cuda":
        return torch.optim.AdamW(params, lr=cfg.learning_rate, betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=0.01)
    opt = torch.optim.AdamW(params, lr=torch.tensor(cfg.learning_rate, device=device),
                            betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01, capturable=True)

    def lr_on_device(optimizer):
        # a loaded state dict brings its LR back as saved (a CPU tensor
        # after map_location="cpu"): put it back on the card
        for group in optimizer.param_groups:
            group["lr"] = torch.as_tensor(group["lr"], dtype=torch.float32).to(device)

    opt.register_load_state_dict_post_hook(lr_on_device)
    return opt


@dataclass
class TrainState:
    model: torch.nn.Module  # parameters and BatchNorm running statistics
    optimizer: torch.optim.AdamW
    cfg: TrainConfig
    accum_examples: int = 0  # examples since the last apply
    microbatches: int = 0  # lifetime microbatch counter
    updates: int = 0  # optimizer apply count
    # the state's step graphs (``parallel/train_step.py::StepGraphs``), made
    # at its first microbatch where the step captures; None elsewhere
    step_graphs: Optional[object] = None

    def accum_grads(self):
        """The summed gradients since the last apply, by parameter name."""
        return {n: p.grad for n, p in self.model.named_parameters()}


def create_train_state(model: torch.nn.Module, cfg: TrainConfig) -> TrainState:
    for p in model.parameters():
        p.grad = torch.zeros_like(p)
    return TrainState(model=model, optimizer=make_optimizer(model.parameters(), cfg), cfg=cfg)
