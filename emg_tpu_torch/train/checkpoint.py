"""Checkpoints: the full train state for resume, and weights for serving.

Counterpart of ``emg_tpu/train/checkpoint.py``, with ``torch.save`` in
place of orbax:

- ``latest``: the full train state (model state dict, AdamW state, the
  accumulated gradients, the counters) and an ``extra`` dict (epoch, best
  PER), for ``--resume``;
- ``model.pt``: a weights-only state dict in the reference's key names
  (the reference's own model.pt), which ``--evaluate_saved_greedy_search``
  and ``--start_training_from`` load.

Files are written to a temporary name and renamed, so a run cut short
leaves the previous checkpoint whole.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import torch

from emg_tpu_torch.train.state import TrainState


def load_weights(path: str) -> Dict[str, torch.Tensor]:
    """A weights-only state dict (model.pt, or a reference ``.pt`` saved
    from a DataParallel model), on the CPU, without the ``module.``
    prefix."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k[len("module."):] if k.startswith("module.") else k: v for k, v in sd.items()}


def merge_params(model: torch.nn.Module, loaded: Dict[str, torch.Tensor]) -> int:
    """strict=False warm start: copy each loaded tensor whose name and
    shape match the model's state dict. Returns the number copied."""
    own = model.state_dict()
    matched = {k: v for k, v in loaded.items() if k in own and own[k].shape == v.shape}
    model.load_state_dict(matched, strict=False)
    return len(matched)


class CheckpointManager:
    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, name: str) -> str:
        return os.path.join(self.directory, name)

    def _save(self, obj, name: str) -> None:
        tmp = self._path(name + ".tmp")
        torch.save(obj, tmp)
        os.replace(tmp, self._path(name))

    def save(self, state: TrainState, name: str = "latest", extra: Optional[dict] = None):
        self._save({
            "model": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "accum_grads": {k: g.detach().clone() for k, g in state.accum_grads().items()},
            "accum_examples": state.accum_examples,
            "microbatches": state.microbatches,
            "updates": state.updates,
            "extra": dict(extra or {}),
        }, name)

    def save_params(self, model: torch.nn.Module, name: str = "model.pt"):
        """Weights-only checkpoint in the reference's key names."""
        self._save(model.state_dict(), name)

    def restore(self, state: TrainState, name: str = "latest") -> Tuple[TrainState, dict]:
        """Restore into an existing (template) state; returns (state, extra)."""
        tree = torch.load(self._path(name), map_location="cpu", weights_only=True)
        state.model.load_state_dict(tree["model"], strict=True)
        state.optimizer.load_state_dict(tree["optimizer"])
        for k, p in state.model.named_parameters():
            p.grad.copy_(tree["accum_grads"][k])
        state.accum_examples = int(tree["accum_examples"])
        state.microbatches = int(tree["microbatches"])
        state.updates = int(tree["updates"])
        return state, tree["extra"]

    def exists(self, name: str) -> bool:
        return os.path.exists(self._path(name))
