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

On a device mesh (``CheckpointManager(directory, mesh)``) every rank takes
part in gathering the sharded tensors (parameters, gradient sums, AdamW's
moments) and rank 0 alone writes them whole: the files are those one
device would write, so a mesh-trained ``model.pt`` serves as it is and a
``latest`` resumes on any mesh, or none; ``restore`` cuts each tensor to
the rank's block.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import torch

from emg_tpu_torch.parallel.distributed import is_primary
from emg_tpu_torch.parallel.mesh import full_state_dict, gather_full, local_block
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


def _optimizer_state(state: TrainState, mesh) -> dict:
    """AdamW's state dict with every moment whole (gathered on a mesh)."""
    sd = state.optimizer.state_dict()
    if mesh is None:
        return sd
    names = [n for n, _ in state.model.named_parameters()]
    sd["state"] = {i: {k: (gather_full(names[i], v, mesh) if k != "step" else v)
                       for k, v in entry.items()}
                   for i, entry in sd["state"].items()}
    return sd


class CheckpointManager:
    def __init__(self, directory: str, mesh=None):
        self.directory = os.path.abspath(directory)
        self.mesh = mesh
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, name: str) -> str:
        return os.path.join(self.directory, name)

    def _save(self, obj, name: str) -> None:
        tmp = self._path(name + ".tmp")
        torch.save(obj, tmp)
        os.replace(tmp, self._path(name))

    def _model_state(self, model: torch.nn.Module) -> Dict[str, torch.Tensor]:
        return model.state_dict() if self.mesh is None else full_state_dict(model, self.mesh)

    def save(self, state: TrainState, name: str = "latest", extra: Optional[dict] = None):
        tree = {
            "model": self._model_state(state.model),
            "optimizer": _optimizer_state(state, self.mesh),
            "accum_grads": {k: gather_full(k, g.detach(), self.mesh).clone()
                            for k, g in state.accum_grads().items()},
            "accum_examples": state.accum_examples,
            "microbatches": state.microbatches,
            "updates": state.updates,
            "extra": dict(extra or {}),
        }
        if is_primary():
            self._save(tree, name)

    def save_params(self, model: torch.nn.Module, name: str = "model.pt"):
        """Weights-only checkpoint in the reference's key names."""
        weights = self._model_state(model)
        if is_primary():
            self._save(weights, name)

    def restore(self, state: TrainState, name: str = "latest") -> Tuple[TrainState, dict]:
        """Restore into an existing (template) state; returns (state, extra)."""
        tree = torch.load(self._path(name), map_location="cpu", weights_only=True)
        mesh = self.mesh
        state.model.load_state_dict({k: local_block(k, v, mesh) for k, v in tree["model"].items()},
                                    strict=True)
        names = [n for n, _ in state.model.named_parameters()]
        opt = tree["optimizer"]
        opt["state"] = {i: {k: (local_block(names[i], v, mesh) if k != "step" else v)
                            for k, v in entry.items()} for i, entry in opt["state"].items()}
        state.optimizer.load_state_dict(opt)
        for k, p in state.model.named_parameters():
            p.grad.copy_(local_block(k, tree["accum_grads"][k], mesh))
        state.accum_examples = int(tree["accum_examples"])
        state.microbatches = int(tree["microbatches"])
        state.updates = int(tree["updates"])
        return state, tree["extra"]

    def exists(self, name: str) -> bool:
        return os.path.exists(self._path(name))
