"""Named training recipes.

Counterpart of ``emg_tpu/train/recipes.py``: the named runs of the
reference's logs_to_save/ (best_model, conformer_model,
Parallel_Schedule_Sampling, augmentation_with_electrode_rotation), which
exist there only as TensorBoard run directories, re-created as config
overlays. Select one with ``--recipe <name>`` on the CLI; it is applied
after the flags, so it overrides an explicit flag it sets.
"""

from __future__ import annotations

from typing import Dict

from emg_tpu_torch.config import Config

RECIPES: Dict[str, Dict[str, object]] = {
    # the published best checkpoint's configuration == the flag defaults
    "best_model": {},
    "conformer_model": {
        "model.encoder_kind": "conformer",
    },
    "Parallel_Schedule_Sampling": {
        "train.scheduled_sampling_max_prob": 0.3,
        "train.scheduled_sampling_ramp": 10000,
    },
    "augmentation_with_electrode_rotation": {
        "train.electrode_rotation_prob": 0.3,
    },
    "augmentation_channel_time_drop": {
        "train.channel_drop_prob": 0.1,
        "train.time_drop_prob": 0.3,
    },
}


def apply_recipe(cfg: Config, name: str) -> Config:
    """Apply recipe ``name`` to ``cfg`` in place and return it; an unknown
    name raises KeyError listing the options."""
    if name not in RECIPES:
        raise KeyError(f"unknown recipe '{name}'; options: {sorted(RECIPES)}")
    for key, value in RECIPES[name].items():
        cfg.override(key, value)
    return cfg
