"""Typed configuration tree.

The same flag names and defaults as the JAX package's configuration (and,
through it, the reference CLI: recognition_model.py:25-50,
architecture.py:12-20, read_emg.py:26-30, BeamSearch.py:16-20,
data_utils.py:17), as one dataclass tree with CLI override support. Flags
that only the JAX package acts on are kept so that one command line drives
both packages; the PyTorch port reads the model, data, decode and paths
sections.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, List, Optional


@dataclass
class ModelConfig:
    # reference architecture.py:12-20
    model_size: int = 768
    feed_forward_layer_size: int = 3072
    num_layers_encoder: int = 6
    num_layers_decoder: int = 6
    n_heads_encoder: int = 8
    n_heads_decoder: int = 8
    relative_distance: int = 300
    dropout_model: float = 0.2
    dropout_pos_emb: float = 0.2
    # encoder variant: "transformer" (reference best_model) or "conformer"
    encoder_kind: str = "transformer"
    conformer_conv_kernel_size: int = 31
    # number of raw-EMG input channels
    num_channels: int = 8
    # compute dtype for the transformer stack ("bfloat16" or "float32")
    compute_dtype: str = "float32"
    # route encoder self-attention through the fused relative-position
    # attention kernel
    use_flash_attention: bool = True
    # rematerialize encoder layers on backward (training only)
    remat: bool = False
    # decoder positional encoding: "per_position" (standard sinusoidal), or
    # "reference_batch" replicating the reference's batch-axis PE indexing
    # quirk (architecture.py:126-127) for converted-checkpoint parity
    decoder_pe: str = "per_position"
    # shard the encoder stream's time dim over devices (multi-device only)
    sequence_shard: bool = False


@dataclass
class DataConfig:
    # reference read_emg.py:26-30
    remove_channels: List[int] = field(default_factory=list)
    silent_data_directories: List[str] = field(
        default_factory=lambda: ["./emg_data/silent_parallel_data"]
    )
    voiced_data_directories: List[str] = field(
        default_factory=lambda: [
            "./emg_data/voiced_parallel_data",
            "./emg_data/nonparallel_data",
        ]
    )
    testset_file: str = "testset_largedev.json"
    text_align_directory: str = "text_alignments"
    # reference data_utils.py:17
    normalizers_file: str = "normalizers.pkl"
    # raw-EMG chunk length used for fixed-length packing before the CNN
    # (reference recognition_model.py:77 uses 200*8)
    packed_chunk: int = 1600
    # host-RAM budget for the dataset's loaded-example LRU cache, in bytes;
    # 0 disables caching
    cache_bytes: int = 2 << 30
    # DSP execution path ("auto" / "device" / "scipy"), as the JAX
    # package's: "device" the pipeline on the dataset's device, "scipy" the
    # host front-end (dsp/host_dsp.py), "auto" scipy for a dataset on the
    # CPU and the device pipeline on a card
    dsp_backend: str = "auto"


@dataclass
class TrainConfig:
    # reference recognition_model.py:38-50
    pad: int = 42
    report_PER: int = 1
    report_loss: int = 50
    learning_rate: float = 3e-4
    learning_rate_warmup: int = 1500
    threshold_alpha_loss: float = 0.05
    batch_size_grad: int = 100
    n_epochs: int = 200
    n_buckets: int = 16
    max_batch_length: int = 80000
    alpha_loss: float = 0.2
    label_smoothing: float = 0.1
    seed: int = 42
    scheduled_sampling_max_prob: float = 0.0
    scheduled_sampling_ramp: int = 10000
    electrode_rotation_prob: float = 0.0
    channel_drop_prob: float = 0.0
    time_drop_prob: float = 0.0
    time_drop_max_samples: int = 160
    eval_batches: int = 10
    per_train_batches: int = 15
    fused_window: "bool | None" = None
    window_max_compiles: int = 64
    prefetch_depth: int = 40
    stage_int16: bool = True
    stage_threads: int = 1


@dataclass
class DecodeConfig:
    # reference BeamSearch.py:16-20
    BeamWidth: int = 100
    Constrained: bool = True
    LMWeight: float = 0.3
    RunningLengthPenalty: float = 0.85
    FinalLengthPenalty: float = 0.95
    max_hypos: int = 512
    extra_steps: int = 10
    device_beam: bool = True
    batch_utterances: int = 8
    beam_scan: str = "early_exit"
    continuous_lanes: int = 0
    # compute dtype for the serving paths (saved-model greedy/beam eval);
    # "float32" restores reference-exact serving numerics
    compute_dtype: str = "bfloat16"
    quantize_int8: bool = False


@dataclass
class ParallelConfig:
    data_axis: int = -1
    model_axis: int = 1
    donate_state: bool = True
    coordinator_address: str = ""
    num_processes: int = -1
    process_id: int = -1
    sequence_shard: bool = False


@dataclass
class PathsConfig:
    # reference recognition_model.py:26-35
    debug: bool = False
    evaluate_saved_beam_search: Optional[str] = None
    evaluate_saved_greedy_search: Optional[str] = None
    start_training_from: Optional[str] = None
    resume: bool = False
    output_directory: str = "output"
    phonesSet: str = "descriptions/phonesSet"
    vocabulary: str = "descriptions/new_vocabulary"
    dict: str = "descriptions/new_dgaddy-lexicon.txt"
    lang_model: str = "descriptions/lm.arpa"


@dataclass
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    decode: DecodeConfig = field(default_factory=DecodeConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    paths: PathsConfig = field(default_factory=PathsConfig)

    def override(self, dotted: str, value: Any) -> None:
        """Set e.g. config.override('train.learning_rate', 1e-4)."""
        parts = dotted.split(".")
        obj = self
        for p in parts[:-1]:
            obj = getattr(obj, p)
        name = parts[-1]
        if not hasattr(obj, name):
            raise KeyError(f"unknown config key: {dotted}")
        current = getattr(obj, name)
        if current is None or not isinstance(value, type(current)):
            value = _coerce(value, current)
        setattr(obj, name, value)

    @classmethod
    def from_args(cls, argv: List[str]) -> "Config":
        """Parse ``--section.key=value`` / ``--key value`` style overrides.

        Bare flag names (no section prefix) are resolved against all
        sections so the reference's flat flag names keep working, e.g.
        ``--learning_rate 1e-4`` maps to ``train.learning_rate``.
        """
        cfg = cls()
        flat = cfg._flat_index()
        i = 0
        args = list(argv)
        while i < len(args):
            a = args[i]
            if not a.startswith("--"):
                i += 1
                continue
            a = a[2:]
            if "=" in a:
                key, val = a.split("=", 1)
                i += 1
            else:
                key = a
                if i + 1 < len(args) and not args[i + 1].startswith("--"):
                    val = args[i + 1]
                    i += 2
                else:
                    val = "true"
                    i += 1
            if "." not in key:
                if key not in flat:
                    raise KeyError(f"unknown flag: --{key}")
                key = flat[key]
            cfg.override(key, val)
        return cfg

    def _flat_index(self):
        index = {}
        for f in dataclasses.fields(self):
            section = getattr(self, f.name)
            for sf in dataclasses.fields(section):
                if sf.name in index:
                    # ambiguous bare names must be qualified
                    index[sf.name] = None
                else:
                    index[sf.name] = f"{f.name}.{sf.name}"
        return {k: v for k, v in index.items() if v is not None}

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)


def _coerce(value: Any, template: Any):
    if template is None and isinstance(value, str):
        # tri-state flags (e.g. train.fused_window None=auto)
        low = value.lower()
        if low in ("1", "true", "yes", "on"):
            return True
        if low in ("0", "false", "no", "off"):
            return False
        if low in ("none", "auto"):
            return None
        return value
    if isinstance(template, bool):
        if isinstance(value, str):
            return value.lower() in ("1", "true", "yes", "on")
        return bool(value)
    if isinstance(template, int):
        return int(value)
    if isinstance(template, float):
        return float(value)
    if isinstance(template, list):
        if isinstance(value, str):
            items = [v for v in value.split(",") if v != ""]
            wants_int = (template and isinstance(template[0], int)) or all(
                v.lstrip("-").isdigit() for v in items
            )
            if items and wants_int:
                return [int(v) for v in items]
            return items
        return list(value)
    return value
