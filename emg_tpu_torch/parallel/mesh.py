"""The (data, model) device mesh: its arithmetic, its process groups, the
sharding rules and the collectives a sharded step runs.

Counterpart of ``emg_tpu/parallel/mesh.py``. JAX writes the training step
in global view and lets XLA insert the collectives over a
``jax.sharding.Mesh``; here every mesh device is a process (a rank of
``torch.distributed``, one card each), the model holds the rank's shards,
and the collectives are explicit autograd functions at the places XLA puts
them:

- ``data`` splits the batch: packed rows and utterances (``shard_batch``),
  with BatchNorm's sums and the CNN's output all-gathered over it
  (``models/resnet.py``, ``models/model.py``) and the gradients summed over
  it after the backward (``parallel/train_step.py``);
- ``model`` splits attention heads and the feed-forward hidden dim
  (``param_pspec``): each block's input enters through ``copy_to_model``
  (identity, gradient all-reduced) and its partial output leaves through
  ``reduce_from_model`` (all-reduce, gradient as is), one pair per
  attention or feed-forward block (Megatron's column/row-parallel layout);
- under ``sequence_shard`` the encoder stream between blocks is split on
  time over ``model``: blocks take it in through ``gather_seq`` (all-gather,
  gradient reduce-scattered) and give it back through ``scatter_seq``
  (reduce-scatter, gradient all-gathered), Megatron's sequence parallelism.

Rank r sits at data index r // model and model index r % model, the
process-major order of JAX's ``np.array(devices).reshape(data, model)``.

Backends: NCCL (CUDA ranks) has every collective; gloo (CPU ranks, and two
ranks sharing one card) has only all-reduce and broadcast for CUDA tensors,
so on gloo an all-gather is an all-reduce of each rank's block placed in
zeros and a reduce-scatter is an all-reduce and a slice, on either device.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

@dataclass(frozen=True)
class MeshShape:
    """A (data, model) mesh's axis sizes."""
    data: int
    model: int

    @property
    def size(self) -> int:
        return self.data * self.model

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.data, "model": self.model}


def make_mesh(data_axis: int = -1, model_axis: int = 1, n_devices: int = 1) -> MeshShape:
    """The mesh over ``n_devices`` devices, as ``emg_tpu.parallel.make_mesh``:
    ``data_axis=-1`` spans the devices the model axis leaves, and a mesh
    that does not cover the devices exactly raises."""
    n = int(n_devices)
    if data_axis == -1 and model_axis > 0:
        data_axis = n // model_axis
    if data_axis < 1 or model_axis < 1 or data_axis * model_axis != n:
        raise ValueError(f"mesh {data_axis}x{model_axis} does not cover {n} devices")
    return MeshShape(data_axis, model_axis)


def mesh_from_config(pcfg, n_devices: int) -> Optional[MeshShape]:
    """The training mesh of a ParallelConfig over ``n_devices`` devices, or
    None: for the defaults (-1, 1) and for a mesh of one device, which keep
    the single-device path (``emg_tpu.parallel.mesh_from_config``)."""
    if pcfg.data_axis == -1 and pcfg.model_axis == 1:
        return None
    shape = make_mesh(pcfg.data_axis, pcfg.model_axis, n_devices)
    return None if shape.size == 1 else shape


def requested_devices(pcfg) -> int:
    """The devices a config's mesh asks for where the devices are the
    mesh's own processes (CPU ranks): the data axis (1 where it is -1)
    times the model axis."""
    return max(pcfg.data_axis, 1) * pcfg.model_axis


# ---------------------------------------------------------------------------
# sharding rules over the port's parameter names and layouts
# ---------------------------------------------------------------------------

_HEADS = re.compile(r"(^|\.)(w_q|w_k|w_v|w_o)$")


def param_pspec(name: str) -> Tuple[Optional[str], ...]:
    """The mesh axis of each dim of parameter ``name`` (a PartitionSpec as a
    tuple; ``()`` replicated), the rules of ``emg_tpu.parallel.param_pspec``
    on the port's layouts:

    - attention projections (H, D, Dh) / (H, Dh, D): heads over ``model``;
    - the feed-forward ``linear1`` weight (FF, D), torch's transpose of the
      JAX kernel (D, FF), and its bias (FF,): FF over ``model``;
    - ``linear2``'s weight (D, FF): its input dim over ``model``;
    - everything else (the relative-position tables, ``linear2``'s bias,
      norms, embeddings, the CNN) replicated.

    The conformer's feed-forwards are ``ff1_in``/``ff2_out``..., which the
    rule (like JAX's) leaves replicated."""
    if _HEADS.search(name):
        return ("model", None, None)
    if name.endswith("linear1.weight"):
        return ("model", None)
    if name.endswith("linear1.bias"):
        return ("model",)
    if name.endswith("linear2.weight"):
        return (None, "model")
    return ()


def shard_dim(name: str) -> Optional[int]:
    """The dim of ``name`` split over the model axis, or None."""
    spec = param_pspec(name)
    return spec.index("model") if "model" in spec else None


_SEQ_PARTIAL = re.compile(r"^transformerEncoder\.layers\.\d+\.(norm1|norm2|linear2\.bias)")


def grad_sums_over_model(name: str, sequence_shard: bool) -> bool:
    """Whether a replicated parameter's gradient is a partial sum over the
    model axis: it is fed by work split over that axis. The relative-
    position tables serve only the rank's heads; under ``sequence_shard``
    the encoder's norms and ``linear2`` bias act on the rank's time shard.
    Everything else replicated meets replicated activations, and its
    gradient is already whole on every model rank."""
    if name.endswith("relative_positional.embeddings"):
        return True
    return sequence_shard and bool(_SEQ_PARTIAL.match(name))


# ---------------------------------------------------------------------------
# the live mesh: a rank's coordinates and process groups
# ---------------------------------------------------------------------------

class Mesh:
    """A rank's view of the (data, model) mesh over the default process
    group. ``data_group`` holds the ranks that share this rank's model
    index (they split the batch), ``model_group`` those that share its data
    index (they split heads, FF and, under sequence_shard, time). Every
    rank must build it, in the same order, since ``new_group`` is a
    collective."""

    def __init__(self, shape: MeshShape, device: torch.device):
        if not dist.is_initialized():
            raise RuntimeError("a Mesh needs an initialized torch.distributed process group")
        world, rank = dist.get_world_size(), dist.get_rank()
        if shape.size != world:
            raise ValueError(f"mesh {shape.data}x{shape.model} does not cover {world} devices")
        self.shape = shape
        self.device = torch.device(device)
        self.rank = rank
        self.data_index, self.model_index = divmod(rank, shape.model)
        self.native = dist.get_backend() == "nccl"
        self.data_group = self.model_group = None
        for m in range(shape.model):  # new_group is collective: every rank makes every group
            g = dist.new_group([d * shape.model + m for d in range(shape.data)])
            if m == self.model_index:
                self.data_group = g
        for d in range(shape.data):
            g = dist.new_group([d * shape.model + m for m in range(shape.model)])
            if d == self.data_index:
                self.model_group = g

    @property
    def data(self) -> int:
        return self.shape.data

    @property
    def model(self) -> int:
        return self.shape.model

    def rows(self, n: int) -> slice:
        """This rank's block of a leading dim of n rows split over data."""
        if n % self.data:
            raise ValueError(f"{n} rows do not divide over a data axis of {self.data}")
        per = n // self.data
        return slice(self.data_index * per, (self.data_index + 1) * per)

    # -- the shards a dropout mask is sliced to -----------------------------
    def batch_shard(self, n_local: int, dim: int = 0):
        """(dim, start, global size) of this rank's batch rows, or nothing."""
        if self.data == 1:
            return ()
        return ((dim, self.data_index * n_local, self.data * n_local),)

    def model_shard(self, n_local: int, dim: int):
        """(dim, start, global size) of this rank's model-axis block."""
        if self.model == 1:
            return ()
        return ((dim, self.model_index * n_local, self.model * n_local),)

    # -- collectives with autograd -----------------------------------------
    def copy_to_model(self, x):
        return _CopyTo.apply(x, self, "model") if self.model > 1 else x

    def reduce_from_model(self, x):
        return _ReduceFrom.apply(x, self, "model") if self.model > 1 else x

    def gather_seq(self, x, dim: int = 1):
        """Time shards -> the whole stream, into split work: the gradient
        is summed over the model axis and each rank keeps its shard's."""
        return _Gather.apply(x, self, "model", dim, True) if self.model > 1 else x

    def gather_seq_replicated(self, x, dim: int = 1):
        """Time shards -> the whole stream, into replicated work: each rank
        keeps its shard's gradient as is."""
        return _Gather.apply(x, self, "model", dim, False) if self.model > 1 else x

    def scatter_seq(self, x, dim: int = 1):
        """Partial sums of the whole stream -> this rank's time shard of their
        sum; the gradient is all-gathered."""
        return _ReduceScatter.apply(x, self, "model", dim) if self.model > 1 else x

    def split_seq(self, x, dim: int = 1):
        """A replicated stream -> this rank's time shard; the gradient is
        all-gathered."""
        return _Split.apply(x, self, "model", dim) if self.model > 1 else x

    def gather_data(self, x, dim: int = 0):
        """The data ranks' row blocks -> all rows, into work that differs by
        data rank: the gradient is reduce-scattered."""
        return _Gather.apply(x, self, "data", dim, True) if self.data > 1 else x

    def sum_over_data(self, x):
        """The sum over the data ranks; the gradient is summed the same way
        (every rank's loss uses the sum)."""
        return _SumAll.apply(x, self, "data") if self.data > 1 else x

    # -- plain collectives (no autograd) -----------------------------------
    def group(self, axis: str):
        return self.data_group if axis == "data" else self.model_group

    def axis_size(self, axis: str) -> int:
        return self.data if axis == "data" else self.model

    def axis_index(self, axis: str) -> int:
        return self.data_index if axis == "data" else self.model_index

    def all_reduce(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """The sum of x over an axis's ranks, a new tensor (every rank gets
        the same bits)."""
        out = x.detach().clone(memory_format=torch.contiguous_format)
        if self.axis_size(axis) > 1:
            dist.all_reduce(out, group=self.group(axis))
        return out

    def all_gather(self, x: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
        """The axis's ranks' blocks of x, concatenated on ``dim`` in rank
        order."""
        n = self.axis_size(axis)
        if n == 1:
            return x.detach().clone()
        x = x.detach()
        if self.native:
            parts = x.movedim(dim, 0).contiguous()
            out = torch.empty((n * parts.shape[0],) + parts.shape[1:], dtype=x.dtype,
                              device=x.device)
            dist.all_gather_into_tensor(out, parts, group=self.group(axis))
            return out.movedim(0, dim).contiguous()
        shape = list(x.shape)
        shape[dim] *= n
        out = torch.zeros(shape, dtype=x.dtype, device=x.device)
        out.narrow(dim, self.axis_index(axis) * x.shape[dim], x.shape[dim]).copy_(x)
        dist.all_reduce(out, group=self.group(axis))
        return out

    def reduce_scatter(self, x: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
        """This rank's block (on ``dim``) of the sum of x over the axis's
        ranks."""
        n = self.axis_size(axis)
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split over {n} ranks")
        per = x.shape[dim] // n
        if self.native and n > 1:
            parts = x.detach().movedim(dim, 0).contiguous()
            out = torch.empty((per,) + parts.shape[1:], dtype=x.dtype, device=x.device)
            dist.reduce_scatter_tensor(out, parts, group=self.group(axis))
            return out.movedim(0, dim).contiguous()
        return self.all_reduce(x, axis).narrow(dim, self.axis_index(axis) * per,
                                               per).contiguous()

    def block(self, x: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
        """This rank's block of x on ``dim`` (no communication)."""
        n = self.axis_size(axis)
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split over {n} ranks")
        per = x.shape[dim] // n
        return x.narrow(dim, self.axis_index(axis) * per, per).contiguous()

    def broadcast_object(self, obj):
        """An object from global rank 0 to every rank."""
        box = [obj]
        dist.broadcast_object_list(box, src=0, device=self.device if self.native else None)
        return box[0]


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g, ctx.axis), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return mesh.all_reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _SumAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return mesh.all_reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g, ctx.axis), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim, grad_sums):
        ctx.mesh, ctx.axis, ctx.dim, ctx.grad_sums = mesh, axis, dim, grad_sums
        return mesh.all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        m = ctx.mesh
        g = (m.reduce_scatter(g, ctx.axis, ctx.dim) if ctx.grad_sums
             else m.block(g, ctx.axis, ctx.dim))
        return g, None, None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return mesh.reduce_scatter(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_gather(g, ctx.axis, ctx.dim), None, None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return mesh.block(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_gather(g, ctx.axis, ctx.dim), None, None, None


# ---------------------------------------------------------------------------
# parameters and batches on the mesh
# ---------------------------------------------------------------------------

def _set_param(model: nn.Module, name: str, value: torch.Tensor) -> None:
    owner, _, leaf = name.rpartition(".")
    setattr(model.get_submodule(owner) if owner else model, leaf, nn.Parameter(value))


def shard_params(model: nn.Module, mesh: Mesh, sequence_shard: bool = False) -> nn.Module:
    """Put ``model`` (built whole, the same weights on every rank) on the
    mesh, in place: each parameter of ``param_pspec`` keeps this rank's
    block of the model axis, every module learns the mesh, and the
    attention layers their local heads. ``sequence_shard`` splits the
    encoder stream's time over the model axis (where it is over 1). Build
    the optimizer after this, so AdamW's moments are per shard."""
    from emg_tpu_torch.models.attention import MultiHeadAttention

    if getattr(model.cfg, "encoder_kind", "transformer") != "transformer":
        raise NotImplementedError("a device mesh trains the transformer encoder; the conformer "
                                  "is not yet sharded")
    M = mesh.model
    for name, p in list(model.named_parameters()):
        dim = shard_dim(name)
        if dim is None or M == 1:
            continue
        if p.shape[dim] % M:
            raise ValueError(f"{name} {tuple(p.shape)}: dim {dim} does not split over a "
                             f"model axis of {M}")
        _set_param(model, name, mesh.block(p.detach(), "model", dim))
    for module in model.modules():
        if hasattr(type(module), "mesh"):
            module.mesh = mesh
        if isinstance(module, MultiHeadAttention):
            module.num_heads //= M
            module.head_offset = mesh.model_index * module.num_heads
    if sequence_shard and M > 1:
        for module in model.transformerEncoder.modules():
            if hasattr(type(module), "sequence_shard"):
                module.sequence_shard = True
    return model


def full_state_dict(model: nn.Module, mesh: Mesh) -> Dict[str, torch.Tensor]:
    """The unsharded state dict (CPU tensors), on every rank: each sharded
    parameter all-gathered over the model axis. A collective."""
    return {k: (mesh.all_gather(v, "model", shard_dim(k)) if _is_sharded(k, mesh) else v.detach())
            .cpu().clone() for k, v in model.state_dict().items()}


def _is_sharded(name: str, mesh: Optional[Mesh]) -> bool:
    return mesh is not None and mesh.model > 1 and shard_dim(name) is not None


def gather_full(name: str, t: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """Parameter ``name``'s tensor (or a tensor shaped as it: a gradient,
    an AdamW moment) made whole. A collective for a sharded parameter."""
    return mesh.all_gather(t, "model", shard_dim(name)) if _is_sharded(name, mesh) else t


def local_block(name: str, t: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """A whole tensor of parameter ``name``'s shape cut to this rank's block."""
    return mesh.block(t, "model", shard_dim(name)) if _is_sharded(name, mesh) else t


@dataclass
class LocalBatch:
    """This rank's share of a host PackedBatch, with the global facts the
    sharded step needs."""
    batch: object  # PackedBatch of the rank's packed rows and utterances
    row_offset: int  # the first utterance's index in the global batch
    packed_shape: Tuple[int, int, int]  # the global (N, L, C)
    n_targets: int  # the global batch size (bucketed)


def batch_pspec() -> Dict[str, Tuple[Optional[str], ...]]:
    """The mesh axis of a PackedBatch field's leading dim, as
    ``emg_tpu.parallel.batch_pspec``."""
    return {
        "packed_raw": ("data", None, None),
        "n_rows": (),
        "lengths": ("data",),
        "offsets": ("data",),
        "targets": ("data", None),
        "target_lengths": ("data",),
        "n_examples": (),
    }


def shard_batch(pb, mesh: Mesh) -> LocalBatch:
    """This rank's block of every data-split field of ``pb`` (built whole
    and alike on every rank, rows and utterances padded to multiples of the
    data axis by ``make_packed_batch``). ``offsets`` keep their global
    values: they index the CNN stream all-gathered over the data axis."""
    import dataclasses

    fields = {}
    for name, spec in batch_pspec().items():
        v = getattr(pb, name)
        fields[name] = v[mesh.rows(len(v))] if spec[:1] == ("data",) else v
    return LocalBatch(batch=dataclasses.replace(pb, **fields),
                      row_offset=mesh.rows(len(pb.lengths)).start,
                      packed_shape=tuple(pb.packed_raw.shape), n_targets=len(pb.lengths))


def flat_all_reduce(tensors: Sequence[torch.Tensor], mesh: Mesh, axis: str) -> List[torch.Tensor]:
    """Sum each tensor over an axis's ranks with one all-reduce of their
    concatenation."""
    if not tensors or mesh.axis_size(axis) == 1:
        return list(tensors)
    flat = mesh.all_reduce(torch.cat([t.reshape(-1) for t in tensors]), axis)
    out, at = [], 0
    for t in tensors:
        out.append(flat[at: at + t.numel()].view_as(t))
        at += t.numel()
    return out
