"""Conformer encoder variant.

Counterpart of ``emg_tpu/models/conformer.py``: the standard Conformer
block (Gulati et al. 2020), half-step feed-forward -> relative-positional
self-attention -> depthwise conv module -> half-step feed-forward ->
LayerNorm, behind the transformer encoder's ``(src, padding_mask,
generator)`` interface, so ``EMGModel`` builds it as ``transformerEncoder``
for ``encoder_kind="conformer"``.

The self-attention is the unfused path of ``models/attention.py``
(``use_flash=False``, key pad mask only), as the JAX conformer's
``MultiHeadAttention`` never takes its flash branch.

Numerics follow flax's promotion: the JAX conformer's Dense, Conv and
LayerNorm layers carry no ``dtype``, so under ``compute_dtype="bfloat16"``
the bf16 stream meets float32 parameters and every layer computes and
returns float32. The encoder therefore upcasts its input once (exact) and
runs float32 throughout, whatever the model's compute dtype. LayerNorms use
flax's epsilon, 1e-6.

Train mode draws dropout masks from the caller's ``torch.Generator`` in
forward order: ff1's two, the attention probabilities, ``attn_drop``, the
conv module's, ff2's two. ``model.remat`` does not reach this encoder, as
in the JAX package, whose ``EMGModel`` builds the conformer without it.

On a device mesh (``parallel/mesh.py::shard_params``, JAX's rules of
``emg_tpu/parallel/mesh.py``) the self-attention's projections split heads
over the model axis, and the attention sits between ``copy_to_model`` and
``reduce_from_model``, as the transformer encoder's does; the
feed-forwards, the norms and the conv module stay replicated and run on
the whole stream. Under ``sequence_shard`` the stream between blocks is
the rank's time shard (JAX's GSPMD computes the unsharded function): the
attention gathers it and reduce-scatters its output, everything
frame-wise runs on the shard, and the depthwise conv, which reads
(K-1)/2 frames on either side, runs on the whole gathered stream, the
rank keeping its shard of the output (frames past the utterance read as
zeros, as on one device: the padding mask zeroes them first). Every
dropout mask is drawn at the unsharded shape and sliced to the rank's
batch rows and time shard.

Parameter names are the port's (the reference never shipped a conformer);
``utils/convert.py`` maps the JAX tree onto them. Under
``transformerEncoder.layers.{i}``:

  ff1_norm, ff1_in, ff1_out          <- ff1_norm, ff1_in, ff1_out
  attn_norm                          <- attn_norm
  self_attn.{w_q,w_k,w_v,w_o}        <- self_attn/{w_q,w_k,w_v,w_o}
  self_attn.relative_positional.embeddings (H, N, Dh, 1)
                                     <- self_attn/relative_positional/embeddings (H, N, Dh)
  conv_module.norm                   <- conv_module/LayerNorm_0
  conv_module.pointwise_in           <- conv_module/pointwise_in
  conv_module.depthwise (D, 1, k)    <- conv_module/depthwise kernel (k, 1, D)
  conv_module.conv_norm              <- conv_module/conv_norm
  conv_module.pointwise_out          <- conv_module/pointwise_out
  ff2_norm, ff2_in, ff2_out          <- ff2_norm, ff2_in, ff2_out
  final_norm                         <- final_norm
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from emg_tpu_torch.models.attention import MultiHeadAttention, dropout

LN_EPS = 1e-6  # flax nn.LayerNorm's default


class _Stream:
    """The mesh's view of the encoder stream (B, T, D): set by
    ``parallel/mesh.py::shard_params``."""

    mesh = None
    sequence_shard = False  # the stream is the rank's time shard

    @property
    def seq(self) -> bool:
        return self.mesh is not None and self.sequence_shard

    def drop(self, x: torch.Tensor, generator) -> torch.Tensor:
        """Dropout on a (B, T, ...) stream tensor: its mask drawn at the
        unsharded shape and sliced to the rank's rows and time shard."""
        shard = ()
        if self.mesh is not None:
            shard = self.mesh.batch_shard(x.shape[0])
            if self.sequence_shard:
                shard += self.mesh.model_shard(x.shape[1], dim=1)
        return dropout(x, self.dropout, generator, self.training, shard)


class ConvModule(nn.Module, _Stream):
    def __init__(self, d_model: int, kernel_size: int, dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.norm = nn.LayerNorm(d_model, eps=LN_EPS)
        self.pointwise_in = nn.Linear(d_model, 2 * d_model)
        self.depthwise = nn.Conv1d(d_model, d_model, kernel_size,
                                   padding=(kernel_size - 1) // 2, groups=d_model)
        self.conv_norm = nn.LayerNorm(d_model, eps=LN_EPS)
        self.pointwise_out = nn.Linear(d_model, d_model)

    def forward(self, x: torch.Tensor, padding_mask: torch.Tensor, generator=None):
        # x: (B, T, D), padding_mask x's (B, T) (under sequence_shard: the
        # rank's time shard of each). Pad frames are zeroed after the norm,
        # so the depthwise conv leaks valid frames only into pad frames
        h = self.norm(x)
        h = torch.where(padding_mask[:, :, None], 0.0, h)
        a, gate = self.pointwise_in(h).chunk(2, dim=-1)
        h = a * torch.sigmoid(gate)  # GLU over the last axis
        T = h.shape[1]
        if self.seq:  # the conv's neighbour frames: the whole stream
            h = self.mesh.gather_seq(h)
        h = self.depthwise(h.transpose(1, 2)).transpose(1, 2)
        if self.seq:
            h = h.narrow(1, self.mesh.model_index * T, T)
        h = self.pointwise_out(F.silu(self.conv_norm(h)))
        return self.drop(h, generator)


class ConformerBlock(nn.Module, _Stream):
    def __init__(self, d_model: int, num_heads: int, d_ff: int,
                 relative_positional_distance: int, conv_kernel_size: int,
                 dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        for name in ("ff1", "ff2"):
            setattr(self, f"{name}_norm", nn.LayerNorm(d_model, eps=LN_EPS))
            setattr(self, f"{name}_in", nn.Linear(d_model, d_ff))
            setattr(self, f"{name}_out", nn.Linear(d_ff, d_model))
        self.attn_norm = nn.LayerNorm(d_model, eps=LN_EPS)
        self.self_attn = MultiHeadAttention(
            d_model, num_heads, relative_positional=True,
            relative_positional_distance=relative_positional_distance, dropout=dropout,
        )
        self.conv_module = ConvModule(d_model, conv_kernel_size, dropout)
        self.final_norm = nn.LayerNorm(d_model, eps=LN_EPS)

    def feed_forward(self, name: str, x: torch.Tensor, generator) -> torch.Tensor:
        h = getattr(self, f"{name}_norm")(x)
        h = self.drop(F.silu(getattr(self, f"{name}_in")(h)), generator)
        return self.drop(getattr(self, f"{name}_out")(h), generator)

    def forward(self, x: torch.Tensor, padding_mask: torch.Tensor, generator=None):
        """x (B, T, D) float32 (under sequence_shard the rank's time shard),
        padding_mask the whole (B, T)."""
        mesh = self.mesh
        local_mask = mesh.block(padding_mask, "model", 1) if self.seq else padding_mask
        x = x + 0.5 * self.feed_forward("ff1", x, generator)
        a = self.attn_norm(x)
        if mesh is not None:  # into the heads' split work
            a = mesh.gather_seq(a) if self.seq else mesh.copy_to_model(a)
        attn = self.self_attn(a, a, key_padding_mask=padding_mask, generator=generator)
        if mesh is not None:  # the heads' partial outputs summed
            attn = mesh.scatter_seq(attn) if self.seq else mesh.reduce_from_model(attn)
        x = x + self.drop(attn, generator)
        x = x + self.conv_module(x, local_mask, generator)
        x = x + 0.5 * self.feed_forward("ff2", x, generator)
        return self.final_norm(x)


class ConformerEncoder(nn.Module, _Stream):
    def __init__(self, num_layers: int, d_model: int, num_heads: int, d_ff: int,
                 relative_positional_distance: int, dropout: float = 0.0,
                 conv_kernel_size: int = 31):
        super().__init__()
        self.layers = nn.ModuleList([
            ConformerBlock(d_model, num_heads, d_ff, relative_positional_distance,
                           conv_kernel_size, dropout)
            for _ in range(num_layers)
        ])

    def forward(self, src: torch.Tensor, src_padding_mask: torch.Tensor,
                generator=None) -> torch.Tensor:
        """(B, T, D) at any dtype -> (B, T, D) float32; under sequence_shard
        the blocks run on the rank's time shard, whole again on return."""
        src = src.float()
        if self.seq:
            src = self.mesh.split_seq(src)
        for layer in self.layers:
            src = layer(src, src_padding_mask, generator)
        return self.mesh.gather_seq_replicated(src) if self.seq else src
