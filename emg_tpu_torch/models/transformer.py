"""Post-norm transformer encoder/decoder layers (ReLU feed-forward).

Counterpart of ``emg_tpu/models/transformer.py``. Layer topology matches the
reference TransformerEncoderLayer / TransformerDecoderLayer
(transformer.py:11-134): residual -> LayerNorm after each sublayer,
relative-positional self-attention in the encoder only (the fused kernels
with ``use_flash``, else the unfused path with key and query pad masks),
causal + padding masks in the decoder. In train mode (``module.train()``) every residual
branch, the feed-forward hidden layer and the attention probabilities take
dropout at ``dropout``, each mask drawn from the ``generator`` passed to
``forward``. Parameter names follow the reference
(``layers.{i}.self_attn``, ``linear1``, ``norm1``, ...).

On a device mesh (``parallel/mesh.py::shard_params``) each attention and
feed-forward block is split over the model axis, Megatron's layout:
``linear1`` column-parallel (its rows of the weight and of the bias),
``linear2`` row-parallel (its columns; the bias added once, after the
sum), the attention by heads. A block takes its input in through
``block_in`` and sums its partial output through ``block_out``: one
all-reduce a block, or under ``sequence_shard`` (encoder only) an
all-gather of the time shards in and a reduce-scatter out, so LayerNorm,
residual and dropout run on the rank's time shard. Dropout masks are drawn
at the unsharded shape and sliced to the rank's batch rows, time shard and
hidden columns (``attention.dropout``'s ``shard``).

LayerNorm arithmetic stays float32 (float32 parameters; a bfloat16
mean of squares is lossy); the stream returns to the compute dtype after
each norm. Linear layers run at the stream dtype with float32 parameters
cast at use.

``TransformerDecoder.decode_step`` is the single-token incremental path
over per-layer self-attention K/V caches. The caches are written in place:
the current token's K/V row lands in the cache before the layer attends
over it, the same arithmetic as attending over the old rows plus the new
one. The step's position is an int64 tensor on the device (JAX's traced
``s``), 0-dim (every row at one position, as greedy decoding) or (B,) (one
position a row, as the beam's lanes, which continuous batching starts at
different times): the cache write is a ``scatter_`` at each row's position
and the causal mask compares against it, so no host value and no Python
branch depends on it, and a CUDA graph captured at one position replays
at every other. A position must lie in [0, S).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from emg_tpu_torch.models.attention import NEG_FILL, DrawTape, MultiHeadAttention, dropout
from emg_tpu_torch.utils.quantize import weight_as


def linear(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """Linear layer at the activation dtype; the parameters stay float32
    (an int8 weight dequantizes, ``utils/quantize.py``)."""
    return F.linear(x, weight_as(layer.weight, x.dtype), layer.bias.to(x.dtype))


def layer_norm(norm: nn.LayerNorm, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight, norm.bias, norm.eps).to(dtype)


class _FeedForwardMixin:
    mesh = None  # the device mesh, set by parallel/mesh.py::shard_params
    sequence_shard = False  # the stream between blocks is the rank's time shard

    def block_in(self, x: torch.Tensor) -> torch.Tensor:
        """A block's input, whole on every model rank."""
        if self.mesh is None:
            return x
        return self.mesh.gather_seq(x) if self.sequence_shard else self.mesh.copy_to_model(x)

    def block_out(self, x: torch.Tensor) -> torch.Tensor:
        """A block's partial output summed over the model axis (under
        sequence_shard, the rank's time shard of the sum)."""
        if self.mesh is None:
            return x
        return self.mesh.scatter_seq(x) if self.sequence_shard else self.mesh.reduce_from_model(x)

    def feed_forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        h = F.relu(linear(self.linear1, self.block_in(x)))
        h = self.drop(h, generator, hidden=True)
        if self.mesh is None or self.mesh.model == 1:
            return linear(self.linear2, h)
        out = self.block_out(F.linear(h, weight_as(self.linear2.weight, h.dtype)))
        return out + self.linear2.bias.to(out.dtype)

    def drop(self, x: torch.Tensor, generator, hidden: bool = False) -> torch.Tensor:
        """Dropout on the stream (B, T, D) or, ``hidden``, the feed-forward
        hidden layer (B, T, FF) whose columns the model axis splits."""
        shard = ()
        if self.mesh is not None:
            shard = self.mesh.batch_shard(x.shape[0])
            if hidden:
                shard += self.mesh.model_shard(x.shape[-1], dim=x.dim() - 1)
            elif self.sequence_shard:
                shard += self.mesh.model_shard(x.shape[1], dim=1)
        return dropout(x, self.dropout, generator, self.training, shard)


class TransformerEncoderLayer(nn.Module, _FeedForwardMixin):
    def __init__(self, d_model: int, num_heads: int, d_ff: int,
                 relative_positional_distance: int, dropout: float = 0.0,
                 use_flash: bool = False):
        super().__init__()
        self.dropout = dropout
        self.self_attn = MultiHeadAttention(
            d_model, num_heads, relative_positional=True,
            relative_positional_distance=relative_positional_distance, dropout=dropout,
            use_flash=use_flash,
        )
        self.linear1 = nn.Linear(d_model, d_ff)
        self.linear2 = nn.Linear(d_ff, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, src: torch.Tensor, src_padding_mask: torch.Tensor,
                generator=None) -> torch.Tensor:
        cdt = src.dtype
        x = self.block_in(src)
        attn = self.block_out(self.self_attn(
            x, x, key_padding_mask=src_padding_mask,
            query_padding_mask=src_padding_mask, generator=generator,
        ))
        src = layer_norm(self.norm1, src + self.drop(attn, generator), cdt)
        ff = self.feed_forward(src, generator)
        return layer_norm(self.norm2, src + self.drop(ff, generator), cdt)


class TransformerDecoderLayer(nn.Module, _FeedForwardMixin):
    def __init__(self, d_model: int, num_heads: int, d_ff: int, dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.self_attn = MultiHeadAttention(d_model, num_heads, dropout=dropout)
        self.multihead_attn = MultiHeadAttention(d_model, num_heads, dropout=dropout)
        self.linear1 = nn.Linear(d_model, d_ff)
        self.linear2 = nn.Linear(d_ff, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm3 = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, tgt, memory, tgt_padding_mask, memory_padding_mask, generator=None):
        """``memory`` has entered the model axis's split work already
        (``TransformerDecoder.forward``)."""
        cdt = tgt.dtype
        x = self.block_in(tgt)
        sa = self.block_out(self.self_attn(
            x, x, key_padding_mask=tgt_padding_mask,
            query_padding_mask=tgt_padding_mask, causal=True, generator=generator,
        ))
        tgt = layer_norm(self.norm1, tgt + self.drop(sa, generator), cdt)
        ca = self.block_out(self.multihead_attn(self.block_in(tgt), memory,
                                                key_padding_mask=memory_padding_mask,
                                                generator=generator))
        tgt = layer_norm(self.norm2, tgt + self.drop(ca, generator), cdt)
        ff = self.feed_forward(tgt, generator)
        return layer_norm(self.norm3, tgt + self.drop(ff, generator), cdt)

    def project_cross_kv(self, memory):
        """Project memory into this layer's cross-attention K/V once."""
        return self.multihead_attn.project_kv(memory)

    def decode_step(self, x_tok, k_cache, v_cache, cross_k, cross_v, step: torch.Tensor,
                    tokens_pad_mask, query_is_pad, memory_padding_mask):
        """x_tok: (B, 1, D); k_cache/v_cache: this layer's (B, H, S, Dh)
        caches, updated in place at row ``step`` of each batch row (an int64
        tensor of shape () or (B,)); cross_k/cross_v: (U, H, T, Dh) and
        memory_padding_mask (U, T) for U utterances, U dividing B, rows
        grouped by utterance."""
        cdt = x_tok.dtype
        B, H, S, Dh = k_cache.shape
        q, k_new, v_new = self.self_attn.project_qkv(x_tok)  # (B, H, 1, Dh)
        rows = step.expand(B)
        at = rows.view(B, 1, 1, 1).expand(B, H, 1, Dh)
        k_cache.scatter_(2, at, k_new.to(k_cache.dtype))
        v_cache.scatter_(2, at, v_new.to(v_cache.dtype))
        valid = torch.arange(S, device=x_tok.device) <= rows[:, None]  # causal, (B, S)
        sa = self.self_attn.attend_step(
            q, k_cache, v_cache, valid, tokens_pad_mask, query_is_pad,
        )
        x = layer_norm(self.norm1, x_tok + sa, cdt)

        # cross-attention (no query masking, matching the reference); logits
        # accumulate float32 so the softmax stays exact at bfloat16. The
        # memory holds U utterances and the B rows attend to it in U groups
        # of R (as emg_tpu/models/transformer.py's batch-1 memory branch):
        # a broadcast, so no utterance's K/V is copied per row.
        mha = self.multihead_attn
        qc = mha.project_q(x)  # (B, H, 1, Dh)
        B, H, _, Dh = qc.shape
        U = cross_k.shape[0]
        qg = qc.reshape(U, B // U, H, 1, Dh)
        logits = torch.einsum("urhqa,uhka->urhqk", qg.float(), cross_k.float()) / (mha.head_dim ** 0.5)
        logits = torch.where(memory_padding_mask[:, None, None, None, :], NEG_FILL, logits)
        probs = torch.softmax(logits, dim=-1).to(cross_v.dtype)
        o = torch.einsum("urhqk,uhka->urhqa", probs, cross_v).reshape(B, H, 1, Dh)
        ca = mha.output(o)
        x = layer_norm(self.norm2, x + ca, cdt)
        return layer_norm(self.norm3, x + self.feed_forward(x), cdt)


def rematerialized(layer: nn.Module, src: torch.Tensor, src_padding_mask: torch.Tensor,
                   generator=None) -> torch.Tensor:
    """``layer(src, src_padding_mask, generator)`` under
    ``torch.utils.checkpoint``: the backward recomputes the layer from its
    input instead of keeping its activations (the JAX package's
    ``nn.remat``). The layer draws through a ``DrawTape``, so the recompute
    reads back the masks and the attention seed that the first run drew,
    and the generator advances once, as without remat. Nothing is saved or
    restored on any generator (``preserve_rng_state=False``): a CUDA graph
    holds the step. On a mesh the recompute replays the layer's
    collectives inside the backward, in the same order on every rank."""
    tape = DrawTape(generator) if generator is not None else None

    def run(x):
        out = layer(x, src_padding_mask, tape)
        if tape is not None:
            tape.replay()
        return out

    return checkpoint(run, src, use_reentrant=False, preserve_rng_state=False)


class TransformerEncoder(nn.Module):
    """The encoder stack. With ``remat`` each layer is rematerialized in
    training (``rematerialized``); in eval mode, or with gradients off, the
    layers run as they are."""

    mesh = None
    sequence_shard = False  # split the stream's time over the model axis

    def __init__(self, num_layers: int, d_model: int, num_heads: int, d_ff: int,
                 relative_positional_distance: int, dropout: float = 0.0,
                 use_flash: bool = False, remat: bool = False):
        super().__init__()
        self.remat = remat
        self.layers = nn.ModuleList([
            TransformerEncoderLayer(d_model, num_heads, d_ff, relative_positional_distance,
                                    dropout, use_flash)
            for _ in range(num_layers)
        ])

    def forward(self, src, src_padding_mask, generator=None):
        """src (B, T, D) -> (B, T, D); under sequence_shard the layers run
        on the rank's time shard, whole again on return."""
        seq = self.mesh is not None and self.sequence_shard
        if seq:
            src = self.mesh.split_seq(src)
        remat = self.remat and self.training and torch.is_grad_enabled()
        for layer in self.layers:
            src = (rematerialized(layer, src, src_padding_mask, generator) if remat
                   else layer(src, src_padding_mask, generator))
        return self.mesh.gather_seq_replicated(src) if seq else src


class TransformerDecoder(nn.Module):
    mesh = None

    def __init__(self, num_layers: int, d_model: int, num_heads: int, d_ff: int,
                 dropout: float = 0.0):
        super().__init__()
        self.layers = nn.ModuleList([
            TransformerDecoderLayer(d_model, num_heads, d_ff, dropout)
            for _ in range(num_layers)
        ])

    def forward(self, tgt, memory, tgt_padding_mask, memory_padding_mask, generator=None):
        if self.mesh is not None:
            # every layer's cross-attention reads the memory: one entry into
            # the split work sums their gradients over the model axis once
            memory = self.mesh.copy_to_model(memory)
        for layer in self.layers:
            tgt = layer(tgt, memory, tgt_padding_mask, memory_padding_mask, generator)
        return tgt

    def project_cross_kvs(self, memory):
        return [layer.project_cross_kv(memory) for layer in self.layers]

    def decode_step(self, x_tok, caches, cross_kvs, step: torch.Tensor, tokens_pad_mask,
                    query_is_pad, memory_padding_mask):
        """caches: (k_all, v_all), each (L, B, H, S, Dh) stacked over layers
        and updated in place at row ``step`` of each batch row (an int64
        tensor of shape () or (B,)). Returns the (B, 1, D) output."""
        k_all, v_all = caches
        for i, layer in enumerate(self.layers):
            ck, cv = cross_kvs[i]
            x_tok = layer.decode_step(
                x_tok, k_all[i], v_all[i], ck, cv, step, tokens_pad_mask,
                query_is_pad, memory_padding_mask,
            )
        return x_tok
