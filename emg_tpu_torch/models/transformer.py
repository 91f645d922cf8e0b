"""Post-norm transformer encoder/decoder layers (ReLU feed-forward).

Counterpart of ``emg_tpu/models/transformer.py``. Layer topology matches the
reference TransformerEncoderLayer / TransformerDecoderLayer
(transformer.py:11-134): residual -> LayerNorm after each sublayer,
relative-positional self-attention in the encoder only, causal + padding
masks in the decoder. In train mode (``module.train()``) every residual
branch, the feed-forward hidden layer and the attention probabilities take
dropout at ``dropout``, each mask drawn from the ``generator`` passed to
``forward``. Parameter names follow the reference
(``layers.{i}.self_attn``, ``linear1``, ``norm1``, ...).

LayerNorm arithmetic stays float32 (float32 parameters; a bfloat16
mean of squares is lossy); the stream returns to the compute dtype after
each norm. Linear layers run at the stream dtype with float32 parameters
cast at use.

``TransformerDecoder.decode_step`` is the single-token incremental path
over per-layer self-attention K/V caches. The caches are written in place:
the current token's K/V row lands in the cache before the layer attends
over it, the same arithmetic as attending over the old rows plus the new
one.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from emg_tpu_torch.models.attention import NEG_FILL, MultiHeadAttention, dropout


def linear(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """Linear layer at the activation dtype; the parameters stay float32."""
    return F.linear(x, layer.weight.to(x.dtype), layer.bias.to(x.dtype))


def layer_norm(norm: nn.LayerNorm, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight, norm.bias, norm.eps).to(dtype)


class _FeedForwardMixin:
    def feed_forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        h = F.relu(linear(self.linear1, x))
        return linear(self.linear2, self.drop(h, generator))

    def drop(self, x: torch.Tensor, generator) -> torch.Tensor:
        return dropout(x, self.dropout, generator, self.training)


class TransformerEncoderLayer(nn.Module, _FeedForwardMixin):
    def __init__(self, d_model: int, num_heads: int, d_ff: int,
                 relative_positional_distance: int, dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.self_attn = MultiHeadAttention(
            d_model, num_heads, relative_positional=True,
            relative_positional_distance=relative_positional_distance, dropout=dropout,
        )
        self.linear1 = nn.Linear(d_model, d_ff)
        self.linear2 = nn.Linear(d_ff, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, src: torch.Tensor, src_padding_mask: torch.Tensor,
                generator=None) -> torch.Tensor:
        cdt = src.dtype
        attn = self.self_attn(
            src, src, key_padding_mask=src_padding_mask,
            query_padding_mask=src_padding_mask, generator=generator,
        )
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
        cdt = tgt.dtype
        sa = self.self_attn(
            tgt, tgt, key_padding_mask=tgt_padding_mask,
            query_padding_mask=tgt_padding_mask, causal=True, generator=generator,
        )
        tgt = layer_norm(self.norm1, tgt + self.drop(sa, generator), cdt)
        ca = self.multihead_attn(tgt, memory, key_padding_mask=memory_padding_mask,
                                 generator=generator)
        tgt = layer_norm(self.norm2, tgt + self.drop(ca, generator), cdt)
        ff = self.feed_forward(tgt, generator)
        return layer_norm(self.norm3, tgt + self.drop(ff, generator), cdt)

    def project_cross_kv(self, memory):
        """Project memory into this layer's cross-attention K/V once."""
        return self.multihead_attn.project_kv(memory)

    def decode_step(self, x_tok, k_cache, v_cache, cross_k, cross_v, step: int,
                    tokens_pad_mask, query_is_pad, memory_padding_mask):
        """x_tok: (B, 1, D); k_cache/v_cache: this layer's (B, H, S, Dh)
        caches, updated in place at row ``step``."""
        cdt = x_tok.dtype
        S = k_cache.shape[2]
        q, k_new, v_new = self.self_attn.project_qkv(x_tok)  # (B, H, 1, Dh)
        k_cache[:, :, step] = k_new[:, :, 0].to(k_cache.dtype)
        v_cache[:, :, step] = v_new[:, :, 0].to(v_cache.dtype)
        valid = torch.arange(S, device=x_tok.device)[None, :] <= step  # causal
        sa = self.self_attn.attend_step(
            q, k_cache, v_cache, valid, tokens_pad_mask, query_is_pad,
        )
        x = layer_norm(self.norm1, x_tok + sa, cdt)

        # cross-attention (no query masking, matching the reference); logits
        # accumulate float32 so the softmax stays exact at bfloat16
        mha = self.multihead_attn
        qc = mha.project_q(x)
        logits = torch.einsum("bhqa,bhka->bhqk", qc.float(), cross_k.float()) / (mha.head_dim ** 0.5)
        logits = torch.where(memory_padding_mask[:, None, None, :], NEG_FILL, logits)
        probs = torch.softmax(logits, dim=-1).to(cross_v.dtype)
        ca = mha.output(torch.einsum("bhqk,bhka->bhqa", probs, cross_v))
        x = layer_norm(self.norm2, x + ca, cdt)
        return layer_norm(self.norm3, x + self.feed_forward(x), cdt)


class TransformerEncoder(nn.Module):
    def __init__(self, num_layers: int, d_model: int, num_heads: int, d_ff: int,
                 relative_positional_distance: int, dropout: float = 0.0):
        super().__init__()
        self.layers = nn.ModuleList([
            TransformerEncoderLayer(d_model, num_heads, d_ff, relative_positional_distance,
                                    dropout)
            for _ in range(num_layers)
        ])

    def forward(self, src, src_padding_mask, generator=None):
        for layer in self.layers:
            src = layer(src, src_padding_mask, generator)
        return src


class TransformerDecoder(nn.Module):
    def __init__(self, num_layers: int, d_model: int, num_heads: int, d_ff: int,
                 dropout: float = 0.0):
        super().__init__()
        self.layers = nn.ModuleList([
            TransformerDecoderLayer(d_model, num_heads, d_ff, dropout)
            for _ in range(num_layers)
        ])

    def forward(self, tgt, memory, tgt_padding_mask, memory_padding_mask, generator=None):
        for layer in self.layers:
            tgt = layer(tgt, memory, tgt_padding_mask, memory_padding_mask, generator)
        return tgt

    def project_cross_kvs(self, memory):
        return [layer.project_cross_kv(memory) for layer in self.layers]

    def decode_step(self, x_tok, caches, cross_kvs, step: int, tokens_pad_mask,
                    query_is_pad, memory_padding_mask):
        """caches: (k_all, v_all), each (L, B, H, S, Dh) stacked over layers
        and updated in place. Returns the (B, 1, D) output."""
        k_all, v_all = caches
        for i, layer in enumerate(self.layers):
            ck, cv = cross_kvs[i]
            x_tok = layer.decode_step(
                x_tok, k_all[i], v_all[i], ck, cv, step, tokens_pad_mask,
                query_is_pad, memory_padding_mask,
            )
        return x_tok
