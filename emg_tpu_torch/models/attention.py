"""Multi-head attention with learned relative positional logits.

Counterpart of ``emg_tpu/models/attention.py``, itself a re-design of the
reference's MultiHeadAttention + LearnedRelativePositionalEmbedding
(transformer.py:137-403): per-head projection tensors in (H, D, Dh) /
(H, Dh, D) layout, additive -1e8 masking, and for encoder self-attention a
per-head table of 2*maxpos-1 learned relative-position embeddings. All
shapes are batch-first (B, T, D).

With ``use_flash`` (the transformer encoder under
``model.use_flash_attention``, the default), encoder self-attention goes
through the fused kernels: in eval mode ``ops.flash_attention_relpos``
(serving), in train mode ``ops.flash_attention_relpos_train`` (forward and
backward kernels, with the attention dropout inside them); on the CPU both
are their plain versions. Every other attention is the JAX package's
unfused path in plain tensor code: the logits, the causal mask, -1e8 at key
pads and then at query pads, and only then the relative logits
(``LearnedRelativePositionalBias.forward``, skewed by
``relative_to_absolute``), so a masked logit is -1e8 + rel, as in JAX. That
path serves the decoder, the conformer (whose attention JAX never fuses)
and the transformer encoder under ``use_flash_attention=false``.

Train mode (``module.train()``) applies the reference's dropouts. Every
random draw comes from the ``torch.Generator`` the caller passes down (on
the activations' device), so a run is a function of its generator's seed.

On a device mesh (``parallel/mesh.py::shard_params`` sets ``mesh``) a
layer holds H / model of the heads, from ``head_offset`` on, and the
rank's batch rows: it returns its heads' partial output projection, which
the caller sums over the model axis. Its dropout masks are the unsharded
layer's, sliced: the probabilities' drawn at the global (B, H, ...) shape,
the fused kernels' hashed at global (b, h). The relative-position table
stays whole on every rank; a rank uses its heads' rows.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from emg_tpu_torch.ops.flash_attention import flash_attention_relpos, flash_attention_relpos_train
from emg_tpu_torch.utils.quantize import weight_as

NEG_FILL = -1e8  # reference masked_fill value
STRUCT_MASK = float("-inf")  # structural (not-yet-generated) positions
ATTN_TILE = 128  # encoder self-attention pads T up to a multiple of this


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator],
            training: bool, shard=()) -> torch.Tensor:
    """Inverted dropout (flax ``nn.Dropout`` semantics: keep with
    probability 1 - rate, scale kept values by 1 / (1 - rate)), its mask
    drawn from ``generator``. The identity outside training or at rate 0.

    ``shard`` lists (dim, start, global size) for each dim in which x is a
    mesh rank's slice of the tensor the unsharded model drops: the mask is
    drawn at the global shape and sliced, so every rank draws the same
    numbers as one device and keeps its part of them."""
    if not training or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("train-mode dropout needs a torch.Generator")
    shape = list(x.shape)
    for dim, _, size in shard:
        shape[dim] = size
    keep = torch.rand(shape, generator=generator, device=x.device) >= rate
    for dim, start, _ in shard:
        keep = keep.narrow(dim, start, x.shape[dim])
    return torch.where(keep, x / (1.0 - rate), 0.0)


def draw_seed(generator: Optional[torch.Generator], device) -> torch.Tensor:
    """A one-element int32 tensor of 32 random bits: the attention
    dropout's hash seed, drawn on the device with no host sync."""
    if generator is None:
        raise ValueError("train-mode attention dropout needs a torch.Generator")
    return torch.randint(-2 ** 31, 2 ** 31, (1,), generator=generator, device=device,
                         dtype=torch.int64).to(torch.int32)


def relative_to_absolute(x: torch.Tensor) -> torch.Tensor:
    """(B, H, L, 2L-1) relative logits -> (B, H, L, L) absolute logits,
    out[b,h,q,k] = x[b,h,q, k-q+L-1], by the pad/reshape skew of
    ``emg_tpu/models/attention.py::relative_to_absolute``."""
    B, H, L, W = x.shape
    if W != 2 * L - 1:
        raise ValueError(f"relative logits of width {W} for length {L}")
    x = nn.functional.pad(x, (0, 1)).reshape(B, H, L * 2 * L)
    x = nn.functional.pad(x, (0, L - 1)).reshape(B, H, L + 1, 2 * L - 1)
    return x[:, :, :L, L - 1 :]


class LearnedRelativePositionalBias(nn.Module):
    """Unmasked (encoder) relative positional logits. The parameter keeps
    the reference's (H, 2*maxpos-1, Dh, 1) shape, so reference checkpoints
    load as they are."""

    def __init__(self, max_relative_pos: int, num_heads: int, head_dim: int):
        super().__init__()
        self.max_relative_pos = max_relative_pos
        self.embeddings = nn.Parameter(
            torch.zeros(num_heads, 2 * max_relative_pos - 1, head_dim, 1)
        )

    def window(self, L: int, heads: slice = slice(None)):
        """The length-L window: (H, 2L-1, Dh) table slice plus a (2L-1,)
        additive out-of-range mask (0 / NEG_FILL); with ``heads``, only
        those heads' rows (a mesh rank's).

        The table covers relative positions [-(maxpos-1), maxpos-1]; a query
        of length L needs [-(L-1), L-1]: zero-pad or slice to fit.
        """
        table = self.embeddings[heads, ..., 0]
        pad = max(L - self.max_relative_pos, 0)
        start = max(self.max_relative_pos - L, 0)
        padded = nn.functional.pad(table, (0, 0, pad, pad))
        used = padded[:, start : start + 2 * L - 1]
        m = torch.arange(2 * L - 1, device=table.device)
        oob = torch.where((m < pad) | (m >= 2 * L - 1 - pad), NEG_FILL, 0.0).to(torch.float32)
        return used, oob

    def forward(self, q: torch.Tensor, heads: slice = slice(None)) -> torch.Tensor:
        """q: (B, H, L, Dh) projected queries of the table's ``heads`` ->
        (B, H, L, L) relative logits at q's dtype; the out-of-range mask
        enters only where the window outgrows the table (L >
        max_relative_pos), as in JAX."""
        L = q.shape[2]
        used, oob = self.window(L, heads)
        rel = torch.einsum("bhld,hmd->bhlm", q, used.to(q.dtype))
        if L > self.max_relative_pos:
            rel = rel + oob.to(q.dtype)
        return relative_to_absolute(rel)


class MultiHeadAttention(nn.Module):
    mesh = None  # the device mesh, set by parallel/mesh.py::shard_params
    head_offset = 0  # the first of this rank's heads (num_heads of them)

    def __init__(self, d_model: int, num_heads: int, relative_positional: bool = False,
                 relative_positional_distance: int = 100, dropout: float = 0.0,
                 use_flash: bool = False):
        super().__init__()
        self.dropout = dropout
        self.use_flash = use_flash
        H = num_heads
        Dh = d_model // H
        if Dh * H != d_model:
            raise ValueError(f"d_model {d_model} does not split into {H} heads")
        self.num_heads = H
        self.head_dim = Dh
        self.w_q = nn.Parameter(torch.zeros(H, d_model, Dh))
        self.w_k = nn.Parameter(torch.zeros(H, d_model, Dh))
        self.w_v = nn.Parameter(torch.zeros(H, d_model, Dh))
        self.w_o = nn.Parameter(torch.zeros(H, Dh, d_model))
        self.relative_positional = (
            LearnedRelativePositionalBias(relative_positional_distance, H, Dh)
            if relative_positional else None
        )

    # -- projections -------------------------------------------------------
    def project_q(self, x: torch.Tensor) -> torch.Tensor:
        return torch.einsum("btf,hfa->bhta", x, weight_as(self.w_q, x.dtype))

    def project_kv(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        w = torch.cat([weight_as(self.w_k, x.dtype), weight_as(self.w_v, x.dtype)])  # (2H, D, Dh)
        kv = torch.einsum("btf,hfa->bhta", x, w)
        return kv[:, : self.num_heads], kv[:, self.num_heads :]

    def project_qkv(self, x: torch.Tensor):
        w = torch.cat([weight_as(w, x.dtype) for w in (self.w_q, self.w_k, self.w_v)])  # (3H, D, Dh)
        qkv = torch.einsum("btf,hfa->bhta", x, w)
        H = self.num_heads
        return qkv[:, :H], qkv[:, H : 2 * H], qkv[:, 2 * H :]

    def output(self, o: torch.Tensor) -> torch.Tensor:
        return torch.einsum("bhta,haf->btf", o, weight_as(self.w_o, o.dtype))

    # -- full path ---------------------------------------------------------
    def forward(
        self,
        query: torch.Tensor,  # (B, Tq, D)
        key: torch.Tensor,  # (B, Tk, D)
        *,
        key_padding_mask: Optional[torch.Tensor] = None,  # (B, Tk) True=pad
        query_padding_mask: Optional[torch.Tensor] = None,  # (B, Tq) True=pad
        causal: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        if key is query:  # self-attention: one fused projection matmul
            q, k, v = self.project_qkv(query)
        else:
            q = self.project_q(query)
            k, v = self.project_kv(key)

        heads = slice(self.head_offset, self.head_offset + self.num_heads)
        b_off, shard = 0, ()
        if self.mesh is not None:
            B = q.shape[0]
            b_off = self.mesh.data_index * B
            shard = self.mesh.batch_shard(B) + self.mesh.model_shard(self.num_heads, dim=1)
        if self.use_flash and self.relative_positional is not None and not causal:
            seed = None
            if self.training:
                # at rate 0 no seed is drawn, as the JAX package draws none
                seed = (draw_seed(generator, q.device) if self.dropout > 0.0
                        else torch.zeros(1, dtype=torch.int32, device=q.device))
            o = relpos_self_attention(q, k, v, self.relative_positional, key_padding_mask,
                                      self.dropout, seed, heads, b_off, self.head_offset)
            return self.output(o.to(query.dtype))

        logits = torch.einsum("bhqa,bhka->bhqk", q, k) / (self.head_dim ** 0.5)
        if causal:
            Tq, Tk = logits.shape[2], logits.shape[3]
            cmask = torch.ones((Tq, Tk), dtype=torch.bool, device=q.device).tril()
            logits = torch.where(cmask[None, None], logits, NEG_FILL)
        if key_padding_mask is not None:
            logits = torch.where(key_padding_mask[:, None, None, :], NEG_FILL, logits)
        if query_padding_mask is not None:
            logits = torch.where(query_padding_mask[:, None, :, None], NEG_FILL, logits)
        if self.relative_positional is not None:
            logits = logits + self.relative_positional(q, heads)
        probs = torch.softmax(logits, dim=-1)
        probs = dropout(probs, self.dropout, generator, self.training, shard)
        o = torch.einsum("bhqk,bhka->bhqa", probs, v)
        return self.output(o)

    # -- incremental path --------------------------------------------------
    def attend_step(
        self,
        q: torch.Tensor,  # (B, H, 1, Dh) projected query of the current token
        k_cache: torch.Tensor,  # (B, H, S, Dh), row ``step`` already written
        v_cache: torch.Tensor,
        valid_mask: torch.Tensor,  # (B or 1, S) True where the key exists
        pad_mask: torch.Tensor,  # (B, S) True where the key is a PAD token
        query_is_pad: torch.Tensor,  # (B,) current token is PAD
    ) -> torch.Tensor:
        """One-token attention over cached keys/values, reproducing the
        reference's full-prefix masks: keys not yet generated are
        structurally excluded (-inf, probability 0); PAD keys and PAD
        queries get -1e8 (softmax ties, as the reference's masked_fill).
        Logits accumulate in float32 so the softmax stays exact when the
        caches are bfloat16."""
        logits = torch.einsum(
            "bhqa,bhka->bhqk", q.float(), k_cache.float()
        ) / (self.head_dim ** 0.5)
        logits = torch.where(pad_mask[:, None, None, :], NEG_FILL, logits)
        logits = torch.where(query_is_pad[:, None, None, None], NEG_FILL, logits)
        logits = torch.where(valid_mask[:, None, None, :], logits, STRUCT_MASK)
        probs = torch.softmax(logits, dim=-1).to(v_cache.dtype)
        o = torch.einsum("bhqk,bhka->bhqa", probs, v_cache)
        return self.output(o)


def relpos_self_attention(q, k, v, relpos: LearnedRelativePositionalBias,
                          key_padding_mask: Optional[torch.Tensor],
                          dropout_rate: float = 0.0,
                          seed: Optional[torch.Tensor] = None,
                          heads: slice = slice(None), b_off: int = 0,
                          h_off: int = 0) -> torch.Tensor:
    """Encoder self-attention through the fused kernels. q, k, v:
    (B, H, T, Dh) of the table's ``heads``. Returns (B, H, T, Dh) float32.
    With ``seed`` (a one-element int32 tensor) it is the differentiable
    training attention with ``dropout_rate`` on the probabilities, its
    dropout hash at batch b_off + b and head h_off + h (a mesh rank's
    offsets); without, the serving one.

    T is padded up to a multiple of ATTN_TILE (192 -> 256): pad keys are
    masked, pad query rows sliced off, and the relative window is taken at
    the padded length, so valid rows are exact. Only key pads enter the
    kernel; query-pad rows come out unmasked (see ops/flash_attention.py).
    Gradients reach the relative-position table through the window's pad
    and slice.
    """
    B, H, T, Dh = q.shape
    Tp = -(-T // ATTN_TILE) * ATTN_TILE
    kp = (key_padding_mask if key_padding_mask is not None
          else torch.zeros((B, T), dtype=torch.bool, device=q.device))
    if Tp != T:
        pad = (0, 0, 0, Tp - T)
        q, k, v = (nn.functional.pad(t, pad) for t in (q, k, v))
        kp = nn.functional.pad(kp, (0, Tp - T), value=True)
    used, oob = relpos.window(Tp, heads)
    if seed is None:
        o = flash_attention_relpos(q, k, v, used.to(q.dtype), oob, kp)
    else:
        o = flash_attention_relpos_train(q, k, v, used.to(q.dtype), oob, kp, dropout_rate, seed,
                                         b_off, h_off)
    return o[:, :, :T]
