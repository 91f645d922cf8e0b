"""The EMG-to-phoneme model: ResBlock CNN subsampler + transformer or
conformer encoder, transformer decoder, dual CTC/CE heads.

Counterpart of ``emg_tpu/models/model.py`` (reference Model,
architecture.py:50-188): raw-EMG packed rows -> stride-8 CNN -> linear ->
per-utterance re-batching (a gather replaces the reference's
decollate_tensor + pad_sequence) -> relative-positional encoder -> CTC
head; target embedding (+1/d-scaled sinusoidal PE) -> causal transformer
decoder with cross-attention -> CE head. The encoder is
``models/transformer.py::TransformerEncoder`` (its self-attention fused
under ``use_flash_attention``, unfused otherwise) or, for
``encoder_kind="conformer"``, ``models/conformer.py::ConformerEncoder``;
either is ``transformerEncoder``, reached only through
``transformerEncoder(src, mask, generator)``.

Train mode (``model.train()``): BatchNorm takes batch statistics over the
valid packed rows, the dropouts of ``dropout_model`` / ``dropout_pos_emb``
apply, and the packed rows are shifted left by a random r in [0, 8)
samples (reference architecture.py:104-107). Every draw comes from the
``torch.Generator`` passed to ``forward`` (on the model's device).

Parameters are float32 and carry the reference's state-dict names, so a
reference ``.pt`` file (or ``utils/convert.py::state_dict_from_flax`` of the
JAX package's variables) loads with ``load_state_dict``. With
``compute_dtype="bfloat16"`` activations run at bfloat16 with parameters
cast at use; ``w_aux`` and ``w_out`` run in float32 and the memory returns
to float32 after the encoder, as in the JAX package (the conformer runs
float32 throughout, see ``models/conformer.py``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from emg_tpu_torch.config import ModelConfig
from emg_tpu_torch.models.conformer import ConformerEncoder
from emg_tpu_torch.models.positional import PositionalEncoding
from emg_tpu_torch.models.resnet import ConvStack, MaskedBatchNorm
from emg_tpu_torch.models.transformer import TransformerDecoder, TransformerEncoder, linear
from emg_tpu_torch.runtime import compute_dtype, resolve_device
from emg_tpu_torch.text.phonemes import N_PHONES, PAD_ID

NUM_OUTS_DEC = N_PHONES  # 43
NUM_OUTS_ENC = N_PHONES + 1  # 44, extra class is the CTC blank


def shift_rows(x: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Shift each packed row (N, L, C) left by r samples, zero-filling the
    tail. ``r`` is a one-element integer tensor on x's device, so the shift
    needs no host sync; r = 0 is the identity."""
    L = x.shape[1]
    idx = torch.arange(L, device=x.device) + r
    shifted = x[:, idx.clamp(max=L - 1)]
    return torch.where((idx < L)[None, :, None], shifted, 0.0)


def draw_shift(generator: torch.Generator, device) -> torch.Tensor:
    """The train-time shift r in [0, 8), a one-element tensor on ``device``."""
    return torch.randint(0, 8, (1,), generator=generator, device=device)


def gather_utterances(flat: torch.Tensor, offsets: torch.Tensor, lengths: torch.Tensor, T: int):
    """(total_frames, D) -> (B, T, D) per-utterance gather + padding mask.

    Utterance b occupies rows [offsets[b], offsets[b]+lengths[b]) of the
    concatenated post-CNN frame stream. Returns (batched, padding_mask)
    where padding_mask is True at padded positions.
    """
    pos = torch.arange(T, device=flat.device)[None, :]
    idx = (offsets[:, None] + pos).clamp(0, flat.shape[0] - 1)
    valid = pos < lengths[:, None]
    out = flat[idx]  # (B, T, D)
    out = torch.where(valid[:, :, None], out, 0.0)
    return out, ~valid


class EMGModel(nn.Module):
    """The full model, built on ``device`` (default ``"cuda"``; raises
    without a card unless ``"cpu"`` is asked for). Weights are drawn from
    ``generator`` (default: a ``torch.Generator`` seeded with 0) on the CPU,
    so one seed gives the same model on every device.

    On a device mesh (``parallel/mesh.py::shard_params``) the packed rows
    and the utterances are the rank's blocks of the batch: the CNN runs on
    its rows, its output is all-gathered over the data axis, and the rank
    takes its utterances by their global offsets; the encoder and decoder
    split heads and feed-forwards over the model axis, and under
    ``sequence_shard`` the encoder stream's time too. ``cfg.sequence_shard``
    acts only there, with a model axis over 1 (as in the JAX package, which
    applies it through the mesh); on one device it changes nothing."""

    mesh = None  # the device mesh, set by parallel/mesh.py::shard_params

    def __init__(self, cfg: ModelConfig, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.remat:
            raise NotImplementedError("remat (rematerialized encoder layers) is not yet ported")
        device = resolve_device(device)
        self.cfg = cfg
        self.dtype = compute_dtype(cfg.compute_dtype)
        D = cfg.model_size
        self.conv_blocks = ConvStack(cfg.num_channels, D)
        self.w_raw_in = nn.Linear(D, D)
        self.embedding_tgt = nn.Embedding(NUM_OUTS_DEC, D)
        self.pos_decoder = PositionalEncoding(
            D, index_axis="batch" if cfg.decoder_pe == "reference_batch" else "position",
            dropout=cfg.dropout_pos_emb,
        )
        if cfg.encoder_kind == "conformer":
            self.transformerEncoder = ConformerEncoder(
                cfg.num_layers_encoder, D, cfg.n_heads_encoder, cfg.feed_forward_layer_size,
                cfg.relative_distance, cfg.dropout_model, cfg.conformer_conv_kernel_size,
            )
        else:
            self.transformerEncoder = TransformerEncoder(
                cfg.num_layers_encoder, D, cfg.n_heads_encoder, cfg.feed_forward_layer_size,
                cfg.relative_distance, cfg.dropout_model, cfg.use_flash_attention,
            )
        self.transformerDecoder = TransformerDecoder(
            cfg.num_layers_decoder, D, cfg.n_heads_decoder, cfg.feed_forward_layer_size,
            cfg.dropout_model,
        )
        self.w_aux = nn.Linear(D, NUM_OUTS_ENC)
        self.w_out = nn.Linear(D, NUM_OUTS_DEC)
        self.init_weights(generator if generator is not None else torch.Generator().manual_seed(0))
        self.to(device)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Random weights in the JAX package's families: fan-in scaled
        normals for convs and dense layers, xavier-normal per-head attention
        tensors, unit-normal embeddings, identity norms. Drawn in a fixed
        order on the CPU."""
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if isinstance(self.get_submodule(name.rsplit(".", 1)[0]), (nn.LayerNorm, MaskedBatchNorm)):
                p.fill_(1.0 if leaf == "weight" else 0.0)
            elif leaf == "bias":
                p.zero_()
            elif leaf in ("w_q", "w_k", "w_v", "w_o"):
                # torch xavier_normal_ on (H, Din, Dout): receptive field Dout
                std = (2.0 / ((p.shape[1] + p.shape[0]) * p.shape[2])) ** 0.5
                p.copy_(torch.randn(p.shape, generator=generator) * std)
            elif leaf == "embeddings":  # relative positions: std Dh^-0.5
                p.copy_(torch.randn(p.shape, generator=generator) * p.shape[2] ** -0.5)
            elif name == "embedding_tgt.weight":
                p.copy_(torch.randn(p.shape, generator=generator))
            else:  # conv (out, in, k), depthwise (D, 1, k) and linear (out, in)
                fan_in = p[0].numel()
                p.copy_(torch.randn(p.shape, generator=generator) * fan_in ** -0.5)

    @property
    def device(self) -> torch.device:
        return self.w_out.weight.device

    # -- encoder path ------------------------------------------------------
    def encode(
        self,
        packed_raw: torch.Tensor,  # (N, chunk, C)
        n_rows: int,  # valid packed rows
        offsets: torch.Tensor,  # (B,)
        lengths: torch.Tensor,  # (B,)
        max_frames: int,  # T of the re-batched encoder input
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Returns (memory (B,T,D) float32, enc_logits (B,T,44), src_pad_mask (B,T)).
        In train mode the rows shift by an r in [0, 8) drawn from
        ``generator``."""
        x = packed_raw
        if self.training:
            if generator is None:
                raise ValueError("train mode needs a torch.Generator for the time shift")
            x = shift_rows(x, draw_shift(generator, x.device))
        x = self.conv_blocks(x, n_rows, self.dtype)
        x = linear(self.w_raw_in, x)  # (N, chunk/8, D)
        if self.mesh is not None:
            # every data rank's rows: the utterances' offsets are global
            x = self.mesh.gather_data(x)
        flat = x.reshape(-1, x.shape[-1])
        src, src_pad_mask = gather_utterances(flat, offsets, lengths, max_frames)
        memory = self.transformerEncoder(src.to(self.dtype), src_pad_mask, generator).float()
        return memory, self.w_aux(memory), src_pad_mask

    # -- decoder path ------------------------------------------------------
    def _embed_targets(self, y: torch.Tensor) -> torch.Tensor:
        # torch padding_idx semantics: the PAD row is pinned to zero (and
        # gets no gradient). A mask, not an index tensor built per call: a
        # decode step copies nothing from the host.
        return F.embedding(y, self.embedding_tgt.weight).masked_fill((y == PAD_ID)[..., None], 0.0)

    def decode(self, y: torch.Tensor, memory: torch.Tensor,
               memory_pad_mask: torch.Tensor,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Teacher-forced decoder: y (B, S) ids -> dec_logits (B, S, 43)."""
        tgt = self.pos_decoder(self._embed_targets(y), generator)
        out = self.transformerDecoder(
            tgt.to(self.dtype), memory.to(self.dtype), y == PAD_ID, memory_pad_mask, generator,
        )
        return self.w_out(out.float())

    def forward(self, packed_raw, n_rows: int, offsets, lengths, y, max_frames: int,
                generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Training/eval forward: returns (enc_logits, dec_logits)."""
        memory, enc_logits, src_pad_mask = self.encode(
            packed_raw, n_rows, offsets, lengths, max_frames, generator,
        )
        return enc_logits, self.decode(y, memory, src_pad_mask, generator)

    def project_cross_kvs(self, memory: torch.Tensor):
        """Per-decoder-layer memory K/V at the compute dtype, computed once
        per utterance."""
        return self.transformerDecoder.project_cross_kvs(memory.to(self.dtype))

    def init_decode_cache(self, batch_size: int, max_len: int):
        """Zeroed self-attention K/V caches (k_all, v_all), each
        (L, B, H, S, Dh) at the compute dtype."""
        L = self.cfg.num_layers_decoder
        H = self.cfg.n_heads_decoder
        Dh = self.cfg.model_size // H
        shape = (L, batch_size, H, max_len, Dh)
        return (
            torch.zeros(shape, dtype=self.dtype, device=self.device),
            torch.zeros(shape, dtype=self.dtype, device=self.device),
        )

    def decode_step(
        self,
        token_ids: torch.Tensor,  # (B,) current input token
        step,  # its position: an int, or an int64 tensor of shape () or (B,)
        caches,  # (k_all, v_all), updated in place
        cross_kvs,  # per-layer (cross_k, cross_v)
        tokens: torch.Tensor,  # (B, S) all tokens so far (for PAD masking)
        memory_pad_mask: torch.Tensor,  # (U, T)
        pe_period: Optional[int] = None,
    ) -> torch.Tensor:
        """One incremental decode step; returns logits (B, 43) float32.

        The memory (``cross_kvs``, ``memory_pad_mask``) holds U utterances,
        U dividing B: decode rows [u*R, (u+1)*R) attend to utterance u, R =
        B // U (U = B for greedy decoding, U = 1 for one utterance's beam).
        Under ``decoder_pe="reference_batch"`` row b adds pe[b mod
        pe_period] (default B: pe[b]); a beam over U utterances of W rows
        each passes W, so each utterance's rows see pe[0..W-1] as they do
        alone.

        A tensor ``step`` is read only on the device (the cache row written,
        the causal mask, pe[step]), so a CUDA graph of this step replays at
        every position; an int is made such a tensor, so both give the same
        bits. A (B,) ``step`` puts each row at its own position (the beam's
        lanes), in [0, S)."""
        step = torch.as_tensor(step, dtype=torch.int64, device=token_ids.device)
        x = self._embed_targets(token_ids)[:, None, :]  # (B, 1, D)
        pe = self.pos_decoder.table
        if self.cfg.decoder_pe == "reference_batch":
            # constant pe[row] per batch row (see PositionalEncoding)
            B = x.shape[0]
            period = B if pe_period is None else pe_period
            x = x + (1.0 / self.cfg.model_size) * pe[:period].repeat(B // period, 1)[:, None, :]
        else:
            x = x + (1.0 / self.cfg.model_size) * pe.index_select(0, step.reshape(-1))[:, None]
        out = self.transformerDecoder.decode_step(
            x.to(self.dtype), caches, cross_kvs, step, tokens == PAD_ID,
            token_ids == PAD_ID, memory_pad_mask,
        )
        return self.w_out(out[:, 0].float())
