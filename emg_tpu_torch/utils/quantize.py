"""int8 weights for the decoder stack, which decoding re-reads every step.

Counterpart of ``emg_tpu/utils/quantize.py``. ``quantize_decoder_int8``
returns a copy of the model in which the ``transformerDecoder`` stack's
matmul weights (the attention tensors ``w_q``/``w_k``/``w_v``/``w_o`` and
the feed-forward ``linear1``/``linear2`` weights) are held as
:class:`Int8Weight`: int8 data with a float32 scale per output channel.
Biases, LayerNorms, embeddings, the relative-position table, the logit
heads (``w_aux``/``w_out``) and the encoder are never quantized: the encoder
runs once per utterance, the decoder once per token.

Scaling is symmetric per output channel, reduced over the contraction
axis: ``scale = max(max|w|, 1e-12) / 127`` and ``data = clip(round(w /
scale), -127, 127)`` (round half to even, as ``jnp.round``), so each
channel's error is at most half an LSB of its own range. The attention
tensors (H, Din, Dout) and (H, Dh, D) reduce over dim 1, as in JAX; a
``nn.Linear`` weight is (Dout, Din), the transpose of JAX's Dense kernel,
so it reduces over dim 1 where JAX reduces over axis 0.

The modules read every matmul weight through :func:`weight_as`, which
dequantizes an ``Int8Weight`` as JAX's ``Int8Tensor.__jax_array__`` does,
``data.to(bf16) * scale.to(bf16)`` (a bfloat16 product), and then casts to
the activation dtype. The dequantization is plain PyTorch, as it is XLA
ops in JAX (fused into each matmul's operand read there, not Pallas).
"""

from __future__ import annotations

import copy

import torch
from torch import nn

# leaf names quantized inside the decoder stack
_ATTN_LEAVES = {"w_q", "w_k", "w_v", "w_o"}  # (H, Din, Dout): reduce dim 1
_DENSE_MODULES = {"linear1", "linear2"}  # nn.Linear weight (Dout, Din): reduce dim 1


class Int8Weight(nn.Module):
    """An int8 weight and its float32 per-output-channel ``scale`` (keepdim
    over the contraction axis), as buffers, so that they move with the
    model. ``dequantize`` gives it at ``dequant_dtype``."""

    def __init__(self, data: torch.Tensor, scale: torch.Tensor,
                 dequant_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.register_buffer("data", data)
        self.register_buffer("scale", scale)
        self.dequant_dtype = dequant_dtype

    def dequantize(self) -> torch.Tensor:
        dt = self.dequant_dtype
        return self.data.to(dt) * self.scale.to(dt)

    def extra_repr(self) -> str:
        return f"shape={tuple(self.data.shape)}, dequant={self.dequant_dtype}"


def weight_as(w, dtype: torch.dtype) -> torch.Tensor:
    """A matmul weight at ``dtype``: a float one cast, an ``Int8Weight``
    dequantized first."""
    if isinstance(w, Int8Weight):
        w = w.dequantize()
    return w.to(dtype)


def quantize_tensor(w: torch.Tensor, dim: int,
                    dequant_dtype: torch.dtype = torch.bfloat16) -> Int8Weight:
    """Symmetric per-output-channel int8 quantization of one weight,
    reduced over ``dim`` (the contraction axis)."""
    w = w.detach().float()
    amax = w.abs().amax(dim=dim, keepdim=True)
    scale = amax.clamp(min=1e-12) / 127.0
    data = torch.round(w / scale).clamp(-127, 127).to(torch.int8)
    return Int8Weight(data, scale, dequant_dtype)


def _float_targets(model: nn.Module):
    """The dotted names of the decoder's matmul weights still held as float
    parameters (an ``Int8Weight`` holds buffers, not parameters)."""
    for name, _ in model.transformerDecoder.named_parameters(prefix="transformerDecoder"):
        names = name.split(".")
        if names[-1] in _ATTN_LEAVES or (names[-2] in _DENSE_MODULES and names[-1] == "weight"):
            yield name


def quantize_decoder_int8(model: nn.Module, dequant_dtype: torch.dtype = torch.bfloat16) -> nn.Module:
    """A copy of ``model`` whose decoder matmul weights are ``Int8Weight``s.
    Every other parameter and every buffer is shared with ``model``, which
    is left as it was. A model with nothing left to quantize is returned as
    it is, so the function is idempotent."""
    todo = list(_float_targets(model))
    if not todo:
        return model
    memo = {id(t): t for t in (*model.parameters(), *model.buffers())}
    out = copy.deepcopy(model, memo)
    for name in todo:
        mname, leaf = name.rsplit(".", 1)
        module = out.get_submodule(mname)
        w = getattr(module, leaf)
        delattr(module, leaf)
        setattr(module, leaf, quantize_tensor(w, 1, dequant_dtype))
    return out
