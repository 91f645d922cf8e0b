"""Serving-time parameter casting.

Counterpart of ``emg_tpu/utils/serving.py``. The port's modules cast their
matmul and conv weights to the activation dtype at every use
(``linear`` and ``_conv`` cast weight and bias, the attention projections
cast ``w_q``/``w_k``/``w_v``/``w_o``). Inside a decode loop that cast is
loop-invariant work: a kernel per weight per step that reads the float32
copy and writes a bfloat16 one. Casting the affected parameters ONCE,
before the loop, turns the per-use casts into no-ops without changing
numerics: the matmuls see bit-identical bfloat16 weights either way.

Only the big matmul/conv operands are cast. LayerNorm/BatchNorm parameters
and statistics, embeddings, the relative-positional table, and the output
heads (``w_aux``/``w_out`` run float32 by design) keep float32.

The conformer is the exception to "numerics unchanged", in JAX as here:
its attention projections are cast with every other ``w_q``/``w_k``/
``w_v``/``w_o``, but the conformer runs float32 (``models/conformer.py``),
so its projections upcast the bfloat16-ROUNDED weights. The cast set is
kept identical to the JAX package's, conformer included, so the two beams
see the same weights.
"""

from __future__ import annotations

import copy

import torch
from torch import nn

# leaf names cast when reached through an attention or feed-forward module
_ATTN_LEAVES = {"w_q", "w_k", "w_v", "w_o"}
_DENSE_MODULES = {"linear1", "linear2", "w_raw_in"}
_CONV_MODULES = {"conv1", "conv2", "residual_path"}


def serving_hot(name: str) -> bool:
    """Whether the parameter called ``name`` (a dotted state-dict key) is
    one the modules cast to the activation dtype at every use."""
    names = name.split(".")
    return names[-1] in _ATTN_LEAVES or (
        len(names) >= 2 and names[-2] in _DENSE_MODULES | _CONV_MODULES
    )


def cast_params_for_serving(model: nn.Module, dtype=torch.bfloat16) -> nn.Module:
    """A copy of ``model`` whose serving-hot weights (``serving_hot``) are
    cast to ``dtype``, for inference only. Every other parameter and every
    buffer is shared with ``model``, which is left as it was. A model whose
    serving-hot weights already have ``dtype`` is returned as it is. An int8
    weight (``utils/quantize.py::Int8Weight``) holds buffers, not
    parameters, so it stays as it is, as the JAX package skips its
    ``Int8Tensor`` leaves."""
    hot = {name: p for name, p in model.named_parameters() if serving_hot(name)}
    if all(p.dtype == dtype for p in hot.values()):
        return model
    hot_ids = {id(p) for p in hot.values()}
    memo = {}
    for p in model.parameters():
        memo[id(p)] = (nn.Parameter(p.detach().to(dtype), requires_grad=False)
                       if id(p) in hot_ids else p)
    for b in model.buffers():
        memo[id(b)] = b
    return copy.deepcopy(model, memo)
