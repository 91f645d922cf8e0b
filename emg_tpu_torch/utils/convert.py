"""JAX-package variables -> the port's (reference-named) state dict.

``state_dict_from_flax`` is the exact inverse of
``emg_tpu/utils/convert.py::convert_reference_state_dict``: it takes the JAX
package's ``{"params", "batch_stats"}`` tree as numpy arrays and returns
the PyTorch state dict in the reference's key names, which the port's
``EMGModel`` loads with ``load_state_dict``. Conventions converted:

  flax Conv kernel (k, in, out)  -> Conv1d weight (out, in, k)
  flax Dense kernel (in, out)    -> Linear weight (out, in)
  LayerNorm / BatchNorm scale    -> weight
  BatchNorm batch_stats mean/var -> running_mean / running_var
  rel-pos embeddings (H, N, D)   -> (H, N, D, 1)

A conformer encoder (``encoder_kind="conformer"``, recognized by its
layers' ``conv_module``) maps onto the port's names listed in
``models/conformer.py``; its depthwise kernel (k, 1, D) is a Conv kernel
like any other.

``load_adamw_from_flax`` carries the JAX optimizer's moments across too,
so a test can start the port's train step mid-run from a JAX train state.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def _put(sd, key, value):
    # a copy: a JAX array's numpy view is read-only
    sd[key] = torch.from_numpy(np.array(value, dtype=np.float32, order="C"))


def _conv(sd, src, dst):
    _put(sd, dst + ".weight", np.asarray(src["kernel"]).transpose(2, 1, 0))
    _put(sd, dst + ".bias", src["bias"])


def _dense(sd, src, dst):
    _put(sd, dst + ".weight", np.asarray(src["kernel"]).T)
    _put(sd, dst + ".bias", src["bias"])


def _norm(sd, src, dst):
    _put(sd, dst + ".weight", src["scale"])
    _put(sd, dst + ".bias", src["bias"])


def _mha(sd, src, dst, relative: bool):
    for w in ("w_q", "w_k", "w_v", "w_o"):
        _put(sd, f"{dst}.{w}", src[w])
    if relative:
        emb = np.asarray(src["relative_positional"]["embeddings"])
        _put(sd, f"{dst}.relative_positional.embeddings", emb[..., None])


def conv_module_from_flax(cm: Mapping[str, Any], prefix: str = "") -> Dict[str, torch.Tensor]:
    """A JAX conformer ``ConvModule``'s params -> the port's ``ConvModule``
    state dict, its keys under ``prefix``."""
    sd: Dict[str, torch.Tensor] = {}
    _norm(sd, cm["LayerNorm_0"], f"{prefix}norm")
    _dense(sd, cm["pointwise_in"], f"{prefix}pointwise_in")
    _conv(sd, cm["depthwise"], f"{prefix}depthwise")
    _norm(sd, cm["conv_norm"], f"{prefix}conv_norm")
    _dense(sd, cm["pointwise_out"], f"{prefix}pointwise_out")
    return sd


def conformer_block_from_flax(p: Mapping[str, Any], prefix: str = "") -> Dict[str, torch.Tensor]:
    """A JAX ``ConformerBlock``'s params -> the port's ``ConformerBlock``
    state dict (names in ``models/conformer.py``), its keys under
    ``prefix``."""
    sd: Dict[str, torch.Tensor] = {}
    for ff in ("ff1", "ff2"):
        _norm(sd, p[f"{ff}_norm"], f"{prefix}{ff}_norm")
        _dense(sd, p[f"{ff}_in"], f"{prefix}{ff}_in")
        _dense(sd, p[f"{ff}_out"], f"{prefix}{ff}_out")
    _norm(sd, p["attn_norm"], f"{prefix}attn_norm")
    _mha(sd, p["self_attn"], f"{prefix}self_attn", relative=True)
    sd.update(conv_module_from_flax(p["conv_module"], f"{prefix}conv_module."))
    _norm(sd, p["final_norm"], f"{prefix}final_norm")
    return sd


def state_dict_from_flax(variables: Mapping[str, Any], num_layers_encoder: int = 6,
                         num_layers_decoder: int = 6) -> Dict[str, torch.Tensor]:
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    sd: Dict[str, torch.Tensor] = {}

    def bn(src, st, dst):
        _norm(sd, src, dst)
        _put(sd, dst + ".running_mean", st["mean"])
        _put(sd, dst + ".running_var", st["var"])
        sd[dst + ".num_batches_tracked"] = torch.tensor(0, dtype=torch.long)

    cb, cs = params["conv_blocks"], stats["conv_blocks"]
    for i in range(3):
        p, s = cb[f"block{i}"], cs[f"block{i}"]
        base = f"conv_blocks.{i}"
        _conv(sd, p["conv1"], f"{base}.conv1")
        bn(p["bn1"], s["bn1"], f"{base}.bn1")
        _conv(sd, p["conv2"], f"{base}.conv2")
        bn(p["bn2"], s["bn2"], f"{base}.bn2")
        _conv(sd, p["residual_path"], f"{base}.residual_path")
        bn(p["res_norm"], s["res_norm"], f"{base}.res_norm")

    _dense(sd, params["w_raw_in"], "w_raw_in")
    _put(sd, "embedding_tgt.weight", params["embedding_tgt"]["embedding"])

    for i in range(num_layers_encoder):
        p = params["transformerEncoder"][f"layer{i}"]
        base = f"transformerEncoder.layers.{i}"
        if "conv_module" in p:  # a conformer block
            sd.update(conformer_block_from_flax(p, f"{base}."))
            continue
        _mha(sd, p["self_attn"], f"{base}.self_attn", relative=True)
        _dense(sd, p["ff"]["linear1"], f"{base}.linear1")
        _dense(sd, p["ff"]["linear2"], f"{base}.linear2")
        _norm(sd, p["norm1"], f"{base}.norm1")
        _norm(sd, p["norm2"], f"{base}.norm2")

    for i in range(num_layers_decoder):
        p = params["transformerDecoder"][f"layer{i}"]
        base = f"transformerDecoder.layers.{i}"
        _mha(sd, p["self_attn"], f"{base}.self_attn", relative=False)
        _mha(sd, p["multihead_attn"], f"{base}.multihead_attn", relative=False)
        _dense(sd, p["ff"]["linear1"], f"{base}.linear1")
        _dense(sd, p["ff"]["linear2"], f"{base}.linear2")
        _norm(sd, p["norm1"], f"{base}.norm1")
        _norm(sd, p["norm2"], f"{base}.norm2")
        _norm(sd, p["norm3"], f"{base}.norm3")

    _dense(sd, params["w_aux"], "w_aux")
    _dense(sd, params["w_out"], "w_out")
    return sd


def load_adamw_from_flax(optimizer: torch.optim.Optimizer, model: torch.nn.Module,
                         opt_state: Any, batch_stats: Mapping[str, Any],
                         num_layers_encoder: int = 6, num_layers_decoder: int = 6) -> None:
    """Carry the JAX package's ``fused_adamw`` state (``count``, ``mu``,
    ``nu``, each moment a params-shaped tree) into the port's AdamW, in
    place, so a run can continue from a JAX train state. The moments map
    to parameters through the same names as ``state_dict_from_flax``."""

    def as_state_dict(tree):
        return state_dict_from_flax({"params": tree, "batch_stats": batch_stats},
                                    num_layers_encoder, num_layers_decoder)

    mu, nu = as_state_dict(opt_state.mu), as_state_dict(opt_state.nu)
    step = float(np.asarray(opt_state.count))
    for name, p in model.named_parameters():
        optimizer.state[p] = {
            "step": torch.tensor(step),
            "exp_avg": mu[name].to(p.device),
            "exp_avg_sq": nu[name].to(p.device),
        }
