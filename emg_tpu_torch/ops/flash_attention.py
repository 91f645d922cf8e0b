"""Encoder self-attention with a learned relative-position bias: CUDA
kernel, plain version, wrapper.

Counterpart of the Pallas TPU kernel ``emg_tpu/ops/pallas/
flash_attention.py::flash_attention_relpos`` (the serving forward):

    out = softmax(q k^T / sqrt(Dh) + R + keypad) v,
    R[i, j] = q_i . used[j - i + T - 1] + oob[j - i + T - 1]

with float32 accumulation and a float32 output. ``used`` (H, 2T-1, Dh) and
``oob`` (2T-1,) are the relative window of ``LearnedRelativePositionalBias.
window(T)``. Padded keys get -1e8 ADDED to their logit (the TPU kernel's
semantics); padded query rows are not masked, and their outputs are
meaningless: callers drop them.

On the card it is the kernel in ``csrc/flash_attention_relpos.cu`` (the
source says what bounds it: operations). On a CPU tensor it is the plain
version below, which builds the full (B, H, T, T) logits.
"""

from __future__ import annotations

import torch

from emg_tpu_torch.ops import build

NEG_FILL = -1e8
KEY_TILE = 64  # the kernel's key tile: T must be a multiple of it
MAX_HEAD_DIM = 128


def relative_index(T: int, device) -> torch.Tensor:
    """(T, T) index j - i + T - 1 of the relative window for query i, key j."""
    pos = torch.arange(T, device=device)
    return pos[None, :] - pos[:, None] + T - 1


def flash_attention_relpos_plain(q, k, v, used, oob, key_pad):
    """The plain PyTorch version of the kernel (any device): the same
    arithmetic with the whole (B, H, T, T) logits in memory. bfloat16
    inputs are computed in float32, with the probabilities rounded to
    bfloat16 before the product with v, as the kernel does."""
    B, H, T, Dh = q.shape
    qf, kf, vf, uf = (t.float() for t in (q, k, v, used.to(q.dtype)))
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * (1.0 / Dh ** 0.5)
    rel = torch.einsum("bhqd,hmd->bhqm", qf, uf) + oob.float()
    idx = relative_index(T, q.device).expand(B, H, T, T)
    s = s + torch.gather(rel, 3, idx)
    s = s + torch.where(key_pad, NEG_FILL, 0.0).to(torch.float32)[:, None, None, :]
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = e.sum(dim=-1, keepdim=True)
    if q.dtype == torch.bfloat16:
        e = e.to(torch.bfloat16).float()
    return torch.einsum("bhqk,bhkd->bhqd", e, vf) / l


def _check(q, k, v, used, oob, key_pad):
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"q, k, v must share one (B, H, T, Dh) shape, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    B, H, T, Dh = q.shape
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k, v must all be float32 or all bfloat16")
    if used.shape != (H, 2 * T - 1, Dh):
        raise ValueError(f"used must be ({H}, {2 * T - 1}, {Dh}), got {tuple(used.shape)}")
    if oob.shape != (2 * T - 1,):
        raise ValueError(f"oob must be ({2 * T - 1},), got {tuple(oob.shape)}")
    if key_pad.shape != (B, T) or key_pad.dtype != torch.bool:
        raise ValueError(f"key_pad must be a ({B}, {T}) bool tensor")
    if any(t.device != q.device for t in (k, v, used, oob, key_pad)):
        raise ValueError("flash_attention_relpos inputs must share one device")


def flash_attention_relpos(q, k, v, used, oob, key_pad):
    """q, k, v: (B, H, T, Dh) float32 or bfloat16; used: (H, 2T-1, Dh);
    oob: (2T-1,) float32; key_pad: (B, T) bool, True at a padded key.
    Returns (B, H, T, Dh) float32.

    A CPU tensor takes the plain version. A CUDA tensor launches the kernel
    (T a multiple of 64, Dh <= 128) or raises; there is no fallback.
    """
    _check(q, k, v, used, oob, key_pad)
    device = q.device
    if device.type == "cpu":
        return flash_attention_relpos_plain(q, k, v, used, oob, key_pad)
    if device.type != "cuda":
        raise ValueError(f"flash_attention_relpos runs on cuda or cpu, not {device}")
    B, H, T, Dh = q.shape
    if T % KEY_TILE or Dh > MAX_HEAD_DIM:
        raise ValueError(
            f"the kernel takes T a multiple of {KEY_TILE} and Dh <= {MAX_HEAD_DIM}, got T={T}, Dh={Dh}"
        )
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    used = used.to(q.dtype).contiguous()
    oob = oob.to(torch.float32).contiguous()
    key_pad = key_pad.contiguous()
    out = torch.empty((B, H, T, Dh), dtype=torch.float32, device=device)
    lib = build.library("flash_attention_relpos")
    fn = (lib.flash_attention_relpos_bf16 if q.dtype == torch.bfloat16
          else lib.flash_attention_relpos_f32)
    code = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), used.data_ptr(), oob.data_ptr(),
        key_pad.data_ptr(), out.data_ptr(), B, H, T, Dh,
        build.current_stream_ptr(device),
    )
    build.check("flash_attention_relpos", code)
    flash_attention_relpos.launches += 1
    return out


flash_attention_relpos.launches = 0
