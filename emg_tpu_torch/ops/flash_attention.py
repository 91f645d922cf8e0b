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

On the card it is the kernel in ``csrc/flash_attention_relpos.cu``, the
forward of ``csrc/flash_fwd_relpos.cuh`` shared with training (the header
says what bounds it, operations, and how it uses the tensor cores). On a
CPU tensor it is the plain version below, which builds the full
(B, H, T, T) logits.

The training twin, ``flash_attention_relpos_train``, is the counterpart of
the JAX package's ``flash_attention_relpos_train`` (its three Pallas kernels
``_flash_train_fwd``, ``_flash_train_bwd`` dq and dk/dv): the same
attention with post-softmax dropout, differentiable in q, k, v and the
window ``used``. On the card ``FlashAttentionRelposTrain`` ties the three
kernels of ``csrc/flash_attention_relpos_train.cu`` together: forward with
the saved logsumexp (K3, the shared forward with its training flag), then
dq and d_used (K4) and dk, dv (K5), both on the tensor cores, from
``csrc/flash_bwd_relpos.cuh``. Each kernel has a plain version here,
and on a CPU tensor the whole call is the plain forward, differentiated by
autograd. The dropout mask is the JAX package's counter-based hash
(``keep_mask``), a function of (seed, b, h, query, key) alone, so every
version draws the same mask.
"""

from __future__ import annotations

import torch

from emg_tpu_torch.ops import build

NEG_FILL = -1e8
KEY_TILE = 64  # the kernel's key tile: T must be a multiple of it
FWD_HEAD_DIMS = (64, 96, 128)  # the attention kernels' (K2-K5) head sizes


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


def _check_fwd_shape(T, Dh):
    if T % KEY_TILE or Dh not in FWD_HEAD_DIMS:
        raise ValueError(
            f"the kernel takes T a multiple of {KEY_TILE} and Dh in {FWD_HEAD_DIMS}, got T={T}, Dh={Dh}"
        )


def flash_attention_relpos(q, k, v, used, oob, key_pad):
    """q, k, v: (B, H, T, Dh) float32 or bfloat16; used: (H, 2T-1, Dh);
    oob: (2T-1,) float32; key_pad: (B, T) bool, True at a padded key.
    Returns (B, H, T, Dh) float32.

    A CPU tensor takes the plain version. A CUDA tensor launches the kernel
    (T a multiple of 64, Dh 64, 96 or 128) or raises; there is no fallback.
    """
    _check(q, k, v, used, oob, key_pad)
    device = q.device
    if device.type == "cpu":
        return flash_attention_relpos_plain(q, k, v, used, oob, key_pad)
    if device.type != "cuda":
        raise ValueError(f"flash_attention_relpos runs on cuda or cpu, not {device}")
    B, H, T, Dh = q.shape
    _check_fwd_shape(T, Dh)
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
    build.count_launch(flash_attention_relpos)
    return out


flash_attention_relpos.launches = 0


# ---------------------------------------------------------------------------
# Training: forward with logsumexp and hash dropout (K3), backward dq and
# d_used (K4), backward dk and dv (K5)
# ---------------------------------------------------------------------------

KEEP_BITS = 30  # the keep test compares the hash's low 30 bits
_M32 = 0xFFFFFFFF


def keep_threshold(rate: float) -> int:
    """A hash keeps an element when its low 30 bits fall below this."""
    return int(round((1.0 - rate) * (1 << KEEP_BITS)))


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32): two partial products,
    each below 2^48, so nothing overflows int64."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def keep_mask(seed, b, h, qg, kg, rate: float) -> torch.Tensor:
    """The dropout keep mask (bool) of the JAX package's ``_keep_mask``
    (ops/pallas/flash_attention.py:222-242), bit for bit: a murmur3
    finalizer over (seed, batch b, head h, global query qg, global key kg)
    in uint32 arithmetic, emulated on int64 tensors masked to 32 bits after
    each step (torch has no unsigned 32-bit multiply). The index arguments
    broadcast against each other; ``seed`` is an int or an integer tensor."""
    seed = torch.as_tensor(seed).to(torch.int64) & _M32
    x = (seed + b * 0x9E3779B9 + h * 0xCC9E2D51 + qg * 0x1B873593
         + kg * 0xC2B2AE35) & _M32
    for mul in (0x85EBCA6B, 0xC2B2AE35):
        x = x ^ (x >> 16)
        x = _mul32(x, mul)
    x = x ^ (x >> 16)
    return (x & ((1 << KEEP_BITS) - 1)) < keep_threshold(rate)


def _keep(seed, shape, rate: float, device, b_off: int = 0, h_off: int = 0) -> torch.Tensor:
    """(B, H, T, T) float32 0/1 keep mask over the global indices: batch
    b_off + b, head h_off + h (a mesh rank's shard of a larger batch and
    head set), query and key."""
    B, H, T, _ = shape
    b, h, t = (torch.arange(n, device=device, dtype=torch.int64) for n in (B, H, T))
    return keep_mask(seed, (b + b_off)[:, None, None, None], (h + h_off)[None, :, None, None],
                     t[None, None, :, None], t[None, None, None, :], rate).float()


def _keep_scale(seed, shape, rate: float, device, b_off: int = 0, h_off: int = 0) -> torch.Tensor:
    """keep / keep_prob, divided in float32 as the kernels do."""
    return (_keep(seed, shape, rate, device, b_off, h_off)
            / torch.tensor(1.0 - rate, dtype=torch.float32))


def _round_like(x: torch.Tensor, dtype) -> torch.Tensor:
    """Round to bfloat16 where the kernels do (before a product)."""
    return x.to(torch.bfloat16).float() if dtype == torch.bfloat16 else x


def _train_logits(q, k, used, oob, key_pad):
    B, H, T, Dh = q.shape
    qf, kf, uf = q.float(), k.float(), used.to(q.dtype).float()
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * (1.0 / Dh ** 0.5)
    rel = torch.einsum("bhqd,hmd->bhqm", qf, uf) + oob.float()
    s = s + torch.gather(rel, 3, relative_index(T, q.device).expand(B, H, T, T))
    return s + torch.where(key_pad, NEG_FILL, 0.0).to(torch.float32)[:, None, None, :]


def flash_train_fwd_plain(q, k, v, used, oob, key_pad, rate: float, seed, b_off: int = 0,
                          h_off: int = 0):
    """Plain version of K3: (o, lse), o (B, H, T, Dh) float32 with
    o_i = sum_j keep * exp(s - m_i) v_j / (l_i * keep_prob), l_i the
    undropped normalizer, lse (B, H, T) = m + log l. Differentiable in q,
    k, v and used (the row max enters only as a constant shift). The keep
    hash sees batch b_off + b and head h_off + h."""
    s = _train_logits(q, k, used, oob, key_pad)
    m = s.amax(dim=-1, keepdim=True).detach()
    e = torch.exp(s - m)
    l = e.sum(dim=-1, keepdim=True)
    if rate > 0.0:
        e = e * _keep(seed, s.shape, rate, q.device, b_off, h_off)
    e = _round_like(e, q.dtype)
    o = torch.einsum("bhqk,bhkd->bhqd", e, v.float()) / (l * (1.0 - rate))
    return o, (m + torch.log(l))[..., 0]


def flash_attention_relpos_train_plain(q, k, v, used, oob, key_pad, rate: float, seed,
                                       b_off: int = 0, h_off: int = 0):
    """The plain training attention: K3's plain forward, whose gradients
    autograd takes (the CPU path of ``flash_attention_relpos_train``)."""
    return flash_train_fwd_plain(q, k, v, used, oob, key_pad, rate, seed, b_off, h_off)[0]


def _train_ds(q, k, v, used, oob, key_pad, dout, lse, delta, rate, seed, b_off=0, h_off=0):
    """p = exp(s - lse), keep / keep_prob (or None), and
    ds = p * (keep * (dO . v) / keep_prob - delta), as the backward kernels
    recompute them."""
    p = torch.exp(_train_logits(q, k, used, oob, key_pad) - lse[..., None])
    dp = torch.einsum("bhqd,bhkd->bhqk", dout.float(), v.float())
    ks = _keep_scale(seed, p.shape, rate, q.device, b_off, h_off) if rate > 0.0 else None
    if ks is not None:
        dp = dp * ks
    return p, ks, p * (dp - delta[..., None])


def flash_train_bwd_dq_plain(q, k, v, used, oob, key_pad, dout, lse, delta, rate: float, seed,
                             b_off: int = 0, h_off: int = 0):
    """Plain version of K4: (dq, d_used), float32. dq = scale * ds.k +
    dR.used and d_used[h] = sum_b dR^T.q, with dR the (B, H, T, 2T-1) map of
    ds to relative index j - i + T - 1."""
    B, H, T, Dh = q.shape
    _, _, ds = _train_ds(q, k, v, used, oob, key_pad, dout, lse, delta, rate, seed, b_off, h_off)
    ds = _round_like(ds, q.dtype)
    dR = torch.zeros((B, H, T, 2 * T - 1), dtype=torch.float32, device=q.device)
    dR.scatter_(3, relative_index(T, q.device).expand(B, H, T, T), ds)
    qf = q.float()
    dq = (torch.einsum("bhqk,bhkd->bhqd", ds, k.float()) * (1.0 / Dh ** 0.5)
          + torch.einsum("bhqm,hmd->bhqd", dR, used.to(q.dtype).float()))
    return dq, torch.einsum("bhqm,bhqd->hmd", dR, qf)


def flash_train_bwd_dkv_plain(q, k, v, used, oob, key_pad, dout, lse, delta, rate: float, seed,
                              b_off: int = 0, h_off: int = 0):
    """Plain version of K5: (dk, dv), float32. dv = (keep * p /
    keep_prob)^T.dO, dk = scale * ds^T.q."""
    Dh = q.shape[-1]
    p, ks, ds = _train_ds(q, k, v, used, oob, key_pad, dout, lse, delta, rate, seed, b_off,
                          h_off)
    pd = _round_like(p * ks if ks is not None else p, q.dtype)
    dv = torch.einsum("bhqk,bhqd->bhkd", pd, dout.float())
    dk = torch.einsum("bhqk,bhqd->bhkd", _round_like(ds, q.dtype), q.float()) * (1.0 / Dh ** 0.5)
    return dk, dv


def _check_train(q, k, v, used, oob, key_pad, rate, seed, b_off=0, h_off=0):
    _check(q, k, v, used, oob, key_pad)
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must lie in [0, 1), got {rate}")
    if not (0 <= b_off < 2 ** 31 and 0 <= h_off < 2 ** 31):
        raise ValueError(f"the hash's offsets must be non-negative ints, got {b_off}, {h_off}")
    if (not isinstance(seed, torch.Tensor) or seed.numel() != 1 or seed.dtype != torch.int32
            or seed.device != q.device):
        raise ValueError("seed must be a one-element int32 tensor on the inputs' device")


def _cuda_ready(name, q, *tensors):
    """Raise unless the inputs lie on the card (each training wrapper checks
    their shape with ``_check_fwd_shape``); return them contiguous."""
    if q.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {q.device}")
    return [t.contiguous() for t in tensors]


def _bwd_check(q, dout, lse, delta):
    B, H, T, _ = q.shape
    if dout.shape != q.shape or dout.dtype != q.dtype:
        raise ValueError("dout must match q in shape and dtype")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (B, H, T) or t.dtype != torch.float32 or t.device != q.device:
            raise ValueError(f"{name} must be a float32 ({B}, {H}, {T}) tensor on q's device")


def flash_train_fwd(q, k, v, used, oob, key_pad, rate: float, seed, b_off: int = 0,
                    h_off: int = 0):
    """K3: (o (B, H, T, Dh), lse (B, H, T)), both float32. ``seed`` is a
    one-element int32 tensor on the inputs' device; the dropout hash sees
    batch b_off + b and head h_off + h (a mesh rank's offsets; 0 on one
    device). A CPU tensor takes the plain version; a CUDA tensor launches
    the kernel (T a multiple of 64, Dh 64, 96 or 128) or raises."""
    _check_train(q, k, v, used, oob, key_pad, rate, seed, b_off, h_off)
    if q.device.type == "cpu":
        return flash_train_fwd_plain(q, k, v, used, oob, key_pad, rate, seed, b_off, h_off)
    q, k, v, oob, key_pad, seed = _cuda_ready("flash_train_fwd", q, q, k, v,
                                              oob.to(torch.float32), key_pad, seed)
    B, H, T, Dh = q.shape
    _check_fwd_shape(T, Dh)
    used = used.to(q.dtype).contiguous()
    o = torch.empty((B, H, T, Dh), dtype=torch.float32, device=q.device)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    lib = build.library("flash_attention_relpos_train")
    fn = lib.flash_train_fwd_bf16 if q.dtype == torch.bfloat16 else lib.flash_train_fwd_f32
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), used.data_ptr(), oob.data_ptr(),
              key_pad.data_ptr(), seed.data_ptr(), o.data_ptr(), lse.data_ptr(),
              B, H, T, Dh, keep_threshold(rate), 1.0 - rate, b_off, h_off,
              build.current_stream_ptr(q.device))
    build.check("flash_attention_relpos_train", code)
    build.count_launch(flash_train_fwd)
    return o, lse


def _launch_bwd(name, q, k, v, used, oob, key_pad, dout, lse, delta, rate, seed, b_off, h_off,
                g1, g2):
    q, k, v, oob, key_pad, seed, dout, lse, delta = _cuda_ready(
        name, q, q, k, v, oob.to(torch.float32), key_pad, seed, dout, lse, delta)
    used = used.to(q.dtype).contiguous()
    B, H, T, Dh = q.shape
    lib = build.library("flash_attention_relpos_train")
    fn = getattr(lib, f"{name}_{'bf16' if q.dtype == torch.bfloat16 else 'f32'}")
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), used.data_ptr(), oob.data_ptr(),
              key_pad.data_ptr(), seed.data_ptr(), dout.data_ptr(), lse.data_ptr(),
              delta.data_ptr(), g1.data_ptr(), g2.data_ptr(), B, H, T, Dh,
              keep_threshold(rate), 1.0 - rate, b_off, h_off, build.current_stream_ptr(q.device))
    build.check("flash_attention_relpos_train", code)
    return g1, g2


def flash_train_bwd_dq(q, k, v, used, oob, key_pad, dout, lse, delta, rate: float, seed,
                       b_off: int = 0, h_off: int = 0):
    """K4: (dq (B, H, T, Dh), d_used (H, 2T-1, Dh)), both float32. ``dout``
    is the output's gradient at the input dtype, ``lse`` K3's saved
    logsumexp, ``delta`` = rowsum(dout * o) (B, H, T) float32. On the card
    it is the tensor-core kernel of ``csrc/flash_bwd_relpos.cuh`` (T a
    multiple of 64, Dh 64, 96 or 128, as the forward). d_used sums over
    blocks with atomics: its float32 rounding changes from run to run. The
    hash's offsets are K3's."""
    _check_train(q, k, v, used, oob, key_pad, rate, seed, b_off, h_off)
    _bwd_check(q, dout, lse, delta)
    if q.device.type == "cpu":
        return flash_train_bwd_dq_plain(q, k, v, used, oob, key_pad, dout, lse, delta, rate, seed,
                                        b_off, h_off)
    B, H, T, Dh = q.shape
    _check_fwd_shape(T, Dh)
    dq = torch.empty((B, H, T, Dh), dtype=torch.float32, device=q.device)
    dused = torch.zeros((H, 2 * T - 1, Dh), dtype=torch.float32, device=q.device)
    out = _launch_bwd("flash_train_bwd_dq", q, k, v, used, oob, key_pad, dout, lse, delta,
                      rate, seed, b_off, h_off, dq, dused)
    build.count_launch(flash_train_bwd_dq)
    return out


def flash_train_bwd_dkv(q, k, v, used, oob, key_pad, dout, lse, delta, rate: float, seed,
                        b_off: int = 0, h_off: int = 0):
    """K5: (dk, dv), each (B, H, T, Dh) float32; arguments as K4's. On the
    card it is the tensor-core kernel of ``csrc/flash_bwd_relpos.cuh`` (T a
    multiple of 64, Dh 64, 96 or 128, as the forward)."""
    _check_train(q, k, v, used, oob, key_pad, rate, seed, b_off, h_off)
    _bwd_check(q, dout, lse, delta)
    if q.device.type == "cpu":
        return flash_train_bwd_dkv_plain(q, k, v, used, oob, key_pad, dout, lse, delta, rate,
                                         seed, b_off, h_off)
    _check_fwd_shape(q.shape[2], q.shape[3])
    dk = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    dv = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    out = _launch_bwd("flash_train_bwd_dkv", q, k, v, used, oob, key_pad, dout, lse, delta,
                      rate, seed, b_off, h_off, dk, dv)
    build.count_launch(flash_train_bwd_dkv)
    return out


flash_train_fwd.launches = 0
flash_train_bwd_dq.launches = 0
flash_train_bwd_dkv.launches = 0


class FlashAttentionRelposTrain(torch.autograd.Function):
    """The training attention through K3 (forward), then K4 and K5
    (backward). Saves q, k, v, used, oob, key_pad, o, lse and seed. The
    gradients of oob and key_pad are zero (None), as in the JAX package;
    d_used arrives at used's dtype, the rest at the input dtype."""

    @staticmethod
    def forward(ctx, q, k, v, used, oob, key_pad, seed, rate, b_off, h_off):
        o, lse = flash_train_fwd(q, k, v, used, oob, key_pad, rate, seed, b_off, h_off)
        ctx.save_for_backward(q, k, v, used, oob, key_pad, o, lse, seed)
        ctx.rate, ctx.offsets = rate, (b_off, h_off)
        return o

    @staticmethod
    def backward(ctx, grad):
        q, k, v, used, oob, key_pad, o, lse, seed = ctx.saved_tensors
        grad = grad.float()
        # delta uses the dropped output, as the JAX backward (:518)
        delta = (grad * o).sum(dim=-1)
        dout = grad.to(q.dtype)
        args = (q, k, v, used, oob, key_pad, dout, lse, delta, ctx.rate, seed, *ctx.offsets)
        dq, dused = flash_train_bwd_dq(*args)
        dk, dv = flash_train_bwd_dkv(*args)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dused.to(used.dtype),
                None, None, None, None, None, None)


def flash_attention_relpos_train(q, k, v, used, oob, key_pad, dropout_rate: float, seed,
                                 b_off: int = 0, h_off: int = 0):
    """Differentiable training attention: q, k, v (B, H, T, Dh) float32 or
    bfloat16, used (H, 2T-1, Dh), oob (2T-1,), key_pad (B, T) bool,
    ``dropout_rate`` on the probabilities, ``seed`` a one-element int32
    tensor on the inputs' device. Returns o (B, H, T, Dh) float32.

    Under a mesh the inputs are a rank's batch rows and heads, which start
    at global batch ``b_off`` and head ``h_off``; the dropout hash takes
    the global indices, so the rank draws its share of the unsharded
    step's mask (offsets of 0: one device).

    A CPU tensor takes the plain version under autograd. A CUDA tensor goes
    through ``FlashAttentionRelposTrain`` (T a multiple of 64, Dh 64, 96 or
    128) or raises; there is no fallback."""
    rate = float(dropout_rate)
    b_off, h_off = int(b_off), int(h_off)
    _check_train(q, k, v, used, oob, key_pad, rate, seed, b_off, h_off)
    if q.device.type == "cpu":
        return flash_attention_relpos_train_plain(q, k, v, used, oob, key_pad, rate, seed,
                                                  b_off, h_off)
    return FlashAttentionRelposTrain.apply(q, k, v, used, oob, key_pad, seed, rate, b_off, h_off)
