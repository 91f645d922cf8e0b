"""The plain reference of the EMG-to-phoneme model's training step, in
float32 PyTorch with TF32 off, written from the published description and
the reference code's semantics, and importing nothing of the program.

- Model (Gaddy & Klein, arXiv:2106.01933; the reference architecture.py and
  transformer.py): three stride-2 ResBlocks with BatchNorm over the valid
  packed rows, a linear layer, the utterances gathered out of the packed
  frame stream, a post-norm encoder with learned relative-position logits
  (keys further than the table's reach masked), a causal post-norm decoder
  with cross-attention and a sinusoidal position code scaled by 1/d, and a
  CTC head and a CE head. The conformer encoder follows Gulati et al.,
  arXiv:2005.08100: half-step feed-forwards, relative self-attention, a
  GLU / depthwise conv / LayerNorm / SiLU module, and a final LayerNorm.
- Losses: CTC (mean over real examples of each sequence's negative
  log-likelihood over its target length) and the reference's label
  smoothing, (1 - eps) CE + eps / S * sum(exp(logits)), joined as
  (1 - alpha) dec + alpha enc.
- Randomness: the port's draw protocol, worked out again from the
  microbatch's seed: one CUDA ``torch.Generator`` seeded per microbatch, a
  time shift r in [0, 8) first, then every dropout mask in forward order,
  each ``rand(shape) >= rate`` at the batch's padded shape; the fused
  encoder attention's mask is a murmur3 hash of (seed, b, h, q, k), its
  seed an int32 drawn in its place (a copy of
  ``emg_tpu_torch/ops/flash_attention.py::keep_mask``).

``Arith`` is where the precision enters: every matrix product and
convolution takes its operands through ``Arith.q``, the identity for the
reference and a rounding to float8 e4m3 (a per-tensor scale) for the
control, the next precision below the configuration's bfloat16.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

NEG = -1e8
N_DEC, N_ENC, BLANK, PAD = 43, 44, 43, 42
ATTN_TILE = 128


class Arith:
    """Operand rounding of every product: None (float32) or "fp8"."""

    def __init__(self, precision: str = "float32"):
        if precision not in ("float32", "fp8"):
            raise ValueError(precision)
        self.fp8 = precision == "fp8"

    def q(self, t: torch.Tensor) -> torch.Tensor:
        if not self.fp8:
            return t
        scale = 448.0 / t.detach().abs().amax().clamp(min=1e-30)
        r = (t.detach() * scale).to(torch.float8_e4m3fn).float() / scale
        return t + (r - t.detach())  # rounded forward, identity gradient

    def lin(self, x, w, b=None):
        y = F.linear(self.q(x), self.q(w))
        return y if b is None else y + b

    def ein(self, spec, a, b):
        return torch.einsum(spec, self.q(a), self.q(b))

    def conv(self, x, w, b, stride=1, padding=0, groups=1):
        return F.conv1d(self.q(x), self.q(w), b, stride=stride, padding=padding, groups=groups)


# -- parameters ---------------------------------------------------------------

def param_spec(cfg: dict) -> List[Tuple[str, tuple, object]]:
    """(name, shape, init) of every parameter, under the reference's
    state-dict names; init is "one", "zero" or a normal's std (fan-in
    scaled; xavier per head for attention; Dh^-0.5 for relative tables)."""
    D, FF, C = cfg["model_size"], cfg["feed_forward_layer_size"], cfg["num_channels"]
    He, Hd = cfg["n_heads_encoder"], cfg["n_heads_decoder"]
    spec: List[Tuple[str, tuple, object]] = []

    def dense(name, out, inp):
        spec.extend([(f"{name}.weight", (out, inp), inp ** -0.5), (f"{name}.bias", (out,), "zero")])

    def norm(name, n):
        spec.extend([(f"{name}.weight", (n,), "one"), (f"{name}.bias", (n,), "zero")])

    def conv(name, out, inp, k, groups=1):
        fan = inp // groups * k
        spec.extend([(f"{name}.weight", (out, inp // groups, k), fan ** -0.5),
                     (f"{name}.bias", (out,), "zero")])

    def mha(name, H, rel):
        Dh = D // H
        for w in ("w_q", "w_k", "w_v"):
            spec.append((f"{name}.{w}", (H, D, Dh), (2.0 / ((D + H) * Dh)) ** 0.5))
        spec.append((f"{name}.w_o", (H, Dh, D), (2.0 / ((Dh + H) * D)) ** 0.5))
        if rel:
            M = cfg["relative_distance"]
            spec.append((f"{name}.relative_positional.embeddings", (H, 2 * M - 1, Dh, 1),
                         Dh ** -0.5))

    for i, (cin, cout) in enumerate([(C, D), (D, D), (D, D)]):
        b = f"conv_blocks.{i}"
        conv(f"{b}.conv1", cout, cin, 3)
        norm(f"{b}.bn1", cout)
        conv(f"{b}.conv2", cout, cout, 3)
        norm(f"{b}.bn2", cout)
        conv(f"{b}.residual_path", cout, cin, 1)
        norm(f"{b}.res_norm", cout)
    dense("w_raw_in", D, D)
    spec.append(("embedding_tgt.weight", (N_DEC, D), 1.0))
    for i in range(cfg["num_layers_encoder"]):
        e = f"transformerEncoder.layers.{i}"
        if cfg["encoder_kind"] == "conformer":
            for ff in ("ff1", "ff2"):
                norm(f"{e}.{ff}_norm", D)
                dense(f"{e}.{ff}_in", FF, D)
                dense(f"{e}.{ff}_out", D, FF)
            norm(f"{e}.attn_norm", D)
            mha(f"{e}.self_attn", He, True)
            norm(f"{e}.conv_module.norm", D)
            dense(f"{e}.conv_module.pointwise_in", 2 * D, D)
            conv(f"{e}.conv_module.depthwise", D, D, cfg["conformer_conv_kernel_size"], groups=D)
            norm(f"{e}.conv_module.conv_norm", D)
            dense(f"{e}.conv_module.pointwise_out", D, D)
            norm(f"{e}.final_norm", D)
        else:
            mha(f"{e}.self_attn", He, True)
            dense(f"{e}.linear1", FF, D)
            dense(f"{e}.linear2", D, FF)
            norm(f"{e}.norm1", D)
            norm(f"{e}.norm2", D)
    for i in range(cfg["num_layers_decoder"]):
        d = f"transformerDecoder.layers.{i}"
        mha(f"{d}.self_attn", Hd, False)
        mha(f"{d}.multihead_attn", Hd, False)
        dense(f"{d}.linear1", FF, D)
        dense(f"{d}.linear2", D, FF)
        for n in (1, 2, 3):
            norm(f"{d}.norm{n}", D)
    dense("w_aux", N_ENC, D)
    dense("w_out", N_DEC, D)
    return spec


# -- randomness -----------------------------------------------------------------

def step_seed(seed: int, microbatches: int) -> int:
    return (int(seed) * 1_000_003 + int(microbatches)) % (1 << 63)


class Draws:
    """The microbatch's generator, drawn from in the port's order."""

    def __init__(self, generator: torch.Generator, rate: float, pos_rate: float):
        self.g, self.rate, self.pos_rate = generator, rate, pos_rate

    def drop(self, x, rate=None):
        rate = self.rate if rate is None else rate
        if rate == 0.0:
            return x
        keep = torch.rand(x.shape, generator=self.g, device=x.device) >= rate
        return torch.where(keep, x / (1.0 - rate), 0.0)

    def shift(self, device):
        return torch.randint(0, 8, (1,), generator=self.g, device=device)

    def hash_seed(self, device):
        return torch.randint(-2 ** 31, 2 ** 31, (1,), generator=self.g, device=device,
                             dtype=torch.int64).to(torch.int32)


_M32 = 0xFFFFFFFF


def _mul32(x, c):
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def hash_keep(seed, b, H, T, rate, device):
    """(H, T, T) bool keep mask of batch row b: murmur3's finalizer over
    (seed, b, h, q, k) in uint32 arithmetic, kept below the rate's
    threshold of the low 30 bits."""
    s = seed.to(torch.int64) & _M32
    h = torch.arange(H, device=device, dtype=torch.int64)[:, None, None]
    t = torch.arange(T, device=device, dtype=torch.int64)
    x = (s + b * 0x9E3779B9 + h * 0xCC9E2D51 + t[None, :, None] * 0x1B873593
         + t[None, None, :] * 0xC2B2AE35) & _M32
    for mul in (0x85EBCA6B, 0xC2B2AE35):
        x = x ^ (x >> 16)
        x = _mul32(x, mul)
    x = x ^ (x >> 16)
    return (x & ((1 << 30) - 1)) < int(round((1.0 - rate) * (1 << 30)))


# -- layers -----------------------------------------------------------------------

def layer_norm(P, name, x, eps):
    return F.layer_norm(x, (x.shape[-1],), P[f"{name}.weight"], P[f"{name}.bias"], eps)


def batch_norm(P, name, x, n_rows):
    """BatchNorm over (N, C, L) in training: the first n_rows rows'
    statistics."""
    v = x[:n_rows]
    mean = v.mean(dim=(0, 2))
    var = v.var(dim=(0, 2), unbiased=False)
    y = (x - mean[None, :, None]) / torch.sqrt(var[None, :, None] + 1e-5)
    return y * P[f"{name}.weight"][None, :, None] + P[f"{name}.bias"][None, :, None]


def res_block(P, a: Arith, name, x, n_rows):
    h = a.conv(x, P[f"{name}.conv1.weight"], P[f"{name}.conv1.bias"], stride=2, padding=1)
    h = F.relu(batch_norm(P, f"{name}.bn1", h, n_rows))
    h = a.conv(h, P[f"{name}.conv2.weight"], P[f"{name}.conv2.bias"], padding=1)
    h = batch_norm(P, f"{name}.bn2", h, n_rows)
    r = a.conv(x, P[f"{name}.residual_path.weight"], P[f"{name}.residual_path.bias"], stride=2)
    return F.relu(h + batch_norm(P, f"{name}.res_norm", r, n_rows))


def relative_logits(P, a: Arith, name, q, M):
    """(B, H, T, T): q_i . E[j - i] for |j - i| < M, else NEG."""
    B, H, T, Dh = q.shape
    table = P[f"{name}.relative_positional.embeddings"][..., 0]  # (H, 2M-1, Dh)
    rel = torch.arange(T, device=q.device)
    dist = rel[None, :] - rel[:, None]  # (T, T): key - query
    inside = dist.abs() < M
    idx = (dist.clamp(-(M - 1), M - 1) + M - 1)
    proj = a.ein("bhtd,hmd->bhtm", q, table)  # (B, H, T, 2M-1)
    out = torch.gather(proj, 3, idx[None, None].expand(B, H, T, T))
    return torch.where(inside[None, None], out, NEG)


def project(P, a: Arith, name, x, which):
    return a.ein("btf,hfa->bhta", x, P[f"{name}.{which}"])


def attention(P, a: Arith, name, x, kv, *, key_pad, query_pad=None, causal=False, rel_M=None,
              drop_probs=None):
    """Multi-head attention in the reference's masking order: causal, key
    pads, query pads (each -1e8), then the relative logits; ``drop_probs``
    turns the probabilities into their dropped form."""
    q = project(P, a, name, x, "w_q")
    k = project(P, a, name, kv, "w_k")
    v = project(P, a, name, kv, "w_v")
    Dh = q.shape[-1]
    s = a.ein("bhqa,bhka->bhqk", q, k) / math.sqrt(Dh)
    if causal:
        Tq, Tk = s.shape[2], s.shape[3]
        tril = torch.ones((Tq, Tk), dtype=torch.bool, device=s.device).tril()
        s = torch.where(tril[None, None], s, NEG)
    s = torch.where(key_pad[:, None, None, :], NEG, s)
    if query_pad is not None:
        s = torch.where(query_pad[:, None, :, None], NEG, s)
    if rel_M is not None:
        s = s + relative_logits(P, a, name, q, rel_M)
    probs = torch.softmax(s, dim=-1)
    if drop_probs is not None:
        probs = drop_probs(probs)
    o = a.ein("bhqk,bhka->bhqa", probs, v)
    return a.ein("bhta,haf->btf", o, P[f"{name}.w_o"])


def hash_dropped(seed, rate):
    """The fused encoder attention's probability dropout."""
    def drop(probs):
        B, H, T, _ = probs.shape
        keep = torch.stack([hash_keep(seed, b, H, T, rate, probs.device) for b in range(B)])
        return torch.where(keep, probs / (1.0 - rate), 0.0)
    return drop


def encoder_layer(P, a, cfg, name, x, pad, draws: Draws):
    seed = draws.hash_seed(x.device) if draws.rate > 0 else None
    attn = attention(P, a, f"{name}.self_attn", x, x, key_pad=pad, rel_M=cfg["relative_distance"],
                     drop_probs=hash_dropped(seed, draws.rate) if seed is not None else None)
    x = layer_norm(P, f"{name}.norm1", x + draws.drop(attn), 1e-5)
    h = draws.drop(F.relu(a.lin(x, P[f"{name}.linear1.weight"], P[f"{name}.linear1.bias"])))
    ff = a.lin(h, P[f"{name}.linear2.weight"], P[f"{name}.linear2.bias"])
    return layer_norm(P, f"{name}.norm2", x + draws.drop(ff), 1e-5)


def conformer_layer(P, a, cfg, name, x, pad, draws: Draws):
    eps = 1e-6

    def ff(which, x):
        h = layer_norm(P, f"{name}.{which}_norm", x, eps)
        h = a.lin(h, P[f"{name}.{which}_in.weight"], P[f"{name}.{which}_in.bias"])
        h = draws.drop(F.silu(h))
        return draws.drop(a.lin(h, P[f"{name}.{which}_out.weight"], P[f"{name}.{which}_out.bias"]))

    x = x + 0.5 * ff("ff1", x)
    h = layer_norm(P, f"{name}.attn_norm", x, eps)
    attn = attention(P, a, f"{name}.self_attn", h, h, key_pad=pad, rel_M=cfg["relative_distance"],
                     drop_probs=draws.drop)
    x = x + draws.drop(attn)
    c = f"{name}.conv_module"
    h = torch.where(pad[:, :, None], 0.0, layer_norm(P, f"{c}.norm", x, eps))
    g = a.lin(h, P[f"{c}.pointwise_in.weight"], P[f"{c}.pointwise_in.bias"])
    h = g[..., : g.shape[-1] // 2] * torch.sigmoid(g[..., g.shape[-1] // 2:])
    k = cfg["conformer_conv_kernel_size"]
    h = a.conv(h.transpose(1, 2), P[f"{c}.depthwise.weight"], P[f"{c}.depthwise.bias"],
               padding=(k - 1) // 2, groups=h.shape[-1]).transpose(1, 2)
    h = F.silu(layer_norm(P, f"{c}.conv_norm", h, eps))
    x = x + draws.drop(a.lin(h, P[f"{c}.pointwise_out.weight"], P[f"{c}.pointwise_out.bias"]))
    x = x + 0.5 * ff("ff2", x)
    return layer_norm(P, f"{name}.final_norm", x, eps)


def decoder_layer(P, a, name, y, memory, y_pad, mem_pad, draws: Draws):
    sa = attention(P, a, f"{name}.self_attn", y, y, key_pad=y_pad, query_pad=y_pad, causal=True,
                   drop_probs=draws.drop)
    y = layer_norm(P, f"{name}.norm1", y + draws.drop(sa), 1e-5)
    ca = attention(P, a, f"{name}.multihead_attn", y, memory, key_pad=mem_pad,
                   drop_probs=draws.drop)
    y = layer_norm(P, f"{name}.norm2", y + draws.drop(ca), 1e-5)
    h = draws.drop(F.relu(a.lin(y, P[f"{name}.linear1.weight"], P[f"{name}.linear1.bias"])))
    ff = a.lin(h, P[f"{name}.linear2.weight"], P[f"{name}.linear2.bias"])
    return layer_norm(P, f"{name}.norm3", y + draws.drop(ff), 1e-5)


def sinusoids(n: int, d: int, device) -> torch.Tensor:
    pos = torch.arange(n, dtype=torch.float64)[:, None]
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float64) * (-math.log(10000.0) / d))
    pe = torch.zeros(n, d, dtype=torch.float64)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe.float().to(device)


# -- the step ---------------------------------------------------------------------

def encode(P: Dict[str, torch.Tensor], cfg: dict, batch: Dict[str, object], draws: Draws,
           a: Arith):
    """(memory (B, T, D), enc_logits, pad (B, T)) of a training batch:
    device tensors packed (N, L, C) float32, lengths, offsets, and ints
    n_rows and max_frames. The rows shift by the drawn r and BatchNorm takes
    the batch's statistics."""
    dev = batch["packed"].device
    D = cfg["model_size"]
    x = batch["packed"]
    L = x.shape[1]
    idx = torch.arange(L, device=dev) + draws.shift(dev)
    x = torch.where((idx < L)[None, :, None], x[:, idx.clamp(max=L - 1)], 0.0)
    x = x.transpose(1, 2)
    for i in range(3):
        x = res_block(P, a, f"conv_blocks.{i}", x, batch["n_rows"])
    x = a.lin(x.transpose(1, 2), P["w_raw_in.weight"], P["w_raw_in.bias"])
    flat = x.reshape(-1, D)
    T = batch["max_frames"]
    lengths, offsets = batch["lengths"], batch["offsets"]
    pos = torch.arange(T, device=dev)[None, :]
    valid = pos < lengths[:, None]
    src = torch.where(valid[:, :, None], flat[(offsets[:, None] + pos).clamp(0, flat.shape[0] - 1)],
                      0.0)
    pad = ~valid
    layer = conformer_layer if cfg["encoder_kind"] == "conformer" else encoder_layer
    for i in range(cfg["num_layers_encoder"]):
        src = layer(P, a, cfg, f"transformerEncoder.layers.{i}", src, pad, draws)
    return src, a.lin(src, P["w_aux.weight"], P["w_aux.bias"]), pad


def decode(P: Dict[str, torch.Tensor], cfg: dict, y: torch.Tensor, memory: torch.Tensor,
           pad: torch.Tensor, draws: Draws, a: Arith) -> torch.Tensor:
    """Teacher-forced decoder logits (B, S, 43) for input ids y (B, S)."""
    D = cfg["model_size"]
    y_pad = y == PAD
    emb = torch.where(y_pad[..., None], 0.0, P["embedding_tgt.weight"][y])
    tgt = draws.drop(emb + sinusoids(y.shape[1], D, y.device)[None] / D, draws.pos_rate)
    for i in range(cfg["num_layers_decoder"]):
        tgt = decoder_layer(P, a, f"transformerDecoder.layers.{i}", tgt, memory, y_pad, pad, draws)
    return a.lin(tgt, P["w_out.weight"], P["w_out.bias"])


def losses(P: Dict[str, torch.Tensor], cfg: dict, batch: Dict[str, object], draws: Draws,
           a: Arith, alpha: float = 0.2, eps: float = 0.1):
    """(loss, dec_loss, enc_loss) of one training microbatch; ``batch`` as
    ``encode`` takes it, with targets (B, S), target_lengths and the int
    n_examples."""
    memory, enc_logits, pad = encode(P, cfg, batch, draws, a)
    targets = batch["targets"]
    dec_logits = decode(P, cfg, targets[:, :-1], memory, pad, draws, a)
    lengths = batch["lengths"]
    n = batch["n_examples"]
    gold = targets[:n, 1:]
    tl = batch["target_lengths"][:n]
    lp = torch.log_softmax(enc_logits[:n], dim=-1)
    nll = F.ctc_loss(lp.transpose(0, 1), gold, lengths[:n], tl - 2, blank=BLANK,
                     reduction="none")
    enc_loss = (nll / (tl - 2).clamp(min=1)).mean()

    seq = int(tl.max()) - 1
    logp = torch.log_softmax(dec_logits[:n], dim=-1)
    keep = gold != PAD
    nll_ce = -logp.gather(-1, torch.where(keep, gold, 0)[..., None])[..., 0]
    ce = torch.where(keep, nll_ce, 0.0).sum() / keep.sum().clamp(min=1)
    reg = (eps / seq) * torch.exp(dec_logits[:n, :seq]).sum()
    dec_loss = (1.0 - eps) * ce + reg
    return (1.0 - alpha) * dec_loss + alpha * enc_loss, dec_loss, enc_loss
