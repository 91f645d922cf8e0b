"""The reference follows the first optimizer steps of a training cell from
the same utterances and weights: its own DSP (``dsp.py``), its own batches
and windows (``batching.py``), the plain model and losses (``model.py``) and
a plain AdamW (torch's formula, weight decay 0.01 on every tensor) at the
warmup LR of the microbatch counter. A step is one accumulation window: the
microbatches up to an apply."""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from h100bench.reference import batching, dsp, model
from h100bench.reference.weights import make_weights

BETAS, EPS, WEIGHT_DECAY = (0.9, 0.999), 1e-8, 0.01


def warmup_lr(learning_rate: float, warmup: int, microbatches: int) -> float:
    it = np.minimum(np.float32(microbatches) + np.float32(1.0), np.float32(warmup))
    return float(it * np.float32(learning_rate) / np.float32(warmup))


def adamw(params, grads, m, v, t: int, lr: float) -> None:
    b1, b2 = BETAS
    with torch.no_grad():
        for p, g, mi, vi in zip(params, grads, m, v):
            p.mul_(1.0 - lr * WEIGHT_DECAY)
            mi.mul_(b1).add_(g, alpha=1.0 - b1)
            vi.mul_(b2).addcmul_(g, g, value=1.0 - b2)
            denom = vi.sqrt() / (1.0 - b2 ** t) ** 0.5 + EPS
            p.addcdiv_(mi, denom, value=-lr / (1.0 - b1 ** t))


def epoch_plan(raw_lengths: List[int], train: dict, epoch: int = 0):
    """(batches of utterance indices, window lengths) of one epoch."""
    batches = batching.sampler_batches(raw_lengths, train["max_batch_length"],
                                       train["n_buckets"], train["seed"], epoch)
    windows = batching.plan_windows([len(b) for b in batches], train["batch_size_grad"],
                                    train["report_loss"])
    return batches, windows


def device_batch(b: batching.Batch, device) -> Dict[str, object]:
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return {"packed": t(b.packed), "lengths": t(b.lengths), "offsets": t(b.offsets),
            "targets": t(b.targets), "target_lengths": t(b.target_lengths),
            "n_rows": int(b.n_rows), "n_examples": int(b.n_examples),
            "max_frames": int(b.max_frames)}


def follow(cfg: dict, train: dict, raws: List[np.ndarray], phones: List[np.ndarray],
           weight_seed: int, steps: int, precision: str = "float32", device="cuda") -> dict:
    """The first ``steps`` steps: each microbatch's loss, each leaf's
    gradient norm at the first apply (``grad1``), and the norm of each
    leaf's change after the last (``delta``), by parameter name."""
    arith = model.Arith(precision)
    spec = model.param_spec(cfg)
    P = {k: v.requires_grad_(True) for k, v in make_weights(spec, weight_seed, device).items()}
    P0 = {k: v.detach().clone() for k, v in P.items()}
    names = list(P)
    params = [P[k] for k in names]
    acc = [torch.zeros_like(p) for p in params]
    m = [torch.zeros_like(p) for p in params]
    v = [torch.zeros_like(p) for p in params]
    batches, windows = epoch_plan([r.shape[0] for r in raws], train)
    inputs: Dict[int, tuple] = {}
    losses, grad1 = [], None
    mb, accum = 0, 0
    for step in range(steps):
        for idxs in batches[mb: mb + windows[step]]:
            for i in idxs:
                if i not in inputs:
                    inputs[i] = dsp.training_input(raws[i])
            b = batching.make_batch([inputs[i][0] for i in idxs], [inputs[i][1] for i in idxs],
                                    [phones[i] for i in idxs], train["packed_chunk"],
                                    train["stage_int16"])
            g = torch.Generator(device=device)
            g.manual_seed(model.step_seed(train["seed"], mb))
            draws = model.Draws(g, cfg["dropout_model"], cfg["dropout_pos_emb"])
            loss, _, _ = model.losses(P, cfg, device_batch(b, device), draws, arith,
                                      alpha=train["alpha_loss"])
            grads = torch.autograd.grad(loss, params, allow_unused=True)
            with torch.no_grad():
                for a, gr in zip(acc, grads):
                    if gr is not None:
                        a.add_(gr)
            losses.append(float(loss.detach()))
            accum += len(idxs)
            mb += 1
        if accum < train["batch_size_grad"]:
            raise RuntimeError(f"step {step + 1} ended without an apply")
        if grad1 is None:
            grad1 = {k: float(a.norm()) for k, a in zip(names, acc)}
        adamw(params, acc, m, v, step + 1,
              warmup_lr(train["learning_rate"], train["learning_rate_warmup"], mb - 1))
        for a in acc:
            a.zero_()
        accum = 0
    delta = {k: float((P[k].detach() - P0[k]).norm()) for k in names}
    return {"losses": losses, "grad1": grad1, "delta": delta, "microbatches": mb}
