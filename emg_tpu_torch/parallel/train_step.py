"""Training and eval steps with gradient accumulation.

Counterpart of ``emg_tpu/parallel/train_step.py`` (one device). The loss
wiring follows the reference training loop (recognition_model.py:77-118):
teacher inputs are targets[:, :-1], CE targets targets[:, 1:], CTC labels
the phoneme ids stripped of <S>/</S> (targets[:, 1:] with label lengths
minus 2), CTC input lengths the encoder frame counts, and the two losses
combine as (1-alpha)*dec + alpha*enc. Gradients sum across microbatches and
apply once the summed example count reaches batch_size_grad, at the warmup
LR of the *microbatch* counter.

Randomness: each microbatch reseeds the caller's ``torch.Generator`` from
(train.seed, microbatch counter), as the JAX step folds the counter into
its key, so a resumed run draws what an uninterrupted one would. The step
draws the time shift first, then the dropout masks in forward order.

Scheduled sampling and the raw-EMG augmentation recipes are not ported
yet: a config that turns one on raises.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from emg_tpu_torch.data.batching import PackedBatch, dequantize_packed_raw
from emg_tpu_torch.ops.ctc import ctc_loss
from emg_tpu_torch.ops.losses import combined_loss, label_smoothing_loss
from emg_tpu_torch.train.state import TrainState, warmup_lr


def step_seed(seed: int, microbatches: int) -> int:
    """The generator seed of one microbatch: a function of (train.seed,
    microbatch counter) alone."""
    return (int(seed) * 1_000_003 + int(microbatches)) % (1 << 63)


def batch_to_device(batch: PackedBatch, device) -> Dict[str, object]:
    """A host ``PackedBatch`` as device tensors, with the host integers the
    losses slice by (``n_examples`` and the true teacher length
    ``seq_len``)."""

    def t(a, dtype=None):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    return {
        "packed_raw": dequantize_packed_raw(t(batch.packed_raw)),
        "n_rows": int(batch.n_rows),
        "offsets": t(batch.offsets, torch.int64),
        "lengths": t(batch.lengths, torch.int64),
        "targets": t(batch.targets, torch.int64),
        "target_lengths": t(batch.target_lengths, torch.int64),
        "n_examples": int(batch.n_examples),
        "seq_len": int(np.max(batch.target_lengths)) - 1,
    }


def compute_losses(model, batch: Dict[str, object], max_frames: int,
                   generator: Optional[torch.Generator] = None):
    """Returns (dec_loss, enc_loss) for a device batch, in the model's
    current mode (train or eval)."""
    targets = batch["targets"]
    enc_logits, dec_logits = model(
        batch["packed_raw"], batch["n_rows"], batch["offsets"], batch["lengths"],
        targets[:, :-1], max_frames, generator,
    )
    n = batch["n_examples"]
    enc_loss = ctc_loss(
        torch.log_softmax(enc_logits.float(), dim=-1), batch["lengths"], targets[:, 1:],
        (batch["target_lengths"] - 2).clamp(min=0), n,
    )
    dec_loss = label_smoothing_loss(dec_logits, targets[:, 1:], n, batch["seq_len"], epsilon=0.1)
    return dec_loss, enc_loss


def _check_ported(cfg) -> None:
    for name in ("scheduled_sampling_max_prob", "electrode_rotation_prob",
                 "channel_drop_prob", "time_drop_prob"):
        if getattr(cfg, name) > 0:
            raise NotImplementedError(f"train.{name} > 0 is not yet ported")


class _Clock:
    """Synchronized per-phase wall times of one step, in ms, when a list
    to append them to is given; otherwise nothing (no syncs)."""

    def __init__(self, sink: Optional[List[dict]], device):
        self.sink, self.device, self.times = sink, device, {}
        self._t = self._now()

    def _now(self):
        if self.sink is None:
            return 0.0
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def mark(self, phase: str) -> None:
        if self.sink is not None:
            t = self._now()
            self.times[phase] = (t - self._t) * 1e3
            self._t = t

    def close(self, **counts) -> None:
        if self.sink is not None:
            self.sink.append(dict(self.times, **counts))


def make_train_step(cfg, step_times: Optional[List[dict]] = None):
    """The microbatch step: train(state, batch, max_frames, generator) ->
    metrics. It runs forward and backward in train mode, adds the gradients
    into the accumulated sums, and applies AdamW at the microbatch's warmup
    LR when the summed example count reaches batch_size_grad. With
    ``step_times`` (a list), each step appends its synchronized
    forward/backward/optimizer ms."""
    _check_ported(cfg)
    alpha = cfg.alpha_loss

    def train_step(state: TrainState, batch: PackedBatch, max_frames: int,
                   generator: torch.Generator) -> dict:
        model = state.model.train()
        clock = _Clock(step_times, model.device)
        generator.manual_seed(step_seed(state.cfg.seed, state.microbatches))
        dev = batch_to_device(batch, model.device)
        dec_loss, enc_loss = compute_losses(model, dev, max_frames, generator)
        loss = combined_loss(dec_loss, enc_loss, alpha)
        clock.mark("forward")
        loss.backward()
        clock.mark("backward")
        n_accum = state.accum_examples + dev["n_examples"]
        lr = warmup_lr(state.cfg, state.microbatches)
        applied = n_accum >= state.cfg.batch_size_grad
        if applied:
            for group in state.optimizer.param_groups:
                group["lr"] = lr
            state.optimizer.step()
            state.optimizer.zero_grad(set_to_none=False)
            state.accum_examples = 0
            state.updates += 1
        else:
            state.accum_examples = n_accum
        state.microbatches += 1
        clock.mark("optimizer")
        clock.close(examples=dev["n_examples"], frames=int(np.sum(batch.lengths)),
                    max_frames=max_frames, applied=applied)
        return {"loss": loss.detach(), "dec_loss": dec_loss.detach(),
                "enc_loss": enc_loss.detach(), "lr": lr, "applied": applied}

    return train_step


def make_eval_step(cfg):
    """eval(model, batch, max_frames) -> device loss metrics, in eval mode
    (running BatchNorm statistics, no dropout, serving attention)."""
    alpha = cfg.alpha_loss

    @torch.no_grad()
    def eval_step(model, batch: PackedBatch, max_frames: int) -> dict:
        model.eval()
        dec_loss, enc_loss = compute_losses(model, batch_to_device(batch, model.device),
                                            max_frames)
        return {"loss": combined_loss(dec_loss, enc_loss, alpha), "dec_loss": dec_loss,
                "enc_loss": enc_loss}

    return eval_step
