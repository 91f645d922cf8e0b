"""Training and eval steps with gradient accumulation.

Counterpart of ``emg_tpu/parallel/train_step.py`` (one device). The loss
wiring follows the reference training loop (recognition_model.py:77-118):
teacher inputs are targets[:, :-1], CE targets targets[:, 1:], CTC labels
the phoneme ids stripped of <S>/</S> (targets[:, 1:] with label lengths
minus 2), CTC input lengths the encoder frame counts, and the two losses
combine as (1-alpha)*dec + alpha*enc. Gradients sum across microbatches and
apply once the summed example count reaches batch_size_grad, at the warmup
LR of the *microbatch* counter.

The training recipes (``train/recipes.py``) act here, as in the JAX step
(``emg_tpu/parallel/train_step.py:71-97, 145-185``):
- the raw-EMG augmentations (``augment_packed``), after the int16
  dequantization and before the model (so before its time shift):
  electrode rotation (roll the channel axis by +1 or -1), channel drop (a
  (C,) keep mask over every packed row) and time drop (one span over the
  flattened N*L packed stream, which may cross rows);
- parallel scheduled sampling (``scheduled_sampling_inputs``): a
  gradient-free first pass in eval mode (running BatchNorm statistics, no
  shift, no dropout, the serving attention) on the augmented batch; its
  argmax, shifted right behind the leading <S>, replaces each teacher input
  but the first with probability ss_prob = max_prob * min(1, microbatches
  / max(ramp, 1)); then the train-mode pass on the mixed inputs.

On a device mesh (the model put there by ``parallel/mesh.py::
shard_params``) every rank runs this step on its block of the batch
(``mesh.shard_batch``), as JAX's global-view step runs on its shards:

- the loss is the global mean: each rank's losses are its real rows' sums
  over the global example (CTC) and token (CE) counts, so the data ranks'
  losses add up to the one-device loss (the metrics are that sum);
- each microbatch's gradients are summed over the data axis, and for the
  replicated parameters that split work feeds (``mesh.
  grad_sums_over_model``) over the model axis too, before they join the
  accumulated sums, so every rank holds the one-device sums (its blocks of
  them) and AdamW applies alike everywhere;
- the example count, and so the apply decision, is the global batch's;
- every draw is made at the global shape from the same generator state on
  every rank, and each rank keeps its slice (the recipes' draws here, the
  dropouts in the model), so a sharded step draws one device's numbers.

Randomness: each microbatch reseeds the caller's ``torch.Generator`` from
(train.seed, microbatch counter), as the JAX step folds the counter into
its key, so a resumed run draws what an uninterrupted one would. The step
draws the recipes' randomness first (``draw_recipe_randomness``: only the
draws whose knob is on, so with every knob at 0 the sequence is the one
without recipes), then the time shift, then the dropout masks in forward
order. Every draw is made on the generator's device; none is read back to
the host.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
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


def batch_to_device(batch: PackedBatch, device, mesh=None) -> Dict[str, object]:
    """A host ``PackedBatch`` as device tensors, with the host integers the
    losses and the recipe draws go by: ``n_examples``, the true teacher
    length ``seq_len``, the CE's target token count ``n_tokens``, the
    first utterance's global index ``row_offset`` and the batch's shapes
    (``packed_shape``, ``n_targets``). On a ``mesh`` the tensors are the
    rank's block of the batch and the integers stay global."""
    from emg_tpu_torch.text.phonemes import PAD_ID

    def t(a, dtype=None):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    n = int(batch.n_examples)
    extra = {"row_offset": 0, "packed_shape": tuple(batch.packed_raw.shape),
             "n_targets": len(batch.lengths),
             "n_tokens": int((np.asarray(batch.targets)[:n, 1:] != PAD_ID).sum())}
    seq_len = int(np.max(batch.target_lengths)) - 1
    if mesh is not None:
        from emg_tpu_torch.parallel.mesh import shard_batch

        local = shard_batch(batch, mesh)
        extra.update(row_offset=local.row_offset, packed_shape=local.packed_shape,
                     n_targets=local.n_targets)
        batch = local.batch
    return {
        "packed_raw": dequantize_packed_raw(t(batch.packed_raw)),
        "n_rows": int(batch.n_rows),
        "offsets": t(batch.offsets, torch.int64),
        "lengths": t(batch.lengths, torch.int64),
        "targets": t(batch.targets, torch.int64),
        "target_lengths": t(batch.target_lengths, torch.int64),
        "n_examples": n,
        "seq_len": seq_len,
        **extra,
    }


def compute_losses(model, batch: Dict[str, object], max_frames: int,
                   generator: Optional[torch.Generator] = None,
                   tgt_in: Optional[torch.Tensor] = None):
    """Returns (dec_loss, enc_loss) for a device batch, in the model's
    current mode (train or eval). The decoder's inputs are ``tgt_in``
    where given, else the teacher's targets[:, :-1]."""
    targets = batch["targets"]
    enc_logits, dec_logits = model(
        batch["packed_raw"], batch["n_rows"], batch["offsets"], batch["lengths"],
        targets[:, :-1] if tgt_in is None else tgt_in, max_frames, generator,
    )
    n = batch["n_examples"]
    row_offset = batch["row_offset"]  # a mesh rank's share of the loss (0: one device)
    enc_loss = ctc_loss(
        torch.log_softmax(enc_logits.float(), dim=-1), batch["lengths"], targets[:, 1:],
        (batch["target_lengths"] - 2).clamp(min=0), n, row_offset=row_offset,
    )
    dec_loss = label_smoothing_loss(dec_logits, targets[:, 1:], n, batch["seq_len"],
                                    batch["n_tokens"], epsilon=0.1, row_offset=row_offset)
    return dec_loss, enc_loss


@dataclass
class RecipeDraws:
    """One microbatch's recipe randomness, as device tensors; a field is
    None where its knob is off."""
    rotation_shift: Optional[torch.Tensor] = None  # () int64: 0 (not this step), +1 or -1
    channel_keep: Optional[torch.Tensor] = None  # (C,) bool
    time_drop: Optional[torch.Tensor] = None  # (N*L,) bool: the dropped span
    ss_mix: Optional[torch.Tensor] = None  # (B, S-1) bool, False at position 0


def draw_recipe_randomness(generator: torch.Generator, cfg, packed_shape, seq_len: int,
                           n_targets: int, ss_prob: float) -> RecipeDraws:
    """The recipes' draws for a packed batch of ``packed_shape`` (N, L, C)
    and ``n_targets`` teacher rows of ``seq_len`` inputs, in a fixed order
    (rotation, channel drop, time drop, scheduled sampling), each only where
    its knob is on. Bernoulli(p) is a uniform draw below p, as
    ``jax.random.bernoulli``."""
    dev = generator.device
    N, L, C = packed_shape

    def uniform(shape=()):
        return torch.rand(shape, generator=generator, device=dev)

    draws = RecipeDraws()
    if cfg.electrode_rotation_prob > 0:
        do = uniform() < cfg.electrode_rotation_prob
        up = uniform() < 0.5
        draws.rotation_shift = torch.where(do, torch.where(up, 1, -1), 0)
    if cfg.channel_drop_prob > 0:
        draws.channel_keep = ~(uniform((C,)) < cfg.channel_drop_prob)
    if cfg.time_drop_prob > 0:
        do = uniform() < cfg.time_drop_prob
        total = N * L
        start = torch.randint(0, total, (), generator=generator, device=dev)
        length = torch.randint(1, cfg.time_drop_max_samples + 1, (), generator=generator,
                               device=dev)
        draws.time_drop = time_drop_span(total, start, length, do)
    if cfg.scheduled_sampling_max_prob > 0:
        mix = uniform((n_targets, seq_len)) < ss_prob
        draws.ss_mix = mix & (torch.arange(seq_len, device=dev)[None, :] >= 1)
    return draws


def time_drop_span(total: int, start: torch.Tensor, length: torch.Tensor,
                   do: torch.Tensor) -> torch.Tensor:
    """(total,) bool: positions [start, start + length) where ``do``."""
    pos = torch.arange(total, device=start.device)
    return (pos >= start) & (pos < start + length) & do


def local_draws(draws: RecipeDraws, dev: Dict[str, object]) -> RecipeDraws:
    """A mesh rank's slice of draws made at the global batch's shapes: the
    time-drop span over its packed rows, the scheduled-sampling mix over
    its utterances (rotation and channel drop act on every row alike); on
    one device, the draws whole."""
    N, L = dev["packed_raw"].shape[:2]
    B = dev["targets"].shape[0]
    first_row = N * (dev["row_offset"] // B)  # the rank's rows: its data index's block
    return RecipeDraws(
        rotation_shift=draws.rotation_shift, channel_keep=draws.channel_keep,
        time_drop=(None if draws.time_drop is None
                   else draws.time_drop[first_row * L: (first_row + N) * L]),
        ss_mix=(None if draws.ss_mix is None
                else draws.ss_mix[dev["row_offset"]: dev["row_offset"] + B]))


def augment_packed(packed: torch.Tensor, draws: RecipeDraws) -> torch.Tensor:
    """The raw-EMG augmentations of ``draws`` on packed rows (N, L, C), in
    the JAX step's order: rotation, channel drop, time drop (the rows as
    they are where no knob is on). Pure gathers, 0/1 products and selects,
    so equal draws give bitwise-equal rows."""
    N, L, C = packed.shape
    if draws.rotation_shift is not None:
        # roll by the drawn shift with no host read: out[c] = x[(c - s) mod C]
        idx = (torch.arange(C, device=packed.device) - draws.rotation_shift) % C
        packed = packed.index_select(2, idx)
    if draws.channel_keep is not None:
        packed = packed * draws.channel_keep[None, None, :].to(packed.dtype)
    if draws.time_drop is not None:
        packed = torch.where(draws.time_drop.reshape(N, L)[:, :, None], 0.0, packed)
    return packed


def scheduled_sampling_inputs(model, batch: Dict[str, object], max_frames: int,
                              mix: torch.Tensor) -> torch.Tensor:
    """Parallel scheduled sampling's decoder inputs: a gradient-free pass in
    eval mode (running BatchNorm statistics, which it leaves as they are;
    no shift, no dropout; the serving attention), its argmax shifted right
    behind the leading <S>, taken where ``mix`` is set. The model is back in
    train mode on return."""
    first = batch["targets"][:, :-1]
    model.eval()
    try:
        with torch.no_grad():
            _, dec_logits = model(batch["packed_raw"], batch["n_rows"], batch["offsets"],
                                  batch["lengths"], first, max_frames)
    finally:
        model.train()
    # the prediction for input position j is the model's output at j - 1
    preds = dec_logits.argmax(dim=-1)
    pred_inputs = torch.cat([first[:, :1], preds[:, :-1]], dim=1)
    return torch.where(mix, pred_inputs, first)


def backward_on_mesh(model, loss: torch.Tensor) -> None:
    """The backward of a mesh rank's loss: this microbatch's gradients,
    summed over the data axis (one all-reduce of them all) and, for the
    replicated parameters that split work feeds, over the model axis (one
    more), then added into the accumulated sums in ``.grad``."""
    from emg_tpu_torch.parallel.mesh import flat_all_reduce, grad_sums_over_model

    mesh = model.mesh
    named = list(model.named_parameters())
    grads = torch.autograd.grad(loss, [p for _, p in named], allow_unused=True)
    grads = flat_all_reduce([torch.zeros_like(p) if g is None else g
                             for (_, p), g in zip(named, grads)], mesh, "data")
    seq = model.transformerEncoder.sequence_shard
    partial = [i for i, (name, _) in enumerate(named) if grad_sums_over_model(name, seq)]
    for i, g in zip(partial, flat_all_reduce([grads[i] for i in partial], mesh, "model")):
        grads[i] = g
    with torch.no_grad():
        for (_, p), g in zip(named, grads):
            p.grad.add_(g)


def reported(metrics: Dict[str, torch.Tensor], mesh) -> Dict[str, torch.Tensor]:
    """Loss metrics of the whole batch: on a mesh, the data ranks' shares
    summed (one all-reduce), the same value on every rank."""
    if mesh is None:
        return metrics
    names = list(metrics)
    total = mesh.all_reduce(torch.stack([metrics[k].detach() for k in names]), "data")
    return {k: total[i] for i, k in enumerate(names)}


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
    alpha = cfg.alpha_loss

    def train_step(state: TrainState, batch: PackedBatch, max_frames: int,
                   generator: torch.Generator) -> dict:
        model = state.model.train()
        mesh = model.mesh
        clock = _Clock(step_times, model.device)
        generator.manual_seed(step_seed(state.cfg.seed, state.microbatches))
        dev = batch_to_device(batch, model.device, mesh)
        targets = dev["targets"]
        ss_prob = cfg.scheduled_sampling_max_prob * min(
            1.0, state.microbatches / max(cfg.scheduled_sampling_ramp, 1))
        draws = draw_recipe_randomness(generator, cfg, dev["packed_shape"],
                                       targets.shape[1] - 1, dev["n_targets"], ss_prob)
        draws = local_draws(draws, dev)
        dev["packed_raw"] = augment_packed(dev["packed_raw"], draws)
        tgt_in = None
        if draws.ss_mix is not None:
            tgt_in = scheduled_sampling_inputs(model, dev, max_frames, draws.ss_mix)
        dec_loss, enc_loss = compute_losses(model, dev, max_frames, generator, tgt_in)
        loss = combined_loss(dec_loss, enc_loss, alpha)
        clock.mark("forward")
        if mesh is None:
            loss.backward()
        else:
            backward_on_mesh(model, loss)
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
        metrics = reported({"loss": loss.detach(), "dec_loss": dec_loss.detach(),
                            "enc_loss": enc_loss.detach()}, mesh)
        return {**metrics, "lr": lr, "applied": applied}

    return train_step


def make_eval_step(cfg):
    """eval(model, batch, max_frames) -> device loss metrics, in eval mode
    (running BatchNorm statistics, no dropout, serving attention)."""
    alpha = cfg.alpha_loss

    @torch.no_grad()
    def eval_step(model, batch: PackedBatch, max_frames: int) -> dict:
        model.eval()
        dec_loss, enc_loss = compute_losses(model, batch_to_device(batch, model.device,
                                                                   model.mesh), max_frames)
        return reported({"loss": combined_loss(dec_loss, enc_loss, alpha), "dec_loss": dec_loss,
                         "enc_loss": enc_loss}, model.mesh)

    return eval_step
