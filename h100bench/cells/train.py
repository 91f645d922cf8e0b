"""The training cells: the trainer's inner loop on a seeded corpus.

Set-up: the utterances of the mix, the port's batched device DSP over all of
them once (as a job's example cache holds them after its first epoch), the
weights made from the seed on the card, and one train state (model and
AdamW) that the whole run uses. Its first three windows run in set-up and
are what the reference follows; set-up then finishes the first epoch, so
that the window starts on a warm allocator.

The loop is the trainer's (``train/trainer.py:269-287``): each epoch's
batches from ``DynamicBatchSampler``, cut by ``plan_windows``, each window's
microbatches packed (``make_packed_batch``), staged to int16
(``quantize_packed_raw``) and offered to ``WindowRunner.run``; the
configuration's ``window_max_compiles`` of 0 makes it decline every window,
as a job's runner declines each new signature past its cap, so every
microbatch, in set-up, in the check and in the window alike, runs through
``make_train_step``'s step. Losses are read at every ``report_loss``
boundary and epoch end. Per-epoch evaluation, the PER report and
checkpoints are left out.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from typing import Dict, List

import numpy as np
import torch

from h100bench import flops, judge, trace
from h100bench.reference import model as ref_model
from h100bench.reference import train as ref_train
from h100bench.reference.weights import make_weights
from h100bench.traffic import make_utterances

DSP_BUCKETS = (4096, 8192, 16384, 32768)
DSP_GROUP = 64  # utterances a batched DSP call
CHECK_STEPS = 3  # optimizer steps the reference follows


def port_config(cfg: dict, mix: dict):
    from emg_tpu_torch.config import Config

    c = Config()
    for key in ("model_size", "feed_forward_layer_size", "num_layers_encoder",
                "num_layers_decoder", "n_heads_encoder", "n_heads_decoder", "relative_distance",
                "dropout_model", "dropout_pos_emb", "encoder_kind", "conformer_conv_kernel_size",
                "num_channels", "compute_dtype", "decoder_pe"):
        setattr(c.model, key, cfg[key])
    c.train.window_max_compiles = cfg["window_max_compiles"]
    t = mix["train"]
    for key in ("max_batch_length", "n_buckets", "batch_size_grad", "learning_rate",
                "learning_rate_warmup", "alpha_loss", "report_loss", "seed", "stage_int16",
                "fused_window"):
        if key in t:
            setattr(c.train, key, t[key])
    c.data.packed_chunk = t["packed_chunk"]
    return c


def device_dsp(utts, device) -> List[tuple]:
    """Each utterance's training rows (soft-clipped 689.06 Hz signal) and
    frame count, from the port's batched DSP, as the dataset keeps them."""
    from emg_tpu_torch.dsp.pipeline import align_lengths, preprocess_emg_batched

    out: List[tuple] = [None] * len(utts)
    order = sorted(range(len(utts)), key=lambda i: utts[i].raw.shape[0])
    for start in range(0, len(order), DSP_GROUP):
        idxs = order[start: start + DSP_GROUP]
        n = [utts[i].raw.shape[0] for i in idxs]
        T = next(b for b in DSP_BUCKETS if b >= max(n))
        buf = np.zeros((len(idxs), T, utts[idxs[0]].raw.shape[1]), np.float32)
        for j, i in enumerate(idxs):
            buf[j, : n[j]] = utts[i].raw
        zeros = [0] * len(idxs)
        pre = preprocess_emg_batched(torch.as_tensor(buf, device=device), n, zeros, zeros)
        frames = pre.n_frames.cpu().numpy()
        emg_orig = pre.emg_orig.cpu().numpy()
        for j, i in enumerate(idxs):
            (_, _), (r0, rlen) = align_lengths(int(frames[j]))
            rows = emg_orig[j, r0: r0 + rlen].astype(np.float32) / 20.0
            out[i] = ((50.0 * np.tanh(rows / 50.0)).astype(np.float32), int(frames[j]))
    return out


class _Corpus:
    """What ``DynamicBatchSampler`` reads of a dataset: ``example_indices``
    over a directory of ``<i>_info.json`` files (each utterance's raw sample
    count as its one chunk) and a length."""

    class _Dir:
        def __init__(self, directory):
            self.directory = directory

    def __init__(self, directory: str, raw_lengths: List[int]):
        for i, n in enumerate(raw_lengths):
            with open(os.path.join(directory, f"{i}_info.json"), "w") as f:
                json.dump({"chunks": [[int(n)]], "text": "x"}, f)
        d = self._Dir(directory)
        self.example_indices = [(d, i) for i in range(len(raw_lengths))]

    def __len__(self):
        return len(self.example_indices)


class TrainLoop:
    """The trainer's inner loop over epochs, one window at a time."""

    def __init__(self, config, model_cfg: dict, inputs, phones, weights: Dict[str, torch.Tensor],
                 corpus: _Corpus, device):
        from emg_tpu_torch.data.sampler import DynamicBatchSampler
        from emg_tpu_torch.models.model import EMGModel
        from emg_tpu_torch.parallel.train_step import make_train_step
        from emg_tpu_torch.train.state import create_train_state
        from emg_tpu_torch.train.window import WindowRunner, windows_enabled

        self.cfg, self.model_cfg, self.device = config, model_cfg, device
        self.inputs, self.phones = inputs, phones
        model = EMGModel(config.model, device=device)
        missing, unexpected = model.load_state_dict(weights, strict=False)
        buffers = {n for n, _ in model.named_buffers()}
        if unexpected or set(missing) - buffers:
            raise KeyError(f"weights do not fit the model: missing {sorted(set(missing) - buffers)}"
                           f", unexpected {sorted(unexpected)}")
        self.state = create_train_state(model, config.train)
        self.runner = (WindowRunner(config.train, device)
                       if windows_enabled(config.train, device) else None)
        self.step_fn = make_train_step(config.train)
        self.generator = torch.Generator(device=device)
        self.sampler = DynamicBatchSampler(
            corpus, config.train.max_batch_length, config.train.n_buckets, shuffle=True,
            batch_ordering="random", seed=config.train.seed, epoch=0)
        self.pending: List[dict] = []
        self.losses: List[float] = []  # every microbatch's loss, read as the trainer reads it
        self.reset_counts()
        self.epoch = 0
        self._new_epoch()

    def _new_epoch(self):
        from emg_tpu_torch.train.window import plan_windows

        t0 = time.perf_counter()
        self.batches = list(self.sampler)
        self.plan = (plan_windows(self.batches, self.state.accum_examples, self.cfg.train)
                     if self.runner is not None else [1] * len(self.batches))
        self.at_window, self.at_batch = 0, 0
        self.host_s += time.perf_counter() - t0

    def _prepare(self, idxs):
        from emg_tpu_torch.data.batching import (FRAME_BUCKETS, bucket_up, make_packed_batch,
                                                 quantize_packed_raw)

        rows = [self.inputs[i][0] for i in idxs]
        frames = [self.inputs[i][1] for i in idxs]
        pb = make_packed_batch(rows, frames, [self.phones[i] for i in idxs],
                               chunk=self.cfg.data.packed_chunk)
        if self.cfg.train.stage_int16:
            pb = quantize_packed_raw(pb)
        return pb, bucket_up(max(frames), FRAME_BUCKETS)

    def drain(self):
        for m in self.pending:
            self.losses.append(float(m["loss"]))
        self.pending.clear()

    def window(self) -> List[dict]:
        """Run the next window; returns its microbatches' metrics."""
        if self.at_window == len(self.plan):
            self.drain()
            self.epoch += 1
            self.sampler.set_epoch(self.epoch)
            self._new_epoch()
        wlen = self.plan[self.at_window]
        t0 = time.perf_counter()
        idxs_list = self.batches[self.at_batch: self.at_batch + wlen]
        group = [self._prepare(idxs) for idxs in idxs_list]
        self.host_s += time.perf_counter() - t0
        metrics = self.runner.run(self.state, group) if wlen > 1 else None
        if metrics is None:
            metrics = [self.step_fn(self.state, pb, mf, self.generator) for pb, mf in group]
        for idxs, (pb, mf) in zip(idxs_list, group):
            fr = [self.inputs[i][1] for i in idxs]
            self.frames += sum(fr)
            self.microbatches += 1
            self.shapes.append((int(pb.targets.shape[0]), int(mf)))
            self.flops += 3.0 * sum(flops.forward_flops(self.model_cfg, f,
                                                        len(self.phones[i]) - 1)
                                    for f, i in zip(fr, idxs))
        self.pending.extend(metrics)
        self.at_window += 1
        self.at_batch += wlen
        if self.at_batch % self.cfg.train.report_loss == 0:
            self.drain()
        return metrics

    def reset_counts(self):
        self.host_s = 0.0  # host seconds assembling batches
        self.frames = 0  # real frames of every microbatch run
        self.microbatches = 0
        self.flops = 0.0  # 3x the analytic forward FLOPs of every microbatch run
        self.shapes: List[tuple] = []  # (B, T) of each microbatch's encoder input



def program_readings(loop: TrainLoop, steps: int) -> dict:
    """Drive ``loop`` from the seed through its first ``steps`` windows,
    each ending in an optimizer apply: every microbatch's loss, the first
    step's gradient as AdamW holds it (exp_avg / (1 - beta1)) and each
    leaf's change after the last, as norms by parameter name."""
    state = loop.state
    named = list(state.model.named_parameters())
    p0 = {n: p.detach().clone() for n, p in named}
    losses, grad1 = [], None
    for step in range(steps):
        metrics = loop.window()
        losses += [float(m["loss"]) for m in metrics]
        if state.updates != step + 1:
            raise RuntimeError(f"window {step + 1} did not end in an optimizer apply")
        if grad1 is None:
            beta1 = state.optimizer.param_groups[0]["betas"][0]
            held = {n: state.optimizer.state.get(p, {}).get("exp_avg") for n, p in named}
            grad1 = {n: 0.0 if m is None else float(m.norm()) / (1.0 - beta1)
                     for n, m in held.items()}
    delta = {n: float((p.detach() - p0[n]).norm()) for n, p in named}
    return {"losses": losses, "grad1": grad1, "delta": delta}


def inputs_of(cell):
    """The run's utterances and the seed of its weights."""
    return make_utterances(cell.traffic, cell.traffic["utterances"], cell.seed), cell.seed + 1


def build(cell):
    """Set-up to the first window: (utterances, weight seed, loop)."""
    device = cell.device
    cfg, mix = cell.config, cell.traffic
    config = port_config(cfg, mix)
    utts, weight_seed = inputs_of(cell)
    inputs = device_dsp(utts, device)
    weights = make_weights(ref_model.param_spec(cfg), weight_seed, device)
    with tempfile.TemporaryDirectory(prefix="h100bench-") as directory:
        corpus = _Corpus(directory, [u.raw.shape[0] for u in utts])
        loop = TrainLoop(config, cfg, inputs, [u.phones for u in utts], weights, corpus, device)
    return utts, weight_seed, loop


def reference(cell, utts, weight_seed: int, precision: str = "float32") -> dict:
    return ref_train.follow(cell.config, cell.traffic["train"], [u.raw for u in utts],
                            [u.phones for u in utts], weight_seed, CHECK_STEPS, precision,
                            cell.device)


def run(cell) -> dict:
    """One run of a training cell (``cell``: see ``run.Cell``)."""
    device = cell.device
    cfg, mix = cell.config, cell.traffic
    utts, weight_seed, loop = build(cell)
    prog = program_readings(loop, CHECK_STEPS)
    while loop.epoch == 0 and loop.at_window < len(loop.plan):
        loop.window()
    loop.drain()
    cell.sync()
    setup_peak = cell.memory_peak()

    # the measured window
    cell.reset_memory_peak()
    loop.reset_counts()
    t0 = cell.window_starts()
    while time.perf_counter() - t0 < cell.seconds:
        loop.window()
    loop.drain()
    cell.sync()
    window_s = time.perf_counter() - t0
    out = {"window_s": window_s, "frames": loop.frames, "microbatches": loop.microbatches,
           "host_batch_s": loop.host_s, "train_flops": loop.flops,
           "window_peak_bytes": cell.memory_peak(), "model": cfg}
    metrics = {"train_frames_per_s": loop.frames / window_s}
    attempted = loop.microbatches

    if cell.trace:
        loop.reset_counts()

        def segment_run():
            for _ in range(mix["trace_windows"]):
                loop.window()
            loop.drain()

        segment = trace.traced(segment_run, device)
        out.update(segment=segment, segment_shapes=list(loop.shapes),
                   heads=cfg["n_heads_encoder"], head_dim=cfg["model_size"] // cfg["n_heads_encoder"],
                   layers=cfg["num_layers_encoder"])
    peak = max(setup_peak, cell.memory_peak())
    # free the program before the reference runs
    del loop
    cell.free()

    numbers = judge.train_numbers(prog, reference(cell, utts, weight_seed))
    return {"metrics": metrics, "numbers": numbers, "context": out, "memory_peak": peak,
            "attempted": attempted, "failed": 0}
