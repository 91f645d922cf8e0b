"""The training loop: epochs, accumulation, evaluation, PER, checkpoints.

Counterpart of ``emg_tpu/train/trainer.py`` (one device), whose loop
mirrors the reference train_model (recognition_model.py:52-317):
dynamic-batch samplers reshuffled per epoch, per-microbatch train steps
with gradient accumulation, an evaluation pass over ``eval_batches`` dev
batches and a loss report every ``report_loss`` steps, a greedy PER report
(``per_train_batches`` train batches + the dev set) every ``report_PER``
epochs, best-dev-PER weights in ``model.pt``, the full state in ``latest``
after every epoch, and an early stop when the epoch's mean loss rounds to
zero.

Training batches are staged as int16 raw rows (``train.stage_int16``, the
JAX trainer's default), which the step dequantizes on the device; eval and
PER batches stay float32, as in the JAX package. The epoch's microbatches
run in the fused accumulation windows of ``train/window.py`` where
``train.fused_window`` resolves on (auto: on a CUDA device): planned ahead
as JAX's are, each window longer than one microbatch replayed as one CUDA
graph (eagerly on the CPU), every other microbatch its own step; the
numbers are the per-microbatch steps'. While a torch profiler runs (or
inside ``utils.profiling.recording()``) the batch assembly and each
per-microbatch step record spans (``utils/profiling.py``), which
synchronize nothing. The JAX trainer's prefetch threads are an XLA
dispatch device and have no counterpart. ``--resume`` continues from the
epoch after the one saved in ``latest``.

Device mesh (``parallel.data_axis`` / ``parallel.model_axis``, as the JAX
trainer's ``emg_tpu/train/trainer.py:66-123``): the trainer runs as one
rank of a process group (``parallel/distributed.py``: the CLI launches the
ranks), builds the mesh over its ranks (``parallel/mesh.py``; a mesh that
does not cover them, or more cards than the host has, raises), pads every
batch's rows and utterances to multiples of the data axis, shards the
parameters before AdamW is built (moments per shard) and steps on its
block of each batch (``parallel/train_step.py``), which computes what one
device computes. ``parallel.sequence_shard`` splits the encoder stream's
time over the model axis where that axis is over 1 (JAX ignores it
otherwise, and so does this trainer). The evaluation loss is the global
batch's; the PER report decodes with the whole model, gathered, on rank 0,
which alone writes the log, the metrics and the checkpoints, each the file
one device would write.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from emg_tpu_torch.config import Config
from emg_tpu_torch.data.batching import (
    FRAME_BUCKETS,
    bucket_up,
    make_packed_batch,
    quantize_packed_raw,
)
from emg_tpu_torch.data.dataset import EMGDataset
from emg_tpu_torch.data.sampler import DynamicBatchSampler
from emg_tpu_torch.decode.graphs import LoopRunner
from emg_tpu_torch.decode.greedy import run_greedy
from emg_tpu_torch.models.model import EMGModel
from emg_tpu_torch.parallel import distributed
from emg_tpu_torch.parallel.mesh import Mesh, full_state_dict, mesh_from_config, shard_params
from emg_tpu_torch.parallel.train_step import make_eval_step, make_train_step
from emg_tpu_torch.runtime import resolve_device
from emg_tpu_torch.text.metrics import wer
from emg_tpu_torch.train.checkpoint import CheckpointManager, load_weights, merge_params
from emg_tpu_torch.train.metrics_writer import MetricsWriter, NullMetricsWriter
from emg_tpu_torch.train.state import TrainState, create_train_state
from emg_tpu_torch.train.window import WindowRunner, plan_windows, windows_enabled

log = logging.getLogger(__name__)


class Trainer:
    """Trains ``config.model`` on ``device`` (default ``"cuda"``; raises
    without a card unless ``"cpu"`` is asked for)."""

    def __init__(self, config: Config, trainset: EMGDataset, devset: EMGDataset,
                 writer: MetricsWriter, device="cuda"):
        self.config = config
        self.device = resolve_device(device)
        self.mesh = self._build_mesh()
        # fused accumulation windows (train/window.py)
        self.windows = (WindowRunner(config.train, self.device)
                        if windows_enabled(config.train, self.device, self.mesh) else None)
        self.trainset = trainset
        self.devset = devset
        # only rank 0 writes metrics (the reported losses are global sums,
        # the same on every rank)
        self.writer = writer if distributed.is_primary() else NullMetricsWriter()
        self.ckpt = CheckpointManager(config.paths.output_directory, self.mesh)
        self.train_step = make_train_step(config.train)
        self.eval_step = make_eval_step(config.train)
        self.generator = torch.Generator(device=self.device)
        self.train_losses: List[float] = []  # every microbatch's loss, in order
        # each epoch's wall seconds: its microbatches, evaluation passes and
        # PER report, up to the checkpoint saves
        self.epoch_seconds: List[float] = []

    def _build_mesh(self) -> Optional[Mesh]:
        """The mesh over this process group's ranks, or None (one device).
        Outside a process group a mesh of more than one device raises: its
        ranks are processes, which the CLI launches."""
        pcfg = self.config.parallel
        if dist.is_initialized():
            shape = mesh_from_config(pcfg, dist.get_world_size())
            if shape is None:
                return None
            mesh = Mesh(shape, self.device)
            log.info("parallel mesh: %d data x %d model over %d ranks (%s)",
                     shape.data, shape.model, shape.size, dist.get_backend())
            if pcfg.sequence_shard and shape.model == 1:
                log.warning("parallel.sequence_shard acts on a model axis over 1: ignored")
            return mesh
        shape = mesh_from_config(pcfg, distributed.local_devices(pcfg, self.device))
        if shape is not None:
            raise RuntimeError(
                f"a {shape.data}x{shape.model} mesh trains as {shape.size} processes: start it "
                f"through the CLI (which launches them), torchrun or parallel.coordinator_address")
        return None

    # -- batch assembly ----------------------------------------------------
    def _prepare(self, dataset: EMGDataset, idxs: List[int], sharded: bool = True):
        """A batch as the step takes it: on a mesh (``sharded``) its rows and
        utterances padded to multiples of the data axis."""
        batch = EMGDataset.collate_raw([dataset[i] for i in idxs])
        dp = self.mesh.data if self.mesh is not None and sharded else 1
        pb = make_packed_batch(
            batch["raw_emg"], batch["lengths"], batch["phonemes_int"],
            chunk=self.config.data.packed_chunk, row_multiple=dp, batch_multiple=dp,
        )
        return pb, bucket_up(max(batch["lengths"]), FRAME_BUCKETS), batch

    # -- initialization ----------------------------------------------------
    def init_state(self) -> TrainState:
        """Random weights from a generator seeded with 0 (the JAX trainer
        initializes from PRNGKey(0)), warm-started from
        ``paths.start_training_from`` (a model.pt) where given."""
        model = EMGModel(self.config.model, device=self.device,
                         generator=torch.Generator().manual_seed(0))
        start = self.config.paths.start_training_from
        if start:
            n = merge_params(model, load_weights(start))
            log.info("warm started from %s (%d tensors)", start, n)
        if self.mesh is not None:
            pcfg = self.config.parallel
            shard_params(model, self.mesh,
                         sequence_shard=pcfg.sequence_shard or self.config.model.sequence_shard)
        return create_train_state(model, self.config.train)

    # -- evaluation --------------------------------------------------------
    def evaluation_loop(self, state: TrainState, sampler) -> Dict[str, float]:
        totals = {"loss": 0.0, "dec_loss": 0.0, "enc_loss": 0.0}
        steps = 0
        for step, idxs in enumerate(sampler):
            pb, max_frames, _ = self._prepare(self.devset, idxs)
            metrics = self.eval_step(state.model, pb, max_frames)
            for k in totals:
                totals[k] += float(metrics[k])
            steps += 1
            if step + 1 == self.config.train.eval_batches:
                break
        return {k: v / max(steps, 1) for k, v in totals.items()}

    def _whole_model(self, state: TrainState) -> Optional[EMGModel]:
        """The model whole, in eval mode: the live one on one device; on a
        mesh, on rank 0, a copy from the gathered weights (None elsewhere;
        every rank takes part in the gather)."""
        if self.mesh is None:
            return state.model.eval()
        weights = full_state_dict(state.model, self.mesh)
        if not distributed.is_primary():
            return None
        model = EMGModel(self.config.model, device=self.device)
        model.load_state_dict(weights)
        return model.eval()

    def report_PER(self, state: TrainState, train_sampler, dev_sampler, epoch: int,
                   batch_idx: int) -> float:
        model = self._whole_model(state)
        if model is None:  # a mesh rank but the first: rank 0 decodes
            return self.mesh.broadcast_object(None)
        # the float32 model; its graphs live for this report only
        runner = LoopRunner(model)

        def decode_set(dataset, sampler, max_batches=None):
            preds, refs, correct, total = [], [], 0, 0
            for step, idxs in enumerate(sampler):
                pb, max_frames, raw = self._prepare(dataset, idxs, sharded=False)
                S_true = int(max(raw["phonemes_int_lengths"]))
                strings, matrix = run_greedy(model, pb, max_frames, S_true - 1,
                                             pb.targets.shape[1] - 1, runner=runner)
                B = len(idxs)
                y = np.full((B, S_true), 42, np.int64)
                for b, p in enumerate(raw["phonemes_int"]):
                    y[b, : len(p)] = p
                preds += strings[:B]
                refs += raw["phonemes"]
                total += y.size
                correct += int((matrix[:B, :S_true] == y).sum())
                if max_batches and step + 1 == max_batches:
                    break
            return preds, refs, correct, total

        t_preds, t_refs, t_corr, t_total = decode_set(
            self.trainset, train_sampler, self.config.train.per_train_batches
        )
        d_preds, d_refs, d_corr, d_total = decode_set(self.devset, dev_sampler)
        train_per = wer(t_refs, t_preds)
        eval_per = wer(d_refs, d_preds)
        log.info("---- Prediction Evaluation ----")
        if d_preds:
            log.info("Evaluation Prediction: %s ---> Reference: %s (PER %.4f)",
                     d_preds[0], d_refs[0], wer(d_refs[0], d_preds[0]))
        w = self.writer
        w.add_scalar("PhonemeErrorRate/Training", train_per, batch_idx)
        w.add_scalar("PhonemeErrorRate/Evaluation", eval_per, batch_idx)
        w.add_scalar("PhonemeErrorRate_Epoch/Training", train_per, epoch)
        w.add_scalar("PhonemeErrorRate_Epoch/Evaluation", eval_per, epoch)
        w.add_scalar("Accuracy_Epoch/Training", round(100 * t_corr / max(t_total, 1), 1), epoch)
        w.add_scalar("Accuracy_Epoch/Evaluation", round(100 * d_corr / max(d_total, 1), 1), epoch)
        w.flush()
        if self.mesh is not None:
            eval_per = self.mesh.broadcast_object(eval_per)
        return eval_per

    # -- the loop ----------------------------------------------------------
    def train(self, state: Optional[TrainState] = None, start_epoch: int = 0,
              best_eval_PER: float = 10.0) -> TrainState:
        cfg = self.config.train
        if state is None:
            state = self.init_state()
        train_sampler = DynamicBatchSampler(
            self.trainset, cfg.max_batch_length, cfg.n_buckets,
            shuffle=True, batch_ordering="random", seed=cfg.seed, epoch=start_epoch,
        )
        dev_sampler = DynamicBatchSampler(
            self.devset, cfg.max_batch_length, cfg.n_buckets,
            shuffle=True, batch_ordering="random", seed=cfg.seed,
        )
        curr_eval_PER = 0.0
        batch_idx = state.microbatches
        run_train = {"loss": 0.0, "dec": 0.0, "enc": 0.0, "n": 0}
        # loss scalars stay on the device until a report boundary, so the
        # host queues microbatches without waiting on each one
        pending: List[dict] = []

        def drain_pending():
            for m in pending:
                loss = float(m["loss"])
                losses.append(loss)
                self.train_losses.append(loss)
                run_train["loss"] += loss
                run_train["dec"] += float(m["dec_loss"])
                run_train["enc"] += float(m["enc_loss"])
                run_train["n"] += 1
            pending.clear()

        for epoch_idx in range(start_epoch, cfg.n_epochs):
            losses: List[float] = []
            epoch_start = time.perf_counter()
            epoch_batches = list(train_sampler)
            windows = (plan_windows(epoch_batches, state.accum_examples, cfg)
                       if self.windows is not None else [1] * len(epoch_batches))
            step = 0
            for wlen in windows:
                group = []
                for idxs in epoch_batches[step: step + wlen]:
                    pb, max_frames, _ = self._prepare(self.trainset, idxs)
                    if cfg.stage_int16:
                        pb = quantize_packed_raw(pb)
                    group.append((pb, max_frames))
                metrics = self.windows.run(state, group) if wlen > 1 else None
                if metrics is None:  # a window of one, or past the signature cap
                    metrics = [self.train_step(state, pb, max_frames, self.generator)
                               for pb, max_frames in group]
                pending.extend(metrics)
                batch_idx += wlen
                step += wlen
                if step % cfg.report_loss == 0:
                    drain_pending()
                    ev = self.evaluation_loop(state, dev_sampler)
                    n = max(run_train["n"], 1)
                    w = self.writer
                    w.add_scalar("Loss/Training", round(run_train["loss"] / n, 3), batch_idx)
                    w.add_scalar("Loss_Decoder/Training", round(run_train["dec"] / n, 3), batch_idx)
                    w.add_scalar("Loss_Encoder/Training", round(run_train["enc"] / n, 3), batch_idx)
                    w.add_scalar("Loss/Evaluation", round(ev["loss"], 3), batch_idx)
                    w.add_scalar("Loss_Decoder/Evaluation", round(ev["dec_loss"], 3), batch_idx)
                    w.add_scalar("Loss_Encoder/Evaluation", round(ev["enc_loss"], 3), batch_idx)
                    w.flush()
                    run_train = {"loss": 0.0, "dec": 0.0, "enc": 0.0, "n": 0}

            drain_pending()
            train_sampler.set_epoch(epoch_idx + 1)
            if epoch_idx % cfg.report_PER == 0:
                curr_eval_PER = self.report_PER(state, train_sampler, dev_sampler, epoch_idx,
                                                batch_idx)
            mean_loss = float(np.mean(losses)) if losses else 0.0
            self.epoch_seconds.append(time.perf_counter() - epoch_start)
            log.info("-----finished epoch %d - training loss: %.4f (%.1fs)------",
                     epoch_idx + 1, mean_loss, self.epoch_seconds[-1])
            if curr_eval_PER < best_eval_PER:
                self.ckpt.save_params(state.model, "model.pt")
                best_eval_PER = curr_eval_PER
            self.ckpt.save(state, "latest", extra={"epoch": epoch_idx,
                                                   "best_eval_PER": best_eval_PER})
            if round(mean_loss, 1) == 0.0:
                break
        return state

    def resume(self) -> TrainState:
        """Continue from ``latest``: the saved state, from the epoch after
        the saved one, with the saved best PER, so a resumed run ends where
        an uninterrupted one would. This departs from the JAX CLI, which
        restores the state but restarts the epoch count (and the sampler's
        epochs) at 0 with a best PER of 10.0."""
        state, extra = self.ckpt.restore(self.init_state(), "latest")
        log.info("resumed from %s (epoch %s, %d microbatches)",
                 self.config.paths.output_directory, extra.get("epoch"), state.microbatches)
        return self.train(state, start_epoch=int(extra["epoch"]) + 1,
                          best_eval_PER=float(extra.get("best_eval_PER", 10.0)))
