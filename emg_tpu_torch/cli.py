"""CLI entry point of the port: training and saved-model greedy evaluation.

Counterpart of ``emg_tpu/cli.py`` (reference recognition_model.py:385-420):

  python -m emg_tpu_torch.cli --output_directory OUT [--resume] \\
      [--start_training_from MODEL.pt] [--device cuda|cpu] [--section.key value ...]
  python -m emg_tpu_torch.cli --evaluate_saved_greedy_search MODEL.pt \\
      [--device cuda|cpu] [--section.key value ...]

With no evaluate flag it trains (``train.trainer.Trainer``), logging to
<output_directory>/log.txt and writing ``latest`` (the full train state,
which ``--resume`` continues from) and ``model.pt`` (the best weights).
``--evaluate_saved_greedy_search`` decodes the test split greedily at batch
1 and reports PER + token accuracy in <output_directory>/log_greedy_search.txt,
in the reference's format. A checkpoint is a ``torch.save``d state dict in
the reference's key names: the port's model.pt, a reference ``.pt`` file,
or ``utils/convert.py::state_dict_from_flax`` of the JAX package's
variables. Beam search is not ported yet and stops with an error.
``--debug`` runs on the CPU whatever ``--device`` says, as the reference's
``--debug`` does.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import sys

import numpy as np

from emg_tpu_torch.config import Config

log = logging.getLogger(__name__)


def _setup_logging(output_directory: str, filename: str):
    os.makedirs(output_directory, exist_ok=True)
    logging.basicConfig(
        handlers=[
            logging.FileHandler(os.path.join(output_directory, filename), "w"),
            logging.StreamHandler(),
        ],
        level=logging.INFO,
        format="%(message)s",
        force=True,
    )


def prepare_single(cfg: Config, testset, i: int):
    """One test utterance as a bucketed batch of 1: (PackedBatch,
    max_frames, collated raw example)."""
    from emg_tpu_torch.data.batching import FRAME_BUCKETS, bucket_up, make_packed_batch
    from emg_tpu_torch.data.dataset import EMGDataset

    batch = EMGDataset.collate_raw([testset[i]])
    pb = make_packed_batch(
        batch["raw_emg"], batch["lengths"], batch["phonemes_int"],
        chunk=cfg.data.packed_chunk,
    )
    max_frames = bucket_up(max(batch["lengths"]), FRAME_BUCKETS)
    return pb, max_frames, batch


def load_model_for_eval(cfg: Config, ckpt_path: str, device="cuda"):
    """The serving model at ``decode.compute_dtype`` (bfloat16 by default;
    parameters stay float32) with the checkpoint's weights, in eval mode."""
    from emg_tpu_torch.models.model import EMGModel
    from emg_tpu_torch.train.checkpoint import load_weights

    if cfg.decode.quantize_int8:
        raise NotImplementedError("--decode.quantize_int8 is not yet ported")
    model = EMGModel(
        dataclasses.replace(cfg.model, compute_dtype=cfg.decode.compute_dtype),
        device=device,
    )
    model.load_state_dict(load_weights(ckpt_path), strict=True)
    return model.eval()


def evaluate_saved_greedy_search(cfg: Config, device="cuda"):
    """Greedy PER of the checkpoint at ``paths.evaluate_saved_greedy_search``
    over the test split. Returns (PER, token accuracy in percent)."""
    from emg_tpu_torch.data.dataset import EMGDataset
    from emg_tpu_torch.decode.greedy import run_greedy
    from emg_tpu_torch.text.metrics import wer

    testset = EMGDataset(cfg, test=True, device=device)
    model = load_model_for_eval(cfg, cfg.paths.evaluate_saved_greedy_search, device)
    references, predictions = [], []
    running_total = running_correct = 0
    for i in range(len(testset)):
        pb, max_frames, raw = prepare_single(cfg, testset, i)
        S_true = int(raw["phonemes_int_lengths"][0])
        strings, matrix = run_greedy(
            model, pb, max_frames, S_true - 1, pb.targets.shape[1] - 1,
        )
        y = np.asarray(raw["phonemes_int"][0], np.int64)[None, :S_true]
        matrix = matrix[:1, :S_true]
        predictions += strings[:1]
        references += raw["phonemes"]
        running_total += y.size
        running_correct += int((matrix == y).sum())
        log.info(
            "Prediction:%s ---> Reference:%s  (PER: %s)",
            strings[0], raw["phonemes"][0], wer(raw["phonemes"][0], strings[0]),
        )
    per = wer(references, predictions)
    acc = round(100 * running_correct / max(running_total, 1), 1)
    log.info("PER: %s and accuracy: %s", per, acc)
    return per, acc


def train(cfg: Config, device="cuda"):
    """Train on the split the config names; ``--resume`` continues from
    <output_directory>/latest where it exists. Returns the Trainer."""
    from emg_tpu_torch.data.dataset import EMGDataset
    from emg_tpu_torch.train.metrics_writer import MetricsWriter, default_log_dir
    from emg_tpu_torch.train.trainer import Trainer

    trainset = EMGDataset(cfg, dev=False, test=False, device=device)
    devset = EMGDataset(cfg, dev=True, device=device)
    log.info("train / dev split: %d %d", len(trainset), len(devset))
    writer = MetricsWriter(default_log_dir(os.path.join(cfg.paths.output_directory, "logs", "run")))
    trainer = Trainer(cfg, trainset, devset, writer, device=device)
    try:
        if cfg.paths.resume and trainer.ckpt.exists("latest"):
            trainer.resume()
        else:
            trainer.train()
    finally:
        writer.close()
    return trainer


def _pop_flag(argv, name: str, default=None):
    """Remove ``--name value`` / ``--name=value`` from argv; return value."""
    for i, a in enumerate(argv):
        if a == f"--{name}":
            value = argv[i + 1]
            del argv[i : i + 2]
            return value
        if a.startswith(f"--{name}="):
            del argv[i]
            return a.split("=", 1)[1]
    return default


def main(argv=None):
    """Dispatch on the evaluate flags: greedy evaluation, or training."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--help" in argv or "-h" in argv:
        print(__doc__)
        return None
    device = _pop_flag(argv, "device", "cuda")
    if _pop_flag(argv, "recipe") is not None:
        raise NotImplementedError("training recipes are not yet ported")
    cfg = Config.from_args(argv)
    if cfg.paths.debug:
        # --debug runs on the CPU, as the reference's does
        device = "cpu"
    if cfg.paths.evaluate_saved_beam_search:
        raise NotImplementedError("--evaluate_saved_beam_search is not yet ported")
    if cfg.paths.evaluate_saved_greedy_search:
        _setup_logging(cfg.paths.output_directory, "log_greedy_search.txt")
        return evaluate_saved_greedy_search(cfg, device=device)
    _setup_logging(cfg.paths.output_directory, "log.txt")
    return train(cfg, device=device)


if __name__ == "__main__":
    main()
