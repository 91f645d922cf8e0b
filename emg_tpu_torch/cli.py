"""CLI entry point of the port: training and saved-model greedy and beam evaluation.

Counterpart of ``emg_tpu/cli.py`` (reference recognition_model.py:385-420):

  python -m emg_tpu_torch.cli --output_directory OUT [--resume] \\
      [--start_training_from MODEL.pt] [--device cuda|cpu] [--recipe NAME] \\
      [--section.key value ...]
  python -m emg_tpu_torch.cli --evaluate_saved_greedy_search MODEL.pt \\
      [--device cuda|cpu] [--recipe NAME] [--section.key value ...]
  python -m emg_tpu_torch.cli --evaluate_saved_beam_search MODEL.pt \\
      --lang_model LM.arpa [--device cuda|cpu] [--recipe NAME] [--section.key value ...]

With no evaluate flag it trains (``train.trainer.Trainer``), logging to
<output_directory>/log.txt and writing ``latest`` (the full train state,
which ``--resume`` continues from) and ``model.pt`` (the best weights).
``--evaluate_saved_greedy_search`` decodes the test split greedily at batch
1 and reports PER + token accuracy in <output_directory>/log_greedy_search.txt,
in the reference's format. ``--evaluate_saved_beam_search`` decodes it with
the lexicon-constrained beam and the n-gram LM (``--lang_model``; the
lexicon from ``--phonesSet``, ``--vocabulary`` and ``--dict``) and reports
the WER of the cleaned text in <output_directory>/log_beam_search.txt. A
checkpoint is a ``torch.save``d state dict in the reference's key names:
the port's model.pt, a reference ``.pt`` file, or
``utils/convert.py::state_dict_from_flax`` of the JAX package's variables.
``--debug`` runs on the CPU whatever ``--device`` says, as the reference's
``--debug`` does. ``--recipe NAME`` applies a named training recipe
(``train/recipes.py``) after the flags, in every mode, so it overrides an
explicit flag it sets and ``--recipe conformer_model`` also builds the
conformer to evaluate a conformer's model.pt.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import sys

import numpy as np
import torch

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
    parameters stay float32) with the checkpoint's weights, in eval mode.
    With ``decode.quantize_int8`` the decoder's matmul weights are int8,
    quantized from the float32 weights (``utils/quantize.py``), which
    covers greedy decoding too, as in the JAX package."""
    from emg_tpu_torch.models.model import EMGModel
    from emg_tpu_torch.train.checkpoint import load_weights
    from emg_tpu_torch.utils.quantize import quantize_decoder_int8

    model = EMGModel(
        dataclasses.replace(cfg.model, compute_dtype=cfg.decode.compute_dtype),
        device=device,
    )
    model.load_state_dict(load_weights(ckpt_path), strict=True)
    if cfg.decode.quantize_int8:
        model = quantize_decoder_int8(model)
    return model.eval()


def evaluate_saved_greedy_search(cfg: Config, device="cuda"):
    """Greedy PER of the checkpoint at ``paths.evaluate_saved_greedy_search``
    over the test split. Returns (PER, token accuracy in percent)."""
    from emg_tpu_torch.data.dataset import EMGDataset
    from emg_tpu_torch.decode.graphs import LoopRunner
    from emg_tpu_torch.decode.greedy import run_greedy
    from emg_tpu_torch.text.metrics import wer
    from emg_tpu_torch.utils.serving import cast_params_for_serving

    testset = EMGDataset(cfg, test=True, device=device)
    model = load_model_for_eval(cfg, cfg.paths.evaluate_saved_greedy_search, device)
    if model.dtype == torch.bfloat16:
        # cast the per-use float32 -> bfloat16 weights once, outside the
        # decode loop, as the beam path does (numerics unchanged)
        model = cast_params_for_serving(model)
    # one runner for the pass: a CUDA graph per (B, S, T) geometry
    runner = LoopRunner(model)
    references, predictions = [], []
    running_total = running_correct = 0
    for i in range(len(testset)):
        pb, max_frames, raw = prepare_single(cfg, testset, i)
        S_true = int(raw["phonemes_int_lengths"][0])
        strings, matrix = run_greedy(
            model, pb, max_frames, S_true - 1, pb.targets.shape[1] - 1, runner=runner,
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


def evaluate_saved_beam_search(cfg: Config, device="cuda"):
    """Beam-search WER of the checkpoint at ``paths.evaluate_saved_beam_search``
    over the test split (``emg_tpu/cli.py::evaluate_saved_beam_search``):
    the device beam (``decode/device_beam.py``) by default, the host beam
    (``decode/beam.py``) for ``Constrained=false``, ``device_beam=false``
    or a KenLM binary LM. With ``decode.continuous_lanes`` > 0 the device
    beam serves each geometry group of more than one utterance through
    ``decode/continuous.py::ContinuousBeamServer``. Returns the final WER."""
    from emg_tpu_torch.data.dataset import EMGDataset
    from emg_tpu_torch.decode.beam import BeamSearcher
    from emg_tpu_torch.decode.kenlm_binary import is_kenlm_binary
    from emg_tpu_torch.decode.ngram import load_language_model
    from emg_tpu_torch.decode.prefix_tree import init_tree
    from emg_tpu_torch.text.metrics import wer
    from emg_tpu_torch.text.phonemes import TextTransform

    dc = cfg.decode
    use_device = dc.device_beam and dc.Constrained
    testset = EMGDataset(cfg, test=True, device=device)
    model = load_model_for_eval(cfg, cfg.paths.evaluate_saved_beam_search, device)
    tree = init_tree(cfg.paths.phonesSet, cfg.paths.vocabulary, cfg.paths.dict)
    compiled = tree.compile_tables()
    lm = load_language_model(cfg.paths.lang_model)
    tt = TextTransform()

    if use_device and is_kenlm_binary(cfg.paths.lang_model):
        # KenLM *binary* LMs expose only hashed n-gram keys, so the device
        # LM tables (which need enumerable n-grams) cannot be compiled from
        # one; score through the host searcher instead, the reference's own
        # regime (PrefixTree.py:288-290 queries kenlm per hypothesis)
        log.warning(
            "lang_model %s is a KenLM binary: device-beam LM tables need an "
            "enumerable ARPA file, falling back to the host beam searcher "
            "(pass the .arpa to re-enable the device beam)",
            cfg.paths.lang_model,
        )
        use_device = False
    if use_device:
        from emg_tpu_torch.decode.device_beam import DeviceBeamSearcher
        from emg_tpu_torch.decode.device_lm import build_device_lm
        from emg_tpu_torch.decode.ngram import ArpaLanguageModel
        from emg_tpu_torch.utils.serving import cast_params_for_serving

        py_lm = (lm if isinstance(lm, ArpaLanguageModel)
                 else ArpaLanguageModel(cfg.paths.lang_model))
        lex_words = [
            compiled.dictionary.lookup_word_by_index(i).name
            for i in range(compiled.dictionary.word_count())
        ]
        dlm = build_device_lm(py_lm, lex_words, device=device)
        if model.dtype == torch.bfloat16:
            # one cast copy shared by every geometry's searcher
            model = cast_params_for_serving(model)

    # pass 1: prepare every utterance
    prepared = []  # (pb, max_frames, target_len, target_text)
    for i in range(len(testset)):
        pb, max_frames, raw = prepare_single(cfg, testset, i)
        target = raw["phonemes_int"][0][1:]
        target_len = int((target != 40).sum())
        prepared.append((pb, max_frames, target_len, tt.clean_text(raw["text"][0])))

    # pass 2: decode; the device beam takes one geometry group's
    # utterances batch_utterances at a time
    words_by_idx = {}
    if use_device:
        groups = {}
        for i, (pb, max_frames, target_len, _) in enumerate(prepared):
            step_cap = 16 * ((target_len + dc.extra_steps + 15) // 16)
            key = (max_frames, step_cap, pb.packed_raw.shape[0], pb.targets.shape[1])
            groups.setdefault(key, []).append(i)
        CH = max(dc.batch_utterances, 1)
        searchers = {}
        for (max_frames, step_cap, _, _), idxs in groups.items():
            if (max_frames, step_cap) not in searchers:
                searchers[max_frames, step_cap] = DeviceBeamSearcher(
                    model, compiled, dlm, dc, max_frames, max_steps=step_cap)
            searcher = searchers[max_frames, step_cap]
            if dc.continuous_lanes > 0 and len(idxs) > 1:
                # one lane pool per geometry group, refilled from its queue
                from emg_tpu_torch.decode.continuous import ContinuousBeamServer

                server = ContinuousBeamServer(searcher, lanes=min(dc.continuous_lanes, len(idxs)))
                outs = server.serve([(prepared[i][0], prepared[i][2]) for i in idxs])
                for i, out in zip(idxs, outs):
                    words_by_idx[i] = out[2]
                continue
            for c0 in range(0, len(idxs), CH):
                chunk = idxs[c0 : c0 + CH]
                if len(chunk) == 1:
                    pb, _, target_len, _ = prepared[chunk[0]]
                    words_by_idx[chunk[0]] = searcher.search(pb, target_len)[2]
                    continue
                # padded to the launch size, as the JAX package's launches
                padded = chunk + [chunk[-1]] * (CH - len(chunk))
                outs = searcher.search_many(
                    [prepared[i][0] for i in padded],
                    [prepared[i][2] for i in padded],
                )
                for i, out in zip(chunk, outs[: len(chunk)]):
                    words_by_idx[i] = out[2]
    else:
        host_searchers = {}
        for i, (pb, max_frames, target_len, _) in enumerate(prepared):
            if max_frames not in host_searchers:
                host_searchers[max_frames] = BeamSearcher(model, compiled, lm, dc, max_frames)
            words_by_idx[i] = host_searchers[max_frames].search(pb, target_len)[2]

    # pass 3: score + log in dataset order (reference log format)
    references, predictions = [], []
    for i, (_, _, _, target_text) in enumerate(prepared):
        pred_text = tt.clean_text(" ".join(words_by_idx[i]))
        if len(target_text) != 0:
            references.append(target_text)
            predictions.append(pred_text)
            log.info(
                "Prediction:%s ---> Reference:%s  (WER: %s)",
                pred_text, target_text, wer(target_text, pred_text),
            )
    final = wer(references, predictions)
    log.info("Final WER: %s", final)
    return final


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


def _print_help():
    from emg_tpu_torch.train.recipes import RECIPES

    print(__doc__)
    print("Flags (bare names accepted when unambiguous, or --section.key):\n")
    cfg = Config()
    for f in dataclasses.fields(cfg):
        section = getattr(cfg, f.name)
        for sf in dataclasses.fields(section):
            print(f"  --{f.name}.{sf.name}  (default: {getattr(section, sf.name)!r})")
    print("\n  --device {cuda,cpu}  (default: 'cuda')")
    print(f"  --recipe {{{','.join(sorted(RECIPES))}}}")


def main(argv=None):
    """Dispatch on the evaluate flags: beam or greedy evaluation, or training."""
    from emg_tpu_torch.train.recipes import apply_recipe

    argv = list(sys.argv[1:] if argv is None else argv)
    if "--help" in argv or "-h" in argv:
        _print_help()
        return None
    device = _pop_flag(argv, "device", "cuda")
    recipe = _pop_flag(argv, "recipe")
    cfg = Config.from_args(argv)
    if cfg.paths.debug:
        # --debug runs on the CPU, as the reference's does
        device = "cpu"
    if recipe is not None:
        apply_recipe(cfg, recipe)
    if cfg.paths.evaluate_saved_beam_search:
        _setup_logging(cfg.paths.output_directory, "log_beam_search.txt")
        return evaluate_saved_beam_search(cfg, device=device)
    if cfg.paths.evaluate_saved_greedy_search:
        _setup_logging(cfg.paths.output_directory, "log_greedy_search.txt")
        return evaluate_saved_greedy_search(cfg, device=device)
    _setup_logging(cfg.paths.output_directory, "log.txt")
    return train(cfg, device=device)


if __name__ == "__main__":
    main()
