"""Step graphs (``parallel/train_step.py::StepGraphs``) on the CPU, where
their bookkeeping runs the body eagerly on the held buffers, as a CUDA
graph would replay it on the card.

- Eight microbatches of three signatures, two of them recurring (a shape
  with and without an apply, then a new shape that applies), give every
  microbatch's losses, the summed gradients, the parameters, AdamW's state
  and the BatchNorm statistics bitwise equal to the eager step's, at
  dropout 0.2 (the draws come from the graphs' generator, reseeded as the
  eager step reseeds its own); the counters read 3 captures and 5 replays.
  Again with the recipes' randomness: scheduled sampling on a ramp (its
  probability changes between replays of one graph) and two augmentations.
- The key splits on whether the microbatch applies, on its frame bucket
  and on the staged dtype, and on nothing that a device tensor carries.
- ``train.fused_window`` false, and auto on the CPU, keep the eager step;
  so does a mesh over gloo (two CPU ranks), where ``true`` raises.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from tests.test_torch_model import one_torch_thread  # noqa: F401

from emg_tpu_torch.config import Config, ModelConfig, TrainConfig
from emg_tpu_torch.data.batching import (FRAME_BUCKETS, bucket_up, make_packed_batch,
                                          quantize_packed_raw)
from emg_tpu_torch.data.dataset import make_normalizers
from emg_tpu_torch.data.fixtures import make_synthetic_corpus
from emg_tpu_torch.models.model import EMGModel
from emg_tpu_torch.parallel.distributed import launch
from emg_tpu_torch.parallel.train_step import make_train_step, microbatch_signature
from emg_tpu_torch.train.state import create_train_state
from emg_tpu_torch.train.trainer import Trainer
from emg_tpu_torch.utils import profiling

TINY = ModelConfig(model_size=16, feed_forward_layer_size=32, num_layers_encoder=1,
                   num_layers_decoder=1, n_heads_encoder=2, n_heads_decoder=2,
                   relative_distance=8, dropout_model=0.2, dropout_pos_emb=0.1)
# three utterances a microbatch, an apply every second one
CFG = TrainConfig(batch_size_grad=6, learning_rate=1e-3, learning_rate_warmup=4, seed=3)
# each microbatch's frames: seven of one shape (16 packed rows, the 64
# frame bucket), then one of another (24 rows, the 128 bucket)
FRAMES = [(40, 56, 32), (48, 40, 40), (32, 32, 64), (56, 48, 24), (40, 40, 48),
          (60, 36, 32), (44, 44, 40), (100, 48, 40)]


def batch(frames, seed, int16=True):
    rng = np.random.default_rng(seed)
    rows = [np.tanh(rng.normal(size=(8 * f, 8))).astype(np.float32) for f in frames]
    phones = [np.concatenate([[41], rng.integers(0, 40, 7), [40]]) for _ in frames]
    pb = make_packed_batch(rows, list(frames), phones, chunk=64)
    return (quantize_packed_raw(pb) if int16 else pb), bucket_up(max(frames), FRAME_BUCKETS)


def state():
    model = EMGModel(TINY, device="cpu", generator=torch.Generator().manual_seed(0))
    return create_train_state(model, CFG)


# scheduled sampling ramped over the eight microbatches, so that each
# replay of a graph runs at another probability, and two augmentations
RECIPE = dict(scheduled_sampling_max_prob=0.5, scheduled_sampling_ramp=6, time_drop_prob=0.3,
              channel_drop_prob=0.2)


def train(fused_window, **recipe):
    cfg = dataclasses.replace(CFG, fused_window=fused_window, **recipe)
    st, step = state(), make_train_step(cfg)
    with profiling.recording():
        metrics = [step(st, *batch(frames, i), torch.Generator()) for i, frames in
                   enumerate(FRAMES)]
    counts = profiling.recorded().counts
    profiling.clear()
    return st, step, metrics, counts


@pytest.mark.parametrize("recipe", [{}, RECIPE], ids=["plain", "recipe"])
def test_step_graphs_equal_the_eager_step(recipe):
    eager, _, eager_metrics, eager_counts = train(False, **recipe)
    graphed, _, metrics, counts = train(True, **recipe)
    assert eager.step_graphs is None
    graphs = graphed.step_graphs
    assert graphs is not None and not graphs.graphed
    assert all((h.ss_prob is not None) is bool(recipe) for h in graphs.graphs.values())
    keys = [microbatch_signature(pb, mf, m["applied"])
            for (pb, mf), m in zip((batch(f, i) for i, f in enumerate(FRAMES)), metrics)]
    assert [m["applied"] for m in metrics] == [False, True] * 4
    assert len(set(keys)) == 3 and keys[:7] == keys[:2] * 3 + keys[:1] and keys[7] not in keys[:7]
    assert (graphs.captures, graphs.replays, graphs.warmups) == (3, 5, 0)
    assert counts == {"step_graphs.capture": 3, "step_graphs.replay": 5}
    assert "step_graphs.capture" not in eager_counts
    assert sorted(h.replays for h in graphs.graphs.values()) == [0, 2, 3]
    for got, want in zip(metrics, eager_metrics):
        assert got.keys() == want.keys()
        for k in ("loss", "dec_loss", "enc_loss"):
            assert torch.equal(got[k], want[k]), k
        assert got["lr"] == want["lr"] and got["applied"] == want["applied"]
    for k in ("microbatches", "updates", "accum_examples"):
        assert getattr(graphed, k) == getattr(eager, k)
    want = dict(eager.model.named_parameters())
    for name, p in graphed.model.named_parameters():
        assert torch.equal(p, want[name]), name
        assert torch.equal(p.grad, want[name].grad), name
    want = dict(eager.model.named_buffers())
    assert any("running_mean" in name for name in want)
    for name, b in graphed.model.named_buffers():
        assert torch.equal(b, want[name]), name
    a, b = graphed.optimizer.state_dict()["state"], eager.optimizer.state_dict()["state"]
    assert a.keys() == b.keys() and len(b) == len(list(eager.model.parameters()))
    for i, s in b.items():
        for key, v in s.items():
            assert torch.equal(torch.as_tensor(a[i][key]), torch.as_tensor(v)), (i, key)


@pytest.mark.parametrize("change", ["applied", "frame_bucket", "staged_dtype"])
def test_the_key_splits(change):
    pb, max_frames = batch(FRAMES[0], 0)
    key = microbatch_signature(pb, max_frames, False)
    # another batch of the same shapes: the same key (its counts are device tensors)
    assert microbatch_signature(*batch(FRAMES[1], 1), False) == key
    other = {"applied": lambda: microbatch_signature(pb, max_frames, True),
             "frame_bucket": lambda: microbatch_signature(pb, 2 * max_frames, False),
             "staged_dtype": lambda: microbatch_signature(batch(FRAMES[0], 0, int16=False)[0],
                                                          max_frames, False)}[change]()
    assert other != key


@pytest.mark.parametrize("fused_window, graphed", [(None, False), (False, False), (True, True)],
                         ids=["auto", "false", "true"])
def test_the_cpu_keeps_the_eager_step_unless_asked(fused_window, graphed):
    step = make_train_step(dataclasses.replace(CFG, fused_window=fused_window))
    st = state()
    step(st, *batch(FRAMES[0], 0), torch.Generator())
    assert (st.step_graphs is not None) is graphed
    # a new state gets graphs of its own
    other = state()
    step(other, *batch(FRAMES[1], 1), torch.Generator())
    if graphed:
        assert other.step_graphs is not st.step_graphs
        assert other.step_graphs.captures == 1 and other.step_graphs.replays == 0


def _gloo_rank(argv, out_dir):
    import torch.distributed as dist

    torch.set_num_threads(1)
    results = {}
    for fused in (None, True):
        flags = [] if fused is None else ["--train.fused_window", "true"]
        cfg = Config.from_args(argv + flags + ["--parallel.data_axis", "2",
                                               "--output_directory", out_dir])
        try:
            trainer = Trainer(cfg, None, None, None, device="cpu")
            st = trainer.init_state()
            trainer.train_step(st, *batch(FRAMES[0], 0), torch.Generator())
            results[str(fused)] = (st.model.mesh is not None and st.microbatches == 1
                                   and st.step_graphs is None)
        except ValueError as e:
            results[str(fused)] = str(e)
    torch.save(results, os.path.join(out_dir, f"gloo.{dist.get_rank()}.pt"))


def test_a_gloo_mesh_keeps_the_eager_step(tmp_path):
    paths = make_synthetic_corpus(str(tmp_path), n_sentences=4, seed=0)
    argv = ["--silent_data_directories", paths["silent_data_directories"],
            "--voiced_data_directories", paths["voiced_data_directories"],
            "--testset_file", paths["testset_file"], "--dict", paths["dict"],
            "--normalizers_file", str(tmp_path / "normalizers.pkl"),
            "--model.model_size", "16", "--feed_forward_layer_size", "32",
            "--num_layers_encoder", "1", "--num_layers_decoder", "1",
            "--n_heads_encoder", "2", "--n_heads_decoder", "2"]
    make_normalizers(Config.from_args(argv), device="cpu")
    out = str(tmp_path / "gloo")
    os.makedirs(out, exist_ok=True)
    launch(_gloo_rank, (argv, out), 2, "cpu")
    for rank in range(2):
        results = torch.load(os.path.join(out, f"gloo.{rank}.pt"))
        assert results["None"] is True
        assert "gloo" in results["True"]
