"""The port's spans and counters (``utils/profiling.py``) on its training
path, on the CPU.

- Off (no profiler, no ``recording()``), a train step records nothing and
  never opens a ``record_function`` region; ``span`` hands out one shared
  no-op context.
- Under ``recording()``, an epoch's batch lists, its window plan, a batch's
  packing and int16 staging and two train steps give the span tree the
  benchmark's readers take: the data spans at the top, each ``step`` with
  ``step.stage``, ``step.forward``, ``step.backward`` and, where it
  applies, ``step.optimizer`` under it, one microbatch id a step and its
  phases, the step's attributes, and no ``sync`` span or ``host_syncs``
  on the CPU (no copy there waits for a device).
- A blocking copy to a card (a stand-in tensor: there is none here) is a
  ``sync`` span with its bytes and counts once in ``host_syncs``.
- A torch profiler turns recording on, and its exit turns it off again:
  this holds torch's private flag (``_is_profiler_enabled``) to its
  meaning across torch upgrades.
- A span's self time is its duration less its children's.
"""

import json
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from emg_tpu_torch.config import ModelConfig, TrainConfig
from emg_tpu_torch.data.batching import (FRAME_BUCKETS, bucket_up, make_packed_batch,
                                          quantize_packed_raw)
from emg_tpu_torch.data.sampler import DynamicBatchSampler
from emg_tpu_torch.models.model import EMGModel
from emg_tpu_torch.parallel.train_step import copy_to_device, make_train_step
from emg_tpu_torch.train.state import create_train_state
from emg_tpu_torch.train.window import plan_windows
from emg_tpu_torch.utils import profiling

TINY = ModelConfig(model_size=16, feed_forward_layer_size=32, num_layers_encoder=1,
                   num_layers_decoder=1, n_heads_encoder=2, n_heads_decoder=2,
                   relative_distance=8, dropout_model=0.0, dropout_pos_emb=0.0)
FRAMES = (40, 56, 32)
PHONES = (7, 9, 5)


@pytest.fixture(autouse=True)
def cleared():
    profiling.clear()
    yield
    profiling.clear()


class _Dir:
    def __init__(self, directory):
        self.directory = directory


class _Corpus:
    """What the sampler reads of a dataset: ``<i>_info.json`` files."""

    def __init__(self, directory, raw_lengths):
        for i, n in enumerate(raw_lengths):
            (directory / f"{i}_info.json").write_text(json.dumps({"chunks": [[n]], "text": "x"}))
        self.example_indices = [(_Dir(str(directory)), i) for i in range(len(raw_lengths))]

    def __len__(self):
        return len(self.example_indices)


def batch():
    rng = np.random.default_rng(0)
    rows = [np.tanh(rng.normal(size=(8 * f, 8))).astype(np.float32) for f in FRAMES]
    phones = [np.concatenate([[41], rng.integers(0, 40, n - 2), [40]]) for n in PHONES]
    pb = quantize_packed_raw(make_packed_batch(rows, list(FRAMES), phones, chunk=64))
    return pb, bucket_up(max(FRAMES), FRAME_BUCKETS)


def setup():
    cfg = TrainConfig(batch_size_grad=4, learning_rate=1e-3, learning_rate_warmup=10)
    model = EMGModel(TINY, device="cpu", generator=torch.Generator().manual_seed(0))
    return cfg, create_train_state(model, cfg), make_train_step(cfg), torch.Generator()


def test_off_records_nothing_and_opens_no_region(monkeypatch):
    opened = []
    monkeypatch.setattr(profiling, "record_function", lambda name: opened.append(name))
    assert not profiling.enabled()
    cfg, state, step, gen = setup()
    pb, max_frames = batch()
    step(state, pb, max_frames, gen)
    profiling.count("host_syncs")
    rec = profiling.recorded()
    assert rec.spans == [] and rec.counts == {} and opened == []
    assert profiling.span("a") is profiling.span("b", microbatch=3, bytes=8)
    with profiling.span("a") as s:
        assert s is None


def test_recording_gives_the_step_span_tree(tmp_path):
    cfg, state, step, gen = setup()
    with profiling.recording():
        sampler = DynamicBatchSampler(_Corpus(tmp_path, [8 * f for f in FRAMES]), 2000, 4,
                                      seed=1)
        plan_windows(list(sampler), 0, cfg)
        pb, max_frames = batch()
        first = step(state, pb, max_frames, gen)  # 3 examples: no apply
        second = step(state, pb, max_frames, gen)  # 6: applies
    assert not first["applied"] and second["applied"]
    rec = profiling.recorded()
    top = [s for s in rec.spans if s.parent is None]
    assert [s.name for s in top] == ["data.sampler", "window.plan", "data.pack", "data.int16",
                                     "step", "step"]
    assert all(s.microbatch is None for s in top[:4])
    phases = [["step.stage", "step.forward", "step.backward"],
              ["step.stage", "step.forward", "step.backward", "step.optimizer"]]
    for k, (st, names) in enumerate(zip(top[4:], phases)):
        kids = rec.children(st)
        assert [c.name for c in kids] == names
        assert st.microbatch == k and all(c.microbatch == k for c in kids)
        assert all(rec.children(c) == [] for c in kids)  # no sync on the CPU
        assert st.attrs == {"examples": 3, "frames": sum(FRAMES), "max_frames": max_frames,
                            "applied": k == 1}
        assert all(st.start_ns <= c.start_ns <= c.end_ns <= st.end_ns for c in kids)
    assert len(rec.spans) == 4 + 2 + 3 + 4
    assert rec.counts.get("host_syncs", 0) == 0
    assert not profiling.enabled()


def test_a_blocking_copy_is_a_counted_sync_span():
    class Staged:
        """A CPU tensor's stand-in whose copy to a card is a no-op."""

        def __init__(self, nbytes):
            self.nbytes = nbytes

        def to(self, device):
            return self

    tensors = {"packed_raw": Staged(1024), "counts": Staged(32)}
    card = torch.device("cuda", 0)
    assert copy_to_device(tensors, card) == tensors and profiling.recorded().spans == []
    with profiling.recording():
        with profiling.span("step.stage"):
            out = copy_to_device(tensors, card)
    assert out == tensors
    rec = profiling.recorded()
    stage, *syncs = rec.spans
    assert [(s.name, s.parent, s.attrs) for s in syncs] == [
        ("sync", stage.id, {"bytes": 1024}), ("sync", stage.id, {"bytes": 32})]
    assert rec.counts == {"host_syncs": 2}


def test_a_profiler_turns_recording_on_and_off():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert profiling.enabled()
        with profiling.span("traced_region"):
            profiling.count("host_syncs", 2)
            torch.ones(4).sum()
    assert not profiling.enabled()
    with profiling.span("after_the_profiler"):
        profiling.count("host_syncs")
    rec = profiling.recorded()
    assert [s.name for s in rec.spans] == ["traced_region"] and rec.counts == {"host_syncs": 2}
    assert "traced_region" in {e.name for e in prof.events()}


def test_self_time_is_duration_less_children():
    with profiling.recording():
        with profiling.span("outer", microbatch=5) as outer:
            time.sleep(0.002)
            for _ in range(2):
                with profiling.span("inner"):
                    time.sleep(0.003)
    rec = profiling.recorded()
    inner = rec.children(outer)
    assert [s.name for s in inner] == ["inner", "inner"]
    assert all(s.microbatch == 5 for s in inner)
    assert rec.self_ns(outer) == outer.duration_ns - sum(s.duration_ns for s in inner)
    assert rec.self_ns(outer) >= 2e6 and all(s.duration_ns >= 3e6 for s in inner)
    assert all(rec.self_ns(s) == s.duration_ns for s in inner)
    made = profiling.Recording([profiling.Span("a", 0, None, None, 0, 100),
                                profiling.Span("b", 1, 0, None, 10, 40),
                                profiling.Span("c", 2, 0, None, 50, 70),
                                profiling.Span("d", 3, 1, None, 20, 30)], {})
    assert [made.self_ns(s) for s in made.spans] == [50, 20, 20, 10]
