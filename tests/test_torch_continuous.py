"""Continuous-batching beam serving (``emg_tpu_torch/decode/continuous.py``)
and the per-lane step position it rests on, against one-by-one search and
the JAX package's ``ContinuousBeamServer``.

The tiny model, lexicon and LM of tests/test_torch_beam.py (float32).

- ``serve`` with 2 lanes and an odd chunk (3 steps an advance) over more
  requests than lanes returns what one-by-one ``search`` does, in request
  order (tests/test_device_beam.py's check: histories and words equal,
  scores to 1e-5); with a chunk of 32 a request whose max_len outruns the
  cache stops at its end, as ``search`` does.
- ``serve`` against JAX's ``serve`` on the same requests, on the rule of
  tests/test_torch_beam.py::test_device_beam_matches_jax.
- ``decode_step`` with a (B,) step of one position is bitwise the 0-dim
  step's, float32 and bfloat16; with a position a row, each row's logits
  are its own run's. The beam's per-lane step, with every lane at one
  position, is bitwise the lock-step one (``search_many``'s), and a lane
  that is done keeps its position.
- ``CapturedLoop.replay`` alternates the two graphs of an odd block.
"""

import numpy as np
import pytest
import torch

from emg_tpu.config import DecodeConfig as JaxDecodeConfig
from emg_tpu.decode.continuous import ContinuousBeamServer as JaxContinuousBeamServer
from emg_tpu.decode.device_beam import DeviceBeamSearcher as JaxDeviceBeamSearcher

from emg_tpu_torch.config import DecodeConfig, ModelConfig
from emg_tpu_torch.decode import ContinuousBeamServer, DeviceBeamSearcher
from emg_tpu_torch.decode.graphs import CapturedLoop
from emg_tpu_torch.models.model import EMGModel
from emg_tpu_torch.text.phonemes import PAD_ID
from tests.test_torch_beam import MAX_FRAMES, as_port, batches, lexicon_lm, make_models  # noqa: F401
from tests.test_torch_model import GEOMETRY, one_torch_thread  # noqa: F401

CFG = dict(BeamWidth=8, extra_steps=6)


def searcher(lexicon_lm, model, max_steps=16, **cfg):
    return DeviceBeamSearcher(model, lexicon_lm["port_tree"], lexicon_lm["port_dlm"],
                              DecodeConfig(**dict(CFG, **cfg)), MAX_FRAMES, max_steps=max_steps)


def assert_same_results(singles, served):
    assert len(served) == len(singles)
    for (h1, s1, w1), (h2, s2, w2) in zip(singles, served):
        assert list(h1) == list(h2)
        assert w1 == w2
        assert s1 == pytest.approx(s2, abs=1e-5)


def test_serve_matches_search(lexicon_lm):
    dev = searcher(lexicon_lm, make_models(7)[2])
    bs, lens = batches([41, 42, 43, 44, 45])
    lens[1] = 2  # a lane that finishes long before the others
    requests = [(as_port(b), L) for b, L in zip(bs, lens)]
    singles = [dev.search(b, L) for b, L in requests]
    server = ContinuousBeamServer(dev, lanes=2, chunk=3)
    served = server.serve(requests)
    assert_same_results(singles, served)
    assert any(np.isfinite(s) for _, s, _ in served)
    assert server.refills == len(requests) - 2 and server.advances > 2
    assert ContinuousBeamServer(dev, lanes=4, chunk=3).serve([]) == []


def test_serve_caps_at_cache_capacity(lexicon_lm):
    # max_len = target + 20 outruns the cache (S - 1 = 8 steps), and one
    # advance of 32 steps would run past it
    dev = searcher(lexicon_lm, make_models(17)[2], max_steps=8, extra_steps=20)
    bs, lens = batches([51, 52, 53])
    requests = [(as_port(b), L) for b, L in zip(bs, lens)]
    singles = [dev.search(b, L) for b, L in requests]
    server = ContinuousBeamServer(dev, lanes=2, chunk=32)
    assert_same_results(singles, server.serve(requests))
    assert server.advances == 2  # each lane's search ends inside one advance


def test_serve_matches_jax(lexicon_lm):
    jm, v, tm = make_models(7)
    bs, lens = batches([41, 42, 43, 44, 45])
    jax_dev = JaxDeviceBeamSearcher(jm, v, lexicon_lm["jax_tree"], lexicon_lm["jax_dlm"],
                                    JaxDecodeConfig(**CFG), MAX_FRAMES, max_steps=16)
    want = JaxContinuousBeamServer(jax_dev, lanes=2, chunk=3).serve(list(zip(bs, lens)))
    got = ContinuousBeamServer(searcher(lexicon_lm, tm), lanes=2, chunk=3).serve(
        [(as_port(b), L) for b, L in zip(bs, lens)])
    agree = 0
    for (jh, js, jw), (th, ts, tw) in zip(want, got):
        if list(jh) == list(th) and jw == tw and ts == pytest.approx(js, abs=1e-4):
            agree += 1
        else:
            print(f"the served searches differ; the two winners' scores differ by {abs(ts - js)}")
            assert abs(ts - js) < 1e-5, (jw, tw, js, ts)
    assert agree >= len(want) - 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_per_row_step(dtype):
    """(B,) steps against the 0-dim step, then rows at their own positions:
    row 1 starts two steps after row 0, and its logits are those of its
    run alone."""
    model = EMGModel(ModelConfig(**dict(GEOMETRY, compute_dtype=dtype)), device="cpu",
                     generator=torch.Generator().manual_seed(5)).eval()
    rng = np.random.default_rng(9)
    B, S, T = 2, 7, MAX_FRAMES
    memory = torch.tensor(rng.normal(size=(B, T, GEOMETRY["model_size"])), dtype=torch.float32)
    mask = torch.zeros((B, T), dtype=torch.bool)
    mask[1, 5:] = True
    tokens = torch.tensor(rng.integers(0, 40, (B, S)), dtype=torch.int64)
    tokens[:, 0] = 41
    tokens[1, 5:] = PAD_ID
    with torch.inference_mode():
        kvs = model.project_cross_kvs(memory)
        runs = []
        for per_row in (False, True):
            caches = model.init_decode_cache(B, S)
            steps = [torch.tensor(s).expand(B) if per_row else torch.tensor(s) for s in range(S)]
            runs.append(([model.decode_step(tokens[:, s], steps[s], caches, kvs, tokens, mask)
                          for s in range(S)], caches))
        (a_logits, a_caches), (b_logits, b_caches) = runs
        for a, b in zip(a_logits + list(a_caches), b_logits + list(b_caches)):
            assert torch.equal(a, b)

        # row 1 runs two steps behind row 0; each row alone as the reference
        alone = []
        for r in range(B):
            kv = [(k[r : r + 1], v[r : r + 1]) for k, v in kvs]
            caches = model.init_decode_cache(1, S)
            alone.append([model.decode_step(tokens[r : r + 1, s], s, caches, kv, tokens[r : r + 1],
                                            mask[r : r + 1]) for s in range(S)])
        caches = model.init_decode_cache(B, S)
        for g in range(S):
            pos = torch.tensor([g, max(g - 2, 0)])
            logits = model.decode_step(tokens.gather(1, pos[:, None])[:, 0], pos, caches, kvs,
                                       tokens, mask)
            torch.testing.assert_close(logits[0], alone[0][g][0], rtol=1e-5, atol=1e-5)
            if g >= 2:
                torch.testing.assert_close(logits[1], alone[1][g - 2][0], rtol=1e-5, atol=1e-5)


def test_per_lane_step_is_bitwise_lockstep(lexicon_lm):
    dev = searcher(lexicon_lm, make_models(21)[2])
    bs, lens = batches([31, 32, 33])
    lens[1] = 2  # lane 1 reaches its max_len (8) first
    with torch.inference_mode():
        kvs, mask = dev._stack_ctx([dev._make_ctx(as_port(b)) for b in bs])
        max_len = torch.tensor([L + CFG["extra_steps"] for L in lens])
        lock = dev._init_state(kvs, mask, max_len)
        lane = dev._init_state(kvs, mask, max_len)
        for step in range(int(max_len.min())):
            lock, lane = dev._step(lock), dev._step(lane, lockstep=False)
            for name, value in lock.items():
                if isinstance(value, torch.Tensor) and name != "done":
                    assert torch.equal(value, lane[name]), (step, name)
        assert lane["t"].tolist() == [8, 8, 8]
        assert bool(dev.lanes_done(lane)[1])
        for _ in range(3):
            lane = dev._step(lane, lockstep=False)
        assert lane["t"][1] == 8  # a lane that is done keeps its position
        assert all(lane["t"][u] == 11 or bool(dev.lanes_done(lane)[u]) for u in (0, 2))


def test_odd_block_replays_two_graphs_in_turn():
    class Graph:
        def __init__(self):
            self.replays = 0

        def replay(self):
            self.replays += 1

    g0, g1 = Graph(), Graph()
    s0, s1 = dict(name="first"), dict(name="swapped")
    loop = CapturedLoop(g0, s0, 0.0, 0, (g1, s1))
    loop.replay()
    assert loop.state is s1 and loop.graph is g1 and g0.replays == 1
    loop.replay()
    assert loop.state is s0 and loop.graph is g0 and g1.replays == 1
    even = CapturedLoop(g0, s0, 0.0, 0)
    even.replay()
    assert even.state is s0 and g0.replays == 2
