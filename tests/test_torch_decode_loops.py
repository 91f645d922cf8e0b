"""The port's decode loops, run k steps between reads of the device, against
the JAX package's ``lax.while_loop``s.

A small model (d=32, 2+2 layers: tests/test_torch_model.py's geometry)
with perturbed JAX weights carried into the port, float32, on a seeded toy
batch of three utterances. Two weight sets: "mixed" (one row emits </S>
at step 3 and keeps extending its raw chain, one at step 1, one never), and
"ending" (every row emits </S> at step 1, so the loop stops on
``all(ended)``); each lifts the </S> logit's bias to get there.

- ``decode_step`` with a 0-dim tensor step gives bitwise the int step's
  logits and caches at every position, float32 and bfloat16.
- The port's ``greedy_decode`` (uncached) and ``greedy_decode_cached`` at
  k in {1, 3, 8} equal JAX's exactly, in ``out`` and in the raw tokens,
  with ``num_steps`` below and at ``max_steps``; the loop read its flag
  once per k-step block.
- ``run_greedy(use_cache=False)`` equals ``use_cache=True``, as
  tests/test_greedy.py::test_cached_greedy_matches_full holds JAX's.
- ``LoopRunner``'s copy-back into static buffers (a ping-pong pair that
  swapped is not copied) and its model check.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from emg_tpu.config import ModelConfig as JaxModelConfig
from emg_tpu.decode.greedy import greedy_decode as jax_greedy_decode
from emg_tpu.decode.greedy import greedy_decode_cached as jax_greedy_decode_cached
from emg_tpu.models.model import EMGModel as JaxEMGModel

from emg_tpu_torch.config import ModelConfig
from emg_tpu_torch.data.batching import PackedBatch
from emg_tpu_torch.decode import LoopRunner, greedy_decode, greedy_decode_cached, run_greedy
from emg_tpu_torch.decode.graphs import _swapped, copy_into
from emg_tpu_torch.models.model import EMGModel
from emg_tpu_torch.text.phonemes import END_ID, PAD_ID
from emg_tpu_torch.utils.convert import state_dict_from_flax
from tests.test_torch_model import GEOMETRY, one_torch_thread, perturbed  # noqa: F401
from tests.test_train_step import toy_batch

MAX_FRAMES = 8
MAX_STEPS = 12
# (perturbation seed, lift of the </S> logit's bias)
WEIGHTS = {"mixed": (2, 1.5), "ending": (3, 2.5)}


def batch():
    return toy_batch(B=3, n_rows=3, chunk=64, S=10, seed=0)


@functools.lru_cache(maxsize=None)
def models(weights: str):
    """(JAX model, its variables, the port's model with the same weights)."""
    seed, lift = WEIGHTS[weights]
    b = batch()
    jm = JaxEMGModel(JaxModelConfig(**GEOMETRY))
    v = jm.init({"params": jax.random.PRNGKey(0)}, b.packed_raw, b.n_rows, b.offsets, b.lengths,
                b.targets[:, :-1], MAX_FRAMES, False)
    v = perturbed({"params": v["params"], "batch_stats": v["batch_stats"]},
                  np.random.default_rng(seed))
    v["params"]["w_out"]["bias"][END_ID] += lift
    tm = EMGModel(ModelConfig(**GEOMETRY), device="cpu")
    tm.load_state_dict(state_dict_from_flax(v, 2, 2))
    return jm, v, tm.eval()


@functools.lru_cache(maxsize=None)
def jax_greedy(weights: str, cached: bool, num_steps: int):
    jm, v, _ = models(weights)
    fn = jax_greedy_decode_cached if cached else jax_greedy_decode
    out, raw = fn(jm, v, batch(), MAX_FRAMES, MAX_STEPS, num_steps=num_steps)
    return np.asarray(out), np.asarray(raw)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tensor_step_is_bitwise_the_int_step(dtype):
    """Every position of a short teacher-forced decode, once with int steps
    and once with 0-dim int64 tensor steps, from the same zeroed caches."""
    model = EMGModel(ModelConfig(**dict(GEOMETRY, compute_dtype=dtype)), device="cpu",
                     generator=torch.Generator().manual_seed(5)).eval()
    rng = np.random.default_rng(9)
    B, S, T = 3, 7, MAX_FRAMES
    memory = torch.tensor(rng.normal(size=(B, T, GEOMETRY["model_size"])), dtype=torch.float32)
    mask = torch.zeros((B, T), dtype=torch.bool)
    mask[1, 5:] = True
    tokens = torch.tensor(rng.integers(0, 40, (B, S)), dtype=torch.int64)
    tokens[:, 0] = 41
    tokens[2, 4:] = PAD_ID
    with torch.inference_mode():
        kvs = model.project_cross_kvs(memory)
        runs = []
        for as_tensor in (False, True):
            caches = model.init_decode_cache(B, S)
            logits = [model.decode_step(tokens[:, s], torch.tensor(s) if as_tensor else s, caches,
                                        kvs, tokens, mask) for s in range(S)]
            runs.append((logits, caches))
    (int_logits, int_caches), (t_logits, t_caches) = runs
    for a, b in zip(int_logits, t_logits):
        assert torch.equal(a, b)
    for a, b in zip(int_caches, t_caches):
        assert torch.equal(a, b)
    assert int_caches[0][:, :, :, -1].abs().sum() > 0  # the last row was written


@pytest.mark.parametrize("weights", sorted(WEIGHTS))
@pytest.mark.parametrize("num_steps", [7, MAX_STEPS], ids=["below_max", "at_max"])
@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("cached", [True, False], ids=["cached", "full_prefix"])
def test_greedy_matches_jax_at_every_cadence(weights, num_steps, k, cached):
    jout, jraw = jax_greedy(weights, cached, num_steps)
    _, _, tm = models(weights)
    runner = LoopRunner(tm, k=k)
    fn = greedy_decode_cached if cached else greedy_decode
    out, raw = fn(tm, PackedBatch(**dataclasses.asdict(batch())), MAX_FRAMES, MAX_STEPS,
                  num_steps=num_steps, runner=runner)
    np.testing.assert_array_equal(raw.numpy(), jraw)
    np.testing.assert_array_equal(out.numpy(), jout)
    # every row writes at each step the loop runs; it read ``done`` once a
    # block and stopped in the block where the steps ended
    steps = int((jraw[0, 1:] != PAD_ID).sum())
    assert runner.reads == runner.blocks == max(1, -(-steps // k))
    if weights == "ending":
        assert steps == 1 and (jout[:, 1] == END_ID).all()


@pytest.mark.parametrize("weights", sorted(WEIGHTS))
def test_run_greedy_full_prefix_matches_cached(weights):
    _, _, tm = models(weights)
    pb = PackedBatch(**dataclasses.asdict(batch()))
    target_len = 9
    strings, matrix = run_greedy(tm, pb, MAX_FRAMES, target_len, MAX_STEPS, use_cache=True)
    fstrings, fmatrix = run_greedy(tm, pb, MAX_FRAMES, target_len, MAX_STEPS, use_cache=False)
    assert strings == fstrings
    np.testing.assert_array_equal(matrix, fmatrix)
    assert matrix.shape == (3, target_len + 1)


def test_loop_runner_copies_back_and_keeps_its_model():
    a, b = torch.zeros(3), torch.ones(3)
    read_only = torch.full((2,), 7.0)
    static = dict(cache=a, spare=b, x=torch.zeros(2), inputs=[(read_only,)])
    # after an odd number of ping-pong steps the current cache is the spare:
    # neither buffer is copied, the runner swaps the two names instead
    state = dict(cache=b, spare=a, x=torch.arange(2.0), inputs=[(read_only,)])
    copy_into(static, state)
    assert static["cache"] is a and torch.equal(a, torch.zeros(3)) and torch.equal(b, torch.ones(3))
    assert _swapped(static, state) == dict(cache=b, spare=a)
    assert torch.equal(static["x"], torch.arange(2.0))
    assert static["inputs"][0][0] is read_only
    with pytest.raises(TypeError):
        copy_into(dict(x=torch.zeros(1)), dict(x=1.0))

    _, _, tm = models("mixed")
    other = EMGModel(ModelConfig(**GEOMETRY), device="cpu").eval()
    with pytest.raises(ValueError, match="another model"):
        greedy_decode_cached(other, PackedBatch(**dataclasses.asdict(batch())), MAX_FRAMES,
                             MAX_STEPS, runner=LoopRunner(tm))
    with pytest.raises(ValueError):
        LoopRunner(tm, k=0)
