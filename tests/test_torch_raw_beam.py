"""``DeviceBeamSearcher.search_from_raw`` (the beam from the raw 1 kHz
signal) against the JAX package's, and the DSP it runs.

The JAX setup of tests/test_device_beam.py::
test_search_from_raw_matches_packed_path: a tiny float32 model (d=16, 1+1
layers) at max_frames 64, W = 8, n = 700 raw samples (bucket 1280, F = 58
frames <= 64), the lexicon and LM of tests/test_torch_beam.py.

- The port's ``preprocess_emg(buf, n, 0, 0)`` against JAX's
  ``preprocess_emg_batched`` at U = 1 (what JAX's ``_build_raw`` calls).
  The raw path has no neighbour context, so both ends are unpadded and
  the bound is PARITY.md's filtfilt edge bound, 1e-3 of each output's
  peak (the 2 Hz high-pass's float32 transient from an unpadded end
  reaches through a short signal; chip_smoke.py holds such utterances to
  it, and ROADMAP.md lists it as an expected difference). Measured here:
  3.1e-4 of the peak (features), 1.9e-4 (signals). JAX's own U = 1 and
  unbatched ``preprocess_emg`` agree to 1.5e-5.
- The port's ``search_from_raw`` against its own packed path (the DSP on
  the side, the soft clip, the rows packed in numpy, ``search``): equal.
- The port's ``search_from_raw`` against JAX's over three seeds (weights
  and signal), on the rule of tests/test_torch_beam.py::
  test_device_beam_matches_jax; the two DSPs differ at ~2e-4 of the
  signal, so a seed that differs must come from a near tie (1e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emg_tpu.config import DecodeConfig as JaxDecodeConfig
from emg_tpu.config import ModelConfig as JaxModelConfig
from emg_tpu.decode.device_beam import DeviceBeamSearcher as JaxDeviceBeamSearcher
from emg_tpu.dsp.pipeline import preprocess_emg_batched
from emg_tpu.models.model import EMGModel as JaxEMGModel

from emg_tpu_torch.config import DecodeConfig, ModelConfig
from emg_tpu_torch.data.batching import PackedBatch
from emg_tpu_torch.decode import DeviceBeamSearcher
from emg_tpu_torch.dsp.pipeline import preprocess_emg
from emg_tpu_torch.models.model import EMGModel
from emg_tpu_torch.utils.convert import state_dict_from_flax
from tests.test_torch_beam import TINY, lexicon_lm  # noqa: F401
from tests.test_torch_model import one_torch_thread, perturbed  # noqa: F401

EDGE_REL = 1e-3  # PARITY.md: filtfilt at an unpadded end
N = 700
BUCKET = 1280
MAX_FRAMES = 64
CFG = dict(BeamWidth=8, extra_steps=6)
MAX_STEPS = 14
TARGET_LEN = 6


def raw_signal(seed):
    return (120 * np.random.default_rng(seed).normal(size=(N, 8))).astype(np.float32)


def packed_by_hand(raw):
    """The packed path of JAX's test, on the port's DSP: (batch, F)."""
    buf = torch.zeros((BUCKET, 8))
    buf[:N] = torch.tensor(raw)
    out = preprocess_emg(buf, N, 0, 0)
    F = out.n_frames
    clipped = 50.0 * torch.tanh(out.emg_orig[8 : 8 + 8 * F] / 20.0 / 50.0)
    flat = np.full((1600, 8), 42.0, np.float32)
    flat[: 8 * F] = clipped.numpy()
    return PackedBatch(
        packed_raw=flat.reshape(1, 1600, 8), n_rows=np.int32(1), lengths=np.asarray([F], np.int32),
        offsets=np.zeros(1, np.int32), targets=np.full((1, 12), 42, np.int64),
        target_lengths=np.asarray([12], np.int32), n_examples=np.int32(1),
    ), F


@pytest.fixture(scope="module")
def jax_model():
    jm = JaxEMGModel(JaxModelConfig(**TINY))
    batch, _ = packed_by_hand(raw_signal(3))
    v = jm.init({"params": jax.random.PRNGKey(5)}, batch.packed_raw, batch.n_rows, batch.offsets,
                batch.lengths, batch.targets[:, :-1], MAX_FRAMES, False)
    return jm, {"params": v["params"], "batch_stats": v["batch_stats"]}


def models(jax_model, seed):
    jm, v = jax_model
    v = perturbed(v, np.random.default_rng(seed))
    tm = EMGModel(ModelConfig(**TINY), device="cpu")
    tm.load_state_dict(state_dict_from_flax(v, 1, 1))
    return v, tm.eval()


def port_searcher(lexicon_lm, tm):
    return DeviceBeamSearcher(tm, lexicon_lm["port_tree"], lexicon_lm["port_dlm"],
                              DecodeConfig(**CFG), MAX_FRAMES, max_steps=MAX_STEPS)


def test_raw_dsp_matches_jax_batched():
    raw = raw_signal(3)
    buf = np.zeros((BUCKET, 8), np.float32)
    buf[:N] = raw
    out = preprocess_emg(torch.tensor(buf), N, 0, 0)
    zeros1 = np.zeros(1, np.int32)
    ref = preprocess_emg_batched(jnp.asarray(buf[None]), np.asarray([N], np.int32), zeros1, zeros1, ())
    assert (out.n_frames, out.n_feat, out.n_raw) == (
        int(ref.n_frames[0]), int(ref.n_feat[0]), int(ref.n_raw[0]))
    assert 0 < out.n_frames <= MAX_FRAMES
    for got, want, n in ((out.emg_features, ref.emg_features, out.n_frames),
                         (out.emg, ref.emg, out.n_feat), (out.emg_orig, ref.emg_orig, out.n_raw)):
        want = np.asarray(want)[0, :n]
        np.testing.assert_allclose(got.numpy()[:n], want, rtol=0,
                                   atol=EDGE_REL * float(np.abs(want).max()))


def test_search_from_raw_matches_packed_path(lexicon_lm, jax_model):
    _, tm = models(jax_model, 11)
    dev = port_searcher(lexicon_lm, tm)
    raw = raw_signal(3)
    batch, F = packed_by_hand(raw)
    with torch.inference_mode():
        packed = dev.pack_raw(raw)
    assert int(packed.lengths[0]) == F and int(packed.n_rows) == 1
    np.testing.assert_array_equal(packed.packed_raw.numpy(), batch.packed_raw)
    h_a, s_a, w_a = dev.search(batch, TARGET_LEN)
    h_b, s_b, w_b = dev.search_from_raw(raw, TARGET_LEN)
    assert np.isfinite(s_a)
    assert list(h_a) == list(h_b) and w_a == w_b and s_a == s_b


def test_search_from_raw_matches_jax(lexicon_lm, jax_model):
    jm, _ = jax_model
    seeds = [11, 12, 13]
    jax_dev, agree, finished = None, 0, 0
    for seed in seeds:
        v, tm = models(jax_model, seed)
        if jax_dev is None:
            jax_dev = JaxDeviceBeamSearcher(jm, v, lexicon_lm["jax_tree"], lexicon_lm["jax_dlm"],
                                            JaxDecodeConfig(**CFG), MAX_FRAMES, max_steps=MAX_STEPS)
        jax_dev.variables = v  # an argument of the raw program: one compilation
        raw = raw_signal(seed)
        jh, js, jw = jax_dev.search_from_raw(raw, TARGET_LEN)
        th, ts, tw = port_searcher(lexicon_lm, tm).search_from_raw(raw, TARGET_LEN)
        finished += bool(np.isfinite(js))
        if list(jh) == list(th) and jw == tw and ts == pytest.approx(js, abs=1e-4):
            agree += 1
        else:
            print(f"seed {seed}: the searches differ; the two winners' scores differ by {abs(ts - js)}")
            assert abs(ts - js) < 1e-4, (seed, jw, tw, js, ts)
    assert finished >= len(seeds) - 1, "the searches rarely finished; the test's setup is too tight"
    assert agree >= len(seeds) - 1
