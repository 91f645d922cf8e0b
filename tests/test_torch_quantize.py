"""The port's int8 decoder weights (``emg_tpu_torch/utils/quantize.py``)
against the JAX package's (``emg_tpu/utils/quantize.py``).

A small model (d=32, 2+2 layers: tests/test_torch_model.py's geometry)
with perturbed JAX weights carried into the port.

- ``quantize_decoder_int8``: the port's int8 data and float32 scales equal
  JAX's bitwise (a Dense kernel's transposed), on the float32 weights and
  on the bf16-cast ones (``cast_params_for_serving`` first, the device
  beam's order); its dequantized weights (a bfloat16 product) equal JAX's
  ``Int8Tensor``'s bitwise. Exactly the decoder's matmul weights are
  quantized, the same names as JAX's; the function is idempotent and
  leaves the caller's model as it was.
- ``quantize_tensor``'s round trip is within half an LSB of each channel.
- Teacher-forced decode logits of the int8 bf16 model against JAX's int8
  bf16 model on the same memory: within 5e-2 of their largest magnitude,
  the bound the port's bf16 model parity tests hold (two libraries' bf16
  matmuls round their sums at different points).
- The int8 device beam (float32 stream, int8 weights dequantized to
  bfloat16) against JAX's, on the rule of
  tests/test_torch_beam.py::test_device_beam_matches_jax. Inside a jitted
  program XLA's CPU compiler keeps JAX's dequantized product in float32
  when a float32 matmul consumes it (it allows excess precision), where
  the source rounds it to bfloat16, as the port does; the winners' scores
  then differ by ~3e-4 (seed 11). So the JAX beam gets its int8 weights
  dequantized eagerly (``Int8Tensor.__jax_array__``, bitwise the port's).
  At bfloat16 the two agree bitwise (the product is rounded for the bf16
  matmul), but bf16 beams differ by ~1e-3 between the libraries anyway.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emg_tpu.config import DecodeConfig as JaxDecodeConfig
from emg_tpu.config import ModelConfig as JaxModelConfig
from emg_tpu.decode.device_beam import DeviceBeamSearcher as JaxDeviceBeamSearcher
from emg_tpu.models.model import EMGModel as JaxEMGModel
from emg_tpu.utils.quantize import Int8Tensor
from emg_tpu.utils.quantize import quantize_decoder_int8 as jax_quantize_decoder_int8
from emg_tpu.utils.serving import cast_params_for_serving as jax_cast_params_for_serving

from emg_tpu_torch.config import DecodeConfig, ModelConfig
from emg_tpu_torch.decode import DeviceBeamSearcher
from emg_tpu_torch.models.model import EMGModel
from emg_tpu_torch.utils.convert import state_dict_from_flax
from emg_tpu_torch.utils.quantize import Int8Weight, quantize_decoder_int8, quantize_tensor
from emg_tpu_torch.utils.serving import cast_params_for_serving
from tests.test_torch_beam import MAX_FRAMES, MAX_STEPS, as_port, batches, lexicon_lm, make_models  # noqa: F401
from tests.test_torch_model import GEOMETRY, one_torch_thread, perturbed  # noqa: F401
from tests.test_train_step import toy_batch

BF16_TOL = 5e-2  # of the largest magnitude (tests/test_torch_conformer.py, test_torch_model.py)


@pytest.fixture(scope="module")
def models():
    """(JAX bf16 model, its perturbed variables, the port's bf16 model with
    the same weights)."""
    cfg = dict(GEOMETRY, compute_dtype="bfloat16")
    jm = JaxEMGModel(JaxModelConfig(**cfg))
    b = toy_batch(B=1, n_rows=2, chunk=64, S=12, seed=5)
    v = jm.init({"params": jax.random.PRNGKey(5)}, b.packed_raw, b.n_rows, b.offsets, b.lengths,
                b.targets[:, :-1], 16, False)
    v = perturbed({"params": v["params"], "batch_stats": v["batch_stats"]},
                  np.random.default_rng(9))
    tm = EMGModel(ModelConfig(**cfg), device="cpu")
    tm.load_state_dict(state_dict_from_flax(v, 2, 2))
    return jm, v, tm.eval()


def port_name(path) -> str:
    """A JAX parameter path -> the port's dotted name."""
    out = []
    for p in path:
        key = getattr(p, "key", str(p))
        if key.startswith("layer") and key[5:].isdigit():
            out += ["layers", key[5:]]
        elif key != "ff":
            out.append("weight" if key == "kernel" else key)
    return ".".join(out)


def jax_int8_leaves(qv) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(
        qv["params"], is_leaf=lambda x: isinstance(x, Int8Tensor))[0]
    return {port_name(path): leaf for path, leaf in flat if isinstance(leaf, Int8Tensor)}


def dequantized(qv):
    """JAX's int8 variables with each ``Int8Tensor`` replaced by its
    dequantized array, computed eagerly."""
    return jax.tree_util.tree_map(lambda x: jnp.asarray(x) if isinstance(x, Int8Tensor) else x,
                                  qv, is_leaf=lambda x: isinstance(x, Int8Tensor))


def port_int8_weights(model) -> dict:
    return {name: m for name, m in model.named_modules() if isinstance(m, Int8Weight)}


@pytest.mark.parametrize("order", ["float32", "bf16_cast_first"])
def test_int8_data_and_scales_equal_jax(models, order):
    jm, v, tm = models
    if order == "float32":
        qv, qm = jax_quantize_decoder_int8(v), quantize_decoder_int8(tm)
    else:
        qv = jax_quantize_decoder_int8(jax_cast_params_for_serving(v))
        qm = quantize_decoder_int8(cast_params_for_serving(tm))
    want, got = jax_int8_leaves(qv), port_int8_weights(qm)
    # 2 layers x (self 4 + cross 4 + 2 feed-forward)
    assert set(got) == set(want) and len(got) == 20
    assert all(name.startswith("transformerDecoder.") for name in got)
    for name, w in got.items():
        data, scale = np.asarray(want[name].data), np.asarray(want[name].scale)
        if name.endswith(".weight"):  # a Dense kernel (in, out) is the Linear's (out, in)
            data, scale = data.T, scale.T
        assert w.data.dtype == torch.int8 and w.scale.dtype == torch.float32
        np.testing.assert_array_equal(w.data.numpy(), data, err_msg=name)
        np.testing.assert_array_equal(w.scale.numpy(), scale, err_msg=name)
        deq = np.asarray(jnp.asarray(want[name]).astype(jnp.float32))
        np.testing.assert_array_equal(w.dequantize().float().numpy(),
                                      deq.T if name.endswith(".weight") else deq, err_msg=name)


def test_quantize_is_a_copy_and_idempotent(models):
    _, _, tm = models
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    qm = quantize_decoder_int8(tm)
    assert qm is not tm and quantize_decoder_int8(qm) is qm
    q_params = dict(qm.named_parameters())
    for name, p in tm.named_parameters():
        if name in port_int8_weights(qm):
            assert name not in q_params
        else:
            assert q_params[name] is p  # shared, not copied
    assert not any(isinstance(m, Int8Weight) for m in tm.modules())
    for k, v in tm.state_dict().items():
        assert torch.equal(v, before[k])
    # the serving cast leaves int8 weights as they are
    cast = cast_params_for_serving(qm)
    assert set(port_int8_weights(cast)) == set(port_int8_weights(qm))
    assert cast.w_raw_in.weight.dtype == torch.bfloat16


def test_quantize_roundtrip_error_bound():
    rng = np.random.default_rng(0)
    w = torch.tensor(rng.normal(size=(4, 32, 8)).astype(np.float32))
    deq = quantize_tensor(w, 1, dequant_dtype=torch.float32).dequantize()
    # per-(head, output channel) error within half an LSB of that channel
    lsb = w.abs().amax(dim=1, keepdim=True) / 127.0
    assert bool(((deq - w).abs() <= 0.5 * lsb + 1e-7).all())
    lin = torch.tensor(rng.normal(size=(8, 16)).astype(np.float32))  # Linear (out, in)
    deq = quantize_tensor(lin, 1, dequant_dtype=torch.float32).dequantize()
    assert bool(((deq - lin).abs() <= 0.5 * lin.abs().amax(1, keepdim=True) / 127.0 + 1e-7).all())


def test_teacher_forced_decode_int8_matches_jax(models):
    jm, v, tm = models
    qv, qm = jax_quantize_decoder_int8(v), quantize_decoder_int8(tm)
    for seed in (5, 6, 7):
        b = toy_batch(B=1, n_rows=2, chunk=64, S=12, seed=seed)
        memory, _, mask = jm.apply(v, b.packed_raw, b.n_rows, b.offsets, b.lengths, 16, False,
                                   method=jm.encode)
        want = np.asarray(jm.apply(qv, b.targets, memory, mask, False, method=jm.decode),
                          np.float32)
        with torch.inference_mode():
            args = (torch.tensor(np.asarray(b.targets)), torch.tensor(np.asarray(memory, np.float32)),
                    torch.tensor(np.asarray(mask)))
            got = qm.decode(*args).float().numpy()
            unquantized = tm.decode(*args).float().numpy()
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(got, want, rtol=0, atol=BF16_TOL * scale)
        assert not np.array_equal(got, unquantized), "the decoder did not read its int8 weights"


def test_int8_device_beam_matches_jax(lexicon_lm):
    cfg = dict(BeamWidth=16, extra_steps=12, quantize_int8=True)
    seeds = [11, 12, 13, 14]
    jax_dev, agree, finished = None, 0, 0
    for seed in seeds:
        jm, v, tm = make_models(seed)
        if jax_dev is None:
            jax_dev = JaxDeviceBeamSearcher(jm, v, lexicon_lm["jax_tree"], lexicon_lm["jax_dlm"],
                                            JaxDecodeConfig(**cfg), MAX_FRAMES, max_steps=MAX_STEPS)
        # the weights are an argument of the search program; dequantized
        # eagerly (see the module doc)
        jax_dev.variables = dequantized(jax_quantize_decoder_int8(v))
        (b,), (L,) = batches([seed])
        jh, js, jw = jax_dev.search(b, L)
        dev = DeviceBeamSearcher(tm, lexicon_lm["port_tree"], lexicon_lm["port_dlm"],
                                 DecodeConfig(**cfg), MAX_FRAMES, max_steps=MAX_STEPS)
        assert len(port_int8_weights(dev.model)) == 10
        th, ts, tw = dev.search(as_port(b), L)
        finished += bool(np.isfinite(js))
        if list(jh) == list(th) and jw == tw and ts == pytest.approx(js, abs=1e-4):
            agree += 1
        else:
            margin = abs(ts - js)
            print(f"seed {seed}: the int8 searches differ; the two winners' scores differ by {margin}")
            assert margin < 1e-5, (seed, jw, tw, js, ts)
    assert finished >= len(seeds) - 1, "the searches rarely finished; the test's setup is too tight"
    assert agree >= len(seeds) - 1
