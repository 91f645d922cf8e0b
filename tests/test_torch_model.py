"""The port's EMGModel against the JAX package's, with the same weights.

Small geometry (d=32, 2+2 layers, 2 heads, relative distance 8, FF 64),
float32. The JAX model is initialized, every parameter and BatchNorm
statistic is perturbed with seeded numpy noise (so a transposed or
misnamed weight cannot hide behind an init constant), and the variables are
carried across with ``state_dict_from_flax``. The JAX side takes its XLA
attention path; the port takes the fused attention's plain version.
Tolerance 1e-4 (float32, different summation orders).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emg_tpu.config import ModelConfig as JaxModelConfig
from emg_tpu.models.model import EMGModel as JaxEMGModel
from emg_tpu.utils.convert import convert_reference_state_dict

from emg_tpu_torch.config import ModelConfig
from emg_tpu_torch.models.model import EMGModel
from emg_tpu_torch.utils.convert import state_dict_from_flax

TOL = dict(rtol=1e-4, atol=1e-4)
GEOMETRY = dict(
    model_size=32, feed_forward_layer_size=64, num_layers_encoder=2,
    num_layers_decoder=2, n_heads_encoder=2, n_heads_decoder=2,
    relative_distance=8, dropout_model=0.0, dropout_pos_emb=0.0,
)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs several pytest-xdist workers on one machine; a full
    torch thread pool in each oversubscribes the cores (the test_torch_*
    files ran ~3x slower under 4 workers). Shared by the test_torch_* files."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def perturbed(tree, rng):
    def leaf(path, x):
        x = np.asarray(x, np.float32)
        noise = rng.normal(size=x.shape).astype(np.float32)
        if path[-1].key == "var":  # BatchNorm variance stays positive
            return x * np.exp(0.3 * noise)
        return x + 0.1 * noise

    return jax.tree_util.tree_map_with_path(leaf, tree)


def example(seed=3):
    rng = np.random.default_rng(seed)
    packed = rng.normal(size=(3, 64, 8)).astype(np.float32) * 3.0
    packed[2, 40:] = 42.0  # the PAD_VALUE tail of the last packed row
    lengths = np.array([14, 7], np.int32)
    offsets = np.array([0, 14], np.int32)
    y = np.full((2, 9), 42, np.int64)
    y[0, :9] = np.r_[41, rng.integers(0, 40, 7), 40]
    y[1, :6] = np.r_[41, rng.integers(0, 40, 4), 40]
    return packed, 3, offsets, lengths, y


@pytest.fixture(scope="module", params=["per_position", "reference_batch"])
def models(request):
    cfg = dict(GEOMETRY, decoder_pe=request.param)
    jm = JaxEMGModel(JaxModelConfig(**cfg))
    packed, n_rows, offsets, lengths, y = example()
    variables = jm.init(
        {"params": jax.random.PRNGKey(0)}, packed, n_rows, offsets, lengths,
        y[:, :-1], 16, False,
    )
    variables = perturbed(
        {"params": variables["params"], "batch_stats": variables["batch_stats"]},
        np.random.default_rng(7),
    )
    tm = EMGModel(ModelConfig(**cfg), device="cpu")
    tm.load_state_dict(state_dict_from_flax(variables, 2, 2), strict=True)
    return jm, variables, tm.eval()


def _encode_both(models, max_frames=16):
    jm, variables, tm = models
    packed, n_rows, offsets, lengths, _ = example()
    jmem, jlog, jmask = jm.apply(
        variables, packed, n_rows, offsets, lengths, max_frames, train=False,
        method=jm.encode,
    )
    with torch.no_grad():
        tmem, tlog, tmask = tm.encode(
            torch.tensor(packed), n_rows, torch.tensor(offsets, dtype=torch.int64),
            torch.tensor(lengths, dtype=torch.int64), max_frames,
        )
    return (np.asarray(jmem), np.asarray(jlog), np.asarray(jmask)), (
        tmem.numpy(), tlog.numpy(), tmask.numpy())


@pytest.mark.parametrize("max_frames", [16, 24])
def test_encode_matches_jax(models, max_frames):
    (jmem, jlog, jmask), (tmem, tlog, tmask) = _encode_both(models, max_frames)
    np.testing.assert_array_equal(jmask, tmask)
    valid = ~jmask
    np.testing.assert_allclose(tmem[valid], jmem[valid], **TOL)
    np.testing.assert_allclose(tlog[valid], jlog[valid], **TOL)


def test_decode_matches_jax(models):
    jm, variables, tm = models
    _, _, _, _, y = example()
    (jmem, _, jmask), _ = _encode_both(models)
    jdec = jm.apply(variables, jnp.asarray(y[:, :-1]), jmem, jmask, False, method=jm.decode)
    with torch.no_grad():
        tdec = tm.decode(torch.tensor(y[:, :-1]), torch.tensor(jmem), torch.tensor(jmask))
    np.testing.assert_allclose(tdec.numpy(), np.asarray(jdec), **TOL)


def test_decode_step_matches_jax(models):
    """Step-by-step KV-cached decoding over the teacher-forced tokens, from
    the same memory: per-step logits agree."""
    jm, variables, tm = models
    _, _, _, _, y = example()
    (jmem, _, jmask), _ = _encode_both(models)
    B, S = y.shape
    jkv = jm.apply(variables, jnp.asarray(jmem), method=jm.project_cross_kvs)
    jcache = jm.init_decode_cache(B, S)
    tokens = y.astype(np.int32)
    with torch.no_grad():
        tkv = tm.project_cross_kvs(torch.tensor(jmem))
        tcache = tm.init_decode_cache(B, S)
        for s in range(S - 1):
            jlog, jcache = jm.apply(
                variables, jnp.asarray(tokens[:, s]), s, jcache, jkv,
                jnp.asarray(tokens), jnp.asarray(jmask), method=jm.decode_step,
            )
            tlog = tm.decode_step(
                torch.tensor(y[:, s]), s, tcache, tkv, torch.tensor(y), torch.tensor(jmask),
            )
            np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
        np.testing.assert_allclose(
            tcache[0].numpy()[:, :, :, : S - 1], np.asarray(jcache[0])[:, :, :, : S - 1], **TOL
        )


def test_state_dict_round_trip(models):
    """convert_reference_state_dict(port.state_dict()) gives back the JAX
    tree exactly: state_dict_from_flax is its inverse."""
    _, variables, tm = models
    back = convert_reference_state_dict(tm.state_dict(), 2, 2)
    flat_a = jax.tree_util.tree_leaves_with_path(variables)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), np.asarray(leaf))


def test_train_mode_batchnorm_matches_jax():
    """MaskedBatchNorm's train-mode shifted one-pass statistics and running
    update against the JAX module, on valid rows only."""
    from emg_tpu.models.resnet import MaskedBatchNorm as JaxBN
    from emg_tpu_torch.models.resnet import MaskedBatchNorm

    rng = np.random.default_rng(5)
    x = (rng.normal(size=(6, 10, 5)) * 2.0 + 30.0).astype(np.float32)
    jbn = JaxBN()
    v = jbn.init(jax.random.PRNGKey(0), jnp.asarray(x), 4, False)
    jout, upd = jbn.apply(v, jnp.asarray(x), 4, False, mutable=["batch_stats"])
    bn = MaskedBatchNorm(5).train()
    tout = bn(torch.tensor(x).permute(0, 2, 1), 4).permute(0, 2, 1)
    np.testing.assert_allclose(tout.detach().numpy()[:4], np.asarray(jout)[:4], **TOL)
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(upd["batch_stats"]["mean"]), **TOL)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(upd["batch_stats"]["var"]), **TOL)


def test_bf16_serving_tracks_float32(models):
    """bfloat16 serving (parameters float32, cast at use) rounds as the JAX
    package's bfloat16 encoder: on valid rows it stays within 5e-2 of
    JAX's bfloat16 memory (a bound on bf16 rounding), and no farther from
    the float32 encoder than JAX's bfloat16 memory is. On these perturbed
    weights neither lies within 5e-2 of float32 everywhere: each conv's
    bias is added after its output is rounded to bf16, as Flax's
    ``nn.Conv(dtype=bfloat16)`` adds it (0.072 from float32 at worst, JAX's
    0.092)."""
    jm, variables, tm = models
    packed, n_rows, offsets, lengths, _ = example()
    args = (torch.tensor(packed), n_rows, torch.tensor(offsets, dtype=torch.int64),
            torch.tensor(lengths, dtype=torch.int64), 16)
    bf = EMGModel(dataclasses.replace(tm.cfg, compute_dtype="bfloat16"), device="cpu")
    bf.load_state_dict(tm.state_dict())
    with torch.no_grad():
        m32, _, mask = tm.encode(*args)
        m16, _, _ = bf.eval().encode(*args)
    assert m16.dtype == torch.float32
    valid = (~mask).numpy()
    jbf = JaxEMGModel(dataclasses.replace(jm.cfg, compute_dtype="bfloat16"))
    j16, _, _ = jbf.apply(variables, packed, n_rows, offsets, lengths, 16, train=False,
                          method=jbf.encode)
    j32, _, _ = jm.apply(variables, packed, n_rows, offsets, lengths, 16, train=False,
                         method=jm.encode)
    j16, j32 = np.asarray(j16)[valid], np.asarray(j32)[valid]
    m16, m32 = m16.numpy()[valid], m32.numpy()[valid]
    np.testing.assert_allclose(m16, j16, atol=5e-2, rtol=5e-2)
    assert np.abs(m16 - m32).max() <= np.abs(j16 - j32).max()
