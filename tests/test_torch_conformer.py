"""The port's conformer against the JAX package's, with the same weights.

Small geometry: d=16, 2 heads, FF 32, depthwise kernel 7, relative
distance 8, dropout 0. JAX parameters are perturbed with seeded numpy noise
(so no LayerNorm sits at its identity init) and carried across with
``utils/convert.py``.

- ``ConvModule``, ``ConformerBlock`` and a two-layer ``ConformerEncoder``
  at T = 6 (within the relative table) and T = 13 (beyond it), with pad
  frames, every row compared.
- ``EMGModel(encoder_kind="conformer")``: encode (valid rows) and decode.
- bfloat16: the JAX conformer's layers carry no dtype, so a bf16 stream
  meets float32 parameters and runs float32; the port's encoder on the same
  bf16 input returns float32 and matches. The whole bf16 model (CNN in
  bf16) returns float32 memory and matches JAX's bf16 model to 5e-2 of its
  largest magnitude, the bound tests/test_torch_model.py holds bf16 serving
  to: the two CNNs' bf16 outputs differ by an ulp (0.5 at |src| ~ 66),
  which moves the memory about as far as bf16 moves it from float32
  (7e-2 in both packages).
- The state dict: every JAX leaf lands on exactly one port tensor, and the
  port's state dict equals what it loaded.
- One train step at dropout 0 (the ``tests/test_torch_train_step.py``
  harness: the JAX step's time shift read by a spy and handed to the port):
  three microbatches, one apply, losses to rtol 1e-5, parameters to 1e-5 of
  each tensor's largest magnitude.
Float32 to 1e-5 of each tensor's largest magnitude unless said otherwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import emg_tpu_torch.models.model as port_model_module
from emg_tpu.config import ModelConfig as JaxModelConfig
from emg_tpu.config import TrainConfig as JaxTrainConfig
from emg_tpu.models.conformer import ConformerBlock as JaxBlock
from emg_tpu.models.conformer import ConformerEncoder as JaxEncoder
from emg_tpu.models.conformer import ConvModule as JaxConvModule
from emg_tpu.models.model import EMGModel as JaxEMGModel
from emg_tpu.parallel import make_train_step as jax_make_train_step
from emg_tpu.train.state import create_train_state as jax_create_state
from tests.test_torch_model import example, one_torch_thread, perturbed  # noqa: F401
from tests.test_torch_train_step import _as_port_batch, _flat, shift_spy  # noqa: F401
from tests.test_torch_unfused_attention import assert_close
from tests.test_train_step import toy_batch

from emg_tpu_torch.config import ModelConfig, TrainConfig
from emg_tpu_torch.models.conformer import ConformerBlock, ConformerEncoder, ConvModule
from emg_tpu_torch.models.model import EMGModel
from emg_tpu_torch.parallel.train_step import make_train_step
from emg_tpu_torch.train.state import create_train_state
from emg_tpu_torch.utils.convert import (
    conformer_block_from_flax,
    conv_module_from_flax,
    state_dict_from_flax,
)

D, H, FF, K, MAXPOS = 16, 2, 32, 7, 8
GEOMETRY = dict(model_size=D, feed_forward_layer_size=FF, num_layers_encoder=2,
                num_layers_decoder=1, n_heads_encoder=H, n_heads_decoder=H,
                relative_distance=MAXPOS, dropout_model=0.0, dropout_pos_emb=0.0,
                encoder_kind="conformer", conformer_conv_kernel_size=K)
MAX_FRAMES = 16


def noisy(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(a, np.float32) + 0.2 * rng.normal(size=a.shape).astype(np.float32),
        params)


def stream(T, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(3, T, D)).astype(np.float32)
    pad = np.arange(T)[None, :] >= np.array([T, T - 2, max(T // 2, 1)])[:, None]
    return x.astype(dtype) if dtype is np.float32 else jnp.asarray(x, dtype), pad


@pytest.mark.parametrize("T", [6, 13])
def test_conv_module_matches_jax(T):
    x, pad = stream(T, seed=T)
    jm = JaxConvModule(D, K, 0.0)
    params = noisy(jm.init(jax.random.PRNGKey(0), x, pad, True)["params"], 1)
    ref = jm.apply({"params": params}, x, pad, True)
    tm = ConvModule(D, K)
    tm.load_state_dict(conv_module_from_flax(params), strict=True)
    with torch.no_grad():
        got = tm(torch.tensor(x), torch.tensor(pad))
    assert_close(got.numpy(), ref)


@pytest.mark.parametrize("T", [6, 13])
def test_conformer_block_matches_jax(T):
    x, pad = stream(T, seed=10 + T)
    jm = JaxBlock(D, H, FF, 0.0, MAXPOS, K)
    params = noisy(jm.init(jax.random.PRNGKey(0), x, pad, True)["params"], 2)
    ref = jm.apply({"params": params}, x, pad, True)
    tm = ConformerBlock(D, H, FF, MAXPOS, K)
    tm.load_state_dict(conformer_block_from_flax(params), strict=True)
    with torch.no_grad():
        got = tm(torch.tensor(x), torch.tensor(pad))
    assert_close(got.numpy(), ref)


def _encoders(seed=3):
    x, pad = stream(13, seed=seed)
    jm = JaxEncoder(2, D, H, FF, 0.0, MAXPOS, K)
    params = noisy(jm.init(jax.random.PRNGKey(0), x, pad, True)["params"], seed)
    tm = ConformerEncoder(2, D, H, FF, MAXPOS, 0.0, K)
    sd = {}
    for i in range(2):
        sd.update(conformer_block_from_flax(params[f"layer{i}"], f"layers.{i}."))
    tm.load_state_dict(sd, strict=True)
    return jm, params, tm.eval()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conformer_encoder_matches_jax(dtype):
    """On a bf16 input both run float32 after an exact upcast."""
    jm, params, tm = _encoders()
    x, pad = stream(13, seed=3, dtype=np.float32 if dtype == "float32" else jnp.bfloat16)
    ref = jm.apply({"params": params}, x, pad, True)
    assert ref.dtype == jnp.float32
    xt = torch.tensor(np.asarray(jnp.asarray(x, jnp.float32))).to(getattr(torch, dtype))
    with torch.no_grad():
        got = tm(xt, torch.tensor(pad))
    assert got.dtype == torch.float32
    assert_close(got.numpy(), ref)


@pytest.fixture(scope="module")
def models():
    jm = JaxEMGModel(JaxModelConfig(**GEOMETRY))
    packed, n_rows, offsets, lengths, y = example()
    variables = jm.init({"params": jax.random.PRNGKey(0)}, packed, n_rows, offsets, lengths,
                        y[:, :-1], 16, False)
    variables = perturbed({"params": variables["params"], "batch_stats": variables["batch_stats"]},
                          np.random.default_rng(9))
    sd = state_dict_from_flax(variables, 2, 1)
    tm = EMGModel(ModelConfig(**GEOMETRY), device="cpu")
    tm.load_state_dict(sd, strict=True)
    return jm, variables, sd, tm.eval()


def _port_encode(model, max_frames):
    packed, n_rows, offsets, lengths, _ = example()
    with torch.no_grad():
        return model.encode(torch.tensor(packed), n_rows, torch.tensor(offsets, dtype=torch.int64),
                            torch.tensor(lengths, dtype=torch.int64), max_frames)


@pytest.mark.parametrize("max_frames", [8, 16])
def test_conformer_model_matches_jax(models, max_frames):
    jm, variables, _, tm = models
    packed, n_rows, offsets, lengths, y = example()
    jmem, jlog, jmask = jm.apply(variables, packed, n_rows, offsets, lengths, max_frames,
                                 train=False, method=jm.encode)
    tmem, tlog, tmask = _port_encode(tm, max_frames)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    valid = ~np.asarray(jmask)
    assert_close(tmem.numpy()[valid], np.asarray(jmem)[valid])
    assert_close(tlog.numpy()[valid], np.asarray(jlog)[valid])
    jdec = jm.apply(variables, jnp.asarray(y[:, :-1]), jmem, jmask, False, method=jm.decode)
    with torch.no_grad():
        tdec = tm.decode(torch.tensor(y[:, :-1]), tmem, tmask)
    assert_close(tdec.numpy(), np.asarray(jdec))


def test_bf16_conformer_model_matches_jax(models):
    _, variables, sd, _ = models
    cfg = dict(GEOMETRY, compute_dtype="bfloat16")
    jm = JaxEMGModel(JaxModelConfig(**cfg))
    packed, n_rows, offsets, lengths, _ = example()
    jmem, _, jmask = jm.apply(variables, packed, n_rows, offsets, lengths, MAX_FRAMES,
                              train=False, method=jm.encode)
    tm = EMGModel(ModelConfig(**cfg), device="cpu")
    tm.load_state_dict(sd, strict=True)
    tmem, _, _ = _port_encode(tm.eval(), MAX_FRAMES)
    assert tmem.dtype == torch.float32 and jmem.dtype == jnp.float32
    valid = ~np.asarray(jmask)
    assert_close(tmem.numpy()[valid], np.asarray(jmem)[valid], rel=5e-2)


def test_state_dict_round_trip(models):
    _, variables, sd, tm = models
    n_leaves = len(jax.tree_util.tree_leaves(variables["params"]))
    n_bn = len(jax.tree_util.tree_leaves(variables["batch_stats"]))
    tracked = [k for k in sd if k.endswith("num_batches_tracked")]
    assert len(sd) == n_leaves + n_bn + len(tracked)
    got = tm.state_dict()
    assert set(got) == set(sd)
    for k, v in sd.items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=0, msg=k)
    depthwise = got["transformerEncoder.layers.0.conv_module.depthwise.weight"]
    assert depthwise.shape == (D, 1, K)


def steps_against_jax(jax_cfg: dict, train_cfg: dict, batches, shift_spy, monkeypatch,
                      rng_key: int = 0, patch_step=None):
    """Run the JAX ``make_train_step`` and the port's over ``batches`` from
    the same initial weights (batch_size_grad 4: an apply every two
    microbatches). Before each port microbatch the time shift the JAX step
    drew is handed to the port, and ``patch_step(monkeypatch, rng, mb,
    batch)`` may hand it more. Checks the losses per microbatch and the
    parameters, running statistics and pending gradient sums at the end.
    Returns the port's per-microbatch metrics."""
    jm = JaxEMGModel(JaxModelConfig(**jax_cfg))
    jcfg = JaxTrainConfig(**train_cfg)
    b0 = batches[0]
    variables = jm.init({"params": jax.random.PRNGKey(0)}, b0.packed_raw, b0.n_rows, b0.offsets,
                        b0.lengths, b0.targets[:, :-1], MAX_FRAMES, False)
    n_enc, n_dec = jax_cfg["num_layers_encoder"], jax_cfg["num_layers_decoder"]
    jstate = jax_create_state(variables["params"], variables["batch_stats"], jcfg)
    jstep = jax_make_train_step(jm, jcfg, MAX_FRAMES)
    rng = jax.random.PRNGKey(rng_key)

    tm = EMGModel(ModelConfig(**jax_cfg), device="cpu")
    tm.load_state_dict(state_dict_from_flax(variables, n_enc, n_dec), strict=True)
    cfg = TrainConfig(**train_cfg)
    state = create_train_state(tm, cfg)
    step = make_train_step(cfg)
    gen = torch.Generator()
    metrics, applied_lr = [], 0.0
    for b in batches:
        mb = int(jstate.microbatches)
        shift_spy.clear()
        jstate, jmet = jstep(jstate, b, rng)
        jax.effects_barrier()
        r = shift_spy[0] if shift_spy else 0
        monkeypatch.setattr(port_model_module, "draw_shift",
                            lambda generator, device, r=r: torch.tensor([r], device=device))
        if patch_step is not None:
            patch_step(monkeypatch, rng, mb, b)
        tmet = step(state, _as_port_batch(b), MAX_FRAMES, gen)
        for k in ("loss", "dec_loss", "enc_loss"):
            np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=1e-5, err_msg=k)
        assert tmet["applied"] == bool(jmet["applied"])
        applied_lr += tmet["lr"] if tmet["applied"] else 0.0
        metrics.append(tmet)
    assert state.updates == int(jstate.updates) >= 1

    ref = _flat(state_dict_from_flax({"params": jstate.params, "batch_stats": jstate.batch_stats},
                                     n_enc, n_dec))
    ref_acc = _flat(state_dict_from_flax({"params": jstate.accum_grads,
                                          "batch_stats": jstate.batch_stats}, n_enc, n_dec))
    got = _flat(tm.state_dict())
    got_acc = {k: g.numpy() for k, g in state.accum_grads().items()}
    bias_tol = 2 * applied_lr  # see tests/test_torch_train_step.py
    for k, _ in tm.named_parameters():
        if k.startswith("conv_blocks") and k.endswith(("conv1.bias", "conv2.bias",
                                                       "residual_path.bias")):
            np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=bias_tol, err_msg=k)
            continue
        for a, b, what in ((got[k], ref[k], k), (got_acc[k], ref_acc[k], f"pending sum {k}")):
            np.testing.assert_allclose(a, b, rtol=0, atol=max(1e-5 * float(np.abs(b).max()), 1e-6),
                                       err_msg=what)
    for k in got:
        if k.endswith(("running_mean", "running_var")):
            atol = 1e-5 * float(np.abs(ref[k]).max()) + (
                0.1 * bias_tol if k.endswith("running_mean") else 0.0)
            np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=atol, err_msg=k)
    return metrics


def test_conformer_train_step_matches_jax(shift_spy, monkeypatch):  # noqa: F811
    cfg = dict(GEOMETRY, num_layers_encoder=1)
    train = dict(batch_size_grad=4, learning_rate=1e-3, learning_rate_warmup=10)
    steps_against_jax(cfg, train, [toy_batch(seed=s) for s in range(3)], shift_spy, monkeypatch)


def test_conformer_dropout_draw_order(monkeypatch):
    """In train mode a block draws its dropout masks from the caller's
    generator in forward order: ff1's two, the attention probabilities,
    attn_drop, the conv module's, ff2's two."""
    import emg_tpu_torch.models.attention as attention_module
    import emg_tpu_torch.models.conformer as conformer_module

    calls = []
    real = attention_module.dropout

    def spy(x, rate, generator, training):
        calls.append(tuple(x.shape))
        return real(x, rate, generator, training)

    monkeypatch.setattr(attention_module, "dropout", spy)
    monkeypatch.setattr(conformer_module, "dropout", spy)
    block = ConformerBlock(D, H, FF, MAXPOS, K, dropout=0.2).train()
    x, pad = stream(13, seed=4)
    with torch.no_grad():
        out = block(torch.tensor(x), torch.tensor(pad), torch.Generator().manual_seed(5))
        again = block(torch.tensor(x), torch.tensor(pad), torch.Generator().manual_seed(5))
    B, T = x.shape[:2]
    ff, d = (B, T, FF), (B, T, D)
    assert calls[:7] == [ff, d, (B, H, T, T), d, d, ff, d]
    torch.testing.assert_close(out, again, rtol=0, atol=0)
