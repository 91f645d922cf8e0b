"""The port's unfused relative-position attention against the JAX package's
XLA path.

- ``relative_to_absolute`` is pure data movement: bitwise equal.
- ``MultiHeadAttention(use_flash=False)`` with the relative table
  (d=16, 2 heads, relative distance 8) at L below, at and above
  ``max_relative_pos`` (no out-of-range mask at L <= 8; the table padded
  and the mask added above), with key and query pads. Both packages mask
  pad query rows the same way here, so every row is compared.
- The transformer ``EMGModel`` under ``use_flash_attention=false``
  (d=16, 2+2 layers) against JAX's, encode and decode, on valid rows; and
  against the port's own fused path (the kernels' plain versions), which
  gives the same valid rows.
Float32, to 1e-5 of each tensor's largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emg_tpu.config import ModelConfig as JaxModelConfig
from emg_tpu.models.attention import MultiHeadAttention as JaxMHA
from emg_tpu.models.attention import relative_to_absolute as jax_relative_to_absolute
from emg_tpu.models.model import EMGModel as JaxEMGModel
from tests.test_torch_model import example, one_torch_thread, perturbed  # noqa: F401

from emg_tpu_torch.config import ModelConfig
from emg_tpu_torch.models.attention import MultiHeadAttention, relative_to_absolute
from emg_tpu_torch.models.model import EMGModel
from emg_tpu_torch.utils.convert import state_dict_from_flax

D, H, MAXPOS = 16, 2, 8
SMALL = dict(model_size=D, feed_forward_layer_size=32, num_layers_encoder=2,
             num_layers_decoder=2, n_heads_encoder=H, n_heads_decoder=H,
             relative_distance=MAXPOS, dropout_model=0.0, dropout_pos_emb=0.0,
             use_flash_attention=False)


def assert_close(got, ref, rel=1e-5):
    """Within ``rel`` of the reference's largest magnitude."""
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), ref, rtol=0,
                               atol=rel * float(np.abs(ref).max()))


@pytest.mark.parametrize("L", [1, 4, 8, 13])
def test_relative_to_absolute_bitwise(L):
    x = np.random.default_rng(L).normal(size=(2, 3, L, 2 * L - 1)).astype(np.float32)
    got = relative_to_absolute(torch.tensor(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_relative_to_absolute(jnp.asarray(x))))
    q, k = np.meshgrid(np.arange(L), np.arange(L), indexing="ij")
    np.testing.assert_array_equal(got, x[:, :, q, k - q + L - 1])


def _pads(B, L, rng):
    lengths = rng.integers(max(L // 2, 1), L + 1, size=B)
    lengths[0] = L  # one row without pads
    return np.arange(L)[None, :] >= lengths[:, None]


@pytest.mark.parametrize("L", [5, 8, 13])
@pytest.mark.parametrize("masks", ["key", "key_and_query", "none"])
def test_multihead_attention_unfused_matches_jax(L, masks):
    rng = np.random.default_rng(10 * L + len(masks))
    B = 3
    x = rng.normal(size=(B, L, D)).astype(np.float32)
    pad = _pads(B, L, rng)
    kp = pad if masks != "none" else None
    qp = pad if masks == "key_and_query" else None
    jm = JaxMHA(D, H, dropout=0.0, relative_positional=True, relative_positional_distance=MAXPOS)
    params = jm.init(jax.random.PRNGKey(0), x, x, x)["params"]
    # perturbed, so the table's window and each projection matter
    params = jax.tree.map(
        lambda a: np.asarray(a) + 0.3 * rng.normal(size=a.shape).astype(np.float32), params)
    ref = jm.apply({"params": params}, x, x, x, key_padding_mask=kp, query_padding_mask=qp)

    tm = MultiHeadAttention(D, H, relative_positional=True, relative_positional_distance=MAXPOS)
    with torch.no_grad():
        for w in ("w_q", "w_k", "w_v", "w_o"):
            getattr(tm, w).copy_(torch.tensor(np.asarray(params[w])))
        tm.relative_positional.embeddings.copy_(
            torch.tensor(np.asarray(params["relative_positional"]["embeddings"]))[..., None])
        xt = torch.tensor(x)
        got = tm(xt, xt, key_padding_mask=None if kp is None else torch.tensor(kp),
                 query_padding_mask=None if qp is None else torch.tensor(qp))
    assert not tm.use_flash
    assert_close(got.numpy(), ref)


@pytest.fixture(scope="module")
def transformer_models():
    jm = JaxEMGModel(JaxModelConfig(**SMALL))
    packed, n_rows, offsets, lengths, y = example()
    variables = jm.init({"params": jax.random.PRNGKey(0)}, packed, n_rows, offsets, lengths,
                        y[:, :-1], 16, False)
    variables = perturbed({"params": variables["params"], "batch_stats": variables["batch_stats"]},
                          np.random.default_rng(8))
    sd = state_dict_from_flax(variables, 2, 2)
    tm = EMGModel(ModelConfig(**SMALL), device="cpu")
    tm.load_state_dict(sd, strict=True)
    fused = EMGModel(ModelConfig(**dict(SMALL, use_flash_attention=True)), device="cpu")
    fused.load_state_dict(sd, strict=True)
    return jm, variables, tm.eval(), fused.eval()


def _encode(model, max_frames):
    packed, n_rows, offsets, lengths, _ = example()
    with torch.no_grad():
        return model.encode(torch.tensor(packed), n_rows, torch.tensor(offsets, dtype=torch.int64),
                            torch.tensor(lengths, dtype=torch.int64), max_frames)


@pytest.mark.parametrize("max_frames", [8, 16, 24])
def test_unfused_transformer_model_matches_jax(transformer_models, max_frames):
    """max_frames 8 sits at the table (no out-of-range mask), 16 and 24
    above it."""
    jm, variables, tm, fused = transformer_models
    packed, n_rows, offsets, lengths, y = example()
    jmem, jlog, jmask = jm.apply(variables, packed, n_rows, offsets, lengths, max_frames,
                                 train=False, method=jm.encode)
    tmem, tlog, tmask = _encode(tm, max_frames)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    valid = ~np.asarray(jmask)
    assert_close(tmem.numpy()[valid], np.asarray(jmem)[valid])
    assert_close(tlog.numpy()[valid], np.asarray(jlog)[valid])
    fmem, _, _ = _encode(fused, max_frames)
    assert_close(fmem.numpy()[valid], tmem.numpy()[valid])

    jdec = jm.apply(variables, jnp.asarray(y[:, :-1]), jmem, jmask, False, method=jm.decode)
    with torch.no_grad():
        tdec = tm.decode(torch.tensor(y[:, :-1]), tmem, tmask)
    assert_close(tdec.numpy(), np.asarray(jdec))
