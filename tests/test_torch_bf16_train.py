"""bfloat16 training (``model.compute_dtype="bfloat16"``) against the JAX
package's bfloat16 step and against the port's own bfloat16 paths.

The tiny model of tests/test_train_step.py (d=16, 1+1 layers, 2 heads,
FF 32) on its toy batches, or the sharded-step test's five-utterance
batch. At bfloat16 the ResNet's convs, ``w_raw_in``, the encoder and the
decoder run on bfloat16 activations with float32 parameters cast at use;
BatchNorm and LayerNorm take their statistics in float32; the heads
``w_aux`` and ``w_out`` take the float32 memory and decoder output; the
losses take float32 logits; the gradient sums and AdamW stay float32.

- The step against JAX's ``make_train_step`` at ``compute_dtype=
  "bfloat16"``, as tests/test_torch_train_step.py does in float32 (JAX's
  state after two microbatches and an apply carried into the port, then
  three microbatches each, the second applying, JAX's time shift draws
  replayed), with the fused attention (the port's at every T) and with
  ``use_flash_attention=false`` (the unfused path on both sides: JAX takes
  it below T=384 in any case). Bounds:
  - each microbatch's losses to LOSS_RTOL (1e-2; 6.5e-4 seen);
  - every parameter after the applies to PARAM_TOL (5e-2) of its largest
    magnitude (2.3e-2 seen, 1.9e-3 for the weights), the BatchNorm running
    statistics likewise (2.4e-3 seen). Two groups to 2 * lr over the
    applies, Adam's step bound: the conv biases that feed a BatchNorm (true
    gradient 0, as in the float32 test), and the conv stack's BatchNorm
    betas (0.55 of their largest seen, 0.82 of lr). Their gradients sum
    the conv stack's bfloat16 backward over every position; where that
    sum is small against its rounding noise its sign differs between two
    bfloat16 computations, and Adam's normalized step then moves the
    parameter by up to lr the other way;
  - the whole update since the carry (the parameters' change, the BN-fed
    biases aside) to UPDATE_TOL (0.15) of its norm (0.059 seen);
  - the pending gradient sums, one microbatch's gradient, to
    GRAD_NORM_TOL (0.1) of their whole norm (0.034-0.039 seen). These
    are bfloat16 gradients: two bfloat16 computations of one gradient
    differ by their roundings, which the conv stack's BatchNorm backward
    amplifies: JAX's own bfloat16 gradient lies 0.08-0.3 of each conv
    tensor's largest from its float32 gradient, the port's as far, and
    the two as far from each other. XLA's CPU compiler keeps or drops a
    bfloat16 rounding inside a fusion (JAX's bfloat16 softmax differs
    between eager and jit in 6% of its elements), and below T=384 JAX
    attends with its unfused bfloat16 logits where the port's fused
    attention takes them in float32, so no per-element bound holds.
- ``model.remat`` at bfloat16 is bitwise the step without it, at dropout 0
  and 0.2, with the training attention run twice a layer (the recompute's
  draws read back).
- ``train.fused_window`` at bfloat16 (the CLI, windows run eagerly on the
  CPU) ends two epochs bitwise where the per-microbatch steps end.
- A 2x1 gloo mesh step at bfloat16 (dropout 0.2) against the single-rank
  bfloat16 step: the loss to 1e-5 and the gradients to MESH_GRAD_TOL
  (1e-2) of their whole norm (1.4e-3 seen). The ranks' BatchNorm sums meet
  over the mesh in another float32 order, which moves an activation by one
  bfloat16 ulp where it sits at a rounding boundary.
- The training attention's autograd function at bfloat16 on the CPU (its
  kernels' plain versions) returns the output in float32, dq, dk and dv
  at the inputs' dtype and d_used at ``used``'s, within 2e-2 of the plain
  forward's autograd (chip_smoke.py's TRAIN_ATTN_TOL: the backward's plain
  versions round ds to bfloat16 where the kernels do, autograd does not;
  6.2e-3 seen).
- The step hands the CTC and the label-smoothed CE float32 logits at
  bfloat16, and the CTC kernels refuse bfloat16 log-probs.
- The CLI trains at ``--model.compute_dtype bfloat16`` on the tiny corpus,
  writes ``latest`` (float32 parameters and AdamW moments) and
  ``model.pt``, and the greedy CLI (at bfloat16 and float32) and the beam
  CLI serve that model.pt as they serve a float32 one.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import emg_tpu_torch.models.model as port_model_module
from tests.test_torch_fused_window import TRAIN as WINDOW_TRAIN
from tests.test_torch_fused_window import _state as window_state
from tests.test_torch_fused_window import corpus  # noqa: F401
from tests.test_torch_model import one_torch_thread  # noqa: F401
from tests.test_torch_remat import port_step
from tests.test_torch_sharded_step import MAX_FRAMES as MESH_FRAMES
from tests.test_torch_sharded_step import TINY, _rank_steps, toy_batch
from tests.test_torch_train_step import MAX_FRAMES, _as_port_batch, _flat, shift_spy  # noqa: F401

from emg_tpu_torch import cli
from emg_tpu_torch.config import ModelConfig, TrainConfig
from emg_tpu_torch.data.fixtures import FIXTURE_SENTENCES
from emg_tpu_torch.decode import lm_train
from emg_tpu_torch.models.model import EMGModel
from emg_tpu_torch.parallel.distributed import launch
from emg_tpu_torch.parallel.train_step import make_train_step
from emg_tpu_torch.train.state import create_train_state

BF16 = dict(compute_dtype="bfloat16")
LOSS_RTOL = 1e-2
PARAM_TOL = 5e-2
UPDATE_TOL = 0.15
GRAD_NORM_TOL = 0.1
MESH_GRAD_TOL = 1e-2
ATTN_TOL = 2e-2
NO_APPLY = TrainConfig(batch_size_grad=10 ** 6)
DROPOUT = dict(dropout_model=0.2, dropout_pos_emb=0.2)
NO_DROPOUT = dict(dropout_model=0.0, dropout_pos_emb=0.0)


def _bn_fed_bias(name: str) -> bool:
    return name.startswith("conv_blocks") and name.endswith(("conv1.bias", "conv2.bias",
                                                              "residual_path.bias"))


def _conv_stack_beta(name: str) -> bool:
    return name.startswith("conv_blocks") and name.endswith(("bn1.bias", "bn2.bias",
                                                              "res_norm.bias"))


def _norm_rel(got: dict, want: dict) -> float:
    """The whole-vector relative difference, the BN-fed conv biases aside."""
    names = [n for n in got if not _bn_fed_bias(n)]
    diff = sum(float(((got[n] - want[n]).astype(np.float64) ** 2).sum()) for n in names)
    ref = sum(float((want[n].astype(np.float64) ** 2).sum()) for n in names)
    return (diff / ref) ** 0.5


@pytest.mark.parametrize("use_flash", [True, False], ids=["fused", "unfused"])
def test_bf16_train_step_matches_jax(shift_spy, monkeypatch, use_flash):  # noqa: F811
    import jax

    from emg_tpu.config import TrainConfig as JaxTrainConfig
    from emg_tpu.models import EMGModel as JaxEMGModel
    from emg_tpu.parallel import make_train_step as jax_make_train_step
    from emg_tpu.train.state import create_train_state as jax_create_state
    from tests.test_train_step import tiny_model, toy_batch as jax_toy_batch

    from emg_tpu_torch.utils.convert import load_adamw_from_flax, state_dict_from_flax

    jcfg_model = dataclasses.replace(tiny_model().cfg, compute_dtype="bfloat16",
                                     use_flash_attention=use_flash)
    model = JaxEMGModel(jcfg_model)
    jcfg = JaxTrainConfig(batch_size_grad=4, learning_rate=1e-3, learning_rate_warmup=10)
    batches = [jax_toy_batch(seed=s) for s in range(5)]
    b0 = batches[0]
    variables = model.init({"params": jax.random.PRNGKey(0)}, b0.packed_raw, b0.n_rows,
                           b0.offsets, b0.lengths, b0.targets[:, :-1], MAX_FRAMES, False)
    jstate = jax_create_state(variables["params"], variables["batch_stats"], jcfg)
    jstep = jax_make_train_step(model, jcfg, MAX_FRAMES)
    rng = jax.random.PRNGKey(0)

    def jax_microbatch(state, batch):
        shift_spy.clear()
        state, m = jstep(state, batch, rng)
        jax.effects_barrier()
        return state, m, (shift_spy[0] if shift_spy else 0)

    for b in batches[:2]:
        jstate, _, _ = jax_microbatch(jstate, b)
    assert int(jstate.updates) == 1

    cfg = TrainConfig(batch_size_grad=4, learning_rate=1e-3, learning_rate_warmup=10)
    port_cfg = ModelConfig(**{f.name: getattr(jcfg_model, f.name)
                              for f in dataclasses.fields(ModelConfig)})
    tm = EMGModel(port_cfg, device="cpu")
    assert tm.dtype == torch.bfloat16
    tm.load_state_dict(state_dict_from_flax(
        {"params": jstate.params, "batch_stats": jstate.batch_stats}, 1, 1))
    start = {k: v.copy() for k, v in _flat(tm.state_dict()).items()}
    state = create_train_state(tm, cfg)
    load_adamw_from_flax(state.optimizer, tm, jstate.opt_state, jstate.batch_stats, 1, 1)
    state.microbatches, state.updates = int(jstate.microbatches), int(jstate.updates)
    step = make_train_step(cfg)
    gen = torch.Generator()

    applied, applied_lr = [], 0.0
    for b in batches[2:]:
        jstate, jm, r = jax_microbatch(jstate, b)
        monkeypatch.setattr(port_model_module, "draw_shift",
                            lambda generator, device, r=r: torch.tensor([r], device=device))
        tmet = step(state, _as_port_batch(b), MAX_FRAMES, gen)
        for k in ("loss", "dec_loss", "enc_loss"):
            np.testing.assert_allclose(float(tmet[k]), float(jm[k]), rtol=LOSS_RTOL, err_msg=k)
        assert tmet["lr"] == float(jm["lr"]) and tmet["applied"] == bool(jm["applied"])
        applied.append(tmet["applied"])
        applied_lr += tmet["lr"] if tmet["applied"] else 0.0
    assert applied == [False, True, False]
    assert state.updates == int(jstate.updates) == 2

    ref = _flat(state_dict_from_flax({"params": jstate.params,
                                      "batch_stats": jstate.batch_stats}, 1, 1))
    ref_acc = _flat(state_dict_from_flax({"params": jstate.accum_grads,
                                          "batch_stats": jstate.batch_stats}, 1, 1))
    got = _flat(tm.state_dict())
    got_acc = {k: g.numpy() for k, g in state.accum_grads().items()}
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    assert all(g.dtype == torch.float32 for g in state.accum_grads().values())
    bias_tol = 2 * applied_lr
    for k, _ in tm.named_parameters():
        if _bn_fed_bias(k) or _conv_stack_beta(k):
            np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=bias_tol, err_msg=k)
            continue
        atol = PARAM_TOL * float(np.abs(ref[k]).max())
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=atol, err_msg=k)
    for k in got:
        if k.endswith(("running_mean", "running_var")):
            atol = (PARAM_TOL * float(np.abs(ref[k]).max())
                    + (0.1 * bias_tol if k.endswith("running_mean") else 0.0))
            np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=atol, err_msg=k)
    names = [k for k, _ in tm.named_parameters()]
    assert _norm_rel({k: got[k] - start[k] for k in names},
                     {k: ref[k] - start[k] for k in names}) <= UPDATE_TOL
    assert _norm_rel(got_acc, ref_acc) <= GRAD_NORM_TOL


@pytest.mark.parametrize("dropout", [NO_DROPOUT, DROPOUT], ids=["dropout0", "dropout0.2"])
def test_bf16_remat_is_bitwise_the_plain_step(dropout):
    kwargs = dict(TINY, num_layers_encoder=2, **BF16, **dropout)
    plain_loss, plain, plain_calls = port_step(kwargs)
    loss, grads, calls = port_step(dict(kwargs, remat=True))
    assert np.isfinite(loss) and loss == plain_loss
    for name, g in plain.items():
        assert g.dtype == torch.float32 and torch.equal(grads[name], g), name
    assert (plain_calls, calls) == (2, 4)


@pytest.fixture(scope="module")
def bf16_runs(corpus):
    """Two epochs of the CLI's train mode at bfloat16 on the fused-window
    test's corpus, with ``--train.fused_window`` true (eager windows on the
    CPU) and false."""
    root, argv = corpus
    runs = {}
    for fused in ("true", "false"):
        runs[fused] = cli.main(argv + WINDOW_TRAIN + [
            "--model.compute_dtype", "bfloat16", "--n_epochs", "2", "--device", "cpu",
            "--train.fused_window", fused, "--output_directory", str(root / f"bf16_{fused}")])
    return root, argv, runs


def test_bf16_windows_equal_per_microbatch_steps(bf16_runs):
    _, _, runs = bf16_runs
    windows = runs["true"].windows
    assert runs["false"].windows is None
    assert windows is not None and not windows.graphed and windows.eager_windows >= 3
    (la, a), (lb, b) = window_state(runs["true"]), window_state(runs["false"])
    assert la == lb and len(la) == 12 and all(np.isfinite(la))
    for key in ("microbatches", "updates", "accum_examples"):
        assert a[key] == b[key]
    assert b["updates"] == 3
    for k, v in b["model"].items():
        assert torch.equal(a["model"][k], v), k
    for k, v in b["accum_grads"].items():
        assert torch.equal(a["accum_grads"][k], v), k
    for i, st in b["optimizer"]["state"].items():
        for key, v in st.items():
            assert torch.equal(a["optimizer"]["state"][i][key], v), (i, key)


def test_bf16_cli_trains_and_the_greedy_cli_serves_it(bf16_runs):
    root, argv, runs = bf16_runs
    trainer = runs["false"]
    assert trainer.config.model.compute_dtype == "bfloat16"
    out = root / "bf16_false"
    assert (out / "latest").exists() and (out / "model.pt").exists()
    assert "finished epoch 1" in (out / "log.txt").read_text()
    latest = torch.load(out / "latest", weights_only=True)
    assert all(v.dtype == torch.float32 for k, v in latest["model"].items()
               if not k.endswith("num_batches_tracked"))
    moments = [v for st in latest["optimizer"]["state"].values() for k, v in st.items()
               if k.startswith("exp_avg")]
    assert moments and all(m.dtype == torch.float32 and torch.isfinite(m).all() for m in moments)
    served = torch.load(out / "model.pt", weights_only=True)
    assert served.keys() == latest["model"].keys()
    for decode_dtype in ("bfloat16", "float32"):
        per, acc = cli.main(argv + ["--device", "cpu", "--decode.compute_dtype", decode_dtype,
                                    "--output_directory", str(root / f"bf16_eval_{decode_dtype}"),
                                    "--evaluate_saved_greedy_search", str(out / "model.pt")])
        assert 0.0 <= per < float("inf") and 0.0 <= acc <= 100.0
    # the beam evaluation serves it too (the device beam, an ARPA of the
    # corpus's sentences)
    arpa = str(root / "bf16_lm.arpa")
    lm_train.write_arpa(lm_train.train_arpa(FIXTURE_SENTENCES, order=3), arpa)
    desc = root / "descriptions"
    beam_out = root / "bf16_beam"
    final = cli.main(argv + ["--device", "cpu", "--BeamWidth", "4", "--lang_model", arpa,
                             "--phonesSet", str(desc / "phonesSet"),
                             "--vocabulary", str(desc / "vocabulary"),
                             "--output_directory", str(beam_out),
                             "--evaluate_saved_beam_search", str(out / "model.pt")])
    assert 0.0 <= final < float("inf") and (beam_out / "log_beam_search.txt").exists()


def test_bf16_mesh_step_matches_single_rank(tmp_path, monkeypatch):
    """A 2x1 mesh of two CPU ranks over gloo, one microbatch at dropout 0.2
    with no apply, against the single-rank step (the time shift held at 3)."""
    kwargs = dict(TINY, **BF16, **DROPOUT)
    launch(_rank_steps, ([("bf16_2x1", (2, 1, False), kwargs, None, NO_APPLY, 3)],
                         str(tmp_path)), 2, "cpu")
    monkeypatch.setattr(port_model_module, "draw_shift",
                        lambda generator, device: torch.tensor([3], device=device))
    model = EMGModel(ModelConfig(**kwargs), device="cpu")
    metrics = make_train_step(NO_APPLY)(create_train_state(model, NO_APPLY), toy_batch(),
                                        MESH_FRAMES, torch.Generator())
    want = {n: p.grad.numpy() for n, p in model.named_parameters()}
    for rank in range(2):
        got = torch.load(os.path.join(tmp_path, f"bf16_2x1.{rank}.pt"))
        np.testing.assert_allclose(got["loss"], float(metrics["loss"]), rtol=1e-5)
        assert _norm_rel({n: g.numpy() for n, g in got["grads"].items()}, want) <= MESH_GRAD_TOL


@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_bf16_training_attention_function(rate):
    """``FlashAttentionRelposTrain`` (K3, then K4 and K5; on the CPU their
    plain versions) at bfloat16 against the plain forward's autograd, with
    ``used`` cast from a float32 table as the encoder passes it."""
    from emg_tpu_torch.ops import flash_attention as fa

    g = torch.Generator().manual_seed(0)
    B, H, T, Dh = 2, 2, 64, 64
    q, k, v = (torch.randn(B, H, T, Dh, generator=g).bfloat16().requires_grad_()
               for _ in range(3))
    table = (0.1 * torch.randn(H, 2 * T - 1, Dh, generator=g)).requires_grad_()
    oob = torch.zeros(2 * T - 1)
    kp = torch.zeros(B, T, dtype=torch.bool)
    kp[1, 50:] = True
    seed = torch.tensor([7], dtype=torch.int32)
    dout = torch.randn(B, H, T, Dh, generator=g)

    def run(attention):
        used = table.to(torch.bfloat16)
        o = attention(q, k, v, used, oob, kp, seed)
        return (o, *torch.autograd.grad(o, (q, k, v, used, table), dout))

    got = run(lambda *a: fa.FlashAttentionRelposTrain.apply(*a[:6], a[6], rate, 0, 0))
    want = run(lambda *a: fa.flash_attention_relpos_train_plain(*a[:6], rate, a[6]))
    assert [t.dtype for t in got] == [torch.float32, *[torch.bfloat16] * 4, torch.float32]
    for name, x, y in zip(("o", "dq", "dk", "dv", "d_used", "d_table"), got, want):
        x, y = x.detach().float(), y.detach().float()
        err = float((x - y).abs().max() / y.abs().max())
        assert err <= ATTN_TOL, (name, err)


def test_bf16_step_hands_float32_logits_to_the_losses(monkeypatch):
    import emg_tpu_torch.ops.ctc as ctc_module
    import emg_tpu_torch.parallel.train_step as train_step_module

    seen = []

    def recording(module, name, kind):
        real = getattr(module, name)

        def record(logits, *args, **kwargs):
            seen.append((kind, logits.dtype))
            return real(logits, *args, **kwargs)
        monkeypatch.setattr(module, name, record)

    recording(ctc_module, "ctc_nll", "ctc")
    recording(train_step_module, "label_smoothing_loss", "ce")
    model = EMGModel(ModelConfig(**TINY, **BF16), device="cpu")
    memory = []
    model.transformerEncoder.register_forward_hook(lambda m, i, o: memory.append(o.dtype))
    metrics = make_train_step(NO_APPLY)(create_train_state(model, NO_APPLY), toy_batch(),
                                        MESH_FRAMES, torch.Generator())
    assert torch.isfinite(metrics["loss"])
    assert memory == [torch.bfloat16]
    assert seen == [("ctc", torch.float32), ("ce", torch.float32)]
    lengths = torch.tensor([4, 4])
    with pytest.raises(TypeError, match="float32"):
        ctc_module.ctc_forward(torch.zeros(2, 4, 44, dtype=torch.bfloat16),
                               torch.ones(2, 1, dtype=torch.int64), lengths, torch.tensor([1, 1]))
