"""``train.fused_window`` (the step graphs of ``parallel/train_step.py``, one
a microbatch signature) on the CPU, against the per-microbatch eager path
and the JAX package's fused windows, and the window plan.

- ``plan_windows`` equals the JAX trainer's ``_plan_windows`` on seeded
  random batch lists, start counts and ``report_loss`` /
  ``batch_size_grad`` values.
- A trainer with ``--train.fused_window true`` on the CPU runs its
  microbatches through the step graphs' bookkeeping eagerly (the graphs'
  own generator, the same staging and body as a graph replays; every
  microbatch a capture or a replay) and ends two epochs bitwise where
  the per-microbatch path ends: every microbatch's losses, the parameters,
  the BatchNorm statistics, AdamW's moments and step counts, the pending
  gradient sums and the counters. The corpus (4 sentences, 6 training
  utterances of one microbatch each at max_batch_length 3000;
  batch_size_grad 4, report_loss 3) runs microbatches with and without an
  apply.
- One epoch against the JAX trainer with ``fused_window=True`` from
  the same weights (JAX's initial weights carried across through a
  model.pt), on the port's dataset, at dropout 0 with the time shift held
  at 0 on both sides (the JAX model's ``_shift_rows`` made the identity),
  the evaluation passes and PER reports left out on both: every
  microbatch's loss to rtol 1e-5; the parameters and BatchNorm statistics
  to 1e-5 of each tensor's largest magnitude, the pending sums zero on both
  (tests/test_torch_train_step.py's bounds, with its exception for the
  conv biases that feed a BatchNorm: 2 * lr an apply), and AdamW's first
  moment, the summed gradients, to MOMENT_TOL (see there).
  The epoch is planned as a window of 4 microbatches and one of 2 that
  applies (batch_size_grad 6, report_loss 4), so every gradient is taken at
  the initial weights. JAX ran at least one window program; the port
  replayed at least one step graph.
- ``train.fused_window`` None resolves off on the CPU, on for a CUDA
  device; on a mesh over gloo (two CPU ranks) None resolves off and
  ``True`` raises.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from tests.test_torch_model import one_torch_thread  # noqa: F401

from emg_tpu_torch import cli
from emg_tpu_torch.config import Config, TrainConfig
from emg_tpu_torch.data.dataset import make_normalizers
from emg_tpu_torch.data.fixtures import make_synthetic_corpus
from emg_tpu_torch.parallel.distributed import launch
from emg_tpu_torch.train.trainer import Trainer
from emg_tpu_torch.train.window import plan_windows, windows_enabled
from emg_tpu_torch.utils import profiling

TINY = ["--model.model_size", "16", "--feed_forward_layer_size", "32",
        "--num_layers_encoder", "1", "--num_layers_decoder", "1",
        "--n_heads_encoder", "2", "--n_heads_decoder", "2", "--relative_distance", "8"]
TRAIN = ["--max_batch_length", "3000", "--batch_size_grad", "4", "--report_loss", "3",
         "--per_train_batches", "1", "--learning_rate_warmup", "4"]
# against JAX: one epoch planned as a window of 4 microbatches and one of 2
# that applies, so every gradient is taken at the initial weights
JAX_TRAIN = ["--batch_size_grad", "6", "--report_loss", "4"]
NO_DROPOUT = ["--dropout_model", "0", "--dropout_pos_emb", "0"]
# AdamW's first moment against JAX's: the gradients summed over six
# microbatches. Those of the CNN's first layers cancel over every packed
# sample, and the two packages' float32 reductions leave them up to ~1.4e-4
# of each tensor's largest magnitude apart (as far with F.ctc_loss in place
# of the port's CTC); the BatchNorm-fed conv biases (true gradient 0) to
# 1e-6 of the largest moment (8.6e-8 seen)
MOMENT_TOL = 5e-4
MOMENT_NOISE_TOL = 1e-6


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("window_corpus")
    paths = make_synthetic_corpus(str(root), n_sentences=4, seed=0)
    argv = ["--silent_data_directories", paths["silent_data_directories"],
            "--voiced_data_directories", paths["voiced_data_directories"],
            "--testset_file", paths["testset_file"], "--dict", paths["dict"],
            "--normalizers_file", os.path.join(str(root), "normalizers.pkl")] + TINY
    make_normalizers(Config.from_args(argv), device="cpu")
    return root, argv


@pytest.mark.parametrize("seed", range(4))
def test_plan_windows_matches_jax(seed):
    from emg_tpu.config import TrainConfig as JaxTrainConfig
    from emg_tpu.train.trainer import Trainer as JaxTrainer

    rng = np.random.default_rng(seed)
    for _ in range(200):
        n = int(rng.integers(0, 80))
        batches = [list(range(int(rng.integers(1, 40)))) for _ in range(n)]
        kw = dict(report_loss=int(rng.integers(1, 50)), batch_size_grad=int(rng.integers(1, 120)))
        start = int(rng.integers(0, kw["batch_size_grad"]))
        ours = plan_windows(batches, start, TrainConfig(**kw))
        assert ours == JaxTrainer._plan_windows(batches, start, JaxTrainConfig(**kw))
        assert sum(ours) == n and all(1 <= w <= 32 for w in ours)


def _state(trainer):
    """What a run leaves: its losses and its whole train state, on the CPU."""
    latest = torch.load(os.path.join(trainer.ckpt.directory, "latest"), weights_only=True)
    return trainer.train_losses, latest


def graph_counts(run):
    """``run()`` inside ``profiling.recording()``: (its result, the step
    graphs' capture and replay counts)."""
    with profiling.recording():
        out = run()
    counts = profiling.recorded().counts
    profiling.clear()
    return out, (counts.get("step_graphs.capture", 0), counts.get("step_graphs.replay", 0))


def test_cpu_windows_equal_per_microbatch_steps(corpus):
    root, argv = corpus
    runs, counts = {}, {}
    for fused in ("true", "false"):
        runs[fused], counts[fused] = graph_counts(lambda: cli.main(argv + TRAIN + [
            "--n_epochs", "2", "--device", "cpu", "--train.fused_window", fused,
            "--output_directory", str(root / f"fused_{fused}")]))
    assert runs["true"].graphed and not runs["false"].graphed
    assert counts["false"] == (0, 0)
    captures, replays = counts["true"]
    assert captures >= 2 and replays >= 3 and captures + replays == 12
    (la, a), (lb, b) = _state(runs["true"]), _state(runs["false"])
    assert la == lb and len(la) == 12
    for key in ("microbatches", "updates", "accum_examples"):
        assert a[key] == b[key]
    assert b["updates"] == 3
    for k, v in b["model"].items():
        assert torch.equal(a["model"][k], v), k
    for k, v in b["accum_grads"].items():
        assert torch.equal(a["accum_grads"][k], v), k
    for i, s in b["optimizer"]["state"].items():
        for key, v in s.items():
            assert torch.equal(a["optimizer"]["state"][i][key], v), (i, key)


def _bn_fed_bias(name: str) -> bool:
    return name.startswith("conv_blocks") and name.endswith(("conv1.bias", "conv2.bias",
                                                              "residual_path.bias"))


def test_cpu_windows_match_jax_windows(corpus, monkeypatch):
    import jax

    import emg_tpu.models.model as jax_model_module
    import emg_tpu_torch.models.model as port_model_module
    from emg_tpu.config import Config as JaxConfig
    from emg_tpu.train.metrics_writer import NullMetricsWriter
    from emg_tpu.train.trainer import Trainer as JaxTrainer
    from emg_tpu_torch.data.dataset import EMGDataset
    from emg_tpu_torch.utils.convert import state_dict_from_flax

    root, argv = corpus
    args = argv + TRAIN + JAX_TRAIN + NO_DROPOUT + ["--n_epochs", "1"]
    # the time shift held at 0 on both sides; no evaluation pass, no PER report
    monkeypatch.setattr(jax_model_module, "_shift_rows", lambda x, r: x)
    monkeypatch.setattr(port_model_module, "draw_shift",
                        lambda generator, device: torch.zeros(1, dtype=torch.int64, device=device))
    for cls in (JaxTrainer, Trainer):
        monkeypatch.setattr(cls, "evaluation_loop", lambda self, state, sampler: {
            "loss": 0.0, "dec_loss": 0.0, "enc_loss": 0.0})
        monkeypatch.setattr(cls, "report_PER", lambda self, *a: 1.0)

    jcfg = JaxConfig.from_args(args + ["--output_directory", str(root / "jax_run"),
                                       "--train.fused_window", "true"])
    cfg = Config.from_args(args + ["--output_directory", str(root / "jax_init")])
    trainset = EMGDataset(cfg, device="cpu")
    devset = EMGDataset(cfg, dev=True, device="cpu")
    jax_losses, programs = [], []
    real_window_for = JaxTrainer._window_for

    def window_for(self, seq):
        fn = real_window_for(self, seq)
        if fn is None:
            return None

        def run(state, batches, rng):
            state, ms = fn(state, batches, rng)
            programs.append(len(batches))
            jax_losses.extend(float(m["loss"]) for m in ms)
            return state, ms
        return run

    real_step_for = JaxTrainer._train_step_for

    def step_for(self, max_frames):
        fn = real_step_for(self, max_frames)

        def run(state, pb, rng):
            state, m = fn(state, pb, rng)
            jax_losses.append(float(m["loss"]))
            return state, m
        return run

    monkeypatch.setattr(JaxTrainer, "_window_for", window_for)
    monkeypatch.setattr(JaxTrainer, "_train_step_for", step_for)
    jtrainer = JaxTrainer(jcfg, trainset, devset, NullMetricsWriter())
    jstate = jtrainer.init_state()
    n_enc, n_dec = cfg.model.num_layers_encoder, cfg.model.num_layers_decoder
    init = state_dict_from_flax({"params": jax.tree.map(np.asarray, jstate.params),
                                 "batch_stats": jax.tree.map(np.asarray, jstate.batch_stats)},
                                n_enc, n_dec)
    torch.save(init, root / "jax_init.pt")
    jstate = jtrainer.train(jstate)
    assert programs and max(programs) > 1

    port, (_, replays) = graph_counts(lambda: cli.main(args + [
        "--device", "cpu", "--train.fused_window", "true",
        "--start_training_from", str(root / "jax_init.pt"),
        "--output_directory", str(root / "port_run")]))
    assert replays >= 1
    np.testing.assert_allclose(port.train_losses, jax_losses, rtol=1e-5)
    _, latest = _state(port)
    assert latest["microbatches"] == int(jstate.microbatches)
    assert latest["updates"] == int(jstate.updates) >= 1
    ref = state_dict_from_flax({"params": jstate.params, "batch_stats": jstate.batch_stats},
                               n_enc, n_dec)
    lr = float(cfg.train.learning_rate)
    bias_tol = 2 * lr * latest["updates"]
    for name, got in latest["model"].items():
        if name.endswith("num_batches_tracked"):
            continue
        want = ref[name].numpy()
        if _bn_fed_bias(name):
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=bias_tol, err_msg=name)
            continue
        atol = max(1e-5 * float(np.abs(want).max()), 1e-6)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol, err_msg=name)
    # AdamW's first moment after its one apply: 0.1 * the summed gradients
    mu = state_dict_from_flax({"params": jstate.opt_state.mu, "batch_stats": jstate.batch_stats},
                              n_enc, n_dec)
    port_names = list(latest["accum_grads"])
    moments = {port_names[i]: s["exp_avg"].numpy() for i, s in latest["optimizer"]["state"].items()}
    assert len(moments) == len(port_names)
    largest = max(float(np.abs(mu[n].numpy()).max()) for n in port_names)
    for name in port_names:
        want = mu[name].numpy()
        atol = (MOMENT_NOISE_TOL * largest if _bn_fed_bias(name)
                else MOMENT_TOL * float(np.abs(want).max()))
        np.testing.assert_allclose(moments[name], want, rtol=0, atol=atol, err_msg=f"mu {name}")
    for name, got in latest["accum_grads"].items():
        assert not got.any(), name
    assert not any(np.asarray(g).any() for g in jax.tree.leaves(jstate.accum_grads))


@pytest.mark.parametrize("fused, device, expected", [
    (None, "cpu", False), (None, "cuda", True), (True, "cpu", True), (False, "cuda", False),
], ids=["auto_cpu", "auto_cuda", "true_cpu", "false_cuda"])
def test_fused_window_resolves(fused, device, expected):
    cfg = dataclasses.replace(TrainConfig(), fused_window=fused)
    assert windows_enabled(cfg, torch.device(device)) is expected


def _gloo_rank(argv, out_dir):
    import torch.distributed as dist

    torch.set_num_threads(1)
    rank = dist.get_rank()
    results = {}
    for fused in (None, True):
        flags = [] if fused is None else ["--train.fused_window", "true"]
        cfg = Config.from_args(argv + TRAIN + flags + ["--parallel.data_axis", "2",
                                                       "--output_directory", out_dir])
        try:
            results[str(fused)] = not Trainer(cfg, None, None, None, device="cpu").graphed
        except ValueError as e:
            results[str(fused)] = str(e)
    torch.save(results, os.path.join(out_dir, f"gloo.{rank}.pt"))


def test_gloo_mesh_refuses_windows(corpus):
    root, argv = corpus
    out = str(root / "gloo")
    os.makedirs(out, exist_ok=True)
    launch(_gloo_rank, (argv, out), 2, "cpu")
    for rank in range(2):
        results = torch.load(os.path.join(out, f"gloo.{rank}.pt"))
        assert results["None"] is True
        assert "gloo" in results["True"]
