"""The port's training recipes against the JAX package's.

- ``RECIPES`` equals the JAX table; ``apply_recipe`` sets the same fields
  and names the options for an unknown recipe.
- Each raw-EMG augmentation is bitwise equal to JAX's ``_augment_batch``,
  given the draws JAX made. The test derives those by replaying the JAX
  step's key schedule: ``fold_in(rng, microbatches)`` -> ``split(., 4)``
  -> ``split(aug_rng, 6)`` (``emg_tpu/parallel/train_step.py:76-92,
  179-182``).
- Full train steps of ``Parallel_Schedule_Sampling`` (ramp cut to 1, so
  the mix is live from the second microbatch) and of the two augmentation
  recipes against JAX at dropout 0, the port handed JAX's draws: losses to
  rtol 1e-5, parameters to 1e-5 of each tensor's largest magnitude. Under
  scheduled sampling the decoder inputs of the train pass are integer-equal
  to JAX's, on first-pass logits whose top-two margin exceeds 1e-4.
- With every knob at 0 the recipe draws take nothing from the generator;
  each knob, when on, does.
- Through the CLI: ``--recipe`` overrides an explicit flag it sets, an
  unknown name raises ``KeyError``, and ``--recipe conformer_model``
  trains a tiny conformer on the CPU and greedy-evaluates its model.pt.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import emg_tpu.parallel.train_step as jax_step_module
import emg_tpu_torch.parallel.train_step as port_step_module
from emg_tpu.config import Config as JaxConfig
from emg_tpu.config import TrainConfig as JaxTrainConfig
from emg_tpu.parallel.train_step import _augment_batch
from emg_tpu.train.recipes import RECIPES as JAX_RECIPES
from emg_tpu.train.recipes import apply_recipe as jax_apply_recipe
from tests.test_torch_conformer import steps_against_jax
from tests.test_torch_model import one_torch_thread  # noqa: F401
from tests.test_torch_train_step import shift_spy  # noqa: F401
from tests.test_torch_trainer import TRAIN, corpus, run_dir  # noqa: F401
from tests.test_train_step import toy_batch

from emg_tpu_torch import cli
from emg_tpu_torch.config import Config, TrainConfig
from emg_tpu_torch.parallel.train_step import (
    RecipeDraws,
    augment_packed,
    draw_recipe_randomness,
    time_drop_span,
)
from emg_tpu_torch.train.recipes import RECIPES, apply_recipe

TINY_MODEL = dict(model_size=16, feed_forward_layer_size=32, num_layers_encoder=1,
                  num_layers_decoder=1, n_heads_encoder=2, n_heads_decoder=2,
                  relative_distance=8, dropout_model=0.0, dropout_pos_emb=0.0)
KNOBS = ("electrode_rotation_prob", "channel_drop_prob", "time_drop_prob",
         "scheduled_sampling_max_prob")


def test_recipes_equal_jax():
    assert RECIPES == JAX_RECIPES
    for name in RECIPES:
        ours, ref = apply_recipe(Config(), name), jax_apply_recipe(JaxConfig(), name)
        for section in ("model", "train"):
            assert (dataclasses.asdict(getattr(ours, section))
                    == dataclasses.asdict(getattr(ref, section))), (name, section)
    with pytest.raises(KeyError, match="options: .*conformer_model"):
        apply_recipe(Config(), "nope")


def jax_draws(cfg, rng, microbatches: int, batch) -> RecipeDraws:
    """The draws the JAX step made at ``microbatches``, as the port's
    ``RecipeDraws``."""
    step_rng = jax.random.fold_in(rng, microbatches)
    _, _, aug_rng, ss_rng = jax.random.split(step_rng, 4)
    r_rot, r_dir, r_chan, r_time, r_pos, r_len = jax.random.split(aug_rng, 6)
    N, L, C = batch.packed_raw.shape
    draws = RecipeDraws()
    if cfg.electrode_rotation_prob > 0:
        do = jax.random.bernoulli(r_rot, cfg.electrode_rotation_prob)
        shift = jnp.where(jax.random.bernoulli(r_dir, 0.5), 1, -1)
        draws.rotation_shift = torch.tensor(int(jnp.where(do, shift, 0)))
    if cfg.channel_drop_prob > 0:
        keep = ~jax.random.bernoulli(r_chan, cfg.channel_drop_prob, (C,))
        draws.channel_keep = torch.tensor(np.asarray(keep))
    if cfg.time_drop_prob > 0:
        do = jax.random.bernoulli(r_time, cfg.time_drop_prob)
        start = jax.random.randint(r_pos, (), 0, N * L)
        length = jax.random.randint(r_len, (), 1, cfg.time_drop_max_samples + 1)
        draws.time_drop = time_drop_span(N * L, torch.tensor(int(start)),
                                         torch.tensor(int(length)), torch.tensor(bool(do)))
    if cfg.scheduled_sampling_max_prob > 0:
        prob = cfg.scheduled_sampling_max_prob * jnp.minimum(
            1.0, jnp.float32(microbatches) / max(cfg.scheduled_sampling_ramp, 1))
        B, S1 = batch.targets.shape[0], batch.targets.shape[1] - 1
        mix = jax.random.bernoulli(ss_rng, prob, (B, S1)) & (jnp.arange(S1)[None, :] >= 1)
        draws.ss_mix = torch.tensor(np.asarray(mix))
    return draws


@pytest.mark.parametrize("knobs", [
    dict(electrode_rotation_prob=1.0),
    dict(electrode_rotation_prob=0.5),
    dict(channel_drop_prob=0.5),
    dict(time_drop_prob=1.0, time_drop_max_samples=90),
    dict(electrode_rotation_prob=0.7, channel_drop_prob=0.3, time_drop_prob=0.7),
], ids=["rotation", "rotation_half", "channel_drop", "time_drop", "all"])
def test_augmentations_bitwise_equal_jax(knobs):
    cfg = TrainConfig(**knobs)
    jcfg = JaxTrainConfig(**knobs)
    rng = jax.random.PRNGKey(7)
    for mb in range(4):
        batch = toy_batch(B=2, n_rows=3, chunk=64, S=8, seed=mb)
        batch.packed_raw[1, 10:20] = -batch.packed_raw[1, 10:20]  # signed zeros stay signed
        _, _, aug_rng, _ = jax.random.split(jax.random.fold_in(rng, mb), 4)
        ref = np.asarray(_augment_batch(batch, jcfg, aug_rng).packed_raw)
        got = augment_packed(torch.tensor(batch.packed_raw), jax_draws(cfg, rng, mb, batch))
        np.testing.assert_array_equal(got.numpy().view(np.uint32), ref.view(np.uint32))


def test_draws_only_for_knobs_that_are_on():
    """With every knob at 0 nothing is drawn, so the generator's sequence
    (time shift, dropout) is the one without recipes; each knob on draws."""
    g = torch.Generator().manual_seed(3)
    before = g.get_state()
    draws = draw_recipe_randomness(g, TrainConfig(), (2, 64, 8), 7, 2, 0.0)
    assert torch.equal(g.get_state(), before) and draws == RecipeDraws()
    for knob in KNOBS:
        g.set_state(before)
        draws = draw_recipe_randomness(g, TrainConfig(**{knob: 0.5}), (2, 64, 8), 7, 2, 0.5)
        assert not torch.equal(g.get_state(), before), knob
        assert sum(getattr(draws, f.name) is not None for f in dataclasses.fields(draws)) == 1
    g.set_state(before)
    draws = draw_recipe_randomness(g, TrainConfig(scheduled_sampling_max_prob=0.5),
                                   (2, 64, 8), 7, 2, 1.0)
    assert draws.ss_mix.shape == (2, 7) and not draws.ss_mix[:, 0].any() and draws.ss_mix[:, 1:].all()


RECIPE_STEPS = {
    "Parallel_Schedule_Sampling": dict(scheduled_sampling_ramp=1),
    "augmentation_with_electrode_rotation": {},
    "augmentation_channel_time_drop": {},
}


@pytest.mark.parametrize("recipe", list(RECIPE_STEPS))
def test_recipe_train_steps_match_jax(recipe, shift_spy, monkeypatch):  # noqa: F811
    train = dict(batch_size_grad=4, learning_rate=1e-3, learning_rate_warmup=10)
    train.update({k.split(".", 1)[1]: v for k, v in RECIPES[recipe].items()})
    train.update(RECIPE_STEPS[recipe])
    cfg = TrainConfig(**train)
    batches = [toy_batch(seed=s) for s in range(4)]
    used, jax_inputs, port_inputs, margins = [], [], [], []

    def hand_draws(mp, rng, mb, batch):
        draws = jax_draws(cfg, rng, mb, batch)
        used.append(draws)
        mp.setattr(port_step_module, "draw_recipe_randomness", lambda *a, **k: draws)

    real_jax_losses = jax_step_module.compute_losses

    def jax_spy(model, params, batch_stats, batch, max_frames, rngs=None, train=False,
                tgt_in=None):
        if train and tgt_in is not None:
            jax.debug.callback(lambda t: jax_inputs.append(np.asarray(t)), tgt_in)
        return real_jax_losses(model, params, batch_stats, batch, max_frames, rngs, train, tgt_in)

    real_port_losses = port_step_module.compute_losses
    real_ss = port_step_module.scheduled_sampling_inputs

    def port_spy(model, batch, max_frames, generator=None, tgt_in=None):
        if tgt_in is not None:
            port_inputs.append(tgt_in.numpy())
        return real_port_losses(model, batch, max_frames, generator, tgt_in)

    def ss_spy(model, batch, max_frames, mix):
        # the first pass's logits, again, for their top-two margins at the
        # positions whose argmax becomes an input
        model.eval()
        with torch.no_grad():
            _, logits = model(batch["packed_raw"], batch["n_rows"], batch["offsets"],
                              batch["lengths"], batch["targets"][:, :-1], max_frames)
        model.train()
        top2 = logits[:, :-1].topk(2, dim=-1).values
        margins.append(float((top2[..., 0] - top2[..., 1]).min()))
        return real_ss(model, batch, max_frames, mix)

    monkeypatch.setattr(jax_step_module, "compute_losses", jax_spy)
    monkeypatch.setattr(port_step_module, "compute_losses", port_spy)
    monkeypatch.setattr(port_step_module, "scheduled_sampling_inputs", ss_spy)
    steps_against_jax(TINY_MODEL, train, batches, shift_spy, monkeypatch, rng_key=0,
                      patch_step=hand_draws)
    if recipe == "Parallel_Schedule_Sampling":
        assert len(port_inputs) == len(jax_inputs) == len(batches)
        assert min(margins) > 1e-4, margins
        for got, ref in zip(port_inputs, jax_inputs):
            np.testing.assert_array_equal(got, ref)
        # the mix took predictions somewhere, and they were not the teacher's
        teacher = [b.targets[:, :-1] for b in batches]
        assert any(d.ss_mix.any() for d in used)
        assert any((got != t).any() for got, t in zip(port_inputs, teacher))
    else:
        assert not port_inputs and not margins
        # every augmentation the recipe turns on acted at least once
        acted = {
            "rotation": any(int(d.rotation_shift) != 0 for d in used
                            if d.rotation_shift is not None),
            "channel": any(not bool(d.channel_keep.all()) for d in used
                           if d.channel_keep is not None),
            "time": any(bool(d.time_drop.any()) for d in used if d.time_drop is not None),
        }
        on = {"rotation": cfg.electrode_rotation_prob, "channel": cfg.channel_drop_prob,
              "time": cfg.time_drop_prob}
        assert all(acted[k] for k, p in on.items() if p > 0), acted


def test_cli_recipe_overrides_flags(tmp_path, monkeypatch):
    seen = []
    monkeypatch.setattr(cli, "train", lambda cfg, device="cuda": seen.append(cfg))
    monkeypatch.setattr(cli, "evaluate_saved_greedy_search",
                        lambda cfg, device="cuda": seen.append(cfg))
    out = ["--output_directory", str(tmp_path)]
    cli.main(out + ["--encoder_kind", "transformer", "--recipe", "conformer_model",
                    "--device", "cpu"])
    cli.main(out + ["--recipe=Parallel_Schedule_Sampling", "--scheduled_sampling_max_prob", "0.9"])
    cli.main(out + ["--evaluate_saved_greedy_search", "model.pt", "--recipe", "conformer_model"])
    assert [c.model.encoder_kind for c in seen] == ["conformer", "transformer", "conformer"]
    assert seen[1].train.scheduled_sampling_max_prob == 0.3
    with pytest.raises(KeyError, match="unknown recipe 'nope'"):
        cli.main(out + ["--recipe", "nope"])


def test_cli_help_lists_recipes(capsys):
    cli.main(["--help"])
    out = capsys.readouterr().out
    assert "--recipe {" in out and all(name in out for name in RECIPES)


def test_cli_conformer_recipe_trains_and_serves(corpus):  # noqa: F811
    root, argv = corpus
    trainer = cli.main(argv + TRAIN + run_dir(root, "conformer") + [
        "--n_epochs", "1", "--device", "cpu", "--recipe", "conformer_model",
        "--conformer_conv_kernel_size", "5"])
    assert trainer.config.model.encoder_kind == "conformer"
    assert type(trainer_model(trainer)).__name__ == "ConformerEncoder"
    assert trainer.train_losses and np.all(np.isfinite(trainer.train_losses))
    model_pt = root / "conformer" / "model.pt"
    assert model_pt.exists()
    per, acc = cli.main(argv + run_dir(root, "conformer_eval") + [
        "--device", "cpu", "--recipe", "conformer_model", "--conformer_conv_kernel_size", "5",
        "--evaluate_saved_greedy_search", str(model_pt)])
    assert 0.0 <= per < float("inf") and 0.0 <= acc <= 100.0
    assert os.path.exists(root / "conformer_eval" / "log_greedy_search.txt")


def trainer_model(trainer):
    state = trainer.ckpt.restore(trainer.init_state(), "latest")[0]
    return state.model.transformerEncoder
