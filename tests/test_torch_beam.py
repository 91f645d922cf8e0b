"""The port's beam searches against the JAX package's.

A tiny model (d=16, 1+1 layers, 2 heads: tests/test_train_step.py's) with
perturbed JAX weights carried into the port, the test fixtures' lexicon
and an order-3 ARPA trained on a few sentences. Float32 on both sides.

- ``DeviceBeamSearcher.search`` against JAX ``DeviceBeamSearcher.search``
  at W = 16 over 6 seeds (weights and input): histories and words equal
  and winning scores within 1e-4 on all seeds but at most one; a seed that
  differs must come from a near tie (its two winners' scores within 1e-5).
- ``search_many`` equals ``search`` per utterance, and ``beam_scan``
  "early_exit" equals "static", under both ``decoder_pe`` modes (the
  reference_batch one adds pe[row mod W] per decode row).
- At k = 1 and k = 4 steps between reads of the device, "early_exit"
  equals "static" and JAX's search (as above); "static" reads nothing.
- The host ``BeamSearcher`` (float64 scores) against JAX ``BeamSearcher``.
- ``cast_params_for_serving``: at bfloat16 the cast-once weights give
  bitwise the logits of the per-use casts, and leave the model as it was.
"""

import dataclasses
import functools
import os
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from emg_tpu.config import DecodeConfig as JaxDecodeConfig
from emg_tpu.config import ModelConfig as JaxModelConfig
from emg_tpu.data.batching import PackedBatch as JaxPackedBatch
from emg_tpu.decode import ArpaLanguageModel as JaxArpaLanguageModel
from emg_tpu.decode import BeamSearcher as JaxBeamSearcher
from emg_tpu.decode import init_tree as jax_init_tree
from emg_tpu.decode.device_beam import DeviceBeamSearcher as JaxDeviceBeamSearcher
from emg_tpu.decode.device_lm import build_device_lm as jax_build_device_lm
from emg_tpu.models.model import EMGModel as JaxEMGModel

from emg_tpu_torch.config import DecodeConfig, ModelConfig
from emg_tpu_torch.data.batching import PackedBatch
from emg_tpu_torch.decode import ArpaLanguageModel, BeamSearcher, DeviceBeamSearcher, init_tree
from emg_tpu_torch.decode.device_lm import build_device_lm
from emg_tpu_torch.decode.greedy import encode_batch
from emg_tpu_torch.decode.lm_train import train_arpa, write_arpa
from emg_tpu_torch.models.model import EMGModel
from emg_tpu_torch.utils.convert import state_dict_from_flax
from emg_tpu_torch.utils.serving import cast_params_for_serving, serving_hot
from tests.test_torch_model import one_torch_thread, perturbed  # noqa: F401
from tests.test_train_step import toy_batch

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
TINY = dict(model_size=16, feed_forward_layer_size=32, num_layers_encoder=1,
            num_layers_decoder=1, n_heads_encoder=2, n_heads_decoder=2, relative_distance=8,
            dropout_model=0.0, dropout_pos_emb=0.0, compute_dtype="float32")
SENTS = ["the cat sat", "the dog ran", "the cat ran home", "a dog sat",
         "we go now", "the moon is cold"] * 2
MAX_FRAMES = 16
MAX_STEPS = 20  # toy targets hold 8 phones: max_len 8 + 12 extra steps


def as_port(pb: JaxPackedBatch) -> PackedBatch:
    return PackedBatch(**dataclasses.asdict(pb))


def batches(seeds):
    out = [toy_batch(B=1, n_rows=2, chunk=64, S=10, seed=s) for s in seeds]
    return out, [int((b.targets[0, 1:] != 40).sum()) for b in out]


@pytest.fixture(scope="module")
def lexicon_lm(tmp_path_factory):
    files = [os.path.join(FIXTURES, f) for f in ("phonesSet", "vocabulary", "lexicon.txt")]
    path = str(tmp_path_factory.mktemp("lm") / "lm.arpa")
    write_arpa(train_arpa(SENTS, order=3), path)
    port_tree, jax_tree = init_tree(*files).compile_tables(), jax_init_tree(*files).compile_tables()
    words = [port_tree.dictionary.lookup_word_by_index(i).name
             for i in range(port_tree.dictionary.word_count())]
    port_lm, jax_lm = ArpaLanguageModel(path), JaxArpaLanguageModel(path)
    return dict(port_tree=port_tree, jax_tree=jax_tree, port_lm=port_lm, jax_lm=jax_lm,
                port_dlm=build_device_lm(port_lm, words, device="cpu"),
                jax_dlm=jax_build_device_lm(jax_lm, words), words=set(words))


@functools.lru_cache(maxsize=None)
def jax_init(decoder_pe: str):
    jm = JaxEMGModel(JaxModelConfig(**dict(TINY, decoder_pe=decoder_pe)))
    b = toy_batch(B=1, n_rows=2, chunk=64, S=10, seed=0)
    v = jm.init({"params": jax.random.PRNGKey(0)}, b.packed_raw, b.n_rows, b.offsets,
                b.lengths, b.targets[:, :-1], MAX_FRAMES, False)
    return jm, {"params": v["params"], "batch_stats": v["batch_stats"]}


def make_models(seed, decoder_pe="per_position"):
    """The JAX tiny model with its initial weights perturbed by seeded
    noise, and the port's with the same weights."""
    jm, v = jax_init(decoder_pe)
    v = perturbed(v, np.random.default_rng(seed))
    geometry = dict(TINY, decoder_pe=decoder_pe)
    tm = EMGModel(ModelConfig(**geometry), device="cpu")
    tm.load_state_dict(state_dict_from_flax(v, 1, 1))
    return jm, v, tm.eval()


def test_device_beam_matches_jax(lexicon_lm):
    cfg = dict(BeamWidth=16, extra_steps=12)
    seeds = [11, 12, 13, 14, 15, 16]
    jax_dev, agree, finished = None, 0, 0
    for seed in seeds:
        jm, v, tm = make_models(seed)
        if jax_dev is None:
            jax_dev = JaxDeviceBeamSearcher(jm, v, lexicon_lm["jax_tree"], lexicon_lm["jax_dlm"],
                                            JaxDecodeConfig(**cfg), MAX_FRAMES,
                                            max_steps=MAX_STEPS)
        # the weights are an argument of the JAX search program: swapping
        # them reuses its compilation
        jax_dev.variables = v
        (b,), (L,) = batches([seed])
        jh, js, jw = jax_dev.search(b, L)
        th, ts, tw = DeviceBeamSearcher(
            tm, lexicon_lm["port_tree"], lexicon_lm["port_dlm"], DecodeConfig(**cfg),
            MAX_FRAMES, max_steps=MAX_STEPS).search(as_port(b), L)
        finished += bool(np.isfinite(js))
        if list(jh) == list(th) and jw == tw and ts == pytest.approx(js, abs=1e-4):
            agree += 1
        else:
            margin = abs(ts - js)
            print(f"seed {seed}: the searches differ; the two winners' scores differ by {margin}")
            assert margin < 1e-5, (seed, jw, tw, js, ts)
    assert finished >= 5, "the searches rarely finished; the test's setup is too tight"
    assert agree >= len(seeds) - 1


@pytest.fixture(scope="module")
def jax_beam(lexicon_lm):
    """The JAX device beam at W = 16; its weights are an argument of its
    search program, so swapping them reuses one compilation."""
    jm, v, _ = make_models(11)
    return JaxDeviceBeamSearcher(jm, v, lexicon_lm["jax_tree"], lexicon_lm["jax_dlm"],
                                 JaxDecodeConfig(BeamWidth=16, extra_steps=12), MAX_FRAMES,
                                 max_steps=MAX_STEPS)


@pytest.mark.parametrize("k", [1, 4])
def test_read_cadence_matches_static_and_jax(lexicon_lm, jax_beam, k):
    cfg = DecodeConfig(BeamWidth=16, extra_steps=12)
    seeds = [11, 13, 15]
    agree = 0
    for seed in seeds:
        jm, v, tm = make_models(seed)
        jax_beam.variables = v
        (b,), (L,) = batches([seed])
        early, static = (
            DeviceBeamSearcher(tm, lexicon_lm["port_tree"], lexicon_lm["port_dlm"], c, MAX_FRAMES,
                               max_steps=MAX_STEPS, read_every=k)
            for c in (cfg, dataclasses.replace(cfg, beam_scan="static")))
        eh, es, ew = early.search(as_port(b), L)
        sh, ss, sw = static.search(as_port(b), L)
        assert list(eh) == list(sh) and ew == sw
        assert es == pytest.approx(ss, abs=1e-5)
        # static runs ceil((S-1)/k) blocks and reads nothing; early exit
        # reads once a block
        assert static.runner.reads == 0 and static.runner.blocks == -(-MAX_STEPS // k)
        assert early.runner.reads == early.runner.blocks <= static.runner.blocks
        jh, js, jw = jax_beam.search(b, L)
        if list(jh) == list(eh) and jw == ew and es == pytest.approx(js, abs=1e-4):
            agree += 1
        else:
            print(f"seed {seed}: the searches differ; the two winners' scores differ by "
                  f"{abs(es - js)}")
            assert abs(es - js) < 1e-5, (seed, jw, ew, js, es)
    assert agree >= len(seeds) - 1


@pytest.fixture(scope="module", params=["per_position", "reference_batch"])
def port_model(request):
    return make_models(21, decoder_pe=request.param)[2]


def test_search_many_matches_search(lexicon_lm, port_model):
    dev = DeviceBeamSearcher(port_model, lexicon_lm["port_tree"], lexicon_lm["port_dlm"],
                             DecodeConfig(BeamWidth=8, extra_steps=6), MAX_FRAMES, max_steps=16)
    bs, lens = batches([31, 32, 33])
    lens[1] = 2  # a lane that stops long before the others
    bs = [as_port(b) for b in bs]
    singles = [dev.search(b, L) for b, L in zip(bs, lens)]
    many = dev.search_many(bs, lens)
    assert any(np.isfinite(s) for _, s, _ in singles)
    for (h1, s1, w1), (h2, s2, w2) in zip(singles, many):
        assert list(h1) == list(h2)
        assert w1 == w2
        assert s1 == pytest.approx(s2, abs=1e-5)


def test_early_exit_matches_static(lexicon_lm, port_model):
    cfg = DecodeConfig(BeamWidth=8, extra_steps=6, beam_scan="static")
    static = DeviceBeamSearcher(port_model, lexicon_lm["port_tree"], lexicon_lm["port_dlm"],
                                cfg, MAX_FRAMES, max_steps=16)
    early = DeviceBeamSearcher(port_model, lexicon_lm["port_tree"], lexicon_lm["port_dlm"],
                               dataclasses.replace(cfg, beam_scan="early_exit"), MAX_FRAMES,
                               max_steps=16)
    bs, lens = batches([61, 62, 63])
    lens[-1] = 2  # a short search exercises the early exit hard
    with mock.patch.object(static, "_step", wraps=static._step) as static_steps, \
            mock.patch.object(early, "_step", wraps=early._step) as early_steps:
        for b, L in zip(bs, lens):
            h1, s1, w1 = static.search(as_port(b), L)
            h2, s2, w2 = early.search(as_port(b), L)
            assert list(h1) == list(h2)
            assert w1 == w2
            assert s1 == pytest.approx(s2, abs=1e-5)
    # static runs every step to the cache's end; early exit stopped sooner
    assert static_steps.call_count == len(lens) * 16
    assert early_steps.call_count < static_steps.call_count
    many_static = static.search_many([as_port(b) for b in bs], lens)
    many_early = early.search_many([as_port(b) for b in bs], lens)
    for (h1, _, w1), (h2, _, w2) in zip(many_static, many_early):
        assert list(h1) == list(h2) and w1 == w2


def test_device_beam_emits_lexicon_words_bf16(lexicon_lm):
    tm = EMGModel(ModelConfig(**dict(TINY, compute_dtype="bfloat16")), device="cpu",
                  generator=torch.Generator().manual_seed(7)).eval()
    dev = DeviceBeamSearcher(tm, lexicon_lm["port_tree"], lexicon_lm["port_dlm"],
                             DecodeConfig(BeamWidth=16, extra_steps=12), MAX_FRAMES,
                             max_steps=MAX_STEPS)
    (b,), (L,) = batches([21])
    hist, score, words = dev.search(as_port(b), L)
    assert np.isfinite(score)
    assert all(w in lexicon_lm["words"] for w in words)
    assert hist[-1] == lexicon_lm["port_tree"].phone_count  # ends with </S>
    # the searcher decodes with its own cast copy; the caller's model is as it was
    assert dev.model is not tm and dev.model.w_raw_in.weight.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    # from the raw signal (n = 700: bucket 1280, F = 58 frames, cut to 16)
    raw = (120 * np.random.default_rng(3).normal(size=(700, 8))).astype(np.float32)
    hist, score, words = dev.search_from_raw(raw, L)
    assert np.isfinite(score)
    assert all(w in lexicon_lm["words"] for w in words)


def test_host_beam_matches_jax(lexicon_lm):
    cfg = dict(BeamWidth=8, extra_steps=6)
    agree, total = 0, 0
    for seed in (41, 42, 43):
        jm, v, tm = make_models(seed)
        (b,), (L,) = batches([seed])
        jh, js, jw = JaxBeamSearcher(jm, v, lexicon_lm["jax_tree"], lexicon_lm["jax_lm"],
                                     JaxDecodeConfig(**cfg), MAX_FRAMES).search(b, L)
        th, ts, tw = BeamSearcher(tm, lexicon_lm["port_tree"], lexicon_lm["port_lm"],
                                  DecodeConfig(**cfg), MAX_FRAMES).search(as_port(b), L)
        total += 1
        if list(jh) == list(th) and jw == tw and ts == pytest.approx(js, abs=1e-4):
            agree += 1
        else:
            print(f"seed {seed}: host beams differ; winners' scores differ by {abs(ts - js)}")
            assert abs(ts - js) < 1e-5, (seed, jw, tw, js, ts)
    assert agree >= total - 1


def test_serving_cast_is_bitwise():
    tm = EMGModel(ModelConfig(**dict(TINY, compute_dtype="bfloat16")), device="cpu",
                  generator=torch.Generator().manual_seed(3)).eval()
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    cast = cast_params_for_serving(tm)
    assert cast is not tm and cast_params_for_serving(cast) is cast
    hot = [n for n, _ in tm.named_parameters() if serving_hot(n)]
    assert any("w_q" in n for n in hot) and any("conv1" in n for n in hot)
    assert any("w_raw_in" in n for n in hot) and any("linear2" in n for n in hot)
    assert not any(n.startswith(("w_out", "w_aux", "embedding_tgt")) or ".norm" in n for n in hot)
    cast_params = dict(cast.named_parameters())
    for name, p in tm.named_parameters():
        assert cast_params[name].dtype == (torch.bfloat16 if name in hot else torch.float32)
        if name not in hot:
            assert cast_params[name] is p  # shared, not copied
    # the caller's model is unchanged
    for k, v in tm.state_dict().items():
        assert v.dtype == before[k].dtype and torch.equal(v, before[k])

    (b,), _ = batches([5])
    with torch.inference_mode():
        outs = []
        for model in (tm, cast):
            memory, enc_logits, mask = encode_batch(model, as_port(b), MAX_FRAMES)
            kvs = model.project_cross_kvs(memory)
            caches = model.init_decode_cache(3, 6)
            tokens = torch.full((3, 6), 42, dtype=torch.int64)
            tokens[:, 0] = 41
            tokens[:, 1] = torch.tensor([3, 7, 40])
            steps = [model.decode_step(tokens[:, s], s, caches, kvs, tokens, mask) for s in range(2)]
            outs.append((memory, enc_logits, *steps, caches[0]))
    for a, b_ in zip(*outs):
        assert torch.equal(a, b_)
