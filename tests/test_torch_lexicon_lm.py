"""The port's lexicon, prefix tree and host language models against the JAX
package's.

- ``compile_tables()`` gives arrays equal to the JAX package's, on the test
  fixtures' lexicon and on the synthetic corpus's.
- ``train_arpa``/``write_arpa`` and ``write_fixture_arpa`` write the same
  text for the same sentences; ``ArpaLanguageModel.score`` is equal to the
  JAX package's (float64, exactly); the native scorer, compiled under
  ``build/``, agrees with the Python reader within 1e-6.
- The KenLM binary writer gives a byte-identical file, and its reader
  scores equal the ARPA's within 1e-4 (as tests/test_kenlm_binary.py).
"""

import os

import numpy as np
import pytest

from emg_tpu.data.fixtures import make_synthetic_corpus
from emg_tpu.decode import kenlm_binary as jax_kenlm
from emg_tpu.decode import lm_train as jax_lm_train
from emg_tpu.decode import ngram as jax_ngram
from emg_tpu.decode.prefix_tree import init_tree as jax_init_tree

from emg_tpu_torch.decode import kenlm_binary, lm_train, ngram
from emg_tpu_torch.decode.lm_binding import NativeArpaLanguageModel
from emg_tpu_torch.decode.prefix_tree import init_tree
from emg_tpu_torch.text.lexicon import load_pronunciation_dict

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
SENTS = [
    "the cat sat on the mat",
    "the dog ran home",
    "a cat ran to the dog",
    "we go home now",
    "the moon is cold and far",
    "a dog sat by the door",
    "we saw the cat by the moon",
    "the door is far from home",
]


def random_sentences(rng, n=40):
    """Sentences over the training words, with out-of-vocabulary words."""
    words = sorted({w for s in SENTS for w in s.split()}) + ["zebra", "quark"]
    return [" ".join(rng.choice(words, size=int(rng.integers(0, 9))).tolist()) for _ in range(n)]


@pytest.fixture(scope="module")
def description_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    paths = make_synthetic_corpus(str(root), n_sentences=4, seed=0)
    return {
        "fixtures": tuple(os.path.join(FIXTURES, f) for f in ("phonesSet", "vocabulary", "lexicon.txt")),
        "synthetic": (paths["phonesSet"], paths["vocabulary"], paths["dict"]),
    }


@pytest.mark.parametrize("which", ["fixtures", "synthetic"])
def test_compile_tables_equal_jax(description_files, which):
    files = description_files[which]
    got, ref = init_tree(*files).compile_tables(), jax_init_tree(*files).compile_tables()
    np.testing.assert_array_equal(got.child_table, ref.child_table)
    np.testing.assert_array_equal(got.mask_table, ref.mask_table)
    assert got.child_table.dtype == ref.child_table.dtype
    assert got.mask_table.dtype == ref.mask_table.dtype
    assert got.node_words == ref.node_words
    assert (got.root, got.phone_count) == (ref.root, ref.phone_count)
    assert got.mask_table.shape[1] == 41
    # </S> (column 40) is valid at the root only
    assert np.isfinite(got.mask_table[:, 40]).sum() == 1 and got.mask_table[got.root, 40] == 0.0
    nodes = np.arange(got.child_table.shape[0])
    phones = np.arange(nodes.size) % 41
    np.testing.assert_array_equal(got.step(nodes, phones), ref.step(nodes, phones))


def test_dictionary_lookups(description_files):
    dct = load_pronunciation_dict(*description_files["fixtures"])
    assert dct.phone_count() == 40
    word = dct.lookup_word_by_name("CAT")
    assert [p.name for p in dct.lookup_prons(word)[0]] == ["K", "AE", "T"]
    assert dct.lookup_word_by_index(word.idx) is word


@pytest.mark.parametrize("order", [2, 3, 4])
def test_train_arpa_text_equals_jax(tmp_path, order):
    got, ref = tmp_path / "port.arpa", tmp_path / "jax.arpa"
    lm_train.write_arpa(lm_train.train_arpa(SENTS, order=order), str(got))
    jax_lm_train.write_arpa(jax_lm_train.train_arpa(SENTS, order=order), str(ref))
    assert got.read_text() == ref.read_text()
    # the file-level entry point too
    corpus = tmp_path / "corpus.txt"
    corpus.write_text("\n".join(SENTS) + "\n")
    lm_train.train_lm_file(str(corpus), str(tmp_path / "file.arpa"), order)
    assert (tmp_path / "file.arpa").read_text() == ref.read_text()


def test_fixture_arpa_text_equals_jax(tmp_path):
    ngram.write_fixture_arpa(str(tmp_path / "port.arpa"), SENTS)
    jax_ngram.write_fixture_arpa(str(tmp_path / "jax.arpa"), SENTS)
    assert (tmp_path / "port.arpa").read_text() == (tmp_path / "jax.arpa").read_text()


@pytest.fixture(scope="module")
def arpa_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("lm") / "lm.arpa")
    lm_train.write_arpa(lm_train.train_arpa(SENTS, order=3), path)
    return path


@pytest.mark.parametrize("bos,eos", [(True, True), (True, False), (False, True)])
def test_arpa_scores_equal_jax(arpa_path, bos, eos):
    port, ref = ngram.ArpaLanguageModel(arpa_path), jax_ngram.ArpaLanguageModel(arpa_path)
    assert port.ngrams == ref.ngrams
    for s in random_sentences(np.random.default_rng(1)):
        assert port.score(s, bos=bos, eos=eos) == ref.score(s, bos=bos, eos=eos), s


def test_native_scorer_matches_python(arpa_path):
    native = NativeArpaLanguageModel(arpa_path)
    py = ngram.ArpaLanguageModel(arpa_path)
    assert native.order == py.order == 3
    for s in random_sentences(np.random.default_rng(2)):
        for bos, eos in ((True, True), (True, False)):
            assert native.score(s, bos, eos) == pytest.approx(py.score(s, bos, eos), abs=1e-6), s
    assert isinstance(ngram.load_language_model(arpa_path), NativeArpaLanguageModel)


def test_load_language_model_warns_on_fallback(arpa_path, monkeypatch, caplog):
    """Without the native scorer, the ARPA loads through the Python reader,
    and the fallback is logged, not silent."""
    from emg_tpu_torch.decode import lm_binding

    def no_compiler():
        raise FileNotFoundError("g++")
    monkeypatch.setattr(lm_binding, "_lib", None)
    monkeypatch.setattr(lm_binding, "build_library", no_compiler)
    with caplog.at_level("WARNING"):
        lm = ngram.load_language_model(arpa_path)
    assert isinstance(lm, ngram.ArpaLanguageModel)
    assert "pure-Python reader" in caplog.text


def test_kenlm_binary_bytes_equal_jax(arpa_path, tmp_path):
    got, ref = tmp_path / "port.binary", tmp_path / "jax.binary"
    kenlm_binary.write_kenlm_binary(arpa_path, str(got))
    jax_kenlm.write_kenlm_binary(arpa_path, str(ref))
    assert got.read_bytes() == ref.read_bytes()
    assert kenlm_binary.is_kenlm_binary(str(got)) and not kenlm_binary.is_kenlm_binary(arpa_path)
    for data in (b"", b"the", b"a longer string of words"):
        assert kenlm_binary.murmur_hash64a(data) == jax_kenlm.murmur_hash64a(data)

    model = ngram.load_language_model(str(got))
    assert isinstance(model, kenlm_binary.KenlmBinaryModel)
    py = ngram.ArpaLanguageModel(arpa_path)
    for s in random_sentences(np.random.default_rng(3)):
        assert model.score(s, True, True) == pytest.approx(py.score(s, True, True), abs=1e-4), s
