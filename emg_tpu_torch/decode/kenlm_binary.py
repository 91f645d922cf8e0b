"""KenLM *binary* language-model format: reader + writer (PROBING layout).

The reference points its ``lang_model`` flag at ``descriptions/lm.binary``
(reference recognition_model.py:35) and scores it through ``kenlm.Model``
(reference PrefixTree.py:288-290).  This module makes that artifact
consumable without the kenlm package: ``KenlmBinaryModel`` memory-loads a
KenLM PROBING-format binary and exposes the same ``score(sentence, bos,
eos)`` contract (sum of conditional log10 probabilities, Katz backoff) as
``ngram.ArpaLanguageModel`` — the two are interchangeable for the host beam
search.

Format (reconstructed from the public kenlm sources — lm/binary_format.cc,
lm/vocab.cc, lm/search_hashed.{hh,cc}, util/probing_hash_table.hh,
util/murmur_hash.cc; all little-endian, 64-bit build):

  Sanity header (88 bytes)
    0   char[56]  magic "mmap lm http://kheafield.com/code format version 5\\n\\0"
                  (53 bytes, zero-padded to ALIGN8 = 56)
    56  f32 x3    0.0, 1.0, -0.5          (endianness / float sanity probes)
    68  u32 x3    1, 0xFFFFFFFF, 0        (WordIndex sanity + struct pad)
    80  u64       1
  FixedWidthParameters (20 bytes, offset 88)
    88  u8 order            (+3 pad)
    92  f32 probing_multiplier
    96  u32 model_type      (0=PROBING, 1=REST_PROBING, 2..5 = trie family)
    100 u8  has_vocabulary  (+3 pad)
    104 u32 search_version  (0 for the probing search)
  counts: u64[order] at offset 108; header total = ALIGN8(108 + 8*order)
  ProbingVocabulary
    u64 bound (number of words incl. <unk>), padded to 8
    hash table: buckets(counts[0]) entries of {u64 murmur64a(word); u32 id}
    (12 bytes each, #pragma pack(4); empty key = 0; <unk> is NOT inserted —
    id 0 is the lookup miss value)
  HashedSearch
    unigram:  (counts[0]+1) x {f32 prob; f32 backoff}, indexed by word id
    orders 2..order-1: buckets(counts[n-1]) x {u64 key; f32 prob; f32 backoff}
    order N:           buckets(counts[N-1]) x {u64 key; f32 prob}
    n-gram key = chain CombineWordHash starting from u64(id of first word)
  vocab strings (if has_vocabulary): words in id order, NUL-terminated

``write_kenlm_binary`` emits the same layout from a parsed ARPA model —
kenlm's ``build_binary`` equivalent — which gives the round-trip fixture
test its binary and doubles as an offline ARPA -> binary converter.

Caveats, stated rather than hidden: REST_PROBING and the trie family store
different payloads and are rejected with an explanatory error (convert with
kenlm's own ``build_binary probing`` once, offline); SRILM-pruned models can
contain "blank" middle entries (prob == -inf placeholders kenlm inserts for
missing prefixes) — lookups treat those as absent, which matches kenlm's
scoring on such models for the backoff cases a complete ARPA never hits.

A copy of ``emg_tpu/decode/kenlm_binary.py``; its writer's files are
byte-identical to the JAX package's.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Sequence, Tuple, Union

import numpy as np

from emg_tpu_torch.decode.ngram import ArpaLanguageModel, BOS, EOS, UNK

MAGIC = b"mmap lm http://kheafield.com/code format version 5\n\x00"
MAGIC_PREFIX = b"mmap lm http://kheafield.com/code format version"
_M64 = 0xC6A4A7935BD1E995
_MASK = (1 << 64) - 1

MODEL_PROBING = 0
MODEL_NAMES = {
    0: "PROBING", 1: "REST_PROBING", 2: "TRIE", 3: "QUANT_TRIE",
    4: "ARRAY_TRIE", 5: "QUANT_ARRAY_TRIE",
}


def _align8(n: int) -> int:
    return (n + 7) & ~7


def murmur_hash64a(data: bytes, seed: int = 0) -> int:
    """util::MurmurHash64A — kenlm's vocabulary string hash (seed 0)."""
    r = 47
    h = (seed ^ ((len(data) * _M64) & _MASK)) & _MASK
    n8 = len(data) & ~7
    for i in range(0, n8, 8):
        (k,) = struct.unpack_from("<Q", data, i)
        k = (k * _M64) & _MASK
        k ^= k >> r
        k = (k * _M64) & _MASK
        h ^= k
        h = (h * _M64) & _MASK
    tail = data[n8:]
    if tail:
        k = 0
        for i, b in enumerate(tail):
            k |= b << (8 * i)
        h ^= k
        h = (h * _M64) & _MASK
    h ^= h >> r
    h = (h * _M64) & _MASK
    h ^= h >> r
    return h


def combine_word_hash(current: int, word_id: int) -> int:
    """lm::detail::CombineWordHash — extends an n-gram key by one word."""
    return (((current * 8978948897894561157) & _MASK)
            ^ (((1 + word_id) * 17894857484156487943) & _MASK))


def ngram_key(ids: Sequence[int]) -> int:
    """Probing-search key of an n-gram (ids in left-to-right ARPA order)."""
    key = ids[0]
    for w in ids[1:]:
        key = combine_word_hash(key, w)
    return key


def _buckets(entries: int, multiplier: float) -> int:
    # util::ProbingHashTable::Size — the cast chain is float32 on purpose
    return max(entries + 1,
               int(np.float32(multiplier) * np.float32(entries)))


def _table_insert(keys: np.ndarray, ideal: np.ndarray, slots_keys, put):
    """Linear-probing insert of pre-hashed entries (writer side)."""
    buckets = len(slots_keys)
    for j in range(len(keys)):
        i = int(ideal[j])
        while slots_keys[i] != 0:
            i += 1
            if i == buckets:
                i = 0
        slots_keys[i] = keys[j]
        put(i, j)


# ---------------------------------------------------------------------------
# writer (kenlm build_binary equivalent, PROBING layout)
# ---------------------------------------------------------------------------

def write_kenlm_binary(
    arpa: Union[str, ArpaLanguageModel],
    out_path: str,
    probing_multiplier: float = 1.5,
    include_vocab_strings: bool = True,
) -> None:
    lm = arpa if isinstance(arpa, ArpaLanguageModel) else ArpaLanguageModel(arpa)
    order = lm.order
    counts = [len(lm.ngrams[n]) for n in range(1, order + 1)]

    # vocab ids in ARPA unigram order; <unk> pinned to 0 (lm/vocab.cc)
    word_id: Dict[str, int] = {UNK: 0}
    id_word: List[str] = [UNK]
    for (w,) in lm.ngrams[1]:
        if w == UNK:
            continue
        word_id[w] = len(id_word)
        id_word.append(w)

    out = bytearray()
    # Sanity
    out += MAGIC.ljust(56, b"\x00")
    out += struct.pack("<fff", 0.0, 1.0, -0.5)
    out += struct.pack("<III", 1, 0xFFFFFFFF, 0)
    out += struct.pack("<Q", 1)
    # FixedWidthParameters
    out += struct.pack("<B3x", order)
    out += struct.pack("<f", probing_multiplier)
    out += struct.pack("<I", MODEL_PROBING)
    out += struct.pack("<B3x", 1 if include_vocab_strings else 0)
    out += struct.pack("<I", 0)  # probing search version
    for c in counts:
        out += struct.pack("<Q", c)
    out += b"\x00" * (_align8(len(out)) - len(out))

    # ProbingVocabulary: bound header + hash table (<unk> not inserted)
    out += struct.pack("<Q", len(id_word))
    vb = _buckets(counts[0], probing_multiplier)
    vkeys = np.zeros(vb, np.uint64)
    vvals = np.zeros(vb, np.uint32)
    ins_words = id_word[1:]
    hashes = np.array([murmur_hash64a(w.encode()) for w in ins_words], np.uint64)
    ideal = (hashes % np.uint64(vb)).astype(np.int64)

    def put_vocab(slot, j):
        vvals[slot] = j + 1  # ids were assigned in this same order

    _table_insert(hashes, ideal, vkeys, put_vocab)
    vtab = np.zeros(vb, dtype=[("k", "<u8"), ("v", "<u4")])
    vtab["k"], vtab["v"] = vkeys, vvals
    out += vtab.tobytes()

    # unigram array, indexed by id; +1 trailing sentinel slot. counts[0]
    # exceeds len(id_word)-1 only if <unk> was absent from the ARPA — then
    # the id space is still counts[0]+1 with a hallucinated <unk> at 0
    uni = np.zeros((counts[0] + 1, 2), np.float32)
    uni[0, 0] = -99.0  # kenlm's default <unk> prob when absent
    for (w,), (p, b) in lm.ngrams[1].items():
        i = word_id[w]
        uni[i, 0], uni[i, 1] = p, b
    out += uni.astype("<f4").tobytes()

    # middle orders: {u64 key; f32 prob; f32 backoff}
    for n in range(2, order):
        grams = lm.ngrams[n]
        nb = _buckets(counts[n - 1], probing_multiplier)
        tkeys = np.zeros(nb, np.uint64)
        tprob = np.zeros(nb, np.float32)
        tbo = np.zeros(nb, np.float32)
        items = list(grams.items())
        keys = np.array(
            [ngram_key([word_id.get(w, 0) for w in ws]) for ws, _ in items],
            np.uint64,
        )
        ideal = (keys % np.uint64(nb)).astype(np.int64)

        def put_mid(slot, j, items=items, tprob=tprob, tbo=tbo):
            tprob[slot], tbo[slot] = items[j][1]

        _table_insert(keys, ideal, tkeys, put_mid)
        tab = np.zeros(nb, dtype=[("k", "<u8"), ("p", "<f4"), ("b", "<f4")])
        tab["k"], tab["p"], tab["b"] = tkeys, tprob, tbo
        out += tab.tobytes()

    # longest order: {u64 key; f32 prob}, 12-byte packed entries
    if order >= 2:
        grams = lm.ngrams[order]
        nb = _buckets(counts[order - 1], probing_multiplier)
        tkeys = np.zeros(nb, np.uint64)
        tprob = np.zeros(nb, np.float32)
        items = list(grams.items())
        keys = np.array(
            [ngram_key([word_id.get(w, 0) for w in ws]) for ws, _ in items],
            np.uint64,
        )
        ideal = (keys % np.uint64(nb)).astype(np.int64)

        def put_long(slot, j, items=items, tprob=tprob):
            tprob[slot] = items[j][1][0]

        _table_insert(keys, ideal, tkeys, put_long)
        tab = np.zeros(nb, dtype=[("k", "<u8"), ("p", "<f4")])
        tab["k"], tab["p"] = tkeys, tprob
        out += tab.tobytes()

    if include_vocab_strings:
        for w in id_word:
            out += w.encode() + b"\x00"

    with open(out_path, "wb") as f:
        f.write(bytes(out))


# ---------------------------------------------------------------------------
# reader
# ---------------------------------------------------------------------------

class KenlmBinaryModel:
    """Scores sentences from a KenLM PROBING binary; ArpaLanguageModel API."""

    def __init__(self, path: str):
        with open(path, "rb") as f:
            buf = f.read()
        if not buf.startswith(MAGIC_PREFIX):
            raise IOError(f"not a KenLM binary file: {path}")
        if not buf.startswith(MAGIC):
            head = buf[: len(MAGIC)].split(b"\n")[0]
            raise IOError(
                f"unsupported KenLM binary version ({head!r}); this reader "
                "implements format version 5"
            )
        (order,) = struct.unpack_from("<B", buf, 88)
        (multiplier,) = struct.unpack_from("<f", buf, 92)
        (model_type,) = struct.unpack_from("<I", buf, 96)
        (has_vocab,) = struct.unpack_from("<B", buf, 100)
        (search_version,) = struct.unpack_from("<I", buf, 104)
        if model_type != MODEL_PROBING:
            raise IOError(
                f"KenLM model type {MODEL_NAMES.get(model_type, model_type)} "
                "is not supported; rebuild the LM with kenlm's "
                "`build_binary probing` (or pass the ARPA text file)"
            )
        if search_version != 0:
            raise IOError(
                f"unsupported probing search version {search_version}"
            )
        counts = list(
            struct.unpack_from(f"<{order}Q", buf, 108)
        )
        self.order = order
        off = _align8(108 + 8 * order)

        # vocabulary
        (bound,) = struct.unpack_from("<Q", buf, off)
        bound &= 0xFFFFFFFF  # kenlm stores a WordIndex; mask struct padding
        off += 8
        vb = _buckets(counts[0], multiplier)
        vtab = np.frombuffer(buf, dtype=[("k", "<u8"), ("v", "<u4")],
                             count=vb, offset=off)
        off += vb * 12
        self._vocab: Dict[int, int] = {
            int(k): int(v) for k, v in zip(vtab["k"], vtab["v"]) if k != 0
        }

        # unigrams
        uni = np.frombuffer(buf, dtype="<f4", count=2 * (counts[0] + 1),
                            offset=off).reshape(-1, 2)
        off += 8 * (counts[0] + 1)
        self._unigram = np.array(uni, np.float64)

        # middle + longest tables -> python dicts keyed by the 64-bit key
        self._middle: List[Dict[int, Tuple[float, float]]] = []
        for n in range(2, order):
            nb = _buckets(counts[n - 1], multiplier)
            tab = np.frombuffer(
                buf, dtype=[("k", "<u8"), ("p", "<f4"), ("b", "<f4")],
                count=nb, offset=off)
            off += nb * 16
            self._middle.append({
                int(k): (float(p), float(b))
                for k, p, b in zip(tab["k"], tab["p"], tab["b"]) if k != 0
            })
        self._longest: Dict[int, float] = {}
        if order >= 2:
            nb = _buckets(counts[order - 1], multiplier)
            tab = np.frombuffer(buf, dtype=[("k", "<u8"), ("p", "<f4")],
                                count=nb, offset=off)
            off += nb * 12
            self._longest = {
                int(k): float(p) for k, p in zip(tab["k"], tab["p"]) if k != 0
            }

        # trailing strings (id -> word), when present
        self.words: List[str] = []
        if has_vocab and off < len(buf):
            self.words = buf[off:].rstrip(b"\x00").split(b"\x00")
            self.words = [w.decode("utf-8", "replace") for w in self.words]

    # -- querying (mirrors ArpaLanguageModel) -------------------------------
    def _id(self, word: str) -> int:
        return self._vocab.get(murmur_hash64a(word.encode()), 0)

    def _lookup(self, ids: Sequence[int]):
        """(prob, backoff) of the n-gram, or None. Blank placeholders
        (-inf probs kenlm inserts for pruned prefixes) read as absent."""
        n = len(ids)
        if n == 1:
            if ids[0] >= len(self._unigram):
                return None
            p, b = self._unigram[ids[0]]
            return (float(p), float(b))
        key = ngram_key(ids)
        if n == self.order:
            p = self._longest.get(key)
            return None if p is None or p == float("-inf") else (p, 0.0)
        hit = self._middle[n - 2].get(key)
        return None if hit is None or hit[0] == float("-inf") else hit

    def _word_score(self, context: Sequence[str], word: str) -> float:
        wid = self._id(word)
        ctx = [self._id(w) for w in context]
        ctx = ctx[-(self.order - 1):] if self.order > 1 else []
        total_backoff = 0.0
        while True:
            hit = self._lookup(ctx + [wid])
            if hit is not None:
                return total_backoff + hit[0]
            if not ctx:
                return total_backoff - 99.0
            bo = self._lookup(ctx)
            total_backoff += bo[1] if bo is not None else 0.0
            ctx = ctx[1:]

    def score(self, sentence: str, bos: bool = True, eos: bool = True) -> float:
        """Total log10 probability (the kenlm.Model.score contract)."""
        words = sentence.split()
        context: List[str] = [BOS] if bos else []
        total = 0.0
        for w in words:
            total += self._word_score(context, w)
            context.append(w)
        if eos:
            total += self._word_score(context, EOS)
        return total


def is_kenlm_binary(path: str) -> bool:
    try:
        with open(path, "rb") as f:
            return f.read(len(MAGIC_PREFIX)) == MAGIC_PREFIX
    except OSError:
        return False
