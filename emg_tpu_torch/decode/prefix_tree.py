"""Phone prefix tree over the pronunciation lexicon, compiled to dense
device tables.

The reference builds a pointer-based trie whose nodes carry per-phone
log-mask vectors and word lists, walked with python loops during beam search
(PrefixTree.py:12-206). Here the trie is built once on host and compiled to
three arrays so the beam search's mask/step/word operations become gathers:

  child_table[node, phone] -> child node id (-1 if invalid)
  mask_table[node, 41]     -> 0 for valid continuations else -inf
                              (column 40 = </S>, valid only at the root)
  node_words[node]         -> word ids finishing at this node (ragged list)

Semantics preserved from the reference: the end token is only emittable at
the root (fill_probs, PrefixTree.py:293-302), finished-hypo node stepping
stays in place (node_step :197-204), and word emission happens at any node
whose word list is non-empty (check_words, BeamSearch.py:215-266).

A copy of ``emg_tpu/decode/prefix_tree.py`` (numpy; the tables are equal
to the JAX package's). The device beam moves them onto the card.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from emg_tpu_torch.text.lexicon import Dictionary, Phone, Word


class Node:
    __slots__ = ("phone", "words", "children", "node_id")

    def __init__(self, phone: Optional[Phone], node_id: int):
        self.phone = phone
        self.words: List[Word] = []
        self.children: Dict[Phone, "Node"] = {}
        self.node_id = node_id

    def is_word(self) -> bool:
        return len(self.words) > 0


class PrefixTree:
    def __init__(self, dictionary: Dictionary, phone_count: int):
        self._dictionary = dictionary
        self._phone_count = phone_count
        self._nodes: List[Node] = []
        self._root = self._new_node(Phone(phone_count + 2, "<S>"))

    def _new_node(self, phone: Optional[Phone]) -> Node:
        node = Node(phone, len(self._nodes))
        self._nodes.append(node)
        return node

    # -- construction ------------------------------------------------------
    def add_pronunciation(self, pron: Sequence[Phone], word: Word) -> None:
        node = self._root
        for phone in pron:
            nxt = node.children.get(phone)
            if nxt is None:
                nxt = self._new_node(phone)
                node.children[phone] = nxt
            node = nxt
        node.words.append(word)

    def add_word(self, word: Word) -> None:
        for pron in self._dictionary.lookup_prons(word):
            self.add_pronunciation(pron, word)

    def add_words(self, words: Sequence[Word]) -> None:
        for w in words:
            self.add_word(w)

    # -- queries (reference API parity) ------------------------------------
    def get_node(self, phones: Sequence[Phone]) -> Optional[Node]:
        node = self._root
        for p in phones:
            node = node.children.get(p)
            if node is None:
                return None
        return node

    def is_word(self, phones: Sequence[Phone]) -> bool:
        node = self.get_node(phones)
        return bool(node and node.is_word())

    def get_successor_phones(self, phones: Sequence[Phone]) -> List[Phone]:
        node = self.get_node(phones)
        if node is None:
            return []
        return [c.phone for c in node.children.values()]

    def words_for_prefix(self, phones: Sequence[Phone]) -> List[Word]:
        node = self.get_node(phones)
        if node is None:
            return []
        out: List[Word] = []

        def visit(n: Node):
            for c in n.children.values():
                visit(c)
            out.extend(n.words)

        visit(node)
        return out

    def num_nodes(self) -> int:
        return len(self._nodes)

    # -- dense compilation -------------------------------------------------
    def compile_tables(self) -> "CompiledTree":
        n = len(self._nodes)
        P = self._phone_count
        child = np.full((n, P), -1, np.int32)
        mask = np.full((n, P + 1), -np.inf, np.float32)
        words: List[List[int]] = [[] for _ in range(n)]
        for node in self._nodes:
            for phone, c in node.children.items():
                child[node.node_id, phone.idx] = c.node_id
                mask[node.node_id, phone.idx] = 0.0
            for w in node.words:
                words[node.node_id].append(w.idx)
        # end token (index P) is valid only at the root
        mask[self._root.node_id, P] = 0.0
        return CompiledTree(
            child_table=child,
            mask_table=mask,
            node_words=words,
            root=self._root.node_id,
            phone_count=P,
            dictionary=self._dictionary,
        )


class CompiledTree:
    def __init__(self, child_table, mask_table, node_words, root, phone_count, dictionary):
        self.child_table = child_table  # (n_nodes, P) int32
        self.mask_table = mask_table  # (n_nodes, P+1) float32
        self.node_words = node_words  # list of word-id lists
        self.root = int(root)
        self.phone_count = int(phone_count)
        self.dictionary = dictionary

    def step(self, nodes: np.ndarray, phones: np.ndarray) -> np.ndarray:
        """Advance node ids by chosen phone ids; the end token (P) keeps the
        node in place (finished hypos are saved, not propagated)."""
        end = phones == self.phone_count
        stepped = self.child_table[nodes, np.where(end, 0, phones)]
        return np.where(end, nodes, stepped)

    def continuation_mask(self, nodes: np.ndarray) -> np.ndarray:
        """(H,) node ids -> (H, P+1) additive masks (0 or -inf)."""
        return self.mask_table[nodes]


def init_tree(phones_file: str, vocab_file: str, dict_file: str) -> PrefixTree:
    """Build a tree from the descriptions/ artifacts (reference
    PrefixTree.init_tree, :218-249): phone set + dedup'd vocabulary +
    pronunciation dictionary (the lexicon's word set is what populates the
    tree, as in the reference)."""
    from emg_tpu_torch.text.lexicon import load_pronunciation_dict

    dct = load_pronunciation_dict(phones_file, vocab_file, dict_file)
    tree = PrefixTree(dct, dct.phone_count())
    tree.add_words(list(dct.words_by_index().values()))
    return tree
