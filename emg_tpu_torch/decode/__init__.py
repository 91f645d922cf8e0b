"""Decoding: greedy search (KV-cached or over the full prefix), the prefix
tree and n-gram LMs, and the lexicon-constrained beam searches (on the card
and on the host), their loops run by ``graphs.LoopRunner``, and the
continuous-batching beam server. Counterpart of ``emg_tpu/decode``."""

from emg_tpu_torch.decode.graphs import LoopRunner  # noqa: F401
from emg_tpu_torch.decode.greedy import greedy_decode, greedy_decode_cached, run_greedy  # noqa: F401
from emg_tpu_torch.decode.prefix_tree import PrefixTree, CompiledTree, init_tree  # noqa: F401
from emg_tpu_torch.decode.ngram import ArpaLanguageModel, load_language_model, write_fixture_arpa  # noqa: F401
from emg_tpu_torch.decode.beam import BeamSearcher, run_single_bs  # noqa: F401

from emg_tpu_torch.decode.device_beam import DeviceBeamSearcher  # noqa: F401
from emg_tpu_torch.decode.continuous import ContinuousBeamServer  # noqa: F401
