"""emg_tpu_torch: the EMG-to-phoneme recognizer in PyTorch, for NVIDIA Hopper.

A port of the JAX package ``emg_tpu`` that mirrors its module layout
(``emg_tpu_torch/dsp/filters.py`` is the counterpart of
``emg_tpu/dsp/filters.py``, and so on). It imports torch, numpy and scipy,
and nothing of JAX or of ``emg_tpu``. The TPU kernels on its path are
CUDA kernels written for ``sm_90a`` under ``ops/csrc/``, each with a plain
PyTorch version beside it that the CPU runs.

It covers serving (device DSP -> ResNet CNN -> relative-positional
transformer encoder -> KV-cached greedy decoding -> PER, ``python -m
emg_tpu_torch.cli --evaluate_saved_greedy_search CKPT``), beam evaluation
(the same encoder, then the lexicon-constrained beam search with the
n-gram LM -> WER, ``--evaluate_saved_beam_search CKPT --lang_model LM``)
and training (``python -m emg_tpu_torch.cli --output_directory OUT``), on
one device or a (data, model) device mesh of one process a device
(``--parallel.data_axis D --parallel.model_axis M``, ``parallel/``).
"""

import torch

__version__ = "0.1.0"

# Float32 stays float32 on the card. cuDNN runs float32 convolutions in
# TF32 by default (about three decimal digits), which would put the conv
# stack off its float32 reference; matmuls are pinned the same way.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
