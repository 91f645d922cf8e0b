"""CTC loss with the reference's reduction.

Counterpart of ``emg_tpu/ops/ctc.py``. The reference computes
F.ctc_loss(log_probs, targets, input_lengths, target_lengths, blank=43)
with the default 'mean' reduction: the batch mean of each sequence's
negative log-likelihood divided by its target length (reference
recognition_model.py:93-98; targets are the phoneme ids with <S>/</S>
stripped). Here ``F.ctc_loss(reduction="none")`` gives the per-sequence
values and the mean runs over the real examples only: the bucket-padding
examples of a batch (``n_examples`` onward) are left out before the loss
is formed, so they cost nothing and cannot reach the gradient.

An alignment that cannot exist (more labels than frames allow) gives
``inf`` here, as in the reference; the JAX package's optax CTC gives a
large finite value instead.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from emg_tpu_torch.text.phonemes import BLANK_ID


def ctc_loss(
    log_probs: torch.Tensor,  # (B, T, C) log-softmaxed logits
    input_lengths: torch.Tensor,  # (B,)
    targets: torch.Tensor,  # (B, S) target ids, no blanks
    target_lengths: torch.Tensor,  # (B,)
    n_examples: int,  # the batch's first n_examples rows are real examples
    blank: int = BLANK_ID,
    row_offset: int = 0,
) -> torch.Tensor:
    """Mean over the real examples of nll / max(target_length, 1): their sum
    over ``n_examples``. On a mesh the rows given are a rank's, from global
    row ``row_offset`` on, and the value is the rank's share of that mean:
    its real rows' sum over the batch's ``n_examples``."""
    local = min(max(int(n_examples) - row_offset, 0), log_probs.shape[0])
    if local == 0:  # no real row here: a zero that keeps the graph whole
        return log_probs[:0].sum()
    per_seq = F.ctc_loss(
        log_probs[:local].transpose(0, 1), targets[:local], input_lengths[:local],
        target_lengths[:local], blank=blank, reduction="none",
    )
    per_len = per_seq / target_lengths[:local].clamp(min=1).to(per_seq.dtype)
    return per_len.sum() / max(int(n_examples), 1)
