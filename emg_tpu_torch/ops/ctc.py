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
    n_examples: int,  # the first n_examples rows are real examples
    blank: int = BLANK_ID,
) -> torch.Tensor:
    """Mean over the real examples of nll / max(target_length, 1)."""
    n = max(int(n_examples), 1)
    per_seq = F.ctc_loss(
        log_probs[:n].transpose(0, 1), targets[:n], input_lengths[:n], target_lengths[:n],
        blank=blank, reduction="none",
    )
    return (per_seq / target_lengths[:n].clamp(min=1).to(per_seq.dtype)).mean()
