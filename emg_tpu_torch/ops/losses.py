"""Decoder CE loss with the reference's label smoothing, and the joint loss.

Counterpart of ``emg_tpu/ops/losses.py``. The reference LabelSmoothingLoss
(LabelSmoothingLoss.py:7-15) is not uniform smoothing but

    (1 - eps) * CE(ignore_index=PAD)  +  (eps / S) * sum(exp(logits))

with S the target sequence length and the exp-sum over every position and
class, padding included: a logit-magnitude regularizer. As in the JAX
package, S and the exp-sum cover the batch's true sequence length
(``seq_len``) and its real examples (the first ``n_examples`` rows), not
the bucket padding. The joint objective is
(1 - alpha) * dec + alpha * enc (recognition_model.py:107).
"""

from __future__ import annotations

import torch

from emg_tpu_torch.text.phonemes import PAD_ID


def label_smoothing_loss(
    logits: torch.Tensor,  # (B, S, C)
    targets: torch.Tensor,  # (B, S)
    n_examples: int,  # the first n_examples rows are real examples
    seq_len: int,  # true (unbucketed) target length of the batch
    epsilon: float = 0.1,
    pad_id: int = PAD_ID,
) -> torch.Tensor:
    logits, targets = logits[:n_examples], targets[:n_examples]
    logp = torch.log_softmax(logits, dim=-1)
    valid = targets != pad_id
    nll = -logp.gather(-1, torch.where(valid, targets, 0)[..., None])[..., 0]
    ce = torch.where(valid, nll, 0.0).sum() / valid.sum().clamp(min=1)
    reg = (epsilon / seq_len) * torch.exp(logits[:, :seq_len]).sum()
    return (1.0 - epsilon) * ce + reg


def combined_loss(dec_loss: torch.Tensor, enc_loss: torch.Tensor, alpha: float = 0.2):
    return (1.0 - alpha) * dec_loss + alpha * enc_loss
