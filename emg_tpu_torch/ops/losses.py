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
    n_examples,  # the batch's first n_examples rows are real examples
    seq_len,  # true (unbucketed) target length of the batch
    n_tokens,  # the batch's target tokens (not pad_id) in its real rows
    epsilon: float = 0.1,
    pad_id: int = PAD_ID,
    row_offset: int = 0,
) -> torch.Tensor:
    """The CE over the batch's ``n_tokens`` target tokens, smoothed by the
    exp-sum. On a mesh the rows given are a rank's, from global row
    ``row_offset`` on, and the value is the rank's share of the batch's
    loss (its real rows' CE sum over ``n_tokens``, and their exp-sum); the
    shares add up to the loss of the whole batch. ``n_examples``,
    ``seq_len`` and ``n_tokens`` are host ints or 0-dim device tensors:
    the rows and positions they leave out are masked, not sliced, so
    nothing reads the device from the host."""
    B, S, _ = logits.shape
    dev = logits.device
    n, seq, tokens = (torch.as_tensor(v, device=dev) for v in (n_examples, seq_len, n_tokens))
    real = (torch.arange(B, device=dev) + row_offset < n)[:, None]
    logp = torch.log_softmax(logits, dim=-1)
    valid = (targets != pad_id) & real
    nll = -logp.gather(-1, torch.where(valid, targets, 0)[..., None])[..., 0]
    ce = torch.where(valid, nll, 0.0).sum() / tokens.clamp(min=1)
    within = real & (torch.arange(S, device=dev) < seq)[None, :]
    reg = (epsilon / seq) * torch.where(within[..., None], torch.exp(logits), 0.0).sum()
    return (1.0 - epsilon) * ce + reg


def combined_loss(dec_loss: torch.Tensor, enc_loss: torch.Tensor, alpha: float = 0.2):
    return (1.0 - alpha) * dec_loss + alpha * enc_loss
