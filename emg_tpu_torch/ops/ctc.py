"""CTC loss with the reference's reduction: CUDA kernels, wrapper.

Counterpart of ``emg_tpu/ops/ctc.py``. The reference computes
F.ctc_loss(log_probs, targets, input_lengths, target_lengths, blank=43)
with the default 'mean' reduction: the batch mean of each sequence's
negative log-likelihood divided by its target length (reference
recognition_model.py:93-98; targets are the phoneme ids with <S>/</S>
stripped). Here the per-sequence values come from ``ctc_nll`` and the mean
runs over the real examples only: the bucket-padding examples of a batch
(``n_examples`` onward) are masked out, so they cost nothing and cannot
reach the gradient. ``n_examples`` may be a host int or a 0-dim device
tensor; nothing here reads the device from the host, so a CUDA graph can
hold the whole loss.

``ctc_nll`` runs the forward-backward recursion of ``csrc/ctc_loss.cu`` on
a CUDA tensor (``ctc_forward`` and ``ctc_backward``, which read the lengths
from device memory: F.ctc_loss copies them to the host, which no graph can
hold) and F.ctc_loss, its plain version, on a CPU tensor. The kernels'
gradient is the true gradient with respect to the log-probabilities;
F.ctc_loss returns one that is right only after log_softmax's backward, and
there the two agree.

An alignment that cannot exist (more labels than frames allow) gives
``inf`` here, as in the reference; the kernels give such a row no
gradient, where F.ctc_loss gives it NaN. The JAX package's optax CTC gives
a large finite value instead.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from emg_tpu_torch.ops import build
from emg_tpu_torch.text.phonemes import BLANK_ID

MAX_LABELS = 511  # 2 * S + 1 states must fit one 1024-thread block


def _check(lp, targets, input_lengths, target_lengths, blank):
    if lp.dim() != 3 or targets.dim() != 2 or targets.shape[0] != lp.shape[0]:
        raise ValueError(f"log_probs (B, T, C) and targets (B, S), got {tuple(lp.shape)}, "
                         f"{tuple(targets.shape)}")
    B = lp.shape[0]
    if input_lengths.shape != (B,) or target_lengths.shape != (B,):
        raise ValueError(f"input_lengths and target_lengths must be ({B},)")
    if not 0 < targets.shape[1] <= MAX_LABELS or not 0 <= blank < lp.shape[2]:
        raise ValueError(f"ctc takes 1-{MAX_LABELS} labels and a blank among the classes")
    if any(t.device != lp.device for t in (targets, input_lengths, target_lengths)):
        raise ValueError("ctc inputs must share one device")


def _cuda_args(lp, targets, input_lengths, target_lengths):
    if lp.dtype != torch.float32:
        # the step hands over float32 log-probs at every compute dtype
        raise TypeError(f"the ctc kernels take float32 log-probs, not {lp.dtype}")
    if lp.device.type != "cuda":
        raise ValueError(f"the ctc kernels run on cuda, not {lp.device}")
    return (lp.contiguous(), targets.to(torch.int64).contiguous(),
            input_lengths.to(torch.int64).contiguous(), target_lengths.to(torch.int64).contiguous())


def ctc_forward(lp, targets, input_lengths, target_lengths, blank: int = BLANK_ID):
    """(nll (B,), alpha (B, T, 2S+1)), float32: launches
    ``ctc_alpha_kernel`` on CUDA tensors (``lp`` float32) or raises."""
    _check(lp, targets, input_lengths, target_lengths, blank)
    lp, targets, il, tl = _cuda_args(lp, targets, input_lengths, target_lengths)
    B, T, C = lp.shape
    S = targets.shape[1]
    alpha = torch.empty((B, T, 2 * S + 1), dtype=torch.float32, device=lp.device)
    nll = torch.empty((B,), dtype=torch.float32, device=lp.device)
    code = build.library("ctc_loss").ctc_forward_f32(
        lp.data_ptr(), targets.data_ptr(), il.data_ptr(), tl.data_ptr(), alpha.data_ptr(),
        nll.data_ptr(), B, T, C, S, blank, build.current_stream_ptr(lp.device))
    build.check("ctc_loss", code)
    build.count_launch(ctc_forward)
    return nll, alpha


def ctc_backward(lp, targets, input_lengths, target_lengths, alpha, nll, grad_nll,
                 blank: int = BLANK_ID):
    """d(sum_b grad_nll[b] nll[b]) / d lp, (B, T, C) float32, zero at
    t >= T_b and for rows whose nll is not finite: launches
    ``ctc_beta_kernel`` and ``ctc_grad_kernel`` on CUDA tensors or raises."""
    _check(lp, targets, input_lengths, target_lengths, blank)
    lp, targets, il, tl = _cuda_args(lp, targets, input_lengths, target_lengths)
    B, T, C = lp.shape
    S = targets.shape[1]
    beta = torch.empty_like(alpha)
    grad = torch.empty_like(lp)
    g = grad_nll.float().contiguous()
    code = build.library("ctc_loss").ctc_backward_f32(
        lp.data_ptr(), targets.data_ptr(), il.data_ptr(), tl.data_ptr(), alpha.data_ptr(),
        nll.data_ptr(), g.data_ptr(), beta.data_ptr(), grad.data_ptr(), B, T, C, S, blank,
        build.current_stream_ptr(lp.device))
    build.check("ctc_loss", code)
    build.count_launch(ctc_backward)
    return grad


ctc_forward.launches = 0
ctc_backward.launches = 0


class CTCNLL(torch.autograd.Function):
    """Per-sequence CTC negative log-likelihood, differentiable in the
    log-probabilities: ``ctc_forward``, then ``ctc_backward``."""

    @staticmethod
    def forward(ctx, lp, targets, input_lengths, target_lengths, blank):
        nll, alpha = ctc_forward(lp, targets, input_lengths, target_lengths, blank)
        ctx.save_for_backward(lp, targets, input_lengths, target_lengths, alpha, nll)
        ctx.blank = blank
        return nll

    @staticmethod
    def backward(ctx, grad_nll):
        lp, targets, il, tl, alpha, nll = ctx.saved_tensors
        grad = ctc_backward(lp, targets, il, tl, alpha, nll, grad_nll, ctx.blank)
        return grad.to(lp.dtype), None, None, None, None


def ctc_nll(log_probs, targets, input_lengths, target_lengths, blank: int = BLANK_ID):
    """(B,) negative log-likelihoods of ``targets`` under ``log_probs``
    (B, T, C), batch first; ``inf`` where no alignment exists. A CPU tensor
    takes F.ctc_loss; a CUDA tensor the kernels (``CTCNLL``)."""
    if log_probs.device.type == "cpu":
        return F.ctc_loss(log_probs.transpose(0, 1), targets, input_lengths, target_lengths,
                          blank=blank, reduction="none")
    return CTCNLL.apply(log_probs, targets, input_lengths, target_lengths, blank)


def ctc_loss(
    log_probs: torch.Tensor,  # (B, T, C) log-softmaxed logits
    input_lengths: torch.Tensor,  # (B,)
    targets: torch.Tensor,  # (B, S) target ids, no blanks
    target_lengths: torch.Tensor,  # (B,)
    n_examples,  # the batch's first n_examples rows are real: an int or a 0-dim tensor
    blank: int = BLANK_ID,
    row_offset: int = 0,
) -> torch.Tensor:
    """Mean over the real examples of nll / max(target_length, 1): their sum
    over ``n_examples``. On a mesh the rows given are a rank's, from global
    row ``row_offset`` on, and the value is the rank's share of that mean:
    its real rows' sum over the batch's ``n_examples``."""
    dev = log_probs.device
    n = torch.as_tensor(n_examples, device=dev)
    real = torch.arange(log_probs.shape[0], device=dev) + row_offset < n
    per_seq = ctc_nll(log_probs, targets, input_lengths, target_lengths, blank)
    per_len = per_seq / target_lengths.clamp(min=1).to(per_seq.dtype)
    return torch.where(real, per_len, 0.0).sum() / n.clamp(min=1).to(per_seq.dtype)
