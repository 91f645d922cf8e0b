"""Stride-8 ResBlock CNN over packed raw-EMG rows, with masked BatchNorm.

Counterpart of ``emg_tpu/models/resnet.py``. Topology matches the reference
ResBlock stack (architecture.py:22-58): three blocks of
[conv3-s BN ReLU conv3 BN] + (1x1-s conv BN) residual with a final ReLU,
channels 8 -> d_model, strides 2,2,2. BatchNorm statistics are computed
over the valid packed rows only: batches are padded up to a bucketed row
count, and those extra rows must not enter the statistics.

``ConvStack`` takes and returns the JAX package's (rows, time, channels)
layout; inside, the convolutions run in PyTorch's (rows, channels, time).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class MaskedBatchNorm(nn.Module):
    """BatchNorm1d over (rows, channels, time) with a valid-row count.

    torch semantics: biased variance for normalization, unbiased for the
    running average, momentum 0.1, eps 1e-5. In training, statistics are
    taken in float32 in one pass (sum and sum of squares together) over
    values shifted by a per-channel offset from the first (always valid)
    row, so channels with |mean| >> std do not cancel in E[x^2] - E[x]^2.
    Serving uses the running statistics. The output returns at the input
    dtype, so a bfloat16 conv stream stays bfloat16.

    On a device mesh (``mesh`` set) x is the rank's block of the packed
    rows, and the statistics are the global ones, as in JAX's global view:
    the shift is data rank 0's row 0 (the global row 0), the two sums are
    summed over the data axis and divided by the global valid count, so
    every rank normalizes alike and keeps equal running statistics.
    """

    mesh = None  # the device mesh, set by parallel/mesh.py::shard_params

    def __init__(self, num_features: int, momentum: float = 0.1, eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))

    def forward(self, x: torch.Tensor, n_valid_rows: int) -> torch.Tensor:
        if not self.training:
            mean, var = self.running_mean, self.running_var
        else:
            N, _, L = x.shape
            xf = x.float()
            count = float(max(n_valid_rows * L, 1))
            c = xf[0].mean(dim=1)  # (C,) shift from row 0
            mesh, first = self.mesh, 0  # first: the global index of row 0
            if mesh is not None:  # (sum_over_data is the identity with one data rank)
                first = mesh.data_index * N
                # c * 0, not a fresh zero: every rank's sum must be in the graph,
                # or one rank would skip the backward all-reduce
                c = mesh.sum_over_data(c if first == 0 else c * 0.0)
            rows = (torch.arange(N, device=x.device) < n_valid_rows - first)[:, None, None]
            xm = torch.where(rows, xf - c[None, :, None], 0.0)
            sums = torch.stack([xm.sum(dim=(0, 2)), (xm * xm).sum(dim=(0, 2))])
            if mesh is not None:
                sums = mesh.sum_over_data(sums)
            mean_s, sq = sums[0] / count, sums[1] / count
            var = torch.clamp(sq - mean_s * mean_s, min=0.0)
            mean = mean_s + c
            with torch.no_grad():
                unbiased = var * count / max(count - 1.0, 1.0)
                self.running_mean.mul_(1 - self.momentum).add_(self.momentum * mean)
                self.running_var.mul_(1 - self.momentum).add_(self.momentum * unbiased)
                self.num_batches_tracked.add_(1)
        y = (x.float() - mean[None, :, None]) / torch.sqrt(var[None, :, None] + self.eps)
        return (y * self.weight[None, :, None] + self.bias[None, :, None]).to(x.dtype)


def _conv(conv: nn.Conv1d, x: torch.Tensor) -> torch.Tensor:
    """Conv at the activation dtype; the parameters stay float32."""
    return F.conv1d(
        x, conv.weight.to(x.dtype), conv.bias.to(x.dtype),
        stride=conv.stride, padding=conv.padding,
    )


class ResBlock(nn.Module):
    def __init__(self, num_ins: int, num_outs: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv1d(num_ins, num_outs, 3, stride=stride, padding=1)
        self.bn1 = MaskedBatchNorm(num_outs)
        self.conv2 = nn.Conv1d(num_outs, num_outs, 3, padding=1)
        self.bn2 = MaskedBatchNorm(num_outs)
        self.has_residual_path = stride != 1 or num_ins != num_outs
        if self.has_residual_path:
            self.residual_path = nn.Conv1d(num_ins, num_outs, 1, stride=stride)
            self.res_norm = MaskedBatchNorm(num_outs)

    def forward(self, x: torch.Tensor, n_valid_rows: int) -> torch.Tensor:
        # x: (rows, channels_in, time)
        h = F.relu(self.bn1(_conv(self.conv1, x), n_valid_rows))
        h = self.bn2(_conv(self.conv2, h), n_valid_rows)
        if self.has_residual_path:
            res = self.res_norm(_conv(self.residual_path, x), n_valid_rows)
        else:
            res = x
        return F.relu(h + res)


class ConvStack(nn.ModuleList):
    """Three stride-2 ResBlocks: time /8, channels -> d_model. A ModuleList so
    its parameters carry the reference names ``conv_blocks.{i}.conv1...``."""

    def __init__(self, num_channels: int, d_model: int):
        super().__init__([
            ResBlock(num_channels, d_model, 2),
            ResBlock(d_model, d_model, 2),
            ResBlock(d_model, d_model, 2),
        ])

    def forward(self, x: torch.Tensor, n_valid_rows: int, dtype=torch.float32) -> torch.Tensor:
        """x: (rows, time, channels) -> (rows, time/8, d_model) at ``dtype``."""
        x = x.to(dtype).transpose(1, 2)
        for block in self:
            x = block(x, n_valid_rows)
        return x.transpose(1, 2)
