"""Normalization layers with fp32 statistics and compute-dtype outputs
(port of ``vibertgrid_tpu/models/norm.py``, inference only).

Parameters (``weight``, ``bias``) and running statistics are fp32; the
input is upcast, normalised in fp32 and cast back to ``dtype``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class LayerNorm(nn.Module):
    """LayerNorm over the last axis, variance E[x²]−E[x]²."""

    def __init__(self, features: int, *, eps: float = 1e-6, dtype=torch.float32, device=None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = (xf * xf).mean(dim=-1, keepdim=True) - mean * mean
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        return (y * self.weight + self.bias).to(self.dtype)


class _RunningNorm(nn.Module):
    def __init__(self, channels: int, *, eps: float, dtype, device):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))
        self.register_buffer("running_mean", torch.zeros(channels, device=device))
        self.register_buffer("running_var", torch.ones(channels, device=device))


class BatchNorm(_RunningNorm):
    """Eval-mode BatchNorm on NCHW (any memory format) from running
    statistics: ``(x − mean)·rsqrt(var + eps)·weight + bias``, in fp32.

    ``F.batch_norm`` in eval mode computes exactly that in fp32 for a bf16
    input with fp32 statistics, in one pass over the tensor, where the
    explicit upcast-normalise-cast takes six."""

    def __init__(self, channels: int, *, eps: float = 1e-5, dtype=torch.float32, device=None):
        super().__init__(channels, eps=eps, dtype=dtype, device=device)

    def forward(self, x):
        return F.batch_norm(
            x.to(self.dtype), self.running_mean, self.running_var, self.weight, self.bias,
            training=False, eps=self.eps,
        )


class MaskedBatchNorm(_RunningNorm):
    """Eval mode of the masked RoI BatchNorm: running statistics, so the
    validity mask plays no part; divides by ``sqrt(var + eps)``."""

    def __init__(self, channels: int, *, eps: float = 1e-5, dtype=torch.float32, device=None):
        super().__init__(channels, eps=eps, dtype=dtype, device=device)

    def forward(self, x):
        view = lambda p: p.view(1, -1, 1, 1)
        y = (x.float() - view(self.running_mean)) / view(torch.sqrt(self.running_var + self.eps))
        return (y * view(self.weight) + view(self.bias)).to(self.dtype)
