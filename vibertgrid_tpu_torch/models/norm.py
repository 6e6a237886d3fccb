"""Normalization layers with fp32 statistics and compute-dtype outputs
(port of ``vibertgrid_tpu/models/norm.py``).

Parameters (``weight``, ``bias``) and running statistics are fp32; the
input is upcast, normalised in fp32 and cast back to ``dtype``. In training
the BatchNorms normalise with the batch's own statistics and move the running
ones: ``ra = momentum·ra + (1 − momentum)·batch`` with the **biased** batch
variance, as the JAX package does (``torch.nn.BatchNorm2d`` would store the
unbiased one). Whether a call trains is an argument, not the module's
``training`` flag, as in the JAX package.

Inside a data-parallel train step
(:func:`vibertgrid_tpu_torch.parallel.collectives.global_batch`) a training
call takes its statistics over every rank's batch, as the JAX package's
BatchNorm over a batch sharded in one program does (SyncBatchNorm): the
sums and the counts are summed over the ranks, differentiably, so the
gradients are those of the statistics of the global batch. Evaluation
issues no collective.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from vibertgrid_tpu_torch.parallel.collectives import active, all_sum


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
    def __init__(self, channels: int, *, eps: float, momentum: float, dtype, device):
        super().__init__()
        self.eps = eps
        self.momentum = momentum  # weight of the old running value, flax convention
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))
        self.register_buffer("running_mean", torch.zeros(channels, device=device))
        self.register_buffer("running_var", torch.ones(channels, device=device))

    def _update(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        with torch.no_grad():
            self.running_mean.mul_(self.momentum).add_(mean, alpha=1 - self.momentum)
            self.running_var.mul_(self.momentum).add_(var, alpha=1 - self.momentum)


def _view(p: torch.Tensor) -> torch.Tensor:
    return p.view(1, -1, 1, 1)


class BatchNorm(_RunningNorm):
    """BatchNorm on NCHW (any memory format), fp32 arithmetic:
    ``(x − mean)·rsqrt(var + eps)·weight + bias``.

    ``train=False`` normalises with the running statistics: ``F.batch_norm``
    in eval mode computes exactly that in fp32 for a bf16 input with fp32
    statistics, in one pass over the tensor. ``train=True`` normalises with
    the batch statistics (biased variance) and moves the running ones
    toward them."""

    def __init__(self, channels: int, *, eps: float = 1e-5, momentum: float = 0.9,
                 dtype=torch.float32, device=None):
        super().__init__(channels, eps=eps, momentum=momentum, dtype=dtype, device=device)

    def forward(self, x, train: bool = False):
        if not train:
            return F.batch_norm(
                x.to(self.dtype), self.running_mean, self.running_var, self.weight, self.bias,
                training=False, eps=self.eps,
            )
        if active():
            return self._global(x)
        # One fused pass forward and one backward: F.batch_norm normalises
        # with the biased batch variance in fp32 and, at momentum 1, leaves
        # the batch mean and the *unbiased* variance in the buffers it is
        # given; (n − 1)/n turns that into the biased one the running
        # average takes.
        n = x.numel() // x.shape[1]
        mean = torch.zeros_like(self.running_mean)
        var = torch.ones_like(self.running_var)
        y = F.batch_norm(
            x.to(self.dtype), mean, var, self.weight, self.bias,
            training=True, momentum=1.0, eps=self.eps,
        )
        self._update(mean, var * ((n - 1) / n))
        return y

    def _global(self, x):
        """Training over the global batch: the mean from the ranks' sums and
        counts, then the biased variance from their centred squares."""
        xf = x.float()
        c = x.shape[1]
        count = xf.new_tensor([x.numel() // c])
        sums = all_sum(torch.cat([xf.sum(dim=(0, 2, 3)), count]))
        mean = sums[:c] / sums[c]
        diff = xf - _view(mean)
        var = all_sum((diff * diff).sum(dim=(0, 2, 3))) / sums[c]
        self._update(mean.detach(), var.detach())
        y = diff * _view(torch.rsqrt(var + self.eps))
        return (y * _view(self.weight) + _view(self.bias)).to(self.dtype)


class MaskedBatchNorm(_RunningNorm):
    """BatchNorm over RoIs ``[N, C, h, w]`` with an entry validity mask
    ``[N]``: in training the statistics are taken over the valid entries only
    (``denom = max(Σmask · h·w, 1)``), so padding RoIs do not contaminate
    them; in eval the running statistics are used and the mask plays no
    part. Divides by ``sqrt(var + eps)``. In a data-parallel step the sums
    and the counts are the ranks' together; a rank whose entries are all
    padding adds zeros, and still joins the reduction."""

    def __init__(self, channels: int, *, eps: float = 1e-5, momentum: float = 0.9,
                 dtype=torch.float32, device=None):
        super().__init__(channels, eps=eps, momentum=momentum, dtype=dtype, device=device)

    def forward(self, x, mask, train: bool = False):
        xf = x.float()
        if train:
            m = mask.float().view(-1, 1, 1, 1)
            c = x.shape[1]
            sums = all_sum(torch.cat([(xf * m).sum(dim=(0, 2, 3)),
                                      (m.sum() * (x.shape[2] * x.shape[3])).reshape(1)]))
            denom = torch.clamp(sums[c], min=1.0)
            mean = sums[:c] / denom
            diff = (xf - _view(mean)) * m
            var = all_sum((diff * diff).sum(dim=(0, 2, 3))) / denom
            self._update(mean.detach(), var.detach())
        else:
            mean, var = self.running_mean, self.running_var
        y = (xf - _view(mean)) / _view(torch.sqrt(var + self.eps))
        return (y * _view(self.weight) + _view(self.bias)).to(self.dtype)
