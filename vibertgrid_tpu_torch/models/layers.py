"""Leaf layers initialised from an explicit ``torch.Generator``, and the
compute-dtype casts the models apply at each use.

Parameters are stored in fp32, as the JAX package's are; like a flax
``Dense(dtype=...)``, each product casts its input, weight and bias to the
compute dtype where it runs (a no-op in fp32).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def _lecun_normal_(w: torch.Tensor, generator: torch.Generator) -> None:
    fan_in = w[0].numel()
    with torch.no_grad():
        w.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=generator)


def linear(in_f: int, out_f: int, *, bias: bool = True, device, generator) -> nn.Linear:
    layer = nn.utils.skip_init(nn.Linear, in_f, out_f, bias=bias, device=device)
    _lecun_normal_(layer.weight, generator)
    if bias:
        nn.init.zeros_(layer.bias)
    return layer


def conv2d(in_c: int, out_c: int, k: int, *, stride: int = 1, bias: bool = False,
           device, generator) -> nn.Conv2d:
    """``k×k`` convolution padded ``k//2`` on each side, as the JAX
    package's ``padding=[(k//2, k//2)] * 2``."""
    layer = nn.utils.skip_init(
        nn.Conv2d, in_c, out_c, k, stride=stride, padding=k // 2, bias=bias, device=device
    )
    _lecun_normal_(layer.weight, generator)
    if bias:
        nn.init.zeros_(layer.bias)
    return layer


def embedding(num: int, dim: int, *, device, generator) -> nn.Embedding:
    layer = nn.utils.skip_init(nn.Embedding, num, dim, device=device)
    with torch.no_grad():
        layer.weight.normal_(0.0, 1.0 / math.sqrt(dim), generator=generator)
    return layer


def _cast(p: torch.Tensor | None, dtype):
    return None if p is None else p.to(dtype)


def dense(x: torch.Tensor, layer: nn.Linear, dtype) -> torch.Tensor:
    return F.linear(x.to(dtype), layer.weight.to(dtype), _cast(layer.bias, dtype))


def conv(x: torch.Tensor, layer: nn.Conv2d, dtype) -> torch.Tensor:
    return F.conv2d(
        x.to(dtype), layer.weight.to(dtype), _cast(layer.bias, dtype),
        layer.stride, layer.padding,
    )


def assign(target: torch.Tensor, value, name: str) -> None:
    """Copy ``value`` (a torch tensor or a numpy array) into the parameter or
    buffer ``target`` in place; a shape mismatch raises and names the entry."""
    value = torch.as_tensor(value)
    if value.shape != target.shape:
        raise ValueError(
            f"{name}: checkpoint shape {tuple(value.shape)}, model {tuple(target.shape)}")
    with torch.no_grad():
        target.copy_(value)
