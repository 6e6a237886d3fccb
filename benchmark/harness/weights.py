"""Weights made from the seed, on the device, for the program and the
reference alike.

One ``torch.randn`` over every floating-point entry of the model, drawn by a
``torch.Generator`` on the device, then scaled in place slice by slice:

- a matrix, a convolution kernel or an embedding table: ``N(0, 1/fan_in)``,
  ``fan_in`` the product of all axes but the first (a torch ``Linear``
  keeps ``[out, in]``, a convolution ``[out, in, kh, kw]``, an embedding
  ``[rows, width]``);
- a norm's scale (a 1-d ``weight``): ``1 + 0.1 N(0, 1)``; a bias, and
  anything else of one axis: ``0.02 N(0, 1)``;
- BatchNorm's running statistics: mean 0 and variance 1.

The names and shapes are the model's state dict; the weights are fp32, the
type the port keeps its parameters in (its products run in bf16).
"""

from __future__ import annotations

import math

import torch


def draw(shapes: dict, seed: int, device) -> dict:
    """``{name: tensor}`` for ``shapes`` (``{name: (shape, dtype)}``, as a
    state dict gives them); entries that are not floating point are zeros."""
    gen = torch.Generator(device=device).manual_seed(seed & 0xFFFFFFFFFFFFFFFF)
    floats = {k: s for k, (s, dt) in shapes.items() if dt.is_floating_point}
    total = sum(math.prod(s) for s in floats.values())
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    with torch.no_grad():
        for name, shape in floats.items():
            n = math.prod(shape)
            t = flat[at:at + n].view(shape)
            at += n
            if name.endswith("running_mean"):
                t.zero_()
            elif name.endswith("running_var"):
                t.fill_(1.0)
            elif len(shape) >= 2:
                t.mul_(1.0 / math.sqrt(math.prod(shape[1:])))
            elif name.endswith("weight"):
                t.mul_(0.1).add_(1.0)
            else:
                t.mul_(0.02)
            out[name] = t
    for name, (shape, dt) in shapes.items():
        if name not in out:
            out[name] = torch.zeros(shape, dtype=dt, device=device)
    return out


def shapes_of(module: torch.nn.Module) -> dict:
    return {k: (tuple(v.shape), v.dtype) for k, v in module.state_dict().items()}
