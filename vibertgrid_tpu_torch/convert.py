"""Flax → PyTorch parameter conversion.

:func:`from_flax` takes the JAX model's variables, ``{"params": ...,
"batch_stats": ...}`` as nested dicts of arrays, and returns a state dict
for the port's :class:`~vibertgrid_tpu_torch.models.vibertgrid.ViBERTgridNet`
(or for one of its sub-modules, given that sub-module's variables). The
port names its modules after the JAX tree, so only the leaves change:

- conv ``kernel`` HWIO → ``weight`` OIHW;
- Dense ``kernel`` ``[in, out]`` → Linear ``weight`` ``[out, in]``;
- norm ``scale`` → ``weight``; BatchNorm statistics ``mean``/``var`` →
  ``running_mean``/``running_var``;
- ``Embed.embedding`` → ``Embedding.weight``;
- the encoder's ``layer_{i}`` → ``layer.{i}`` (an ``nn.ModuleList``).
"""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch

_LEAF = {"scale": "weight", "embedding": "weight", "bias": "bias",
         "mean": "running_mean", "var": "running_var"}


def _leaf(name: str, value: np.ndarray) -> tuple[str, np.ndarray]:
    if name == "kernel":
        if value.ndim == 4:
            return "weight", value.transpose(3, 2, 0, 1)
        if value.ndim == 2:
            return "weight", value.T
        raise ValueError(f"kernel of rank {value.ndim}")
    return _LEAF[name], value


def _walk(tree: Mapping, prefix: list[str], out: dict) -> None:
    for key, value in tree.items():
        if isinstance(value, Mapping):
            _walk(value, prefix + [re.sub(r"^layer_(\d+)$", r"layer.\1", key)], out)
            continue
        name, arr = _leaf(key, np.asarray(value, dtype=np.float32))
        out[".".join(prefix + [name])] = torch.from_numpy(np.ascontiguousarray(arr))


def from_flax(variables: Mapping) -> dict[str, torch.Tensor]:
    """State dict (fp32 CPU tensors) from flax ``params`` and ``batch_stats``."""
    out: dict[str, torch.Tensor] = {}
    _walk(variables["params"], [], out)
    _walk(variables.get("batch_stats", {}), [], out)
    return out
