"""Flax → PyTorch parameter and optimizer-state conversion.

:func:`from_flax` takes the JAX model's variables, ``{"params": ...,
"batch_stats": ...}`` as nested dicts of arrays, and returns a state dict
for the port's :class:`~vibertgrid_tpu_torch.models.vibertgrid.ViBERTgridNet`
(or for one of its sub-modules, given that sub-module's variables). The
port names its modules after the JAX tree, so only the leaves change:

- conv ``kernel`` HWIO → ``weight`` OIHW;
- Dense ``kernel`` ``[in, out]`` → Linear ``weight`` ``[out, in]``;
- norm ``scale`` → ``weight``; BatchNorm statistics ``mean``/``var`` →
  ``running_mean``/``running_var``;
- ``Embed.embedding`` → ``Embedding.weight``; the CRF head's ``transitions``
  keeps its name and layout;
- the encoder's ``layer_{i}`` → ``layer.{i}`` (an ``nn.ModuleList``).

:func:`optimizer_state_from_optax` does the same for the JAX package's dual
optimizer state (the SGD momentum and the Adam moments are shaped like the
parameters, so their leaves move the same way), for
:meth:`vibertgrid_tpu_torch.train.optim.DualOptimizer.load_named_state`.
"""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch

_LEAF = {"scale": "weight", "embedding": "weight", "bias": "bias",
         "mean": "running_mean", "var": "running_var", "transitions": "transitions"}


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
        if isinstance(value, tuple) and not value:
            continue  # optax's placeholder for a leaf of the other optimizer
        name, arr = _leaf(key, np.asarray(value, dtype=np.float32))
        out[".".join(prefix + [name])] = torch.from_numpy(np.array(arr))  # a writable copy


def from_flax(variables: Mapping) -> dict[str, torch.Tensor]:
    """State dict (fp32 CPU tensors) from flax ``params`` and ``batch_stats``."""
    out: dict[str, torch.Tensor] = {}
    _walk(variables["params"], [], out)
    _walk(variables.get("batch_stats", {}), [], out)
    return out


def optimizer_state_from_optax(opt_state) -> dict:
    """``{"count": int, "state": {parameter name: {slot: tensor}}}`` from the
    state of the JAX package's ``make_optimizer`` transformation (arrays as
    numpy or JAX arrays): slot ``momentum`` for the SGD group, ``mu`` and
    ``nu`` for the AdamW group, named and laid out as the port's parameters,
    in fp32 (the optimizer casts to its state dtype on load)."""
    sgd = opt_state.inner_states["cnn"].inner_state
    adam = opt_state.inner_states["bert"].inner_state
    state: dict[str, dict[str, torch.Tensor]] = {}
    for slot, tree in (("momentum", sgd["momentum"]), ("mu", adam["adam"].mu),
                       ("nu", adam["adam"].nu)):
        flat: dict[str, torch.Tensor] = {}
        _walk(tree, [], flat)
        for name, tensor in flat.items():
            state.setdefault(name, {})[slot] = tensor
    return {"count": int(np.asarray(sgd["count"])), "state": state}
