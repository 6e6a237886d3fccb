"""Tensor-parallel placement of the encoder's weights and the ZeRO-1
partition of the optimizer state (port of
``vibertgrid_tpu/parallel/sharding.py``).

**Tensor parallelism** (a ``model`` axis above 1) follows the JAX package's
Megatron rules (``_spec_for``): in every encoder layer the attention's
query, key and value products and the FFN's up-projection are split on
their output features (weights and biases), the attention's output product
and the FFN's down-projection on their input features; everything else is
replicated. :func:`split_axis` states the rule on the port's parameter
names, in ``nn.Linear``'s ``[out, in]`` layout (the transpose of flax's
``[in, out]`` kernels, so "output features" is axis 0 here);
:func:`apply_shardings` keeps this rank's slice of each split parameter, and
:func:`gather_whole` rebuilds whole tensors from the model group's slices
(checkpoints hold whole tensors).

**ZeRO-1.** Each optimizer-state leaf of at least ``min_size`` elements
(the SGD momentum of a CNN weight, the Adam moments of a BERT weight, under
tensor parallelism of this rank's slice of it) is split along its first axis
that the data group's size divides, and each rank keeps only its slice;
smaller or indivisible leaves stay whole on every rank. The train step
reduce-scatters the gradients of the split parameters over the data group,
so that each rank receives the mean of its slices only
(:func:`reduce_scatter_mean`); each rank then updates only the slices that
it owns, and the data group all-gathers the updated slices, so that every
rank holds every parameter (:func:`all_gather_slices`,
:meth:`~vibertgrid_tpu_torch.train.optim.DualOptimizer.step`). The update
is elementwise, so it equals the replicated one.

Both exchanges pack the slices of one dtype into one buffer, a row per
rank: row r holds rank r's slice of each tensor in turn, laid out as the
slice itself.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from vibertgrid_tpu_torch.parallel.collectives import all_gather_into, reduce_scatter_into
from vibertgrid_tpu_torch.parallel.mesh import Layout


def split_axis(name: str, ndim: int) -> int | None:
    """The axis of the parameter ``name`` (the port's dotted name) that
    tensor parallelism splits over the model group, or None where it is
    replicated: the JAX package's ``_spec_for`` on the same path."""
    keys = name.split(".")
    if "bert_model" not in keys:
        return None
    if "attention" in keys:
        if any(k in keys for k in ("query", "key", "value")):
            return 0  # output features, weight and bias
        if "out" in keys:
            return 1 if ndim == 2 else None  # input features; the bias is whole
    if "intermediate" in keys:
        return 0
    if name.endswith("output.weight"):
        return 1
    return None


def param_shardings(model: torch.nn.Module, layout: Layout | None = None) -> dict:
    """``{parameter: split axis or None}`` for every parameter of ``model``
    (:func:`split_axis`); where ``layout`` has one model shard, none is
    split."""
    split = layout is not None and layout.model > 1
    return {p: split_axis(n, p.ndim) if split else None for n, p in model.named_parameters()}


def local_part(t: torch.Tensor, axis: int | None, layout: Layout | None) -> torch.Tensor:
    """This rank's slice of the whole tensor ``t`` along ``axis`` (a view;
    all of ``t`` where nothing is split)."""
    if axis is None or layout is None or layout.model == 1:
        return t
    n = t.shape[axis] // layout.model
    return t.narrow(axis, layout.model_index * n, n)


@torch.no_grad()
def apply_shardings(model: torch.nn.Module, layout: Layout) -> torch.nn.Module:
    """Keep this rank's slice of each split parameter of ``model``, in place
    (the parameter objects stay, their data shrink); a no-op where the
    layout has one model shard. Build the optimizer after it."""
    for p, axis in param_shardings(model, layout).items():
        if axis is not None:
            p.data = local_part(p.data, axis, layout).clone()
    return model


def gather_whole(named: dict, layout: Layout | None) -> dict:
    """``{name: whole tensor}`` from this rank's entries of ``named`` (the
    port's names) and the model group's: each split parameter's slices
    gathered along :func:`split_axis` (one all-gather a dtype), the others
    as they are."""
    axes = {n: split_axis(n, t.ndim) for n, t in named.items()}
    split = {n: t for n, t in named.items() if axes[n] is not None}
    if layout is None or layout.model == 1 or not split:
        return dict(named)
    whole = all_gather_slices(split, {n: (axes[n],) for n in split}, group=layout.model_group)
    return {n: whole.get(n, t) for n, t in named.items()}


def shard_axis(shape, world: int, min_size: int = 2**16) -> int | None:
    """The axis along which a leaf of ``shape`` is split over ``world``
    ranks, or None where it stays whole (the JAX package's rule)."""
    numel = 1
    for n in shape:
        numel *= n
    if world <= 1 or len(shape) == 0 or numel < min_size:
        return None
    return next((ax for ax, n in enumerate(shape) if n % world == 0), None)


def optimizer_state_shardings(params, rank: int, world: int, min_size: int = 2**16) -> dict:
    """``{param: (axis, start, length)}``: the slice of each split leaf that
    rank ``rank`` keeps and updates."""
    out = {}
    for p in params:
        ax = shard_axis(tuple(p.shape), world, min_size)
        if ax is not None:
            length = p.shape[ax] // world
            out[p] = (ax, rank * length, length)
    return out


def shard_optimizer_state(optimizer, rank: int, world: int, min_size: int = 2**16,
                          group=None):
    """Keep only the slices of ``optimizer``'s large state leaves that rank
    ``rank`` of the ``world`` ranks of the data group ``group`` (by default
    every process) owns, in place, and return the optimizer; a no-op on one
    data rank, as the JAX driver's ``zero1`` is on a data axis of 1."""
    if world > 1:
        params = [p for g in optimizer.param_groups for p in g["params"]]
        optimizer.set_shards(optimizer_state_shardings(params, rank, world, min_size), group)
    return optimizer


def _ranks_first(t: torch.Tensor, ax: int, world: int) -> torch.Tensor:
    """A view of contiguous ``t`` as ``[world, *slice shape]``: index r is
    rank r's slice along ``ax``."""
    shape = tuple(t.shape)
    return t.view(*shape[:ax], world, shape[ax] // world, *shape[ax + 1:]).movedim(ax, 0)


def _by_dtype(tensors: dict) -> list[dict]:
    parts: dict = {}
    for p, t in tensors.items():
        parts.setdefault(t.dtype, {})[p] = t
    return list(parts.values())


def reduce_scatter_mean(grads: dict, shards: dict, group=None) -> None:
    """ZeRO-1's gradient exchange over ``group`` (the data group; by default
    every process). ``grads``: ``{param: its whole local gradient}`` for
    split parameters. Writes the mean over the ranks of this rank's slice
    (``shards[param]``) into that slice of each gradient, in place (one
    reduce-scatter a dtype); the rest of each gradient keeps this rank's
    local values, which nothing reads."""
    world = dist.get_world_size(group)
    for part in _by_dtype(grads):
        sizes = [g.numel() // world for g in part.values()]
        first = next(iter(part.values()))
        rows = torch.empty((world, sum(sizes)), dtype=first.dtype, device=first.device)
        for (p, g), col in zip(part.items(), rows.split(sizes, dim=1)):
            chunks = _ranks_first(g, shards[p][0], world)
            col.view(chunks.shape).copy_(chunks)
        mine = torch.empty(sum(sizes), dtype=first.dtype, device=first.device)
        reduce_scatter_into(mine, rows, group)
        mine.div_(world)
        for (p, g), piece in zip(part.items(), mine.split(sizes)):
            ax, start, length = shards[p]
            own = g.narrow(ax, start, length)
            own.copy_(piece.view(own.shape))


def all_gather_slices(pieces: dict, shards: dict, out: dict | None = None,
                      group=None) -> dict:
    """``{key: whole tensor}`` from every rank's slice ``pieces[key]`` along
    the axis ``shards[key][0]``, the ranks of ``group`` (by default every
    process) in order (one all-gather a dtype). The whole tensors are
    written into ``out[key]`` where given (a contiguous tensor of the whole
    shape), else into new ones."""
    world = dist.get_world_size(group)
    out = dict(out or {})
    for part in _by_dtype(pieces):
        sizes = [t.numel() for t in part.values()]
        mine = torch.cat([t.reshape(-1) for t in part.values()])
        rows = torch.empty((world, mine.numel()), dtype=mine.dtype, device=mine.device)
        all_gather_into(rows, mine, group)
        for (k, t), col in zip(part.items(), rows.split(sizes, dim=1)):
            ax = shards[k][0]
            shape = list(t.shape)
            shape[ax] *= world
            whole = out.setdefault(k, torch.empty(shape, dtype=t.dtype, device=t.device))
            _ranks_first(whole, ax, world).copy_(col.view(world, *t.shape))
    return out


def state_bytes(optimizer) -> int:
    """The bytes of optimizer state this rank holds."""
    return sum(t.numel() * t.element_size() for st in optimizer.state.values()
               for t in st.values() if isinstance(t, torch.Tensor))
