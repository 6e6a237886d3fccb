"""ZeRO-1 partition of the optimizer state (port of
``vibertgrid_tpu/parallel/sharding.py``).

Each optimizer-state leaf of at least ``min_size`` elements (the SGD
momentum of a CNN weight, the Adam moments of a BERT weight) is split along
its first axis that the world size divides, and each rank keeps only its
slice; smaller or indivisible leaves stay whole on every rank. The train
step reduce-scatters the gradients of the split parameters, so that each
rank receives the mean of its slices only (:func:`reduce_scatter_mean`);
each rank then updates only the slices that it owns, and the ranks
all-gather the updated slices, so that every rank holds every parameter
(:func:`all_gather_slices`,
:meth:`~vibertgrid_tpu_torch.train.optim.DualOptimizer.step`). The update
is elementwise, so it equals the replicated one.

Both exchanges pack the slices of one dtype into one buffer, a row per
rank: row r holds rank r's slice of each tensor in turn, laid out as the
slice itself.

Tensor parallelism (``param_shardings``) is not ported.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from vibertgrid_tpu_torch.parallel.collectives import all_gather_into, reduce_scatter_into
from vibertgrid_tpu_torch.parallel.mesh import ROADMAP_TP


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


def shard_optimizer_state(optimizer, rank: int, world: int, min_size: int = 2**16):
    """Keep only this rank's slices of ``optimizer``'s large state leaves
    (in place) and return the optimizer; a no-op in one process, as the
    JAX driver's ``zero1`` is on a data axis of 1."""
    if world > 1:
        params = [p for g in optimizer.param_groups for p in g["params"]]
        optimizer.set_shards(optimizer_state_shardings(params, rank, world, min_size))
    return optimizer


def _ranks_first(t: torch.Tensor, ax: int, world: int) -> torch.Tensor:
    """A view of contiguous ``t`` as ``[world, *slice shape]``: index r is
    rank r's slice along ``ax``."""
    shape = tuple(t.shape)
    return t.view(*shape[:ax], world, shape[ax] // world, *shape[ax + 1:]).movedim(ax, 0)


def _by_dtype(tensors: dict) -> list[dict]:
    groups: dict = {}
    for p, t in tensors.items():
        groups.setdefault(t.dtype, {})[p] = t
    return list(groups.values())


def reduce_scatter_mean(grads: dict, shards: dict) -> list[torch.Tensor]:
    """ZeRO-1's gradient exchange. ``grads``: ``{param: its whole local
    gradient}`` for split parameters. Writes the mean over the ranks of this
    rank's slice (``shards[param]``) into that slice of each gradient, in
    place (one reduce-scatter a dtype), and returns those slices; the rest
    of each gradient keeps this rank's local values, which nothing reads."""
    world = dist.get_world_size()
    owned = []
    for group in _by_dtype(grads):
        sizes = [g.numel() // world for g in group.values()]
        first = next(iter(group.values()))
        rows = torch.empty((world, sum(sizes)), dtype=first.dtype, device=first.device)
        for (p, g), col in zip(group.items(), rows.split(sizes, dim=1)):
            chunks = _ranks_first(g, shards[p][0], world)
            col.view(chunks.shape).copy_(chunks)
        mine = torch.empty(sum(sizes), dtype=first.dtype, device=first.device)
        reduce_scatter_into(mine, rows)
        mine.div_(world)
        for (p, g), piece in zip(group.items(), mine.split(sizes)):
            ax, start, length = shards[p]
            own = g.narrow(ax, start, length)
            own.copy_(piece.view(own.shape))
            owned.append(own)
    return owned


def all_gather_slices(pieces: dict, shards: dict, out: dict | None = None) -> dict:
    """``{param: whole tensor}`` from every rank's slice ``pieces[param]``
    along ``shards[param]`` (one all-gather a dtype). The whole tensors are
    written into ``out[param]`` where given (a contiguous tensor of the
    parameter's shape), else into new ones."""
    world = dist.get_world_size()
    out = dict(out or {})
    for group in _by_dtype(pieces):
        sizes = [t.numel() for t in group.values()]
        mine = torch.cat([t.reshape(-1) for t in group.values()])
        rows = torch.empty((world, mine.numel()), dtype=mine.dtype, device=mine.device)
        all_gather_into(rows, mine)
        for (p, t), col in zip(group.items(), rows.split(sizes, dim=1)):
            whole = out.setdefault(p, torch.empty(p.shape, dtype=t.dtype, device=t.device))
            _ranks_first(whole, shards[p][0], world).copy_(col.view(world, *t.shape))
    return out


def state_bytes(optimizer) -> int:
    """The bytes of optimizer state this rank holds."""
    return sum(t.numel() * t.element_size() for st in optimizer.state.values()
               for t in st.values() if isinstance(t, torch.Tensor))


def param_shardings(*_args, **_kwargs):
    """Tensor-parallel placement of the BERT weights: not ported."""
    raise NotImplementedError(ROADMAP_TP)
