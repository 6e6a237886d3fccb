"""Reductions over the global batch of a data-parallel train step, and the
pair of collectives of a tensor-parallel layer.

The JAX package computes a step over the global batch in one program, so its
loss, its OHEM and sampled selections, its BatchNorm statistics and its
clip all see every example. The port runs one process per device and makes
each such batch-wide reduction global by hand, over the **data group** of
the process's :class:`~vibertgrid_tpu_torch.parallel.mesh.Layout` (the ranks
of one model group hold the same documents, so a reduction over every
process would count each document ``model`` times). Inside
:func:`global_batch`, which the train step enters when a process group
exists:

- :func:`all_sum` sums a tensor over the data ranks, differentiably;
- :func:`all_max` and :func:`gather` reduce or gather without a gradient
  (the batch-max token count, the OHEM candidates);
- :func:`index_base` is the offset of this rank's elements in the global
  flat index, which the hashed masks count from (dropout, random samples);
- :func:`fold_seed` folds the shard ``data_index·model + model_index`` into
  the seed of an in-kernel dropout, as the JAX package's sharded kernels do
  (``seed + shard·2¹⁶``).

Outside it each of them is the one-process identity and issues no
collective: evaluation and serving never communicate per batch. The context
belongs to the thread (and task) that enters it; the backward passes keep
what they need from their forward.

**Gradients.** Every rank holds the same global loss L. The backward of
:func:`all_sum` sums the incoming gradients over the data ranks: it is the
adjoint of the sum in the graph of all ranks together, in which L occurs
once on each rank. So rank r's backward yields ``data · ∂L/∂(its inputs)``,
and the mean over the data group of the ranks' parameter gradients
(:func:`average_gradients`) is ``∂L/∂θ``, the gradient of the global-batch
loss.

**Tensor parallelism** (Megatron's f and g, over the **model group**):
:func:`copy_to_model` is the input of a column-parallel product (identity
forward, all-reduce backward), :func:`reduce_from_model` the output of a
row-parallel one (all-reduce forward, identity backward). They run in
evaluation too: a tensor-parallel layer needs them in every forward.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch
import torch.distributed as dist

from vibertgrid_tpu_torch.parallel.mesh import Layout, current_layout


# the collectives into and out of one flat buffer: named *_single from torch
# 2.13 on, *_into_tensor / *_tensor before it
_all_gather_flat = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_reduce_scatter_flat = (getattr(dist, "reduce_scatter_single", None)
                        or dist.reduce_scatter_tensor)


def _rows(x: torch.Tensor, group) -> list[torch.Tensor]:
    return list(x.view(dist.get_world_size(group), -1).unbind(0))


def _gloo_on_cuda(x: torch.Tensor, group) -> bool:
    """Gloo on the card is driven through the forms that take a list of
    tensors, the forms ``chip_smoke.py`` checks there."""
    return x.is_cuda and dist.get_backend(group) == "gloo"


def all_gather_into(out: torch.Tensor, x: torch.Tensor, group=None) -> None:
    """Every rank's ``x`` (of ``group``, by default every process) into
    ``out`` (the group's size times ``x``'s elements), in rank order,
    written straight into ``out``."""
    if _gloo_on_cuda(x, group):
        dist.all_gather(_rows(out, group), x.reshape(-1), group=group)
    else:
        _all_gather_flat(out.view(-1), x.reshape(-1), group=group)


def reduce_scatter_into(out: torch.Tensor, rows: torch.Tensor, group=None) -> None:
    """Row ``i`` of the sum over ``group``'s ranks of ``rows`` (a row per
    rank, of ``out``'s elements) into ``out``, on the group's ``i``-th rank."""
    if _gloo_on_cuda(out, group):
        dist.reduce_scatter(out, _rows(rows, group), group=group)
    else:
        _reduce_scatter_flat(out, rows.view(-1), group=group)


_ACTIVE: contextvars.ContextVar[Layout | None] = contextvars.ContextVar("global_batch",
                                                                       default=None)


@contextlib.contextmanager
def global_batch(enabled: bool = True, layout: Layout | None = None):
    """Make the batch-wide reductions of the code inside global over the
    data group of ``layout`` (by default the current one,
    :func:`~vibertgrid_tpu_torch.parallel.mesh.current_layout`);
    ``enabled=False`` leaves them local."""
    token = _ACTIVE.set((layout or current_layout()) if enabled else None)
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def _data() -> Layout | None:
    """The layout inside :func:`global_batch` when its data group has more
    than one rank, else None."""
    g = _ACTIVE.get()
    return g if g is not None and g.data > 1 else None


def active() -> bool:
    return _data() is not None


def _all_reduce(x: torch.Tensor, op=dist.ReduceOp.SUM, group=None) -> torch.Tensor:
    y = x.detach().clone().contiguous()
    dist.all_reduce(y, op=op, group=group)
    return y


class _AllSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group=group)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, group=ctx.group), None


def all_sum(x: torch.Tensor) -> torch.Tensor:
    """``Σ_ranks x`` over the data group; its backward sums the gradients
    over the group (see the module docstring). The identity outside
    :func:`global_batch`."""
    g = _data()
    if g is None:
        return x
    return _AllSum.apply(x, g.data_group) if x.requires_grad else _all_reduce(x, group=g.data_group)


def all_max(x: torch.Tensor) -> torch.Tensor:
    """The elementwise maximum over the data group, without a gradient."""
    g = _data()
    return x if g is None else _all_reduce(x, dist.ReduceOp.MAX, g.data_group)


def gather(x: torch.Tensor) -> torch.Tensor:
    """``[data, *x.shape]``: every data rank's ``x`` in order, without a
    gradient (one all-gather)."""
    g = _data()
    if g is None:
        return x.detach()[None]
    buf = torch.empty((g.data, *x.shape), dtype=x.dtype, device=x.device)
    all_gather_into(buf, x.detach().contiguous(), g.data_group)
    return buf


def index_base(n: int, device) -> torch.Tensor | int:
    """The number of elements that the data ranks before this one hold of
    an array of which this rank holds ``n``: where its elements start in the
    global flat index (``data_index·n`` when the ranks' shapes agree, and
    disjoint ranges when they do not). The ranks of one model group hold the
    same documents and so start at the same place. A 0-d int64 tensor on
    ``device``, or 0 outside :func:`global_batch`."""
    g = _data()
    if g is None:
        return 0
    counts = gather(torch.tensor(n, dtype=torch.int64, device=device))
    return counts[:g.data_index].sum()


def fold_seed(seed):
    """``seed + (data_index·model + model_index)·2¹⁶`` in wrapping int32: the
    in-kernel dropout's seed on this rank, as the JAX package's sharded
    kernels fold the shard index in (a kernel's program ids restart at 0 on
    every shard); ``seed + rank·2¹⁶`` without tensor parallelism. A tensor
    seed (a 0-d int32 slot of the step's seeds) is folded on its device."""
    g = _ACTIVE.get()
    if g is None:
        return seed
    if isinstance(seed, torch.Tensor):
        return seed + (((g.rank * 2**16 + 2**31) % 2**32) - 2**31)  # int32 arithmetic wraps
    return ((int(seed) + g.rank * 2**16 + 2**31) % 2**32) - 2**31


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, group=ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group=group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x: torch.Tensor, layout: Layout | None) -> torch.Tensor:
    """The input of a column-parallel product (Megatron's f): the identity,
    whose backward sums the gradient over the model group, since each model
    rank's slice of the product contributes a part of it."""
    if layout is None or layout.model == 1 or not x.requires_grad:
        return x
    return _CopyToModel.apply(x, layout.model_group)


def reduce_from_model(x: torch.Tensor, layout: Layout | None) -> torch.Tensor:
    """The output of a row-parallel product (Megatron's g): the sum over the
    model group of the ranks' partial products; its backward is the
    identity, since every rank's partial product enters the sum once."""
    if layout is None or layout.model == 1:
        return x
    if not x.requires_grad:
        return _all_reduce(x, group=layout.model_group)
    return _ReduceFromModel.apply(x, layout.model_group)


def average_gradients(grads: list[torch.Tensor], group=None) -> None:
    """Replace each gradient by its mean over ``group``'s ranks (by default
    every process), in place: one all-reduce of the gradients packed into
    one buffer."""
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    flat.div_(dist.get_world_size(group))
    torch._foreach_copy_(grads, [c.view_as(g) for c, g in
                                 zip(flat.split([g.numel() for g in grads]), grads)])
