"""Reductions over the global batch of a data-parallel train step.

The JAX package computes a step over the global batch in one program, so its
loss, its OHEM and sampled selections, its BatchNorm statistics and its
clip all see every example. The port runs one process per device and makes
each such batch-wide reduction global by hand. Inside :func:`global_batch`,
which the train step enters when a process group exists:

- :func:`all_sum` sums a tensor over the ranks, differentiably;
- :func:`all_max` and :func:`gather` reduce or gather without a gradient
  (the batch-max token count, the OHEM candidates);
- :func:`index_base` is the offset of this rank's elements in the global
  flat index, which the hashed masks count from (dropout, random samples);
- :func:`fold_seed` folds the rank into the seed of an in-kernel dropout,
  as the JAX package's sharded kernels do (``seed + shard·2¹⁶``).

Outside it each of them is the one-process identity and issues no
collective: evaluation and serving never communicate per batch. The context
belongs to the thread (and task) that enters it; the backward passes keep
what they need from their forward.

**Gradients.** Every rank holds the same global loss L. The backward of
:func:`all_sum` sums the incoming gradients over the ranks: it is the
adjoint of the sum in the graph of all ranks together, in which L occurs
once on each rank. So rank r's backward yields ``world · ∂L/∂(its inputs)``,
and the mean of the ranks' parameter gradients
(:func:`average_gradients`) is ``∂L/∂θ``, the gradient of the global-batch
loss.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class _Group:
    rank: int
    world: int


# the collectives into and out of one flat buffer: named *_single from torch
# 2.13 on, *_into_tensor / *_tensor before it
_all_gather_flat = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_reduce_scatter_flat = (getattr(dist, "reduce_scatter_single", None)
                        or dist.reduce_scatter_tensor)


def _rows(x: torch.Tensor) -> list[torch.Tensor]:
    return list(x.view(dist.get_world_size(), -1).unbind(0))


def _gloo_on_cuda(x: torch.Tensor) -> bool:
    """Gloo on the card is driven through the forms that take a list of
    tensors, the forms ``chip_smoke.py`` checks there."""
    return x.is_cuda and dist.get_backend() == "gloo"


def all_gather_into(out: torch.Tensor, x: torch.Tensor) -> None:
    """Every rank's ``x`` into ``out`` (``world`` times ``x``'s elements),
    in rank order, written straight into ``out``."""
    if _gloo_on_cuda(x):
        dist.all_gather(_rows(out), x.reshape(-1))
    else:
        _all_gather_flat(out.view(-1), x.reshape(-1))


def reduce_scatter_into(out: torch.Tensor, rows: torch.Tensor) -> None:
    """Row ``rank`` of the sum over the ranks of ``rows`` (``world`` rows of
    ``out``'s elements) into ``out``."""
    if _gloo_on_cuda(out):
        dist.reduce_scatter(out, _rows(rows))
    else:
        _reduce_scatter_flat(out, rows.view(-1))


_ACTIVE: contextvars.ContextVar[_Group | None] = contextvars.ContextVar("global_batch",
                                                                       default=None)


@contextlib.contextmanager
def global_batch(enabled: bool = True):
    """Make the batch-wide reductions of the code inside global over the
    ranks of the process group; ``enabled=False`` leaves them local."""
    token = _ACTIVE.set(_Group(dist.get_rank(), dist.get_world_size()) if enabled else None)
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def active() -> bool:
    return _ACTIVE.get() is not None


def _all_reduce(x: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
    y = x.detach().clone().contiguous()
    dist.all_reduce(y, op=op)
    return y


class _AllSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _all_reduce(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad)


def all_sum(x: torch.Tensor) -> torch.Tensor:
    """``Σ_ranks x``; its backward sums the gradients over the ranks (see
    the module docstring). The identity outside :func:`global_batch`."""
    if _ACTIVE.get() is None:
        return x
    return _AllSum.apply(x) if x.requires_grad else _all_reduce(x)


def all_max(x: torch.Tensor) -> torch.Tensor:
    """The elementwise maximum over the ranks, without a gradient."""
    return x if _ACTIVE.get() is None else _all_reduce(x, dist.ReduceOp.MAX)


def gather(x: torch.Tensor) -> torch.Tensor:
    """``[world, *x.shape]``: every rank's ``x`` in rank order, without a
    gradient (one all-gather)."""
    g = _ACTIVE.get()
    if g is None:
        return x.detach()[None]
    buf = torch.empty((g.world, *x.shape), dtype=x.dtype, device=x.device)
    all_gather_into(buf, x.detach().contiguous())
    return buf


def index_base(n: int, device) -> torch.Tensor | int:
    """The number of elements that the ranks before this one hold of an
    array of which this rank holds ``n``: where its elements start in the
    global flat index (``rank·n`` when the ranks' shapes agree, and disjoint
    ranges when they do not). A 0-d int64 tensor on ``device``, or 0 outside
    :func:`global_batch`."""
    g = _ACTIVE.get()
    if g is None:
        return 0
    counts = gather(torch.tensor(n, dtype=torch.int64, device=device))
    return counts[:g.rank].sum()


def fold_seed(seed: int) -> int:
    """``seed + rank·2¹⁶`` in wrapping int32: the in-kernel dropout's seed on
    this rank, as the JAX package's sharded kernels fold the shard index in
    (a kernel's program ids restart at 0 on every rank)."""
    g = _ACTIVE.get()
    if g is None:
        return seed
    return ((int(seed) + g.rank * 2**16 + 2**31) % 2**32) - 2**31


def average_gradients(grads: list[torch.Tensor]) -> None:
    """Replace each gradient by its mean over the ranks, in place: one
    all-reduce of the gradients packed into one buffer."""
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    flat.div_(dist.get_world_size())
    torch._foreach_copy_(grads, [c.view_as(g) for c, g in
                                 zip(flat.split([g.numel() for g in grads]), grads)])
