"""Token → segment embedding aggregation (port of
``vibertgrid_tpu/ops/segments.py``), and the embedding lookup whose
gradient is summed in a fixed order.

Both are written so that a train step on the card is bit-repeatable: no
float sum here goes through atomics, whose order changes from run to run.
The aggregation is one batched product with a 0/1 selection matrix (its
backward is the transposed product); the lookup's gradient adds each row's
contributions in the order of a stable sort of the ids.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def aggregate_token_embeddings(
    token_embeddings: torch.Tensor,
    seg_ids: torch.Tensor,
    token_mask: torch.Tensor,
    *,
    num_segments: int,
    mode: str = "mean",
) -> torch.Tensor:
    """Aggregate wordpiece embeddings ``[B, T, D]`` into segments ``[B, S, D]``.

    ``mode="mean"`` averages each segment's valid tokens; ``"first"`` takes
    the embedding of its first valid token. Segments with no valid token
    are zero. Masked tokens belong to no segment.

    Both modes are ``select @ token_embeddings`` with a ``[B, S, T]`` matrix
    of zeros and ones (a segment's tokens, or its first token), so the sums
    run in the product's fixed order and the gradient is the transposed
    product: no scatter and no atomics on either pass.
    """
    if token_embeddings.ndim == 2:
        return aggregate_token_embeddings(
            token_embeddings[None], seg_ids[None], token_mask[None],
            num_segments=num_segments, mode=mode,
        )[0]
    t = token_embeddings.shape[1]
    valid = token_mask.to(torch.bool)
    segments = torch.arange(num_segments, device=seg_ids.device)
    member = (seg_ids.long()[:, None, :] == segments[None, :, None]) & valid[:, None, :]
    if mode == "mean":
        counts = member.sum(dim=2, keepdim=True).clamp_min(1)  # [B, S, 1]
        sums = torch.matmul(member.to(token_embeddings.dtype), token_embeddings)
        return sums / counts.to(sums.dtype)
    if mode == "first":
        pos = torch.arange(t, device=seg_ids.device)
        first = torch.where(member, pos, t).amin(dim=2, keepdim=True)  # [B, S, 1]
        return torch.matmul((pos == first).to(token_embeddings.dtype), token_embeddings)
    raise ValueError(f"mode must be 'mean' or 'first', got {mode!r}")


def sorted_segment_sum(values: torch.Tensor, ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """``out[s] = Σ values[i]`` over the rows ``i`` with ``ids[i] == s``,
    ``[num_segments, D]``: each segment's rows added one after the other in
    the order of a stable sort of ``ids``, so the result does not depend on
    how the card schedules the sum. ``values [N, D]``, ``ids [N]`` int64 in
    ``[0, num_segments)``. Reads nothing back from the device."""
    sorted_ids, order = torch.sort(ids, stable=True)
    bounds = torch.searchsorted(sorted_ids, torch.arange(num_segments + 1, device=ids.device))
    return torch.segment_reduce(values.index_select(0, order), "sum",
                                lengths=bounds.diff(), axis=0, unsafe=True)


class _Lookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, weight, ids):
        ctx.save_for_backward(ids)
        ctx.rows = weight.shape[0]
        return F.embedding(ids, weight)

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        d = grad.shape[-1]
        return sorted_segment_sum(grad.reshape(-1, d), ids.reshape(-1), ctx.rows), None


def embedding_lookup(weight: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``weight[ids]`` (``F.embedding``), whose gradient with respect to
    ``weight`` sums the rows of each id by :func:`sorted_segment_sum`: the
    library's backward sums an id's rows in an order that changes between
    runs on the card (an id repeated over a whole batch showed it)."""
    return _Lookup.apply(weight, ids.long())
