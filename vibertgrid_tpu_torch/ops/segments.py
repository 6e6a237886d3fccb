"""Token → segment embedding aggregation (port of
``vibertgrid_tpu/ops/segments.py``)."""

from __future__ import annotations

import torch


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
    are zero. Masked tokens go to an overflow bucket ``S`` that is dropped.
    """
    if token_embeddings.ndim == 2:
        return aggregate_token_embeddings(
            token_embeddings[None], seg_ids[None], token_mask[None],
            num_segments=num_segments, mode=mode,
        )[0]
    b, t, d = token_embeddings.shape
    valid = token_mask.to(torch.bool)
    ids = torch.where(valid, seg_ids.long(), num_segments)  # [B, T]
    if mode == "mean":
        emb = torch.where(valid[..., None], token_embeddings, 0)
        sums = emb.new_zeros((b, num_segments + 1, d))
        sums.scatter_add_(1, ids[..., None].expand(b, t, d), emb)
        counts = emb.new_zeros((b, num_segments + 1))
        counts.scatter_add_(1, ids, valid.to(emb.dtype))
        return sums[:, :-1] / counts[:, :-1].clamp_min(1)[..., None]
    if mode == "first":
        pos = torch.arange(t, device=ids.device).expand(b, t)
        first = torch.full((b, num_segments + 1), t, dtype=torch.long, device=ids.device)
        first.scatter_reduce_(1, ids, torch.where(valid, pos, t), reduce="amin")
        first = first[:, :-1]
        gathered = torch.gather(
            token_embeddings, 1, first.clamp_max(t - 1)[..., None].expand(b, num_segments, d)
        )
        return torch.where((first < t)[..., None], gathered, 0)
    raise ValueError(f"mode must be 'mean' or 'first', got {mode!r}")
