"""Box rasterization: the later-box-wins winner map and the BERTgrid
scatter (port of ``vibertgrid_tpu/ops/rasterize.py``).

Boxes are int ``(x0, y0, x1, y1)`` in image pixels; cell ``(y, x)`` of a
stride-``s`` grid is covered when ``y0//s <= y < y1//s`` and
``x0//s <= x < x1//s`` (floor division). Where boxes overlap, the one with
the highest index wins: the winner map is a masked maximum over covering
box indices. These functions are the plain version of the scatter kernel
(:mod:`vibertgrid_tpu_torch.ops.grid_scatter`). Each takes one image
(``boxes [S, 4]``) or a batch (``boxes [B, S, 4]``).
"""

from __future__ import annotations

import torch


def box_winner_map(
    boxes: torch.Tensor,
    box_mask: torch.Tensor,
    *,
    height: int,
    width: int,
    stride: int = 1,
    chunk: int = 32,
    values: torch.Tensor | None = None,
) -> torch.Tensor:
    """``[..., height, width]`` int32: 0 where no valid box covers the
    cell, else 1 + the index of the last covering valid box. Boxes are
    taken ``chunk`` at a time to bound the ``[chunk, H, W]`` working set.

    ``values`` (shaped as ``box_mask``) replaces the painted value
    ``s + 1`` of segment ``s``; it must be positive and strictly increasing
    in ``s`` for later-wins to hold under the maximum. Callers use it to
    carry a payload beside the index."""
    if boxes.ndim == 2:
        return box_winner_map(
            boxes[None], box_mask[None], height=height, width=width,
            stride=stride, chunk=chunk, values=None if values is None else values[None],
        )[0]
    b, s, _ = boxes.shape
    dev = boxes.device
    cells = torch.div(boxes.to(torch.int32), stride, rounding_mode="floor")
    x0, y0, x1, y1 = cells.unbind(-1)  # [B, S]
    valid = box_mask.to(torch.bool)
    rows = torch.arange(height, dtype=torch.int32, device=dev)
    cols = torch.arange(width, dtype=torch.int32, device=dev)
    if values is None:
        idx = torch.arange(1, s + 1, dtype=torch.int32, device=dev).expand(b, s)
    else:
        idx = values.to(torch.int32)
    winner = torch.zeros((b, height, width), dtype=torch.int32, device=dev)
    for lo in range(0, s, chunk):
        sl = slice(lo, lo + chunk)
        in_rows = (
            (rows >= y0[:, sl, None]) & (rows < y1[:, sl, None]) & valid[:, sl, None]
        )  # [B, C, H]
        rowv = torch.where(in_rows, idx[:, sl, None], 0)
        colm = ((cols >= x0[:, sl, None]) & (cols < x1[:, sl, None])).to(torch.int32)
        cwin = (rowv[:, :, :, None] * colm[:, :, None, :]).amax(dim=1)
        winner = torch.maximum(winner, cwin)
    return winner


def bertgrid_scatter(
    embeddings: torch.Tensor,
    boxes: torch.Tensor,
    box_mask: torch.Tensor,
    *,
    height: int,
    width: int,
    stride: int = 8,
) -> torch.Tensor:
    """Paint each segment's embedding ``[..., S, D]`` over its box:
    ``[..., height, width, D]``, zero where no box covers the cell."""
    if embeddings.ndim == 2:
        return bertgrid_scatter(
            embeddings[None], boxes[None], box_mask[None],
            height=height, width=width, stride=stride,
        )[0]
    winner = box_winner_map(boxes, box_mask, height=height, width=width, stride=stride)
    b, _, d = embeddings.shape
    emb0 = torch.cat([embeddings.new_zeros((b, 1, d)), embeddings], dim=1)
    batch = torch.arange(b, device=embeddings.device)[:, None, None]
    return emb0[batch, winner.long()]


def rasterize_label_maps(
    seg_classes: torch.Tensor,
    boxes: torch.Tensor,
    box_mask: torch.Tensor,
    *,
    height: int,
    width: int,
    chunk: int = 32,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-pixel training targets of the auxiliary segmentation head, at
    stride 1: ``(pos_neg, class_map)``, both ``[..., height, width]`` int32.

    - ``pos_neg``: 0 = background, 1 = key text (class > 0), 2 = other text;
    - ``class_map``: the winning segment's class id, 0 for background.

    The class rides beside the winning index as ``(s+1)·1024 + class``
    (monotone in ``s``, so later-wins still holds), which saves a
    full-resolution gather; class ids are clipped to the 10-bit field."""
    s = boxes.shape[-2]
    index = torch.arange(1, s + 1, dtype=torch.int32, device=boxes.device)
    encoded_vals = index * 1024 + seg_classes.to(torch.int32).clamp(0, 1023)
    encoded = box_winner_map(
        boxes, box_mask, height=height, width=width, stride=1, chunk=chunk,
        values=encoded_vals,
    )
    covered = encoded > 0
    class_map = torch.where(covered, encoded % 1024, 0).to(torch.int32)
    pos_neg = torch.where(covered, torch.where(class_map > 0, 1, 2), 0).to(torch.int32)
    return pos_neg, class_map
