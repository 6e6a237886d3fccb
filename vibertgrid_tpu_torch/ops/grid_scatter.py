"""Batched BERTgrid scatter, forward and backward (port of
``vibertgrid_tpu/ops/pallas_scatter.py::bertgrid_scatter_pallas``).

:func:`grid_scatter` is differentiable in the embeddings. On CUDA tensors
its forward launches ``csrc/bertgrid_scatter.cu`` once for the whole batch
and its backward ``csrc/bertgrid_scatter_bwd.cu``, whose call is two
launches: one lists each image's cells by winning segment
(:func:`winner_cells` is its plain version), the other sums fixed-size
pieces of those lists (:func:`scatter_backward_pieces` adds in its order).
On CPU tensors they run :func:`vibertgrid_tpu_torch.ops.rasterize.bertgrid_scatter`
and :func:`scatter_backward_reference`. The forward copies rows, so kernel and
twin agree exactly; the backward sums rows in fp32 and agrees to summation
order.
"""

from __future__ import annotations

import torch

from vibertgrid_tpu_torch.ops import kernels
from vibertgrid_tpu_torch.ops.rasterize import bertgrid_scatter, box_winner_map


def scatter_backward_reference(d_out, boxes, box_mask, *, stride: int = 8):
    """Plain twin of the backward kernel: ``d_emb[b, s]`` is the fp32 sum of
    ``d_out[b, cell]`` over the cells segment ``s`` won, cast to d_out's
    dtype. d_out ``[B, height, width, D]`` → ``[B, S, D]``."""
    b, height, width, d = d_out.shape
    s = boxes.shape[1]
    winner = box_winner_map(boxes, box_mask, height=height, width=width, stride=stride)
    index = winner.reshape(b, -1).long() + (s + 1) * torch.arange(
        b, device=d_out.device)[:, None]
    acc = torch.zeros((b * (s + 1), d), dtype=torch.float32, device=d_out.device)
    acc.index_add_(0, index.reshape(-1), d_out.reshape(-1, d).float())
    return acc.reshape(b, s + 1, d)[:, 1:].to(d_out.dtype)  # row 0: cells nobody won


# Cells of an image's won-cell list that one block of the backward kernel's
# second launch sums (kPiece in csrc/bertgrid_scatter_bwd.cu).
PIECE = 32


def winner_cells(boxes, box_mask, *, height: int, width: int, stride: int = 8):
    """Each image's grid cells listed by the segment that wins them: the
    plain version of the backward kernel's first launch, which agrees bit for
    bit. Returns ``(offsets [B, S + 2], cells [B, height·width])``, both
    int32: segment ``s`` won ``cells[b, offsets[b, s]:offsets[b, s + 1]]``,
    in ascending order, and the cells nobody won follow from
    ``offsets[b, S]`` to ``offsets[b, S + 1] = height·width``."""
    b, s = box_mask.shape
    winner = box_winner_map(boxes, box_mask, height=height, width=width, stride=stride)
    key = winner.reshape(b, -1).long() - 1
    key = torch.where(key < 0, s, key)  # the cells nobody won sort last
    cells = torch.sort(key, dim=1, stable=True).indices.to(torch.int32)
    counts = torch.zeros((b, s + 1), dtype=torch.int64, device=key.device)
    counts.scatter_add_(1, key, torch.ones_like(key))
    offsets = torch.cat([counts.new_zeros((b, 1)), counts.cumsum(dim=1)], dim=1)
    return offsets.to(torch.int32), cells


def scatter_backward_pieces(d_out, boxes, box_mask, *, stride: int = 8, piece: int = PIECE):
    """:func:`scatter_backward_reference` added up in the backward kernel's
    order, which it matches bit for bit at ``piece = PIECE``: each image's
    won-cell list (:func:`winner_cells`) is cut into pieces of ``piece``
    cells; in each piece every run of one segment is summed in fp32 from 0,
    row after row; a segment that crosses pieces is the sum of its runs'
    partials in piece order. Slow (a Python loop over runs): for tests and
    checks at small sizes."""
    b, height, width, d = d_out.shape
    s = boxes.shape[1]
    offsets, cells = (t.tolist() for t in winner_cells(
        boxes, box_mask, height=height, width=width, stride=stride))
    rows = d_out.reshape(b, height * width, d).float()
    d_emb = torch.zeros((b, s, d), dtype=torch.float32, device=d_out.device)
    zero = torch.zeros(d, dtype=torch.float32, device=d_out.device)
    for i in range(b):
        for seg in range(s):
            lo, hi = offsets[i][seg], offsets[i][seg + 1]
            parts = []  # the segment's run in each piece it reaches
            for p0 in range(lo - lo % piece, hi, piece):
                part = zero
                for pos in range(max(lo, p0), min(hi, p0 + piece)):
                    part = part + rows[i, cells[i][pos]]
                parts.append(part)
            if len(parts) == 1:
                d_emb[i, seg] = parts[0]
            elif parts:
                total = zero
                for part in parts:
                    total = total + part
                d_emb[i, seg] = total
    return d_emb.to(d_out.dtype)


def _prepare(boxes, box_mask):
    return boxes.to(torch.int32).contiguous(), box_mask.to(torch.int32).contiguous()


def _forward(embeddings, boxes, box_mask, height, width, stride):
    if embeddings.device.type == "cpu":
        return bertgrid_scatter(
            embeddings, boxes, box_mask, height=height, width=width, stride=stride
        )
    if embeddings.device.type != "cuda":
        raise ValueError(f"grid_scatter: unsupported device {embeddings.device}")
    b, s, d = embeddings.shape
    if boxes.shape != (b, s, 4) or box_mask.shape != (b, s):
        raise ValueError(f"boxes must be [B, S, 4] and mask [B, S]: {boxes.shape} {box_mask.shape}")
    if embeddings.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"grid_scatter takes float32 or bfloat16, got {embeddings.dtype}")
    boxes, mask = _prepare(boxes, box_mask)
    kernels.check_inputs("grid_scatter", embeddings, boxes, mask)
    out = torch.empty((b, height, width, d), dtype=embeddings.dtype, device=embeddings.device)
    lib = kernels.library()
    kernels.LAUNCHES["bertgrid_scatter"] += 1
    err = lib.vg_bertgrid_scatter(
        embeddings.data_ptr(), boxes.data_ptr(), mask.data_ptr(), out.data_ptr(),
        b, s, d * embeddings.element_size(), height, width, stride,
        torch.cuda.current_stream(embeddings.device).cuda_stream,
    )
    kernels.check(err, "bertgrid_scatter")
    return out


def _backward(d_out, boxes, box_mask, stride, lists=None):
    """``d_emb`` from the kernel (CUDA) or the twin (CPU). The kernel's cell
    list goes into ``lists = (offsets, cells)`` if given (so a check can read
    it; shaped as :func:`winner_cells` returns them), else into transient
    scratch, beside the partials and counters of its second launch."""
    if d_out.device.type == "cpu":
        return scatter_backward_reference(d_out, boxes, box_mask, stride=stride)
    d_out = d_out.contiguous()
    b, height, width, d = d_out.shape
    s = boxes.shape[1]
    boxes, mask = _prepare(boxes, box_mask)
    dev = d_out.device
    if lists is None:
        lists = (torch.empty((b, s + 2), dtype=torch.int32, device=dev),
                 torch.empty((b, height * width), dtype=torch.int32, device=dev))
    offsets, cells = lists
    if offsets.shape != (b, s + 2) or cells.shape != (b, height * width) or any(
            t.dtype != torch.int32 for t in lists):
        raise ValueError(f"lists must be int32 [{b}, {s + 2}] and [{b}, {height * width}]")
    pieces = (height * width + PIECE - 1) // PIECE
    partials = torch.empty((b, pieces, 2, d), dtype=torch.float32, device=dev)
    counters = torch.empty((b, s), dtype=torch.int32, device=dev)
    kernels.check_inputs("grid_scatter_bwd", d_out, boxes, mask, offsets, cells, partials,
                         counters)
    d_emb = torch.empty((b, s, d), dtype=d_out.dtype, device=dev)
    lib = kernels.library()
    kernels.LAUNCHES["bertgrid_scatter_bwd"] += 1
    err = lib.vg_bertgrid_scatter_bwd(
        d_out.data_ptr(), boxes.data_ptr(), mask.data_ptr(), d_emb.data_ptr(),
        cells.data_ptr(), offsets.data_ptr(), partials.data_ptr(), counters.data_ptr(),
        b, s, d, height, width, stride, PIECE, kernels.dtype_code(d_out.dtype),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    kernels.check(err, "bertgrid_scatter_bwd")
    return d_emb


class _GridScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, embeddings, boxes, box_mask, height, width, stride):
        # int32 as both kernels take them, so the backward converts nothing
        boxes, box_mask = _prepare(boxes, box_mask)
        ctx.save_for_backward(boxes, box_mask)
        ctx.stride = stride
        return _forward(embeddings.contiguous(), boxes, box_mask, height, width, stride)

    @staticmethod
    def backward(ctx, d_out):
        boxes, box_mask = ctx.saved_tensors
        return _backward(d_out, boxes, box_mask, ctx.stride), None, None, None, None, None


def grid_scatter(
    embeddings: torch.Tensor,
    boxes: torch.Tensor,
    box_mask: torch.Tensor,
    *,
    height: int,
    width: int,
    stride: int = 8,
) -> torch.Tensor:
    """embeddings ``[B, S, D]``, boxes ``[B, S, 4]`` int, mask ``[B, S]``
    → grid ``[B, height, width, D]`` in the embeddings' dtype; the gradient
    goes to the embeddings only."""
    return _GridScatter.apply(embeddings, boxes, box_mask, height, width, stride)
