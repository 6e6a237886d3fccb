"""Batched BERTgrid scatter, forward and backward (port of
``vibertgrid_tpu/ops/pallas_scatter.py::bertgrid_scatter_pallas``).

:func:`grid_scatter` is differentiable in the embeddings. On CUDA tensors
its forward launches ``csrc/bertgrid_scatter.cu`` and its backward
``csrc/bertgrid_scatter_bwd.cu``, each once for the whole batch; on CPU
tensors they run :func:`vibertgrid_tpu_torch.ops.rasterize.bertgrid_scatter`
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


def _backward(d_out, boxes, box_mask, stride):
    if d_out.device.type == "cpu":
        return scatter_backward_reference(d_out, boxes, box_mask, stride=stride)
    d_out = d_out.contiguous()
    b, height, width, d = d_out.shape
    s = boxes.shape[1]
    boxes, mask = _prepare(boxes, box_mask)
    kernels.check_inputs("grid_scatter_bwd", d_out, boxes, mask)
    d_emb = torch.empty((b, s, d), dtype=d_out.dtype, device=d_out.device)
    lib = kernels.library()
    kernels.LAUNCHES["bertgrid_scatter_bwd"] += 1
    err = lib.vg_bertgrid_scatter_bwd(
        d_out.data_ptr(), boxes.data_ptr(), mask.data_ptr(), d_emb.data_ptr(),
        b, s, d, height, width, stride, kernels.dtype_code(d_out.dtype),
        torch.cuda.current_stream(d_out.device).cuda_stream,
    )
    kernels.check(err, "bertgrid_scatter_bwd")
    return d_emb


class _GridScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, embeddings, boxes, box_mask, height, width, stride):
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
