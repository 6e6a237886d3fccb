"""Batched BERTgrid scatter (port of the forward of
``vibertgrid_tpu/ops/pallas_scatter.py::bertgrid_scatter_pallas``).

On a CUDA tensor :func:`grid_scatter` launches ``csrc/bertgrid_scatter.cu``
once for the whole batch; on a CPU tensor it runs the plain
:func:`vibertgrid_tpu_torch.ops.rasterize.bertgrid_scatter`. Both give the
same grid exactly: the kernel copies rows, it does no arithmetic.
"""

from __future__ import annotations

import torch

from vibertgrid_tpu_torch.ops import kernels
from vibertgrid_tpu_torch.ops.rasterize import bertgrid_scatter


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
    → grid ``[B, height, width, D]`` in the embeddings' dtype."""
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
    boxes = boxes.to(torch.int32).contiguous()
    mask = box_mask.to(torch.int32).contiguous()
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
