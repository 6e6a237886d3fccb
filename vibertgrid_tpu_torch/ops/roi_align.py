"""RoIAlign with torchvision semantics (aligned=False) as two dense
contractions (port of ``vibertgrid_tpu/ops/roi_align.py``).

Bilinear sampling plus in-bin averaging is separable: each RoI's pooled
output is ``Wy · F · Wxᵀ`` with ``Wy [P, Hf]`` and ``Wx [P, Wf]`` holding
the summed tap weights of every sample (adaptive ``ceil(roi/pooled)``
sampling, samples outside ``[-1, size]`` dropped but counted, clamping and
the degenerate high edge as torchvision). The weights are built dense and
both stages are ``torch.einsum``s. The JAX package has no kernel here.
"""

from __future__ import annotations

import torch


def _dense_axis_weights(starts, bins, grids, grid_cap: int, size: int):
    """Dense 1-D pooling weights ``[B, S, P, size]``.

    starts ``[B, S, P]`` and bins ``[B, S]`` are the bin geometry in feature
    pixels; grids ``[B, S]`` the samples per bin (already clamped to
    ``grid_cap``)."""
    dev = starts.device
    i = torch.arange(grid_cap, dtype=torch.float32, device=dev)
    sample_valid = i < grids[..., None].float()  # [B, S, G]
    coord = starts[..., None] + (i + 0.5) * bins[..., None, None] / grids.clamp_min(1)[
        ..., None, None
    ].float()  # [B, S, P, G]
    in_range = (coord >= -1.0) & (coord <= size)
    c = coord.clamp_min(0.0)
    low = torch.floor(c).to(torch.int64)
    degen = low >= size - 1
    low = torch.where(degen, size - 1, low)
    frac = torch.where(degen, 0.0, c - low.float())
    high = (low + 1).clamp_max(size - 1)
    keep = (sample_valid[:, :, None, :] & in_range).float()
    w_low = (1.0 - frac) * keep
    w_high = frac * keep
    axis = torch.arange(size, device=dev)
    w = torch.zeros(starts.shape + (size,), dtype=torch.float32, device=dev)
    for g in range(grid_cap):
        w = w + torch.where(axis == low[..., g : g + 1], w_low[..., g : g + 1], 0.0)
        w = w + torch.where(axis == high[..., g : g + 1], w_high[..., g : g + 1], 0.0)
    return w


def roi_align(
    features: torch.Tensor,
    rois: torch.Tensor,
    roi_mask: torch.Tensor,
    *,
    output_size: int = 7,
    spatial_scale: float = 0.25,
    sampling_ratio: int = -1,
    max_grid_h: int = 8,
    max_grid_w: int = 16,
) -> torch.Tensor:
    """Pool ``features [B, Hf, Wf, C]`` (NHWC) over ``rois [B, S, 4]``
    ``(x0, y0, x1, y1)`` image pixels → ``[B, S, P, P, C]`` in the features'
    dtype, accumulated in fp32. Padding RoIs (``roi_mask`` False) give zeros.
    """
    b, hf, wf, c = features.shape
    p = output_size
    box = rois.float() * spatial_scale
    x0, y0, x1, y1 = box.unbind(-1)  # [B, S]
    roi_w = (x1 - x0).clamp_min(1.0)
    roi_h = (y1 - y0).clamp_min(1.0)
    # Divided by a tensor: CUDA divides by a Python scalar as a product with
    # its reciprocal, one ulp off, and ceil() below then takes one sample
    # more where a bin is a whole number of feature pixels (3, 5, 6, 7, ...).
    pooled = torch.full_like(roi_w, float(p))
    bin_w = roi_w / pooled
    bin_h = roi_h / pooled
    if sampling_ratio > 0:
        gh = torch.full_like(x0, min(sampling_ratio, max_grid_h), dtype=torch.int32)
        gw = torch.full_like(x0, min(sampling_ratio, max_grid_w), dtype=torch.int32)
    else:
        gh = torch.ceil(bin_h).to(torch.int32).clamp(1, max_grid_h)
        gw = torch.ceil(bin_w).to(torch.int32).clamp(1, max_grid_w)
    count = (gh * gw).float()
    pr = torch.arange(p, dtype=torch.float32, device=features.device)
    y_starts = y0[..., None] + pr * bin_h[..., None]  # [B, S, P]
    x_starts = x0[..., None] + pr * bin_w[..., None]
    wy = _dense_axis_weights(y_starts, bin_h, gh, max_grid_h, hf)  # [B, S, P, Hf]
    wx = _dense_axis_weights(x_starts, bin_w, gw, max_grid_w, wf)  # [B, S, P, Wf]
    scale_r = torch.where(roi_mask.to(torch.bool), 1.0 / count, 0.0)
    wy = (wy * scale_r[..., None, None]).to(features.dtype)
    wx = wx.to(features.dtype)
    # Stage 1 over rows: [B, S·P, Hf] @ [B, Hf, Wf·C]. At the flagship
    # (B=16, S=128, P=7, Wf=96, C=256) this [B, S, P, Wf, C] intermediate
    # holds 0.7 G elements, 1.41 GB in fp32 or half that in bf16: it fits
    # the card's 80 GB, so it is kept rather than tiled.
    fy = torch.einsum("bsph,bhwc->bspwc", wy, features)
    # Stage 2 over columns: [B, S, Q, Wf] x [B, S, P, Wf, C] → [B, S, P, Q, C].
    return torch.einsum("bsqw,bspwc->bspqc", wx, fy)
