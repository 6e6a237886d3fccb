"""Auxiliary semantic segmentation heads (port of
``vibertgrid_tpu/models/seg_head.py``).

An encoder of two 3×3 conv + BatchNorm + ReLU and two 1×1 projections (a
3-way background / key / other mask and a C-way class map), all at stride 4:
1×1 convolutions commute with nearest upsampling, so only the few-channel
logits are upsampled 4× back to stride 1. Pixel labels are rasterised from
the segment boxes (:func:`vibertgrid_tpu_torch.ops.rasterize.rasterize_label_maps`)
and the losses run at cell cost through the ``*_pooled`` forms: either the
two-stage per-class binary classification gated on the predicted positive
mask (:class:`SemanticSegmentationHead`, with the full and CRF classifiers)
or a pair of multi-class losses (:class:`SimplifiedSemanticSegmentationHead`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from vibertgrid_tpu_torch.models.layers import conv, conv2d
from vibertgrid_tpu_torch.models.norm import BatchNorm
from vibertgrid_tpu_torch.ops.losses import (
    bce_ohem_pooled,
    cross_entropy_ohem_pooled,
    cross_entropy_random_sample_pooled,
)
from vibertgrid_tpu_torch.ops.rasterize import rasterize_label_maps
from vibertgrid_tpu_torch.parallel.collectives import all_max


def _upsample_nearest(x: torch.Tensor, scale: int) -> torch.Tensor:
    """``[B, h, w, C]`` → ``[B, h·scale, w·scale, C]``."""
    return x.repeat_interleave(scale, dim=1).repeat_interleave(scale, dim=2)


class SegEncoder(nn.Module):
    """Shared encoder and projections: ``forward(p_fuse [B, h, w, C], train)``
    → fp32 ``(mask_logits [B, h, w, 3], class_logits [B, h, w, classes])``."""

    def __init__(self, channels: int, num_classes: int, *, dtype, device, generator):
        super().__init__()
        self.dtype = dtype
        kw = dict(device=device, generator=generator)
        self.conv1 = conv2d(channels, channels, 3, **kw)
        self.bn1 = BatchNorm(channels, dtype=dtype, device=device)
        self.conv2 = conv2d(channels, channels, 3, **kw)
        self.bn2 = BatchNorm(channels, dtype=dtype, device=device)
        self.mask_proj = conv2d(channels, 3, 1, bias=True, **kw)
        self.class_proj = conv2d(channels, num_classes, 1, bias=True, **kw)

    def forward(self, p_fuse, train: bool = False):
        dt = self.dtype
        x = p_fuse.permute(0, 3, 1, 2).to(dt)  # channels_last NCHW view
        x = F.relu(self.bn1(conv(x, self.conv1, dt), train))
        x = F.relu(self.bn2(conv(x, self.conv2, dt), train))
        nhwc = lambda y: y.permute(0, 2, 3, 1).float()
        return nhwc(conv(x, self.mask_proj, dt)), nhwc(conv(x, self.class_proj, dt))


class SemanticSegmentationHead(nn.Module):
    """Two-stage variant: a randomly sampled CE on the 3-way mask, then one
    binary OHEM loss per class over the pixels the mask predicts positive,
    from a bank of C−1 binary classifiers (one 1×1 conv) on the class map.

    ``forward(p_fuse, seg_classes, boxes, box_mask, train, seeds)`` →
    ``(loss, mask_logits [B, H, W, 3], class_logits [B, H, W, C])`` at stride
    1; ``seeds``: C ints, one for the random sample and one per class
    (unused unless the OHEM pre-samples)."""

    def __init__(self, channels: int, num_classes: int, *, loss_1_sample_list=None,
                 num_hard_positive: int = -1, num_hard_negative: int = -1,
                 loss_weights=None, dtype, device, generator):
        super().__init__()
        self.dtype = dtype
        self.num_classes = num_classes
        self.loss_1_sample_list = loss_1_sample_list
        self.ohem = dict(num_hard_positive=num_hard_positive,
                         num_hard_negative=num_hard_negative)
        kw = dict(device=device, generator=generator)
        self.encoder = SegEncoder(channels, num_classes, dtype=dtype, **kw)
        self.binary_bank = conv2d(num_classes, num_classes - 1, 1, bias=True, **kw)

    def forward(self, p_fuse, seg_classes, boxes, box_mask, *, train: bool = False,
                seeds=None):
        _, h4, w4, _ = p_fuse.shape
        if seeds is None:
            seeds = (0,) * self.num_classes
        mask_logits4, class_logits4 = self.encoder(p_fuse, train)
        bin_logits4 = conv(class_logits4.permute(0, 3, 1, 2), self.binary_bank,
                           self.dtype).float()  # [B, C-1, h, w]
        pos_neg, class_map = rasterize_label_maps(
            seg_classes, boxes, box_mask, height=h4 * 4, width=w4 * 4)
        loss1 = cross_entropy_random_sample_pooled(
            mask_logits4, pos_neg, block=4, sample_list=self.loss_1_sample_list, seed=seeds[0])
        # argmax of upsampled logits == upsample of the cell argmax
        pred_pos4 = mask_logits4.argmax(dim=-1) == 1  # [B, h, w]
        gated = _upsample_nearest(pred_pos4[..., None], 4)[..., 0]
        loss2 = 0.0
        for ci in range(self.num_classes - 1):
            loss2 = loss2 + bce_ohem_pooled(bin_logits4[:, ci], class_map == ci + 1, gated,
                                            block=4, seed=seeds[1 + ci], **self.ohem)
        # the class losses count where any pixel of the (global) batch is positive
        loss = loss1 + all_max(pred_pos4.any().float()) * loss2
        return loss, _upsample_nearest(mask_logits4, 4), _upsample_nearest(class_logits4, 4)


class SimplifiedSemanticSegmentationHead(nn.Module):
    """Two multi-class pixel losses: a randomly sampled CE on the 3-way mask
    and an OHEM CE on the class map.

    ``forward(p_fuse, seg_classes, boxes, box_mask, train, seeds)`` →
    ``(loss, mask_logits [B, H, W, 3], class_logits [B, H, W, C])`` at stride
    1; ``seeds``: two ints, for the random sample and (unused unless the OHEM
    pre-samples) the OHEM loss."""

    def __init__(self, channels: int, num_classes: int, *, loss_1_sample_list=None,
                 num_hard_positive: int = -1, num_hard_negative: int = -1,
                 loss_weights=None, dtype, device, generator):
        super().__init__()
        self.loss_1_sample_list = loss_1_sample_list
        self.ohem = dict(num_hard_positive=num_hard_positive,
                         num_hard_negative=num_hard_negative, weight=loss_weights)
        self.encoder = SegEncoder(channels, num_classes, dtype=dtype, device=device,
                                  generator=generator)

    def forward(self, p_fuse, seg_classes, boxes, box_mask, *, train: bool = False,
                seeds=(0, 0)):
        _, h4, w4, _ = p_fuse.shape
        mask_logits4, class_logits4 = self.encoder(p_fuse, train)
        pos_neg, class_map = rasterize_label_maps(
            seg_classes, boxes, box_mask, height=h4 * 4, width=w4 * 4)
        loss1 = cross_entropy_random_sample_pooled(
            mask_logits4, pos_neg, block=4, sample_list=self.loss_1_sample_list, seed=seeds[0])
        loss2 = cross_entropy_ohem_pooled(
            class_logits4, class_map, block=4, seed=seeds[1], **self.ohem)
        return (loss1 + loss2, _upsample_nearest(mask_logits4, 4),
                _upsample_nearest(class_logits4, 4))
