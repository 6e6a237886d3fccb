"""ResNet-FPN backbone with BERTgrid early fusion (port of
``vibertgrid_tpu/models/resnet_fpn.py``).

The public interface keeps the JAX layouts: images ``[B, H, W, 3]`` and the
BERTgrid ``[B, H/8, W/8, Dg]`` in, P_fuse ``[B, H/4, W/4, 256]`` out, all
NHWC. Inside, tensors are logical NCHW in ``channels_last`` memory, which is
the same bytes as NHWC, so the permutes at the edges copy nothing. The
convolutions are cuDNN's, as the JAX package left them to XLA.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from vibertgrid_tpu_torch.device import resolve_device
from vibertgrid_tpu_torch.models.layers import assign, conv, conv2d
from vibertgrid_tpu_torch.models.norm import BatchNorm

# Registry mirroring the reference's model/ViBERTgrid_net.py:282-316.
BACKBONE_REGISTRY = {
    "resnet_18_fpn": dict(size_list=(2, 2, 2, 2), d_variant=False, fusion_bias=True),
    "resnet_34_fpn": dict(size_list=(3, 4, 6, 3), d_variant=False, fusion_bias=True),
    "resnet_18_fpn_pretrained": dict(size_list=(2, 2, 2, 2), d_variant=False, fusion_bias=False),
    "resnet_34_fpn_pretrained": dict(size_list=(3, 4, 6, 3), d_variant=False, fusion_bias=False),
    "resnet_18_D_fpn": dict(size_list=(2, 2, 2, 2), d_variant=True, fusion_bias=True),
    "resnet_34_D_fpn": dict(size_list=(3, 4, 6, 3), d_variant=True, fusion_bias=True),
}


def _up(x, scale: int):
    """Nearest upsampling by an integer ``scale`` of a ``channels_last``
    NCHW map, as a broadcast of its NHWC view (the JAX package's ``repeat``;
    the result keeps the layout): its gradient is a reduction over each
    pixel's copies, in an order fixed by the shapes."""
    if scale == 1:
        return x
    n, c, h, w = x.shape
    nhwc = x.permute(0, 2, 3, 1)[:, :, None, :, None, :].expand(n, h, scale, w, scale, c)
    return nhwc.reshape(n, h * scale, w * scale, c).permute(0, 3, 1, 2)


class ResBlock(nn.Module):
    """Basic block; with ``downsample`` the shortcut is a stride-2 1×1 conv,
    or in the D-variant a 2×2 average pool then a 1×1 conv."""

    def __init__(self, in_c: int, out_c: int, *, downsample: bool = False,
                 d_variant: bool = False, dtype, device, generator):
        super().__init__()
        self.dtype = dtype
        self.downsample = downsample
        self.d_variant = d_variant
        kw = dict(device=device, generator=generator)
        stride = 2 if downsample else 1
        self.conv1 = conv2d(in_c, out_c, 3, stride=stride, **kw)
        self.bn1 = BatchNorm(out_c, dtype=dtype, device=device)
        self.conv2 = conv2d(out_c, out_c, 3, **kw)
        self.bn2 = BatchNorm(out_c, dtype=dtype, device=device)
        if downsample:
            self.shortcut_conv = conv2d(in_c, out_c, 1, stride=1 if d_variant else 2, **kw)
            self.shortcut_bn = BatchNorm(out_c, dtype=dtype, device=device)

    def forward(self, x, train: bool = False):
        dt = self.dtype
        h = F.relu(self.bn1(conv(x, self.conv1, dt), train))
        h = self.bn2(conv(h, self.conv2, dt), train)
        if self.downsample:
            sc = F.avg_pool2d(x, 2, 2) if self.d_variant else x
            sc = self.shortcut_bn(conv(sc, self.shortcut_conv, dt), train)
        else:
            sc = x
        return F.relu(h + sc)


class ResNetFPN(nn.Module):
    """stem → 4 stages (early fusion after stage 3's first block) → FPN →
    P_fuse. ``forward(images [B,H,W,3], grid [B,H/8,W/8,Dg], train)`` →
    ``[B, H/4, W/4, fuse_channels]``; ``train`` selects batch statistics in
    the BatchNorms."""

    def __init__(self, size_list: Sequence[int], *, grid_channels: int = 768,
                 d_variant: bool = False, pyramid_channels: int = 256,
                 fuse_channels: int = 256, fusion_bias: bool = True,
                 dtype=torch.float32, device="cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        self.dtype = dtype
        self.size_list = tuple(size_list)
        kw = dict(device=device, generator=generator)
        block = lambda i, o, ds=False: ResBlock(
            i, o, downsample=ds, d_variant=d_variant, dtype=dtype, **kw
        )
        pc = pyramid_channels
        self.stem_conv = conv2d(3, 64, 7, stride=2, **kw)
        self.stem_bn = BatchNorm(64, dtype=dtype, device=device)
        stages = [("stage2", 64, 64, False), ("stage3", 64, 128, True),
                  ("stage4", 128, 256, True), ("stage5", 256, 512, True)]
        for (name, c_in, c_out, ds), n in zip(stages, self.size_list):
            for i in range(n):
                self.add_module(
                    f"{name}_block{i}", block(c_in if i == 0 else c_out, c_out, ds and i == 0)
                )
        self.early_fusion = conv2d(128 + grid_channels, 128, 1, bias=fusion_bias, **kw)
        self.conv6 = conv2d(512, pc, 1, **kw)
        for i, c_skip in zip((1, 2, 3), (256, 128, 64)):
            self.add_module(f"skip{i}", conv2d(c_skip, pc, 1, **kw))
            self.add_module(f"merge{i}", conv2d(pc, pc, 3, **kw))
        # P_fuse: one 1×1 kernel over the four levels' channels, applied
        # level by level (see forward).
        self.fuse = conv2d(4 * pc, fuse_channels, 1, **kw)

    def _stage(self, x, name: str, n: int, train: bool, first: int = 0):
        for i in range(first, n):
            x = getattr(self, f"{name}_block{i}")(x, train)
        return x

    def forward(self, images, grid, train: bool = False):
        dt = self.dtype
        n2, n3, n4, n5 = self.size_list
        x = images.permute(0, 3, 1, 2).to(dt)  # channels_last NCHW view
        x = F.relu(self.stem_bn(conv(x, self.stem_conv, dt), train))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        x1 = self._stage(x, "stage2", n2, train)  # stride 4
        x2 = self.stage3_block0(x1, train)
        x2 = torch.cat([x2, grid.permute(0, 3, 1, 2).to(x2.dtype)], dim=1)
        x2 = conv(x2, self.early_fusion, dt)
        x2 = self._stage(x2, "stage3", n3, train, first=1)  # stride 8
        x3 = self._stage(x2, "stage4", n4, train)  # stride 16
        x4 = conv(self._stage(x3, "stage5", n5, train), self.conv6, dt)  # stride 32
        x5 = conv(_up(x4, 2) + conv(x3, self.skip1, dt), self.merge1, dt)
        x6 = conv(_up(x5, 2) + conv(x2, self.skip2, dt), self.merge2, dt)
        x7 = conv(_up(x6, 2) + conv(x1, self.skip3, dt), self.merge3, dt)
        # P_fuse = 1×1 conv of concat(up8(x4), up4(x5), up2(x6), x7). Nearest
        # upsampling commutes with a pointwise conv, so each level is
        # projected at its own resolution by its slice of the kernel and
        # the partial sums are accumulated coarse to fine, as the JAX
        # package's _SplitPointwise does (same parameters, same math).
        w = self.fuse.weight.to(dt)
        out, lo = None, 0
        for level, scale in ((x4, 8), (x5, 4), (x6, 2), (x7, 1)):
            c = level.shape[1]
            y = F.conv2d(level, w[:, lo : lo + c])
            lo += c
            out = y if out is None else _up(out, 2) + y
        return out.permute(0, 2, 3, 1)  # NHWC


def load_torchvision_resnet(backbone: ResNetFPN, state_dict) -> None:
    """Copy a local torchvision resnet18/34 state dict (torch tensors or numpy
    arrays) into the backbone's stem and four stages in place: convolutions,
    BatchNorm parameters and running statistics. The FPN and the fusion layers
    keep their initialisation. A shape mismatch raises ``ValueError``."""

    def copy_conv(ours: str, theirs: str):
        assign(backbone.get_parameter(f"{ours}.weight"), state_dict[f"{theirs}.weight"], theirs)

    def copy_bn(ours: str, theirs: str):
        for leaf in ("weight", "bias"):
            assign(backbone.get_parameter(f"{ours}.{leaf}"), state_dict[f"{theirs}.{leaf}"],
                   theirs)
        for leaf in ("running_mean", "running_var"):
            assign(backbone.get_buffer(f"{ours}.{leaf}"), state_dict[f"{theirs}.{leaf}"], theirs)

    copy_conv("stem_conv", "conv1")
    copy_bn("stem_bn", "bn1")
    for si, (stage, n_blocks) in enumerate(zip(("stage2", "stage3", "stage4", "stage5"),
                                               backbone.size_list)):
        for i in range(n_blocks):
            ours, theirs = f"{stage}_block{i}", f"layer{si + 1}.{i}"
            copy_conv(f"{ours}.conv1", f"{theirs}.conv1")
            copy_bn(f"{ours}.bn1", f"{theirs}.bn1")
            copy_conv(f"{ours}.conv2", f"{theirs}.conv2")
            copy_bn(f"{ours}.bn2", f"{theirs}.bn2")
            if f"{theirs}.downsample.0.weight" in state_dict:
                copy_conv(f"{ours}.shortcut_conv", f"{theirs}.downsample.0")
                copy_bn(f"{ours}.shortcut_bn", f"{theirs}.downsample.1")


def load_pretrained_backbone(model: nn.Module, state_dict) -> None:
    """:func:`load_torchvision_resnet` into the ``backbone`` of a whole
    :class:`~vibertgrid_tpu_torch.models.vibertgrid.ViBERTgridNet`."""
    load_torchvision_resnet(model.backbone, state_dict)
