"""Operations and bytes, worked out from a configuration and the shapes of a
call: the yardstick that the rooflines and the MFU readers divide by. It
counts the work that the model and each kernel's contract need, whatever
implements them, and takes nothing from the program.

Model FLOPs of a forward (one multiply-add is 2 operations):

- the text encoder: its file under ``benchmark/harness/encoders/``, named by
  the configuration's ``model.text_encoder``, which also counts its kernels;
- every convolution of the ResNet trunk, the BERTgrid early fusion, the FPN
  and the P_fuse projection, at the canvas size;
- the RoI head (two 3x3 convolutions on each 7x7 RoI and its linear layer),
  the late fusion's linear layer and the field-type head;
- with the losses (training), the segmentation head's convolutions and the
  simplified head's pos/neg classifier.

Left out as no model FLOPs: the segment mean, the BERTgrid scatter, RoIAlign's
sampling, normalisation and elementwise passes. A train step counts three
forwards.

A kernel's bound is the larger of its operations over the bf16 peak and its
bytes over the memory bandwidth, each input read once and each output
written once (``benchmark/peaks.json``).
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF16, F32 = 2, 4


def peaks() -> dict:
    with open(os.path.join(HERE, "peaks.json")) as f:
        return json.load(f)


@dataclasses.dataclass(frozen=True)
class Shape:
    """The batch of one ``ViBERTgridNet.forward`` call."""

    b: int          # documents, padding rows included
    h: int          # canvas height, pixels
    w: int          # canvas width
    tokens: int     # token positions a document, padding included
    window: int     # tokens a window (the configuration's ``window_tokens``)
    s: int          # segment slots a document
    train: bool = False


@dataclasses.dataclass(frozen=True)
class Model:
    """The sizes the counts read, from a configuration file's ``model``."""

    text_encoder: str       # the file of benchmark/harness/encoders/
    encoder: object         # that file's sizes(model)
    blocks: tuple           # ResNet basic blocks of stages 2-5
    classes: int
    head: str               # "simp" | "full"
    roi: int = 7
    pyramid: int = 256
    fusion: int = 1024

    @staticmethod
    def of(config: dict) -> "Model":
        m = config["model"]
        return Model(text_encoder=m["text_encoder"],
                     encoder=encoder_of(m["text_encoder"]).sizes(m),
                     blocks=tuple(m["resnet_blocks"]), classes=m["num_classes"],
                     head=m["classifier_mode"], roi=m.get("roi_shape", 7),
                     fusion=m.get("late_fusion_fuse_embedding_channel", 1024))

    @property
    def width(self) -> int:
        """The token states' width: the BERTgrid's channels."""
        return self.encoder.width


def encoder_of(name: str):
    """The counts of the text encoder ``name``."""
    return importlib.import_module("benchmark.harness.encoders." + name)


def _conv(b, h, w, c_out, c_in, k):
    return 2 * b * h * w * c_out * c_in * k * k


def encoder_flops(m: Model, x: Shape) -> float:
    return encoder_of(m.text_encoder).forward_flops(m, x)


def backbone_flops(m: Model, x: Shape) -> float:
    b, h, w = x.b, x.h, x.w
    total = _conv(b, h // 2, w // 2, 64, 3, 7)  # stem
    widths = (64, 128, 256, 512)
    c_in = 64
    for stage, (c, n) in enumerate(zip(widths, m.blocks)):
        r = 4 << stage  # stride of the stage's output
        hh, ww = h // r, w // r
        for i in range(n):
            first = c_in if i == 0 else c
            total += _conv(b, hh, ww, c, first, 3) + _conv(b, hh, ww, c, c, 3)
            if i == 0 and first != c:  # the shortcut's 1x1 projection
                total += _conv(b, hh, ww, c, first, 1)
            if stage == 1 and i == 0:  # early fusion after stage 3's first block
                total += _conv(b, hh, ww, 128, 128 + m.width, 1)
        c_in = c
    p = m.pyramid
    total += _conv(b, h // 32, w // 32, p, 512, 1)  # conv6
    for r, c in ((16, 256), (8, 128), (4, 64)):  # skips and merges
        total += _conv(b, h // r, w // r, p, c, 1) + _conv(b, h // r, w // r, p, p, 3)
    for r in (32, 16, 8, 4):  # P_fuse, one slice of its kernel a level
        total += _conv(b, h // r, w // r, p, p, 1)
    return total


def head_flops(m: Model, x: Shape) -> float:
    rows = x.b * x.s
    roi = 2 * _conv(rows, m.roi, m.roi, m.pyramid, m.pyramid, 3)
    roi += 2 * rows * m.roi * m.roi * m.pyramid * m.fusion
    fuse = 2 * rows * (m.fusion + m.width) * m.fusion
    c = m.classes
    if m.head == "simp":  # two-layer MLPs; pos/neg only with the losses
        field = 2 * rows * (m.fusion * (m.fusion // 2) + (m.fusion // 2) * c)
        if x.train:
            field += 2 * rows * (m.fusion * (m.fusion // 2) + (m.fusion // 2) * 2)
    else:  # single-layer gate and class bank
        field = 2 * rows * m.fusion * c
    total = roi + fuse + field
    if x.train:  # segmentation head at stride 4
        hh, ww, p = x.h // 4, x.w // 4, m.pyramid
        total += 2 * _conv(x.b, hh, ww, p, p, 3) + _conv(x.b, hh, ww, 3 + c, p, 1)
        if m.head != "simp":
            total += _conv(x.b, hh, ww, c - 1, c, 1)
    return total


def forward_flops(m: Model, x: Shape) -> float:
    return encoder_flops(m, x) + backbone_flops(m, x) + head_flops(m, x)


def step_flops(m: Model, x: Shape) -> float:
    """A train step: forward, and a backward of twice its operations."""
    return 3 * forward_flops(m, dataclasses.replace(x, train=True))


# ---- one kernel call: (flops, bytes) ----

def scatter(m: Model, x: Shape) -> tuple[float, float]:
    """The BERTgrid scatter: the segments' embeddings read, the grid at an
    eighth of the canvas written (bf16); boxes and masks read."""
    grid = x.b * (x.h // 8) * (x.w // 8) * m.width * BF16
    return 0.0, grid + x.b * x.s * m.width * BF16 + x.b * x.s * 5 * F32


CALLS = {  # the trunk's kernels: kind -> (count function, calls a forward)
    "scatter": (scatter, lambda m: 1),
}


def merged(trunk: dict, encoder: dict) -> dict:
    """The trunk's entries and the encoder's; a kind defined twice is an error."""
    twice = sorted(set(trunk) & set(encoder))
    if twice:
        raise ValueError(f"kernel kinds defined by the trunk and the text encoder: {twice}")
    return {**trunk, **encoder}


def calls(m: Model) -> dict:
    """Kernel kind -> (count function, calls a forward): the trunk's
    :data:`CALLS` and the text encoder's ``KERNELS``."""
    own = encoder_of(m.text_encoder).KERNELS
    return merged(CALLS, {k: (fn, n) for k, (fn, n, _) in own.items()})


def bound_s(flops: float, nbytes: float) -> float:
    p = peaks()
    return max(flops / p["bf16_flops_per_s"], nbytes / p["bytes_per_s"])

