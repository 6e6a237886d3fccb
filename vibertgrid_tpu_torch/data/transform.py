"""Host-side image transform: resize, normalize, bucket-pad (port of
``vibertgrid_tpu/data/transform.py``).

The resize follows ``F.interpolate(..., mode='bilinear', align_corners=False)``
(half-pixel source grid, edge clamp), with the source coordinates in float64
and the taps in this order: the row above lerped across, the row below lerped
across, then the two lerped down, then ``(value - mean) * (1 / std)``.
:class:`ImageTransform` and the collator run it through the port's C++ host
op (:mod:`vibertgrid_tpu_torch.data.native`). :func:`resize_normalize_into`,
:func:`resize_uint8_into` and :func:`bilinear_resize` are its plain version,
torch ops on CPU tensors with the same bits; the tests hold the host op to
them, and nothing on the main path calls them. Output sizes follow torch's
``recompute_scale_factor=True`` (floor of shape × scale).

Boxes are rescaled on the correct axes (the reference swaps them,
``pipeline/transform.py:167-168``; aspect ratio is kept, so the ratios
differ only by rounding), as the JAX package does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch

from vibertgrid_tpu_torch.data import native

# the collator's uint8 wire (three channels): the resize times 255, rounded
UINT8_MEAN = np.zeros(3, np.float32)
UINT8_STD = np.full(3, 1.0 / 255.0, np.float32)


def _taps(out_n: int, in_n: int):
    src = (np.arange(out_n, dtype=np.float64) + 0.5) * (in_n / out_n) - 0.5
    src = np.clip(src, 0.0, in_n - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, in_n - 1)
    frac = (src - lo).astype(np.float32)
    return torch.from_numpy(lo), torch.from_numpy(hi), torch.from_numpy(frac)


def resize_normalize_into(image: np.ndarray, dst: np.ndarray, out_h: int, out_w: int,
                          mean, std) -> None:
    """Bilinear resize of ``image [H, W, C]`` (float in [0, 1]) to ``out_h x
    out_w``, normalised, written into the top-left of the canvas ``dst [bh,
    bw, C]`` (float32, C-contiguous); the rest of ``dst`` is left as it is.
    The plain version of :func:`native.bilinear_resize_norm_into`, for the
    tests; the main path calls the host op.

    Separable, in place where it can be: each source row that an output row
    reads is lerped across once (a row's lerp does not depend on which output
    row reads it, so the bits are the native op's), then the output rows are
    lerped down from those."""
    img = torch.from_numpy(np.ascontiguousarray(image, np.float32))
    h, w, c = img.shape
    out = torch.from_numpy(dst)[:out_h, :out_w]
    mean = torch.from_numpy(np.asarray(mean, np.float32))
    inv_std = 1.0 / torch.from_numpy(np.asarray(std, np.float32))
    if (h, w) == (out_h, out_w):
        torch.mul(img - mean, inv_std, out=out)
        return
    ylo, yhi, fy = _taps(out_h, h)
    xlo, xhi, fx = _taps(out_w, w)
    # the taps over the flattened (x, channel) axis, so a gather moves floats
    # and not 3-float slices
    chan = torch.arange(c)
    xlo, xhi = ((x[:, None] * c + chan).reshape(-1) for x in (xlo, xhi))
    fx = fx[:, None].expand(out_w, c).reshape(-1)
    rows, row_of = torch.unique(torch.cat([ylo, yhi]), return_inverse=True)
    src = img.view(h, w * c)
    if len(rows) < h:
        src = src.index_select(0, rows)
    across = src.index_select(1, xlo).mul_(1 - fx)
    across.add_(src.index_select(1, xhi).mul_(fx))
    fy = fy[:, None]
    down = across.index_select(0, row_of[:out_h]).mul_(1 - fy)
    down.add_(across.index_select(0, row_of[out_h:]).mul_(fy))
    torch.mul(down.view(out_h, out_w, c).sub_(mean), inv_std, out=out)


def round_uint8_into(page: np.ndarray, dst: np.ndarray) -> None:
    """``page [h, w, C]`` (float32, values on [0, 255]) rounded half to even
    and clipped, written into the top-left of the uint8 canvas ``dst [bh, bw,
    C]``: ``np.clip(np.rint(page), 0, 255)``, one page at a time and not over
    a whole float canvas."""
    h, w = page.shape[:2]
    values = torch.from_numpy(page).round_().clamp_(0.0, 255.0)
    torch.from_numpy(dst)[:h, :w].copy_(values)


def resize_uint8_into(image: np.ndarray, dst: np.ndarray, out_h: int, out_w: int) -> None:
    """The resize scaled to [0, 255], rounded half to even and clipped, written
    into the top-left of the uint8 canvas ``dst [bh, bw, C]``: the values of
    ``np.clip(np.rint(x), 0, 255)`` for ``x`` the resize normalized with mean 0
    and std 1/255. The plain version of the collator's uint8 wire (the host
    op's resize, then :func:`round_uint8_into`), for the tests."""
    c = image.shape[2]
    resized = np.empty((out_h, out_w, c), np.float32)
    resize_normalize_into(image, resized, out_h, out_w, np.zeros(c, np.float32),
                          np.full(c, 1.0 / 255.0, np.float32))
    round_uint8_into(resized, dst)


def bilinear_resize(image: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """The resize alone: ``image [H, W, C]`` → ``[out_h, out_w, C]`` float32.
    The plain version of :func:`native.bilinear_resize`, for the tests."""
    out = np.empty((out_h, out_w, image.shape[2]), np.float32)
    resize_normalize_into(image, out, out_h, out_w, np.zeros(image.shape[2]),
                          np.ones(image.shape[2]))
    return out


@dataclasses.dataclass
class ImageTransform:
    """Resize + normalize + box rescale (host side)."""

    image_mean: Sequence[float]
    image_std: Sequence[float]
    train_min_size: Sequence[int]  # paper: [320, 416, 512, 608, 704]
    test_min_size: int = 512
    max_size: int = 800

    def __call__(
        self,
        image: np.ndarray,
        boxes: np.ndarray,
        train: bool,
        rng: np.random.Generator | None = None,
    ) -> tuple[np.ndarray, np.ndarray, tuple[int, int]]:
        """image [H,W,3] float32 in [0,1]; boxes [S,4] int. Returns
        (resized+normalized image, rescaled int boxes, (h, w))."""
        h, w = image.shape[:2]
        min_size = self.draw_min_size(rng) if train else float(self.test_min_size)
        out_h, out_w = self._output_shape(h, w, min_size)
        resized = native.bilinear_resize_norm(image, out_h, out_w,
                                              np.asarray(self.image_mean, np.float32),
                                              np.asarray(self.image_std, np.float32))
        return resized, self.rescale_boxes(boxes, (h, w), (out_h, out_w)), (out_h, out_w)

    def draw_min_size(self, rng: np.random.Generator) -> float:
        """One per-image random short-edge target (the reference draws per
        image too, ``pipeline/transform.py:192-196``)."""
        assert rng is not None
        return float(rng.choice(list(self.train_min_size)))

    @staticmethod
    def rescale_boxes(
        boxes: np.ndarray, hw: tuple[int, int], ohw: tuple[int, int]
    ) -> np.ndarray:
        """Scale boxes from an (h, w) image onto its (oh, ow) resize."""
        if not len(boxes):
            return np.zeros((0, 4), np.int32)
        (h, w), (out_h, out_w) = hw, ohw
        b = boxes.astype(np.float64).copy()
        b[:, [0, 2]] *= out_w / w
        b[:, [1, 3]] *= out_h / h
        return b.astype(np.int32)

    def _output_shape(self, h: int, w: int, min_size: float) -> tuple[int, int]:
        scale = min_size / min(h, w)
        if max(h, w) * scale > self.max_size:
            scale = self.max_size / max(h, w)
        return int(math.floor(h * scale)), int(math.floor(w * scale))

    def test_output_shape(self, h: int, w: int) -> tuple[int, int]:
        """Deterministic eval-time resize target (no image work), the key of
        the collator's bucket signature."""
        return self._output_shape(h, w, float(self.test_min_size))


def bucket_hw(h: int, w: int, multiple: int = 64) -> tuple[int, int]:
    """Round a resized shape up to the padding bucket."""
    up = lambda v: int(math.ceil(v / multiple) * multiple)
    return up(h), up(w)


def bucket_count(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n. Counts beyond the ladder's top round up to the
    next multiple of the top bucket (the ladder is open-ended, never a cap)."""
    for b in buckets:
        if n <= b:
            return b
    top = buckets[-1]
    return int(math.ceil(n / top) * top)
