"""The plain reference of a training batch: what the port's collator makes of
the documents, worked out again, so that a training cell can check the
batches its steps received before it follows the steps.

Each page draws its short side from the configuration's train sizes (the
long side at most ``image_max_size``), serially from the feed's generator;
it is resized bilinearly (half-pixel grid, edge clamp: the row above and
the row below each lerped across, then lerped down), normalised, and written
into the top-left of a canvas whose sides are the batch's largest rounded up
to a multiple of 64. Boxes are rescaled; segments and tokens are padded to
their buckets.
"""

from __future__ import annotations

import math

import numpy as np

FIELDS = ("images", "tokens", "token_mask", "seg_ids", "boxes", "box_mask", "seg_classes")
SEG_BUCKETS = (32, 64, 128, 256, 512)
WIN_BUCKETS = (1, 2, 3, 4, 6, 8, 12, 16)
HW_MULTIPLE = 64


def _bucket(n: int, ladder) -> int:
    for b in ladder:
        if n <= b:
            return b
    return int(math.ceil(n / ladder[-1]) * ladder[-1])


def _output_shape(h, w, min_size, max_size):
    scale = min_size / min(h, w)
    if max(h, w) * scale > max_size:
        scale = max_size / max(h, w)
    return int(math.floor(h * scale)), int(math.floor(w * scale))


def _taps(out_n: int, in_n: int):
    src = np.clip((np.arange(out_n, dtype=np.float64) + 0.5) * (in_n / out_n) - 0.5,
                  0.0, in_n - 1)
    lo = np.floor(src).astype(np.int64)
    return lo, np.minimum(lo + 1, in_n - 1), (src - lo).astype(np.float32)


def resize_normalize(image: np.ndarray, out_h: int, out_w: int, mean, std) -> np.ndarray:
    """``image [H, W, C]`` float32 in [0, 1] → ``[out_h, out_w, C]``,
    ``(value - mean)·(1/std)``, all in float32."""
    image = np.asarray(image, np.float32)
    mean = np.asarray(mean, np.float32)
    inv_std = np.float32(1.0) / np.asarray(std, np.float32)
    if image.shape[:2] == (out_h, out_w):
        return (image - mean) * inv_std
    ylo, yhi, fy = _taps(out_h, image.shape[0])
    xlo, xhi, fx = _taps(out_w, image.shape[1])
    fx = fx[None, :, None]
    across = lambda rows: rows[:, xlo] * (np.float32(1) - fx) + rows[:, xhi] * fx
    fy = fy[:, None, None]
    down = across(image[ylo]) * (np.float32(1) - fy) + across(image[yhi]) * fy
    return (down - mean) * inv_std


def batch(docs: list, hyp: dict, window: int, rng: np.random.Generator) -> dict:
    """``docs``: ``(image [H, W, 3] in [0, 1], tokens, seg_ids, boxes [n, 4],
    classes [n])``; the arrays of the collated batch, its tokens padded to
    whole windows of ``window`` tokens (the configuration's
    ``window_tokens``)."""
    sizes = [float(rng.choice(list(hyp["image_min_size"]))) for _ in docs]
    hws = [_output_shape(*d[0].shape[:2], m, float(hyp["image_max_size"]))
           for d, m in zip(docs, sizes)]
    up = lambda v: int(math.ceil(v / HW_MULTIPLE) * HW_MULTIPLE)
    bh, bw = up(max(h for h, _ in hws)), up(max(w for _, w in hws))
    b = len(docs)
    s_cap = _bucket(max(max(len(d[4]) for d in docs), 1), SEG_BUCKETS)
    t_cap = _bucket(-(-max(max(len(d[1]) for d in docs), 1) // window), WIN_BUCKETS) * window
    out = {"images": np.zeros((b, bh, bw, 3), np.float32),
           "tokens": np.zeros((b, t_cap), np.int32), "token_mask": np.zeros((b, t_cap), np.int32),
           "seg_ids": np.zeros((b, t_cap), np.int32), "boxes": np.zeros((b, s_cap, 4), np.int32),
           "box_mask": np.zeros((b, s_cap), bool), "seg_classes": np.zeros((b, s_cap), np.int32)}
    for i, ((image, tokens, seg_ids, boxes, classes), (oh, ow)) in enumerate(zip(docs, hws)):
        out["images"][i, :oh, :ow] = resize_normalize(image, oh, ow, hyp["image_mean"],
                                                      hyp["image_std"])
        h, w = image.shape[:2]
        bx = np.asarray(boxes, np.float64).reshape(-1, 4).copy()
        bx[:, [0, 2]] *= ow / w
        bx[:, [1, 3]] *= oh / h
        n, t = len(classes), len(tokens)
        out["boxes"][i, :n] = bx.astype(np.int32)
        out["box_mask"][i, :n] = True
        out["seg_classes"][i, :n] = classes
        out["tokens"][i, :t] = tokens
        out["token_mask"][i, :t] = 1
        out["seg_ids"][i, :t] = seg_ids
    return out


def mismatches(got: list, want: list) -> int:
    """Arrays of the batches that differ (shape or any value)."""
    bad = 0
    for g, w in zip(got, want):
        for name in FIELDS:
            a, b = np.asarray(g[name]), np.asarray(w[name])
            bad += a.shape != b.shape or not np.array_equal(a, b)
    return bad + abs(len(got) - len(want))
