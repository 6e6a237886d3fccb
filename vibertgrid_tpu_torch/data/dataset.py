"""Samples and bucketed collation (port of the collation half of
``vibertgrid_tpu/data/dataset.py``).

A :class:`Sample` is one document: its image, its wordpiece corpus with
``seg_ids`` mapping tokens to segments, its boxes and classes. The
:class:`Collator` pads a list of them into *bucketed static shapes*: images to
``/hw_multiple`` buckets, tokens to 510-token windows (the window count on a
ladder), segments to a fixed ladder, so that a served or evaluated stream lands
on a small set of shapes. It emits numpy arrays; the caller moves them to the
device.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from vibertgrid_tpu_torch.data.transform import (
    ImageTransform,
    bucket_count,
    bucket_hw,
    resize_normalize_into,
    resize_uint8_into,
)
from vibertgrid_tpu_torch.models.vibertgrid import Batch

SEG_BUCKETS = (32, 64, 128, 256, 512)
WIN_BUCKETS = (1, 2, 3, 4, 6, 8, 12, 16)
WINDOW = 510


@dataclasses.dataclass
class Sample:
    image: np.ndarray          # [H, W, 3] float32 in [0,1]
    tokens: np.ndarray         # [n_tok] int32
    seg_ids: np.ndarray        # [n_tok] int32
    boxes: np.ndarray          # [n_seg, 4] int32 (original coords)
    seg_classes: np.ndarray    # [n_seg] int32
    texts: list[str]
    key_dict: dict | None = None


@dataclasses.dataclass
class EvalAux:
    """Host-side metadata riding alongside a collated batch."""

    texts: list[list[str]]
    key_dicts: list[dict | None]
    n_segments: list[int]
    # Per-sample resized (h, w) before canvas padding: the uint8 wire needs
    # it to set the padded pixels back to 0 after normalizing on the device.
    image_sizes: list[tuple[int, int]] | None = None


class Collator:
    """Samples → static-shape :class:`Batch` of numpy arrays (+ EvalAux)."""

    def __init__(
        self,
        transform: ImageTransform,
        seg_buckets: Sequence[int] = SEG_BUCKETS,
        hw_multiple: int = 64,
        max_windows: int | None = None,
        win_buckets: Sequence[int] = WIN_BUCKETS,
        emit_uint8: bool = False,
    ) -> None:
        """``max_windows=None`` supports corpora of any length (the window
        count rounds up on ``win_buckets``, open-ended beyond the top); an
        explicit ``max_windows`` raises on overflow, and never truncates.
        ``emit_uint8``: the canvas holds the resized pixels x 255 rounded to
        uint8, not normalized; the device normalizes (4x fewer host-to-device
        bytes)."""
        self.transform = transform
        self.seg_buckets = tuple(seg_buckets)
        self.hw_multiple = hw_multiple
        self.max_windows = max_windows
        self.win_buckets = tuple(win_buckets)
        self.emit_uint8 = emit_uint8

    def signature(self, sample: Sample) -> tuple[int, int, int, int]:
        """Eval-time collation bucket signature ``(bh, bw, s_cap, n_win)``:
        a batch of samples that share one collates to exactly these shapes."""
        oh, ow = self.transform.test_output_shape(*sample.image.shape[:2])
        bh, bw = bucket_hw(oh, ow, self.hw_multiple)
        s_cap = bucket_count(max(len(sample.seg_classes), 1), self.seg_buckets)
        n_win = bucket_count(-(-max(len(sample.tokens), 1) // WINDOW), self.win_buckets)
        return bh, bw, s_cap, n_win

    def __call__(
        self,
        samples: list[Sample],
        train: bool,
        rng: np.random.Generator | None = None,
        pool=None,
    ) -> tuple[Batch, EvalAux]:
        """``pool``: optional executor; the per-sample resize releases the GIL,
        so it runs across the batch in parallel."""
        b = len(samples)
        # one random min size per image, drawn serially (the reference draws
        # per image too, pipeline/transform.py:192-196)
        if train and rng is None:
            rng = np.random.default_rng(0)
        tr = self.transform
        min_sizes = [tr.draw_min_size(rng) if train else float(tr.test_min_size)
                     for _ in samples]
        hws = [tr._output_shape(s.image.shape[0], s.image.shape[1], ms)
               for s, ms in zip(samples, min_sizes)]

        bh, bw = bucket_hw(max(h for h, _ in hws), max(w for _, w in hws), self.hw_multiple)
        # uint8: the resize only, scaled to [0, 255] and rounded, page by page
        image_arr = np.zeros((b, bh, bw, 3), np.uint8 if self.emit_uint8 else np.float32)
        mean = np.asarray(tr.image_mean, np.float32)
        std = np.asarray(tr.image_std, np.float32)

        def _resize_sample(i: int):
            s = samples[i]
            oh, ow = hws[i]
            if self.emit_uint8:
                resize_uint8_into(s.image, image_arr[i], oh, ow)
            else:
                resize_normalize_into(s.image, image_arr[i], oh, ow, mean, std)
            return tr.rescale_boxes(s.boxes, s.image.shape[:2], (oh, ow))

        if pool is not None and b > 1:
            boxes_list = list(pool.map(_resize_sample, range(b)))
        else:
            boxes_list = [_resize_sample(i) for i in range(b)]

        n_seg = max(max((len(s.seg_classes) for s in samples), default=1), 1)
        s_cap = bucket_count(n_seg, self.seg_buckets)
        n_tok = max(max((len(s.tokens) for s in samples), default=1), 1)
        n_win = bucket_count(-(-n_tok // WINDOW), self.win_buckets)
        if self.max_windows is not None and n_win > self.max_windows:
            raise ValueError(
                f"corpus needs {n_win} windows ({n_tok} tokens) but the collator was "
                f"capped at max_windows={self.max_windows}; raise or drop the cap, tokens "
                "are never truncated"
            )
        t_cap = n_win * WINDOW

        boxes = np.zeros((b, s_cap, 4), np.int32)
        box_mask = np.zeros((b, s_cap), bool)
        seg_classes = np.zeros((b, s_cap), np.int32)
        tokens = np.zeros((b, t_cap), np.int32)
        token_mask = np.zeros((b, t_cap), np.int32)
        seg_ids = np.zeros((b, t_cap), np.int32)
        for i, s in enumerate(samples):
            ns, nt = len(s.seg_classes), len(s.tokens)
            boxes[i, :ns] = boxes_list[i]
            box_mask[i, :ns] = True
            seg_classes[i, :ns] = s.seg_classes
            tokens[i, :nt] = s.tokens
            token_mask[i, :nt] = 1
            seg_ids[i, :nt] = s.seg_ids

        batch = Batch(images=image_arr, tokens=tokens, token_mask=token_mask,
                      seg_ids=seg_ids, boxes=boxes, box_mask=box_mask,
                      seg_classes=seg_classes)
        aux = EvalAux(
            texts=[s.texts for s in samples],
            key_dicts=[s.key_dict for s in samples],
            n_segments=[len(s.seg_classes) for s in samples],
            image_sizes=[tuple(hw) for hw in hws],
        )
        return batch, aux
