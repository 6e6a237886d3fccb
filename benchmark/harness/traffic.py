"""The one traffic generator. A mix is a data file, ``benchmark/traffic/<mix>.json``,
of parameters; this module turns it and a seed into documents.

Parameters a mix may hold:

- ``pages``: ``[{"name", "hw": [H, W], "share"}]``: page sizes in pixels and
  the share of documents of each;
- ``segments``: ``{"median", "sigma", "min", "max"}`` (log-normal, clipped)
  or ``{"fixed": n}``: OCR segments a page;
- ``words_per_segment``: ``[lo, hi]``, uniform, both ends included;
- ``max_tokens``: words a page at most (one word is one token); the last
  segments lose words beyond it;
- ``token_ids``: ``[lo, hi)``, the ids each token is drawn from, straight
  from the model's vocabulary (the tokenizer is bypassed);
- ``class_shares``: the share of segments of each field class (training);
- ``image_pool``: distinct page images of each size, which the documents
  share (an image of 1600x700 is 13 MB of float32).

Every seed gets the same multiset of page kinds and segment counts, in
another order: the seed changes which document comes
when and what it says, not how much work a run holds. Token ids, boxes,
classes and images are drawn from the seed.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LINE_PX = 14  # a text line's pitch on the page


def load_mix(name: str) -> dict:
    with open(os.path.join(HERE, "traffic", name + ".json")) as f:
        return json.load(f)


@dataclasses.dataclass
class Document:
    kind: int                  # index into mix["pages"]
    image: int                 # index into the kind's image pool
    boxes: np.ndarray          # [n, 4] int32 (x0, y0, x1, y1), page pixels
    ids: list[np.ndarray]      # token ids of each segment (int32)
    classes: np.ndarray        # [n] int32 field class of each segment


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([seed & 0xFFFFFFFFFFFFFFFF, stream])


def _quantiles(n: int) -> np.ndarray:
    return (np.arange(n) + 0.5) / n


def segment_counts(mix: dict, n: int) -> np.ndarray:
    """The fixed multiset of ``n`` segment counts (sorted), the same for every
    seed: the distribution's quantiles at evenly spaced probabilities."""
    seg = mix["segments"]
    if "fixed" in seg:
        return np.full(n, int(seg["fixed"]), np.int64)
    normal = statistics.NormalDist()
    z = np.array([normal.inv_cdf(p) for p in _quantiles(n)])
    counts = np.rint(np.exp(math.log(seg["median"]) + seg["sigma"] * z))
    return np.clip(counts, seg["min"], seg["max"]).astype(np.int64)


def page_kinds(mix: dict, n: int) -> np.ndarray:
    """The fixed multiset of page kinds, in proportion to their shares."""
    shares = np.array([p["share"] for p in mix["pages"]], np.float64)
    edges = np.cumsum(shares / shares.sum())
    return np.searchsorted(edges, _quantiles(n)).astype(np.int64)


def _layout(n_seg: int, hw, rng: np.random.Generator) -> np.ndarray:
    """Boxes in lines down the page, ``per_line`` a line, 11 px high."""
    h, w = hw
    lines = max((h - 20) // LINE_PX, 1)
    per_line = -(-n_seg // lines)
    cell = (w - 20) // per_line
    i = np.arange(n_seg)
    x0 = 10 + (i % per_line) * cell
    y0 = 10 + (i // per_line) * LINE_PX
    x1 = x0 + rng.integers(8, max(cell, 9), n_seg)
    return np.stack([x0, y0, x1, y0 + 11], 1).astype(np.int32)


def documents(mix: dict, seed: int, n: int) -> list[Document]:
    """``n`` documents of ``mix`` for ``seed``."""
    order = _rng(seed, 1).permutation(n)
    kinds = page_kinds(mix, n)
    counts = segment_counts(mix, n)[_rng(seed, 2).permutation(n)]
    rng = _rng(seed, 3)
    lo, hi = mix["words_per_segment"]
    cap = mix.get("max_tokens")
    shares = mix.get("class_shares")
    id_range = mix["token_ids"]
    pool = mix.get("image_pool", 4)
    docs = []
    for k in range(n):
        kind = int(kinds[order[k]])
        n_seg = int(counts[k])
        words = rng.integers(lo, hi + 1, n_seg)
        if cap is not None and words.sum() > cap:  # drop words from the end
            over = np.cumsum(words) - cap
            words = np.where(over > 0, np.maximum(words - over, 0), words)
            words = words[words > 0]
            n_seg = len(words)
        flat = rng.integers(id_range[0], id_range[1], int(words.sum())).astype(np.int32)
        ids = np.split(flat, np.cumsum(words)[:-1])
        classes = (rng.choice(len(shares), n_seg, p=np.asarray(shares) / sum(shares))
                   if shares else np.zeros(n_seg, np.int64)).astype(np.int32)
        docs.append(Document(kind=kind, image=int(rng.integers(0, pool)),
                             boxes=_layout(n_seg, mix["pages"][kind]["hw"], rng),
                             ids=list(ids), classes=classes))
    return docs


def page_images(mix: dict, seed: int) -> list[list[np.ndarray]]:
    """For each page kind, ``image_pool`` images ``[H, W, 3]`` float32 in
    [0, 1]: paper of a light grey with shaded text lines and noise."""
    rng = _rng(seed, 4)
    out = []
    for page in mix["pages"]:
        h, w = page["hw"]
        images = []
        for _ in range(mix.get("image_pool", 4)):
            img = np.full((h, w, 3), rng.uniform(0.9, 0.98), np.float32)
            boxes = _layout(int(rng.integers(40, 200)), (h, w), rng)
            for x0, y0, x1, y1 in boxes:
                img[y0:y1, x0:x1] = rng.uniform(0.1, 0.8)
            img += rng.normal(0.0, 0.02, (h, w, 1)).astype(np.float32)
            images.append(np.clip(img, 0.0, 1.0))
        out.append(images)
    return out

