"""Dataset reading, tokenization, bucketed collation, the loaders and the
prefetch to the device (port of ``vibertgrid_tpu/data/dataset.py``).

:class:`KIEDataset` reads one split as ``data/SROIE_dataset.py:94-163`` does:
an image and its CSV labels (``left,top,right,bot,text,data_class``), each
segment's text tokenized into one flat wordpiece corpus with ``seg_ids``
mapping tokens to segments; empty, blank and untokenizable segments are
skipped; test items add the raw texts and a key dict.

A :class:`Sample` is one document. The :class:`Collator` pads a list of them
into *bucketed static shapes*: images to ``/hw_multiple`` buckets, tokens to
510-token windows (the window count on a ladder), segments to a fixed ladder,
so that a served or evaluated stream lands on a small set of shapes. It emits
numpy arrays; :func:`prefetch_to_device` (or :func:`to_device`) moves them to
the device from pinned host memory.
"""

from __future__ import annotations

import dataclasses
import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Iterator, Sequence

import numpy as np
import torch

from vibertgrid_tpu_torch.data import native
from vibertgrid_tpu_torch.data.transform import (
    UINT8_MEAN,
    UINT8_STD,
    ImageTransform,
    bucket_count,
    bucket_hw,
    round_uint8_into,
)
from vibertgrid_tpu_torch.data.spec import DatasetSpec
from vibertgrid_tpu_torch.device import resolve_device
from vibertgrid_tpu_torch.models.vibertgrid import Batch

SEG_BUCKETS = (32, 64, 128, 256, 512)
WIN_BUCKETS = (1, 2, 3, 4, 6, 8, 12, 16)
WINDOW = 510


def _read_image(path: str) -> np.ndarray:
    if path.endswith(".npy"):  # synthetic test data
        return np.load(path).astype(np.float32)
    from PIL import Image

    img = Image.open(path)
    if img.mode != "RGB":
        img = img.convert("RGB")
    return np.asarray(img, np.float32) / 255.0  # ToTensor semantics


def _read_label_csv(path: str) -> list[dict]:
    import csv

    with open(path, newline="", encoding="utf-8") as f:
        return list(csv.DictReader(f))


@dataclasses.dataclass
class Sample:
    image: np.ndarray          # [H, W, 3] float32 in [0,1]
    tokens: np.ndarray         # [n_tok] int32
    seg_ids: np.ndarray        # [n_tok] int32
    boxes: np.ndarray          # [n_seg, 4] int32 (original coords)
    seg_classes: np.ndarray    # [n_seg] int32
    texts: list[str]
    key_dict: dict | None = None


class KIEDataset:
    """Reads one split (``root`` holds the image / label / key directories of
    ``spec``)."""

    def __init__(self, root: str, spec: DatasetSpec, tokenizer: Any, train: bool = True,
                 split_list: str | None = None) -> None:
        if not os.path.exists(root):
            raise FileNotFoundError(f"dataset root {root} does not exist")
        self.root = root
        self.spec = spec
        self.tokenizer = tokenizer
        self.train = train
        if spec.filelist_from_txt:
            listfile = split_list or ("train.txt" if train else "test.txt")
            with open(os.path.join(root, listfile)) as f:
                self.filenames = [ln.strip() for ln in f if ln.strip()]
        else:
            label_dir = os.path.join(root, spec.label_dir)
            src = label_dir if os.path.isdir(label_dir) else os.path.join(root, spec.image_dir)
            self.filenames = sorted(os.path.splitext(f)[0] for f in os.listdir(src))

    def __len__(self) -> int:
        return len(self.filenames)

    def __getitem__(self, index: int) -> Sample:
        name = self.filenames[index]
        spec = self.spec
        image = _read_image(os.path.join(self.root, spec.image_dir, name + spec.image_ext))
        rows = _read_label_csv(os.path.join(self.root, spec.label_dir, name + ".csv"))

        kept_rows, to_encode = [], []
        for row in rows:
            text = str(row["text"])
            if text == "" or text.isspace():
                continue
            kept_rows.append((row, text))
            to_encode.append(text.lower() if spec.lowercase else text)

        # One batched encode a document: a fast (Rust) tokenizer encodes all
        # segments in one call that releases the GIL, where one call a segment
        # was the host pipeline's serial bottleneck. The ids equal the
        # per-segment path's.
        if getattr(self.tokenizer, "is_fast", False) and to_encode:
            ids_lists = self.tokenizer(to_encode, add_special_tokens=False)["input_ids"]
        else:
            ids_lists = [self.tokenizer.convert_tokens_to_ids(self.tokenizer.tokenize(t))
                         for t in to_encode]

        tokens, seg_ids, boxes, classes, texts = [], [], [], [], []
        for (row, text), ids in zip(kept_rows, ids_lists):
            if not ids:
                continue
            seg_ids.extend([len(texts)] * len(ids))
            tokens.extend(ids)
            boxes.append([int(float(row[k])) for k in ("left", "top", "right", "bot")])
            classes.append(int(float(row["data_class"])))
            texts.append(text)

        key_dict = None
        if not self.train:
            key_dict = (spec.key_loader(self.root, name) if spec.key_loader is not None
                        else {"filename": name})

        return Sample(
            image=image,
            tokens=np.asarray(tokens, np.int32),
            seg_ids=np.asarray(seg_ids, np.int32),
            boxes=np.asarray(boxes, np.int32).reshape(-1, 4),
            seg_classes=np.asarray(classes, np.int32),
            texts=texts,
            key_dict=key_dict,
        )


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
        """``pool``: optional executor; the per-sample resize (the C++ host op,
        :mod:`data.native`) releases the GIL, so it runs across the batch in
        parallel."""
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
                page = native.bilinear_resize_norm(s.image, oh, ow, UINT8_MEAN, UINT8_STD)
                round_uint8_into(page, image_arr[i])
            else:  # straight into the page's slot of the canvas, no pad copy
                native.bilinear_resize_norm_into(s.image, image_arr[i], oh, ow, mean, std)
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


def data_loader(
    dataset: KIEDataset,
    collator: Collator,
    batch_size: int,
    train: bool,
    seed: int = 0,
    shard: tuple[int, int] = (0, 1),
    drop_last: bool | None = None,
    num_workers: int = 0,
) -> Iterator[tuple[Batch, EvalAux]]:
    """An epoch of collated ``(batch, aux)``: shuffled from ``default_rng(seed)``
    when ``train``, the process's share ``[rank::world]`` of the order, the
    DistributedSampler + BatchSampler(drop_last) semantics
    (``data/SROIE_dataset.py:314-333``). ``num_workers > 0`` reads each batch's
    samples on a thread pool, which the collator's resize shares."""
    rng = np.random.default_rng(seed)
    order = np.arange(len(dataset))
    if train:
        rng.shuffle(order)
    rank, world = shard
    order = order[rank::world]
    if drop_last is None:
        drop_last = train
    if world > 1 and drop_last:
        # every process takes the same number of steps an epoch
        order = order[: len(dataset) // world]
    end = (len(order) // batch_size) * batch_size if drop_last else len(order)

    pool = ThreadPoolExecutor(max_workers=num_workers) if num_workers > 0 else None
    try:
        for i in range(0, end, batch_size):
            idx = order[i : i + batch_size]
            if not len(idx):
                continue
            if pool is not None:
                samples = list(pool.map(dataset.__getitem__, idx))
            else:
                samples = [dataset[j] for j in idx]
            yield collator(samples, train, rng, pool=pool)
    finally:
        if pool is not None:
            pool.shutdown(wait=False)


def _read_all(dataset: KIEDataset, indices, fn, num_workers: int) -> list:
    if num_workers > 0:
        with ThreadPoolExecutor(max_workers=num_workers) as pool:
            return list(pool.map(fn, indices))
    return [fn(i) for i in indices]


def compute_mean_std(dataset: KIEDataset, num_workers: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Per-channel image statistics for a new dataset's ``image_mean`` /
    ``image_std`` (``data/SROIE_dataset.py:263-278``): each raw [0, 1]
    image's channel mean and sample standard deviation (ddof 1), averaged
    over the dataset."""

    def stats(i):
        img = dataset[i].image.reshape(-1, 3).astype(np.float64)
        return img.mean(axis=0), img.std(axis=0, ddof=1)

    mean = np.zeros(3, np.float64)
    std = np.zeros(3, np.float64)
    for m, s in _read_all(dataset, range(len(dataset)), stats, num_workers):
        mean += m
        std += s
    n = max(len(dataset), 1)
    return (mean / n).astype(np.float32), (std / n).astype(np.float32)


def bucketed_eval_loader(
    dataset: KIEDataset,
    collator: Collator,
    batch_size: int,
    shard: tuple[int, int] = (0, 1),
    num_workers: int = 0,
) -> Iterator[tuple[Batch, EvalAux]]:
    """Evaluation batches of up to ``batch_size`` documents that share one
    collation signature, the groups in sorted signature order. A partial
    group is padded to the next power of two by repeating its last document;
    the repeats get ``aux.n_segments = 0``, so the metrics skip them and
    each document's metrics equal the batch-size-1 loop's (the forward is
    independent across a batch in eval mode). The mean loss counts the
    repeats like real documents."""
    rank, world = shard
    order = list(range(len(dataset)))[rank::world]
    samples = _read_all(dataset, order, dataset.__getitem__, num_workers)

    groups: dict[tuple, list[Sample]] = {}
    for s in samples:
        groups.setdefault(collator.signature(s), []).append(s)

    for sig in sorted(groups):
        g = groups[sig]
        for i in range(0, len(g), batch_size):
            chunk = g[i : i + batch_size]
            n_real = len(chunk)
            target = min(1 << (n_real - 1).bit_length(), batch_size)
            chunk = chunk + [chunk[-1]] * (target - n_real)
            batch, aux = collator(chunk, train=False)
            for j in range(n_real, len(chunk)):
                aux.n_segments[j] = 0  # a repeat: the metrics skip it
            yield batch, aux


def to_device(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array as a tensor on ``device``: on the card copied from pinned
    host memory with ``non_blocking=True`` on the current stream (the caching
    host allocator keeps the pinned block until the copy is done), on the CPU
    the array's own memory."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


_DONE = object()


def prefetch_to_device(iterator: Iterator, device="cuda", size: int = 2) -> Iterator:
    """Run a loader of ``(batch, aux)`` on a background thread and hand the
    batches over through a queue of ``size``, their arrays as tensors on
    ``device``: host reading, tokenizing and collation overlap the device's
    steps.

    On the card each batch is copied from pinned memory on a side stream and
    an event is recorded after its copies; the consumer makes its current
    stream wait on that event, and marks each tensor as used on that stream
    so that the caching allocator cannot hand its memory out again while the
    consumer's kernels may still read it. On the CPU the thread only
    overlaps host work.

    An early ``break`` (or closing the generator) stops the thread; an
    exception in the loader is raised in the consumer."""
    dev = resolve_device(device)
    side = torch.cuda.Stream(dev) if dev.type == "cuda" else None
    q: queue.Queue = queue.Queue(maxsize=size)
    stop = threading.Event()

    def put(obj) -> bool:
        # a put that gives up once the consumer is gone, so that an early
        # break cannot leave this thread blocked on a full queue
        while not stop.is_set():
            try:
                q.put(obj, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def upload(batch: Batch):
        moved = lambda: Batch(**{f.name: to_device(getattr(batch, f.name), dev)
                                 for f in dataclasses.fields(batch)})
        if side is None:
            return moved(), None
        with torch.cuda.stream(side):
            out = moved()
            event = torch.cuda.Event()
            event.record(side)
        return out, event

    def producer():
        try:
            for batch, aux in iterator:
                if stop.is_set() or not put((*upload(batch), aux)):
                    return
        except BaseException as exc:  # raised again in the consumer
            put((_DONE, exc))
            return
        finally:
            close = getattr(iterator, "close", None)
            if close is not None:  # a generator's own clean-up (a loader's pool)
                close()
        put((_DONE, None))

    thread = threading.Thread(target=producer, name="prefetch_to_device", daemon=True)
    thread.start()
    try:
        while True:
            batch, event_or_exc, *aux = q.get()
            if batch is _DONE:
                if event_or_exc is not None:
                    raise event_or_exc
                return
            if event_or_exc is not None:
                stream = torch.cuda.current_stream(dev)
                stream.wait_event(event_or_exc)
                for f in dataclasses.fields(batch):
                    getattr(batch, f.name).record_stream(stream)
            yield batch, aux[0]
    finally:
        stop.set()
        thread.join(timeout=10)
