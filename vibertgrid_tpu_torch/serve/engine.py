"""Inference engine: config + weights → bucketed inference on the card (port
of ``vibertgrid_tpu/serve/engine.py``).

A request goes: OCR segments → tokenize → resize and normalize (or the uint8
wire) → collate into bucketed static shapes, the batch padded to a power of
two → a forward on the device → D2H → softmax, entity join, per-dataset
filter → ``{field: value}``. The entity join and the filters are
:mod:`vibertgrid_tpu_torch.eval.entities`' (the reference's deployment copies
join with a trailing space and map regex rejects to ''; the eval-side join is
kept and None maps to '').

:meth:`InferenceEngine._dispatch` collates, uploads from pinned host memory
with ``non_blocking=True`` and enqueues the forward, and reads nothing back:
what it returns is a device future, which :meth:`InferenceEngine._finish`
fetches. :meth:`InferenceEngine.predict_stream` overlaps batch k+1's host
work with batch k's device work through that split. The forward runs under
``torch.inference_mode()`` entered by ``_dispatch`` itself, since grad mode
is per thread and :class:`~vibertgrid_tpu_torch.serve.batching.BatchingEngine`
calls it from a worker thread; under it the encoder takes the residual-free
FFN kernel.
"""

from __future__ import annotations

import dataclasses
import io
import os
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any

import numpy as np
import torch

from vibertgrid_tpu_torch.data.dataset import Collator, Sample, to_device
from vibertgrid_tpu_torch.data.spec import get_spec
from vibertgrid_tpu_torch.device import resolve_device
from vibertgrid_tpu_torch.eval.entities import join_entities
from vibertgrid_tpu_torch.eval.harness import RESULT_FILTERS
from vibertgrid_tpu_torch.models.vibertgrid import Batch
from vibertgrid_tpu_torch.serve.ocr_client import ocr_extraction
from vibertgrid_tpu_torch.train.state import normalize_uint8_images


class InferenceEngine:
    """``hyp``: a deployment YAML dict (``configs/deployment_sroie.yaml``).
    Weights, in order of precedence: ``state``, a state dict of the model (for
    instance ``convert.from_flax`` of the JAX engine's variables);
    ``reference_weights``, a ViBERTgrid-PyTorch checkpoint file; ``weights``, a
    checkpoint directory of ``train/checkpoint.py`` (only its model is read);
    else the random initialisation from seed 0. Runs on ``device``, the card
    unless the caller asks for ``"cpu"``."""

    def __init__(
        self,
        hyp: dict,
        dataset: str = "sroie",
        tokenizer: Any = None,
        state: Any = None,
        spec: Any = None,
        device="cuda",
    ) -> None:
        from vibertgrid_tpu_torch.train.driver import build_all, build_tokenizer

        self.device = resolve_device(device)
        self.hyp = hyp
        self.spec = spec or get_spec(dataset)
        self.tokenizer = tokenizer or build_tokenizer(hyp)
        (self.spec, self.cfg, self.model, self.transform, self.collator,
         self.tag_to_idx) = build_all(hyp, self.spec.name, self.tokenizer, self.spec,
                                      device=self.device, seed=0)
        self.ocr_url = hyp.get("ocr_url", "")
        self.parse_mode = hyp.get("parse_mode", "eng_line")
        self.result_filter = RESULT_FILTERS.get(self.spec.name)
        # A batch's pages are resized in parallel: the torch resize releases
        # the GIL, and its gathers use torch's intra-op threads poorly. Half
        # the cores, as those threads still work inside each resize.
        self._pool = ThreadPoolExecutor(max_workers=max(1, (os.cpu_count() or 2) // 2))

        # The uint8 wire: 4x fewer host-to-device bytes, normalized on the
        # device; its <=0.5/255 quantization changes serving numerics against
        # offline eval, so the engine says which wire it uses.
        self.log_timing = bool(hyp.get("serve_log_timing", False))
        self.uint8_upload = bool(hyp.get("serve_uint8_upload", True))
        if self.uint8_upload:
            self.collator = Collator(self.transform, emit_uint8=True)
        print(
            "InferenceEngine wire format: "
            + ("uint8 (normalized on the device, set serve_uint8_upload: false "
               "for exact fp32 eval numerics)" if self.uint8_upload
               else "fp32 (host-normalized, matches offline eval exactly)")
        )

        # the statistics on the device once: a copy from the host in the
        # request path would wait for the forwards already queued
        self._img_mean, self._img_std = (
            torch.tensor(v, dtype=torch.float32, device=self.device)
            for v in (self.transform.image_mean, self.transform.image_std))

        if state is not None:
            self.model.load_state_dict(state, strict=True)
        elif hyp.get("reference_weights"):
            from vibertgrid_tpu_torch.models.convert_reference import load_reference_checkpoint
            from vibertgrid_tpu_torch.train.driver import _load_torch_state_dict

            load_reference_checkpoint(self.model,
                                      _load_torch_state_dict(hyp["reference_weights"]))
        elif hyp.get("weights"):
            from vibertgrid_tpu_torch.train.checkpoint import restore_model

            restore_model(hyp["weights"], self.model)

    def _forward(self, batch: Batch, sizes: torch.Tensor) -> torch.Tensor:
        if self.uint8_upload:
            images = normalize_uint8_images(batch.images, sizes, self._img_mean, self._img_std)
            batch = dataclasses.replace(batch, images=images)
        return self.model(batch).pred_label

    def _make_sample(self, image, texts, boxes) -> Sample:
        tokens, seg_ids, kept_boxes, kept_texts = [], [], [], []
        seg = 0
        for text, box in zip(texts, boxes):
            t = text.lower() if self.spec.lowercase else text
            if not t or t.isspace():
                continue
            pieces = self.tokenizer.tokenize(t)
            if not pieces:
                continue
            ids = self.tokenizer.convert_tokens_to_ids(pieces)
            tokens.extend(ids)
            seg_ids.extend([seg] * len(ids))
            kept_boxes.append(list(box))
            kept_texts.append(text)
            seg += 1
        return Sample(
            image=np.asarray(image, np.float32),
            tokens=np.asarray(tokens, np.int32),
            seg_ids=np.asarray(seg_ids, np.int32),
            boxes=np.asarray(kept_boxes, np.int32).reshape(-1, 4),
            seg_classes=np.zeros(len(kept_boxes), np.int32),
            texts=kept_texts,
        )

    def _collate(self, samples: list[Sample]):
        return self.collator(samples, train=False, pool=self._pool)

    def _empty_result(self) -> dict:
        return {c: "" for c in self.spec.class_list[1:]}

    def _postprocess(self, pred_row, n: int, texts: list[str]) -> dict:
        probs = pred_row[:n]
        if probs.ndim == 1:  # crf decoded tags → one-hot scores
            onehot = np.zeros((n, len(self.tag_to_idx)), np.float32)
            onehot[np.arange(n), probs.astype(int)] = 1.0
            probs = onehot
        z = probs - probs.max(-1, keepdims=True)
        probs = np.exp(z) / np.exp(z).sum(-1, keepdims=True)
        best = join_entities(probs, texts, self.spec.num_classes, language=self.spec.language)
        result = {}
        for ci in range(1, self.spec.num_classes):
            value = best[ci]
            if self.result_filter is not None:
                value = self.result_filter(value, ci)
            result[self.spec.class_list[ci]] = value or ""
        return result

    def predict(self, image: np.ndarray, texts: list[str], boxes) -> dict:
        """image [H,W,3] float in [0,1] + OCR segments → {field: value}."""
        return self.predict_many([(image, texts, boxes)])[0]

    def _dispatch(self, requests: list[tuple]):
        """Collate one micro-batch and enqueue its forward without reading
        anything back: the returned prediction is a device tensor that the
        device fills while the host moves on."""
        samples = [self._make_sample(img, txt, np.asarray(bx)) for img, txt, bx in requests]
        keep = [i for i, s in enumerate(samples) if len(s.texts)]
        if not keep:
            return None, None, samples, keep
        batch, aux = self._collate([samples[i] for i in keep])
        sizes = np.asarray(aux.image_sizes, np.int32)
        # The batch axis is bucketed too (next power of two, the last sample
        # repeated), so concurrency levels share shapes.
        n_real = len(keep)
        n_bucket = 1 << (n_real - 1).bit_length()
        if n_bucket != n_real:
            pad = lambda x: np.concatenate([x] + [x[-1:]] * (n_bucket - n_real), axis=0)
            batch = Batch(**{f.name: pad(getattr(batch, f.name))
                             for f in dataclasses.fields(batch)})
            sizes = pad(sizes)
        device_batch = Batch(**{f.name: to_device(getattr(batch, f.name), self.device)
                                for f in dataclasses.fields(batch)})
        with torch.inference_mode():
            pred = self._forward(device_batch, to_device(sizes, self.device))
        return pred, aux, samples, keep

    def _finish(self, pred, aux, samples, keep) -> list[dict]:
        """Fetch a dispatched micro-batch (blocking D2H) and postprocess."""
        results: list[dict] = [self._empty_result() for _ in samples]
        if not keep:
            return results
        pred = pred.float().cpu().numpy()
        for row, i in enumerate(keep):
            results[i] = self._postprocess(pred[row], aux.n_segments[row], samples[i].texts)
        return results

    def predict_many(self, requests: list[tuple]) -> list[dict]:
        """Micro-batched inference: N (image, texts, boxes) requests in one
        device call (the batch pads to the shared bucket signature). The
        reference's deployment runs one document per forward
        (``deployment/inference_SROIE.py:160-181``)."""
        t0 = time.time()
        out = self._finish(*self._dispatch(requests))
        if self.log_timing:
            print(f"Model Inference Time {time.time() - t0:.3f}s ({len(requests)} docs)")
        return out

    def predict_stream(self, requests: list[tuple], batch_size: int = 16,
                       depth: int = 2) -> list[dict]:
        """Pipelined inference over a request list: micro-batch k+1's host
        collate, upload and dispatch overlap micro-batch k's device work and
        fetch; ``depth`` bounds the batches in flight."""
        out: list[dict] = []
        pending: deque = deque()
        for i in range(0, len(requests), batch_size):
            pending.append(self._dispatch(requests[i : i + batch_size]))
            if len(pending) >= depth:
                out.extend(self._finish(*pending.popleft()))
        while pending:
            out.extend(self._finish(*pending.popleft()))
        return out

    def extract_request(self, image_bytes: bytes):
        """OCR + image decode → (image, texts, boxes), or None on OCR error.
        Shared by the direct and the micro-batched serving fronts."""
        from PIL import Image

        code, texts, boxes = ocr_extraction(image_bytes, self.ocr_url, self.parse_mode)
        if code != 200:
            return None
        img = Image.open(io.BytesIO(image_bytes)).convert("RGB")
        return np.asarray(img, np.float32) / 255.0, texts, boxes

    def predict_bytes(self, image_bytes: bytes) -> dict | None:
        """Full pipeline with the external OCR service."""
        req = self.extract_request(image_bytes)
        return None if req is None else self.predict(*req)
