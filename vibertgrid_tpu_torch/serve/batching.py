"""Micro-batching wrapper for the inference engine (port of
``vibertgrid_tpu/serve/batching.py``).

The reference serves strictly one document per forward through Flask
(``deployment/main_SROIE.py:19-33``). Under concurrent load that leaves the
device mostly idle between requests. :class:`BatchingEngine` runs a
background worker that drains a request queue into one
``InferenceEngine.predict_many`` call — up to ``max_batch`` requests or
whatever arrived within ``max_wait_ms`` of the first — so concurrent
callers share device batches transparently while a lone request pays at
most ``max_wait_ms`` extra latency. The engine enters
``torch.inference_mode()`` itself, on this worker thread.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future


class BatchingEngine:
    def __init__(self, engine, max_batch: int = 8, max_wait_ms: float = 5.0):
        self.engine = engine
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1e3
        self._queue: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def predict(self, image, texts, boxes) -> dict:
        """Blocking single-request API; batching happens transparently."""
        if self._stop.is_set():
            raise RuntimeError("BatchingEngine is closed")
        fut: Future = Future()
        self._queue.put(((image, texts, boxes), fut))
        return fut.result()

    def predict_bytes(self, image_bytes: bytes):
        """OCR + batched model call (engine.predict_bytes equivalent)."""
        req = self.engine.extract_request(image_bytes)
        return None if req is None else self.predict(*req)

    def close(self):
        self._stop.set()
        self._worker.join(timeout=5)
        # fail any requests still queued (or racing the stop flag) so their
        # callers never block forever in fut.result()
        while True:
            try:
                _, fut = self._queue.get_nowait()
            except queue.Empty:
                break
            if not fut.done():
                fut.set_exception(RuntimeError("BatchingEngine closed"))

    def _run(self):
        while not self._stop.is_set():
            try:
                first = self._queue.get(timeout=0.1)
            except queue.Empty:
                continue
            items = [first]
            # drain whatever arrives before the deadline set by the FIRST
            # request (a fixed per-get timeout would restart the window on
            # every arrival, growing worst-case latency to
            # (max_batch-1)·max_wait), up to max_batch
            deadline = time.monotonic() + self.max_wait
            while len(items) < self.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    items.append(self._queue.get(timeout=remaining))
                except queue.Empty:
                    break
            requests = [req for req, _ in items]
            try:
                results = self.engine.predict_many(requests)
                for (_, fut), res in zip(items, results):
                    fut.set_result(res)
            except Exception as e:  # pragma: no cover - propagate to callers
                for _, fut in items:
                    if not fut.done():
                        fut.set_exception(e)
