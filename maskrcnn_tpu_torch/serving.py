"""Serving: request micro-batching around the Detector (counterpart of
maskrcnn_tpu/serving.py).

* callers submit images from any thread and block on a Future;
* a dispatcher thread drains the queue, waits at most `max_delay_ms` to
  fill up to `max_batch`, and launches the device work
  (`Detector.dispatch_batch`: CUDA launches return once enqueued; the
  handle carries an event recorded after the batch's outputs);
* a fetcher thread waits for the outputs and decodes on the host
  (`Detector.fetch`: the copies run on the Detector's own copy stream
  after that event, into pinned buffers), so batch N's device-to-host
  copy and decode overlap batch N+1's compute on the default stream — a
  2-deep pipeline bounded by a maxsize-1 handoff queue;
* batches are padded with repeats of their last image to 1, 2, 4, ...,
  max_batch images, the JAX package's sizes, and the padded results are
  dropped.

`tools/serve_torch.py` exposes this over HTTP.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import Optional, Tuple

import numpy as np


def _pad_size(n: int, max_batch: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return min(p, max_batch)


class BatchingDetector:
    """Thread-safe micro-batching front end over one api.Detector."""

    def __init__(self, detector, max_batch: int = 32,
                 max_delay_ms: float = 10.0):
        self.detector = detector
        self.max_batch = max_batch
        self.max_delay = max_delay_ms / 1e3
        self._q: "queue.Queue[Tuple[np.ndarray, Future]]" = queue.Queue()
        # dispatcher -> fetcher handoff; maxsize=1 caps the batches in
        # flight on the device at 2 (one running, one queued)
        self._inflight: "queue.Queue" = queue.Queue(maxsize=1)
        self._stop = threading.Event()
        self.batches_run = 0
        self.images_run = 0
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._fetcher = threading.Thread(target=self._fetch_loop,
                                         daemon=True)
        self._worker.start()
        self._fetcher.start()

    def submit(self, image: np.ndarray) -> Future:
        """Enqueue one RGB uint8 image; resolves to the detect() tuple.
        After close() the future resolves at once with a RuntimeError."""
        f: Future = Future()
        if self._stop.is_set():
            f.set_exception(RuntimeError("BatchingDetector is closed"))
            return f
        self._q.put((image, f))
        return f

    def detect(self, image: np.ndarray, timeout: Optional[float] = None):
        return self.submit(image).result(timeout)

    def close(self):
        """Stop both threads; every request not answered resolves with a
        RuntimeError."""
        self._stop.set()
        self._worker.join(timeout=5)
        self._fetcher.join(timeout=5)
        while True:
            try:
                _, fut = self._q.get_nowait()
            except queue.Empty:
                break
            if not fut.done():
                fut.set_exception(RuntimeError("BatchingDetector closed "
                                               "before request ran"))
        while True:
            try:
                _, batch = self._inflight.get_nowait()
            except queue.Empty:
                break
            for _, fut in batch:
                if not fut.done():
                    fut.set_exception(RuntimeError(
                        "BatchingDetector closed before result fetched"))

    def _run(self):
        while not self._stop.is_set():
            try:
                first = self._q.get(timeout=0.1)
            except queue.Empty:
                continue
            batch = [first]
            deadline = time.monotonic() + self.max_delay
            while len(batch) < self.max_batch:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                try:
                    batch.append(self._q.get(timeout=left))
                except queue.Empty:
                    break
            images = [b[0] for b in batch]
            target = _pad_size(len(images), self.max_batch)
            padded = images + [images[-1]] * (target - len(images))
            try:
                handle = self.detector.dispatch_batch(padded)
            except Exception as e:  # resolve everyone; the server stays up
                for _, fut in batch:
                    if not fut.done():
                        fut.set_exception(e)
                continue
            handed_off = False
            while not self._stop.is_set():
                try:
                    self._inflight.put((handle, batch), timeout=0.1)
                    handed_off = True
                    break
                except queue.Full:
                    continue
            if not handed_off:
                for _, fut in batch:
                    if not fut.done():
                        fut.set_exception(RuntimeError(
                            "BatchingDetector closed before result "
                            "fetched"))

    def _fetch_loop(self):
        n_fields = 5 if self.detector.config.NUM_KEYPOINTS else 4
        while not (self._stop.is_set() and self._inflight.empty()):
            try:
                handle, batch = self._inflight.get(timeout=0.1)
            except queue.Empty:
                if self._stop.is_set():
                    break
                continue
            try:
                results = self.detector.fetch(handle)
                self.batches_run += 1
                self.images_run += len(batch)
                for (_, fut), res in zip(batch, results):
                    fut.set_result(res if res is not None
                                   else (None,) * n_fields)
            except Exception as e:
                for _, fut in batch:
                    if not fut.done():
                        fut.set_exception(e)
