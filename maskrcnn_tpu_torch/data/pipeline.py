"""Threaded host input pipeline feeding the device (counterpart of
maskrcnn_tpu/data/pipeline.py, numpy only).

The reference's DataLoader is hard-coded to batch_size=1, num_workers=0
(reference: model.py:1528-1532) and does all target sampling on the host.
Here the host only decodes images and packs fixed-shape uint8 batches
(target sampling is on the device), with a worker pool + prefetch queue
so the card does not wait on the host. Per-host sharding for
multi-process data parallelism is index-striding over the dataset.
"""

from __future__ import annotations

import os
import queue
import random
import threading
from typing import Dict, Iterator, Optional

import numpy as np


def _pack_valid(masks: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """A sample's gt masks [G, H, W] bit-packed along W: the valid slots
    (the first ones, DetectionDataset.sample's layout) packed, the padding
    slots, all zero, left as zero bytes."""
    from maskrcnn_tpu_torch.ops.bits import pack_masks
    n = int(np.count_nonzero(valid))
    out = np.zeros(masks.shape[:-1] + (-(-masks.shape[-1] // 8),), np.uint8)
    out[:n] = pack_masks(masks[:n])
    return out


def _collate(samples) -> Dict[str, np.ndarray]:
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


class BatchLoader:
    """Infinite shuffled batch iterator with background workers."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 num_workers: int = 4, prefetch: int = 4,
                 seed: int = 0, shard_index: int = 0,
                 num_shards: int = 1, hflip: bool = True,
                 pack_bits: bool = True, augment=None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.hflip = hflip
        self.pack_bits = pack_bits
        self.augment = augment  # data.augment.Augmenter or None
        self._rng = random.Random(seed)
        # per-host shard: stride over the dataset (SURVEY.md section 2.3:
        # per-host shards feeding a dp mesh)
        self._indices = list(range(shard_index, len(dataset), num_shards))
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        # bounded: the feeder waits for the workers instead of queueing
        # indices without end
        self._iq: "queue.Queue" = queue.Queue(
            maxsize=prefetch * batch_size + batch_size)
        self._stop = threading.Event()
        # each worker's torch ops (the resample) on its share of the
        # host's cores: a thread's torch pool is its own, and pools of a
        # thread a core each, one a worker, would wait on each other
        import torch
        self._worker_threads = max(1, min(
            torch.get_num_threads(),
            (os.cpu_count() or 1) // max(1, num_workers)))
        self._workers = [
            threading.Thread(target=self._worker, daemon=True)
            for _ in range(max(1, num_workers))
        ]
        self._feeder = threading.Thread(target=self._feed, daemon=True)
        self._sample_q: "queue.Queue" = queue.Queue(
            maxsize=prefetch * batch_size + batch_size)
        for w in self._workers:
            w.start()
        self._collator = threading.Thread(target=self._collate_loop,
                                          daemon=True)
        self._feeder.start()
        self._collator.start()

    def _put(self, q: "queue.Queue", item) -> bool:
        """Put item on q, waiting while it is full; False once stopped."""
        while not self._stop.is_set():
            try:
                q.put(item, timeout=0.5)
                return True
            except queue.Full:
                continue
        return False

    def _feed(self):
        while not self._stop.is_set():
            order = list(self._indices)
            if self.shuffle:
                self._rng.shuffle(order)
            for idx in order:
                if not self._put(self._iq, idx):
                    return

    def _worker(self):
        import torch
        torch.set_num_threads(self._worker_threads)
        while not self._stop.is_set():
            try:
                idx = self._iq.get(timeout=0.5)
            except queue.Empty:
                continue
            try:
                if self.augment is not None:
                    s = self.dataset.sample(idx, hflip=self.hflip,
                                            augment=self.augment)
                else:
                    s = self.dataset.sample(idx, hflip=self.hflip)
                if self.pack_bits:
                    s["gt_masks_packed"] = _pack_valid(s.pop("gt_masks"),
                                                       s["gt_valid"])
                self._put(self._sample_q, s)
            except Exception as e:  # keep the pipeline alive
                print(f"[pipeline] sample {idx} failed: {e}")

    def _collate_loop(self):
        while not self._stop.is_set():
            samples = []
            while len(samples) < self.batch_size:
                try:
                    samples.append(self._sample_q.get(timeout=0.5))
                except queue.Empty:
                    if self._stop.is_set():
                        return
            self._put(self._q, _collate(samples))

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        return self._q.get()

    def close(self):
        """Stop the threads and wait for them (a sample in progress
        finishes first)."""
        self._stop.set()
        for t in [self._feeder, self._collator] + self._workers:
            t.join()


class SyntheticLoader:
    """Deterministic random batches for benchmarks and smoke tests."""

    def __init__(self, config, batch_size: int, seed: int = 0):
        self.config = config
        self.batch_size = batch_size
        self._rng = np.random.RandomState(seed)
        self._batch = self._make()

    def _make(self) -> Dict[str, np.ndarray]:
        cfg = self.config
        b = self.batch_size
        ch, cw = cfg.IMAGE_SHAPE[:2]
        g = cfg.MAX_GT_INSTANCES
        rng = self._rng
        images = rng.randint(0, 256, (b, ch, cw, 3), np.uint8)
        cls = np.zeros((b, g), np.int32)
        boxes = np.zeros((b, g, 4), np.float32)
        valid = np.zeros((b, g), bool)
        masks = np.zeros((b, g, ch, cw), np.uint8)
        k = getattr(cfg, "NUM_KEYPOINTS", 0)
        kps = np.zeros((b, g, k, 3), np.float32) if k else None
        for i in range(b):
            for j in range(3):
                y1 = rng.uniform(0, ch * 0.5)
                x1 = rng.uniform(0, cw * 0.5)
                h = rng.uniform(ch * 0.2, ch * 0.45)
                w = rng.uniform(cw * 0.2, cw * 0.45)
                boxes[i, j] = [y1, x1, min(y1 + h, ch), min(x1 + w, cw)]
                cls[i, j] = rng.randint(1, cfg.NUM_CLASSES)
                valid[i, j] = True
                yy, xx = boxes[i, j].astype(int)[:2], boxes[i, j].astype(
                    int)[2:]
                masks[i, j, yy[0]:xx[0], yy[1]:xx[1]] = 1
                if k:
                    # labeled keypoints scattered inside the box (y, x,
                    # v); every 5th unlabeled to exercise the v=0 path
                    by1, bx1, by2, bx2 = boxes[i, j]
                    kps[i, j, :, 0] = rng.uniform(by1, by2, k)
                    kps[i, j, :, 1] = rng.uniform(bx1, bx2, k)
                    kps[i, j, :, 2] = 2.0
                    kps[i, j, ::5, 2] = 0.0
        out = {"images": images, "gt_class_ids": cls, "gt_boxes": boxes,
               "gt_masks": masks, "gt_valid": valid}
        if k:
            out["gt_keypoints"] = kps
        return out

    def __iter__(self):
        return self

    def __next__(self):
        return self._batch
