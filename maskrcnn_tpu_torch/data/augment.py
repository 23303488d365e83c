"""Training-time data augmentation (beyond the reference's flip-only;
counterpart of maskrcnn_tpu/data/augment.py, numpy only).

The reference augments with a horizontal flip and nothing else
(reference data.py:806-810). This module adds the standard detection
augmentations — scale jitter, random crop (zoom-in), photometric
jitter — as host-side numpy transforms on ORIGINAL-coordinate
instances, applied inside `DetectionDataset.sample` BEFORE the canvas
resize. Batch shapes therefore stay fixed: zoom-out is a canvas-scale multiplier (the image
shrinks into more letterbox padding), zoom-in is a crop of the
original, and color jitter never touches geometry.

Usage:
    aug = Augmenter(scale_range=(0.8, 1.25), crop_range=(0.7, 1.0),
                    brightness=0.2, contrast=0.2, saturation=0.2)
    loader = BatchLoader(dataset, batch_size, augment=aug)
or from the CLI: `coco_torch.py train --augment scale=0.8:1.25,crop=0.7:1.0,color=0.2`.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Optional, Tuple

import numpy as np

from maskrcnn_tpu_torch.data.dataset import mask_extent_box


@dataclasses.dataclass
class Augmenter:
    """Stochastic per-sample augmentation policy.

    scale_range: canvas-scale multiplier drawn log-uniformly. Values
      < 1 shrink the image into more padding (zoom-out); values > 1 are
      capped by the canvas fit, so pure zoom-in should come from
      crop_range instead.
    crop_range: side-fraction of a random crop of the original image
      (zoom-in). 1.0 = no crop. Instances whose visible mask drops
      below min_visible pixels are removed; keypoints outside the crop
      become unlabeled (v=0).
    brightness/contrast/saturation: +- jitter fractions (0 disables).
    min_visible: survival threshold for cropped instances, in pixels.
    """

    scale_range: Tuple[float, float] = (1.0, 1.0)
    crop_range: Tuple[float, float] = (1.0, 1.0)
    brightness: float = 0.0
    contrast: float = 0.0
    saturation: float = 0.0
    min_visible: int = 16

    @classmethod
    def parse(cls, spec: str) -> "Augmenter":
        """Build from a CLI spec: `scale=LO:HI,crop=LO:HI,color=F` or
        the individual `brightness=F,contrast=F,saturation=F` keys."""
        kw = {}
        for part in spec.split(","):
            if not part.strip():
                continue
            key, _, val = part.partition("=")
            key = key.strip()
            if key in ("scale", "crop"):
                lo, _, hi = val.partition(":")
                kw[f"{key}_range"] = (float(lo), float(hi or lo))
            elif key == "color":
                f = float(val)
                kw.update(brightness=f, contrast=f, saturation=f)
            elif key in ("brightness", "contrast", "saturation"):
                kw[key] = float(val)
            elif key == "min_visible":
                kw[key] = int(val)
            else:
                raise ValueError(f"unknown augment key: {key!r}")
        return cls(**kw)

    # ------------------------------------------------------------------

    def __call__(self, image, label_ids, boxes, masks, kps=None):
        """(original-coordinate instances) -> (same tuple, scale_mult).

        Uses the module-level `random` RNG like the flip draw in the
        dataset loaders, so BatchLoader workers stay independent.
        """
        image, label_ids, boxes, masks, kps = self._crop(
            image, label_ids, boxes, masks, kps)
        image = self._photometric(image)
        lo, hi = self.scale_range
        if (lo, hi) == (1.0, 1.0):
            scale_mult = 1.0
        else:
            # log-uniform: 0.5x and 2x equally likely around 1
            scale_mult = float(np.exp(random.uniform(np.log(lo),
                                                     np.log(hi))))
        return image, label_ids, boxes, masks, kps, scale_mult

    # ------------------------------------------------------- geometry --

    def _crop(self, image, label_ids, boxes, masks, kps):
        lo, hi = self.crop_range
        if (lo, hi) == (1.0, 1.0):
            return image, label_ids, boxes, masks, kps
        f = random.uniform(lo, hi)
        h, w = image.shape[:2]
        nh, nw = max(8, round(h * f)), max(8, round(w * f))
        if nh >= h and nw >= w:
            return image, label_ids, boxes, masks, kps
        y0 = random.randint(0, h - nh)
        x0 = random.randint(0, w - nw)

        cm = masks[:, y0:y0 + nh, x0:x0 + nw]
        visible = cm.reshape(len(cm), -1).sum(1)
        keep = visible >= self.min_visible
        if not keep.any():
            # all instances would vanish — skip the crop (keeps the
            # sample trainable rather than emitting an all-background
            # frame the sampler didn't ask for)
            return image, label_ids, boxes, masks, kps

        image = image[y0:y0 + nh, x0:x0 + nw]
        masks = np.ascontiguousarray(cm[keep])
        label_ids = np.asarray(label_ids)[keep]
        boxes = np.asarray([mask_extent_box(m) for m in masks],
                           np.float32)
        if kps is not None:
            kps = kps[keep].copy()
            ky, kx, v = kps[..., 0], kps[..., 1], kps[..., 2]
            inside = ((ky >= y0) & (ky < y0 + nh)
                      & (kx >= x0) & (kx < x0 + nw) & (v > 0))
            kps[..., 0] = np.where(inside, ky - y0, 0.0)
            kps[..., 1] = np.where(inside, kx - x0, 0.0)
            kps[..., 2] = np.where(inside, v, 0.0)
        return image, label_ids, boxes, masks, kps

    # ---------------------------------------------------- photometric --

    def _photometric(self, image):
        if not (self.brightness or self.contrast or self.saturation):
            return image
        img = image.astype(np.float32)
        if self.brightness:
            img *= 1.0 + random.uniform(-self.brightness, self.brightness)
        if self.contrast:
            mean = img.mean()
            img = (img - mean) * (1.0 + random.uniform(
                -self.contrast, self.contrast)) + mean
        if self.saturation:
            gray = img.mean(axis=2, keepdims=True)
            a = 1.0 + random.uniform(-self.saturation, self.saturation)
            img = gray + (img - gray) * a
        return np.clip(img, 0, 255).astype(np.uint8)
