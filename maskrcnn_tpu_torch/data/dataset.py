"""Generic dataset contract + in-memory dataset for custom fine-tuning
(counterpart of maskrcnn_tpu/data/dataset.py, numpy only).

The reference lineage (matterport-style Mask R-CNN) is built around a
user-subclassable Dataset; the reference fork hard-codes COCO
(reference: data.py:695-884). This module restores the generic surface
the port's way: a subclass supplies original-coordinate instances
(`load`), and the base class produces the fixed-shape canvas batches the
train step consumes (`sample`: fixed shapes, whatever the dataset).

Two consumers define the contract:
  * training — `data.pipeline.BatchLoader` calls `len(ds)` and
    `ds.sample(index, hflip=...)`;
  * evaluation — `eval.evaluate.evaluate_coco` calls `ds.ids`,
    `ds.load_image(image_id)` and `ds.class_id(label)`.

`ArrayDataset` is the batteries-included implementation: hand it
in-memory images + instance masks + class ids and it trains, and its
`to_coco()` builds the COCO-format annotation dict (RLE-encoded) that
feeds the full bbox/segm/keypoints AP stack without any files on disk.
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional, Sequence

import numpy as np

from maskrcnn_tpu_torch.data.codecs import (encode_boxes, encode_masks,
                                            resize_image)


def mask_extent_box(mask: np.ndarray) -> List[float]:
    """Tight (y1, x1, y2, x2) box around a binary mask; zeros if empty.

    Same extent rule the COCO loader applies (reference data.py:837-848):
    inclusive pixel extents with the +1 open end.
    """
    cols = np.any(mask, axis=0)
    rows = np.any(mask, axis=1)
    if not cols.any():
        return [0.0, 0.0, 0.0, 0.0]
    y1, y2 = np.where(rows)[0][[0, -1]]
    x1, x2 = np.where(cols)[0][[0, -1]]
    return [float(y1), float(x1), float(y2) + 1.0, float(x2) + 1.0]


class DetectionDataset:
    """Base class for instance-segmentation datasets.

    Subclasses set ``self.config`` and implement:
      * ``__len__``
      * ``load(index, hflip) -> (image, label_ids, boxes, masks[, kps])``
        in ORIGINAL image coordinates — image HxWx3 uint8, label_ids
        [N] int32 (negative = crowd), boxes [N, 4] (y1, x1, y2, x2)
        float32, masks [N, H, W] uint8, optional keypoints [N, K, 3]
        (y, x, v) float32 when ``config.NUM_KEYPOINTS`` is set.

    For evaluation through ``evaluate_coco`` a subclass also provides
    ``ids`` (the evaluation image-id list), ``load_image(image_id)`` and
    ``class_id(label)`` (contiguous label -> annotation category id).
    """

    config = None  # set by subclasses

    def __len__(self) -> int:  # pragma: no cover - contract
        raise NotImplementedError

    def load(self, index: int, hflip: bool = False):  # pragma: no cover
        raise NotImplementedError

    def sample(self, index: int, hflip: bool = True,
               augment=None) -> Dict[str, np.ndarray]:
        """One fixed-shape training example (canvas coords, padded gt).

        The original-coordinate instances from ``load`` go through the
        reference's resize/pad protocol (data.py:439-504 via
        data/codecs.py) and are padded to ``MAX_GT_INSTANCES`` static
        slots, so every batch has the same shapes.

        augment: optional ``data.augment.Augmenter`` applied to the
        original-coordinate instances before the canvas resize — the
        output shapes stay fixed.
        """
        cfg = self.config
        nk = getattr(cfg, "NUM_KEYPOINTS", 0)
        loaded = self.load(index, hflip=hflip)
        image, label_ids, boxes, masks = loaded[:4]
        kps = loaded[4] if nk else None
        scale_mult = 1.0
        if augment is not None:
            (image, label_ids, boxes, masks, kps,
             scale_mult) = augment(image, label_ids, boxes, masks, kps)
        ch, cw = cfg.IMAGE_SHAPE[:2]
        canvas, window, scale = resize_image(image, cfg.IMAGE_MIN_DIM,
                                             cfg.IMAGE_MAX_DIM,
                                             canvas_shape=(ch, cw),
                                             scale_mult=scale_mult)
        boxes = encode_boxes(boxes, scale, window)
        masks = encode_masks(masks, scale, window, cfg.IMAGE_MAX_DIM,
                             canvas_shape=(ch, cw))

        g = cfg.MAX_GT_INSTANCES
        n = len(label_ids)
        out_cls = np.zeros((g,), np.int32)
        out_boxes = np.zeros((g, 4), np.float32)
        out_masks = np.zeros((g, ch, cw), np.uint8)
        out_valid = np.zeros((g,), bool)
        out_cls[:n] = label_ids
        out_boxes[:n] = boxes
        out_masks[:n] = masks
        out_valid[:n] = label_ids != 0
        out = {
            "images": canvas,
            "gt_class_ids": out_cls,
            "gt_boxes": out_boxes,
            "gt_masks": out_masks,
            "gt_valid": out_valid,
        }
        if nk:
            # keypoints follow the boxes' original->canvas transform
            out_kp = np.zeros((g, nk, 3), np.float32)
            out_kp[:n, :, 0] = kps[:, :, 0] * scale + window[0]
            out_kp[:n, :, 1] = kps[:, :, 1] * scale + window[1]
            out_kp[:n, :, 2] = kps[:, :, 2]
            out_kp[:n, :, 0] *= kps[:, :, 2] > 0  # unlabeled stay (0,0)
            out_kp[:n, :, 1] *= kps[:, :, 2] > 0
            out["gt_keypoints"] = out_kp
        return out


class ArrayDataset(DetectionDataset):
    """In-memory dataset over (image, masks, class_ids) triples.

    The zero-boilerplate path for fine-tuning on a custom task: supply
    per-image instance masks and contiguous class labels (1..N-1; 0 is
    background) and the full training + evaluation stack runs on it.
    Category ids in COCO-format output are the labels themselves
    (``class_id`` is the identity), so ``config.NUM_CLASSES`` defines
    the label space.

    Args:
      config: the model Config (NUM_CLASSES must cover the labels).
      images: sequence of HxWx3 uint8 arrays (sizes may differ).
      masks: sequence of [N_i, H, W] binary uint8 arrays.
      class_ids: sequence of [N_i] int arrays/lists.
      keypoints: optional sequence of [N_i, K, 3] float arrays in
        internal (y, x, v) order, required if config.NUM_KEYPOINTS > 0.
      class_names: optional display names indexed by label
        (class_names[0] = background).
      kp_hflip_perm: left/right keypoint index permutation applied under
        a horizontal flip (identity if omitted).
    """

    def __init__(self, config, images: Sequence[np.ndarray],
                 masks: Sequence[np.ndarray],
                 class_ids: Sequence[Sequence[int]],
                 keypoints: Optional[Sequence[np.ndarray]] = None,
                 class_names: Optional[List[str]] = None,
                 kp_hflip_perm: Optional[Sequence[int]] = None):
        assert len(images) == len(masks) == len(class_ids)
        nk = getattr(config, "NUM_KEYPOINTS", 0)
        if nk:
            assert keypoints is not None and len(keypoints) == len(images), \
                "config.NUM_KEYPOINTS set but no keypoints supplied"
        self.config = config
        self.images = [np.asarray(im, np.uint8) for im in images]
        self.masks = [np.asarray(m, np.uint8) for m in masks]
        self.class_ids = [np.asarray(c, np.int32) for c in class_ids]
        self.keypoints = ([np.asarray(k, np.float32) for k in keypoints]
                          if keypoints is not None else None)
        self.class_names = class_names
        self.kp_hflip_perm = (list(kp_hflip_perm)
                              if kp_hflip_perm is not None else None)
        for im, m, c in zip(self.images, self.masks, self.class_ids):
            assert m.ndim == 3 and m.shape[1:] == im.shape[:2], \
                f"masks {m.shape} must be [N, {im.shape[0]}, {im.shape[1]}]"
            assert len(c) == len(m)
        self.ids = list(range(1, len(self.images) + 1))

    def __len__(self) -> int:
        return len(self.images)

    # ------------------------------------------------- eval surface --

    def class_id(self, label_id: int) -> int:
        return int(label_id)

    def name(self, label_id: int) -> str:
        if self.class_names and 0 <= label_id < len(self.class_names):
            return self.class_names[label_id]
        return f"class_{label_id}"

    def load_image(self, image_id: int) -> np.ndarray:
        return self.images[image_id - 1]

    # --------------------------------------------- training surface --

    def load(self, index: int, hflip: bool = False):
        image = self.images[index]
        masks = self.masks[index]
        label_ids = self.class_ids[index]
        nk = getattr(self.config, "NUM_KEYPOINTS", 0)
        kps = self.keypoints[index].copy() if nk else None

        # stochastic flip, same contract as the COCO loader
        # (data.py:806-810): hflip=True means "flip half the time"
        flip = hflip and random.randint(0, 1)
        h, w = image.shape[:2]
        if flip:
            image = image[:, ::-1]
            masks = masks[:, :, ::-1]
            if nk:
                kps[:, :, 1] = np.where(kps[:, :, 2] > 0,
                                        w - 1 - kps[:, :, 1], kps[:, :, 1])
                if self.kp_hflip_perm is not None:
                    kps = kps[:, self.kp_hflip_perm]

        if len(label_ids) == 0:
            # empty-image fallback (reference data.py:859-867)
            label_ids = np.asarray([0], np.int32)
            boxes = np.asarray([[0.0, 0.0, float(h), float(w)]], np.float32)
            masks = np.ones((1, h, w), np.uint8)
            if nk:
                kps = np.zeros((1, nk, 3), np.float32)
        else:
            boxes = np.asarray([mask_extent_box(m) for m in masks],
                               np.float32)

        g = self.config.MAX_GT_INSTANCES
        out = (image, label_ids[:g], boxes[:g],
               np.ascontiguousarray(masks[:g]))
        if nk:
            out = out + (kps[:g],)
        return out

    # ----------------------------------------------- COCO interop --

    def to_coco(self) -> dict:
        """COCO-format annotation dict (in-memory, RLE segmentations).

        Feed it straight to ``eval.coco_index.COCO`` to run the complete
        bbox/segm/keypoints AP evaluation on this dataset — no JSON
        files required. Keypoints convert from the internal (y, x, v)
        to COCO's flat (x, y, v) order.
        """
        from maskrcnn_tpu_torch.eval import rle as rle_lib
        nk = getattr(self.config, "NUM_KEYPOINTS", 0)
        images, anns = [], []
        aid = 1
        for image_id, (im, ms, cs) in zip(
                self.ids, zip(self.images, self.masks, self.class_ids)):
            h, w = im.shape[:2]
            images.append({"id": image_id, "height": h, "width": w,
                           "file_name": f"array_{image_id:012d}.png"})
            for j, (m, c) in enumerate(zip(ms, cs)):
                if c == 0 or not m.any():
                    continue
                r = rle_lib.encode(m)
                x, y, bw, bh = [float(v) for v in rle_lib.to_bbox(r)]
                ann = {"id": aid, "image_id": image_id,
                       "category_id": int(abs(c)),
                       "segmentation": r,
                       "bbox": [x, y, bw, bh],
                       "area": float(rle_lib.area(r)),
                       "iscrowd": 1 if c < 0 else 0}
                if nk:
                    kp = self.keypoints[image_id - 1][j]
                    flat = []
                    for ky, kx, v in kp:
                        flat += [float(kx), float(ky), float(v)]
                    ann["keypoints"] = flat
                    ann["num_keypoints"] = int((kp[:, 2] > 0).sum())
                anns.append(ann)
                aid += 1
        ncat = max(2, getattr(self.config, "NUM_CLASSES", 2))
        cats = [{"id": c, "name": self.name(c)} for c in range(1, ncat)]
        return {"images": images, "annotations": anns, "categories": cats}
