#!/usr/bin/env python
"""Fine-tune on a CUSTOM dataset end to end with the PyTorch/CUDA port:
the ArrayDataset tutorial (the counterpart of tools/finetune_custom.py,
with its argv, plus --device).

Build an in-memory `ArrayDataset` from (image, instance masks, class
ids) triples, train with the port's `Trainer` and `BatchLoader`, evaluate
bbox and segm AP through the port's COCO evaluation via
`ArrayDataset.to_coco()`, and render predictions with the custom class
names (matplotlib; without it the render is skipped, the AP is still
printed). The demo task is 3-class synthetic shapes (square / disk /
triangle) at 64 px. The AP printed is this run's, beside the device it
ran on; the JAX tool's docstring figure was taken on a TPU and is no
target here.

    python tools/finetune_custom_torch.py [--steps 100] [--epochs 3]
                                          [--batch 4] [--lr 3e-3]
                                          [--device cuda|cpu]

Imports torch, numpy and the port; nothing of JAX or Pillow.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CLASS_NAMES = ["BG", "square", "disk", "triangle"]


def make_shape(rng, img, cls):
    """Paint one instance; returns its binary mask."""
    h, w = img.shape[:2]
    m = np.zeros((h, w), np.uint8)
    cy = rng.randint(14, h - 14)
    cx = rng.randint(14, w - 14)
    r = rng.randint(7, min(13, cy, cx, h - cy, w - cx))
    yy, xx = np.mgrid[0:h, 0:w]
    if cls == 1:
        m[cy - r:cy + r, cx - r:cx + r] = 1
        color = (220, 60, 60)
    elif cls == 2:
        m = (((yy - cy) ** 2 + (xx - cx) ** 2) <= r * r).astype(np.uint8)
        color = (60, 200, 60)
    else:
        m = ((np.abs(xx - cx) <= (yy - (cy - r)) // 2)
             & (yy >= cy - r) & (yy <= cy + r)).astype(np.uint8)
        color = (80, 80, 230)
    img[m > 0] = color
    return m


def make_dataset(cfg, n_images, seed):
    """`n_images` scenes of one or two shapes on a dark canvas, seeded."""
    from maskrcnn_tpu_torch.data.dataset import ArrayDataset
    rng = np.random.RandomState(seed)
    d = cfg.IMAGE_MAX_DIM
    images, masks, clses = [], [], []
    for _ in range(n_images):
        img = np.full((d, d, 3), 25, np.uint8)
        ms, cs = [], []
        for _ in range(rng.randint(1, 3)):
            c = rng.randint(1, 4)
            ms.append(make_shape(rng, img, c))
            cs.append(c)
        # later paint wins overlaps: subtract from earlier masks
        for i in range(len(ms) - 1):
            for j in range(i + 1, len(ms)):
                ms[i] = (ms[i] & ~ms[j]).astype(np.uint8)
        keep = [i for i, m in enumerate(ms) if m.sum() >= 16]
        images.append(img)
        masks.append(np.stack([ms[i] for i in keep]))
        clses.append([cs[i] for i in keep])
    return ArrayDataset(cfg, images, masks, clses, class_names=CLASS_NAMES)


def config():
    """Your config: NUM_CLASSES is 1 + your classes; the anchors scaled to
    the 64 px demo canvas."""
    from maskrcnn_tpu_torch.config import TinyConfig
    return TinyConfig(NUM_CLASSES=1 + 3, IMAGE_MIN_DIM=64, IMAGE_MAX_DIM=64,
                      RPN_ANCHOR_SCALES=(4, 8, 16, 32, 64),
                      DETECTION_MIN_CONFIDENCE=0.5)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--train-images", type=int, default=64)
    p.add_argument("--eval-images", type=int, default=16)
    p.add_argument("--out", default="output/custom_finetune.jpg")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default=cuda)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    import torch

    from maskrcnn_tpu_torch.api import Detector
    from maskrcnn_tpu_torch.checkpoint.convert import load_state
    from maskrcnn_tpu_torch.data.pipeline import BatchLoader
    from maskrcnn_tpu_torch.eval.coco_index import COCO
    from maskrcnn_tpu_torch.eval.evaluate import evaluate_coco
    from maskrcnn_tpu_torch.models.mask_rcnn import MaskRCNN
    from maskrcnn_tpu_torch.train.trainer import Trainer
    from maskrcnn_tpu_torch.utils.visualize import display_instances

    cfg = config()
    device = torch.device(args.device)
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "the CPU")

    # 1. Custom data: images + per-instance masks + labels, in memory.
    train_ds = make_dataset(cfg, args.train_images, seed=1)
    val_ds = make_dataset(cfg, args.eval_images, seed=999)

    # 2. Train with the production loop (the stage presets work too: pass
    #    "heads" to fine-tune the heads only on a real backbone).
    model = MaskRCNN(cfg, device, train=True).init(
        torch.Generator().manual_seed(0))
    trainer = Trainer(model, log_every=20)
    loader = BatchLoader(train_ds, args.batch, num_workers=2, prefetch=2)
    try:
        trainer.fit(loader, args.lr, epochs=args.epochs, layers="all",
                    generator=torch.Generator(device=device).manual_seed(1),
                    steps_per_epoch=args.steps)
    finally:
        loader.close()

    # 3. Full COCO-protocol AP on the held-out set, no file on disk.
    detector = Detector(cfg, device)
    load_state(detector.model, {k: v.detach().to("cpu", torch.float32)
                                .numpy()
                                for k, v in model.state_dict().items()})
    coco = COCO(val_ds.to_coco())
    bbox = evaluate_coco(detector, val_ds, coco, "bbox",
                         batch_size=args.batch)
    segm = evaluate_coco(detector, val_ds, coco, "segm",
                         batch_size=args.batch)
    print(f"\nbbox AP50 {bbox[1]:.3f}  segm AP50 {segm[1]:.3f} on {where} "
          f"({args.epochs} epochs x {args.steps} steps, batch {args.batch})")

    # 4. Render predictions with the custom class names.
    img = val_ds.load_image(val_ds.ids[0])
    cls, scores, boxes, masks = detector.detect(img)[:4]
    if cls is None:
        print("no detections on the render image")
    else:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        try:
            display_instances(img, np.asarray(boxes), masks, cls,
                              CLASS_NAMES, scores=scores,
                              title="custom fine-tune", save_path=args.out,
                              figsize=(6, 6))
            print(f"wrote {args.out} ({len(cls)} detections)")
        except ImportError as e:
            print(f"cannot draw the picture: {e}")
    return bbox[1], segm[1]


if __name__ == "__main__":
    main()
