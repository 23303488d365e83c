#!/usr/bin/env python3
"""Train the 64 px keypoint model on the keypoint gate's scenes and draw
its detections, masks and keypoints on a held-out scene (the
counterpart of tools/keypoint_demo.py, on the PyTorch/CUDA port):

    python tools/keypoint_demo_torch.py [--steps 240]
        [--out output/keypoints_torch.png] [--device cuda|cpu]

It trains tools/learning_torch.keypoint_config() (17 keypoints, a 2-conv
64-wide keypoint head) from its seeded init on
keypoint_train_batch(RandomState(3), cfg, 4) batches through
learning_torch.train (preset "all", lr 3e-3), detects the held-out
keypoint_scene(RandomState(777), cfg) with a Detector holding the trained
weights, prints the mean keypoint error over the detections matched to a
ground-truth box at IoU >= 0.5, as the JAX script does, and writes the
drawing (utils.visualize.render_instances) as a PNG at the canvas's size
(data.image_io.write_png). It exits 1 with "no detections" when the
model finds nothing. Imports torch, numpy and the port: no matplotlib,
no Pillow, nothing of JAX.
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

import learning_torch as lt  # noqa: E402


def box_iou(a, b) -> float:
    """IoU of two (y1, x1, y2, x2) boxes, 0 for an empty union (the JAX
    script's match)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    yy = max(0.0, min(a[2], b[2]) - max(a[0], b[0]))
    xx = max(0.0, min(a[3], b[3]) - max(a[1], b[1]))
    inter = yy * xx
    union = ((a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1])
             - inter)
    return inter / union if union else 0.0


def keypoint_errors(gt_boxes, gt_kps, boxes, kps):
    """For each ground-truth box, the mean pixel distance between its
    keypoints and those of the detection that overlaps it most, where
    that IoU is at least 0.5."""
    errs = []
    for gb, gk in zip(gt_boxes, gt_kps):
        ious = [box_iou(gb, b) for b in boxes]
        i = int(np.argmax(ious))
        if ious[i] >= 0.5:
            errs.append(float(np.hypot(kps[i][:, 0] - gk[:, 0],
                                       kps[i][:, 1] - gk[:, 1]).mean()))
    return errs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=lt.STEPS)
    ap.add_argument("--out", default="output/keypoints_torch.png")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if (torch.device(args.device).type == "cuda"
            and not torch.cuda.is_available()):
        print("keypoint_demo_torch: no CUDA device (pass --device cpu)",
              file=sys.stderr)
        return 1
    from maskrcnn_tpu_torch.data.image_io import write_png
    from maskrcnn_tpu_torch.utils.visualize import render_instances

    cfg = lt.keypoint_config()
    model, info = lt.train(cfg, lt.batches(lt.keypoint_train_batch,
                                           np.random.RandomState(3), cfg, 4),
                           args.steps, args.device, log_every=40,
                           tag="keypoints")
    print(f"trained {args.steps} steps in {info['seconds']:.1f} s: last "
          f"losses {info['losses']}", flush=True)
    det = lt.detector(cfg, lt.float_state(model), args.device)
    img, gt_boxes, gt_kps = lt.keypoint_scene(np.random.RandomState(777), cfg)
    class_ids, scores, boxes, masks, kps = det.detect(img)
    if class_ids is None:
        print("no detections: train longer (--steps)")
        return 1
    errs = keypoint_errors(gt_boxes, gt_kps, boxes, kps)
    if errs:
        print(f"mean keypoint error on matched detections: "
              f"{np.mean(errs):.2f} px (canvas {cfg.IMAGE_MAX_DIM})")
    print(f"{len(class_ids)} detections / {len(gt_boxes)} ground-truth "
          f"objects after {args.steps} steps")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    write_png(args.out, render_instances(img, boxes, masks, kps))
    print(f"saved {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
