#!/usr/bin/env python3
"""Train the full-width model on the multiclass synthetic scenes and save
its weights as a `.pth` the port's `Detector.load_weights` reads (the
counterpart of tools/train_synthetic_ckpt.py, on the PyTorch/CUDA port):

    python tools/train_synthetic_ckpt_torch.py [--steps 240] [--batch 8]
        [--lr 3e-3] [--out models/synthetic_trained_torch.pth]
        [--device cuda|cpu]

Config: CocoInferenceConfig(DETECTION_MIN_CONFIDENCE=0.0,
MAX_GT_INSTANCES=8) (ResNet-101, 1024², 81 classes, bf16;
tools/learning_torch.full_config). A pool of 10 multiclass_train_batch(
RandomState(3), cfg, --batch) batches, the masks bit-packed, is put on
the device once and cycled through tools/learning_torch.train (its seeded
init, preset "all"), as tools/protocol_ap_ab_torch.py's get_state trains.
The float32 state is written with torch.save (`models/` is not
committed). The demo scene that goes with the weights is the JAX tool's
images/synthetic_scene.png, which this script does not rewrite: it checks
first that data/image_io.read_image of it equals
multiclass_scene(RandomState(501), 1024) pixel for pixel.
explore_torch.py -model and build_notebook_torch.py's notebook load the
file. Imports torch, numpy and the port: nothing of JAX or Pillow.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

import learning_torch as lt  # noqa: E402

POOL = 10
SCENE = lt.REPO / "images" / "synthetic_scene.png"


def scene_matches(path=SCENE, side: int = 1024) -> bool:
    """Whether the image file at `path` holds multiclass_scene(
    RandomState(501), side), pixel for pixel."""
    from maskrcnn_tpu_torch.data.image_io import read_image
    want, _ = lt.multiclass_scene(np.random.RandomState(501), side)
    return np.array_equal(read_image(path), want)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=lt.STEPS)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=lt.LR)
    ap.add_argument("--out", default="models/synthetic_trained_torch.pth")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if (torch.device(args.device).type == "cuda"
            and not torch.cuda.is_available()):
        print("train_synthetic_ckpt_torch: no CUDA device (pass --device "
              "cpu)", file=sys.stderr)
        return 1
    cfg = lt.full_config()
    if not scene_matches(side=cfg.IMAGE_MAX_DIM):
        print(f"{SCENE} is not multiclass_scene(RandomState(501), "
              f"{cfg.IMAGE_MAX_DIM})", file=sys.stderr)
        return 1
    print(f"{SCENE.name}: multiclass_scene(RandomState(501)) pixel for pixel",
          flush=True)
    t0 = time.perf_counter()
    pool = lt.device_pool(lt.multiclass_train_batch, np.random.RandomState(3),
                          cfg, args.batch, POOL, args.device)
    model, info = lt.train(cfg, pool, args.steps, args.device, lr=args.lr,
                           log_every=40, tag="synthetic")
    lt.save_state(args.out, lt.float_state(model))
    print(f"weights saved: {args.out} ({args.steps} steps at B={args.batch}, "
          f"{time.perf_counter() - t0:.1f} s, median {info['median_ms']} ms a "
          f"step; last losses {info['losses']}; state "
          f"{info['state_sha256']})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
