#!/usr/bin/env python
"""Evaluate Mask R-CNN on MS COCO with the PyTorch/CUDA port (the
counterpart of coco.py, with its argv, plus --device):

    python coco_torch.py evaluate --dataset /path/to/coco [--year 2014]
                         [--model weights.pth] [--limit 500]
                         [--device cuda|cpu]

Evaluation runs the minival subset through Detector.dispatch_batch/fetch
(batches of 8, two in flight) and reports COCO bbox then segm AP, then,
with --keypoints K, the OKS keypoint AP (ground truth with person
keypoints). Masks are decoded on the host, the reference-parity decode,
as coco.py does. --tta, --soft-nms SIGMA and --cascade IOUS set the
config's inference protocols. Reading the image files needs Pillow; the
Detector and the evaluation do not. `train` is not ported yet (ROADMAP
Queue 1 item 5), and more than one device (--devices above 1, --sp)
reaches the config, which raises NotImplementedError.
"""

import argparse
import os

from maskrcnn_tpu_torch.api import Detector
from maskrcnn_tpu_torch.config import CocoInferenceConfig
from maskrcnn_tpu_torch.data.coco import CocoDataset
from maskrcnn_tpu_torch.eval import native
from maskrcnn_tpu_torch.eval.evaluate import evaluate_coco

DEFAULT_LOGS_DIR = os.path.join(os.getcwd(), "logs")
DEFAULT_DATASET_YEAR = "2014"


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Train/Eval Mask R-CNN Model on MS COCO (PyTorch/CUDA "
        "port; evaluate only).")
    parser.add_argument("command", metavar="<command>",
                        help="'train' or 'evaluate' on MS COCO")
    parser.add_argument("--dataset", required=True,
                        metavar="/path/to/coco/",
                        help="Directory of the MS-COCO dataset")
    parser.add_argument("--year", required=False,
                        default=DEFAULT_DATASET_YEAR, metavar="<year>",
                        help="Year of the MS-COCO dataset (default=2014)")
    parser.add_argument("--model", required=False,
                        default="models/mask_rcnn_coco.pth",
                        metavar="/path/to/weights.pth",
                        help="Path to weights (.pth)")
    parser.add_argument("--logs", required=False, default=DEFAULT_LOGS_DIR,
                        metavar="/path/to/logs/",
                        help="Logs and checkpoints directory")
    parser.add_argument("--limit", required=False, default=500,
                        metavar="<image count>",
                        help="Images to use for evaluation (default=500)")
    parser.add_argument("--devices", required=False, default=None, type=int,
                        help="Device count (default 1; more is not ported)")
    parser.add_argument("--sp", required=False, default=1, type=int,
                        help="Spatial partitioning (not ported)")
    parser.add_argument("--steps-per-epoch", required=False, default=None,
                        type=int, help="Override STEPS_PER_EPOCH (train)")
    parser.add_argument("--epochs", required=False, default=None, type=int,
                        help="Train a single stage to this epoch (train)")
    parser.add_argument("--curriculum", required=False, default=None,
                        metavar="SPEC", help="canvas curriculum (train)")
    parser.add_argument("--augment", required=False, default=None,
                        metavar="SPEC", help="training augmentation (train)")
    parser.add_argument("--grad-accum", required=False, default=1,
                        type=int, help="Gradient accumulation (train)")
    parser.add_argument("--keypoints", required=False, default=0,
                        type=int, metavar="K",
                        help="Keypoint branch with K keypoints (17 = COCO "
                        "person keypoints); adds the keypoint AP")
    parser.add_argument("--soft-nms", required=False, default=0.0,
                        type=float, metavar="SIGMA",
                        help="gaussian Soft-NMS sigma (0 = hard NMS)")
    parser.add_argument("--tta", action="store_true",
                        help="horizontal-flip test-time augmentation")
    parser.add_argument("--cascade", required=False, default=None,
                        metavar="IOUS",
                        help="Cascade R-CNN stage IoUs, e.g. 0.5,0.6,0.7")
    parser.add_argument("--cascade-mask-last", action="store_true",
                        help="Cascade Mask R-CNN placement (train)")
    parser.add_argument("--device", required=False, default="cuda",
                        help="torch device to run on (default=cuda)")
    return parser


def main(argv=None) -> None:
    parser = build_parser()
    args = parser.parse_args(argv)
    cascade = (tuple(float(x) for x in args.cascade.split(","))
               if args.cascade else ())
    print("Command: ", args.command)
    print("Model: ", args.model)
    print("Dataset: ", args.dataset)
    print("Year: ", args.year)
    print("Logs: ", args.logs)

    if args.command == "train":
        raise NotImplementedError(
            "coco_torch.py train: training is not ported to "
            "maskrcnn_tpu_torch yet (ROADMAP Queue 1 item 5); train with "
            "coco.py")
    if args.command != "evaluate":
        print(f"'{args.command}' is not recognized. "
              "Use 'train' or 'evaluate'")
        return

    # host mask decode, the reference-parity decode (as coco.py evaluates)
    config = CocoInferenceConfig(NUM_DEVICES=args.devices or 1,
                                 SP_DEVICES=args.sp,
                                 DEVICE_MASK_DECODE=False,
                                 NUM_KEYPOINTS=args.keypoints,
                                 TTA_HFLIP=args.tta,
                                 DETECTION_SOFT_NMS_SIGMA=args.soft_nms,
                                 CASCADE_STAGES=cascade)
    config.display()
    detector = Detector(config, device=args.device)
    if os.path.exists(args.model):
        detector.load_weights(args.model)
        print("Loaded weights ", args.model)
    else:
        print("Weight file not found ...")
    print("RLE route: "
          + ("native (native/rle_kernels.cpp, built under build/)"
             if native.available() else "numpy"))
    val_ds = CocoDataset(args.dataset, "minival", args.year, config)
    limit = int(args.limit)
    print(f"Running COCO evaluation on {limit} images.")
    eval_types = ("bbox", "segm") + (("keypoints",) if args.keypoints
                                     else ())
    for eval_type in eval_types:
        evaluate_coco(detector, val_ds, val_ds.coco, eval_type, limit=limit,
                      batch_size=8)


if __name__ == "__main__":
    main()
