#!/usr/bin/env python
"""Train or evaluate Mask R-CNN on MS COCO with the PyTorch/CUDA port (the
counterpart of coco.py, with its argv, plus --device):

    python coco_torch.py train --dataset /path/to/coco [--year 2014]
                         [--model weights.pth] [--logs DIR]
                         [--epochs E] [--steps-per-epoch S]
                         [--curriculum 512:10,1024:20[:LR]]
                         [--augment scale=0.8:1.25,crop=0.7:1.0,color=0.2]
                         [--grad-accum A] [--keypoints K]
                         [--cascade 0.5,0.6,0.7 [--cascade-mask-last]]
                         [--device cuda|cpu]
    python coco_torch.py evaluate --dataset /path/to/coco [--year 2014]
                         [--model weights.pth] [--limit 500]
                         [--device cuda|cpu]

Training runs the CocoConfig on the train subset with minival for
validation: --epochs E trains the heads to epoch E, without it the
reference's three-stage schedule runs (heads to 40, 4+ to 120, all to
160 at LR / 10); --curriculum trains "all" over canvas stages. The newest
epoch checkpoint under --logs (torch.save, checkpoint.store) resumes the
run before --model is read; --model loads a reference-layout .pth.

Evaluation runs the minival subset through Detector.dispatch_batch/fetch
(batches of 8, two in flight) and reports COCO bbox then segm AP, then,
with --keypoints K, the OKS keypoint AP (ground truth with person
keypoints). Masks are decoded on the host, the reference-parity decode,
as coco.py does. --tta, --soft-nms SIGMA and --cascade IOUS set the
config's inference protocols. Reading the image files needs Pillow; the
Detector and the evaluation do not.

Data-parallel training runs one process a GPU under torchrun, --devices
the world size:

    torchrun --nproc_per_node 4 coco_torch.py train --dataset /path/to/coco
                         --devices 4 --epochs 1

Each rank reads its shard of the dataset (IMAGES_PER_DEVICE images a
step); rank 0 logs and writes the checkpoints. --devices above 1 outside
such a group raises ValueError; evaluation with --devices N runs one
weight replica a GPU in one process. --sp (the spatial axis) raises
NotImplementedError.
"""

import argparse
import os

import torch

from maskrcnn_tpu_torch.api import Detector
from maskrcnn_tpu_torch.config import CocoConfig, CocoInferenceConfig
from maskrcnn_tpu_torch.data.coco import CocoDataset
from maskrcnn_tpu_torch.eval import native
from maskrcnn_tpu_torch.eval.evaluate import evaluate_coco

DEFAULT_LOGS_DIR = os.path.join(os.getcwd(), "logs")
DEFAULT_DATASET_YEAR = "2014"


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Train/Eval Mask R-CNN Model on MS COCO (PyTorch/CUDA "
        "port).")
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

    if args.cascade_mask_last and not cascade:
        # without stages CASCADE_MASK_LAST would do nothing
        parser.error("--cascade-mask-last requires --cascade "
                     "(e.g. --cascade 0.5,0.6,0.7)")
    if args.command == "train":
        train(args, cascade)
        return
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


def train(args, cascade) -> None:
    """The train command (coco.py's, on one device)."""
    from maskrcnn_tpu_torch.checkpoint.convert import load_state, read_pth
    from maskrcnn_tpu_torch.data.pipeline import BatchLoader
    from maskrcnn_tpu_torch.models.mask_rcnn import MaskRCNN
    from maskrcnn_tpu_torch.train.trainer import (Trainer,
                                                  fit_canvas_curriculum)
    config = CocoConfig(NUM_DEVICES=args.devices or 1, SP_DEVICES=args.sp,
                        GRAD_ACCUM_STEPS=args.grad_accum,
                        NUM_KEYPOINTS=args.keypoints, CASCADE_STAGES=cascade,
                        CASCADE_MASK_LAST=args.cascade_mask_last)
    if config.BATCH_SIZE % max(args.grad_accum, 1):
        raise ValueError(f"BATCH_SIZE {config.BATCH_SIZE} must divide by "
                         f"--grad-accum {args.grad_accum}")
    from maskrcnn_tpu_torch import parallel
    device, rank = args.device, 0
    if config.NUM_DEVICES > 1 and "WORLD_SIZE" in os.environ:
        device = parallel.init_from_env(torch.device(args.device).type)
        rank = parallel.rank()
    if rank == 0:
        config.display()
    model = MaskRCNN(config, device, train=True).init(
        torch.Generator().manual_seed(0))
    if os.path.exists(args.model):
        load_state(model, read_pth(args.model, model.state_dict()))
        print("Loaded weights ", args.model)
    augment = None
    if args.augment:
        from maskrcnn_tpu_torch.data.augment import Augmenter
        augment = Augmenter.parse(args.augment)
        print("Augmentation:", augment)
    generator = parallel.rank_generator(1, rank, device)
    kw = {}
    if args.steps_per_epoch:
        kw["steps_per_epoch"] = args.steps_per_epoch
    loaders = []

    def loader(cfg, subset, **extra):
        ds = CocoDataset(args.dataset, subset, args.year, cfg)
        loaders.append(BatchLoader(ds, cfg.IMAGES_PER_DEVICE,
                                   shard_index=rank,
                                   num_shards=cfg.NUM_DEVICES, **extra))
        return loaders[-1]

    try:
        if args.curriculum:
            stages = []
            for part in args.curriculum.split(","):
                bits = part.split(":")
                stage = {"canvas": int(bits[0]), "epochs": int(bits[1])}
                if len(bits) > 2:
                    stage["lr"] = float(bits[2])
                stages.append(stage)
            fit_canvas_curriculum(
                config, model,
                lambda cfg: (loader(cfg, "train", augment=augment),
                             loader(cfg, "minival")),
                stages, generator, layers="all", checkpoint_dir=args.logs,
                **kw)
            return
        trainer = Trainer(model, checkpoint_dir=args.logs)
        # the newest epoch checkpoint under --logs wins over --model
        trainer.try_resume()
        train_iter = loader(config, "train", augment=augment)
        val_iter = loader(config, "minival")
        if args.epochs:
            trainer.fit(train_iter, config.LEARNING_RATE, args.epochs, "heads",
                        generator, val_iter=val_iter, **kw)
        else:
            trainer.fit_coco_schedule(train_iter, generator,
                                      val_iter=val_iter, **kw)
    finally:
        for it in loaders:
            it.close()


if __name__ == "__main__":
    main()
