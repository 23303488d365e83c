#!/usr/bin/env python
"""Single-image Mask R-CNN inference CLI of the PyTorch/CUDA port (the
counterpart of predict.py, with its argv, plus --device):

    python predict_torch.py [-model /path/to/weights.pth] [-output out.png]
                            [--device cuda|cpu] <image>

Loads the reference `mask_rcnn_coco.pth` when it exists (random weights
otherwise), prints one line a detection (label id, Chinese name, box,
score) and saves the overlay. The image file (JPEG, PNG, WebP, GIF, BMP,
TIFF, Netpbm, TGA, QOI, ICO, CUR, DIB, PCX, DCX, SGI or Sun raster; a
TIFF's first image, its Orientation applied as Pillow applies it) is
read without Pillow (data/image_io.py, which names the modes it
refuses); drawing needs matplotlib, the Detector does not. -tta (flip
test-time augmentation), -soft-nms SIGMA and -cascade IOUS set the
config's inference protocols; the reference `.pth` has no cascade heads,
so they keep their initialization (the Detector prints so).
"""

import argparse
import os

import numpy as np

from maskrcnn_tpu_torch.api import Detector
from maskrcnn_tpu_torch.config import CocoInferenceConfig
from maskrcnn_tpu_torch.data.coco import COCO_CLASS_NAMES, CocoLabel
from maskrcnn_tpu_torch.data.image_io import read_image
from maskrcnn_tpu_torch.utils.visualize import display_instances

COCO_MODEL_PATH = os.path.join(os.getcwd(), "models/mask_rcnn_coco.pth")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Mask RCNN Predictor "
                                     "(PyTorch/CUDA port)")
    parser.add_argument("-model", type=str, default=COCO_MODEL_PATH,
                        help=f"trained model [{COCO_MODEL_PATH}]")
    parser.add_argument("-output", type=str, default=None,
                        help="save the rendered overlay to this path")
    parser.add_argument("-tta", action="store_true",
                        help="horizontal-flip test-time augmentation "
                        "(config.TTA_HFLIP)")
    parser.add_argument("-soft-nms", type=float, default=0.0, metavar="S",
                        help="gaussian Soft-NMS sigma instead of hard "
                        "detection NMS (0 = off)")
    parser.add_argument("-cascade", type=str, default=None, metavar="IOUS",
                        help="Cascade R-CNN stage IoUs, e.g. '0.5,0.6,0.7' "
                        "(config.CASCADE_STAGES)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to run on [cuda]")
    parser.add_argument("image", type=str, help="image file")
    return parser


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    cascade = (tuple(float(x) for x in args.cascade.split(","))
               if args.cascade else ())
    config = CocoInferenceConfig(
        TTA_HFLIP=args.tta, DETECTION_SOFT_NMS_SIGMA=args.soft_nms,
        CASCADE_STAGES=cascade)

    detector = Detector(config, device=args.device)
    if os.path.exists(args.model):
        detector.load_weights(args.model)
    else:
        print("Weight file not found ...")

    img = read_image(args.image)
    class_ids, scores, boxes, masks = detector.detect(img)

    if class_ids is not None:
        for i, j in enumerate(class_ids):
            print(j, CocoLabel.zh_name(j), boxes[i], scores[i])
        display_instances(
            img, np.array(boxes), np.array(masks), np.array(class_ids),
            COCO_CLASS_NAMES, np.array(scores),
            save_path=args.output or "predict_output.png")
    else:
        print("nothing detected")


if __name__ == "__main__":
    main()
