#!/usr/bin/env python
"""Stage-by-stage pipeline exploration with the PyTorch/CUDA port (the
counterpart of explore.py, with its argv, plus --device):

    python explore_torch.py [-model weights.pth] [-stage p2|anchors|rpn|detect]
                            [-output explore_output.png] [--device cuda|cpu]
                            image

It composes the model's stage APIs one by one, as explore.py does:
MaskRCNN.backbone -> rpn_detect -> detection.pipeline.rpn_refine ->
multilevel RoIAlign -> classify -> mrn_refine, prints each stage's
numbers and renders the stage asked for. Each stage is a function that
returns its tensors (`features`, `anchors`, `proposals`, `detections`),
so a script can call the stages without the CLI. The RoIAlign is the
device dispatch (`ops.roi_align.multilevel_roi_align_impl`): K1 on the
card, the plain `multilevel_roi_align` on the CPU. The image file (JPEG,
PNG, WebP, GIF, BMP or TIFF, its first image) is read without Pillow
(data/image_io.py, which names the modes it refuses). Drawing
needs matplotlib; without it the stages still run and print, and the CLI
says that it cannot draw the picture.
"""

import argparse
import os

import numpy as np
import torch

from maskrcnn_tpu_torch.api import Detector
from maskrcnn_tpu_torch.config import CocoInferenceConfig
from maskrcnn_tpu_torch.data.codecs import resize_image
from maskrcnn_tpu_torch.data.image_io import read_image
from maskrcnn_tpu_torch.detection.pipeline import mrn_refine, rpn_refine
from maskrcnn_tpu_torch.ops import device_tensor
from maskrcnn_tpu_torch.ops.image import normalize_image
from maskrcnn_tpu_torch.ops.roi_align import multilevel_roi_align_impl

STAGES = ("p2", "anchors", "rpn", "detect")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Mask RCNN Explorer "
                                     "(PyTorch/CUDA port)")
    parser.add_argument("-model", type=str,
                        default=os.path.join(os.getcwd(),
                                             "models/mask_rcnn_coco.pth"))
    parser.add_argument("-stage", type=str, default="detect", choices=STAGES)
    parser.add_argument("-output", type=str, default="explore_output.png")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to run on [cuda]")
    parser.add_argument("image", type=str)
    return parser


def canvas_of(config, image: np.ndarray):
    """An image on the config's canvas: (canvas [H, W, 3] uint8, window
    (y1, x1, y2, x2), scale), as the Detector places it on the host."""
    return resize_image(image, config.IMAGE_MIN_DIM, config.IMAGE_MAX_DIM,
                        canvas_shape=tuple(config.IMAGE_SHAPE[:2]))


@torch.inference_mode()
def features(model, canvas: np.ndarray):
    """A uint8 canvas -> [P2..P6], each [1, h, w, 256] (NHWC) on the
    model's device."""
    dev = model.anchor_boxes.device
    x = torch.from_numpy(np.ascontiguousarray(canvas[None])).to(dev)
    return model.backbone(normalize_image(x, model.config.MEAN_PIXEL))


def anchors(model) -> torch.Tensor:
    """Pixel-space anchors [A, 4] (y1, x1, y2, x2) on the model's
    device."""
    return model.anchors()


@torch.inference_mode()
def proposals(model, feats):
    """The RPN's training-form outputs through the proposal layer:
    (proposals [1, R, 4] normalized, valid [1, R])."""
    _, probs, deltas = model.rpn_detect(feats)
    return rpn_refine(model.config, model.anchors(), probs, deltas)


@torch.inference_mode()
def detections(model, feats, rois, valid, window):
    """RoIAlign over P2-P5 at the proposals, the box head and
    mrn_refine: the image's Detections ([1, D] each)."""
    cfg = model.config
    pooled = multilevel_roi_align_impl(feats[:4], rois, cfg.POOL_SIZE,
                                       cfg.IMAGE_SHAPE)
    r = rois.shape[1]
    _, probs, deltas = model.classify(pooled.reshape(r, *pooled.shape[2:]))
    win = device_tensor([list(window)], torch.float32, rois.device)
    return mrn_refine(cfg, rois, valid, probs.reshape(1, r, -1),
                      deltas.reshape(1, r, cfg.NUM_CLASSES, 4), win)


def _draw(render) -> None:
    """Run a drawing call; without matplotlib say that the picture is not
    drawn (the stage's numbers are printed already)."""
    try:
        render()
    except ImportError as e:
        print(f"cannot draw the picture: {e}")


def _p2_grid(p2: np.ndarray, path: str) -> None:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, axes = plt.subplots(4, 4, figsize=(12, 12))
    for i, ax in enumerate(axes.flat):
        ax.imshow(p2[:, :, i], cmap="viridis")
        ax.axis("off")
    plt.savefig(path, bbox_inches="tight")
    plt.close(fig)


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    from maskrcnn_tpu_torch.utils.visualize import display_instances
    config = CocoInferenceConfig()
    detector = Detector(config, device=args.device)
    if os.path.exists(args.model):
        detector.load_weights(args.model)
    else:
        print("Weight file not found ...")
    model = detector.model

    canvas, window, _ = canvas_of(config, read_image(args.image))
    feats = features(model, canvas)

    if args.stage == "p2":
        # the first 16 channels of P2 as a tiled grid
        p2 = feats[0][0].float().cpu().numpy()
        print(f"P2 features {p2.shape}: mean {p2.mean():.4f} std "
              f"{p2.std():.4f}")
        _draw(lambda: _p2_grid(p2, args.output))
        return

    boxes = anchors(model).cpu().numpy()
    if args.stage == "anchors":
        centers = ((boxes[:, :2] + boxes[:, 2:]) / 2).astype(int)
        print(f"{len(boxes)} anchors; first center {centers[0]}, "
              f"last {centers[-1]}")
        _draw(lambda: display_instances(canvas, boxes[:3], None,
                                        np.zeros(3, int), ["BG"], None,
                                        save_path=args.output))
        return

    rois, valid = proposals(model, feats)
    if args.stage == "rpn":
        v = valid[0].cpu().numpy()
        h, w = config.IMAGE_SHAPE[:2]
        shown = rois[0].cpu().numpy()[v][:50] * np.array([h, w, h, w])
        print(f"{int(v.sum())} proposals after NMS; showing top 50")
        _draw(lambda: display_instances(canvas, shown, None,
                                        np.zeros(len(shown), int), ["BG"],
                                        None, save_path=args.output))
        return

    det = detections(model, feats, rois, valid, window)
    v = det.valid[0].cpu().numpy()
    print(f"{int(v.sum())} detections")
    _draw(lambda: display_instances(
        canvas, det.boxes[0].cpu().numpy()[v], None,
        det.class_ids[0].cpu().numpy()[v],
        [str(i) for i in range(config.NUM_CLASSES)],
        det.scores[0].cpu().numpy()[v], save_path=args.output))


if __name__ == "__main__":
    main()
