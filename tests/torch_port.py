"""Shared helpers of the port's parity tests (tests/test_torch_*.py).

Weights are made once, by the JAX package, and loaded into the port
through `checkpoint.convert.load_jax_params`; inputs are made with numpy
from a seed and handed to both sides as arrays. The JAX side gets the JAX
package's config classes and the port its own (`port_config` mirrors one
into the port's field by field).
"""

from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path

# Two intra-op threads for torch in every test process: pytest-xdist runs
# several workers on the machine's cores, and each worker's default pool
# (a thread a core, meeting at a barrier after every parallel op) then
# waits on threads the other workers hold. Two, not one: the tests'
# float32 equalities and tolerances were set on pools of several threads,
# and five of them (sharded against whole convs, gradients against JAX's)
# fail with the single thread's summation order. Set for this process
# and for the processes the tests start (the gloo ranks, the CLIs).
_THREADS = 2
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[_var] = str(_THREADS)

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(_THREADS)

from maskrcnn_tpu.models.mask_rcnn import MaskRCNN as JaxMaskRCNN  # noqa: E402
from maskrcnn_tpu_torch import config as port_config_module  # noqa: E402
from maskrcnn_tpu_torch.checkpoint.convert import load_jax_params  # noqa: E402
from maskrcnn_tpu_torch.models.mask_rcnn import MaskRCNN  # noqa: E402


def port_config(config):
    """A JAX package config as the port's config class of the same name,
    with the same fields."""
    cls = getattr(port_config_module, type(config).__name__)
    return cls(**{f.name: getattr(config, f.name)
                  for f in dataclasses.fields(config)})


def jax_params(config, seed: int = 7):
    """Reference-init JAX params with jittered BN statistics, so the
    frozen-BN affine is not the identity (as test_full_model_parity)."""
    params = JaxMaskRCNN(config).init(jax.random.PRNGKey(seed))

    def jitter(path, p):
        name = str(path[-1])
        if "running_mean" in name:
            return p + 0.3
        if "running_var" in name:
            return p * 1.7 + 0.1
        return p

    return jax.tree_util.tree_map_with_path(jitter, params)


def torch_model(config, params) -> MaskRCNN:
    """The port's model on the CPU with the JAX weights loaded (`config`
    may be either package's; the port gets its own class)."""
    model = MaskRCNN(port_config(config), "cpu")
    load_jax_params(model, params)
    return model


def edge_boxes(rng: np.random.RandomState, n: int) -> np.ndarray:
    """[n, 4] normalized boxes whose first five rows are the edge cases
    of tests/test_roi_align_pallas.py: partly outside, zero, extreme
    wide, extreme tall, bottom-right corner."""
    ctr = rng.rand(n, 2) * 0.8 + 0.1
    sz = rng.rand(n, 2) * 0.25 + 0.02
    y1 = np.clip(ctr[:, 0] - sz[:, 0] / 2, 0, 1)
    y2 = np.clip(ctr[:, 0] + sz[:, 0] / 2, 0, 1)
    x1 = np.clip(ctr[:, 1] - sz[:, 1] / 2, 0, 1)
    x2 = np.clip(ctr[:, 1] + sz[:, 1] / 2, 0, 1)
    b = np.stack([y1, x1, y2, x2], 1).astype(np.float32)
    b[0] = [-0.2, -0.2, 0.3, 0.3]
    b[1] = [0, 0, 0, 0]
    b[2] = [0.1, 0.05, 0.12, 0.95]
    b[3] = [0.05, 0.4, 0.95, 0.44]
    b[4] = [0.9, 0.9, 0.99, 0.999]
    return b


def synthetic_coco_dir(root: Path) -> str:
    """tests/test_e2e.py's COCO directory under `root`: three JPEGs of
    104-120 x 120 px, one box-and-polygon annotation each, under the
    minival 2014 names. Returns the directory."""
    from PIL import Image
    (root / "annotations").mkdir()
    (root / "val2014").mkdir()
    rng = np.random.RandomState(0)
    images, anns = [], []
    for i in range(1, 4):
        h, w = 96 + 8 * i, 120
        name = f"COCO_val2014_{i:012d}.jpg"
        Image.fromarray(rng.randint(0, 255, (h, w, 3), np.uint8)).save(
            root / "val2014" / name)
        images.append({"id": i, "height": h, "width": w, "file_name": name})
        x, y, bw, bh = 10, 20, 40, 30
        anns.append({"id": i, "image_id": i, "category_id": 1,
                     "bbox": [x, y, bw, bh], "area": bw * bh, "iscrowd": 0,
                     "segmentation": [[x, y, x + bw, y, x + bw, y + bh, x,
                                       y + bh]]})
    data = {"images": images, "annotations": anns,
            "categories": [{"id": c, "name": f"c{c}"} for c in range(1, 91)]}
    with open(root / "annotations" / "instances_minival2014.json", "w") as f:
        json.dump(data, f)
    return str(root)


def train_config(base, **overrides):
    """`base` (a JAX package config) in the samplers' deterministic regime
    (tests/test_reference_samplers_golden.py): the RPN cap is the anchor
    count, and 24 proposals and 24 head slots an image, 3 of them
    positive (ratio 0.125): with exactly three positive proposals
    (`train_batch`) the negative budget, 3 / 0.125 - 3 = 21, takes every
    other proposal, so no random subsample fires on either side."""
    from maskrcnn_tpu.ops.anchors import config_anchors
    cfg = base.replace(RPN_NMS_MAX_ROIS_NUM=24, TRAIN_ROIS_PER_IMAGE=24,
                       ROI_POSITIVE_RATIO=0.125, **overrides)
    return cfg.replace(RPN_TRAIN_ANCHORS_PER_IMAGE=len(config_anchors(cfg)))


def train_batch(config, model, b: int = 2, seed: int = 0, keypoints=0):
    """A training batch (numpy) whose gt boxes are three of the port
    model's own proposals an image, each with no other proposal at IoU
    0.5 or more, so exactly three proposals an image are positive; with
    rectangle masks. The proposals come from the port's training RPN on
    the same canvases."""
    import torch
    from maskrcnn_tpu_torch.detection.pipeline import rpn_refine
    from maskrcnn_tpu_torch.ops.boxes import box_iou
    from maskrcnn_tpu_torch.ops.image import normalize_image
    rng = np.random.RandomState(seed)
    h, w = config.IMAGE_SHAPE[:2]
    g = config.MAX_GT_INSTANCES
    images = rng.randint(0, 256, (b, h, w, 3), np.uint8)
    with torch.no_grad():
        feats = model.backbone(normalize_image(torch.from_numpy(images),
                                               config.MEAN_PIXEL))
        _, probs, deltas = model.rpn_detect(feats)
        props, pvalid = rpn_refine(model.config, model.anchors(), probs,
                                   deltas)
    cls = np.zeros((b, g), np.int32)
    boxes = np.zeros((b, g, 4), np.float32)
    valid = np.zeros((b, g), bool)
    masks = np.zeros((b, g, h, w), np.uint8)
    kps = np.zeros((b, g, keypoints, 3), np.float32)
    for i in range(b):
        picked = []
        live = props[i, pvalid[i]]
        for j in np.flatnonzero(pvalid[i].numpy()):
            box = props[i, j]
            if min(box[2] - box[0], box[3] - box[1]) * min(h, w) < 2.0:
                continue
            if int((box_iou(box[None], live)[0] >= 0.5).sum()) != 1:
                continue
            picked.append(j)
            if len(picked) == 3:
                break
        assert len(picked) == 3, "too few distinct proposals"
        for k, j in enumerate(picked):
            px = props[i, j].numpy() * np.array([h, w, h, w], np.float32)
            boxes[i, k] = px
            cls[i, k] = rng.randint(1, config.NUM_CLASSES)
            valid[i, k] = True
            y1, x1, y2, x2 = np.round(px).astype(int)
            masks[i, k, y1:y2, x1:x2] = 1
            if keypoints:
                kps[i, k, :, 0] = rng.uniform(px[0], px[2], keypoints)
                kps[i, k, :, 1] = rng.uniform(px[1], px[3], keypoints)
                kps[i, k, :, 2] = 2.0
                kps[i, k, ::3, 2] = 0.0
    out = {"images": images, "gt_class_ids": cls, "gt_boxes": boxes,
           "gt_masks": masks, "gt_valid": valid}
    if keypoints:
        out["gt_keypoints"] = kps
    return out
