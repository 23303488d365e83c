#!/usr/bin/env python3
"""The JAX package's learning and accuracy gates, for the PyTorch/CUDA
port: train a model from scratch on synthetic scenes, write a held-out
set as an on-disk COCO directory of PNG files, evaluate it through the
port's `CocoDataset` and `evaluate_coco`, and hold the AP to the JAX
package's floors (unchanged):

    one-class   tests/test_learning_ap.py: 240 steps, bbox AP50 >= 0.5,
                segm AP50 >= 0.3; int8 bbox AP50 >= float - 0.05
    multiclass  tests/test_learning_ap_multiclass.py: bbox AP50 >= 0.70,
                segm AP50 >= 0.60
    cascade     the same file's test_cascade_ap75_floor: the 3-stage
                cascade's bbox AP75 >= the single head's - 0.05
    keypoints   tests/test_keypoints_learning.py: OKS AP50 >= 0.5
    overfit     tools/overfit_smoke.py: 200 steps of the 128 px
                TinyConfig, then Detector.detect finds the rectangles,
                recall >= 0.75

    python tools/learning_torch.py [multiclass] [cascade] [keypoints]
        [one-class] [overfit] [--runs N] [--steps 240] [--json-out FILE]
        [--device cuda|cpu]

(no gate named: multiclass, cascade and keypoints; chip_smoke.py's
phase 9 runs one-class, overfit and keypoints). Each run prints a
line a gate and fails (exit 1) on a missed floor; --json-out writes the
runs' AP with the card's name and power limit.

The scenes and held-out directories are copies of the JAX gates'
builders (tests/test_learning_ap.py, tests/test_keypoints_learning.py,
tests/synthetic_scenes.make_multiclass_coco_dir), with the port's RLE
encoder and PNG writer; the multiclass scenes are
tests/synthetic_scenes.py's own (numpy only). The training loop mirrors
the JAX gates' (preset "all", lr 3e-3, batch 4, numpy seed 3) over the
port's train_step. chip_smoke.py (phase 9) and the full-width tools
(tools/*_ap*_torch.py) share this module. Imports torch, numpy and the
port; nothing of JAX or Pillow.
"""

from __future__ import annotations

import argparse
import hashlib
import itertools
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests"))

from synthetic_scenes import (multiclass_scene,  # noqa: E402
                              multiclass_train_batch)

# the JAX gates' floors
FLOORS = {"one-class": {"bbox_AP50": 0.5, "segm_AP50": 0.3,
                        "int8_bbox_AP50_below_float": 0.05},
          "multiclass": {"bbox_AP50": 0.70, "segm_AP50": 0.60},
          "cascade": {"bbox_AP75_below_single": 0.05},
          "keypoints": {"keypoints_AP50": 0.5},
          "overfit": {"recall": 0.75}}
STEPS = 240
LR = 3e-3
CASCADE = (0.5, 0.6, 0.7)


def gate_config(**overrides):
    """The JAX gates' 64 px TinyConfig: anchor scales halved so objects
    and anchors keep the 1024 px config's ratios, every detection kept."""
    from maskrcnn_tpu_torch import TinyConfig
    return TinyConfig(IMAGE_MIN_DIM=64, IMAGE_MAX_DIM=64,
                      RPN_ANCHOR_SCALES=(4, 8, 16, 32, 64),
                      DETECTION_MIN_CONFIDENCE=0.0, **overrides)


def keypoint_config():
    """tests/test_keypoints_learning.py's config: 17 keypoints, a 2-conv
    64-wide keypoint head."""
    return gate_config(NUM_KEYPOINTS=17, KEYPOINT_HEAD_CONVS=2,
                       KEYPOINT_HEAD_DIM=64)


def full_config(**overrides):
    """The full-width tools' config (tools/protocol_ap_ab.py): ResNet-101,
    1024², 81 classes, bf16, every detection kept, 8 gt slots."""
    from maskrcnn_tpu_torch import CocoInferenceConfig
    overrides.setdefault("MAX_GT_INSTANCES", 8)
    return CocoInferenceConfig(DETECTION_MIN_CONFIDENCE=0.0, **overrides)


# ------------------------------------------------------------- the scenes

def scene(rng, cfg):
    """One scene: 1-2 solid rectangles on a dark background
    (tests/test_learning_ap.py _scene)."""
    d = cfg.IMAGE_MAX_DIM
    img = np.full((d, d, 3), 30, np.uint8)
    boxes = []
    for _ in range(rng.randint(1, 3)):
        y1, x1 = rng.randint(3, int(d * 0.5), 2)
        h, w = rng.randint(int(d * 0.25), int(d * 0.42), 2)
        y2, x2 = min(y1 + h, d - 1), min(x1 + w, d - 1)
        img[y1:y2, x1:x2] = (220, 40, 40)
        boxes.append((y1, x1, y2, x2))
    return img, boxes


def _empty_batch(cfg, b):
    d, g = cfg.IMAGE_MAX_DIM, cfg.MAX_GT_INSTANCES
    return {"images": np.zeros((b, d, d, 3), np.uint8),
            "gt_class_ids": np.zeros((b, g), np.int32),
            "gt_boxes": np.zeros((b, g, 4), np.float32),
            "gt_masks": np.zeros((b, g, d, d), np.uint8),
            "gt_valid": np.zeros((b, g), bool)}


def train_batch(rng, cfg, b):
    """A batch of one-class scenes (tests/test_learning_ap.py
    _train_batch)."""
    out = _empty_batch(cfg, b)
    for i in range(b):
        out["images"][i], scene_boxes = scene(rng, cfg)
        for j, (y1, x1, y2, x2) in enumerate(scene_boxes):
            out["gt_class_ids"][i, j] = 1
            out["gt_boxes"][i, j] = [y1, x1, y2, x2]
            out["gt_valid"][i, j] = True
            out["gt_masks"][i, j, y1:y2, x1:x2] = 1
    return out


# 17 keypoints on a fixed 4x4 grid and the centre of each box (fractions
# of its height and width; tests/test_keypoints_learning.py _FRACS)
KP_FRACS = [(fy, fx) for fy in (0.125, 0.375, 0.625, 0.875)
            for fx in (0.125, 0.375, 0.625, 0.875)] + [(0.5, 0.5)]


def keypoint_scene(rng, cfg):
    """1-2 solid rectangles with keypoints at the grid fractions
    (tests/test_keypoints_learning.py _scene)."""
    d = cfg.IMAGE_MAX_DIM
    img = np.full((d, d, 3), 30, np.uint8)
    boxes, kps = [], []
    for _ in range(rng.randint(1, 3)):
        y1, x1 = rng.randint(3, int(d * 0.5), 2)
        h, w = rng.randint(int(d * 0.3), int(d * 0.45), 2)
        y2, x2 = min(y1 + h, d - 1), min(x1 + w, d - 1)
        img[y1:y2, x1:x2] = (220, 40, 40)
        boxes.append((y1, x1, y2, x2))
        kp = np.zeros((17, 3), np.float32)
        for j, (fy, fx) in enumerate(KP_FRACS):
            kp[j] = [y1 + fy * (y2 - y1), x1 + fx * (x2 - x1), 2.0]
        kps.append(kp)
    return img, boxes, kps


def keypoint_train_batch(rng, cfg, b):
    """tests/test_keypoints_learning.py _train_batch."""
    out = _empty_batch(cfg, b)
    out["gt_keypoints"] = np.zeros((b, cfg.MAX_GT_INSTANCES, 17, 3),
                                   np.float32)
    for i in range(b):
        out["images"][i], scene_boxes, scene_kps = keypoint_scene(rng, cfg)
        for j, (y1, x1, y2, x2) in enumerate(scene_boxes):
            out["gt_class_ids"][i, j] = 1
            out["gt_boxes"][i, j] = [y1, x1, y2, x2]
            out["gt_valid"][i, j] = True
            out["gt_masks"][i, j, y1:y2, x1:x2] = 1
            out["gt_keypoints"][i, j] = scene_kps[j]
    return out


def overfit_batch(rng, cfg, b):
    """tools/overfit_smoke.py make_batch: 1-2 rectangles a scene."""
    d = cfg.IMAGE_MAX_DIM
    out = _empty_batch(cfg, b)
    out["images"][:] = 30
    for i in range(b):
        for j in range(rng.randint(1, 3)):
            y1, x1 = rng.randint(5, int(d * 0.55), 2)
            h, w = rng.randint(int(d * 0.23), int(d * 0.4), 2)
            y2, x2 = min(y1 + h, d - 1), min(x1 + w, d - 1)
            out["images"][i, y1:y2, x1:x2] = (220, 40, 40)
            out["gt_class_ids"][i, j] = 1
            out["gt_boxes"][i, j] = [y1, x1, y2, x2]
            out["gt_valid"][i, j] = True
            out["gt_masks"][i, j, y1:y2, x1:x2] = 1
    return out


def extent_box(mask: np.ndarray):
    """Mask-extent box [y1, x1, y2, x2], max + 1 exclusive
    (tests/synthetic_scenes.py _extent_box)."""
    rows = np.where(np.any(mask, axis=1))[0]
    cols = np.where(np.any(mask, axis=0))[0]
    return [float(rows[0]), float(cols[0]),
            float(rows[-1]) + 1.0, float(cols[-1]) + 1.0]


# ------------------------------------------------- held-out COCO directories

def _coco_root(root: Path):
    root = Path(root) / "coco"
    (root / "annotations").mkdir(parents=True, exist_ok=True)
    (root / "val2014").mkdir(exist_ok=True)
    return root


def _write_coco(root: Path, images, anns, categories) -> str:
    with open(root / "annotations" / "instances_minival2014.json", "w") as f:
        json.dump({"images": images, "annotations": anns,
                   "categories": categories}, f)
    return str(root)


def _rect_ann(aid, image_id, y1, x1, y2, x2, **extra):
    poly = [float(x1), float(y1), float(x2), float(y1),
            float(x2), float(y2), float(x1), float(y2)]
    return {"id": aid, "image_id": image_id, "category_id": 1,
            "bbox": [float(x1), float(y1), float(x2 - x1), float(y2 - y1)],
            "area": float((x2 - x1) * (y2 - y1)), "iscrowd": 0,
            "segmentation": [poly], **extra}


def _write_image(root: Path, i: int, img: np.ndarray, d: int):
    from maskrcnn_tpu_torch.data.image_io import write_png
    # png keeps the edges exact (a jpg's ringing would blur the mask
    # boundary segm AP measures)
    name = f"COCO_val2014_{i:012d}.png"
    write_png(root / "val2014" / name, img)
    return {"id": i, "height": d, "width": d, "file_name": name}


ALL_CATEGORIES = [{"id": c, "name": f"c{c}"} for c in range(1, 91)]


def make_coco_dir(tmp_path, cfg, n_images: int = 8) -> str:
    """The one-class held-out set, seeds 500 + i (tests/test_learning_ap.py
    _make_coco_dir)."""
    root = _coco_root(tmp_path)
    d = cfg.IMAGE_MAX_DIM
    images, anns = [], []
    for i in range(1, n_images + 1):
        img, scene_boxes = scene(np.random.RandomState(500 + i), cfg)
        for box in scene_boxes:
            anns.append(_rect_ann(len(anns) + 1, i, *box))
        images.append(_write_image(root, i, img, d))
    return _write_coco(root, images, anns, ALL_CATEGORIES)


def make_keypoint_coco_dir(tmp_path, cfg, n_images: int = 8) -> str:
    """The keypoint held-out set, COCO (x, y, v) keypoints
    (tests/test_keypoints_learning.py _make_coco_dir)."""
    root = _coco_root(tmp_path)
    d = cfg.IMAGE_MAX_DIM
    images, anns = [], []
    for i in range(1, n_images + 1):
        img, scene_boxes, scene_kps = keypoint_scene(
            np.random.RandomState(500 + i), cfg)
        for box, kp in zip(scene_boxes, scene_kps):
            flat = [float(t) for (ky, kx, v) in kp for t in (kx, ky, v)]
            anns.append(_rect_ann(len(anns) + 1, i, *box, keypoints=flat,
                                  num_keypoints=17))
        images.append(_write_image(root, i, img, d))
    return _write_coco(root, images, anns, [{"id": 1, "name": "person"}])


def make_multiclass_coco_dir(tmp_path, cfg, n_images: int = 16,
                             seed0: int = 500) -> str:
    """The multiclass held-out set: compressed-RLE segmentations and
    iscrowd annotations (tests/synthetic_scenes.make_multiclass_coco_dir)."""
    from maskrcnn_tpu_torch.eval import rle as rle_lib
    root = _coco_root(tmp_path)
    d = cfg.IMAGE_MAX_DIM
    images, anns = [], []
    n_crowd = 0
    for i in range(1, n_images + 1):
        img, inst = multiclass_scene(np.random.RandomState(seed0 + i), d)
        for it in inst:
            r = rle_lib.encode(np.asfortranarray(it["mask"]))
            counts = r["counts"]
            if isinstance(counts, bytes):
                counts = counts.decode("ascii")
            y1, x1, y2, x2 = extent_box(it["mask"])
            n_crowd += it["iscrowd"]
            anns.append({
                "id": len(anns) + 1, "image_id": i,
                "category_id": it["class_id"],
                "bbox": [x1, y1, x2 - x1, y2 - y1],
                "area": float(it["mask"].sum()),
                "iscrowd": int(it["iscrowd"]),
                "segmentation": {"size": [d, d], "counts": counts}})
        images.append(_write_image(root, i, img, d))
    if not n_crowd:
        raise ValueError("the held-out set holds no iscrowd region")
    return _write_coco(root, images, anns, ALL_CATEGORIES)


# ---------------------------------------------------------------- training

def batches(make, rng, cfg, b):
    """Fresh batches, one a step: make(rng, cfg, b)."""
    return (make(rng, cfg, b) for _ in itertools.count())


def device_pool(make, rng, cfg, b, n, device):
    """n batches made with make(rng, cfg, b), the gt masks bit-packed, put
    on the device once and cycled (the full-width tools' pool: fresh
    1024² batches would make the host set the pace)."""
    from maskrcnn_tpu_torch.train.trainer import to_device
    pool = []
    for _ in range(n):
        batch = make(rng, cfg, b)
        batch["gt_masks_packed"] = np.packbits(batch.pop("gt_masks"), axis=-1)
        pool.append(to_device(batch, device))
    return itertools.cycle(pool)


def train(cfg, batch_iter, steps: int, device, lr: float = LR,
          log_every: int = 60, tag: str = "", trace: list = None,
          init_state=None):
    """Train MaskRCNN(cfg) from its seeded init (torch seed 0), or from
    `init_state` (a float32 torch-layout state of numpy arrays), for
    `steps` SGD steps under preset "all" (train/trainer.py's masks), the
    samplers drawing from a torch generator seeded 1 on the device. batch_iter
    yields numpy batches or batches already on the device; a list `trace`
    gets each step's losses (0-d device tensors). Returns (model, info):
    the wall seconds, their mean a step, the median step after two
    warm-ups (host clock, two steps in flight: the card's pace once it
    sets it), the last losses and the trained state's digest
    (`state_digest`)."""
    from maskrcnn_tpu_torch.models.mask_rcnn import MaskRCNN
    from maskrcnn_tpu_torch.train.step import make_optimizer, train_step
    from maskrcnn_tpu_torch.train.trainer import (LAYER_REGEX, decay_mask,
                                                  to_device, trainable_mask)
    model = MaskRCNN(cfg, device, train=True).init(
        torch.Generator().manual_seed(0))
    if init_state is not None:
        from maskrcnn_tpu_torch.checkpoint.convert import load_state
        load_state(model, init_state)
    regex = LAYER_REGEX["all"]
    tmask, dmask = trainable_mask(model, regex), decay_mask(model, regex)
    params = []
    for name, p in model.named_parameters():
        p.requires_grad_(tmask[name])
        if tmask[name]:
            params.append((name, p))
    opt = make_optimizer(cfg, lr, [p for _, p in params],
                         [dmask[n] for n, _ in params])
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(1)
    cuda = dev.type == "cuda"
    done = []
    t0 = time.perf_counter()
    marks = []
    for step in range(steps):
        marks.append(time.perf_counter())
        batch = next(batch_iter)
        if not torch.is_tensor(batch["images"]):
            batch = to_device(batch, dev)
        metrics = train_step(model, opt, batch, gen)
        if trace is not None:
            trace.append(metrics)
        if cuda:
            # at most two steps in flight, as Trainer.fit
            event = torch.cuda.Event()
            event.record()
            done.append(event)
            if step >= 2:
                done[step - 2].synchronize()
        if log_every and step % log_every == 0:
            print(f"[{tag}] step {step}: total={float(metrics['total']):.3f}"
                  f" ({time.perf_counter() - t0:.1f} s)", flush=True)
    losses = {k: float(v) for k, v in metrics.items()}
    seconds = time.perf_counter() - t0
    marks.append(time.perf_counter())
    gaps = np.diff(marks[2:]) * 1e3
    if not np.isfinite(losses["total"]):
        raise RuntimeError(f"[{tag}] the last loss is not finite: {losses}")
    return model, {"steps": steps, "seconds": seconds,
                   "ms_per_step": seconds * 1e3 / max(steps, 1),
                   "median_ms": float(np.median(gaps)) if len(gaps) else None,
                   "losses": losses, "state_sha256": state_digest(model)}


def float_state(model):
    """The model's state as float32 numpy arrays (what
    checkpoint.convert.load_state takes)."""
    return {k: v.detach().to("cpu", torch.float32).numpy()
            for k, v in model.state_dict().items()}


def state_digest(model) -> str:
    """SHA-256 of the model's state as float32, tensor after tensor in
    state_dict order, each name then its bytes: one training run's
    fingerprint (the same seeds give the same digest)."""
    digest = hashlib.sha256()
    for name, value in float_state(model).items():
        digest.update(name.encode())
        digest.update(np.ascontiguousarray(value).tobytes())
    return digest.hexdigest()


def detector(cfg, state, device, calib_images=None):
    """An inference Detector of cfg holding the trained float32 state."""
    from maskrcnn_tpu_torch.api import Detector
    from maskrcnn_tpu_torch.checkpoint.convert import load_state
    det = Detector(cfg, device, calib_images=calib_images)
    load_state(det.model, state)
    return det


def save_state(path, state) -> None:
    """A float32 state (numpy) as a torch.save file."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({k: torch.from_numpy(v) for k, v in state.items()}, path)


def load_state_file(path):
    """save_state's file back as float32 numpy arrays."""
    return {k: v.numpy() for k, v in
            torch.load(path, map_location="cpu", weights_only=True).items()}


def write_record(path, record) -> None:
    """A JSON record (the tools' results), written again after each arm so
    a cut run keeps what it measured."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(record, f, indent=1)


def _summary(stats):
    s = [float(v) for v in stats]
    return {"AP": s[0], "AP50": s[1], "AP75": s[2]}


def evaluate(det, root: str, kinds=("bbox", "segm"), limit: int = 8,
             batch_size: int = 4):
    """{kind: {AP, AP50, AP75}} of `det` over the COCO directory `root`
    (minival 2014 names) through CocoDataset and evaluate_coco."""
    from maskrcnn_tpu_torch.data.coco import CocoDataset
    from maskrcnn_tpu_torch.eval.evaluate import evaluate_coco
    ds = CocoDataset(root, "minival", 2014, det.config)
    return {k: _summary(evaluate_coco(det, ds, ds.coco, k, limit=limit,
                                      batch_size=batch_size))
            for k in kinds}


def calib_scenes(make_image, n: int):
    """n calibration frames of the training distribution: make_image(rng)
    with seeds 900 + i."""
    return np.stack([make_image(np.random.RandomState(900 + i))
                     for i in range(n)])


# ------------------------------------------------------------------- gates

def box_iou(a, b):
    """IoU of two (y1, x1, y2, x2) boxes (tools/overfit_smoke.py)."""
    yy1, xx1 = max(a[0], b[0]), max(a[1], b[1])
    yy2, xx2 = min(a[2], b[2]), min(a[3], b[3])
    inter = max(0.0, yy2 - yy1) * max(0.0, xx2 - xx1)

    def area(r):
        return (r[2] - r[0]) * (r[3] - r[1])
    return inter / max(area(a) + area(b) - inter, 1e-9)


def overfit_recall(det, rng, samples: int = 4):
    """tools/overfit_smoke.py's judge: `samples` fresh scenes through
    Detector.detect; a rectangle is found by a class-1 detection scoring
    above 0.5 at box IoU above 0.5. Returns (found, total, mask IoUs)."""
    hits = total = 0
    mask_ious = []
    for _ in range(samples):
        sample = overfit_batch(rng, det.config, 1)
        valid = sample["gt_valid"][0]
        gts, gt_masks = sample["gt_boxes"][0][valid], sample["gt_masks"][0][valid]
        out = det.detect(sample["images"][0])
        found = [] if out[0] is None else list(zip(*out[:4]))
        for gt, gt_mask in zip(gts, gt_masks):
            best, best_miou = 0.0, 0.0
            for cid, score, box, mask in found:
                iou = box_iou(gt, box)
                if iou > best and score > 0.5 and cid == 1:
                    m, g = np.asarray(mask, bool), gt_mask.astype(bool)
                    best, best_miou = iou, (m & g).sum() / max((m | g).sum(), 1)
            total += 1
            if best > 0.5:
                hits += 1
                mask_ious.append(float(best_miou))
    return hits, total, mask_ious


def _check(ok: bool, what: str, failures: list) -> None:
    if not ok:
        failures.append(what)


def one_class_gate(device, tmp, steps: int = STEPS):
    """tests/test_learning_ap.py on the port: train, evaluate bbox and segm
    over the 8 held-out scenes, then the int8 Detector (4 calibration
    scenes) with int8 RoI tables and without. Returns (record,
    failures)."""
    cfg = gate_config()
    rng = np.random.RandomState(3)
    model, info = train(cfg, batches(train_batch, rng, cfg, 4), steps, device,
                        tag="one-class")
    state = float_state(model)
    root = make_coco_dir(Path(tmp) / "one_class", cfg)
    rec = {"train": info,
           "float": evaluate(detector(cfg, state, device), root)}
    calib = calib_scenes(lambda r: scene(r, cfg)[0], 4)
    q = cfg.replace(QUANT_INT8=True)
    rec["int8"] = evaluate(detector(q, state, device, calib), root, ("bbox",))
    rec["int8_bf16_roi"] = evaluate(
        detector(q.replace(QUANT_INT8_ROI=False), state, device, calib), root,
        ("bbox",))
    f = FLOORS["one-class"]
    fb, fs = rec["float"]["bbox"]["AP50"], rec["float"]["segm"]["AP50"]
    failures = []
    _check(fb >= f["bbox_AP50"], f"one-class bbox AP50 {fb:.3f} < 0.5",
           failures)
    _check(fs >= f["segm_AP50"], f"one-class segm AP50 {fs:.3f} < 0.3",
           failures)
    qb = rec["int8"]["bbox"]["AP50"]
    _check(qb >= fb - f["int8_bbox_AP50_below_float"],
           f"one-class int8 bbox AP50 {qb:.3f} vs float {fb:.3f}", failures)
    return rec, failures


OVERFIT_STEPS = 200


def overfit_gate(device, steps: int = OVERFIT_STEPS, keep=None):
    """tools/overfit_smoke.py on the port: TinyConfig (128 px, every
    detection kept) trained from scratch on its rectangle scenes (200
    steps at B=4, numpy seed 3), then Detector.detect on 4 more scenes of
    the same generator: recall >= 0.75. Returns (record, failures); a
    dict `keep` gets the trained float32 state and the config."""
    from maskrcnn_tpu_torch import TinyConfig
    cfg = TinyConfig(DETECTION_MIN_CONFIDENCE=0.0)
    rng = np.random.RandomState(3)
    model, info = train(cfg, batches(overfit_batch, rng, cfg, 4), steps,
                        device, log_every=50, tag="overfit")
    state = float_state(model)
    if keep is not None:
        keep.update(state=state, config=cfg)
    hits, total, mask_ious = overfit_recall(detector(cfg, state, device),
                                            rng)
    rec = {"train": info, "found": hits, "total": total,
           "recall": hits / total, "mask_iou": mask_ious}
    failures = []
    _check(hits >= total * FLOORS["overfit"]["recall"],
           f"overfit recall {hits}/{total} < 0.75", failures)
    return rec, failures


def multiclass_gate(device, tmp, steps: int = STEPS):
    """tests/test_learning_ap_multiclass.py test_trained_multiclass_ap50 on
    the port. Returns (record, failures, the float32 state)."""
    cfg = gate_config()
    model, info = train(cfg, batches(multiclass_train_batch,
                                     np.random.RandomState(3), cfg, 4),
                        steps, device, tag="multiclass")
    state = float_state(model)
    root = make_multiclass_coco_dir(Path(tmp) / "multiclass", cfg,
                                    n_images=8)
    rec = {"train": info, "float": evaluate(detector(cfg, state, device),
                                            root)}
    f = FLOORS["multiclass"]
    b, s = rec["float"]["bbox"]["AP50"], rec["float"]["segm"]["AP50"]
    failures = []
    _check(b >= f["bbox_AP50"], f"multiclass bbox AP50 {b:.3f} < 0.70",
           failures)
    _check(s >= f["segm_AP50"], f"multiclass segm AP50 {s:.3f} < 0.60",
           failures)
    return rec, failures, state


def cascade_gate(device, tmp, single_state, steps: int = STEPS):
    """test_cascade_ap75_floor on the port: the 3-stage cascade trained on
    the multiclass gate's batches against the single head (the multiclass
    gate's weights: the same recipe), bbox over 8 held-out scenes."""
    cfg = gate_config()
    cas = gate_config(CASCADE_STAGES=CASCADE)
    model, info = train(cas, batches(multiclass_train_batch,
                                     np.random.RandomState(3), cas, 4),
                        steps, device, tag="cascade")
    root = make_multiclass_coco_dir(Path(tmp) / "cascade", cfg, n_images=8)
    rec = {"train": info,
           "single": evaluate(detector(cfg, single_state, device), root,
                              ("bbox",)),
           "cascade": evaluate(detector(cas, float_state(model), device),
                               root, ("bbox",))}
    single, cascade = (rec["single"]["bbox"]["AP75"],
                       rec["cascade"]["bbox"]["AP75"])
    failures = []
    _check(cascade >= single - FLOORS["cascade"]["bbox_AP75_below_single"],
           f"cascade bbox AP75 {cascade:.3f} vs single {single:.3f}",
           failures)
    return rec, failures


def keypoint_gate(device, tmp, steps: int = STEPS):
    """tests/test_keypoints_learning.py on the port: OKS AP over 8 held-out
    scenes."""
    cfg = keypoint_config()
    model, info = train(cfg, batches(keypoint_train_batch,
                                     np.random.RandomState(3), cfg, 4),
                        steps, device, tag="keypoints")
    root = make_keypoint_coco_dir(Path(tmp) / "keypoints", cfg)
    rec = {"train": info, "float": evaluate(
        detector(cfg, float_state(model), device), root, ("keypoints",))}
    ap50 = rec["float"]["keypoints"]["AP50"]
    failures = []
    _check(ap50 >= FLOORS["keypoints"]["keypoints_AP50"],
           f"keypoint OKS AP50 {ap50:.3f} < 0.5", failures)
    return rec, failures


GATES = ("one-class", "overfit", "multiclass", "cascade", "keypoints")


def run_gates(gates, device, steps: int = STEPS):
    """Each named gate once (cascade trains the multiclass gate's single
    head too unless multiclass runs). Returns ({gate: record},
    failures)."""
    out, failures = {}, []
    single = None
    with tempfile.TemporaryDirectory() as tmp:
        if "one-class" in gates:
            rec, fails = one_class_gate(device, tmp, steps)
            out["one-class"], failures = rec, failures + fails
        if "overfit" in gates:
            rec, fails = overfit_gate(device)
            out["overfit"], failures = rec, failures + fails
        if "multiclass" in gates or "cascade" in gates:
            rec, fails, single = multiclass_gate(device, tmp, steps)
            if "multiclass" in gates:
                out["multiclass"], failures = rec, failures + fails
        if "cascade" in gates:
            rec, fails = cascade_gate(device, tmp, single, steps)
            out["cascade"], failures = rec, failures + fails
        if "keypoints" in gates:
            rec, fails = keypoint_gate(device, tmp, steps)
            out["keypoints"], failures = rec, failures + fails
    return out, failures


def gate_line(name: str, rec) -> str:
    """One printed line of a gate's AP."""
    if name == "cascade":
        return (f"bbox AP75 single {rec['single']['bbox']['AP75']:.3f} "
                f"cascade {rec['cascade']['bbox']['AP75']:.3f}")
    if name == "overfit":
        return (f"recall {rec['found']}/{rec['total']} (mask IoU "
                f"{[round(v, 2) for v in rec['mask_iou']]})")
    parts = [f"{kind} AP {v['AP']:.3f} AP50 {v['AP50']:.3f} AP75 "
             f"{v['AP75']:.3f}" for kind, v in rec["float"].items()]
    return (" / ".join(parts)
            + f" ({rec['train']['ms_per_step']:.1f} ms a step)")


def card_record(device) -> dict:
    """The device a record was measured on: the card's name and power
    limit as nvidia-smi gives them."""
    if torch.device(device).type != "cuda":
        return {"device": "cpu"}
    import chip_smoke
    return {"device": torch.cuda.get_device_name(0),
            "nvidia_smi": chip_smoke.card_info()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("gates", nargs="*", metavar="GATE",
                    help=f"of {', '.join(GATES)} (default: multiclass "
                    "cascade keypoints)")
    ap.add_argument("--runs", type=int, default=1)
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)
    gates = tuple(args.gates) or ("multiclass", "cascade", "keypoints")
    unknown = set(gates) - set(GATES)
    if unknown:
        ap.error(f"unknown gates {sorted(unknown)}")
    if args.device == "cuda" and not torch.cuda.is_available():
        print("learning_torch: no CUDA device", file=sys.stderr)
        return 1
    record = {"card": card_record(args.device), "steps": args.steps,
              "floors": FLOORS, "runs": [], "missed_floors": []}
    failed = []
    for run in range(args.runs):
        t0 = time.perf_counter()
        out, failures = run_gates(gates, args.device, args.steps)
        for name, rec in out.items():
            print(f"[learning run {run + 1}] {name}: {gate_line(name, rec)}"
                  f"; state {rec['train']['state_sha256']}", flush=True)
        print(f"[learning run {run + 1}] {time.perf_counter() - t0:.1f} s; "
              f"missed floors: {failures or 'none'}", flush=True)
        record["runs"].append(out)
        record["missed_floors"].append(failures)
        failed += failures
        if args.json_out:
            write_record(args.json_out, record)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
