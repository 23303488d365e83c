#!/usr/bin/env python3
"""(Re)generate explore_torch.ipynb, the stage-by-stage tutorial of the
PyTorch/CUDA port (the counterpart of tools/build_notebook.py and
explore.ipynb, with the same sections):

    python tools/build_notebook_torch.py      # writes explore_torch.ipynb

The notebook walks explore_torch.py's stage functions (`canvas_of`,
`features`, `anchors`, `proposals`, `detections`) and the port's
Detector, on the card when there is one. It loads
models/synthetic_trained_torch.pth (tools/train_synthetic_ckpt_torch.py)
when present and keeps the seeded weights otherwise. Its pictures are
numpy drawings (utils.visualize.render_instances) written as PNG files
under output/ (data.image_io.write_png): no matplotlib, no Pillow. The
notebook is written as nbformat 4 JSON with the json module, without
outputs, so building it needs neither nbformat nor Jupyter; run it from
the repository root (Jupyter, or chip_smoke.py's phase 10c, which runs
its code cells in order in one namespace).
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

OUT = Path(__file__).resolve().parent.parent / "explore_torch.ipynb"

CELLS = [("markdown", """\
# maskrcnn_tpu_torch tutorial: the pipeline, stage by stage

This walks the road of the JAX package's `explore.ipynb` (FPN features →
anchors → RPN proposals → detections → training) with the PyTorch/CUDA
port, on an NVIDIA GPU when there is one: every stage below is a
function of `explore_torch.py` over one `MaskRCNN` module. Weights come
from the synthetic-trained file (`tools/train_synthetic_ckpt_torch.py`:
multi-class scenes, no COCO assets here) when present, the seeded
reference init otherwise; `det_api.load_weights("models/mask_rcnn_coco.pth")`
takes the reference's COCO weights. Every picture is a numpy drawing
written as a PNG under `output/`."""),
         ("code", """\
import os

import numpy as np
import torch

from maskrcnn_tpu_torch import CocoInferenceConfig
from maskrcnn_tpu_torch.api import Detector

DEVICE = "cuda" if torch.cuda.is_available() else "cpu"
config = CocoInferenceConfig()          # ResNet-101 FPN, 81 classes, bf16
det_api = Detector(config, DEVICE)      # the seeded reference init

WEIGHTS = "models/synthetic_trained_torch.pth"
TRAINED = os.path.exists(WEIGHTS)
if TRAINED:  # tools/train_synthetic_ckpt_torch.py output
    det_api.load_weights(WEIGHTS)
    print(f"loaded {WEIGHTS}")
model = det_api.model
print(DEVICE, torch.cuda.get_device_name(0) if DEVICE == "cuda" else "")"""),
         ("markdown", """\
`model` is one `torch.nn.Module`: float32 master weights cast to the
compute dtype (bf16) as each layer runs. The same module drives
inference, training and the stage calls below. With the trained
weights the demo image is a held-out scene of the training
distribution, so every stage shows real structure."""),
         ("code", """\
import explore_torch as et
from maskrcnn_tpu_torch.data.image_io import read_image, write_png

demo = ("images/synthetic_scene.png" if TRAINED
        else "images/sample.jpg")   # the scene matches the trained weights
img = read_image(demo)               # PNG or baseline JPEG, no Pillow
canvas, window, scale = et.canvas_of(config, img)
feats = et.features(model, canvas)   # [P2..P6], NHWC on the device
for f in feats:
    print(tuple(f.shape))   # (1, 256, 256, 256) ... (1, 16, 16, 256)"""),
         ("markdown", """\
The backbone is ResNet-101 with *frozen* BatchNorm (the reference keeps
BN in eval mode forever, model.py:1010-1016): a constant per-channel
affine. Below, the mean P2 activation as a gray image: with trained
weights it lights up on the objects, with seeded ones it is structured
noise that follows the image."""),
         ("code", """\
os.makedirs("output", exist_ok=True)
p2 = feats[0][0].float().mean(-1).cpu().numpy()
span = max(float(p2.max() - p2.min()), 1e-12)
write_png("output/p2_features_torch.png",
          np.round(255 * (p2 - p2.min()) / span).astype(np.uint8))
print(f"P2 mean activation {p2.shape}: min {p2.min():.4f} "
      f"max {p2.max():.4f}")"""),
         ("markdown", """\
The 261,888 anchors are made once on the host (`ops/anchors.py`) in the
(level, y, x, ratio) order of the RPN head's outputs, so scores and
anchors line up one to one. Every 3000th, across the five levels:"""),
         ("code", """\
from maskrcnn_tpu_torch.utils.visualize import render_instances

anchors = et.anchors(model).cpu().numpy()   # (261888, 4) pixel coords
shown = anchors[::3000]
cyan = [(0.0, 1.0, 1.0)] * len(shown)
write_png("output/anchors_torch.png",
          render_instances(canvas, shown, colors=cyan))
print(f"{len(anchors):,} anchors (every 3000th drawn)")"""),
         ("markdown", """\
The RPN head is one weight-shared conv over the five levels. The
proposal layer (`detection/pipeline.rpn_refine`: top-k, box decode,
clip, NMS) runs on the device; its NMS is the greedy NMS kernel
(`csrc/nms.cu`), one launch for the batch, where the reference's CUDA
NMS copied a suppression bitmask back to the host (nms_cuda.cu:107-131)."""),
         ("code", """\
rois, valid = et.proposals(model, feats)
n_valid = int(valid.sum())
print(tuple(rois.shape), n_valid)    # (1, 500, 4) normalized

h, w = config.IMAGE_SHAPE[:2]
top = rois[0, :80].cpu().numpy() * np.array([h, w, h, w])
write_png("output/rpn_refine_torch.png",
          render_instances(canvas, top, colors=[(0.0, 1.0, 0.0)] * len(top)))
print(f"top RPN proposals drawn ({n_valid} survive NMS)")"""),
         ("markdown", """\
RoIAlign routes each proposal to its pyramid level
(`4 + log2(sqrt(hw)/224)`, model.py:335-338) and samples each output
cell's 2x2 bilinear footprint: on the card one kernel
(`csrc/roi_align.cu`) that takes the boxes and computes the levels and
sample points itself. The box head then classifies and refines, and
`mrn_refine` runs one class-offset NMS in place of the reference's
per-class loop (model.py:1454-1475)."""),
         ("code", """\
det = et.detections(model, feats, rois, valid, window)
print("detections:", int(det.valid.sum()))"""),
         ("markdown", """\
The mask head gives 28x28 sigmoid masks for all 81 classes a detection;
the Detector pastes the detected class's mask into the canvas on the
device and bit-packs it (`csrc/paste_pack.cu`) in place of the
reference's per-mask PIL loop. Below, class 1's masks of 8 detections."""),
         ("code", """\
from maskrcnn_tpu_torch.ops.roi_align import multilevel_roi_align_impl

with torch.inference_mode():
    mask_rois = det.boxes / torch.tensor([h, w, h, w], dtype=torch.float32,
                                         device=det.boxes.device)
    pooled_m = multilevel_roi_align_impl(feats[:4], mask_rois,
                                         config.MASK_POOL_SIZE,
                                         config.IMAGE_SHAPE)
    mask_probs = model.predict_masks(pooled_m[0])   # [D, 28, 28, 81]
print(tuple(mask_probs.shape))
strip = np.concatenate(list(mask_probs[:8, :, :, 1].float().cpu().numpy()),
                       axis=1)
write_png("output/mask_head_torch.png",
          np.round(strip * 255).astype(np.uint8))"""),
         ("markdown", """\
`Detector.detect` keeps the reference's `model.detect()` contract (an
image in, `(class_ids, scores, boxes, masks)` in the image's
coordinates out) with the resample and the mask decode on the device;
`detect_batch` is the same step at B > 1, which the reference never
could (it asserts batch 1)."""),
         ("code", """\
class_ids, scores, boxes, masks = det_api.detect(img)
if class_ids is not None:
    print(f"{len(class_ids)} detections"
          + ("" if TRAINED else " (seeded weights: arbitrary classes)"))
    write_png("output/detections_torch.png",
              render_instances(img, boxes, masks))"""),
         ("markdown", """\
Training: targets are sampled on the device (fixed-shape draws in place
of host randperm loops), the five losses and the SGD step are one
`train_step` (under torch's strict deterministic mode: the same seeds
give the same weights), and `Trainer.fit` drives it, on several GPUs
under torchrun. Below, two steps on a synthetic mini-COCO (a real
`--dataset` takes `coco_torch.py train`'s 3-stage schedule,
`Trainer.fit_coco_schedule`)."""),
         ("code", """\
import json
import tempfile

from maskrcnn_tpu_torch import CocoConfig
from maskrcnn_tpu_torch.data.coco import CocoDataset
from maskrcnn_tpu_torch.data.pipeline import BatchLoader
from maskrcnn_tpu_torch.models.mask_rcnn import MaskRCNN
from maskrcnn_tpu_torch.train.trainer import Trainer


def make_mini_coco(root, n=4):
    rng = np.random.RandomState(0)
    os.makedirs(f"{root}/annotations", exist_ok=True)
    os.makedirs(f"{root}/train2014", exist_ok=True)
    images, anns = [], []
    for i in range(1, n + 1):
        arr = (rng.rand(240, 320, 3) * 255).astype(np.uint8)
        name = f"im_{i:06d}.png"
        write_png(f"{root}/train2014/{name}", arr)
        images.append({"id": i, "file_name": name,
                       "width": 320, "height": 240})
        x0, y0 = float(rng.randint(10, 150)), float(rng.randint(10, 100))
        bw, bh = float(rng.randint(40, 100)), float(rng.randint(40, 80))
        anns.append({"id": i, "image_id": i, "category_id": 1,
                     "segmentation": [[x0, y0, x0 + bw, y0,
                                       x0 + bw, y0 + bh, x0, y0 + bh]],
                     "area": bw * bh, "bbox": [x0, y0, bw, bh],
                     "iscrowd": 0})
    with open(f"{root}/annotations/instances_train2014.json", "w") as f:
        json.dump({"images": images, "annotations": anns,
                   "categories": [{"id": 1, "name": "thing"}]}, f)
    return root


root = make_mini_coco(tempfile.mkdtemp())
tconfig = CocoConfig()
tmodel = MaskRCNN(tconfig, DEVICE, train=True).init(
    torch.Generator().manual_seed(0))
ds = CocoDataset(root, "train", 2014, tconfig)
loader = BatchLoader(ds, tconfig.BATCH_SIZE)

trainer = Trainer(tmodel, log_every=1)
trainer.fit(loader, 1e-3, 1, "heads",
            torch.Generator(device=DEVICE).manual_seed(1), steps_per_epoch=2)
loader.close()
print("losses:", {k: round(v, 3)
                  for k, v in trainer.loss_history[-1].items()})"""),
         ("markdown", """\
Layer presets (`heads`, `3+`, `4+`, `5+`, `all`) follow the reference's
regex table (model.py:1509-1523); `BatchLoader` is a threaded,
prefetching host pipeline that ships bit-packed masks. Evaluation
closes the loop: the COCO stack (RLE codec, annotation index, COCOeval)
is the port's own, with a native RLE library built with g++ on first
use."""),
         ("code", """\
from maskrcnn_tpu_torch.eval.evaluate import evaluate_coco

val_ds = CocoDataset(root, "train", 2014, tconfig)
stats = evaluate_coco(det_api, val_ds, val_ds.coco, "bbox", limit=2)
print("bbox AP (synthetic data):", stats[0])"""),
         ("markdown", """\
That is the whole surface: `predict_torch.py` and `coco_torch.py` wrap
these calls with the reference's argv. To scale out, `coco_torch.py
train` runs under torchrun one process a GPU (`--devices`, and `--sp`
to share each image's rows between GPUs), and `chip_smoke.py` runs every
path of the port on the card.""")]


def notebook() -> dict:
    """The notebook as nbformat 4 JSON (a dict), no outputs."""
    cells = []
    for i, (kind, text) in enumerate(CELLS):
        cell = {"cell_type": kind, "id": f"cell-{i:02d}", "metadata": {},
                "source": text.splitlines(keepends=True)}
        if kind == "code":
            cell.update(execution_count=None, outputs=[])
        cells.append(cell)
    return {"cells": cells,
            "metadata": {"kernelspec": {"display_name": "Python 3",
                                        "language": "python",
                                        "name": "python3"},
                         "language_info": {"name": "python"}},
            "nbformat": 4, "nbformat_minor": 5}


def code_cells(path=OUT):
    """The code cells' sources of the notebook at `path`, in order."""
    nb = json.loads(Path(path).read_text())
    return ["".join(c["source"]) for c in nb["cells"]
            if c["cell_type"] == "code"]


def main(argv=None) -> int:
    out = Path(argv[0]) if argv else OUT
    out.write_text(json.dumps(notebook(), indent=1, ensure_ascii=False)
                   + "\n")
    print(f"wrote {out} with {len(CELLS)} cells")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
