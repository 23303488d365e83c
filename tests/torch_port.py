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
from pathlib import Path

import jax
import numpy as np

from maskrcnn_tpu.models.mask_rcnn import MaskRCNN as JaxMaskRCNN
from maskrcnn_tpu_torch import config as port_config_module
from maskrcnn_tpu_torch.checkpoint.convert import load_jax_params
from maskrcnn_tpu_torch.models.mask_rcnn import MaskRCNN


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
