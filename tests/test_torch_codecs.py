"""The port's host codecs without Pillow: `resample_bilinear` bit-equal to
Pillow's 8-bit BILINEAR resize, `resize_image`, `decode_masks` and
`decode_boxes` equal to the JAX package's (which use Pillow), and the
port importing and serving with Pillow and matplotlib refused."""

import hashlib
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from maskrcnn_tpu.config import CocoInferenceConfig, TinyConfig
from maskrcnn_tpu.data import codecs as jax_codecs
from maskrcnn_tpu_torch.data import codecs as port_codecs

REPO = Path(__file__).resolve().parent.parent

# (in_h, in_w, out_h, out_w): upscaling, downscaling (factors up to 97),
# one axis only (each pass is skipped on its own), sizes 1-97, mixed
GRID = [(1, 1, 97, 1), (1, 97, 1, 1), (2, 3, 5, 7), (7, 5, 3, 2),
        (13, 29, 13, 61), (61, 29, 13, 29), (97, 97, 1, 96),
        (96, 1, 97, 1), (33, 64, 64, 33), (80, 45, 97, 44),
        (5, 97, 97, 5), (97, 3, 2, 97), (17, 17, 17, 17), (64, 48, 91, 37)]


@pytest.mark.parametrize("mode", ["L", "RGB"])
@pytest.mark.parametrize("size", GRID, ids=lambda s: "x".join(map(str, s)))
def test_resample_bilinear_equals_pillow(mode, size):
    """Bit-equal to Image.resize(..., BILINEAR) on random and on 0/255
    (mask-like) images."""
    h, w, oh, ow = size
    rng = np.random.RandomState(h * 1000 + w * 10 + oh + ow)
    shape = (h, w) if mode == "L" else (h, w, 3)
    for img in (rng.randint(0, 256, shape, dtype=np.uint8),
                (rng.rand(*shape) > 0.5).astype(np.uint8) * 255):
        want = np.asarray(Image.fromarray(img, mode).resize(
            (ow, oh), Image.BILINEAR))
        got = port_codecs.resample_bilinear(img, oh, ow)
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


COCO_SHAPES = [(640, 480), (480, 640), (427, 640), (375, 500), (1000, 750)]


@pytest.mark.parametrize("config", [TinyConfig(), CocoInferenceConfig()],
                         ids=["tiny", "coco"])
def test_resize_image_equals_jax_on_coco_shapes(config):
    """Canvas, window and scale identical to the JAX package's
    resize_image on COCO image shapes, at TinyConfig's and the COCO
    config's dims."""
    rng = np.random.RandomState(0)
    for shape in COCO_SHAPES:
        image = rng.randint(0, 256, shape + (3,), dtype=np.uint8)
        args = (image, config.IMAGE_MIN_DIM, config.IMAGE_MAX_DIM)
        got = port_codecs.resize_image(*args)
        want = jax_codecs.resize_image(*args)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:], shape


@pytest.mark.parametrize("orig, window", [
    ((96, 120), None), ((1000, 750), None), ((50, 30), None),
    ((128, 96), None), ((96, 100), (10, 3, 106, 125)),
    ((70, 122), (0, 6, 128, 128))],
    ids=["down", "up", "far_down", "scale_1", "width_only", "height_only"])
def test_decode_masks_and_boxes_equal_jax(orig, window):
    """Canvas masks (blobs, some on the window's edges, a single pixel,
    noise, a full mask, an empty one and one set only outside the window)
    back to the original size, the port's taking them bit-packed, and
    boxes back to original coordinates, equal to the JAX package's
    decode."""
    oh, ow = orig
    canvas = 128
    rng = np.random.RandomState(oh + ow)
    _, win, scale = jax_codecs.resize_image(
        np.zeros((oh, ow, 3), np.uint8), canvas, canvas)
    top, left, bottom, right = window = window or win
    masks = np.zeros((9, canvas, canvas), bool)
    for i in range(3):
        y, x = rng.randint(0, canvas - 40, 2)
        masks[i, y:y + rng.randint(2, 40), x:x + rng.randint(2, 40)] = True
    masks[3, top:top + 9, left:left + 5] = True
    masks[3, bottom - 4:bottom, right - 7:right] = True
    masks[4, (top + bottom) // 2, (left + right) // 2] = True
    masks[5] = rng.rand(canvas, canvas) > 0.5
    masks[6] = True
    masks[8] = True
    masks[8, top:bottom, left:right] = False
    got = port_codecs.decode_masks(np.packbits(masks, axis=-1), scale,
                                   window, oh, ow)
    want = jax_codecs.decode_masks(masks, scale, window, oh, ow)
    assert got.dtype == want.dtype and got.shape == (9, oh, ow)
    np.testing.assert_array_equal(got, want)
    assert got[6].all() and got[7].sum() == 0 and got[8].sum() == 0
    boxes = (rng.rand(6, 4) * canvas).astype(np.float32)
    np.testing.assert_array_equal(
        port_codecs.decode_boxes(boxes, scale, window),
        jax_codecs.decode_boxes(boxes, scale, window))


NO_PIL = r"""
import importlib.abc, sys

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("PIL", "matplotlib"):
            raise ImportError(f"{name} refused")
        return None

sys.meta_path.insert(0, Refuse())
import numpy as np
from maskrcnn_tpu_torch import TinyConfig
from maskrcnn_tpu_torch.api import Detector
from maskrcnn_tpu_torch.data import codecs
import maskrcnn_tpu_torch.data.coco, maskrcnn_tpu_torch.eval
import maskrcnn_tpu_torch.utils.visualize
rng = np.random.RandomState(0)
canvas, window, scale = codecs.resize_image(
    rng.randint(0, 256, (90, 120, 3), dtype=np.uint8), 128, 128)
assert canvas.shape == (128, 128, 3) and scale > 1
masks = codecs.decode_masks(np.packbits(rng.rand(2, 128, 128) > 0.5, -1),
                            scale, window, 90, 120)
assert masks.shape == (2, 90, 120)
cfg = TinyConfig(DETECTION_MIN_CONFIDENCE=0.0, ORIG_MASK_CANVAS=96)
out = Detector(cfg, "cpu").detect(
    rng.randint(0, 256, (100, 120, 3), dtype=np.uint8))
assert out[0] is not None and out[3].shape[1:] == (100, 120)
import hashlib, json, os, tempfile
from maskrcnn_tpu_torch.data.coco import CocoDataset
files = ("images/sample.jpg", "images/synthetic_scene.png")
with tempfile.TemporaryDirectory() as tmp:
    ann = os.path.join(tmp, "ann.json")
    with open(ann, "w") as f:
        json.dump({"images": [{"id": i + 1, "height": 1, "width": 1,
                               "file_name": n} for i, n in enumerate(files)],
                   "annotations": [], "categories": []}, f)
    ds = CocoDataset(".", "val", 2014, cfg, annfile=ann, image_dir=".")
    for i, n in enumerate(files):
        img = ds.load_image(i + 1)
        print("DIGEST", n, img.shape, hashlib.sha256(img.tobytes()).hexdigest())
bad = sorted(k for k in sys.modules if k.split(".")[0] in ("PIL",
                                                           "matplotlib"))
print(bad)
sys.exit(1 if bad else 0)
"""


def test_port_serves_without_pillow_or_matplotlib():
    """With PIL and matplotlib refused at import, the port imports, the
    codecs resample and decode, a Detector answers a request that takes
    the resample and the host mask decode, and CocoDataset.load_image
    reads a JPEG and a PNG to the pixels Pillow decodes here."""
    proc = subprocess.run([sys.executable, "-c", NO_PIL], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    digests = [line.split(" ", 2)[1:] for line in proc.stdout.splitlines()
               if line.startswith("DIGEST ")]
    assert len(digests) == 2, proc.stdout
    for name, rest in digests:
        want = np.asarray(Image.open(REPO / name).convert("RGB"))
        assert rest == (f"{want.shape} "
                        f"{hashlib.sha256(want.tobytes()).hexdigest()}")
