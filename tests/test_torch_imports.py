"""The port's package boundary: nothing of JAX or of the JAX package at
import, its own configs and resize, the card by default, the weight
bridge, the anchors."""

import ast
import dataclasses
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from maskrcnn_tpu import config as jax_config_module
from maskrcnn_tpu.checkpoint.torch_convert import to_torch_state_dict
from maskrcnn_tpu.config import CocoInferenceConfig, TinyConfig
from maskrcnn_tpu.data import codecs as jax_codecs
from maskrcnn_tpu.ops.anchors import config_anchors
from maskrcnn_tpu_torch import config as port_config_module
from maskrcnn_tpu_torch.api import Detector
from maskrcnn_tpu_torch.checkpoint.convert import from_jax_params
from maskrcnn_tpu_torch.data import codecs as port_codecs
from maskrcnn_tpu_torch.models.mask_rcnn import MaskRCNN
from maskrcnn_tpu_torch.ops import anchors as port_anchors
from tests.torch_port import jax_params, port_config

REPO = Path(__file__).resolve().parent.parent
SLICE_MODULES = (
    "maskrcnn_tpu_torch", "maskrcnn_tpu_torch.api",
    "maskrcnn_tpu_torch.kernels", "maskrcnn_tpu_torch.checkpoint.convert",
    "maskrcnn_tpu_torch.checkpoint.fold", "maskrcnn_tpu_torch.ops.bottleneck",
    "maskrcnn_tpu_torch.detection.pipeline",
    "maskrcnn_tpu_torch.models.fpn", "maskrcnn_tpu_torch.models.heads",
    "maskrcnn_tpu_torch.models.mask_rcnn", "maskrcnn_tpu_torch.models.resnet",
    "maskrcnn_tpu_torch.models.rpn", "maskrcnn_tpu_torch.ops.anchors",
    "maskrcnn_tpu_torch.ops.bits", "maskrcnn_tpu_torch.ops.boxes",
    "maskrcnn_tpu_torch.ops.image", "maskrcnn_tpu_torch.ops.mask_paste",
    "maskrcnn_tpu_torch.ops.nms", "maskrcnn_tpu_torch.ops.roi_align",
    "maskrcnn_tpu_torch.ops.int8_conv", "maskrcnn_tpu_torch.quant",
    "maskrcnn_tpu_torch.config", "maskrcnn_tpu_torch.data.codecs",
    "maskrcnn_tpu_torch.ops.group_roi", "maskrcnn_tpu_torch.models.layers",
    "maskrcnn_tpu_torch.data.coco", "maskrcnn_tpu_torch.eval",
    "maskrcnn_tpu_torch.eval.rle", "maskrcnn_tpu_torch.eval.native",
    "maskrcnn_tpu_torch.eval.coco_index", "maskrcnn_tpu_torch.eval.cocoeval",
    "maskrcnn_tpu_torch.eval.evaluate", "maskrcnn_tpu_torch.utils.progress",
    "maskrcnn_tpu_torch.utils.visualize", "maskrcnn_tpu_torch.train",
    "maskrcnn_tpu_torch.train.targets", "maskrcnn_tpu_torch.train.losses",
    "maskrcnn_tpu_torch.train.step", "maskrcnn_tpu_torch.train.trainer",
    "maskrcnn_tpu_torch.checkpoint.store", "maskrcnn_tpu_torch.data.dataset",
    "maskrcnn_tpu_torch.data.augment", "maskrcnn_tpu_torch.data.pipeline",
    "maskrcnn_tpu_torch.serving", "maskrcnn_tpu_torch.models.retina_fpn",
    "maskrcnn_tpu_torch.parallel", "maskrcnn_tpu_torch.export",
    "maskrcnn_tpu_torch.kernels.torch_ops",
    "maskrcnn_tpu_torch.utils.profiler", "maskrcnn_tpu_torch.utils.canvas",
    "maskrcnn_tpu_torch.data.image_io", "maskrcnn_tpu_torch.parallel.spatial",
    "maskrcnn_tpu_torch.data.native_image",
    "maskrcnn_tpu_torch.utils.native_build",
    "predict_torch", "coco_torch", "explore_torch", "tools.serve_torch",
    "tools.finetune_custom_torch", "tools.export_model_torch",
    "tools.learning_torch", "tools.protocol_ap_ab_torch",
    "tools.int8_ablation_gate_torch", "tools.int8_ap_gate_torch",
    "tools.int8_calib_diag_torch", "tools.keypoint_demo_torch",
    "tools.train_synthetic_ckpt_torch", "tools.build_notebook_torch")
# packages the port must not import: JAX, flax, the JAX package itself
# (even its modules that import no JAX) and Pillow (the card's machine has
# none: the port reads image files with data/image_io.py)
FORBIDDEN = ("jax", "flax", "maskrcnn_tpu", "PIL")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_port_imports_no_jax():
    """Every slice module and port tool imports in a fresh interpreter
    without JAX, flax, any module of the JAX package or Pillow (the card's
    machine has neither JAX nor Pillow, and the port keeps its own copies
    of what it needs)."""
    code = ("import importlib, sys\n"
            f"for m in {SLICE_MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            f"bad = sorted(k for k in sys.modules if any(k == f or "
            f"k.startswith(f + '.') for f in {FORBIDDEN!r}))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _imported_names(path: Path):
    """Every module named by an import statement in the file, at any
    depth (imports inside functions included)."""
    return _names_in(path.read_text())


def _names_in(source: str):
    """Every module named by an import statement in Python source."""
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", ["chip_smoke.py", "maskrcnn_tpu_torch",
                                  "predict_torch.py", "coco_torch.py",
                                  "tools/serve_torch.py",
                                  "tools/chip_phases.py",
                                  "tools/ab_trees.py",
                                  "tools/learning_torch.py",
                                  "tools/protocol_ap_ab_torch.py",
                                  "tools/int8_ablation_gate_torch.py",
                                  "tools/int8_ap_gate_torch.py",
                                  "tools/int8_calib_diag_torch.py",
                                  "explore_torch.py",
                                  "tools/finetune_custom_torch.py",
                                  "tools/export_model_torch.py",
                                  "tests/torch_sp_worker.py",
                                  "tools/keypoint_demo_torch.py",
                                  "tools/train_synthetic_ckpt_torch.py",
                                  "tools/build_notebook_torch.py",
                                  "tools/ab_train_torch.py",
                                  "tools/image_decode_bench_torch.py"])
def test_port_sources_import_nothing_of_jax(path):
    """chip_smoke.py, the port's CLIs and tools and every source file of
    the port, read with ast: no import of JAX, flax, the JAX package or
    Pillow, even inside a function."""
    root = REPO / path
    files = sorted(root.rglob("*.py")) if root.is_dir() else [root]
    assert files
    bad = [(str(f.relative_to(REPO)), name) for f in files
           for name in _imported_names(f) if _forbidden(name)]
    assert not bad, bad


# the card's machine has neither nbformat nor matplotlib: the demo scripts
# and the notebook draw with numpy and write JSON and PNG themselves
DEMO_FORBIDDEN = FORBIDDEN + ("nbformat", "matplotlib")


@pytest.mark.parametrize("path", ["tools/keypoint_demo_torch.py",
                                  "tools/train_synthetic_ckpt_torch.py",
                                  "tools/build_notebook_torch.py",
                                  "explore_torch.ipynb"])
def test_demo_sources_import_no_jax_pil_nbformat_matplotlib(path):
    """The demo scripts and every code cell of explore_torch.ipynb, read
    with ast: no import of JAX, flax, the JAX package, Pillow, nbformat
    or matplotlib, even inside a function."""
    root = REPO / path
    if root.suffix == ".ipynb":
        cells = ["".join(c["source"]) for c in
                 json.loads(root.read_text())["cells"]
                 if c["cell_type"] == "code"]
    else:
        cells = [root.read_text()]
    assert cells
    names = [name for src in cells for name in _names_in(src)]
    bad = [n for n in names if any(n == f or n.startswith(f + ".")
                                   for f in DEMO_FORBIDDEN)]
    assert names and not bad, bad


# a ctypes (or dlopen) load of a system image codec: the port decodes
# WebP, GIF, BMP, TIFF (Deflate included), JPEG 2000 and AVIF with its own
# sources (csrc/), never with libwebp, giflib, libtiff, zlib's library,
# OpenJPEG's, libavif, libaom, dav1d or libyuv
CODEC_LOAD = re.compile(r"(find_library|CDLL|LoadLibrary|dlopen)\s*\("
                        r"[^)]*\b(lib)?(webp|gif|tiff|z|openjp2|avif|aom|"
                        r"dav1d|yuv)\b")


@pytest.mark.parametrize("path", ["chip_smoke.py", "maskrcnn_tpu_torch",
                                  "predict_torch.py", "coco_torch.py",
                                  "explore_torch.py", "tools/serve_torch.py",
                                  "tools/image_decode_bench_torch.py"])
def test_port_sources_load_no_system_codec(path):
    """The port's sources and image-reading scripts, read as text: no
    ctypes or dlopen load of libwebp, giflib, libtiff, libz, libavif,
    libaom, dav1d or libyuv, and the C++ decoders include no codec
    library's header (zlib.h, tiffio.h, aom/, dav1d/ and avif/ among
    them)."""
    root = REPO / path
    files = (sorted(root.rglob("*.py")) + sorted(root.rglob("*.cpp"))
             if root.is_dir() else [root])
    bad = [str(f.relative_to(REPO)) for f in files
           if CODEC_LOAD.search(f.read_text())
           or re.search(r"#include\s*[<\"](webp|gif_lib|png|jpeglib|zlib|"
                        r"tiffio|tiff|openjpeg|aom|dav1d|avif|libyuv)",
                        f.read_text())]
    assert not bad, bad


CONFIG_CLASSES = ("Config", "CocoConfig", "CocoInferenceConfig",
                  "TinyConfig")
DERIVED = ("BATCH_SIZE", "IMAGE_SHAPE", "BACKBONE_SHAPES", "NUM_ANCHORS",
           "PRE_NMS_LIMIT")


@pytest.mark.parametrize("name", CONFIG_CLASSES)
def test_port_config_equals_jax_config(name, capsys):
    """The port's copy of each config class: the same fields in the same
    order with the same defaults, the same derived properties, and the
    same `replace` and `display`."""
    port_cls = getattr(port_config_module, name)
    jax_cls = getattr(jax_config_module, name)
    assert dataclasses.is_dataclass(port_cls)
    pf, jf = dataclasses.fields(port_cls), dataclasses.fields(jax_cls)
    assert [f.name for f in pf] == [f.name for f in jf]
    port, ref = port_cls(), jax_cls()
    for f in jf:
        assert getattr(port, f.name) == getattr(ref, f.name), f.name
    for prop in DERIVED:
        assert getattr(port, prop) == getattr(ref, prop), prop
    kw = dict(IMAGE_MAX_DIM=256, IMAGE_MIN_DIM=256, IMAGES_PER_DEVICE=2)
    port2, ref2 = port.replace(**kw), ref.replace(**kw)
    assert type(port2) is port_cls
    for prop in DERIVED:
        assert getattr(port2, prop) == getattr(ref2, prop), prop
    assert port2.display() == ref2.display()
    capsys.readouterr()
    with pytest.raises(dataclasses.FrozenInstanceError):
        port.NAME = "other"


@pytest.mark.parametrize("size", [(50, 70), (300, 200), (128, 96)],
                         ids=["scale_up", "scale_down", "scale_1"])
def test_port_resize_image_bit_equal(size):
    """The port's resize_image against the JAX package's: canvas, window
    and scale identical for an image scaled up, scaled down and kept."""
    rng = np.random.RandomState(sum(size))
    image = rng.randint(0, 256, size + (3,), dtype=np.uint8)
    for args in ((128, 128), (64, 128, (128, 160))):
        got = port_codecs.resize_image(image, *args)
        want = jax_codecs.resize_image(image, *args)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]
    if size == (128, 96):
        assert got[2] == 1.0


def test_resize_image_without_pil_names_pillow(monkeypatch, tmp_path):
    """Without PIL, resize_image still resamples (the port resamples
    without Pillow) and equals the JAX package's canvas, and
    CocoDataset.load_image reads a real PNG and a real JPEG (the port's
    own reader, data/image_io.py) to the pixels Pillow decoded before PIL
    was refused."""
    from PIL import Image
    from maskrcnn_tpu_torch.data.coco import CocoDataset
    rng = np.random.RandomState(4)
    image = rng.randint(0, 256, (50, 70, 3), dtype=np.uint8)
    want = jax_codecs.resize_image(image, 128, 128)
    files = ("images/synthetic_scene.png", "images/sample.jpg")
    pillow = [np.asarray(Image.open(REPO / f).convert("RGB")) for f in files]
    monkeypatch.setitem(sys.modules, "PIL", None)
    got = port_codecs.resize_image(image, 128, 128)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]
    ann = tmp_path / "ann.json"
    ann.write_text(json.dumps({"images": [
        {"id": i + 1, "height": p.shape[0], "width": p.shape[1],
         "file_name": f} for i, (f, p) in enumerate(zip(files, pillow))],
        "annotations": [], "categories": []}))
    ds = CocoDataset(str(REPO), "val", 2014, None, annfile=str(ann),
                     image_dir=str(REPO))
    for i, want_pixels in enumerate(pillow):
        np.testing.assert_array_equal(ds.load_image(i + 1), want_pixels)


@pytest.mark.parametrize("entry", ["Detector", "MaskRCNN"])
def test_entry_points_default_to_the_card(entry, monkeypatch):
    """With no device given the entry points want the card: without one
    they raise, naming device="cpu", and never run on the CPU unasked;
    with "cpu" they run there."""
    cfg = port_config_module.TinyConfig()
    make = Detector if entry == "Detector" else MaskRCNN
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        make(cfg)
    obj = make(cfg, "cpu")
    model = obj if entry == "MaskRCNN" else obj.model
    assert model.anchor_boxes.device.type == "cpu"
    assert model.rpn.conv_shared.weight.device.type == "cpu"


@pytest.mark.parametrize("arch", ["resnet50", "resnet101"])
def test_from_jax_params_matches_torch_convert(arch):
    """The torch-free bridge equals the JAX package's converter key for
    key and array for array, and loads into the port with strict=True."""
    cfg = TinyConfig().replace(BACKBONE=arch)
    params = jax_params(cfg)
    want = to_torch_state_dict(params, arch)
    got = from_jax_params(params, arch)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    model = MaskRCNN(port_config(cfg), "cpu")
    model.load_state_dict({k: torch.tensor(v) for k, v in got.items()},
                          strict=True)


@pytest.mark.parametrize("config", [TinyConfig(), CocoInferenceConfig()],
                         ids=["tiny", "coco_inference"])
def test_anchors_bit_equal(config):
    got = port_anchors.config_anchors(port_config(config))
    want = config_anchors(config)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
