"""The port's package boundary: no JAX at import, the weight bridge, the
anchors."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from maskrcnn_tpu.checkpoint.torch_convert import to_torch_state_dict
from maskrcnn_tpu.config import CocoInferenceConfig, TinyConfig
from maskrcnn_tpu.ops.anchors import config_anchors
from maskrcnn_tpu_torch.checkpoint.convert import from_jax_params
from maskrcnn_tpu_torch.models.mask_rcnn import MaskRCNN
from maskrcnn_tpu_torch.ops import anchors as port_anchors
from tests.torch_port import jax_params

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
    "maskrcnn_tpu_torch.ops.int8_conv", "maskrcnn_tpu_torch.quant")


def test_port_imports_no_jax():
    """Every slice module imports in a fresh interpreter without JAX
    (the card's machine has none)."""
    code = ("import importlib, sys\n"
            f"for m in {SLICE_MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(k for k in sys.modules if k == 'jax' "
            "or k.startswith('jax.') or k == 'flax')\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


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
    model = MaskRCNN(cfg)
    model.load_state_dict({k: torch.tensor(v) for k, v in got.items()},
                          strict=True)


@pytest.mark.parametrize("config", [TinyConfig(), CocoInferenceConfig()],
                         ids=["tiny", "coco_inference"])
def test_anchors_bit_equal(config):
    got = port_anchors.config_anchors(config)
    want = config_anchors(config)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
