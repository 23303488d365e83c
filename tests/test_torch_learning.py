"""The port's learning-gate machinery (tools/learning_torch.py) against
the JAX package's gate helpers: the same configs, the same scenes and
training batches from the same seeds, the same held-out COCO directories
(annotation JSON equal, pixels equal once decoded, the port's PNGs read
by both the port and Pillow), a 2-step one-class gate through CocoDataset
and evaluate_coco and a 1-step overfit gate through Detector.detect on
the CPU, and the int8 calibration subsample at full width."""

import dataclasses
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from maskrcnn_tpu.config import CocoInferenceConfig as JaxCocoInference
from maskrcnn_tpu_torch import quant as pq
from maskrcnn_tpu_torch.data.image_io import read_image
from synthetic_scenes import make_multiclass_coco_dir, multiclass_train_batch
from tests import test_keypoints_learning as jax_kp
from tests import test_learning_ap as jax_ap
from tests import test_learning_ap_multiclass as jax_mc
from tests.torch_port import port_config
from tools import learning_torch as lt
from tools import overfit_smoke


@pytest.mark.parametrize("name,port,jax", [
    ("one-class", lt.gate_config, jax_ap._config),
    ("multiclass", lt.gate_config, jax_mc._config),
    ("cascade", lambda: lt.gate_config(CASCADE_STAGES=lt.CASCADE),
     lambda: jax_mc._config(CASCADE_STAGES=(0.5, 0.6, 0.7))),
    ("keypoints", lt.keypoint_config, jax_kp._config),
    ("full width", lt.full_config,
     lambda: JaxCocoInference(DETECTION_MIN_CONFIDENCE=0.0,
                              MAX_GT_INSTANCES=8))])
def test_gate_configs_equal_jax(name, port, jax):
    """Each gate's config is the JAX gate's, field by field (the full
    width one is tools/protocol_ap_ab.py's)."""
    got, want = port(), port_config(jax())
    assert type(got) is type(want)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def _equal_batches(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert a[k].dtype == b[k].dtype, k


BUILDERS = {
    "one-class": (lt.train_batch, jax_ap._train_batch, jax_ap._config),
    "keypoints": (lt.keypoint_train_batch, jax_kp._train_batch,
                  jax_kp._config),
    "overfit": (lt.overfit_batch, overfit_smoke.make_batch, jax_ap._config),
    "multiclass": (multiclass_train_batch, multiclass_train_batch,
                   jax_mc._config),
}


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_training_batches_equal_jax(name):
    """Three batches of four from numpy seed 3, the gates' training seed:
    equal to the JAX helpers' arrays (images, classes, boxes, masks,
    valid flags, keypoints)."""
    port, jax, config = BUILDERS[name]
    jcfg = config()
    pcfg = port_config(jcfg)
    rp, rj = np.random.RandomState(3), np.random.RandomState(3)
    for _ in range(3):
        _equal_batches(port(rp, pcfg, 4), jax(rj, jcfg, 4))


def test_one_class_scene_and_box_iou_equal_jax():
    cfg = jax_ap._config()
    for seed in range(5):
        img_p, boxes_p = lt.scene(np.random.RandomState(seed),
                                  port_config(cfg))
        img_j, boxes_j = jax_ap._scene(np.random.RandomState(seed), cfg)
        np.testing.assert_array_equal(img_p, img_j)
        assert boxes_p == boxes_j
    rng = np.random.RandomState(0)
    for _ in range(20):
        a, b = rng.rand(2, 4) * 32
        a[2:] += a[:2]
        b[2:] += b[:2]
        assert lt.box_iou(a, b) == overfit_smoke.box_iou(a, b)


def _jax_dir(name, root: Path):
    if name == "one-class":
        return jax_ap._make_coco_dir(root, jax_ap._config())
    if name == "keypoints":
        return jax_kp._make_coco_dir(root, jax_kp._config())
    return make_multiclass_coco_dir(root, jax_mc._config(), n_images=8)


def _port_dir(name, root: Path):
    if name == "one-class":
        return lt.make_coco_dir(root, lt.gate_config())
    if name == "keypoints":
        return lt.make_keypoint_coco_dir(root, lt.keypoint_config())
    return lt.make_multiclass_coco_dir(root, lt.gate_config(), n_images=8)


@pytest.mark.parametrize("name", ["one-class", "keypoints", "multiclass"])
def test_held_out_coco_dirs_equal_jax(name, tmp_path):
    """The held-out set: the same annotation JSON, and every PNG the port
    writes decodes (by the port and by Pillow) to the pixels of the JAX
    helper's Pillow-written PNG."""
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    jroot = Path(_jax_dir(name, tmp_path / "jax"))
    proot = Path(_port_dir(name, tmp_path / "port"))
    ann = "annotations/instances_minival2014.json"
    want = json.loads((jroot / ann).read_text())
    assert json.loads((proot / ann).read_text()) == want
    assert len(want["images"]) == 8
    for info in want["images"]:
        jfile = jroot / "val2014" / info["file_name"]
        pfile = proot / "val2014" / info["file_name"]
        pixels = np.asarray(Image.open(jfile).convert("RGB"))
        np.testing.assert_array_equal(read_image(pfile), pixels)
        np.testing.assert_array_equal(
            np.asarray(Image.open(pfile).convert("RGB")), pixels)


def test_state_file_round_trip(tmp_path):
    rng = np.random.RandomState(0)
    state = {"a.weight": rng.rand(3, 4).astype(np.float32),
             "b.bias": rng.rand(5).astype(np.float32)}
    lt.save_state(tmp_path / "w" / "s.pth", state)
    back = lt.load_state_file(tmp_path / "w" / "s.pth")
    assert sorted(back) == sorted(state)
    for k in state:
        np.testing.assert_array_equal(back[k], state[k])


@pytest.fixture
def one_thread():
    """One torch thread: the suite runs six workers on the CPU, and the
    gates' convolutions oversubscribe it with the default thread count."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_two_step_one_class_gate_through_evaluate_coco(tmp_path, one_thread):
    """The one-class gate's machinery at 2 steps on the CPU: training from
    scratch, the held-out PNG set through CocoDataset and evaluate_coco
    (float bbox and segm, int8 bbox with and without int8 RoI tables)
    and overfit_smoke's recall; every AP a finite value of COCOeval's
    range. No floor: 2 steps learn nothing."""
    rec, failures = lt.one_class_gate("cpu", tmp_path, steps=2)
    assert rec["train"]["steps"] == 2
    assert np.isfinite(rec["train"]["losses"]["total"])
    for arm, kinds in (("float", ("bbox", "segm")), ("int8", ("bbox",)),
                       ("int8_bf16_roi", ("bbox",))):
        assert tuple(rec[arm]) == kinds
        for kind in kinds:
            for v in rec[arm][kind].values():
                assert np.isfinite(v) and -1.0 <= v <= 1.0
    assert isinstance(failures, list)
    assert (tmp_path / "one_class" / "coco" / "val2014").is_dir()


def test_one_step_overfit_gate(one_thread):
    """tools/overfit_smoke.py's recipe at 1 step on the CPU: the 128 px
    TinyConfig, then Detector.detect on 4 more scenes and the judge."""
    rec, failures = lt.overfit_gate("cpu", steps=1)
    assert rec["train"]["steps"] == 1 and rec["total"] >= 4
    assert 0 <= rec["found"] <= rec["total"]
    assert len(rec["mask_iou"]) == rec["found"]
    assert isinstance(failures, list)


# NHWC shapes of the calibration batch (4 canvases): the 1024² canvas's
# stages (stem to C5, FPN) and the 128 px TinyConfig's
FULL = [(4, 256, 256, 64), (4, 256, 256, 256), (4, 128, 128, 128),
        (4, 128, 128, 512), (4, 64, 64, 256), (4, 64, 64, 1024),
        (4, 32, 32, 512), (4, 32, 32, 2048), (4, 16, 16, 256)]
TINY = [(2, 32, 32, 64), (2, 32, 32, 256), (2, 16, 16, 512),
        (2, 8, 8, 1024), (2, 4, 4, 2048), (128, 14, 14, 256)]


@pytest.mark.parametrize("shape", FULL + TINY, ids=str)
def test_calibration_subsample_channels(shape):
    """The |x| subsample of calibration (QUANT_CALIB mse or percentile)
    never reads one channel alone: where the JAX package's stride,
    numel // 16384, is a multiple of C (every 1024² tensor through C4)
    it reads channel 0 only, and the port's stride is one more, which
    visits every channel; elsewhere the two strides are equal (the 128 px
    configs of the parity tests)."""
    numel, c = int(np.prod(shape)), shape[-1]
    jax_stride = max(1, numel // 16384)
    stride = pq.sample_stride(numel, c, 16384)
    # k * s mod C over the 16384-odd samples visits C / gcd(s, C) channels
    if jax_stride % c == 0:
        assert stride == jax_stride + 1
        assert math.gcd(stride, c) == 1 and numel // stride >= c
    else:
        assert stride == jax_stride


def test_calib_mode_takes_that_subsample():
    """The port's calib traversal records exactly flat[::sample_stride]
    of the NHWC tensor, beside its max |x|."""
    shape = (2, 32, 32, 64)
    numel = int(np.prod(shape))
    x = -torch.arange(numel, dtype=torch.float32).reshape(shape)
    ctx = pq._Ctx(mode="calib", dtype=torch.float32, calib_sample=1024)
    assert ctx.qt("t", x) is x
    stride = pq.sample_stride(numel, 64, 1024)
    assert stride == 129
    np.testing.assert_array_equal(ctx.stats["t"]["sample"].numpy(),
                                  np.arange(numel, dtype=np.float32)[::stride])
    assert float(ctx.stats["t"]["amax"]) == numel - 1
