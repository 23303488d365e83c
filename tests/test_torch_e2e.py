"""The port's product surface end to end on a synthetic COCO directory
(the one of tests/test_e2e.py), with the same seeded JAX weights in both
packages: the COCO reader, the host mask decode against the JAX
Detector, the port's device and host decodes against each other,
`detect()`'s empty result, and `evaluate_coco` for bbox and segm."""

import numpy as np
import pytest

from maskrcnn_tpu.api import Detector as JaxDetector
from maskrcnn_tpu.config import TinyConfig
from maskrcnn_tpu.data import coco as jax_coco
from maskrcnn_tpu.eval.evaluate import evaluate_coco as jax_evaluate_coco
from maskrcnn_tpu_torch.api import Detector
from maskrcnn_tpu_torch.data import coco as port_coco
from maskrcnn_tpu_torch.eval.evaluate import evaluate_coco
from tests.torch_port import jax_params, port_config, synthetic_coco_dir

# host decode on the JAX side, as coco.py evaluates
CFG = TinyConfig().replace(DETECTION_MIN_CONFIDENCE=0.0,
                           DEVICE_MASK_DECODE=False)


@pytest.fixture(scope="module")
def coco_dir(tmp_path_factory):
    return synthetic_coco_dir(tmp_path_factory.mktemp("coco"))


@pytest.fixture(scope="module")
def params():
    return jax_params(CFG)


@pytest.fixture(scope="module")
def jax_run(coco_dir, params):
    """The JAX Detector's results on the three images (one batch) and its
    bbox and segm stats over them."""
    ds = jax_coco.CocoDataset(coco_dir, "minival", 2014, CFG)
    det = JaxDetector(CFG, params=params)
    images = [ds.load_image(i) for i in ds.ids]
    results = det.detect_batch(images)
    stats = {t: jax_evaluate_coco(det, ds, ds.coco, t, limit=3,
                                  batch_size=3)
             for t in ("bbox", "segm")}
    return images, results, stats


def _port(cfg, params):
    det = Detector(port_config(cfg), "cpu")
    det.load_jax_params(params)
    return det


def test_coco_dataset_reads_like_jax(coco_dir):
    """ids, paths, images, class ids and the label tables as the JAX
    reader has them."""
    port = port_coco.CocoDataset(coco_dir, "minival", 2014, None)
    ref = jax_coco.CocoDataset(coco_dir, "minival", 2014, CFG)
    assert port.ids == ref.ids and len(port) == len(ref) == 3
    assert port.coco.dataset == ref.coco.dataset
    for i, image_id in enumerate(port.ids):
        assert port.image_path(i) == ref.image_path(i)
        np.testing.assert_array_equal(port.load_image(image_id),
                                      ref.load_image(image_id))
    port.set_filter([3, 1])
    assert port.ids == [3, 1] and port.image_index(1) == 1
    for label in (0, 1, 12, 80, 81):
        assert port.class_id(label) == ref.class_id(label)
        assert port_coco.CocoLabel.name(label) == jax_coco.CocoLabel.name(
            label)
        assert (port_coco.CocoLabel.zh_name(label)
                == jax_coco.CocoLabel.zh_name(label))
    assert port_coco.COCO_CLASS_IDS == jax_coco.COCO_CLASS_IDS
    assert port_coco.COCO_CLASS_NAMES == jax_coco.COCO_CLASS_NAMES
    assert port_coco.CocoLabel.from_class(90) == 80
    assert (port_coco.coco_image_dir("/c", "minival")
            == jax_coco.coco_image_dir("/c", "minival"))
    assert (port_coco.coco_annfile("/c", "minival")
            == jax_coco.coco_annfile("/c", "minival"))


def _hits(got, want):
    """(class, box) hits, JAX detections, mask pixels apart and compared."""
    hits = total = apart = pixels = 0
    for g, w in zip(got, want):
        assert g is not None and w is not None
        jax_slot = {(c, tuple(np.round(b, 3))): i
                    for i, (c, b) in enumerate(zip(w[0], w[2]))}
        for c, b, m in zip(g[0], g[2], g[3]):
            i = jax_slot.get((c, tuple(np.round(b, 3))))
            if i is not None:
                hits += 1
                apart += int((m != w[3][i]).sum())
                pixels += m.size
        total += len(w[0])
    return hits, total, apart, pixels


@pytest.mark.parametrize("route", ["canvas_96", "decode_off"])
def test_host_decode_matches_jax(route, params, jax_run):
    """The port's host decode, taken for images above ORIG_MASK_CANVAS (96
    against 104-120 px) or under DEVICE_MASK_DECODE=False, against the
    JAX Detector's host decode: (class, box) hits >= 0.9 and mask pixels
    apart <= 1e-3, the bars of test_torch_pipeline."""
    images, want, _ = jax_run
    cfg = (CFG.replace(DEVICE_MASK_DECODE=True, ORIG_MASK_CANVAS=96)
           if route == "canvas_96" else CFG)
    det = _port(cfg, params)
    handle = det.dispatch_batch(images)
    assert handle[-1] is False  # the host route
    got = det.fetch(handle)
    for img, g in zip(images, got):
        assert g[3].shape == (len(g[0]),) + img.shape[:2]
        assert g[3].dtype == np.uint8
    hits, total, apart, pixels = _hits(got, want)
    assert total > 0
    assert hits >= 0.9 * total
    assert apart <= 1e-3 * pixels


def test_device_and_host_decode_agree(params, jax_run):
    """The port's device decode against its host decode on the same
    detections: equal classes, scores and boxes, masks apart on < 0.02 of
    pixels (the 0.5 iso-contour; tests/test_e2e.py's bar)."""
    images = jax_run[0]
    dev = _port(CFG.replace(DEVICE_MASK_DECODE=True), params)
    host = _port(CFG, params)
    a = dev.detect_batch(images)
    b = host.detect_batch(images)
    for ra, rb in zip(a, b):
        assert ra[0] == rb[0]
        np.testing.assert_array_equal(ra[1], rb[1])
        np.testing.assert_array_equal(ra[2], rb[2])
        assert ra[3].shape == rb[3].shape
        assert (ra[3] != rb[3]).mean() < 0.02


def test_detect_returns_none_when_nothing_found(params, jax_run):
    """With a confidence floor no score reaches, detect() returns
    (None,) * 4 in both packages; with none it returns the first image's
    detections of detect_batch."""
    image = jax_run[0][0]
    cfg = CFG.replace(DETECTION_MIN_CONFIDENCE=1.0)
    assert _port(cfg, params).detect(image) == (None,) * 4
    assert JaxDetector(cfg, params=params).detect(image) == (None,) * 4
    port = _port(CFG, params)
    one = port.detect(image)
    want = port.detect_batch([image])[0]
    assert one[0] == want[0] and one[2] == want[2]


def test_evaluate_coco_matches_jax(coco_dir, params, jax_run):
    """evaluate_coco through the port (dispatch_batch/fetch, host decode,
    the port's RLE and COCOeval) for bbox and segm: its 12 stats within
    0.01 of the JAX run's. Measured on the CPU: the stats are equal (gap
    0.0)."""
    ds = port_coco.CocoDataset(coco_dir, "minival", 2014, None)
    det = _port(CFG, params)
    for eval_type, want in jax_run[2].items():
        got = evaluate_coco(det, ds, ds.coco, eval_type, limit=3,
                            batch_size=2)
        assert got.shape == (12,)
        gap = float(np.abs(got - want).max())
        print(f"{eval_type} stats gap to JAX: {gap}")
        assert gap <= 0.01, (eval_type, got, want)
