"""The port's inference protocols end to end against the JAX package at
TinyConfig, float32 on the CPU, on one seeded JAX tree that holds every
optional head (three cascade box heads, a 4-keypoint head of two 32-wide
convs): predict_step under flip TTA with soft-NMS and with hard NMS,
cascade with soft-NMS, keypoints and a 128x192 canvas. The Detector
cases (test_torch_protocols_detector.py, _canvas.py) and the weights
(_weights.py) use this module's tree, helpers and bars.

The bar is test_torch_pipeline's (PR 1's): the share of valid detections
equal in (class, box) >= 0.9 with the rest counted, |delta score| stated
and <= 1e-5, mask bytes equal but for ulp ties at 127.5 (<= 1e-3).
Measured here: every detection equal in every case, |delta score| at
most 1.2e-7, no mask byte apart; keypoint coordinates within 1 float32
ulp of the box edge (7.6e-6 px), since the decode's cell centre divides
by the heatmap size (XLA multiplies by its reciprocal under jit).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maskrcnn_tpu.api import Detector as JaxDetector
from maskrcnn_tpu.detection import pipeline as jax_pipe
from maskrcnn_tpu.models.mask_rcnn import MaskRCNN as JaxMaskRCNN
from maskrcnn_tpu_torch.api import Detector
from maskrcnn_tpu_torch.detection import pipeline as port_pipe
from tests.test_torch_pipeline import CFG, _match
from tests.torch_port import jax_params, port_config

KP = dict(NUM_KEYPOINTS=4, KEYPOINT_HEAD_CONVS=2, KEYPOINT_HEAD_DIM=32)
CASCADE = (0.5, 0.6, 0.7)
FULL = CFG.replace(CASCADE_STAGES=CASCADE, **KP)
KP_ULP = float(np.spacing(np.float32(128)))

CASES = {
    "tta-soft": dict(TTA_HFLIP=True, DETECTION_SOFT_NMS_SIGMA=0.5),
    "tta-hard": dict(TTA_HFLIP=True),
    "cascade-soft": dict(CASCADE_STAGES=CASCADE,
                         DETECTION_SOFT_NMS_SIGMA=0.5),
    "keypoints": KP,
    "rect": dict(IMAGE_CANVAS=(128, 192)),
}


@pytest.fixture(scope="module")
def params():
    """Seeded JAX weights with every optional head and jittered BN."""
    return jax_params(FULL)


def _tree(params, cfg):
    """The tree with only the heads `cfg` has (the JAX model ignores the
    others; the port's strict load does not)."""
    stages = max(1, len(cfg.CASCADE_STAGES))
    return {k: v for k, v in params.items()
            if not (k.startswith("box_head") and k != "box_head"
                    and int(k[len("box_head"):]) > stages)
            and (k != "kp_head" or cfg.NUM_KEYPOINTS > 0)}


def _port_detector(cfg, params, **kw):
    det = Detector(port_config(cfg), "cpu", **kw)
    det.load_jax_params(_tree(params, cfg))
    return det


def _canvases(cfg, rng, b=2):
    """uint8 canvases with a zero border outside each window."""
    h, w = cfg.IMAGE_SHAPE[:2]
    images = np.zeros((b, h, w, 3), np.uint8)
    windows = np.array([[0, 0, h, w], [16, 0, h - 16, w]][:b], np.float32)
    for i, (y1, x1, y2, x2) in enumerate(windows.astype(int)):
        images[i, y1:y2, x1:x2] = rng.randint(0, 256, (y2 - y1, x2 - x1, 3))
    return images, windows


@pytest.mark.parametrize("case", list(CASES))
def test_protocol_predict_step_matches_jax(params, case):
    cfg = CFG.replace(**CASES[case])
    images, windows = _canvases(cfg, np.random.RandomState(7))
    want = jax.device_get(jax_pipe.predict_step(
        JaxMaskRCNN(cfg), params, jnp.asarray(images), jnp.asarray(windows)))
    model = _port_detector(cfg, params).model
    got = port_pipe.predict_step(model, torch.from_numpy(images),
                                 torch.from_numpy(windows))
    got = {k: v.numpy() for k, v in got.items()}
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert got[k].dtype == want[k].dtype, k
    total, share, dscore, mism = _match(want, got)
    print(f"{case} predict_step parity: {total} valid, (class, box) equal "
          f"{share:.4f}, max |dscore| {dscore:.3g}, mask byte mismatch "
          f"{mism:.3g}")
    assert total > 0
    assert share >= 0.9
    assert dscore <= 1e-5
    assert mism <= 1e-3
    if "keypoints" in want:
        n = want["keypoints"].shape[1]
        assert n == min(cfg.KEYPOINT_MAX_INSTANCES,
                        cfg.DETECTION_MAX_INSTANCES)
        both = want["valid"][:, :n] & got["valid"][:, :n]
        w, g = want["keypoints"][both], got["keypoints"][both]
        np.testing.assert_allclose(g[..., :2], w[..., :2], rtol=0,
                                   atol=KP_ULP)
        np.testing.assert_allclose(g[..., 2], w[..., 2], rtol=1e-5, atol=0)
        np.testing.assert_array_equal(
            got["keypoints"][~got["valid"][:, :n]], 0.0)


def _detector_parity(got, want, images, keypoints=False):
    hits = total = apart = pixels = 0
    for img, g, w in zip(images, got, want):
        assert (g is None) == (w is None)
        if g is None:
            continue
        assert len(g) == len(w) == (5 if keypoints else 4)
        cls, scores, boxes, masks = g[:4]
        assert masks.shape == (len(cls),) + img.shape[:2]
        slot = {(c, tuple(np.round(b, 3))): i
                for i, (c, b) in enumerate(zip(w[0], w[2]))}
        for j, (c, s, b, m) in enumerate(zip(cls, scores, boxes, masks)):
            i = slot.get((c, tuple(np.round(b, 3))))
            if i is None:
                continue
            hits += 1
            assert abs(s - w[1][i]) <= 1e-5
            apart += int((m != w[3][i]).sum())
            pixels += m.size
            if keypoints:
                assert g[4].dtype == np.float64
                np.testing.assert_allclose(g[4][j], w[4][i], rtol=1e-5,
                                           atol=1e-4)
        total += len(w[0])
    assert total > 0 and hits >= 0.9 * total
    assert apart <= 1e-3 * pixels
    return hits, total


def detector_case(params, overrides):
    """detect_batch through both Detectors on the same tree: a scale-1,
    an upscaled and a wide image (canvas placement, device or host
    resample, predict_step, mask decode, box and keypoint decode). Under
    keypoints each result has a fifth element, float64 keypoints in
    original coordinates, held within 1e-4 px. Returns the port's
    Detector."""
    cfg = CFG.replace(**overrides)
    rng = np.random.RandomState(8)
    images = [rng.randint(0, 256, (128, 128, 3), np.uint8),
              rng.randint(0, 256, (64, 48, 3), np.uint8),
              rng.randint(0, 256, (96, 128, 3), np.uint8)]
    det = _port_detector(cfg, params)
    got = det.detect_batch(images)
    want = JaxDetector(cfg, params=params).detect_batch(images)
    hits, total = _detector_parity(got, want, images,
                                   keypoints=cfg.NUM_KEYPOINTS > 0)
    print(f"{overrides} Detector parity: {hits} of {total} detections "
          "equal")
    return det, images
