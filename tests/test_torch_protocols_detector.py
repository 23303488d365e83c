"""The port's Detector under keypoints and under cascade + flip TTA +
soft-NMS stacked, against the JAX Detector at TinyConfig, float32 on the
CPU, on test_torch_protocols_pipeline's seeded tree with every optional
head. The bars are test_torch_protocols_pipeline's."""

import numpy as np
import pytest
import torch

from maskrcnn_tpu.api import Detector as JaxDetector
from maskrcnn_tpu_torch.detection import pipeline as port_pipe
from tests.test_torch_pipeline import CFG
from tests.test_torch_protocols_pipeline import (CASCADE, FULL, KP,
                                                 _canvases, _port_detector,
                                                 detector_case)
from tests.torch_port import jax_params


@pytest.fixture(scope="module")
def params():
    """Seeded JAX weights with every optional head and jittered BN."""
    return jax_params(FULL)


@pytest.mark.parametrize("case", ["keypoints", "cascade-tta-soft"])
def test_protocol_detector_matches_jax(params, case):
    overrides = KP if case == "keypoints" else dict(
        CASCADE_STAGES=CASCADE, TTA_HFLIP=True, DETECTION_SOFT_NMS_SIGMA=0.5)
    det, images = detector_case(params, overrides)
    if case == "keypoints":
        assert len(det.detect(images[0])) == 5


def test_keypoint_max_instances_truncates_like_jax(params):
    """KEYPOINT_MAX_INSTANCES below D: the head runs on the first slots
    only ([B, 2, K, 3] from predict_step, as the JAX package's), and the
    Detector gives the later detections zero keypoint rows."""
    cfg = CFG.replace(KEYPOINT_MAX_INSTANCES=2, **KP)
    det = _port_detector(cfg, params)
    images, windows = _canvases(cfg, np.random.RandomState(3), b=1)
    out = port_pipe.predict_step(det.model, torch.from_numpy(images),
                                 torch.from_numpy(windows))
    assert tuple(out["keypoints"].shape) == (1, 2, 4, 3)
    got = det.detect_batch([images[0]])[0]
    want = JaxDetector(cfg, params=params).detect_batch([images[0]])[0]
    assert got is not None and len(got[0]) > 2
    assert got[4].shape == (len(got[0]), 4, 3)
    np.testing.assert_array_equal(got[4][2:], 0.0)
    np.testing.assert_allclose(got[4], want[4], rtol=1e-5, atol=1e-4)
