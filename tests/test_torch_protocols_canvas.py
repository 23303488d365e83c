"""The port's Detector under DEVICE_RESIZE and on a 128x192 canvas,
against the JAX Detector at TinyConfig, float32 on the CPU, on
test_torch_protocols_pipeline's seeded tree; and DEVICE_RESIZE against
the port's host route at scale 1. The bars are
test_torch_protocols_pipeline's."""

import numpy as np
import pytest

from tests.test_torch_pipeline import CFG
from tests.test_torch_protocols_pipeline import (FULL, _port_detector,
                                                 detector_case)
from tests.torch_port import jax_params


@pytest.fixture(scope="module")
def params():
    """Seeded JAX weights with every optional head and jittered BN."""
    return jax_params(FULL)


@pytest.mark.parametrize("case", ["device-resize", "rect"])
def test_protocol_detector_matches_jax(params, case):
    detector_case(params, dict(DEVICE_RESIZE=True) if case == "device-resize"
                  else dict(IMAGE_CANVAS=(128, 192), ORIG_MASK_CANVAS=192))


def test_device_resize_scale1_detections_equal_host(params):
    """DEVICE_RESIZE on scale-1 images places the same canvases as the
    host, so the detections are identical to the host route's."""
    rng = np.random.RandomState(20)
    images = [rng.randint(0, 256, (128, 128, 3), np.uint8),
              rng.randint(0, 256, (128, 96, 3), np.uint8)]
    host = _port_detector(CFG, params).detect_batch(images)
    dev = _port_detector(CFG.replace(DEVICE_RESIZE=True),
                         params).detect_batch(images)
    for h, d in zip(host, dev):
        assert (h is None) == (d is None)
        if h is not None:
            assert h[0] == d[0] and h[1] == d[1] and h[2] == d[2]
            np.testing.assert_array_equal(h[3], d[3])
