"""The port's FOLD_BN serving path end to end against the JAX package's:
predict_step on folded weights, and the Detector, which folds the
ordinary JAX tree itself. Metrics and bars of test_torch_pipeline."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maskrcnn_tpu.api import Detector as JaxDetector
from maskrcnn_tpu.checkpoint.fold import fold_bn_params
from maskrcnn_tpu.detection import pipeline as jax_pipe
from maskrcnn_tpu.models.mask_rcnn import MaskRCNN as JaxMaskRCNN
from maskrcnn_tpu_torch.api import Detector
from maskrcnn_tpu_torch.detection import pipeline as port_pipe
from tests.test_torch_pipeline import CFG, _images, _match
from tests.torch_port import jax_params, torch_model

FOLD = CFG.replace(FOLD_BN=True)


@pytest.fixture(scope="module")
def params():
    return jax_params(CFG)


def test_folded_predict_step_matches_jax(params):
    """The port's folded model (identity blocks through the fused op)
    against JAX predict_step(MaskRCNN(FOLD_BN), fold_bn_params(params)),
    float32 on the CPU."""
    folded = fold_bn_params(params)
    model = torch_model(FOLD, folded)
    assert model.fpn.C2[1].fused
    images, windows = _images(np.random.RandomState(9), 2)
    want = jax.device_get(jax_pipe.predict_step(
        JaxMaskRCNN(FOLD), folded, jnp.asarray(images),
        jnp.asarray(windows)))
    got = port_pipe.predict_step(model, torch.from_numpy(images),
                                 torch.from_numpy(windows))
    got = {k: v.numpy() for k, v in got.items()}
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype
    total, share, dscore, mism = _match(want, got)
    print(f"folded predict_step parity: {total} valid, (class, box) equal "
          f"{share:.4f}, max |dscore| {dscore:.3g}, mask byte mismatch "
          f"{mism:.3g}")
    assert total > 0
    assert share >= 0.9
    assert dscore <= 1e-4
    assert mism <= 1e-3


def test_folded_detector_matches_jax(params):
    """Both Detectors with FOLD_BN take the same unfolded tree and fold it
    on load; same detections and masks in original coordinates."""
    rng = np.random.RandomState(10)
    images = [rng.randint(0, 256, (128, 128, 3), np.uint8),
              rng.randint(0, 256, (96, 128, 3), np.uint8),
              rng.randint(0, 256, (64, 48, 3), np.uint8)]
    det = Detector(FOLD, "cpu")
    det.load_jax_params(params)
    got = det.detect_batch(images)
    want = JaxDetector(FOLD, params=params).detect_batch(images)
    hits = total = apart = pixels = 0
    for img, g, w in zip(images, got, want):
        assert g is not None and w is not None
        cls, scores, boxes, masks = g
        assert masks.shape == (len(cls),) + img.shape[:2]
        slot = {(c, tuple(np.round(b, 3))): i
                for i, (c, b) in enumerate(zip(w[0], w[2]))}
        for c, s, b, m in zip(cls, scores, boxes, masks):
            i = slot.get((c, tuple(np.round(b, 3))))
            if i is not None:
                hits += 1
                assert abs(s - w[1][i]) <= 1e-4
                apart += int((m != w[3][i]).sum())
                pixels += m.size
        total += len(w[0])
    print(f"folded Detector parity: {hits} of {total} detections equal, "
          f"{apart} of {pixels} mask pixels apart")
    assert total > 0 and hits >= 0.9 * total
    assert apart <= 1e-3 * pixels
