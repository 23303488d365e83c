"""The port's int8 serving path (Config.QUANT_INT8) end to end against the
JAX package's, with the bars of test_torch_pipeline: share of valid
detections equal in (class, box) >= 0.9, |delta score| <= 1e-4, mask
bytes (pixels for the Detector) <= 1% apart. Also the options the port
refuses.

Both sides run one quantized tree. JAX runs op by op (`jax.disable_jit()`):
under jit, XLA's CPU backend contracts the int8 epilogue into a fused
multiply-add, which the port does not do, and the one-ulp differences
move activations across quantization boundaries (measured against jitted
JAX: 10 of 16 detections equal, |delta score| 3.2e-4). At this size the
JAX package pools float RoI tables (its int8 tables need the Pallas
route), so the port's side sets QUANT_INT8_ROI=False; the int8 tables
are held against the Pallas kernel in test_torch_roi_align_int8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maskrcnn_tpu import quant as jq
from maskrcnn_tpu.api import Detector as JaxDetector
from maskrcnn_tpu.detection import pipeline as jax_pipe
from maskrcnn_tpu.models.mask_rcnn import MaskRCNN as JaxMaskRCNN
from maskrcnn_tpu_torch import quant as pq
from maskrcnn_tpu_torch.api import Detector
from maskrcnn_tpu_torch.checkpoint.convert import from_jax_quant_params
from maskrcnn_tpu_torch.detection import pipeline as port_pipe
from maskrcnn_tpu_torch.ops import int8_conv as ic
from tests.test_torch_pipeline import CFG, _images, _match
from tests.torch_port import jax_params, port_config, torch_model

QCFG = CFG.replace(QUANT_INT8=True, QUANT_CALIB="amax")
PORT = QCFG.replace(QUANT_INT8_ROI=False)


@pytest.fixture(scope="module")
def setup():
    params = jax_params(QCFG)
    calib = pq.default_calib_canvases(QCFG.IMAGE_SHAPE, n=2)
    model = torch_model(PORT, params)
    return params, calib, pq.calibrate(model, model.float_state, calib)


@pytest.mark.parametrize("head", ["int8_head", "float_head"])
def test_quant_predict_step_matches_jax(setup, head):
    """float_head: stats without the mask head's activations (as a stats
    file from before head calibration), so both packages keep the mask
    head float. Measured: 16 of 16 equal, |delta score| 3.7e-8, no mask
    byte apart."""
    params, _, stats = setup
    if head == "float_head":
        stats = {k: v for k, v in stats.items()
                 if not k.startswith("mask_head/")}
    tree = jq.prepare_quant_params(JaxMaskRCNN(QCFG), params,
                                   act_stats=stats)
    assert ("mask_head/conv1" in tree["quant"]["convs"]) == \
        (head == "int8_head")
    model = torch_model(PORT, params)
    model.set_quant(from_jax_quant_params(tree))
    images, windows = _images(np.random.RandomState(7), 2)
    with jax.disable_jit():
        want = jax.device_get(jax_pipe.predict_step(
            JaxMaskRCNN(QCFG), tree, jnp.asarray(images),
            jnp.asarray(windows)))
    got = port_pipe.predict_step(model, torch.from_numpy(images),
                                 torch.from_numpy(windows))
    got = {k: v.numpy() for k, v in got.items()}
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype
    total, share, dscore, mism = _match(want, got)
    print(f"int8 predict_step parity ({head}): {total} valid, (class, box) "
          f"equal {share:.4f}, max |dscore| {dscore:.3g}, mask byte "
          f"mismatch {mism:.3g}")
    assert total > 0
    assert share >= 0.9
    assert dscore <= 1e-4
    assert mism <= 0.01


def test_quant_detector_reads_jax_stats(setup, tmp_path, monkeypatch):
    """The JAX Detector calibrates and writes its stats file; the port's
    Detector on the same weights reads it (no calibration runs), prepares
    the JAX Detector's tree exactly, and detects as it does."""
    params, calib, _ = setup
    path = str(tmp_path / "calib_stats.json")
    jdet = JaxDetector(QCFG, params=params, calib_images=calib,
                       calib_stats_path=path)
    want_tree = from_jax_quant_params(jdet.params)

    def no_calibration(*args, **kwargs):
        raise AssertionError("the stats file was not used")

    monkeypatch.setattr(pq, "calibrate", no_calibration)
    det = Detector(port_config(PORT), "cpu", calib_images=calib, calib_stats_path=path)
    det.load_jax_params(params)
    det.prepare()
    acts = {k: np.float32(s.value) for k, s in det.model.quant["acts"].items()}
    assert acts == want_tree["acts"]
    for path_, e in want_tree["convs"].items():
        np.testing.assert_array_equal(
            det.model.quant["convs"][path_]["kernel"].numpy(), e["kernel"])

    rng = np.random.RandomState(10)
    images = [rng.randint(0, 256, (128, 128, 3), np.uint8),
              rng.randint(0, 256, (96, 128, 3), np.uint8)]
    got = det.detect_batch(images)
    with jax.disable_jit():
        want = jdet.detect_batch(images)
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
    print(f"int8 Detector parity: {hits} of {total} detections equal, "
          f"{apart} of {pixels} mask pixels apart")
    assert total > 0 and hits >= 0.9 * total
    assert apart <= 0.01 * pixels


def test_int8_detector_runs_the_int8_path(monkeypatch):
    """Detector(QUANT_INT8) calibrates on the default canvases at its
    first request and runs the int8 convs, not the float model."""
    calls = []
    plain = ic.int8_conv_plain

    def counted(*args, **kwargs):
        calls.append(1)
        return plain(*args, **kwargs)

    monkeypatch.setattr(ic, "int8_conv_plain", counted)
    det = Detector(port_config(QCFG), "cpu")
    assert det.model.quant is None
    images = [np.random.RandomState(11).randint(0, 256, (128, 128, 3),
                                                np.uint8)]
    det.detect_batch(images)
    assert det.model.quant is not None
    # resnet50: 52 backbone convs, 8 FPN, the RPN's shared conv on 5
    # levels, 4 mask-head convs
    assert len(calls) == 52 + 8 + 5 + 4


SET = {"CASCADE_STAGES": (0.5, 0.6), "NUM_KEYPOINTS": 17, "TTA_HFLIP": True,
       "DETECTION_SOFT_NMS_SIGMA": 0.5, "IMAGE_CANVAS": (128, 192),
       "DEVICE_RESIZE": True, "NUM_DEVICES": 2, "SP_DEVICES": 2}


@pytest.mark.parametrize("field", list(SET))
def test_unported_option_raises(field):
    """Each option that changes the function computed builds its Detector
    and keeps the field, instead of running the default: every one is
    ported. SP_DEVICES counts within NUM_DEVICES, so its case sets both
    (tests/test_torch_spatial.py holds the spatial axis against the JAX
    package)."""
    overrides = {field: SET[field]}
    if field == "SP_DEVICES":
        overrides["NUM_DEVICES"] = SET["NUM_DEVICES"]
    cfg = port_config(CFG.replace(**overrides))
    assert getattr(Detector(cfg, "cpu").config, field) == SET[field]
