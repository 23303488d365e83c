"""The port's inference pipeline against the JAX package.

Stages get identical inputs and must give identical discrete outputs
(proposal validity, class ids, boxes, packed mask bytes). The whole
predict_step runs both packages on the same weights and canvases and is
held to three metrics: the share of valid detections equal in (class,
box), |delta score| and the share of mismatched mask bytes on those.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maskrcnn_tpu.config import TinyConfig
from maskrcnn_tpu.detection import pipeline as jax_pipe
from maskrcnn_tpu.models.mask_rcnn import MaskRCNN as JaxMaskRCNN
from maskrcnn_tpu.ops import mask_paste as jax_paste
from maskrcnn_tpu.ops.anchors import config_anchors
from maskrcnn_tpu_torch.api import Detector
from maskrcnn_tpu_torch.checkpoint.convert import load_jax_params
from maskrcnn_tpu_torch.detection import pipeline as port_pipe
from maskrcnn_tpu_torch.ops import mask_paste as port_paste
from tests.torch_port import jax_params, port_config, torch_model

CFG = TinyConfig().replace(DETECTION_MIN_CONFIDENCE=0.0)
PCFG = port_config(CFG)


def _t(x):
    return torch.tensor(np.asarray(x))


def _jax_rpn(cfg, anchors, scores, deltas):
    return jax.vmap(lambda s, d: jax_pipe.rpn_refine_scores(
        cfg, jnp.asarray(anchors), s, d))(jnp.asarray(scores),
                                          jnp.asarray(deltas))


@pytest.mark.parametrize("tied", [False, True], ids=["distinct", "tied"])
def test_rpn_refine_scores_matches_jax(tied):
    """tied: scores quantised to 3 levels, as saturated sigmoids are under
    random weights; top-k must then take equal scores in index order."""
    rng = np.random.RandomState(int(tied))
    anchors = config_anchors(CFG)
    a = anchors.shape[0]
    scores = rng.rand(2, a).astype(np.float32)
    if tied:
        scores = np.round(scores * 2) / 2
    deltas = (rng.randn(2, a, 4) * 0.3).astype(np.float32)
    want_p, want_v = _jax_rpn(CFG, anchors, scores, deltas)
    got_p, got_v = port_pipe.rpn_refine_scores(PCFG, _t(anchors), _t(scores),
                                               _t(deltas))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), rtol=1e-6,
                               atol=1e-6)


def test_rpn_candidates_tie_order():
    """All-equal scores: the k candidates are anchors 0..k-1 in order."""
    from maskrcnn_tpu_torch.ops import boxes as box_ops
    anchors = _t(config_anchors(CFG))
    a = anchors.shape[0]
    k = CFG.PRE_NMS_LIMIT
    h, w = CFG.IMAGE_SHAPE[:2]
    got = port_pipe.rpn_candidates(PCFG, anchors, torch.ones(1, a),
                                   torch.zeros(1, a, 4))[0]
    want = box_ops.clip_boxes(box_ops.refine_boxes(anchors[:k],
                                                   torch.zeros(k, 4)),
                              (0.0, 0.0, float(h), float(w)))
    assert torch.equal(got, want)


def test_mrn_refine_matches_jax():
    rng = np.random.RandomState(4)
    b, r, k = 2, CFG.RPN_NMS_MAX_ROIS_NUM, CFG.NUM_CLASSES
    proposals = np.zeros((b, r, 4), np.float32)
    proposals[..., :2] = rng.uniform(0, 0.6, (b, r, 2))
    proposals[..., 2:] = proposals[..., :2] + rng.uniform(0.05, 0.4,
                                                          (b, r, 2))
    valid = rng.rand(b, r) > 0.2
    logits = rng.randn(b, r, k).astype(np.float32) * 3
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    probs = probs.astype(np.float32)
    deltas = (rng.randn(b, r, k, 4) * 0.1).astype(np.float32)
    windows = np.array([[0, 0, 128, 128], [16, 0, 112, 128]], np.float32)
    want = jax.vmap(lambda p, v, pr, d, wi: jax_pipe.mrn_refine(
        CFG, p, v, pr, d, wi))(*map(jnp.asarray, (proposals, valid, probs,
                                                  deltas, windows)))
    got = port_pipe.mrn_refine(PCFG, _t(proposals), _t(valid), _t(probs),
                               _t(deltas), _t(windows))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.class_ids.numpy(),
                                  np.asarray(want.class_ids))
    np.testing.assert_array_equal(got.boxes.numpy(), np.asarray(want.boxes))
    np.testing.assert_array_equal(got.scores.numpy(),
                                  np.asarray(want.scores))


def _paste_case(rng, n, h, w):
    masks = rng.rand(n, 28, 28).astype(np.float32)
    boxes = []
    for _ in range(n):
        y1, x1 = rng.randint(0, min(h, w) // 2, 2)
        boxes.append([y1, x1, min(h, y1 + rng.randint(4, h // 2)),
                      min(w, x1 + rng.randint(4, w // 2))])
    return masks, np.asarray(boxes, np.float32), rng.rand(n) > 0.3


# A pasted pixel is the sum of two or more float32 products compared with
# 127.5. XLA's and PyTorch's CPU matmuls round that sum differently, so a
# pixel whose exact value lies within an ulp of the threshold may land on
# either side. The interpolation operators are bit-equal (asserted), so
# masks must agree everywhere else.
TIE = 2 * float(np.spacing(np.float32(127.5)))


def _assert_equal_but_ties(got, want, exact):
    diff = got != want
    assert diff.mean() <= 1e-4, diff.mean()
    np.testing.assert_array_less(np.abs(exact[diff] - 127.5), TIE)


def test_paste_masks_packed_matches_jax():
    rng = np.random.RandomState(5)
    h, w = 96, 104
    masks, boxes, valid = _paste_case(rng, 19, h, w)
    want = np.asarray(jax_paste.paste_masks_packed(
        jnp.asarray(masks), jnp.asarray(boxes), jnp.asarray(valid), h, w))
    got = port_paste.paste_masks_packed(_t(masks), _t(boxes), _t(valid), h, w)
    assert got.dtype == torch.uint8 and got.shape == want.shape

    ops = []
    for a, b in ((0, 2), (1, 3)):
        start, size = boxes[:, a], boxes[:, b] - boxes[:, a]
        op = port_paste._interp_operator(_t(start), _t(size),
                                         (h, w)[a], 28).numpy()
        np.testing.assert_array_equal(op, np.asarray(
            jax_paste._interp_operator(jnp.asarray(start), jnp.asarray(size),
                                       (h, w)[a], 28)))
        ops.append(op.astype(np.float64))
    q = np.floor(np.clip(masks * np.float32(255.0), 0, 255)).astype(np.float64)
    exact = np.einsum("nym,nmj,nxj->nyx", ops[0], q, ops[1])
    _assert_equal_but_ties(np.unpackbits(got.numpy(), axis=-1)[..., :w],
                           np.unpackbits(want, axis=-1)[..., :w], exact)


@pytest.mark.parametrize("orig", [(96, 104), (60, 52), (150, 170)],
                         ids=["same", "down", "up"])
def test_masks_to_original_matches_jax(orig):
    rng = np.random.RandomState(6)
    ch = cw = 128
    masks, boxes, _ = _paste_case(rng, 11, ch, cw)
    canvas = np.asarray(jax_paste.paste_masks(jnp.asarray(masks),
                                              jnp.asarray(boxes), ch, cw))
    window = np.array([16, 12, 112, 116], np.float32)
    out_dim = 176
    want = np.asarray(jax_paste.masks_to_original(
        jnp.asarray(canvas), jnp.asarray(window), jnp.int32(orig[0]),
        jnp.int32(orig[1]), out_dim))
    got = port_paste.masks_to_original(
        _t(canvas), _t(window), torch.tensor(orig[0]), torch.tensor(orig[1]),
        out_dim).numpy()
    assert got.shape == want.shape == (11, out_dim, out_dim)

    ops = []
    for a, b, size in ((0, 2, orig[0]), (1, 3, orig[1])):
        op = port_paste._pil_resize_operator(
            torch.tensor(window[a]), torch.tensor(window[b] - window[a]),
            torch.tensor(size), ch, out_dim).numpy()
        np.testing.assert_array_equal(op, np.asarray(
            jax_paste._pil_resize_operator(
                jnp.float32(window[a]), jnp.float32(window[b] - window[a]),
                jnp.int32(size), ch, out_dim)))
        ops.append(op.astype(np.float64))
    exact = np.einsum("yd,ndx,wx->nyw", ops[0], canvas * 255.0, ops[1])
    _assert_equal_but_ties(got, want, exact)


def _images(rng, b):
    """uint8 canvases with a zero border outside each window."""
    h, w = CFG.IMAGE_SHAPE[:2]
    images = np.zeros((b, h, w, 3), np.uint8)
    windows = np.array([[0, 0, h, w], [16, 0, h - 16, w]][:b], np.float32)
    for i, (y1, x1, y2, x2) in enumerate(windows.astype(int)):
        images[i, y1:y2, x1:x2] = rng.randint(0, 256, (y2 - y1, x2 - x1, 3))
    return images, windows


def _match(jax_out, port_out):
    """Per image: the JAX valid detections whose (class, box) the port
    also found; |delta score| and mask-byte mismatches on those."""
    total = equal = 0
    dscore, mism, nbytes = 0.0, 0, 0
    for i in range(jax_out["valid"].shape[0]):
        port = {}
        for s in np.flatnonzero(port_out["valid"][i]):
            key = (int(port_out["class_ids"][i, s]),
                   tuple(port_out["boxes"][i, s].tolist()))
            port.setdefault(key, s)
        for s in np.flatnonzero(jax_out["valid"][i]):
            total += 1
            key = (int(jax_out["class_ids"][i, s]),
                   tuple(jax_out["boxes"][i, s].tolist()))
            if key not in port:
                continue
            p = port[key]
            equal += 1
            dscore = max(dscore, abs(float(jax_out["scores"][i, s])
                                     - float(port_out["scores"][i, p])))
            a = jax_out["masks_packed"][i, s]
            mism += int((a != port_out["masks_packed"][i, p]).sum())
            nbytes += a.size
    return total, equal / max(total, 1), dscore, mism / max(nbytes, 1)


@pytest.fixture(scope="module")
def weights():
    params = jax_params(CFG)
    return params, torch_model(CFG, params)


def test_predict_step_matches_jax(weights):
    """Measured on the CPU (float32, seeded weights and canvases): all 16
    valid detections equal in (class, box), |delta score| 1.2e-7 and no
    mismatched mask byte. The score and mask bars are tightened from
    1e-4 and 1% to that; the share keeps room for one detection that
    another CPU's math library rounds across a boundary."""
    params, model = weights
    rng = np.random.RandomState(7)
    images, windows = _images(rng, 2)
    want = jax.device_get(jax_pipe.predict_step(
        JaxMaskRCNN(CFG), params, jnp.asarray(images), jnp.asarray(windows)))
    got = port_pipe.predict_step(model, _t(images), _t(windows))
    got = {k: v.numpy() for k, v in got.items()}
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert got[k].dtype == want[k].dtype, k
    total, share, dscore, mism = _match(want, got)
    print(f"predict_step parity: {total} valid, (class, box) equal "
          f"{share:.4f}, max |dscore| {dscore:.3g}, mask byte mismatch "
          f"{mism:.3g}")
    assert total > 0
    assert share >= 0.9
    assert dscore <= 1e-5
    assert mism <= 1e-3


def test_detector_detect_batch_matches_jax(weights):
    """Detector end to end on the CPU, 128-px config: canvas placement
    (including an upscaled image through the PIL path), predict_step,
    mask decode to original size, box decode; same detections as the
    JAX Detector on the same weights."""
    from maskrcnn_tpu.api import Detector as JaxDetector
    params, _ = weights
    rng = np.random.RandomState(8)
    images = [rng.randint(0, 256, (128, 128, 3), np.uint8),
              rng.randint(0, 256, (96, 128, 3), np.uint8),
              rng.randint(0, 256, (64, 48, 3), np.uint8)]
    det = Detector(PCFG, "cpu")
    load_jax_params(det.model, params)
    got = det.detect_batch(images)
    want = JaxDetector(CFG, params=params).detect_batch(images)
    assert len(got) == len(images)
    hits = total = apart = pixels = 0
    for img, g, w in zip(images, got, want):
        assert g is not None and w is not None
        cls, scores, boxes, masks = g
        assert masks.shape == (len(cls),) + img.shape[:2]
        assert np.isfinite(np.asarray(boxes)).all()
        assert np.isfinite(np.asarray(scores)).all()
        jax_slot = {(c, tuple(np.round(b, 3))): i
                    for i, (c, b) in enumerate(zip(w[0], w[2]))}
        for c, b, m in zip(cls, boxes, masks):
            i = jax_slot.get((c, tuple(np.round(b, 3))))
            if i is not None:
                hits += 1
                apart += int((m != w[3][i]).sum())
                pixels += m.size
        total += len(w[0])
    assert hits >= 0.9 * total
    assert apart <= 1e-3 * pixels
