"""The port's training samplers, box ops, gt-mask crops and the plain
RoIAlign backward (K1-bwd's plain version) against the JAX package, on
the same numpy-seeded inputs, in float32.

The samplers are compared in the deterministic regime, where no cap
binds (as tests/test_reference_samplers_golden.py sets it up): every
eligible entry is kept on both sides whatever the random draws, and the
test asserts that on the JAX side, so no seed can hide a mismatch. Match
labels, the packing order, class ids, validity, assignments and the
rounded mask crops are equal; deltas agree to 2.4e-7 of their
magnitude (2 ulps: torch's and XLA's log differ in the last bit, and
jitted XLA may divide by the std constants as a reciprocal multiply). Where the caps bind, the tests check properties:
counts at their caps, positives first, and that a torch.Generator seed
reproduces itself. The plain backward agrees with the VJP of the JAX
package's `_gather_patches` custom_vjp to 1e-6 of the largest gradient
(measured: equal to the last bit at these sizes), edge and zero boxes
included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maskrcnn_tpu.config import TinyConfig as JaxTiny
from maskrcnn_tpu.detection.pipeline import _pool_rois as jax_pool_rois
from maskrcnn_tpu.ops import boxes as jax_boxes
from maskrcnn_tpu.ops.anchors import config_anchors
from maskrcnn_tpu.ops.roi_align import (crop_and_resize as jax_crop,
                                        indexed_crop_and_resize as jax_icrop)
from maskrcnn_tpu.train import targets as jt
from maskrcnn_tpu_torch.ops import boxes as port_boxes
from maskrcnn_tpu_torch.ops import roi_align as port_roi
from maskrcnn_tpu_torch.train import targets as pt
from tests.torch_port import edge_boxes, port_config

B = 2


def make_gt(cfg, rng, n_real, n_crowd=0):
    """[G] class ids (crowds negative), [G, 4] pixel boxes, [G] valid."""
    g, d = cfg.MAX_GT_INSTANCES, cfg.IMAGE_MAX_DIM
    cls = np.zeros(g, np.int32)
    boxes = np.zeros((g, 4), np.float32)
    valid = np.zeros(g, bool)
    for i in range(n_real + n_crowd):
        y1, x1 = rng.uniform(0, d * 0.6, 2)
        h, w = rng.uniform(d * 0.15, d * 0.4, 2)
        boxes[i] = [y1, x1, min(y1 + h, d), min(x1 + w, d)]
        cls[i] = rng.randint(1, cfg.NUM_CLASSES) * (1 if i < n_real else -1)
        valid[i] = True
    return cls, boxes, valid


def t(x):
    return torch.from_numpy(np.asarray(x))


def test_box_ops_equal_jax():
    """box_iou, box_area and scale_boxes bit-equal; box_deltas within 2
    float32 ulps (torch's and XLA's log differ in the last bit)."""
    rng = np.random.RandomState(0)
    corner = rng.rand(2, 40, 2).astype(np.float32) * 100
    size = rng.rand(2, 40, 2).astype(np.float32) * 50 + 1
    a = np.concatenate([corner, corner + size], -1)
    b = a[:, ::-1] * np.float32(1.1)
    np.testing.assert_allclose(
        port_boxes.box_deltas(t(a), t(b)).numpy(),
        np.asarray(jax_boxes.box_deltas(a, b)), rtol=2.4e-7, atol=0)
    np.testing.assert_array_equal(
        port_boxes.box_iou(t(a), t(b)).numpy(),
        np.asarray(jax.vmap(jax_boxes.box_iou)(a, b)))
    np.testing.assert_array_equal(port_boxes.box_area(t(a)).numpy(),
                                  np.asarray(jax_boxes.box_area(a)))
    np.testing.assert_array_equal(
        port_boxes.scale_boxes(t(a), [0.5, 2.0, 0.5, 2.0]).numpy(),
        np.asarray(jax_boxes.scale_boxes(a, jnp.asarray([0.5, 2.0, 0.5,
                                                         2.0]))))


def _rpn_scene(cfg, seed):
    rng = np.random.RandomState(seed)
    gts = [make_gt(cfg, rng, 3 + i, n_crowd=1) for i in range(B)]
    return [np.stack(x) for x in zip(*gts)]


def test_rpn_targets_deterministic_equal_jax():
    """RPN_TRAIN_ANCHORS_PER_IMAGE = the anchor count: no subsample fires;
    match labels and packed deltas of both packages agree."""
    base = JaxTiny()
    anchors = config_anchors(base)
    cfg = base.replace(RPN_TRAIN_ANCHORS_PER_IMAGE=len(anchors))
    cls, boxes, valid = _rpn_scene(cfg, 1)
    want = jax.jit(jax.vmap(lambda k, c, bx, v: jt.rpn_targets(
        cfg, k, jnp.asarray(anchors), c, bx, v)))(
            jax.random.split(jax.random.PRNGKey(0), B), cls, boxes, valid)
    match = np.asarray(want.rpn_match)
    n = len(anchors)
    # the JAX side kept every eligible anchor: its caps did not bind
    assert ((match == 1).sum(1) <= n // 2).all()
    assert ((match == 1).sum(1) > 0).all() and (match == -1).any()
    got = pt.rpn_targets(port_config(cfg), torch.Generator().manual_seed(5),
                         t(anchors), t(cls), t(boxes), t(valid))
    np.testing.assert_array_equal(got.rpn_match.numpy(), match)
    np.testing.assert_allclose(got.rpn_bbox.numpy(),
                               np.asarray(want.rpn_bbox), rtol=2.4e-7,
                               atol=0)


def _mrn_scene(cfg, seed):
    """Per image: 3 positives (jittered gt copies), 5 negatives, one
    proposal on a crowd (neither), one far one at IoU < 0.5 of a gt, and
    invalid padding; gt masks random."""
    rng = np.random.RandomState(seed)
    d, g, r = cfg.IMAGE_MAX_DIM, cfg.MAX_GT_INSTANCES, cfg.RPN_NMS_MAX_ROIS_NUM
    out = []
    for _ in range(B):
        cls, boxes, valid = make_gt(cfg, rng, 3, n_crowd=1)
        norm = boxes / d
        props = np.zeros((r, 4), np.float32)
        pvalid = np.zeros(r, bool)
        for i in range(3):
            props[i] = np.clip(norm[i] + rng.uniform(-0.01, 0.01, 4), 0, 1)
        props[3] = norm[3]                       # the crowd box
        for i in range(4, 9):                    # negatives, far corner
            y, x = rng.uniform(0.8, 0.9, 2)
            props[i] = [y, x, y + 0.05, x + 0.05]
        pvalid[:9] = True
        perm = rng.permutation(r)                # scatter over the slots
        masks = (rng.rand(g, d, d) > 0.5).astype(np.uint8)
        out.append((props[perm], pvalid[perm], cls, norm.astype(np.float32),
                    masks, valid))
    return [np.stack(x) for x in zip(*out)]


def test_mrn_targets_deterministic_equal_jax():
    """Positives under p_cap and negatives under the budget on the JAX
    side: rois, classes, deltas, crops, validity and assignment agree."""
    cfg = JaxTiny()
    scene = _mrn_scene(cfg, 2)
    props, pvalid, cls, boxes, masks, valid = scene
    # the JAX side's eligible counts against its limits
    t_ = cfg.TRAIN_ROIS_PER_IMAGE
    p_cap = int(t_ * cfg.ROI_POSITIVE_RATIO)
    for i in range(B):
        inst = (cls[i] > 0) & valid[i]
        crowd = (cls[i] < 0) & valid[i]
        iou = np.asarray(jt._masked_iou(props[i], boxes[i], inst)).max(1)
        ciou = np.asarray(jt._masked_iou(props[i], boxes[i], crowd)).max(1)
        n_pos = int(((iou >= 0.5) & pvalid[i]).sum())
        n_neg = int(((iou < 0.5) & (ciou < 0.001) & pvalid[i]).sum())
        budget = min(int(np.floor(n_pos / np.float32(0.33))) - n_pos,
                     t_ - p_cap)
        assert 0 < n_pos <= p_cap and 0 < n_neg <= budget, (n_pos, n_neg)
    want = jax.jit(jax.vmap(lambda k, *a: jt.mrn_targets(cfg, k, *a)))(
        jax.random.split(jax.random.PRNGKey(0), B), *scene)
    got = pt.mrn_targets(port_config(cfg), torch.Generator().manual_seed(9),
                         *[t(x) for x in scene])
    for f in ("rois", "class_ids", "masks", "valid", "positive",
              "gt_assignment"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)
    np.testing.assert_allclose(got.deltas.numpy(), np.asarray(want.deltas),
                               rtol=2.4e-7, atol=1e-7)


def test_cascade_and_keypoint_targets_equal_jax():
    """cascade_targets (relabeling at 0.6, std / 2) and keypoint_targets
    (labeled, unlabeled and outside keypoints) agree."""
    cfg = JaxTiny(NUM_KEYPOINTS=5)
    props, pvalid, cls, boxes, _, valid = _mrn_scene(cfg, 3)
    rois = np.where(pvalid[..., None], props, 0).astype(np.float32)
    std = np.asarray(cfg.BBOX_STD_DEV, np.float32) / np.float32(2)
    want = jax.vmap(lambda r, v, c, bx, gv: jt.cascade_targets(
        cfg, r, v, c, bx, gv, 0.6, jnp.asarray(std)))(
            rois, pvalid, cls, boxes, valid)
    got = pt.cascade_targets(port_config(cfg), t(rois), t(pvalid), t(cls),
                             t(boxes), t(valid), 0.6, t(std))
    for f in ("class_ids", "valid", "positive", "assignment"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)
    np.testing.assert_allclose(got.deltas.numpy(), np.asarray(want.deltas),
                               rtol=2.4e-7, atol=1e-7)
    assert got.positive.any()

    rng = np.random.RandomState(4)
    d = cfg.IMAGE_MAX_DIM
    kps = rng.uniform(-10, d + 10, (B, cfg.MAX_GT_INSTANCES, 5, 3)).astype(
        np.float32)
    kps[..., 2] = rng.randint(0, 3, kps.shape[:-1])
    assign = np.asarray(got.assignment)
    pos = np.asarray(got.positive)
    want_pos, want_valid = jax.vmap(lambda r, a, p, g: jt.keypoint_targets(
        cfg, r, a, p, g))(rois, assign, pos, kps)
    got_pos, got_valid = pt.keypoint_targets(
        port_config(cfg), t(rois), t(assign), t(pos), t(kps))
    np.testing.assert_array_equal(got_valid.numpy(), np.asarray(want_valid))
    np.testing.assert_array_equal(got_pos.numpy(), np.asarray(want_pos))
    assert want_valid.any() and not np.asarray(want_valid).all()


def test_random_regime_properties():
    """Caps that bind: at most RPN_TRAIN_ANCHORS_PER_IMAGE / 2 positive
    anchors and the budget filled; mrn positives at p_cap and first,
    negatives at the budget; the same seed gives the same samples, another
    seed other ones."""
    cfg = port_config(JaxTiny())
    anchors = torch.from_numpy(config_anchors(JaxTiny()))
    rng = np.random.RandomState(6)
    gts = [make_gt(cfg, rng, 8) for _ in range(B)]
    cls, boxes, valid = [t(np.stack(x)) for x in zip(*gts)]

    def rpn(seed, c=cfg):
        return pt.rpn_targets(c, torch.Generator().manual_seed(seed),
                              anchors, cls, boxes, valid)
    a, a2, c = rpn(0), rpn(0), rpn(1)
    # every eligible anchor: the cap at the anchor count
    full = rpn(0, cfg.replace(RPN_TRAIN_ANCHORS_PER_IMAGE=len(anchors)))
    tr = cfg.RPN_TRAIN_ANCHORS_PER_IMAGE
    n_pos = torch.clamp_max((full.rpn_match == 1).sum(1), tr // 2)
    assert torch.equal((a.rpn_match == 1).sum(1), n_pos)
    assert ((a.rpn_match != 0).sum(1) == tr).all()
    assert not (a.rpn_match & ~full.rpn_match).any()
    assert ((a.rpn_match == 1) <= (full.rpn_match == 1)).all()
    assert torch.equal(a.rpn_match, a2.rpn_match)
    assert not torch.equal(a.rpn_match, c.rpn_match)

    # many positives and negatives
    r = cfg.RPN_NMS_MAX_ROIS_NUM
    norm = boxes / cfg.IMAGE_MAX_DIM
    props = torch.cat([norm[:, :8].repeat(1, 4, 1)
                       + torch.from_numpy(rng.uniform(-0.005, 0.005,
                                                      (B, 32, 4))).float(),
                       torch.rand(B, r - 32, 4, generator=torch.Generator()
                                  .manual_seed(3)).sort(-1).values * 0.02
                       + 0.97], dim=1).clamp(0, 1).float()
    pvalid = torch.ones(B, r, dtype=torch.bool)
    masks = torch.from_numpy((rng.rand(B, cfg.MAX_GT_INSTANCES,
                                       cfg.IMAGE_MAX_DIM,
                                       cfg.IMAGE_MAX_DIM) > 0.5)
                             .astype(np.uint8))

    def mrn(seed):
        return pt.mrn_targets(cfg, torch.Generator().manual_seed(seed),
                              props, pvalid, cls, norm, masks, valid)
    m, m2, m3 = mrn(0), mrn(0), mrn(1)
    tt = cfg.TRAIN_ROIS_PER_IMAGE
    p_cap = int(tt * cfg.ROI_POSITIVE_RATIO)
    assert m.positive[:, :p_cap].all() and not m.positive[:, p_cap:].any()
    n_neg = int(np.floor(p_cap / np.float32(0.33))) - p_cap
    assert ((m.valid & ~m.positive).sum(1) == n_neg).all()
    for f in m._fields:
        assert torch.equal(getattr(m, f), getattr(m2, f)), f
    assert not torch.equal(m.rois, m3.rois)


def test_gt_mask_crops_equal_jax():
    """crop_and_resize and indexed_crop_and_resize of uint8 masks (C=1),
    boxes partly outside and zero: bit-equal."""
    rng = np.random.RandomState(7)
    masks = (rng.rand(4, 40, 52, 1) > 0.5).astype(np.uint8)
    boxes = edge_boxes(rng, 30)
    idx = rng.randint(0, 4, 30).astype(np.int32)
    np.testing.assert_array_equal(
        port_roi.indexed_crop_and_resize(t(masks), t(boxes), t(idx),
                                         28).numpy(),
        np.asarray(jax_icrop(masks, boxes, idx, 28)))
    np.testing.assert_array_equal(
        port_roi.crop_and_resize(t(masks[1]), t(boxes), 14).numpy(),
        np.asarray(jax_crop(masks[1], boxes, 14)))


@pytest.mark.parametrize("pool", [7, 14])
def test_roi_align_backward_plain_equal_jax_vjp(pool):
    """The plain level gradients (and RoIAlignFunction's CPU backward
    through autograd) against the VJP of the JAX RoIAlign on the training
    route (`_pool_rois`, the `_gather_patches` custom_vjp), C=64 levels,
    boxes on all four levels, edge boxes (outside, zero, thin) included."""
    rng = np.random.RandomState(8)
    # the 1024² level rule over small levels, boxes of every level
    shape = (1024, 1024, 3)
    levels = [rng.randn(B, s, s, 64).astype(np.float32)
              for s in (32, 16, 8, 4)]

    def image_boxes():
        size = np.exp(rng.uniform(np.log(0.03), 0, (20, 2)))
        corner = rng.rand(20, 2) * (1 - size)
        spread = np.concatenate([corner, corner + size], 1)
        return np.concatenate([edge_boxes(rng, 20), spread]).astype(
            np.float32)
    boxes = np.stack([image_boxes() for _ in range(B)])
    g = rng.randn(B, 40, pool, pool, 64).astype(np.float32)
    _, vjp = jax.vjp(lambda *f: jax_pool_rois(list(f), boxes, pool, shape),
                     *levels)
    want = vjp(g)
    got = port_roi.multilevel_roi_align_backward(
        t(g), [lv.shape for lv in levels], torch.float32, t(boxes), pool,
        shape)
    feats = [t(lv).requires_grad_() for lv in levels]
    out = port_roi.multilevel_roi_align_impl(feats, t(boxes), pool, shape)
    via_fn = torch.autograd.grad(out, feats, t(g))
    for w, a, f in zip(want, got, via_fn):
        w = np.asarray(w)
        scale = np.abs(w).max()
        assert scale > 0
        np.testing.assert_allclose(a.numpy(), w, rtol=0, atol=1e-6 * scale)
        assert torch.equal(a, f)
