"""The port's six training losses against the JAX package's on the same
numpy-seeded tensors (float32), batched as the step calls them, and the
zeros of empty selections. Bar: 1e-5 relative, 1e-6 absolute (float32
sums over up to 25k terms run in another order; the mask BCE's measured
gap is 2.1e-6 relative, the others' below 2.4e-7)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maskrcnn_tpu.train import losses as JL
from maskrcnn_tpu_torch.train import losses as PL

B, A, T, K = 2, 300, 16, 5
RTOL = 1e-5


def t(x):
    return torch.from_numpy(np.asarray(x))


def close(got, want):
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL, atol=1e-6)


@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(0)
    match = rng.choice([-1, 0, 1], (B, A), p=[0.3, 0.6, 0.1]).astype(
        np.int32)
    n_pos = (match == 1).sum(1).max()
    rpn_bbox_t = np.zeros((B, 64, 4), np.float32)
    rpn_bbox_t[:, :n_pos] = rng.randn(B, n_pos, 4)
    cls = rng.randint(0, K, (B, T)).astype(np.int32)
    pos = rng.rand(B, T) > 0.6
    return dict(
        match=match, rpn_logits=rng.randn(B, A, 2).astype(np.float32) * 3,
        rpn_bbox=rng.randn(B, A, 4).astype(np.float32) * 2,
        rpn_bbox_t=rpn_bbox_t, cls=np.where(pos, cls, 0).astype(np.int32),
        logits=rng.randn(B, T, K).astype(np.float32) * 2,
        valid=rng.rand(B, T) > 0.3, pos=pos,
        deltas_t=rng.randn(B, T, 4).astype(np.float32),
        deltas=rng.randn(B, T, K, 4).astype(np.float32) * 2,
        masks_t=(rng.rand(B, T, 28, 28) > 0.5).astype(np.float32),
        # saturated probabilities too: the eps clamp
        masks=np.clip(rng.rand(B, T, 28, 28, K) * 1.2 - 0.1, 0, 1).astype(
            np.float32),
        kp_logits=rng.randn(B, T, 8, 8, 3).astype(np.float32),
        kp_pos=rng.randint(0, 64, (B, T, 3)).astype(np.int32),
        kp_valid=rng.rand(B, T, 3) > 0.5)


def test_rpn_losses_equal_jax(data):
    d = data
    close(PL.rpn_class_loss(t(d["match"]), t(d["rpn_logits"])),
          JL.rpn_class_loss(d["match"], d["rpn_logits"]))
    close(PL.rpn_box_loss(t(d["rpn_bbox_t"]), t(d["match"]),
                          t(d["rpn_bbox"])),
          JL.rpn_box_loss(d["rpn_bbox_t"], d["match"], d["rpn_bbox"]))


def test_head_losses_equal_jax(data):
    d = data
    close(PL.mrn_class_loss(t(d["cls"]), t(d["logits"]), t(d["valid"])),
          JL.mrn_class_loss(d["cls"], d["logits"], d["valid"]))
    close(PL.mrn_box_loss(t(d["cls"]), t(d["deltas_t"]), t(d["deltas"]),
                          t(d["pos"])),
          JL.mrn_box_loss(d["cls"], d["deltas_t"], d["deltas"], d["pos"]))
    close(PL.mask_loss(t(d["cls"]), t(d["masks_t"]), t(d["masks"]),
                       t(d["pos"])),
          JL.mask_loss(d["cls"], d["masks_t"], d["masks"], d["pos"]))
    close(PL.keypoint_loss(t(d["kp_pos"]), t(d["kp_valid"]),
                           t(d["kp_logits"])),
          JL.keypoint_loss(d["kp_pos"], d["kp_valid"], d["kp_logits"]))
    x = np.linspace(-3, 3, 61, dtype=np.float32)
    np.testing.assert_array_equal(PL.smooth_l1(t(x)).numpy(),
                                  np.asarray(JL.smooth_l1(jnp.asarray(x))))


def test_empty_selections_are_zero(data):
    """No sampled anchor, no positive, no valid RoI, no valid keypoint:
    every loss is exactly 0, as in both packages."""
    d = data
    zero_match = np.zeros((B, A), np.int32)
    none = np.zeros((B, T), bool)
    got = [
        PL.rpn_class_loss(t(zero_match), t(d["rpn_logits"])),
        PL.rpn_box_loss(t(d["rpn_bbox_t"]), t(zero_match), t(d["rpn_bbox"])),
        PL.mrn_class_loss(t(d["cls"]), t(d["logits"]), t(none)),
        PL.mrn_box_loss(t(d["cls"]), t(d["deltas_t"]), t(d["deltas"]),
                        t(none)),
        PL.mask_loss(t(d["cls"]), t(d["masks_t"]), t(d["masks"]), t(none)),
        PL.keypoint_loss(t(d["kp_pos"]), t(np.zeros((B, T, 3), bool)),
                         t(d["kp_logits"]))]
    want = [
        JL.rpn_class_loss(zero_match, d["rpn_logits"]),
        JL.rpn_box_loss(d["rpn_bbox_t"], zero_match, d["rpn_bbox"]),
        JL.mrn_class_loss(d["cls"], d["logits"], none),
        JL.mrn_box_loss(d["cls"], d["deltas_t"], d["deltas"], none),
        JL.mask_loss(d["cls"], d["masks_t"], d["masks"], none),
        JL.keypoint_loss(d["kp_pos"], np.zeros((B, T, 3), bool),
                         d["kp_logits"])]
    assert [float(v) for v in got] == [float(v) for v in want] == [0.0] * 6
