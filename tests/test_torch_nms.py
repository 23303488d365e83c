"""The port's plain NMS against the JAX package: the XLA fixpoint
`nms_mask` and the Pallas kernel in interpret mode. Keep masks must be
equal bit for bit.

N = 1,345 and 2,000 lie above what K2's shared memory holds (its bitmask
goes through device memory there); the Pallas kernel in interpret mode
takes about 37 s at N = 1,345 on the CPU (its 64-step blocks unroll into
one program), so those two N are held against the XLA `nms_mask` only."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas as pl

import maskrcnn_tpu.ops.nms_pallas as NP
from maskrcnn_tpu.ops import nms as jax_nms
from maskrcnn_tpu_torch.ops import nms as port_nms
from tests.test_nms import rand_dets


@pytest.fixture(autouse=True)
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(NP.pl, "pallas_call", patched)


def _sorted_case(rng, n, invalid_share=0.15):
    dets = rand_dets(rng, n)
    order = np.argsort(-dets[:, 4], kind="stable")
    boxes = np.ascontiguousarray(dets[order, :4])
    valid = rng.rand(n) >= invalid_share
    return boxes, valid


# the largest N whose Pallas interpret run stays within seconds
PALLAS_MAX_N = 500


@pytest.mark.parametrize("thr", [0.3, 0.5, 0.7])
@pytest.mark.parametrize("n", [50, 64, 130, 500, 1345, 2000])
def test_nms_mask_matches_jax(n, thr):
    rng = np.random.RandomState(n * 10 + int(thr * 10))
    boxes, valid = _sorted_case(rng, n)
    got = port_nms.nms_mask(torch.from_numpy(boxes),
                            torch.from_numpy(valid), thr).numpy()
    want = np.asarray(jax_nms.nms_mask(jnp.asarray(boxes),
                                       jnp.asarray(valid), thr))
    np.testing.assert_array_equal(got, want)
    assert not got[~valid].any()
    if n <= PALLAS_MAX_N:
        pallas = np.asarray(NP.nms_mask_pallas(jnp.asarray(boxes),
                                               jnp.asarray(valid), thr))
        np.testing.assert_array_equal(got, pallas)


def test_nms_mask_batched_equals_per_image():
    rng = np.random.RandomState(3)
    cases = [_sorted_case(rng, 130) for _ in range(3)]
    boxes = torch.from_numpy(np.stack([c[0] for c in cases]))
    valid = torch.from_numpy(np.stack([c[1] for c in cases]))
    got = port_nms.nms_mask_impl(boxes, valid, 0.5).numpy()
    for i, (b, v) in enumerate(cases):
        want = np.asarray(jax_nms.nms_mask(jnp.asarray(b), jnp.asarray(v),
                                           0.5))
        np.testing.assert_array_equal(got[i], want, err_msg=f"image {i}")


@pytest.mark.parametrize("n", [64, 500])
def test_multiclass_nms_matches_jax(n):
    """Rounded boxes with class offsets at 0.3, as mrn_refine calls it."""
    rng = np.random.RandomState(n)
    dets = rand_dets(rng, n, size=120.0)
    order = np.argsort(-dets[:, 4], kind="stable")
    boxes = np.round(dets[order, :4])
    classes = rng.randint(0, 6, n).astype(np.int32)
    valid = (rng.rand(n) > 0.1) & (classes > 0)
    got = port_nms.multiclass_nms_mask(
        torch.from_numpy(boxes), torch.from_numpy(classes),
        torch.from_numpy(valid), 0.3, coord_span=200.0).numpy()
    for impl in ("xla", "pallas"):
        want = np.asarray(jax_nms.multiclass_nms_mask(
            jnp.asarray(boxes), jnp.asarray(classes), jnp.asarray(valid),
            0.3, coord_span=200.0, impl=impl))
        np.testing.assert_array_equal(got, want, err_msg=impl)


def test_iou_plus_one_matches_jax():
    rng = np.random.RandomState(5)
    boxes = rand_dets(rng, 70)[:, :4]
    got = port_nms._iou_plus_one(torch.from_numpy(boxes)).numpy()
    want = np.asarray(jax_nms._iou_plus_one(jnp.asarray(boxes)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("tied", [False, True], ids=["distinct", "tied"])
def test_rpn_refine_scores_matches_jax_at_2000_rois(tied):
    """RPN_NMS_MAX_ROIS_NUM=2000 at TinyConfig (4,092 anchors), so the
    proposal NMS runs at N = PRE_NMS_LIMIT = 2,000, where K2's bitmask
    goes through device memory; the port's proposals equal the JAX
    package's. tied: scores on 3 levels, as saturated sigmoids are."""
    import jax
    from maskrcnn_tpu.config import TinyConfig
    from maskrcnn_tpu.detection import pipeline as jax_pipe
    from maskrcnn_tpu.ops.anchors import config_anchors
    from maskrcnn_tpu_torch.detection import pipeline as port_pipe
    from tests.torch_port import port_config
    cfg = TinyConfig().replace(RPN_NMS_MAX_ROIS_NUM=2000)
    assert cfg.PRE_NMS_LIMIT == 2000
    rng = np.random.RandomState(20 + int(tied))
    anchors = config_anchors(cfg)
    scores = rng.rand(2, anchors.shape[0]).astype(np.float32)
    if tied:
        scores = np.round(scores * 2) / 2
    deltas = (rng.randn(2, anchors.shape[0], 4) * 0.3).astype(np.float32)
    want_p, want_v = jax.vmap(lambda s, d: jax_pipe.rpn_refine_scores(
        cfg, jnp.asarray(anchors), s, d))(jnp.asarray(scores),
                                           jnp.asarray(deltas))
    got_p, got_v = port_pipe.rpn_refine_scores(
        port_config(cfg), torch.from_numpy(anchors),
        torch.from_numpy(scores), torch.from_numpy(deltas))
    assert got_v.shape == (2, 2000)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), rtol=1e-6,
                               atol=1e-6)
