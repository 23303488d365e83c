"""The port's inference protocols, op by op, against the JAX package:
soft-NMS, the flip mirrors, the TTA merge (box fusion, then hard NMS or
soft-NMS), mrn_refine's soft, delta_std and unrounded branches, the
keypoint head and decode, the device resample, the merge's class-offset
NMS, and the rectangular canvas's geometry.

Tolerances, each measured on the CPU and stated where it is asserted:
* soft-NMS: the same selections, |delta score| <= 1e-6 (XLA's exp and
  PyTorch's differ in the last bit), against a JAX reference computed in
  a process of its own on one CPU (see `_soft_nms_reference`);
* flips, the merge's NMS keep mask, the resample at scale 1: bit-equal;
* the merge: the same valid slots and classes, |delta score| <= 1e-6,
  boxes within 1e-4 px (the fusion's sums run in another order), and
  rounded boxes equal except at .5 ties (counted);
* the keypoint head: |delta logit| <= 1e-5 of the logits' range (the JAX
  package's 2x bilinear blends one axis after the other, the port both
  at once);
* the resample on an upscale: uint8 equal except where JAX's float value
  lies within 1e-4 of a .5 tie (XLA contracts the coordinate into an FMA
  under jit); every differing value is counted and checked.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maskrcnn_tpu.api import Detector as JaxDetector
from maskrcnn_tpu.config import TinyConfig
from maskrcnn_tpu.data.codecs import resize_image
from maskrcnn_tpu.detection import pipeline as jax_pipe
from maskrcnn_tpu.models.heads import KeypointHead as JaxKeypointHead
from maskrcnn_tpu.ops import image as jax_image
from maskrcnn_tpu.ops import nms as jax_nms
from maskrcnn_tpu.ops.anchors import config_anchors
from maskrcnn_tpu_torch.api import Detector
from maskrcnn_tpu_torch.data import codecs as port_codecs
from maskrcnn_tpu_torch.detection import pipeline as port_pipe
from maskrcnn_tpu_torch.models.heads import KeypointHead
from maskrcnn_tpu_torch.ops import anchors as port_anchors
from maskrcnn_tpu_torch.ops import image as port_image
from maskrcnn_tpu_torch.ops import nms as port_nms
from tests.torch_port import port_config

CFG = TinyConfig().replace(DETECTION_MIN_CONFIDENCE=0.0)
PCFG = port_config(CFG)


def _t(x):
    return torch.tensor(np.asarray(x))


def _np(x):
    return np.asarray(x.detach().numpy() if torch.is_tensor(x) else x)


def _boxes(rng, b, n, span=100.0, size=(5.0, 35.0)):
    ctr = rng.rand(b, n, 2) * span
    sz = rng.rand(b, n, 2) * (size[1] - size[0]) + size[0]
    return np.concatenate([ctr - sz / 2, ctr + sz / 2], -1).astype(np.float32)


SOFT_NMS_CASES = {"s0.5": (0.5, False), "s0.5-tied": (0.5, True),
                  "s0.3": (0.3, False)}
SOFT_NMS_ITERS = 50

# The JAX scan's float32 bits depend on the host: XLA:CPU splits the
# scan's loops across as many intra-op threads as the process may use
# (on an 8-CPU x86-64 host, 4 or 5 CPUs give other bits for s0.5-tied
# than 1-3 or 6-8) and vectorises for the CPU's ISA (SSE4.2 and AVX give
# other bits than AVX2 and AVX-512), and the suite's compile cache can
# hand back an executable compiled by another process. An ulp that flips a near-tie in the
# argmax changes the order of selection. The port's bits depend on none
# of these (the same under 1, 2 and 8 threads and ATen's AVX2 and
# AVX-512 kernels), so the reference is computed in a process of its own
# on one CPU, with the ISA capped at AVX2 and no compile cache.
SOFT_NMS_REFERENCE = r"""
import os, sys
os.sched_setaffinity(0, {min(os.sched_getaffinity(0))})
import numpy as np
import jax
from maskrcnn_tpu.ops import nms as jax_nms
cases = np.load(sys.argv[1])
out = {}
for name in sys.argv[3:]:
    sigma = float(cases[name + "/sigma"])
    f = jax.jit(jax.vmap(lambda x, s, v: jax_nms.soft_nms_scores(
        x, s, v, sigma, int(cases["iters"]))))
    out[name] = np.asarray(f(cases[name + "/boxes"], cases[name + "/scores"],
                             cases[name + "/valid"]))
np.savez(sys.argv[2], **out)
"""


def _soft_nms_inputs(sigma, tied):
    rng = np.random.RandomState(int(sigma * 10) + tied)
    b, n = 3, 100
    boxes = _boxes(rng, b, n)
    scores = rng.rand(b, n).astype(np.float32)
    if tied:
        scores = np.round(scores * 3) / 3
    valid = rng.rand(b, n) > 0.2
    return boxes, scores, valid


@pytest.fixture(scope="module")
def _soft_nms_reference(tmp_path_factory):
    """The JAX scan's scores for every case, from one pinned process."""
    tmp = tmp_path_factory.mktemp("soft_nms")
    arrays = {"iters": np.int32(SOFT_NMS_ITERS)}
    for name, (sigma, tied) in SOFT_NMS_CASES.items():
        boxes, scores, valid = _soft_nms_inputs(sigma, tied)
        arrays.update({name + "/sigma": np.float64(sigma),
                       name + "/boxes": boxes, name + "/scores": scores,
                       name + "/valid": valid})
    np.savez(tmp / "in.npz", **arrays)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("XLA_", "JAX_"))}
    env.update(JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_cpu_max_isa=AVX2")
    repo = Path(__file__).resolve().parents[1]
    proc = subprocess.run([sys.executable, "-c", SOFT_NMS_REFERENCE,
                           str(tmp / "in.npz"), str(tmp / "out.npz"),
                           *SOFT_NMS_CASES], cwd=repo, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    with np.load(tmp / "out.npz") as out:
        return {name: out[name] for name in SOFT_NMS_CASES}


@pytest.mark.parametrize("case", list(SOFT_NMS_CASES))
def test_soft_nms_scores_matches_jax(case, _soft_nms_reference):
    """Batched soft-NMS against the JAX scan on each image: the same boxes
    selected (score > 0), |delta score| <= 1e-6. Tied scores (4 levels)
    check that the argmax takes the first index on both sides."""
    sigma, tied = SOFT_NMS_CASES[case]
    boxes, scores, valid = _soft_nms_inputs(sigma, tied)
    want = _soft_nms_reference[case]
    got = _np(port_nms.soft_nms_scores(_t(boxes), _t(scores), _t(valid),
                                       sigma, SOFT_NMS_ITERS))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got > 0, want > 0)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_soft_nms_nothing_left_to_select():
    """More steps than valid boxes, and an image with none: the extra
    steps change nothing, and the empty image's scores are all 0."""
    rng = np.random.RandomState(3)
    boxes = _t(_boxes(rng, 2, 6))
    scores = _t(rng.rand(2, 6).astype(np.float32))
    valid = torch.tensor([[True, False, True, True, False, False],
                          [False] * 6])
    few = port_nms.soft_nms_scores(boxes, scores, valid, 0.5, 3)
    many = port_nms.soft_nms_scores(boxes, scores, valid, 0.5, 20)
    assert torch.equal(few, many)
    assert not bool(many[1].any()) and not bool(many[0][~valid[0]].any())


def test_flip_boxes_and_windows_exact():
    """One subtraction a coordinate on both sides: bit-equal, once and
    twice (twice is not the identity in float32: w - x rounds)."""
    rng = np.random.RandomState(4)
    w = 192
    boxes = (rng.rand(2, 9, 4) * w).astype(np.float32)
    windows = np.array([[10, 14, 118, 114], [0, 0, 128, 100]], np.float32)
    for port, jax_fn, x in ((port_pipe.flip_boxes, jax_pipe.flip_boxes,
                             boxes),
                            (port_pipe.flip_windows, jax_pipe.flip_windows,
                             windows)):
        once = jax_fn(jnp.asarray(x), w)
        np.testing.assert_array_equal(_np(port(_t(x), w)), np.asarray(once))
        np.testing.assert_array_equal(_np(port(port(_t(x), w), w)),
                                      np.asarray(jax_fn(once, w)))


def _dets(boxes, scores, class_ids, valid):
    """One Detections of numpy arrays [B, D, ...] for each package."""
    arrays = (np.asarray(class_ids, np.int32), np.asarray(scores, np.float32),
              np.asarray(boxes, np.float32), np.asarray(valid, bool))
    return (jax_pipe.Detections(*map(jnp.asarray, arrays)),
            port_pipe.Detections(*map(_t, arrays)))


def _pass_pair(rng, d):
    """Two passes' detections [2, d] in one frame: pass b finds most of
    pass a's objects again, jittered by up to 3 px, with other scores,
    plus objects of its own; classes 1-3, some slots invalid."""
    boxes = _boxes(rng, 2, d, span=110.0, size=(10.0, 40.0))
    classes = rng.randint(1, 4, (2, d))
    scores = rng.rand(2, d).astype(np.float32)
    valid = rng.rand(2, d) > 0.15
    boxes_b = boxes + rng.uniform(-3, 3, boxes.shape).astype(np.float32)
    fresh = rng.rand(2, d) < 0.3
    boxes_b[fresh] = _boxes(rng, 1, int(fresh.sum()), 110.0, (10.0, 40.0))[0]
    a = _dets(boxes, scores, classes, valid)
    b = _dets(boxes_b, rng.rand(2, d).astype(np.float32), classes,
              rng.rand(2, d) > 0.15)
    return a, b


def _assert_merge_equal(cfg, a, b):
    want = jax.device_get(jax_pipe.merge_detections(cfg, a[0], b[0]))
    got = port_pipe.merge_detections(port_config(cfg), a[1], b[1])
    np.testing.assert_array_equal(_np(got.valid), want.valid)
    np.testing.assert_array_equal(_np(got.class_ids), want.class_ids)
    np.testing.assert_allclose(_np(got.scores), want.scores, rtol=0,
                               atol=1e-6)
    gb, wb = _np(got.boxes), np.asarray(want.boxes)
    np.testing.assert_allclose(gb, wb, rtol=0, atol=1e-4)
    # the TTA path rounds the merged boxes: equal but at .5 ties
    apart = np.round(gb) != np.round(wb)
    frac = np.abs(wb - np.floor(wb) - 0.5)
    assert (frac[apart] < 1e-4).all(), (gb[apart], wb[apart])
    return int(want.valid.sum()), int(apart.sum())


@pytest.mark.parametrize("fusion,sigma", [(0.5, 0.0), (0.5, 0.5),
                                          (0.0, 0.0)],
                         ids=["fusion-hard", "fusion-soft", "hard"])
def test_merge_detections_matches_jax(fusion, sigma):
    """Random two-pass sets with flip-like pairs: valid slots and classes
    equal, scores within 1e-6, boxes within 1e-4 px (the fusion's weight
    sums and product run in another order), rounded boxes equal but at
    .5 ties (counted: none in this data)."""
    rng = np.random.RandomState(int(10 * fusion + 100 * sigma))
    cfg = CFG.replace(TTA_FUSION_IOU=fusion,
                      DETECTION_SOFT_NMS_SIGMA=sigma)
    a, b = _pass_pair(rng, CFG.DETECTION_MAX_INSTANCES)
    kept, ties = _assert_merge_equal(cfg, a, b)
    print(f"merge {fusion} {sigma}: {kept} kept, {ties} rounding ties")
    assert kept > 0 and ties == 0


def _case(d, rows_a, rows_b):
    """tests/test_tta.py's scenarios: rows are (box, score, class,
    valid), padded to d invalid slots, one image."""
    def pad(rows):
        z = ([0.0] * 4, 0.0, 0, False)
        rows = list(rows) + [z] * (d - len(rows))
        return _dets(*[[[r[i] for r in rows]] for i in range(4)])
    return pad(rows_a), pad(rows_b)


MERGE_CASES = {
    "fuses-matched-pair": ([([20, 20, 60, 60], 0.9, 1, True)],
                           [([24, 24, 64, 64], 0.6, 1, True)]),
    "identity-when-passes-agree": (
        [([10, 10, 40, 40], 0.9, 1, True), ([60, 60, 90, 90], 0.7, 2, True)],
        [([10, 10, 40, 40], 0.9, 1, True), ([60, 60, 90, 90], 0.7, 2, True)]),
    "singleton-keeps-coords": ([([20, 20, 60, 60], 0.37, 1, True)], []),
    "never-crosses-classes": ([([20, 20, 60, 60], 0.9, 1, True)],
                              [([22, 22, 62, 62], 0.8, 2, True)]),
    "dedup-and-order": (
        [([10, 10, 40, 40], 0.9, 1, True), ([60, 60, 90, 90], 0.7, 2, True)],
        [([10, 10, 40, 40], 0.8, 1, True),
         ([100, 100, 120, 120], 0.6, 1, True),
         ([0, 0, 128, 128], 0.99, 3, False)]),
    "keeps-other-class": ([([20, 20, 70, 70], 0.9, 1, True)],
                          [([20, 20, 70, 70], 0.8, 2, True)]),
    "overlapping-duplicates": ([([20, 20, 70, 70], 0.9, 1, True)],
                               [([22, 22, 72, 72], 0.8, 1, True)]),
}


@pytest.mark.parametrize("sigma", [0.0, 0.5], ids=["hard", "soft"])
@pytest.mark.parametrize("case", list(MERGE_CASES))
def test_merge_cases_match_jax(case, sigma):
    """The merge scenarios of tests/test_tta.py, hard and soft, through
    both packages: the same result (tolerances above)."""
    cfg = CFG.replace(DETECTION_SOFT_NMS_SIGMA=sigma)
    a, b = _case(cfg.DETECTION_MAX_INSTANCES, *MERGE_CASES[case])
    kept, ties = _assert_merge_equal(cfg, a, b)
    assert kept >= 1 and ties == 0


def test_merge_nms_keep_matches_multiclass_nms_mask():
    """The merge's hard NMS on the inputs it gets at full width (the
    open NMS-conventions check of a new caller): N = 2D = 100 score-sorted
    rows, invalid rows at the end, class ids up to 80 on a 1024 canvas,
    so offsets reach 81 * 1026. The port's keep mask (the kernel's plain
    version on the CPU; chip_smoke holds the kernel to it) equals JAX's
    multiclass_nms_mask."""
    rng = np.random.RandomState(11)
    n, span = 100, 1024.0
    for trial in range(4):
        boxes = _boxes(rng, 1, n, span=span, size=(8.0, 200.0))[0]
        boxes = np.clip(boxes, 0.0, span)
        classes = rng.randint(1, 81, n) if trial else np.full(n, 80)
        scores = -np.sort(-rng.rand(n)).astype(np.float32)
        valid = np.arange(n) < n - 7 * trial
        want = np.asarray(jax_nms.multiclass_nms_mask(
            jnp.asarray(boxes), jnp.asarray(classes), jnp.asarray(valid),
            0.3, coord_span=span))
        got = _np(port_nms.multiclass_nms_mask(
            _t(boxes)[None], _t(classes)[None], _t(valid)[None], 0.3,
            coord_span=span))[0]
        np.testing.assert_array_equal(got, want)
        assert 0 < got.sum() < valid.sum() or trial


def _refine_inputs(rng, b=2):
    r, k = CFG.RPN_NMS_MAX_ROIS_NUM, CFG.NUM_CLASSES
    proposals = np.zeros((b, r, 4), np.float32)
    proposals[..., :2] = rng.uniform(0, 0.6, (b, r, 2))
    proposals[..., 2:] = proposals[..., :2] + rng.uniform(0.05, 0.4,
                                                          (b, r, 2))
    valid = rng.rand(b, r) > 0.2
    logits = rng.randn(b, r, k).astype(np.float32) * 3
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    deltas = (rng.randn(b, r, k, 4) * 0.1).astype(np.float32)
    windows = np.array([[0, 0, 128, 128], [16, 0, 112, 128]], np.float32)
    return proposals, valid, probs.astype(np.float32), deltas, windows


@pytest.mark.parametrize("sigma,delta_std,round_boxes", [
    (0.5, None, True), (0.0, (0.1 / 3, 0.1 / 3, 0.2 / 3, 0.2 / 3), True),
    (0.0, None, False), (0.5, (0.05, 0.05, 0.1, 0.1), False)],
    ids=["soft", "delta_std", "unrounded", "soft-delta_std-unrounded"])
def test_mrn_refine_branches_match_jax(sigma, delta_std, round_boxes):
    """mrn_refine's three options: valid and classes equal, boxes within
    1 float32 ulp of 128 px (unrounded) or equal, scores within 1e-6."""
    rng = np.random.RandomState(12)
    cfg = CFG.replace(DETECTION_SOFT_NMS_SIGMA=sigma)
    args = _refine_inputs(rng)
    want = jax.device_get(jax.vmap(lambda p, v, pr, d, wi: jax_pipe.mrn_refine(
        cfg, p, v, pr, d, wi, delta_std=delta_std,
        round_boxes=round_boxes))(*map(jnp.asarray, args)))
    got = port_pipe.mrn_refine(port_config(cfg), *map(_t, args),
                               delta_std=delta_std, round_boxes=round_boxes)
    np.testing.assert_array_equal(_np(got.valid), want.valid)
    np.testing.assert_array_equal(_np(got.class_ids), want.class_ids)
    np.testing.assert_allclose(_np(got.scores), want.scores, rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(_np(got.boxes), want.boxes, rtol=0,
                               atol=float(np.spacing(np.float32(128))))
    assert want.valid.sum() > 0


KP = dict(NUM_KEYPOINTS=4, KEYPOINT_HEAD_CONVS=2, KEYPOINT_HEAD_DIM=32)


def test_keypoint_head_matches_jax():
    """The keypoint head on carried JAX weights (the layouts of
    checkpoint.convert; the names are held in test_torch_protocols_
    pipeline): [N, 56, 56, K] float32 logits within 1e-5 of the logits'
    range."""
    cfg = CFG.replace(**KP)
    head = JaxKeypointHead(num_keypoints=4, convs=2, dim=32)
    rng = np.random.RandomState(13)
    pooled = rng.randn(5, 14, 14, 256).astype(np.float32)
    params = head.init(jax.random.PRNGKey(2), jnp.asarray(pooled))["params"]
    # non-zero biases, so their order of addition shows
    params = jax.tree_util.tree_map(
        lambda p: p + 0.05 if p.ndim == 1 else p, params)
    want = np.asarray(head.apply({"params": params}, jnp.asarray(pooled)))
    state = {}
    for name, e in params.items():
        state[f"{name}.weight"] = torch.tensor(
            np.asarray(e["kernel"]).transpose(3, 2, 0, 1))
        state[f"{name}.bias"] = torch.tensor(np.asarray(e["bias"]))
    port = KeypointHead(cfg.NUM_KEYPOINTS, cfg.KEYPOINT_HEAD_CONVS,
                        cfg.KEYPOINT_HEAD_DIM, dtype=torch.float32)
    port.load_state_dict(state, strict=True)
    got = _np(port(_t(pooled)))
    assert got.shape == want.shape == (5, 56, 56, 4)
    assert got.dtype == np.float32
    span = float(want.max() - want.min())
    err = float(np.abs(got - want).max())
    print(f"keypoint head: max |delta logit| {err:.3g} of range {span:.3g}")
    assert err <= 1e-5 * span


def test_decode_keypoints_matches_jax():
    """Random heatmaps with planted peaks and exact ties (two equal
    maxima: both take the first cell): the same cells and scores,
    coordinates within 2 float32 ulp of the box's far edge, zeros for
    invalid rows."""
    cfg = CFG.replace(**KP)
    rng = np.random.RandomState(14)
    n, k = 6, 4
    logits = rng.randn(n, 56, 56, k).astype(np.float32)
    logits[0, 3, 50, 0] = logits[0, 40, 2, 0] = 30.0      # a tie
    logits[1, 55, 55, 1] = 25.0
    boxes = np.sort(rng.rand(n, 2, 2) * 120, axis=1).reshape(n, 4)
    boxes = boxes[:, [0, 2, 1, 3]].astype(np.float32)
    valid = np.array([True, True, False, True, True, False])
    want = np.asarray(jax_pipe.decode_keypoints(
        cfg, jnp.asarray(logits), jnp.asarray(boxes), jnp.asarray(valid)))
    got = _np(port_pipe.decode_keypoints(_t(logits), _t(boxes), _t(valid)))
    assert got.shape == want.shape == (n, k, 3)
    np.testing.assert_array_equal(got[~valid], 0.0)
    np.testing.assert_allclose(got[..., 2], want[..., 2], rtol=1e-6, atol=0)
    np.testing.assert_allclose(got[..., :2], want[..., :2], rtol=0,
                               atol=2 * float(np.spacing(np.float32(128))))
    assert abs(got[0, 0, 0] - (boxes[0, 0] + 3.5 / 56 * (boxes[0, 2]
                                                        - boxes[0, 0]))) < 1e-4


def _jax_resample_float(raws, windows, sizes, canvas_hw):
    """JAX's resample before its round (ops/image._resize_pad_one's two
    products, jitted as batched_resize_pad is)."""
    ch, cw = canvas_hw

    def one(raw, win, size):
        vmat = jax_image._axis_resize_matrix(ch, raw.shape[0], win[0],
                                             size[0], win[2] - win[0])
        hmat = jax_image._axis_resize_matrix(cw, raw.shape[1], win[1],
                                             size[1], win[3] - win[1])
        hi = jax.lax.Precision.HIGHEST
        tmp = jnp.einsum("yk,kwc->ywc", vmat, raw.astype(jnp.float32),
                         precision=hi)
        return jnp.einsum("xw,ywc->yxc", hmat, tmp, precision=hi)

    return np.asarray(jax.jit(jax.vmap(one))(raws, windows, sizes))


RESIZE_CASES = {
    # (image shapes, min dim, canvas)
    "scale1": ([(100, 80), (128, 96)], 64, (128, 128)),
    "upscale": ([(60, 90), (96, 50), (120, 100)], 128, (256, 256)),
    "rect": ([(60, 120), (70, 64)], 64, (128, 192)),
}


@pytest.mark.parametrize("case", list(RESIZE_CASES))
def test_batched_resize_pad_matches_jax(case):
    """The device resample on the CPU against the JAX package's: bit-equal
    at scale 1 (and equal to the host path's canvas there); otherwise
    equal but where JAX's float value lies within 1e-4 of a .5 tie,
    every such value counted. Windows and scales come from the shared
    geometry."""
    shapes, min_dim, canvas = RESIZE_CASES[case]
    rng = np.random.RandomState(len(shapes) + min_dim)
    images = [rng.randint(0, 256, s + (3,), dtype=np.uint8) for s in shapes]
    raws, sizes = port_image.bucket_raws(images)
    geoms = [Detector._canvas_geometry(h, w, min_dim, *canvas)
             for h, w in shapes]
    windows = np.asarray([g[0] for g in geoms], np.int32)
    want = np.asarray(jax_image.batched_resize_pad(raws, windows, sizes,
                                                   canvas))
    got = _np(port_image.batched_resize_pad(_t(raws), _t(windows), _t(sizes),
                                            canvas))
    assert got.dtype == np.uint8 and got.shape == want.shape
    apart = got != want
    if case == "scale1":
        assert all(g[1] == 1.0 for g in geoms)
        np.testing.assert_array_equal(got, want)
        for img, canvas_img in zip(images, got):
            host = resize_image(img, min_dim, max(canvas),
                                canvas_shape=canvas)[0]
            np.testing.assert_array_equal(canvas_img, host)
        return
    exact = _jax_resample_float(raws, windows, sizes, canvas)
    tie = np.abs(exact - np.floor(exact) - 0.5)
    print(f"resample {case}: {int(apart.sum())} of {got.size} values apart")
    assert (tie[apart] < 1e-4).all(), exact[apart]
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_device_resize_routing():
    """Detector._preprocess under DEVICE_RESIZE: a batch of scale-1 and
    upscaled images takes the device route (equal to batched_resize_pad,
    and at scale 1 to the host canvas); a batch holding an image to
    downscale takes the host route whole, as the JAX Detector routes it
    (the rule of Config.DEVICE_RESIZE), equal to the JAX Detector's
    canvas."""
    cfg = PCFG.replace(DEVICE_RESIZE=True)
    det = Detector(cfg, "cpu")
    host = Detector(PCFG, "cpu")
    rng = np.random.RandomState(15)
    fit = [rng.randint(0, 256, (128, 100, 3), np.uint8),
           rng.randint(0, 256, (60, 90, 3), np.uint8)]
    batch, windows, scales = det._preprocess(fit)
    assert scales[0] == 1.0 and scales[1] > 1.0
    raws, sizes = port_image.bucket_raws(fit)
    want = port_image.batched_resize_pad(_t(raws), _t(np.int32(windows)),
                                         _t(sizes), cfg.IMAGE_SHAPE[:2])
    assert torch.equal(batch, want)
    assert torch.equal(batch[0], host._preprocess(fit[:1])[0][0])
    big = fit + [rng.randint(0, 256, (200, 260, 3), np.uint8)]
    batch, windows, scales = det._preprocess(big)
    assert scales[2] < 1.0
    jdet = JaxDetector.__new__(JaxDetector)
    jdet.config, jdet._mesh = CFG.replace(DEVICE_RESIZE=True), None
    jbatch, jwindows, jscales = jdet._preprocess(big)
    np.testing.assert_array_equal(_np(batch), np.asarray(jbatch))
    assert windows == jwindows and scales == jscales
    assert torch.equal(batch, host._preprocess(big)[0])


RECT = CFG.replace(IMAGE_CANVAS=(128, 192))


def test_rect_canvas_shapes_and_anchors():
    """The port's config and anchors on a rectangular canvas: the JAX
    package's IMAGE_SHAPE, BACKBONE_SHAPES and anchors, bit for bit; a
    side not divisible by 64 raises."""
    prect = port_config(RECT)
    assert prect.IMAGE_SHAPE == RECT.IMAGE_SHAPE == (128, 192, 3)
    assert prect.BACKBONE_SHAPES == RECT.BACKBONE_SHAPES
    np.testing.assert_array_equal(port_anchors.config_anchors(prect),
                                  config_anchors(RECT))
    with pytest.raises(ValueError, match="64"):
        _ = port_config(CFG.replace(IMAGE_CANVAS=(100, 192))).IMAGE_SHAPE


def test_rect_detector_preprocess_matches_jax():
    """Canvas placement on 128x192 for a wide, a tall and a scale-1
    image: the same canvases, windows and scales as the JAX Detector's
    host path."""
    rng = np.random.RandomState(16)
    images = [rng.randint(0, 256, s, np.uint8)
              for s in ((60, 120, 3), (150, 90, 3), (128, 150, 3))]
    det = Detector(port_config(RECT), "cpu")
    jdet = JaxDetector.__new__(JaxDetector)
    jdet.config, jdet._mesh = RECT, None
    batch, windows, scales = det._preprocess(images)
    jbatch, jwindows, jscales = jdet._preprocess(images)
    assert tuple(batch.shape) == (3, 128, 192, 3)
    np.testing.assert_array_equal(_np(batch), np.asarray(jbatch))
    assert windows == jwindows and scales == jscales


def test_upscale_close_to_host_resample():
    """The device resample against the port's host resample (Pillow's
    filter) on an upscale, as tests/test_device_resize.py holds the JAX
    package's: at most 3 apart, under 0.5 on average, the padding zero on
    both."""
    rng = np.random.RandomState(18)
    images = [rng.randint(0, 256, (60, 90, 3), np.uint8),
              rng.randint(0, 256, (96, 50, 3), np.uint8)]
    raws, sizes = port_image.bucket_raws(images)
    geoms = [Detector._canvas_geometry(h, w, 128, 256, 256)
             for h, w in sizes]
    windows = np.asarray([g[0] for g in geoms], np.int32)
    dev = _np(port_image.batched_resize_pad(_t(raws), _t(windows),
                                            _t(sizes), (256, 256)))
    for img, d, (window, scale) in zip(images, dev, geoms):
        canvas, w_ref, s_ref = port_codecs.resize_image(
            img, 128, 256, canvas_shape=(256, 256))
        assert scale == s_ref > 1.0 and tuple(window) == tuple(w_ref)
        diff = np.abs(d.astype(np.int32) - canvas.astype(np.int32))
        assert diff.max() <= 3 and diff.mean() < 0.5, (diff.max(),
                                                       diff.mean())
        top, left, bot, right = window
        pad = d.copy()
        pad[top:bot, left:right] = 0
        assert not pad.any()


def test_masks_to_original_rect_matches_jax():
    """The device mask decode on a 128x192 canvas: the port's and the
    JAX package's masks_to_original agree (the interpolation operators
    are equal; pixels apart only at 127.5 ties, none in this data)."""
    from maskrcnn_tpu.ops.mask_paste import masks_to_original as jax_m2o
    from maskrcnn_tpu_torch.ops.mask_paste import masks_to_original
    rng = np.random.RandomState(19)
    ch, cw, out_dim = 128, 192, 96
    for _ in range(3):
        oh, ow = int(rng.randint(30, 97)), int(rng.randint(40, 97))
        _, window, _ = resize_image(np.zeros((oh, ow, 3), np.uint8), 100,
                                    ch, canvas_shape=(ch, cw))
        masks = np.zeros((4, ch, cw), bool)
        for m in masks:
            y0, x0 = rng.randint(0, ch - 30), rng.randint(0, cw - 30)
            m[y0:y0 + rng.randint(8, 60), x0:x0 + rng.randint(8, 60)] = True
        win = np.asarray(window, np.float32)
        want = np.asarray(jax_m2o(jnp.asarray(masks), jnp.asarray(win),
                                  jnp.asarray(oh), jnp.asarray(ow), out_dim))
        got = _np(masks_to_original(_t(masks), _t(win), torch.tensor(oh),
                                    torch.tensor(ow), out_dim))
        assert got.shape == (4, out_dim, out_dim)
        np.testing.assert_array_equal(got, want)
        assert not got[:, oh:].any() and not got[:, :, ow:].any()


def test_keypoint_results_and_drawing(tmp_path):
    """Keypoints on the product surface: build_coco_results writes them in
    COCO's (x, y, v) order as the JAX package does, and display_instances
    draws them (one dot an instance's keypoint) into the saved figure."""
    from maskrcnn_tpu.eval.evaluate import build_coco_results as jax_results
    from maskrcnn_tpu_torch.eval.evaluate import build_coco_results
    from maskrcnn_tpu_torch.utils.visualize import display_instances

    class Dataset:
        @staticmethod
        def class_id(label_id):
            return label_id

    rng = np.random.RandomState(21)
    boxes = (rng.rand(3, 4) * 40).astype(np.float32)
    masks = (rng.rand(3, 30, 40) > 0.5).astype(np.uint8)
    kps = rng.rand(3, 17, 3) * 30
    args = (Dataset(), 5, [1, 2, 1], rng.rand(3).tolist(), boxes, masks)
    got = build_coco_results(*args, keypoints=kps)
    assert got == jax_results(*args, keypoints=kps)
    assert got[1]["keypoints"][:3] == [kps[1, 0, 1], kps[1, 0, 0], 1]
    assert "keypoints" not in build_coco_results(*args)[0]
    path = tmp_path / "kp.png"
    image = rng.randint(0, 256, (30, 40, 3), np.uint8)
    display_instances(image, boxes, masks, [1, 2, 1], ["bg", "a", "b"],
                      save_path=str(path), keypoints=kps, figsize=(3, 3))
    assert path.stat().st_size > 0
