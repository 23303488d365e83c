"""The port's bfloat16 pipeline against the JAX package's, on the CPU.

TinyConfig with COMPUTE_DTYPE="bfloat16" on the seeded weights and
canvases of test_torch_pipeline.py. Measured here (torch 2.13 CPU, JAX
0.9 CPU):

- predict_step as both packages stand: 16 valid detections, 15 equal in
  (class, box) (share 0.9375), max |delta score| 3.2e-4, mask byte
  mismatch 3.3e-5. With the JAX RoIAlign blending in float32 (monkeypatch
  below): 15 of 16, 3.2e-4, 9.8e-5. The one detection apart is the same
  in both runs: class 9, x1 = 58 in JAX and 59 in the port; mrn_refine
  rounds boxes to whole pixels (the reference's quirk) and this x1 lies
  at a half pixel within the two backbones' bf16 noise: a threshold tie.
- Per stage, each package fed the same inputs (JAX's outputs of the stage
  before, the backbone the same normalized canvases):
  backbone/FPN, P2-P6: port and JAX are equally far from the JAX float32
  maps (mean error 0.13-0.50% of the range for both, max 0.85-3.7% port
  against 0.85-4.2% JAX); they differ from each other by up to 1.75% of
  the range. One bf16 conv agrees to 1 ulp on all but ~0.01% of its
  outputs (float32 sums in another order, rounded on either side of a
  bf16 boundary), and those flips spread through ~100 layers.
  RPN: 0.43% of scores differ, by at most 7.4e-3; 0.13% of deltas.
  Proposals: bit-equal validity, boxes within 6e-8 (exp's last bit, as
  in float32).
  RoIAlign 7x7 and 14x14: the known difference. On the CPU, and at every
  TinyConfig size, the JAX package takes its XLA route, which blends in
  the table dtype (maskrcnn_tpu/ops/roi_align.py:18-20,
  detection/pipeline.py:197-205: the Pallas route needs every level at
  least 32 rows); the port blends in float32 and rounds once, as the
  Pallas kernel does on the TPU's main path. 28% of pooled values differ,
  2.3% by more than an ulp. With JAX blending in float32: at most 1 ulp
  on 6e-6 of them (float32 sums in another order).
  Box head: logits within 1 bf16 ulp of their range (0.0078 at 1.42) on
  0.95%, probabilities within 3.0e-4. mrn_refine: bit-equal. Mask head:
  probabilities within 1.2e-3, 0.03% on the other side of 0.5.
- One fault was found and repaired: a bf16 conv or linear with a bias
  rounded its output once in the port (MKLDNN fuses the bias on the CPU,
  cuBLAS's epilogue on the card), twice in the JAX package (product,
  then bias), so a quarter of such a layer's outputs were an ulp apart.
  The seeded weights have zero biases and do not show it;
  test_bias_added_after_the_product does. models/layers.py adds the bias
  after the product on every device.
Bars are the measured values with room for another CPU's math library,
each stated where it is asserted.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import maskrcnn_tpu.ops.roi_align as jax_roi
from maskrcnn_tpu.detection import pipeline as jax_pipe
from maskrcnn_tpu.models.mask_rcnn import MaskRCNN as JaxMaskRCNN
from maskrcnn_tpu.ops.image import normalize_image
from maskrcnn_tpu_torch.detection import pipeline as port_pipe
from tests.test_torch_pipeline import CFG, _images, _match
from tests.torch_port import jax_params, torch_model

B16 = CFG.replace(COMPUTE_DTYPE="bfloat16")


def _f32(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _t(x) -> torch.Tensor:
    """A JAX array as a tensor of the same dtype."""
    a = jnp.asarray(x)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(np.array(a.astype(jnp.float32))).to(
            torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _bf16_ulp(scale: float) -> float:
    """The bf16 spacing at magnitude `scale`."""
    return 2.0 ** (np.floor(np.log2(scale)) - 7)


def _ulps(got, want) -> np.ndarray:
    got, want = _f32(got), _f32(want)
    big = np.maximum(np.abs(got), np.abs(want))
    exp = np.floor(np.log2(np.where(big > 0, big, 1.0)))
    return np.abs(got - want) / 2.0 ** (exp - 7)


def _blend_in_float32(monkeypatch):
    """The JAX XLA RoIAlign route blends its table's dtype; make it blend
    in float32 and round once, as the port and the Pallas kernel do."""
    orig = jax_roi._crop_core

    def core(table, *args):
        return orig(table.astype(jnp.float32), *args).astype(table.dtype)

    monkeypatch.setattr(jax_roi, "_crop_core", core)


@pytest.fixture(scope="module")
def weights():
    params = jax_params(CFG)
    return params, torch_model(B16, params)


@pytest.fixture(scope="module")
def port_out(weights):
    _, model = weights
    images, windows = _images(np.random.RandomState(7), 2)
    out = port_pipe.predict_step(model, torch.from_numpy(images),
                                 torch.from_numpy(windows))
    return images, windows, {k: v.numpy() for k, v in out.items()}


@pytest.mark.parametrize("blend", ["table", "float32"])
def test_predict_step_bf16_matches_jax(weights, port_out, blend,
                                       monkeypatch):
    """Bars: share >= 0.9 (one tie of 16 measured), |delta score| <= 1e-3
    (3.2e-4: bf16 logits through a softmax), mask bytes <= 1e-3 (3.3e-5
    and 9.8e-5)."""
    params, _ = weights
    images, windows, got = port_out
    if blend == "float32":
        _blend_in_float32(monkeypatch)
    jax.clear_caches()  # no trace of the other blend
    want = jax.device_get(jax_pipe.predict_step(
        JaxMaskRCNN(B16), params, jnp.asarray(images), jnp.asarray(windows)))
    jax.clear_caches()
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype
    total, share, dscore, mism = _match(want, got)
    print(f"bf16 predict_step parity ({blend} blend): {total} valid, "
          f"(class, box) equal {share:.4f}, max |dscore| {dscore:.3g}, "
          f"mask byte mismatch {mism:.3g}")
    assert total > 0
    assert share >= 0.9
    assert dscore <= 1e-3
    assert mism <= 1e-3


@pytest.fixture(scope="module")
def stages(weights):
    """The JAX package's bf16 stage outputs, and the float32 backbone."""
    params, _ = weights
    jm = JaxMaskRCNN(B16)
    images, windows = _images(np.random.RandomState(7), 2)
    x = normalize_image(jnp.asarray(images), B16.MEAN_PIXEL)
    feats = jm.backbone(params, x)
    scores, deltas = jm.rpn_scores(params, feats)
    anchors = jnp.asarray(jm.anchors())
    proposals, pvalid = jax.vmap(lambda s, d: jax_pipe.rpn_refine_scores(
        B16, anchors, s, d))(scores, deltas)
    pooled = jax_pipe._pool_rois(feats, proposals, B16.POOL_SIZE,
                                 B16.IMAGE_SHAPE)
    b, r = proposals.shape[:2]
    head = jm.classify(params, pooled.reshape(b * r, *pooled.shape[2:]))
    det = jax.vmap(lambda p, v, pr, dl, w: jax_pipe.mrn_refine(
        B16, p, v, pr, dl, w))(
            proposals, pvalid, head[1].reshape(b, r, -1),
            head[2].reshape(b, r, B16.NUM_CLASSES, 4), jnp.asarray(windows))
    return dict(x=x, windows=windows, feats=feats,
                feats32=JaxMaskRCNN(CFG).backbone(params, x), scores=scores,
                deltas=deltas, proposals=proposals, pvalid=pvalid,
                pooled=pooled, head=head, det=det,
                mask_rois=det.boxes / jnp.asarray([128.0] * 4))


def test_backbone_bf16_as_close_to_float32_as_jax(weights, stages):
    """Both bf16 backbones against the JAX float32 maps: the port's mean
    error at most 1.05x JAX's and its max 1.25x (measured <= 1.0x in
    every level), so the two differ by bf16 noise only."""
    _, model = weights
    with torch.inference_mode():
        got = model.backbone(_t(stages["x"]))
    for i, (g, w, ref) in enumerate(zip(got, stages["feats"],
                                        stages["feats32"])):
        ref = _f32(ref)
        scale = np.abs(ref).max()
        ep, ej = np.abs(_f32(g) - ref), np.abs(_f32(w) - ref)
        print(f"P{i + 2}: port mean {ep.mean() / scale:.3g} max "
              f"{ep.max() / scale:.3g}, JAX mean {ej.mean() / scale:.3g} max "
              f"{ej.max() / scale:.3g}")
        assert ep.mean() <= 1.05 * ej.mean(), f"P{i + 2}"
        assert ep.max() <= 1.25 * ej.max(), f"P{i + 2}"


def test_rpn_and_proposals_bf16_match_jax(weights, stages):
    """Same maps: scores within 2e-2 on at most 2% (7.4e-3 on 0.43%
    measured), deltas apart on at most 1% (0.13%). Same scores and
    deltas: proposal validity equal, boxes within 1e-6 (the float32
    test's bar)."""
    _, model = weights
    with torch.inference_mode():
        scores, deltas = model.rpn_scores([_t(f) for f in stages["feats"]])
    ds = np.abs(_f32(scores) - _f32(stages["scores"]))
    assert ds.max() <= 2e-2 and (ds > 0).mean() <= 0.02
    assert deltas.dtype == torch.bfloat16
    assert (_f32(deltas) != _f32(stages["deltas"])).mean() <= 0.01
    props, valid = port_pipe.rpn_refine_scores(
        model.config, model.anchors(), _t(stages["scores"]),
        _t(stages["deltas"]))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(stages["pvalid"]))
    np.testing.assert_allclose(props.numpy(), _f32(stages["proposals"]),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("pool", [7, 14])
@pytest.mark.parametrize("blend", ["table", "float32"])
def test_roi_align_bf16_blend(weights, stages, pool, blend, monkeypatch):
    """The known difference. JAX blending in float32: at most 1 bf16 ulp,
    on at most 1e-4 of the values (6e-6 measured: float32 sums in another
    order). As the packages stand: within 2% of the pooled range, more
    than an ulp on at most 5% (2.3% measured)."""
    boxes = stages["proposals"] if pool == 7 else stages["mask_rois"]
    if blend == "float32":
        _blend_in_float32(monkeypatch)
    want = jax_pipe._pool_rois(stages["feats"], boxes, pool, B16.IMAGE_SHAPE)
    got = port_pipe._pool_rois([_t(f) for f in stages["feats"]], _t(boxes),
                               pool, B16.IMAGE_SHAPE)
    assert got.dtype == torch.bfloat16
    ulps = _ulps(got, want)
    if blend == "float32":
        assert ulps.max() <= 1.0 and (ulps > 0).mean() <= 1e-4
    else:
        err = np.abs(_f32(got) - _f32(want)).max()
        assert err <= 0.02 * np.abs(_f32(want)).max()
        assert (ulps > 1).mean() <= 0.05


def test_heads_and_refine_bf16_match_jax(weights, stages):
    """Same pooled features. Box head: logits and deltas within 2 bf16
    ulps of their range, on at most 3% (1 ulp on 0.95% measured);
    probabilities within 1e-3 (3.0e-4). mrn_refine on the same inputs:
    bit-equal. Mask head: within 5e-3 (1.2e-3), at most 1e-3 of the
    probabilities on the other side of 0.5 (3.3e-4)."""
    params, model = weights
    pooled = stages["pooled"]
    b, r = stages["proposals"].shape[:2]
    with torch.inference_mode():
        head = model.classify(_t(pooled).reshape(b * r, *pooled.shape[2:]))
    for name, g, w in zip(("logits", "probs", "deltas"), head,
                          stages["head"]):
        g, w = _f32(g), _f32(w)
        d = np.abs(g - w)
        if name == "probs":
            assert d.max() <= 1e-3, name
        else:
            assert d.max() <= 2 * _bf16_ulp(np.abs(w).max()), name
            assert (d > 0).mean() <= 0.03, name
    head = stages["head"]
    got = port_pipe.mrn_refine(
        model.config, _t(stages["proposals"]), _t(stages["pvalid"]),
        _t(head[1]).reshape(b, r, -1),
        _t(head[2]).reshape(b, r, B16.NUM_CLASSES, 4),
        torch.from_numpy(stages["windows"]))
    for g, w in zip(got, stages["det"]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    pm = jax_pipe._pool_rois(stages["feats"], stages["mask_rois"],
                             B16.MASK_POOL_SIZE, B16.IMAGE_SHAPE)
    want = _f32(JaxMaskRCNN(B16).predict_masks(params,
                                               pm.reshape(-1, 14, 14, 256)))
    with torch.inference_mode():
        got = _f32(model.predict_masks(_t(pm).reshape(-1, 14, 14, 256)))
    assert np.abs(got - want).max() <= 5e-3
    assert ((got > 0.5) != (want > 0.5)).mean() <= 1e-3


@pytest.mark.parametrize("layer", ["conv3x3", "conv7_valid", "linear",
                                   "deconv"])
def test_bias_added_after_the_product(layer):
    """A bf16 layer with a nonzero bias against flax's: the port's layers
    (models/layers.py) add the bias after the product, as flax does, and
    agree to 1 ulp on all but 0.1% of the outputs (float32 sums in
    another order; 0 apart measured). torch's own layer is printed beside
    them, not held: whether it fuses the bias and rounds once depends on
    torch's backend (22-31% apart where it fuses, as MKLDNN did)."""
    import flax.linen as fnn
    import torch.nn as tnn
    from maskrcnn_tpu.models.common import Conv, DeconvK2S2, Dense
    from maskrcnn_tpu_torch.models import layers
    rng = np.random.RandomState(11)
    bf = jnp.bfloat16
    if layer == "linear":
        x = rng.randn(64, 512).astype(np.float32)
        mod = Dense(96, dtype=bf)
    elif layer == "deconv":
        x = rng.randn(4, 6, 6, 64).astype(np.float32)
        mod = DeconvK2S2(32, dtype=bf)
    else:
        x = rng.randn(4, 9, 9, 64).astype(np.float32)
        mod = (Conv(96, (3, 3), padding=((1, 1), (1, 1)), dtype=bf)
               if layer == "conv3x3" else Conv(96, (7, 7), padding="VALID",
                                                dtype=bf))
    xj = jnp.asarray(x).astype(bf)
    p = mod.init(jax.random.PRNGKey(0), xj)["params"]
    p = {"kernel": p["kernel"],
         "bias": jnp.asarray(rng.randn(*p["bias"].shape) * 0.5, jnp.float32)}
    want = _f32(mod.apply({"params": p}, xj))
    k = torch.from_numpy(np.array(p["kernel"])).to(torch.bfloat16)
    bias = torch.from_numpy(np.array(p["bias"])).to(torch.bfloat16)
    xt = _t(xj)
    if layer == "linear":
        ours, theirs = layers.Linear(512, 96), tnn.Linear(512, 96)
        weight, to_nhwc, xin = k.T, (lambda y: y), xt
    elif layer == "deconv":
        ours = layers.ConvTranspose2d(64, 32, 2, stride=2)
        theirs = tnn.ConvTranspose2d(64, 32, 2, stride=2)
        # flax [2, 2, O, I] -> torch [I, O, 2, 2]
        weight = k.permute(3, 2, 0, 1)
        to_nhwc, xin = (lambda y: y.permute(0, 2, 3, 1)), xt.permute(0, 3, 1, 2)
    else:
        side = 3 if layer == "conv3x3" else 7
        pad = 1 if layer == "conv3x3" else 0
        ours = layers.Conv2d(64, 96, side, padding=pad)
        theirs = tnn.Conv2d(64, 96, side, padding=pad)
        weight = k.permute(3, 2, 0, 1)
        to_nhwc, xin = (lambda y: y.permute(0, 2, 3, 1)), xt.permute(0, 3, 1, 2)
    shares = []
    for m in (ours, theirs):
        m.to(torch.bfloat16)
        with torch.no_grad():
            m.weight.copy_(weight)
            m.bias.copy_(bias)
            got = _f32(to_nhwc(m(xin)))
        assert got.shape == want.shape
        ulps = _ulps(got, want)
        shares.append(((ulps > 0).mean(), ulps.max()))
    print(f"{layer}: bias after the product {shares[0]}, torch's layer "
          f"{shares[1]}")
    assert shares[0][0] <= 1e-3 and shares[0][1] <= 1.0
