"""The port's int8 quantization (maskrcnn_tpu_torch/quant.py and
ops/int8_conv.py) against the JAX package's quant.py.

Host numerics (quantization of tensors and kernels, the clip search, the
calibration canvases, the prepared tree) are bit-equal. The int8 stages
run both packages on one quantized tree. JAX runs them op by op
(`jax.disable_jit()`), as its code writes them: under jit, XLA's CPU
backend contracts the epilogue's multiply and add into one fused
multiply-add (an ulp apart in about a quarter of the outputs), which the
port's CUDA path, and its plain version, do not do.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maskrcnn_tpu import quant as jq
from maskrcnn_tpu.models.mask_rcnn import MaskRCNN as JaxMaskRCNN
from maskrcnn_tpu.ops.image import normalize_image as jax_normalize
from maskrcnn_tpu_torch import quant as pq
from maskrcnn_tpu_torch.checkpoint.convert import (from_jax_params,
                                                   from_jax_quant_params)
from maskrcnn_tpu_torch.ops import int8_conv as ic
from maskrcnn_tpu_torch.ops.image import normalize_image
from tests.test_torch_pipeline import CFG
from tests.torch_port import jax_params, port_config, torch_model

QCFG = CFG.replace(QUANT_INT8=True, QUANT_CALIB="amax")
SKIPS = [(), ("C4", "C5"), ("RPN",), ("MASK",)]


@pytest.fixture(scope="module")
def setup():
    """Weights, calibration canvases and one set of amax stats (the port's
    calibration), shared by both packages."""
    params = jax_params(QCFG)
    model = torch_model(QCFG, params)
    images = pq.default_calib_canvases(QCFG.IMAGE_SHAPE, n=2)
    stats = pq.calibrate(model, model.float_state, images)
    return params, images, stats


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_tensor_bit_equal(dtype):
    """Random values, exact .5 ties (a power-of-two scale makes x / s
    exact) and saturation, f32 and bf16 inputs."""
    rng = np.random.RandomState(0)
    ties = (np.arange(-300, 300) + 0.5).astype(np.float32) * 0.25
    x = np.concatenate([rng.randn(20000).astype(np.float32) * 3, ties,
                        np.float32([1e4, -1e4, 0.0])])
    for scale in (np.float32(0.25), np.float32(0.0371)):
        xj = jnp.asarray(x).astype(dtype)
        want = np.asarray(jq.quantize_tensor(xj, jnp.float32(scale)))
        got = ic.quantize_tensor(
            torch.from_numpy(x).to(getattr(torch, dtype)),
            torch.tensor(scale)).numpy()
        assert got.dtype == np.int8
        np.testing.assert_array_equal(got, want)
    assert {-127, 127} <= set(got.tolist())


def test_quantize_kernel_equal():
    rng = np.random.RandomState(1)
    weight = rng.randn(24, 16, 3, 3).astype(np.float32)
    weight[5] = 0.0                       # the 1e-8 floor of an empty channel
    bias = rng.randn(24).astype(np.float32)
    want = jq._quantize_kernel({"kernel": weight.transpose(2, 3, 1, 0),
                                "bias": bias})
    got = pq._quantize_kernel(weight, bias)
    np.testing.assert_array_equal(got["kernel"],
                                  np.asarray(want["kernel"]).transpose(
                                      3, 0, 1, 2))
    np.testing.assert_array_equal(got["kscale"], np.asarray(want["kscale"]))
    np.testing.assert_array_equal(got["bias"], np.asarray(want["bias"]))


@pytest.mark.parametrize("method", ["mse", "percentile"])
def test_search_clip_equal(method):
    """Over 65,536 values, so the mse search subsamples."""
    rng = np.random.RandomState(2)
    sample = np.abs(rng.standard_t(3, 100000)).astype(np.float32)
    amax = float(sample.max())
    assert pq._search_clip(amax, sample, method, 99.9) == \
        jq._search_clip(amax, sample, method, 99.9)
    with pytest.raises(ValueError, match="QUANT_CALIB"):
        pq._search_clip(amax, sample, "max", 99.9)


def test_canvases_and_stats_key_equal(setup):
    params = setup[0]
    for shape, n in (((128, 128), 2), ((64, 96), 3)):
        np.testing.assert_array_equal(pq.default_calib_canvases(shape, n),
                                      jq.default_calib_canvases(shape, n))
    assert pq.params_fingerprint(from_jax_params(params, QCFG.BACKBONE)) == \
        jq.params_fingerprint(params)
    # the port's own config keys the stats file as the JAX Detector does
    # (maskrcnn_tpu/api.py:143-146)
    state = from_jax_params(params, QCFG.BACKBONE)
    for cfg in (QCFG, QCFG.replace(QUANT_CALIB="percentile",
                                   QUANT_PERCENTILE=99.5)):
        want = (jq.params_fingerprint(params) + f"|{cfg.QUANT_CALIB}"
                + (f":{cfg.QUANT_PERCENTILE}"
                   if cfg.QUANT_CALIB == "percentile" else ""))
        assert pq.stats_key(port_config(cfg), state) == want


@pytest.mark.parametrize("skip", SKIPS, ids=lambda s: "-".join(s) or "none")
def test_prepare_quant_params_equal(setup, skip):
    """The same float32 weights and stats give JAX's tree exactly: int8
    kernels, kscale, biases, acts, float entries."""
    params, _, stats = setup
    cfg = QCFG.replace(QUANT_SKIP=skip)
    want = from_jax_quant_params(jq.prepare_quant_params(
        JaxMaskRCNN(cfg), params, act_stats=stats))
    got = pq.prepare_quant_params(torch_model(cfg, params),
                                  from_jax_params(params, cfg.BACKBONE),
                                  act_stats=stats)
    assert set(got) == set(want)
    for part in ("convs", "convs_fp", "mask_head_fp"):
        assert set(got.get(part, {})) == set(want.get(part, {})), part
        for path, entry in want.get(part, {}).items():
            for k, v in entry.items():
                assert got[part][path][k].dtype == v.dtype, (path, k)
                np.testing.assert_array_equal(got[part][path][k], v,
                                              err_msg=f"{path} {k}")
    assert got["acts"] == want["acts"]
    for k in ("weight", "bias"):
        np.testing.assert_array_equal(got["stem"][k], want["stem"][k])


@pytest.mark.parametrize("shape", [(1, 1, 1), (1, 1, 2), (3, 3, 1)],
                         ids=["1x1", "1x1_stride2", "3x3"])
def test_int8_conv_plain_matches_lax(shape):
    """Exact int32 accumulators, full int8 range, odd sizes."""
    k, _, stride = shape
    rng = np.random.RandomState(k + stride)
    x = rng.randint(-127, 128, (2, 9, 7, 64)).astype(np.int8)
    w = rng.randint(-127, 128, (k, k, 64, 40)).astype(np.int8)
    x[0, 0, 0] = 127
    w[..., 0] = 127                       # saturated products summed
    pad = (k - 1) // 2
    want = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (stride, stride),
        ((pad, pad), (pad, pad)), dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32))
    got = ic.int8_conv(torch.from_numpy(x),
                       torch.from_numpy(np.ascontiguousarray(
                           w.transpose(3, 0, 1, 2))), stride, pad).numpy()
    assert got.dtype == np.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_int8_conv_dispatch():
    with pytest.raises(TypeError, match="int8"):
        ic.int8_conv(torch.zeros(1, 2, 2, 8), torch.zeros(8, 1, 1, 8,
                                                          dtype=torch.int8))
    with pytest.raises(ValueError, match="no implementation"):
        ic.int8_conv(torch.zeros(1, 2, 2, 8, dtype=torch.int8,
                                 device="meta"),
                     torch.zeros(8, 1, 1, 8, dtype=torch.int8,
                                 device="meta"))


def test_epilogue_order_bit_equal():
    """One int8 conv with its epilogue through both packages' `_Ctx.conv`:
    bit-equal to JAX op by op. The test can see the order: computing
    (y32 * sx) * sw instead gives other bits."""
    rng = np.random.RandomState(3)
    x = (rng.randn(2, 6, 6, 32) * 2).astype(np.float32)
    w = rng.randn(3, 3, 32, 24).astype(np.float32)
    entry = jq._quantize_kernel({"kernel": w,
                                 "bias": rng.randn(24).astype(np.float32)})
    sx = np.float32(0.0537)
    tree = {"convs": {"c": entry}, "acts": {"a": jnp.float32(sx)}}
    with jax.disable_jit():
        ctx = jq._Ctx(mode="int8", dtype=jnp.float32, tree=tree)
        want = np.asarray(ctx.conv("c", ctx.qt("a", jnp.asarray(x)),
                                   padding=((1, 1), (1, 1)), relu=True))
    port = pq.to_device(from_jax_quant_params(
        {"convs": tree["convs"], "convs_fp": {}, "acts": {"a": sx},
         "stem": {"kernel": w, "bias": w[0, 0, 0]}}), torch.float32, "cpu")
    ctx = pq._Ctx(mode="int8", dtype=torch.float32, tree=port)
    xq = ctx.qt("a", torch.from_numpy(x))
    got = ctx.conv("c", xq, padding=1, relu=True).numpy()
    np.testing.assert_array_equal(got, want)
    e = port["convs"]["c"]
    y32 = ic.int8_conv(xq.q, e["kernel"], 1, 1).to(torch.float32)
    other = torch.relu(y32 * xq.scale * e["kscale"] + e["bias"]).numpy()
    assert (other != want).any()


def _stages(cfg, params, quant_tree, images, pooled):
    """P2..P6, RPN scores and deltas and the mask head: the port's and
    JAX's (op by op) on one quantized tree."""
    model = torch_model(cfg, params)
    model.set_quant(from_jax_quant_params(quant_tree))
    with torch.inference_mode():
        feats = model.backbone(normalize_image(torch.from_numpy(images),
                                               cfg.MEAN_PIXEL))
        got = list(feats) + list(model.rpn_scores(feats)) + [
            model.predict_masks(torch.from_numpy(pooled))]
    jm = JaxMaskRCNN(cfg)
    with jax.disable_jit():
        feats = jm.backbone(quant_tree, jax_normalize(jnp.asarray(images),
                                                      cfg.MEAN_PIXEL))
        want = list(feats) + list(jm.rpn_scores(quant_tree, feats)) + [
            jm.predict_masks(quant_tree, jnp.asarray(pooled))]
    return [g.numpy() for g in got], [np.asarray(w) for w in want]


@pytest.mark.parametrize("skip", SKIPS, ids=lambda s: "-".join(s) or "none")
def test_int8_stages_match_jax(setup, skip):
    """Bars, measured: the int8 chain (backbone, neck, mask head) is
    bit-equal. The RPN's float 18-channel 1x1 sums in another order than
    XLA's (|err| 1.1e-5 on deltas, 1.4e-6 on scores; bar 1e-4). A
    float-kept group (C4, C5) sums its float convs in another order too,
    and that moves a few activations across a quantization boundary
    downstream: measured at most 0.5% of each level's range, bar 2%."""
    params, images, stats = setup
    cfg = QCFG.replace(QUANT_SKIP=skip)
    tree = jq.prepare_quant_params(JaxMaskRCNN(cfg), params, act_stats=stats)
    pooled = np.random.RandomState(4).randn(6, 14, 14, 256).astype(
        np.float32)
    got, want = _stages(cfg, params, tree, images, pooled)
    assert [g.shape for g in got] == [w.shape for w in want]
    feats, rpn, masks = slice(0, 5), slice(5, 7), 7
    if skip == ("C4", "C5"):
        for g, w in zip(got[feats], want[feats]):
            assert np.abs(g - w).max() <= 0.02 * max(np.abs(w).max(), 1e-6)
    else:
        for g, w in zip(got[feats], want[feats]):
            np.testing.assert_array_equal(g, w)
        for g, w in zip(got[rpn], want[rpn]):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got[masks], want[masks])


def test_missing_activation_scale_raises(setup):
    """A quantized conv whose input scale is missing never runs float."""
    params, images, stats = setup
    model = torch_model(QCFG, params)
    model.set_quant(pq.prepare_quant_params(
        model, model.float_state,
        act_stats={k: v for k, v in stats.items()
                   if k != "resnet/C3/block1/a1"}))
    x = normalize_image(torch.from_numpy(images), QCFG.MEAN_PIXEL)
    with pytest.raises(KeyError, match="resnet/C3/block1/conv2"):
        model.backbone(x)


def test_unprepared_int8_model_raises(setup):
    model = torch_model(QCFG, setup[0])
    with pytest.raises(RuntimeError, match="set_quant"):
        model.backbone(torch.zeros(1, 128, 128, 3))


@pytest.mark.parametrize("method", ["amax", "mse"])
def test_calibrate_matches_jax(setup, method):
    """amax: within rtol 1e-5 (measured 4.8e-6: the float convs sum in
    another order). mse: the same or an adjacent one of the 32
    candidates (ratio 50^(1/31) apart); measured the same for all 65."""
    params, images, _ = setup
    cfg = QCFG.replace(QUANT_CALIB=method)
    want = jq.calibrate(JaxMaskRCNN(cfg), params, images)
    model = torch_model(cfg, params)
    got = pq.calibrate(model, model.float_state, images)
    assert list(got) == list(want)
    g = np.array([got[k] for k in want])
    w = np.array([want[k] for k in want])
    if method == "amax":
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=0)
    else:
        step = np.log(50.0) / 31
        assert np.all(np.abs(np.log(g / w)) <= 1.01 * step)
