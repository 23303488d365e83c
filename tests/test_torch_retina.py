"""The port's RetinaNet (maskrcnn_tpu_torch/models/retina_fpn.py and its
int8 twin in quant.py) against the JAX package's, at TinyConfig (128²,
81 classes) in float32, on one JAX init loaded through
`checkpoint.convert.from_jax_retina_params`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maskrcnn_tpu import quant as jq
from maskrcnn_tpu.config import TinyConfig
from maskrcnn_tpu.models.retina_fpn import RetinaNet as JaxRetinaNet
from maskrcnn_tpu_torch import quant as pq
from maskrcnn_tpu_torch.checkpoint.convert import from_jax_quant_params
from maskrcnn_tpu_torch.models import retina_fpn as pr
from tests.test_targets import make_gt
from tests.torch_port import port_config

CFG = TinyConfig(DETECTION_MIN_CONFIDENCE=0.0)


def _seeded_params(jnet, seed=3):
    """A tree of `RetinaNet.init`'s structure (traced abstractly, no
    forward run) filled from numpy: xavier-uniform kernels, zero biases
    but cls_out's prior, BN statistics away from the identity so the fold
    does work."""
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0))
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name = str(path[-1].key)
        shape = leaf.shape
        if name == "kernel":
            fan = np.prod(shape[:2]) * (shape[2] + shape[3])
            lim = np.sqrt(6.0 / fan)
            return rng.uniform(-lim, lim, shape).astype(np.float32)
        if name == "bias":
            prior = str(path[-2].key) == "cls_out"
            return np.full(shape, -4.595 if prior else 0.0, np.float32)
        if name == "running_mean":
            return rng.uniform(-0.1, 0.1, shape).astype(np.float32)
        if name == "running_var":
            return rng.uniform(1.0, 1.6, shape).astype(np.float32)
        if name == "weight":
            return rng.uniform(0.8, 1.2, shape).astype(np.float32)
        return np.zeros(shape, np.float32)
    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def setup():
    jnet = JaxRetinaNet(CFG)
    params = _seeded_params(jnet)
    net = pr.RetinaNet(port_config(CFG), "cpu")
    net.load_jax_params(params)
    rng = np.random.RandomState(5)
    raw = rng.randint(0, 256, (2, 128, 128, 3)).astype(np.uint8)
    images = ((raw.astype(np.float32) - np.float32(CFG.MEAN_PIXEL))
              .astype(np.float32))
    logits, deltas = jax.jit(jnet.forward)(params, jnp.asarray(images))
    return jnet, params, net, raw, images, np.asarray(logits), \
        np.asarray(deltas)


def test_pyramid_shapes():
    """P3..P7 at strides 8..128 (reference fpn/retina_fpn.py:130-137)."""
    fpn = pr.RetinaFPN(device="cpu")
    feats = fpn(torch.zeros(1, 3, 128, 128))
    assert [tuple(f.shape) for f in feats] == [
        (1, 256, 16, 16), (1, 256, 8, 8), (1, 256, 4, 4), (1, 256, 2, 2),
        (1, 256, 1, 1)]


@pytest.mark.parametrize("src,dst", [((4, 4), (8, 8)), ((3, 5), (5, 9)),
                                     ((7, 6), (13, 12)), ((6, 6), (3, 4))])
def test_bilinear_resize_matches_jax_image(src, dst):
    """jax.image.resize "bilinear" (edge taps renormalised, not clamped
    as F.interpolate's) on exact-2x, odd and downscaled sizes. Bar 1e-6 of
    the range: the two products may sum in another order than XLA's
    einsum (measured: equal or an ulp apart)."""
    x = np.random.RandomState(1).randn(2, *src, 5).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, *dst, 5),
                                       "bilinear"))
    got = pr.bilinear_resize(torch.from_numpy(x).permute(0, 3, 1, 2),
                             *dst).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


def test_forward_matches_jax(setup):
    """Logits and deltas within 1e-4 of their range (float32 convs sum in
    another order than XLA's)."""
    _, _, net, _, images, logits, deltas = setup
    with torch.no_grad():
        got = net(torch.from_numpy(images))
    for g, w in zip(got, (logits, deltas)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-4 * (w.max() - w.min()))


def test_anchors_equal(setup):
    jnet, _, net, *_ = setup
    np.testing.assert_array_equal(net.anchors().numpy(), jnet.anchors())


def _jax_detect(logits, deltas):
    """The JAX detect's decode on given logits and deltas (its forward
    replaced on a fresh instance)."""
    jnet = JaxRetinaNet(CFG)
    jnet.forward = lambda p, im: (jnp.asarray(logits), jnp.asarray(deltas))
    out = jnet.detect({}, jnp.zeros((logits.shape[0], 1)))
    return {k: np.asarray(v) for k, v in out.items()}


def test_detect_decode_equals_jax(setup):
    """On the same logits and deltas: class ids, boxes and valid exact,
    |dscore| <= 1e-5 (K2's plain version on the CPU, N = 2 x
    PRE_NMS_LIMIT class-offset boxes)."""
    _, _, net, _, _, logits, deltas = setup
    want = _jax_detect(logits, deltas)
    net.forward = lambda images: (torch.from_numpy(logits),
                                  torch.from_numpy(deltas))
    try:
        got = {k: v.numpy() for k, v in net.detect(None).items()}
    finally:
        del net.forward
    assert want["valid"].any()
    for k in ("valid", "class_ids", "boxes"):
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=0,
                               atol=1e-5)


def test_detect_end_to_end(setup):
    """From the images: the port's detect against JAX's jitted detect.
    Class ids and valid equal; boxes within 1e-3 px and scores within
    1e-5 (the forward's float32 error, test_forward_matches_jax)."""
    jnet, params, net, _, images, _, _ = setup
    want = {k: np.asarray(v) for k, v in
            jnet.detect(params, jnp.asarray(images)).items()}
    got = {k: v.numpy() for k, v in
           net.detect(torch.from_numpy(images)).items()}
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_array_equal(got["class_ids"], want["class_ids"])
    np.testing.assert_allclose(got["boxes"], want["boxes"], rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=0,
                               atol=1e-5)


def _gt(n_images=2):
    rng = np.random.RandomState(9)
    rows = [make_gt(CFG, rng, 3) for _ in range(n_images)]
    return [np.stack(c) for c in zip(*rows)]


def _port_losses(params, images, cls, boxes, valid, dtype="float32"):
    net = pr.RetinaNet(port_config(CFG.replace(COMPUTE_DTYPE=dtype)), "cpu",
                       train=True)
    net.load_jax_params(params)
    tdt = getattr(torch, dtype)
    net.to(tdt)
    total, parts = net.losses(torch.from_numpy(images).to(tdt),
                              torch.from_numpy(cls), torch.from_numpy(boxes),
                              torch.from_numpy(valid))
    return net, total, parts


# weights whose gradients are held against jax.grad (the class and box
# logit convs, the box tower's last conv, P4's smoothing conv)
JAX_HELD = {"head.cls_out.weight": ("head", "cls_out"),
            "head.box_out.weight": ("head", "box_out"),
            "head.box3.weight": ("head", "box3"),
            "fpn.smooth1.weight": ("fpn", "smooth1")}


@pytest.fixture(scope="module")
def focal(setup):
    """Both packages' focal loss and gradients on one batch of gt."""
    jnet, params, _, _, images, _, _ = setup
    cls, boxes, valid = _gt()

    def loss(p, x, c, b, v):
        return jnet.losses(p, jax.random.PRNGKey(0), x, c, b, v)

    want = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params, jnp.asarray(images), jnp.asarray(cls), jnp.asarray(boxes),
        jnp.asarray(valid))
    net, total, parts = _port_losses(params, images, cls, boxes, valid)
    grads = dict(zip([n for n, p in net.named_parameters()],
                     torch.autograd.grad(total, list(net.parameters()))))
    return want, (total.detach(), parts, grads), (params, images, cls,
                                                  boxes, valid)


def test_focal_loss_matches_jax(focal):
    """The focal + smooth-L1 loss and its two parts within 1e-5 relative.
    No subsample binds (RPN_TRAIN_ANCHORS_PER_IMAGE = A), so no random
    draw enters."""
    (want, parts), _ = focal[0]
    total, got_parts, _ = focal[1]
    np.testing.assert_allclose(float(total), float(want), rtol=1e-5)
    for k in ("cls", "box"):
        np.testing.assert_allclose(float(got_parts[k]), float(parts[k]),
                                   rtol=1e-5)


@pytest.mark.parametrize("name", list(JAX_HELD))
def test_focal_gradients_match_jax(focal, name):
    """Gradients against jax.grad within 1e-5 of their largest value."""
    _, grads = focal[0]
    w = grads
    for k in JAX_HELD[name]:
        w = w[k]
    w = np.asarray(w["kernel"]).transpose(3, 2, 0, 1)
    g = focal[1][2][name].numpy()
    np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * np.abs(w).max())


def test_focal_gradients_match_float64(focal):
    """Every gradient of the float32 port within 1e-5 of its largest value
    of the port's own float64 run. The class tower's and P3's gradients
    are held here, not against jax.grad: measured, XLA:CPU's jitted
    gradient of the class tower (cls0-3) and of everything below P3 is
    up to 1e-3 relative off the float64 run, where the port's float32 is
    within 1e-6 (the box tower and P4's smoothing conv agree with both).
    The stem conv is left out: its max pool routes a gradient to one of
    two near-equal inputs, and float32 and float64 pick differently."""
    params, images, cls, boxes, valid = focal[2]
    net, total, _ = _port_losses(params, images, cls, boxes, valid,
                                 "float64")
    want = torch.autograd.grad(total, list(net.parameters()))
    got = focal[1][2]
    for (name, _), w in zip(net.named_parameters(), want):
        if name == "fpn.conv1.weight":
            continue
        w = w.numpy()
        np.testing.assert_allclose(got[name].double().numpy(), w, rtol=0,
                                   atol=1e-5 * max(np.abs(w).max(), 1e-12),
                                   err_msg=name)


@pytest.fixture(scope="module")
def int8(setup):
    """One set of amax stats (the port's calibration on two canvases),
    both packages' quantized trees from it, and the port net int8."""
    jnet, params, net, *_ = setup
    canvases = pq.default_calib_canvases(CFG.IMAGE_SHAPE, n=2)
    qcfg = port_config(CFG.replace(QUANT_INT8=True))
    qnet = pr.RetinaNet(qcfg, "cpu")
    qnet.load_float_state(net.float_state)
    folded = pq._fold_retina_state(net.float_state, qnet.fpn.num_blocks)
    stats = pq.calibrate_retina(qnet, folded, canvases)
    jtree = jq.prepare_retina_quant_params(jnet, params, act_stats=stats)
    ptree = pq.prepare_retina_quant_params(qnet, qnet.float_state,
                                           act_stats=stats)
    qnet.set_quant(ptree)
    return jtree, ptree, qnet


def test_retina_quant_tree_equals_jax(int8):
    """Folded and quantized kernels, their scales, biases and the act
    scales bit-equal to the JAX tree (converted to the port's layouts)."""
    jtree, ptree, _ = int8
    want = from_jax_quant_params(jtree)
    assert sorted(ptree["convs"]) == sorted(want["convs"])
    assert sorted(ptree["acts"]) == sorted(want["acts"])
    for p, e in want["convs"].items():
        for k in ("kernel", "kscale", "bias"):
            np.testing.assert_array_equal(ptree["convs"][p][k], e[k])
    for k, v in want["acts"].items():
        assert np.float32(ptree["acts"][k]) == v, k
    for k in ("weight", "bias"):
        np.testing.assert_array_equal(ptree["stem"][k], want["stem"][k])


def test_retina_quant_forward_matches_jax(setup, int8):
    """The int8 twin against JAX's retina_quant_forward run op by op:
    P5, P6 and P7 (int8 convs all the way, their int32 accumulators and
    epilogues) bit-equal; P3 and P4 pass the float top-down resize, which
    may round an ulp apart and move an activation across a quantization
    boundary downstream (bar 1% of the range); logits and deltas through
    the float cls_out/box_out convs within 1e-3 of their range."""
    jnet, _, _, _, images, _, _ = setup
    jtree, _, qnet = int8
    images = images[:1]
    x = jnp.asarray(images)
    with jax.disable_jit():
        # retina_quant_forward's two calls, its features kept
        ctx = jq._Ctx(mode="int8", dtype=jnp.float32, tree=jtree["quant"])
        jfeats = jq.retina_fpn_forward(CFG, ctx, x, jnet.fpn.num_blocks)
        jlog, jdel = jq.retina_head_forward(CFG, ctx, jtree["head"], jfeats)
    with torch.no_grad():
        ctx = pq._Ctx(mode="int8", dtype=torch.float32, tree=qnet.quant)
        feats = pq.retina_fpn_forward(ctx, torch.from_numpy(images),
                                      qnet.fpn.num_blocks)
        log, dl = qnet(torch.from_numpy(images))
    for lvl, (g, w) in enumerate(zip(feats, jfeats)):
        w = np.asarray(w)
        if lvl >= 2:
            np.testing.assert_array_equal(g.numpy(), w)
        else:
            assert np.abs(g.numpy() - w).max() <= 0.01 * np.abs(w).max()
    for g, w in ((log, jlog), (dl, jdel)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-3 * (w.max() - w.min()))


def test_unprepared_int8_retina_raises(setup):
    qnet = pr.RetinaNet(port_config(CFG.replace(QUANT_INT8=True)), "cpu")
    with pytest.raises(RuntimeError, match="set_quant"):
        qnet(torch.zeros(1, 128, 128, 3))
