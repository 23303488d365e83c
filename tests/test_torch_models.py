"""The port's models against flax on the same converted weights
(TinyConfig, float32). Tolerances are those of test_full_model_parity:
relative error 2e-3 for the FPN maps (a deep f32 conv stack summed in
another order), rtol 1e-3 / atol 1e-4 for the heads."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maskrcnn_tpu.config import TinyConfig
from maskrcnn_tpu.models.mask_rcnn import MaskRCNN as JaxMaskRCNN
from tests.torch_port import jax_params, port_config, torch_model


@pytest.fixture(scope="module")
def pair():
    cfg = TinyConfig()
    params = jax_params(cfg)
    return cfg, JaxMaskRCNN(cfg), params, torch_model(cfg, params)


def test_backbone_fpn_parity(pair):
    cfg, jmodel, params, tmodel = pair
    rng = np.random.RandomState(0)
    x = (rng.randn(2, cfg.IMAGE_MAX_DIM, cfg.IMAGE_MAX_DIM, 3) * 30).astype(
        np.float32)
    want = jmodel.backbone(params, jnp.asarray(x))
    with torch.inference_mode():
        got = tmodel.backbone(torch.from_numpy(x))
    assert len(got) == len(want) == 5
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape, f"P{i + 2}"
        err = np.abs(g.numpy() - w).max() / (np.abs(w).max() + 1e-6)
        assert err < 2e-3, f"P{i + 2}: rel err {err}"


def test_rpn_scores_parity(pair):
    cfg, jmodel, params, tmodel = pair
    rng = np.random.RandomState(1)
    feats = [rng.randn(2, h, w, 256).astype(np.float32)
             for h, w in cfg.BACKBONE_SHAPES]
    want_s, want_d = jmodel.rpn_scores(params,
                                       [jnp.asarray(f) for f in feats])
    with torch.inference_mode():
        got_s, got_d = tmodel.rpn_scores([torch.from_numpy(f) for f in feats])
    assert got_s.shape == (2, cfg.NUM_ANCHORS) and got_s.dtype == torch.float32
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                               rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d),
                               rtol=1e-3, atol=1e-4)


def test_box_head_parity(pair):
    cfg, jmodel, params, tmodel = pair
    pooled = np.random.RandomState(2).randn(5, 7, 7, 256).astype(np.float32)
    want = jmodel.classify(params, jnp.asarray(pooled))
    with torch.inference_mode():
        got = tmodel.classify(torch.from_numpy(pooled))
    for name, g, w in zip(("logits", "probs", "deltas"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-3,
                                   atol=1e-4, err_msg=name)


def test_mask_head_parity(pair):
    cfg, jmodel, params, tmodel = pair
    pooled = np.random.RandomState(3).randn(3, 14, 14, 256).astype(
        np.float32)
    want = np.asarray(jmodel.predict_masks(params, jnp.asarray(pooled)))
    with torch.inference_mode():
        got = tmodel.predict_masks(torch.from_numpy(pooled)).numpy()
    assert got.shape == want.shape == (3, 28, 28, cfg.NUM_CLASSES)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)


def test_init_is_seeded_and_reference_shaped():
    """init(generator): same seed, same weights; xavier bounds on convs,
    N(0, 0.01) linears, zero biases, identity BN."""
    from maskrcnn_tpu_torch.models.mask_rcnn import MaskRCNN
    cfg = TinyConfig()
    a = MaskRCNN(port_config(cfg), "cpu").init(
        torch.Generator().manual_seed(3))
    b = MaskRCNN(port_config(cfg), "cpu").init(
        torch.Generator().manual_seed(3))
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    w = a.fpn.C2[0].conv2.weight
    bound = (6.0 / (64 * 9 + 64 * 9)) ** 0.5
    assert w.abs().max() <= bound and w.abs().max() > 0.9 * bound
    assert abs(a.classifier.linear_class.weight.std().item() - 0.01) < 1e-3
    assert not a.rpn.conv_shared.bias.any()
    assert torch.equal(a.mask.bn1.running_var, torch.ones(256))
