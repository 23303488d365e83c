"""The port's FOLD_BN path against the JAX package: the fold itself, the
folded model, and that Config.FOLD_BN is honoured at all."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maskrcnn_tpu.checkpoint.fold import fold_bn_params as jax_fold
from maskrcnn_tpu.config import TinyConfig
from maskrcnn_tpu.models.mask_rcnn import MaskRCNN as JaxMaskRCNN
from maskrcnn_tpu_torch.api import Detector
from maskrcnn_tpu_torch.checkpoint.convert import from_jax_params
from maskrcnn_tpu_torch.checkpoint.fold import BN_EPS, fold_state_dict
from maskrcnn_tpu_torch.models.mask_rcnn import MaskRCNN
from maskrcnn_tpu_torch.models.resnet import FrozenBatchNorm
from tests.torch_port import jax_params, port_config, torch_model

CFG = TinyConfig()
FOLD = CFG.replace(FOLD_BN=True)
IDENTITY = (1.0, 0.0, 0.0, np.float32(1.0 - BN_EPS))


def _assert_states_equal(got, want):
    """Both folds are IEEE float32 elementwise ops (sqrt, divide,
    multiply, add) in the same order, so they agree bit for bit."""
    assert list(got) == list(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype == np.float32, k
        np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.fixture(scope="module", params=["resnet50", "resnet101"])
def arch_params(request):
    cfg = CFG.replace(BACKBONE=request.param)
    return request.param, jax_params(cfg)


def test_fold_equals_jax_fold(arch_params):
    """The port's fold of the torch-layout state dict equals the JAX
    package's fold_bn_params array for array."""
    arch, params = arch_params
    _assert_states_equal(fold_state_dict(from_jax_params(params, arch), arch),
                         from_jax_params(jax_fold(params), arch))


def test_fold_twice_is_a_no_op(arch_params):
    arch, params = arch_params
    once = fold_state_dict(from_jax_params(params, arch), arch)
    _assert_states_equal(fold_state_dict(once, arch), once)


def _bn_modules(model):
    return [(n, m) for n, m in model.named_modules()
            if isinstance(m, FrozenBatchNorm)]


def test_fold_bn_is_honoured_when_loading_jax_params():
    """Config.FOLD_BN folds unfolded JAX weights on the way in: every
    conv equals the JAX fold, every BN holds the identity and applies
    nothing, and the identity blocks run the fused op."""
    params = jax_params(CFG)
    det = Detector(port_config(FOLD), "cpu")
    det.load_jax_params(params)
    want = from_jax_params(jax_fold(params), CFG.BACKBONE)
    got = det.model.state_dict()
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    bns = _bn_modules(det.model)
    assert len(bns) == 53 + 2 + 4  # backbone, box head, mask head
    x = torch.randn(2, 8, 3, 3)
    for name, bn in bns:
        assert bn.folded, name
        for field, value in zip(("weight", "bias", "running_mean",
                                 "running_var"), IDENTITY):
            assert torch.all(getattr(bn, field) == value), (name, field)
        assert bn(x) is x
    fused = [n for n, m in det.model.named_modules()
             if getattr(m, "fused", False)]
    assert fused == [f"fpn.C{s}.{i}" for s, n in zip((2, 3, 4, 5),
                                                     (3, 4, 6, 3))
                     for i in range(1, n)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_seeded_init_folds_float32_before_the_cast(dtype):
    """FOLD_BN init: the float32 draws of the unfolded init, folded, then
    cast once. Fresh BN (var=1) scales by 1/sqrt(1.001), so the fold is
    not a no-op; in bf16, folding the rounded weights would round twice
    and differ."""
    cfg = CFG.replace(COMPUTE_DTYPE=dtype)
    draws = MaskRCNN(port_config(cfg.replace(COMPUTE_DTYPE="float32")),
                     "cpu").init(
        torch.Generator().manual_seed(4)).state_dict()
    draws = {k: v.numpy() for k, v in draws.items()}
    folded = fold_state_dict(draws, cfg.BACKBONE)
    model = MaskRCNN(port_config(cfg.replace(FOLD_BN=True)), "cpu").init(
        torch.Generator().manual_seed(4))
    got = model.state_dict()
    key = "fpn.C3.2.conv2.weight"
    assert not np.array_equal(folded[key], draws[key])
    for k, v in folded.items():
        want = torch.from_numpy(v).to(got[k].dtype)
        assert torch.equal(got[k], want), k
    if dtype == "bfloat16":
        rounded = {k: torch.from_numpy(v).to(torch.bfloat16).float().numpy()
                   for k, v in draws.items()}
        twice = torch.from_numpy(fold_state_dict(rounded, cfg.BACKBONE)[key])
        assert not torch.equal(got[key], twice.to(torch.bfloat16))


@pytest.fixture(scope="module")
def folded_pair():
    """JAX MaskRCNN(FOLD_BN) and the port on the same folded params; the
    jittered BN of torch_port.jax_params makes the fold non-trivial."""
    folded = jax_fold(jax_params(CFG))
    return JaxMaskRCNN(FOLD), folded, torch_model(FOLD, folded)


def test_folded_backbone_parity(folded_pair):
    """Tolerance of test_torch_models: relative error 2e-3 on the FPN
    maps (a deep float32 conv stack summed in another order; the fused
    identity blocks add one more order)."""
    jmodel, params, tmodel = folded_pair
    rng = np.random.RandomState(0)
    x = (rng.randn(2, 128, 128, 3) * 30).astype(np.float32)
    want = jmodel.backbone(params, jnp.asarray(x))
    with torch.inference_mode():
        got = tmodel.backbone(torch.from_numpy(x))
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape, f"P{i + 2}"
        err = np.abs(g.numpy() - w).max() / (np.abs(w).max() + 1e-6)
        assert err < 2e-3, f"P{i + 2}: rel err {err}"


def test_folded_heads_parity(folded_pair):
    """RPN, box head and mask head at test_torch_models' rtol 1e-3 /
    atol 1e-4."""
    jmodel, params, tmodel = folded_pair
    rng = np.random.RandomState(1)
    feats = [rng.randn(2, h, w, 256).astype(np.float32)
             for h, w in CFG.BACKBONE_SHAPES]
    box_in = rng.randn(5, 7, 7, 256).astype(np.float32)
    mask_in = rng.randn(3, 14, 14, 256).astype(np.float32)
    want = (list(jmodel.rpn_scores(params, [jnp.asarray(f) for f in feats]))
            + list(jmodel.classify(params, jnp.asarray(box_in)))
            + [jmodel.predict_masks(params, jnp.asarray(mask_in))])
    with torch.inference_mode():
        got = (list(tmodel.rpn_scores([torch.from_numpy(f) for f in feats]))
               + list(tmodel.classify(torch.from_numpy(box_in)))
               + [tmodel.predict_masks(torch.from_numpy(mask_in))])
    names = ("rpn scores", "rpn deltas", "logits", "probs", "deltas",
             "masks")
    for name, g, w in zip(names, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-3,
                                   atol=1e-4, err_msg=name)
