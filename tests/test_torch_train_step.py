"""The port's training step against the JAX package at TinyConfig, float32,
on JAX weights carried across by `load_jax_params` and one numpy batch
(two images) whose gt boxes are proposals, in the samplers'
deterministic regime (tests/torch_port.train_config).

* one `compute_losses` and its gradient against JAX's jitted
  `jax.value_and_grad`: the six losses within 1e-5 relative (1e-6
  absolute), every parameter's gradient within 1e-4 of that tensor's
  largest |g|. Measured: losses within 8.9e-6 relative, 9.9e-7
  absolute (mrn_box: its targets divide by BBOX_STD_DEV, which jitted
  XLA turns into a reciprocal multiply, an ulp on deltas near 10), the
  others within 4.4e-7; gradients within 6.4e-5 of their max
  (fpn.C3.1.conv3.bias);
* two `train_step`s ("all" layers at LEARNING_RATE, momentum, weight
  decay and the clip all acting: the gradient norm is about 266) against
  two steps of the JAX package's train_step (its gradient, frozen mask,
  optax chain and apply_updates, unrolled so the module compiles one
  gradient): every weight within 1e-5 of its largest |p| (measured
  4.9e-7). A zero-initialized bias is nothing but its two updates, so
  it is held to 1e-3 of its largest update (measured 4.1e-4, the mask
  head's conv1.bias): the gradients' 1e-4 bar, carried through the clip
  and through a second gradient taken at weights that already differ.

The JAX gradient and steps are computed once for the module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from maskrcnn_tpu.config import TinyConfig as JaxTiny
from maskrcnn_tpu.models.mask_rcnn import MaskRCNN as JaxMaskRCNN
from maskrcnn_tpu.train import step as jstep
from maskrcnn_tpu.train import targets as jt
from maskrcnn_tpu.train.trainer import LAYER_REGEX as JAX_REGEX
from maskrcnn_tpu.train.trainer import decay_mask as jax_decay
from maskrcnn_tpu.train.trainer import trainable_mask as jax_trainable
from maskrcnn_tpu_torch.checkpoint.convert import (from_jax_params,
                                                   load_jax_params)
from maskrcnn_tpu_torch.models.mask_rcnn import MaskRCNN
from maskrcnn_tpu_torch.train import step as pstep
from maskrcnn_tpu_torch.train.trainer import to_device
from tests.torch_port import jax_params, port_config, train_batch, train_config

CFG = train_config(JaxTiny())
LR = 0.001


def port_model(params):
    model = MaskRCNN(port_config(CFG), "cpu", train=True)
    load_jax_params(model, params)
    return model


@pytest.fixture(scope="module")
def setup():
    params = jax_params(CFG)
    model = port_model(params)
    batch = train_batch(CFG, model)
    # the deterministic regime on the JAX side: positives under p_cap and
    # negatives under the budget in every image
    from maskrcnn_tpu_torch.detection.pipeline import rpn_refine
    from maskrcnn_tpu_torch.ops.image import normalize_image
    with torch.no_grad():
        feats = model.backbone(normalize_image(
            torch.from_numpy(batch["images"]), CFG.MEAN_PIXEL))
        props, pvalid = rpn_refine(model.config, model.anchors(),
                                   *model.rpn_detect(feats)[1:])
    t = CFG.TRAIN_ROIS_PER_IMAGE
    p_cap = int(t * CFG.ROI_POSITIVE_RATIO)
    norm = batch["gt_boxes"] / np.float32(CFG.IMAGE_MAX_DIM)
    for i in range(len(norm)):
        iou = np.asarray(jt._masked_iou(props[i].numpy(), norm[i],
                                        batch["gt_valid"][i])).max(1)
        n_pos = int(((iou >= 0.5) & pvalid[i].numpy()).sum())
        n_neg = int(((iou < 0.5) & pvalid[i].numpy()).sum())
        budget = min(int(np.floor(n_pos / np.float32(0.125))) - n_pos,
                     t - p_cap)
        assert n_pos == p_cap and n_neg <= budget, (n_pos, n_neg)
    return params, batch


@pytest.fixture(scope="module")
def jax_value_and_grad(setup):
    """JAX's jitted value_and_grad of compute_losses on the batch."""
    _, batch = setup
    jmodel = JaxMaskRCNN(CFG)

    def loss_fn(p):
        losses = jstep.compute_losses(jmodel, p, jax.random.PRNGKey(0),
                                      batch)
        return losses.total, losses
    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


@pytest.fixture(scope="module")
def jax_grad(setup, jax_value_and_grad):
    (_, losses), grads = jax_value_and_grad(setup[0])
    return losses, grads


def test_compute_losses_and_grads_equal_jax(setup, jax_grad):
    params, batch = setup
    want, grads = jax_grad
    model = port_model(params)
    losses = pstep.compute_losses(model, torch.Generator().manual_seed(0),
                                  to_device(batch, "cpu"))
    for k, v in losses.as_dict().items():
        w = float(getattr(want, k))
        np.testing.assert_allclose(float(v), w, rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    assert float(want.mrn_class) > 0 and float(want.mrn_mask) > 0
    names, ps = zip(*model.named_parameters())
    got = torch.autograd.grad(losses.total, ps, allow_unused=True)
    jgrads = from_jax_params(jax.device_get(grads), CFG.BACKBONE)
    for name, g in zip(names, got):
        w = jgrads[name]
        g = np.zeros_like(w) if g is None else g.numpy()
        scale = np.abs(w).max()
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * scale + 1e-12,
                                   err_msg=name)


@pytest.fixture(scope="module")
def jax_two_steps(setup, jax_value_and_grad, jax_grad):
    """Two steps of the JAX package's train_step, unrolled: its jitted
    gradient (compiled once for the module), the frozen mask, its optax
    chain (make_optimizer) and apply_updates, in its order. Returns the
    params before and after, and the first step's clip input norm."""
    params, _ = setup
    regex = JAX_REGEX["all"]
    tmask = jax_trainable(params, regex)
    opt = jstep.make_optimizer(CFG, LR, jax_decay(params, regex))

    @jax.jit
    def update(grads, opt_state, p):
        grads = jax.tree_util.tree_map(
            lambda g, t: g * jnp.asarray(t, g.dtype), grads, tmask)
        updates, opt_state = opt.update(grads, opt_state, p)
        return optax.apply_updates(p, updates), opt_state, \
            optax.global_norm(grads)

    p, opt_state = params, opt.init(params)
    grads, norms = jax_grad[1], []
    for i in range(2):
        if i:
            grads = jax_value_and_grad(p)[1]
        p, opt_state, norm = update(grads, opt_state, p)
        norms.append(float(norm))
    return jax.device_get(params), jax.device_get(p), norms


def test_two_train_steps_equal_jax(setup, jax_two_steps):
    params, batch = setup
    before, want, norms = jax_two_steps
    assert max(norms) > pstep.CLIP_NORM, norms
    model = port_model(params)
    names = [n for n, _ in model.named_parameters()]
    opt = pstep.make_optimizer(model.config, LR,
                               [p for _, p in model.named_parameters()],
                               [True] * len(names))
    gen = torch.Generator().manual_seed(0)
    dev_batch = to_device(batch, "cpu")
    for _ in range(2):
        pstep.train_step(model, opt, dev_batch, gen)
    assert int(opt.step) == 2
    ref = from_jax_params(want, CFG.BACKBONE)
    ref0 = from_jax_params(before, CFG.BACKBONE)
    for name, p in model.named_parameters():
        w = ref[name]
        if np.any(ref0[name]):
            bar = 1e-5 * np.abs(w).max()
        else:
            # a zero-initialized bias is its two updates
            bar = 1e-3 * np.abs(w - ref0[name]).max()
        np.testing.assert_allclose(p.detach().numpy(), w, rtol=0,
                                   atol=bar + 1e-12, err_msg=name)
