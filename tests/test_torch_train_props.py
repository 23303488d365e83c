"""Properties of the port's training step and trainer on the CPU,
float32:

* the trainable and decay masks of every LAYER_REGEX preset equal the
  JAX package's, parameter by parameter through the weight bridge's
  name_map (cascade and keypoint heads included; the JAX tree from
  jax.eval_shape, no weights made);
* GRAD_ACCUM_STEPS=2 updates the weights with the mean of the two
  micro-batches' gradients and reports the mean losses;
* REMAT_BACKBONE and REMAT_HEADS on and off give identical gradients;
* a non-finite total keeps the weights, the momentum and the step count;
* the inference construction keeps its weights in the compute dtype and
  raises for the inference-only options when built for training.
All four equalities are bit for bit (the same operations in the same
order on the CPU)."""

import jax
import numpy as np
import pytest
import torch

from maskrcnn_tpu.config import TinyConfig as JaxTiny
from maskrcnn_tpu.models.mask_rcnn import MaskRCNN as JaxMaskRCNN
from maskrcnn_tpu.train.trainer import LAYER_REGEX as JAX_REGEX
from maskrcnn_tpu.train.trainer import decay_mask as jax_decay
from maskrcnn_tpu.train.trainer import trainable_mask as jax_trainable
from maskrcnn_tpu_torch import TinyConfig
from maskrcnn_tpu_torch.checkpoint.convert import name_map
from maskrcnn_tpu_torch.data.pipeline import SyntheticLoader
from maskrcnn_tpu_torch.models.mask_rcnn import MaskRCNN
from maskrcnn_tpu_torch.train import step as pstep
from maskrcnn_tpu_torch.train.trainer import (LAYER_REGEX, decay_mask,
                                              to_device, trainable_mask)
from tests.torch_port import port_config

PROTOCOLS = dict(CASCADE_STAGES=(0.5, 0.6, 0.7), NUM_KEYPOINTS=3,
                 KEYPOINT_HEAD_CONVS=2, KEYPOINT_HEAD_DIM=32)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: v})
    return out


@pytest.mark.parametrize("preset", sorted(LAYER_REGEX))
def test_masks_equal_jax(preset):
    cfg = JaxTiny(**PROTOCOLS)
    shapes = jax.eval_shape(JaxMaskRCNN(cfg)._init, jax.random.PRNGKey(0))
    jt = _flat(jax_trainable(shapes, JAX_REGEX[preset]))
    jd = _flat(jax_decay(shapes, JAX_REGEX[preset]))
    model = MaskRCNN(port_config(cfg), "cpu", train=True)
    pt = trainable_mask(model, LAYER_REGEX[preset])
    pd = decay_mask(model, LAYER_REGEX[preset])
    suffix = {"weight": "kernel", "bias": "bias"}
    names = name_map(cfg.BACKBONE, box_heads=3, keypoint_convs=2)
    to_flax = {f"{t}.{f}": f"{j}/{suffix[f]}" for t, j, kind in names
               if kind != "bn" for f in suffix}
    assert sorted(to_flax) == sorted(pt)
    assert {n: jt[to_flax[n]] for n in pt} == pt
    assert {n: jd[to_flax[n]] for n in pd} == pd
    # BN tensors are JAX parameters, never trainable; buffers in the port
    assert not any(v for k, v in jt.items() if "bn" in k)
    assert any(pt.values()) and (preset == "all") == all(pt.values())


def _model(**overrides):
    cfg = TinyConfig(**overrides)
    return MaskRCNN(cfg, "cpu", train=True).init(
        torch.Generator().manual_seed(0))


@pytest.fixture(scope="module")
def batch():
    return to_device(next(SyntheticLoader(TinyConfig(), 2, seed=1)), "cpu")


def _sgd(model):
    params = list(model.parameters())
    return pstep.make_optimizer(model.config, 0.01, params,
                                [True] * len(params))


def test_grad_accum_is_the_mean_of_micro_batches(batch):
    acc = _model(GRAD_ACCUM_STEPS=2)
    ref = _model()
    opt_a, opt_r = _sgd(acc), _sgd(ref)
    got = pstep.train_step(acc, opt_a, pstep.split_accum(batch, 2),
                           torch.Generator().manual_seed(3))
    gen = torch.Generator().manual_seed(3)
    grads, totals = None, []
    for i in range(2):
        losses = pstep.compute_losses(ref, gen,
                                      {k: v[i:i + 1] for k, v in batch.items()})
        g = pstep._grads(losses.total, opt_r.params)
        grads = g if grads is None else [a + b for a, b in zip(grads, g)]
        totals.append(losses.total.detach())
    two = torch.tensor(2.0)
    opt_r.update([g / two for g in grads], torch.tensor(True))
    assert torch.equal(got["total"], (totals[0] + totals[1]) / two)
    for (name, a), b in zip(acc.named_parameters(), ref.parameters()):
        assert torch.equal(a, b), name
    assert int(opt_a.step) == 1


def _named_grads(model, batch):
    losses = pstep.compute_losses(model, torch.Generator().manual_seed(5),
                                  batch)
    names, params = zip(*model.named_parameters())
    return losses, dict(zip(names, pstep._grads(losses.total, params)))


def test_remat_gives_identical_gradients(batch):
    plain = _named_grads(_model(REMAT_BACKBONE=False), batch)
    remat = _named_grads(_model(REMAT_BACKBONE=True, REMAT_HEADS=True),
                         batch)
    assert torch.equal(plain[0].total, remat[0].total)
    for k, g in plain[1].items():
        assert torch.equal(g, remat[1][k]), k


def test_non_finite_guard_keeps_the_state(batch):
    model = _model()
    opt = _sgd(model)
    gen = torch.Generator().manual_seed(0)
    pstep.train_step(model, opt, batch, gen)
    assert int(opt.step) == 1 and any(bool(t.any()) for t in opt.trace)
    with torch.no_grad():
        model.rpn.conv_class.bias[0] = float("nan")
    params = [p.detach().clone() for p in model.parameters()]
    trace = [t.clone() for t in opt.trace]
    metrics = pstep.train_step(model, opt, batch, gen)
    assert not torch.isfinite(metrics["total"])
    assert int(opt.step) == 1
    for a, b in zip(model.parameters(), params):
        assert torch.equal(a.nan_to_num(), b.nan_to_num())
    for a, b in zip(opt.trace, trace):
        assert torch.equal(a, b)


def test_training_construction():
    """float32 weights computing in bf16 for training; the inference
    construction's weights stay bf16; FOLD_BN and QUANT_INT8 refuse
    training."""
    train = MaskRCNN(TinyConfig(COMPUTE_DTYPE="bfloat16"), "cpu", train=True)
    infer = MaskRCNN(TinyConfig(COMPUTE_DTYPE="bfloat16"), "cpu")
    assert train.fpn.C2[0].conv1.weight.dtype == torch.float32
    assert train.fpn.C2[0].conv1.act_dtype == torch.bfloat16
    assert infer.fpn.C2[0].conv1.weight.dtype == torch.bfloat16
    assert train.dtype == infer.dtype == torch.bfloat16
    for field in ("FOLD_BN", "QUANT_INT8"):
        with pytest.raises(NotImplementedError, match=field):
            MaskRCNN(TinyConfig(**{field: True}), "cpu", train=True)
    # data parallelism needs one process a device: outside a process
    # group of that size NUM_DEVICES > 1 raises
    with pytest.raises(ValueError, match="NUM_DEVICES"):
        MaskRCNN(TinyConfig(NUM_DEVICES=2), "cpu", train=True)
