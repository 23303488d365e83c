"""Data parallelism of the port (maskrcnn_tpu_torch/parallel, the
data-parallel Detector) on the CPU.

Two gloo ranks (tests/torch_dp_worker.py, spawned over localhost) each
take one image of a global batch of two, whose RPN positive-anchor
counts differ between the images: averaged per-rank means would give
another gradient. After one data-parallel step the parameters and
losses equal the port's one-process step on the global batch and one
step of the JAX package's train_step (its jitted value_and_grad of
compute_losses and optax chain, as tests/test_torch_train_step.py)
within 1e-5 of each tensor's largest value; the validation losses equal
the one-process losses. One accumulated step (GRAD_ACCUM_STEPS=2, two
images a rank) equals the port's one-process accumulated step on the
global micro-batches (each rank's micro-batch i together, as the JAX
package's multi-process shard_batch builds them); the one-process
accumulated step is held against JAX in tests/test_torch_train_props.py.
The samplers run in the deterministic regime (tests/torch_port
.train_config), so no random draw enters.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from maskrcnn_tpu.config import TinyConfig as JaxTiny
from maskrcnn_tpu.models.mask_rcnn import MaskRCNN as JaxMaskRCNN
from maskrcnn_tpu.train import step as jstep
from maskrcnn_tpu.train.trainer import LAYER_REGEX as JAX_REGEX
from maskrcnn_tpu.train.trainer import decay_mask as jax_decay
from maskrcnn_tpu.train.trainer import trainable_mask as jax_trainable
from maskrcnn_tpu_torch.api import Detector
from maskrcnn_tpu_torch.checkpoint.convert import (from_jax_params,
                                                   load_jax_params)
from maskrcnn_tpu_torch.config import TinyConfig
from maskrcnn_tpu_torch.models.mask_rcnn import MaskRCNN
from maskrcnn_tpu_torch.train import step as pstep
from maskrcnn_tpu_torch.train.targets import rpn_targets
from maskrcnn_tpu_torch.train.trainer import split_accum, to_device
from tests.torch_port import jax_params, port_config, train_batch, train_config

CFG = train_config(JaxTiny())
LR = 0.001
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_model(params, **overrides):
    model = MaskRCNN(port_config(CFG).replace(**overrides), "cpu",
                     train=True)
    load_jax_params(model, params)
    return model


def _anchor_gt(model, batch, i):
    """Image i of `batch` with a fourth instance whose box is one of the
    RPN's anchors (a positive anchor the other image lacks) at IoU < 0.3
    with every proposal and gt of the image, so the head's positives and
    the deterministic regime stay as they were."""
    from maskrcnn_tpu_torch.detection.pipeline import rpn_refine
    from maskrcnn_tpu_torch.ops.boxes import box_iou
    from maskrcnn_tpu_torch.ops.image import normalize_image
    h, w = CFG.IMAGE_SHAPE[:2]
    with torch.no_grad():
        feats = model.backbone(normalize_image(
            torch.from_numpy(batch["images"][i:i + 1]), CFG.MEAN_PIXEL))
        props, pvalid = rpn_refine(model.config, model.anchors(),
                                   *model.rpn_detect(feats)[1:])
    scale = torch.tensor([h, w, h, w], dtype=torch.float32)
    taken = torch.cat([props[0, pvalid[0]] * scale,
                       torch.from_numpy(batch["gt_boxes"][i][
                           batch["gt_valid"][i]])])
    anchors = model.anchors()
    inside = ((anchors[:, 0] >= 0) & (anchors[:, 1] >= 0)
              & (anchors[:, 2] <= h) & (anchors[:, 3] <= w)
              & (anchors[:, 2] - anchors[:, 0] >= 16))
    free = inside & (box_iou(anchors, taken).max(1).values < 0.3)
    j = int(torch.nonzero(free)[0])
    k = int(batch["gt_valid"][i].sum())
    batch = {key: v.copy() for key, v in batch.items()}
    batch["gt_boxes"][i, k] = anchors[j].numpy()
    batch["gt_class_ids"][i, k] = 1
    batch["gt_valid"][i, k] = True
    y1, x1, y2, x2 = np.round(anchors[j].numpy()).astype(int)
    batch["gt_masks"][i, k, y1:y2, x1:x2] = 1
    return batch


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jax_step(params, batch):
    """One step of the JAX package's train_step on the global batch: its
    jitted value_and_grad of compute_losses, the frozen mask, the optax
    chain and apply_updates. Returns (losses, the weights after, in the
    port's state layout)."""
    jmodel = JaxMaskRCNN(CFG)

    def loss_fn(p, b):
        losses = jstep.compute_losses(jmodel, p, jax.random.PRNGKey(0), b)
        return losses.total, losses

    # the batch an argument, not a constant of the traced function: XLA
    # then compiles in seconds
    (_, losses), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params, batch)
    regex = JAX_REGEX["all"]
    tmask = jax_trainable(params, regex)
    opt = jstep.make_optimizer(CFG, LR, jax_decay(params, regex))

    @jax.jit
    def update(grads, p):
        # train_step's frozen mask, optax chain and apply_updates (jitted:
        # op by op the chain takes half a minute)
        grads = jax.tree_util.tree_map(
            lambda g, t: g * jnp.asarray(t, g.dtype), grads, tmask)
        updates, _ = opt.update(grads, opt.init(p), p)
        return optax.apply_updates(p, updates)

    return losses, from_jax_params(jax.device_get(update(grads, params)),
                                   CFG.BACKBONE)


def _one_process_step(params, batch, accum=1):
    """The port's one-process step on the global batch: (losses, weights
    after), numpy."""
    model = _port_model(params, GRAD_ACCUM_STEPS=accum)
    ps = [p for _, p in model.named_parameters()]
    opt = pstep.make_optimizer(model.config, LR, ps, [True] * len(ps))
    losses = pstep.train_step(model, opt,
                              split_accum(to_device(batch, "cpu"), accum),
                              torch.Generator().manual_seed(0))
    return ({k: v.numpy() for k, v in losses.items()},
            {n: p.detach().numpy() for n, p in model.named_parameters()})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The weights, the batches (two images; four for the accumulated
    step), the two ranks' results, and, computed while the ranks run, the
    one-process steps, the one-process validation losses and JAX's
    step."""
    params = jax_params(CFG)
    model = _port_model(params)
    batch = _anchor_gt(model, train_batch(CFG, model, b=2), 0)
    batch4 = train_batch(CFG, model, b=4, seed=1)
    tmp = tmp_path_factory.mktemp("dp")
    fields = {f.name: getattr(CFG, f.name)
              for f in dataclasses.fields(CFG)}
    data = {"config": np.asarray(json.dumps(fields)),
            "lr": np.float64(LR)}
    data.update({f"state.{k}": v for k, v in
                 from_jax_params(params, CFG.BACKBONE).items()})
    data.update({f"step.{k}": v for k, v in batch.items()})
    data.update({f"accum.{k}": v for k, v in batch4.items()})
    np.savez(tmp / "in.npz", **data)
    port = _free_port()
    env = {k: v for k, v in os.environ.items()}
    env["PYTHONPATH"] = ROOT
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tests.torch_dp_worker", str(r), "2",
         str(port), str(tmp / "in.npz"), str(tmp / "out.npz")],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(2)]
    try:
        one = {"step": _one_process_step(params, batch),
               # rank r holds images 2r, 2r + 1; micro-batch i of the
               # global step is (image i of rank 0, image i of rank 1)
               "accum": _one_process_step(
                   params, {k: v[[0, 2, 1, 3]] for k, v in batch4.items()},
                   accum=2)}
        with torch.no_grad():
            val = pstep.compute_losses(model,
                                       torch.Generator().manual_seed(0),
                                       to_device(batch, "cpu"))
        one["val"] = {k: float(v) for k, v in val.as_dict().items()}
        one["jax"] = _jax_step(params, batch)
    finally:
        logs = [p.communicate(timeout=600) for p in procs]
    for p, (_, err) in zip(procs, logs):
        assert p.returncode == 0, err[-3000:]
    with np.load(tmp / "out.npz") as z:
        out = {k: z[k] for k in z.files}
    return params, batch, batch4, out, one


def test_ranks_hold_different_positive_counts(runs):
    """The scene that catches per-rank averaging: the two images' RPN
    positive and sampled anchor counts differ (the head's positives are
    three an image on both)."""
    params, batch, *_ = runs
    model = _port_model(params)
    tgt = rpn_targets(model.config, None, model.anchors(),
                      torch.from_numpy(batch["gt_class_ids"]),
                      torch.from_numpy(batch["gt_boxes"]),
                      torch.from_numpy(batch["gt_valid"]))
    pos = (tgt.rpn_match == 1).sum(1).tolist()
    sampled = (tgt.rpn_match != 0).sum(1).tolist()
    assert pos[0] != pos[1] and sampled[0] != sampled[1], (pos, sampled)


def _close(got, want, name, before=None):
    """Within 1e-5 of the tensor's largest |value|; a zero-initialized
    tensor (`before` all 0) is nothing but its update, held to 3e-3 of
    its largest update: the gradients' float32 sums, in another order on
    two ranks (measured 1.6e-3 on mask.conv3.bias, against the one-process
    step and against JAX)."""
    scale = float(np.abs(want).max())
    rel = 1e-5
    if before is not None and not np.any(before):
        scale, rel = float(np.abs(want - before).max()), 3e-3
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(scale, 1e-30), err_msg=name)


# Losses: the ranks' convolutions run at batch 1 where the one-process
# run's run at batch 2, and the CPU convolution sums in another order;
# measured up to 2e-5 relative on mrn_box, whose targets divide by
# BBOX_STD_DEV = 0.1 (its value 0.11), the others within 1e-6.
LOSS_RTOL = 5e-5


def test_step_equals_one_process_step(runs):
    params, _, _, out, one = runs
    losses, weights = one["step"]
    before = from_jax_params(params, CFG.BACKBONE)
    for k, v in losses.items():
        np.testing.assert_allclose(out[f"step.loss.{k}"], v,
                                   rtol=LOSS_RTOL, atol=1e-7, err_msg=k)
    for n, w in weights.items():
        _close(out[f"step.param.{n}"], w, n, before[n])


def test_step_equals_jax_train_step(runs):
    """One step of the JAX package's train_step on the global batch: its
    losses and every weight after the update."""
    params, _, _, out, one = runs
    losses, after = one["jax"]
    before = from_jax_params(params, CFG.BACKBONE)
    for k in ("total", "rpn_class", "rpn_box", "mrn_class", "mrn_box",
              "mrn_mask"):
        np.testing.assert_allclose(out[f"step.loss.{k}"],
                                   float(getattr(losses, k)),
                                   rtol=LOSS_RTOL, atol=1e-6, err_msg=k)
    for n in (k[len("step.param."):] for k in out
              if k.startswith("step.param.")):
        _close(out[f"step.param.{n}"], after[n], n, before[n])


def test_eval_losses_equal_one_process(runs):
    out, one = runs[3], runs[4]
    for k, v in one["val"].items():
        np.testing.assert_allclose(out[f"val.{k}"], v, rtol=LOSS_RTOL,
                                   atol=1e-7, err_msg=k)


def test_accumulated_step_equals_one_process(runs):
    """Rank r holds images 2r, 2r + 1; micro-batch i of the global step is
    (image i of rank 0, image i of rank 1) = images (i, 2 + i)."""
    params, _, _, out, one = runs
    losses, weights = one["accum"]
    before = from_jax_params(params, CFG.BACKBONE)
    for k, v in losses.items():
        np.testing.assert_allclose(out[f"accum.loss.{k}"], v,
                                   rtol=LOSS_RTOL, atol=1e-7, err_msg=k)
    for n, w in weights.items():
        _close(out[f"accum.param.{n}"], w, n, before[n])


@pytest.mark.parametrize("n_images", [3, 4])
def test_two_replica_detector_equals_one(n_images):
    """Detector(NUM_DEVICES=2) with two CPU replicas against
    NUM_DEVICES=1: 3 images (padded to 4, the pad dropped) and 4."""
    cfg = TinyConfig(DETECTION_MIN_CONFIDENCE=0.0)
    rng = np.random.RandomState(n_images)
    images = [rng.randint(0, 256, (96 + 8 * i, 120, 3)).astype(np.uint8)
              for i in range(n_images)]
    one = Detector(cfg, "cpu").detect_batch(images)
    two_det = Detector(cfg.replace(NUM_DEVICES=2), "cpu")
    two = two_det.detect_batch(images)
    assert len(two_det._replicas) == 2
    assert len(two) == n_images
    for a, b in zip(one, two):
        if a is None:
            assert b is None
            continue
        assert a[0] == b[0]
        np.testing.assert_allclose(a[1], b[1], rtol=1e-5)
        np.testing.assert_allclose(a[2], b[2], atol=1e-3)
        assert np.mean(a[3] != b[3]) < 1e-3
