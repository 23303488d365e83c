"""Training forward, the loss and the SGD step (counterpart of
maskrcnn_tpu/train/step.py).

* forward: the reference's `extract` (model.py:1205-1292): backbone,
  RPN, proposal layer, target sampling on the device, heads;
* loss: the five-task sum (model.py:1623-1629), the keypoint task when
  the config has one;
* update: SGD, momentum 0.9, weight decay 1e-4 on the trainable
  parameters, global-norm clip at 5.0 (model.py:1542-1557, 1633), in the
  optax order of the JAX package.

The loss is the mean over the batch, as in the JAX package (the
reference sums single-image passes; at its batch of 1 they coincide).
Nothing in a step reads a value on the host: the non-finite guard keeps
the old weights and momentum with device selects, as the JAX step does
in its graph. On the card the step's RoIAligns are K1 forward and K1-bwd
backward (the mrt::roi_align op's registered gradient,
kernels/torch_ops.py), its proposal NMS K2. Under data parallelism
(`train_step`'s `dp`) the losses are global-batch means and the
gradients are all-reduced before the update (parallel/).

`train_step` runs under torch's strict deterministic mode
(`deterministic`): cuDNN and cuBLAS take deterministic algorithms,
index_add_ and the gathers' backward their deterministic forms, and an
op with no deterministic form raises. With K1-bwd's fixed order of sums,
a step on the card gives the same bits from the same weights, batch and
generator, as the JAX package's step does. cuBLAS needs
CUBLAS_WORKSPACE_CONFIG, which `maskrcnn_tpu_torch.train` sets on import.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.utils.deterministic
from torch.utils.checkpoint import checkpoint

from maskrcnn_tpu_torch.detection.pipeline import _pool_rois, rpn_refine
from maskrcnn_tpu_torch.models.mask_rcnn import MaskRCNN
from maskrcnn_tpu_torch.ops import boxes as box_ops
from maskrcnn_tpu_torch.ops import device_tensor
from maskrcnn_tpu_torch.ops.bits import unpack_masks
from maskrcnn_tpu_torch.ops.image import normalize_image
from maskrcnn_tpu_torch.train import losses as L
from maskrcnn_tpu_torch.train.targets import (_crop_gt_masks,
                                              cascade_targets,
                                              keypoint_targets, mrn_targets,
                                              rpn_targets)

# the global-norm clip of the reference (model.py:1633)
CLIP_NORM = 5.0


@contextlib.contextmanager
def deterministic():
    """torch.use_deterministic_algorithms(True), strict (not warn_only),
    inside; the caller's setting restored on exit. The mode's fill of
    uninitialized memory (torch.utils.deterministic
    .fill_uninitialized_memory) is off inside: every op of the step
    writes its whole output, and the fill cost a CocoConfig B=4 step
    3,536 more launches and about 5 ms more device time on an H100
    (PERF.md section 6); chip_smoke phase 7d checks that runs repeat."""
    mode = torch.are_deterministic_algorithms_enabled()
    warn_only = torch.is_deterministic_algorithms_warn_only_enabled()
    fill = torch.utils.deterministic.fill_uninitialized_memory
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(mode, warn_only=warn_only)
        torch.utils.deterministic.fill_uninitialized_memory = fill


def _remat(fn):
    """fn recomputed in the backward pass (Config.REMAT_HEADS)."""
    return lambda *args: checkpoint(fn, *args, use_reentrant=False,
                                         preserve_rng_state=False)


def _f32(values, device) -> torch.Tensor:
    return device_tensor(values, torch.float32, device)


def compute_losses(model: MaskRCNN, generator: Optional[torch.Generator],
                   batch: Dict[str, torch.Tensor]) -> L.Losses:
    """The training forward -> the task losses.

    batch: tensors on the model's device, B images (fixed shapes):
      images [B, H, W, 3] uint8 canvas; gt_class_ids [B, G] int32
      (negative = crowd, 0 = padding); gt_boxes [B, G, 4] float32 canvas
      pixels; gt_masks [B, G, H, W] uint8 {0,1}, or gt_masks_packed
      [B, G, H, W/8] (np.packbits order, unpacked here); gt_valid [B, G]
      bool; gt_keypoints [B, G, K, 3] (y, x, v), optional: trains the
      keypoint head when Config.NUM_KEYPOINTS > 0.
    generator: the samplers' random draws (on the model's device)."""
    config = model.config
    h, w = config.IMAGE_SHAPE[:2]
    b = batch["images"].shape[0]
    dev = batch["images"].device
    if "gt_masks_packed" in batch:
        batch = dict(batch)
        batch["gt_masks"] = unpack_masks(batch.pop("gt_masks_packed"), w)

    # REMAT_HEADS: the heads' internals are recomputed in the backward pass
    rpn_fn, classify_fn, masks_fn = (model.rpn_detect, model.classify,
                                     model.predict_masks)
    kp_on = config.NUM_KEYPOINTS > 0 and "gt_keypoints" in batch
    kp_fn = model.predict_keypoints if kp_on else None
    if config.REMAT_HEADS:
        rpn_fn, classify_fn, masks_fn = (_remat(rpn_fn), _remat(classify_fn),
                                         _remat(masks_fn))
        if kp_on:
            kp_fn = _remat(kp_fn)

    x = normalize_image(batch["images"], config.MEAN_PIXEL)
    feats = model.backbone(x)
    rpn_logits, rpn_probs, rpn_bbox = rpn_fn(feats)

    anchors = model.anchors()
    rpn_tgt = rpn_targets(config, generator, anchors, batch["gt_class_ids"],
                          batch["gt_boxes"], batch["gt_valid"])
    proposals, pvalid = rpn_refine(config, anchors, rpn_probs, rpn_bbox)
    gt_boxes_norm = batch["gt_boxes"] / _f32([h, w, h, w], dev)

    stage0_iou = config.CASCADE_STAGES[0] if config.CASCADE_STAGES else 0.5
    mrn_tgt = mrn_targets(config, generator, proposals, pvalid,
                          batch["gt_class_ids"], gt_boxes_norm,
                          batch["gt_masks"], batch["gt_valid"],
                          pos_iou=stage0_iou)

    # Cascade R-CNN (CASCADE_STAGES): stage 0 is the sampled head; a later
    # stage relabels the previous stage's refined boxes at its IoU with
    # std BBOX_STD_DEV / (i + 1), no re-sampling. mrn_class and mrn_box
    # are the sums over the stages.
    t = config.TRAIN_ROIS_PER_IMAGE
    stages = model.stages
    std_base = np.asarray(config.BBOX_STD_DEV, np.float32)
    rois = mrn_tgt.rois
    l_mrn_c = l_mrn_b = torch.zeros((), device=dev)
    tgt = mrn_tgt
    for i in range(stages):
        cls_fn = classify_fn if i == 0 else (
            lambda pooled, i=i: model.classify_stage(pooled, i))
        if i > 0 and config.REMAT_HEADS:
            cls_fn = _remat(cls_fn)
        pooled = _pool_rois(feats, rois, config.POOL_SIZE, config.IMAGE_SHAPE)
        mrn_logits, mrn_probs, mrn_deltas = cls_fn(
            pooled.reshape(b * t, *pooled.shape[2:]))
        mrn_logits = mrn_logits.reshape(b, t, -1)
        mrn_deltas = mrn_deltas.reshape(b, t, config.NUM_CLASSES, 4)
        # std_base / (i + 1) as float32, an IEEE division on the host
        std = _f32(std_base / np.float32(i + 1), dev)
        if i > 0:
            tgt = cascade_targets(config, rois, mrn_tgt.valid,
                                  batch["gt_class_ids"], gt_boxes_norm,
                                  batch["gt_valid"],
                                  config.CASCADE_STAGES[i], std)
        l_mrn_c = l_mrn_c + L.mrn_class_loss(tgt.class_ids, mrn_logits,
                                             tgt.valid)
        l_mrn_b = l_mrn_b + L.mrn_box_loss(tgt.class_ids, tgt.deltas,
                                           mrn_deltas, tgt.positive)
        if i < stages - 1:
            with torch.no_grad():
                probs = mrn_probs.reshape(b, t, -1)
                fg = torch.argmax(probs[..., 1:], dim=-1) + 1       # [B, T]
                sel = torch.gather(mrn_deltas, 2, fg[..., None, None].expand(
                    -1, -1, 1, 4))[:, :, 0]
                nxt = box_ops.refine_boxes(rois, sel * std)
                nxt = box_ops.clip_boxes(nxt, (0.0, 0.0, 1.0, 1.0))
                rois = torch.where(mrn_tgt.valid[..., None], nxt, 0.0)

    # The mask head's RoIs: stage 0's samples; with CASCADE_MASK_LAST
    # (Cascade Mask R-CNN's mask at the last stage) the last stage's boxes
    # and labels, with the mask targets cropped anew at those boxes.
    mask_rois, mask_masks = mrn_tgt.rois, mrn_tgt.masks
    mask_cls, mask_pos = mrn_tgt.class_ids, mrn_tgt.positive
    if stages > 1 and config.CASCADE_MASK_LAST:
        with torch.no_grad():
            crops = _crop_gt_masks(batch["gt_masks"], rois, tgt.assignment,
                                   config.MASK_SHAPE[0])
            mask_masks = torch.where(tgt.positive[..., None, None],
                                     torch.round(crops), 0.0)
        mask_rois, mask_cls, mask_pos = rois, tgt.class_ids, tgt.positive

    pooled_m = _pool_rois(feats, mask_rois, config.MASK_POOL_SIZE,
                          config.IMAGE_SHAPE)
    pred_masks = masks_fn(pooled_m.reshape(b * t, *pooled_m.shape[2:]))
    pred_masks = pred_masks.reshape(b, t, *pred_masks.shape[1:])

    l_rpn_c = L.rpn_class_loss(rpn_tgt.rpn_match, rpn_logits)
    l_rpn_b = L.rpn_box_loss(rpn_tgt.rpn_bbox, rpn_tgt.rpn_match, rpn_bbox)
    l_mask = L.mask_loss(mask_cls, mask_masks, pred_masks, mask_pos)

    # The keypoint task shares the mask head's pooled RoIs. Only positive
    # RoIs carry keypoint targets and mrn_targets packs them into the first
    # p_cap slots, so the head runs on that prefix; with CASCADE_MASK_LAST
    # the mask RoIs are the last stage's, so it pools stage 0's prefix.
    l_kp = torch.zeros((), device=dev)
    if kp_on:
        p_cap = int(t * config.ROI_POSITIVE_RATIO)
        if mask_rois is mrn_tgt.rois:
            pooled_kp = pooled_m[:, :p_cap]
        else:
            pooled_kp = _pool_rois(feats, mrn_tgt.rois[:, :p_cap],
                                   config.MASK_POOL_SIZE, config.IMAGE_SHAPE)
        kp_logits = kp_fn(pooled_kp.reshape(b * p_cap, *pooled_kp.shape[2:]))
        if tuple(kp_logits.shape[1:3]) != tuple(config.KEYPOINT_SHAPE):
            raise ValueError(f"KEYPOINT_SHAPE {config.KEYPOINT_SHAPE} != the "
                             f"head's output {tuple(kp_logits.shape[1:3])} "
                             "(4 * MASK_POOL_SIZE)")
        kp_logits = kp_logits.reshape(b, p_cap, *kp_logits.shape[1:])
        kp_pos, kp_valid = keypoint_targets(
            config, mrn_tgt.rois[:, :p_cap], mrn_tgt.gt_assignment[:, :p_cap],
            mrn_tgt.positive[:, :p_cap], batch["gt_keypoints"])
        l_kp = L.keypoint_loss(kp_pos, kp_valid, kp_logits)

    total = l_rpn_c + l_rpn_b + l_mrn_c + l_mrn_b + l_mask + l_kp
    return L.Losses(total=total, rpn_class=l_rpn_c, rpn_box=l_rpn_b,
                    mrn_class=l_mrn_c, mrn_box=l_mrn_b, mrn_mask=l_mask,
                    mrn_kp=l_kp)


class SGD:
    """SGD with momentum, weight decay and the global-norm clip, in the
    optax chain of the JAX package (make_optimizer):

        clip:     g <- where(norm < 5, g, g / norm * 5), norm the global
                  L2 norm of the gradients (optax.clip_by_global_norm;
                  torch's clip_grad_norm_ adds 1e-6 and differs)
        decay:    u <- g + WEIGHT_DECAY * p      (the decay parameters)
        momentum: t <- u + LEARNING_MOMENTUM * t (stored in
                  OPT_MOMENTUM_DTYPE), u <- t
        step:     p <- p + u * (-lr)

    `params` are the trainable parameters (float32): a frozen parameter
    is not one of them and gets no gradient, as the JAX step zeroes a
    frozen gradient before the clip (a zero adds nothing to the norm and
    its update is zero). `step` counts the finite steps, on the device."""

    def __init__(self, config, learning_rate: float,
                 params: List[torch.nn.Parameter], decay: List[bool]):
        if len(params) != len(decay):
            raise ValueError("SGD: one decay flag a parameter")
        self.params = list(params)
        self.decay = list(decay)
        self.learning_rate = learning_rate
        self.momentum = config.LEARNING_MOMENTUM
        self.weight_decay = config.WEIGHT_DECAY
        acc = getattr(torch, config.OPT_MOMENTUM_DTYPE)
        self.trace = [torch.zeros_like(p, dtype=acc) for p in self.params]
        device = self.params[0].device if self.params else "cpu"
        self.step = torch.zeros((), dtype=torch.int32, device=device)

    @torch.no_grad()
    def update(self, grads: List[torch.Tensor], ok: torch.Tensor) -> None:
        """Apply one step of `grads` (float32, one a parameter) where `ok`
        (a 0-d bool tensor) holds; elsewhere keep the parameters, the
        momentum and the step count."""
        if not self.params:
            self.step += ok.to(torch.int32)
            return
        dev = self.params[0].device
        norm = torch.linalg.vector_norm(torch.stack(
            torch._foreach_norm(grads)))
        trigger = norm < CLIP_NORM
        # where(trigger, g, g / norm * 5) as g / div * mul: exactly g where
        # the trigger holds
        one = torch.ones((), device=dev)
        div = torch.where(trigger, one, norm)
        mul = torch.where(trigger, one, _f32(CLIP_NORM, dev))
        u = list(torch._foreach_div(grads, div))
        torch._foreach_mul_(u, mul)
        decayed = [i for i, d in enumerate(self.decay) if d]
        if decayed and self.weight_decay:
            wp = torch._foreach_mul([self.params[i] for i in decayed],
                                    self.weight_decay)
            for i, v in zip(decayed, wp):
                u[i] = u[i] + v
        # momentum * t in the trace's dtype (a bf16 trace multiplies in
        # bf16, as optax's weakly typed scalar does), then the sum in float32
        t = torch._foreach_mul(self.trace, self.momentum)
        t = torch._foreach_add(u, [x.to(torch.float32) for x in t])
        step = torch._foreach_mul(t, -self.learning_rate)
        new = torch._foreach_add(self.params, step)
        for p, n, tr, tn in zip(self.params, new, self.trace, t):
            torch.where(ok, n, p, out=p)
            torch.where(ok, tn.to(tr.dtype), tr, out=tr)
        self.step += ok.to(torch.int32)


def make_optimizer(config, learning_rate: float, params: List[torch.nn.Parameter],
                   decay: List[bool]) -> SGD:
    """A fresh SGD (momentum reset): one a training stage, as the
    reference's new optim.SGD a train_model call (model.py:1550)."""
    return SGD(config, learning_rate, params, decay)


def split_accum(batch: Dict[str, Any], accum: int) -> Dict[str, Any]:
    """A batch for GRAD_ACCUM_STEPS: every leaf [B, ...] ->
    [accum, B // accum, ...] (numpy arrays or tensors)."""
    if accum <= 1:
        return batch
    out = {}
    for k, v in batch.items():
        if v.shape[0] % accum:
            raise ValueError(f"batch dim {v.shape[0]} not divisible by "
                             f"GRAD_ACCUM_STEPS={accum}")
        out[k] = v.reshape(accum, v.shape[0] // accum, *v.shape[1:])
    return out


def _grads(total: torch.Tensor, params: List[torch.Tensor]):
    """d total / d params, zeros for a parameter the loss does not reach
    (as the JAX gradient's)."""
    if not params:
        return []
    grads = torch.autograd.grad(total, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for g, p in zip(grads, params)]


def compute_losses_dp(model: MaskRCNN, generator: Optional[torch.Generator],
                      batch: Dict[str, torch.Tensor], dp=None) -> L.Losses:
    """`compute_losses` under data parallelism (`dp` a
    parallel.DataParallel, or None for one process): each loss a mean
    over the global batch, returned all-reduced (the validation losses,
    the counterpart of make_parallel_eval_losses)."""
    if dp is None:
        return compute_losses(model, generator, batch)
    with dp.global_means():
        losses = compute_losses(model, generator, batch)
    return dp.sum_losses(losses)


def train_step(model: MaskRCNN, optimizer: SGD,
               batch: Dict[str, torch.Tensor],
               generator: Optional[torch.Generator],
               dp=None) -> Dict[str, torch.Tensor]:
    """One SGD step on the device; returns the losses (0-d device tensors).

    Under GRAD_ACCUM_STEPS = A > 1 the batch's leaves are [A, B / A, ...]
    (`split_accum`): the gradients and losses are the means over the A
    micro-batches. A non-finite total keeps the parameters, the momentum
    and the step count (decided on the device).

    dp (a parallel.DataParallel): `batch` is this rank's slice; the
    losses are means over the global batch (their denominators
    all-reduced), and the gradients and losses are all-reduced (SUM)
    before the update, so every rank applies the same global step. Under
    SP_DEVICES (the model's `spatial` transport) the heads' gradients,
    alike on an sp group's ranks, are divided by SP_DEVICES first.

    The step runs under `deterministic()`."""
    with deterministic():
        with (dp.global_means() if dp is not None
              else contextlib.nullcontext()):
            grads, losses = _step_grads(model, optimizer, batch, generator)
        if dp is not None:
            shared = None
            if model.spatial is not None:
                # the parameters after the spatial gather: alike on the
                # group
                upstream = {id(p) for p in model.fpn.parameters()}
                shared = [id(p) not in upstream for p in optimizer.params]
            grads = dp.sum_grads(grads, shared)
            losses = dp.sum_losses(losses)
        optimizer.update(grads, torch.isfinite(losses.total))
    return losses.as_dict()


def _step_grads(model: MaskRCNN, optimizer: SGD,
                batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator]):
    """This process's (gradients, detached losses) of a step."""
    params = optimizer.params
    accum = model.config.GRAD_ACCUM_STEPS
    if accum > 1:
        dev = batch["images"].device
        gsum = lsum = None
        for i in range(accum):
            losses = compute_losses(model, generator,
                                    {k: v[i] for k, v in batch.items()})
            grads = _grads(losses.total, params)
            if gsum is None:
                gsum, lsum = grads, [v.detach() for v in losses]
            else:
                torch._foreach_add_(gsum, grads)
                lsum = [a + v.detach() for a, v in zip(lsum, losses)]
        # a division by a tensor (on CUDA a Python divisor is a
        # reciprocal multiply)
        a = _f32(float(accum), dev)
        grads = torch._foreach_div(gsum, a) if gsum else []
        losses = L.Losses(*[v / a for v in lsum])
    else:
        losses = compute_losses(model, generator, batch)
        grads = _grads(losses.total, params)
        losses = L.Losses(*[v.detach() for v in losses])
    return grads, losses
