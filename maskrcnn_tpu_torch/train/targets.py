"""Training target samplers on the device, batched over images
(counterpart of maskrcnn_tpu/train/targets.py).

* `rpn_targets` <- the reference's rpn_samples (data.py:449-591);
* `mrn_targets` <- mrn_samples (model.py:396-576);
* `cascade_targets`, `keypoint_targets`: the JAX package's cascade
  relabeling and keypoint heatmap targets.

Every shape is fixed by the config and nothing reads a value on the host:
the reference's dynamic positive and negative lists are fixed slots and
masks, as in the JAX package, with a batch dimension in front. Random
subsampling keeps a uniformly random subset of at most `limit` eligible
entries (`_random_keep`), drawn from an explicit `torch.Generator`; the
draws differ from JAX's threefry stream, so the samplers equal the JAX
package's where no cap binds. The packings sort with `stable=True` on
distinct keys, which gives the order of the JAX package's top_k and
argsort. Targets carry no gradient.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch

from maskrcnn_tpu_torch.config import Config
from maskrcnn_tpu_torch.ops import boxes as box_ops
from maskrcnn_tpu_torch.ops import device_tensor
from maskrcnn_tpu_torch.ops.roi_align import indexed_crop_and_resize


def _masked_iou(boxes1: torch.Tensor, boxes2: torch.Tensor,
                valid2: torch.Tensor) -> torch.Tensor:
    """IoU [B, M, G] with invalid columns 0 (padded gt are zero boxes,
    whose IoU is 0/0)."""
    iou = torch.nan_to_num(box_ops.box_iou(boxes1, boxes2), nan=0.0)
    return torch.where(valid2[:, None, :], iou, 0.0)


def _row_max(x: torch.Tensor) -> torch.Tensor:
    """max over the last axis with an initial 0 (jnp.max(initial=0.0))."""
    return torch.clamp_min(x.amax(dim=-1), 0.0)


def _random_keep(generator: Optional[torch.Generator],
                 eligible: torch.Tensor,
                 limit: Union[int, torch.Tensor]) -> torch.Tensor:
    """Keep at most `limit` (an int, or a [B] tensor) of each row's
    eligible entries, uniformly at random: a random priority an entry,
    ineligible entries last, the first `limit` of a stable sort
    (np.random.choice without replacement of the surplus, data.py:544-557;
    randperm subsampling, model.py:468-472)."""
    priority = torch.rand(eligible.shape, generator=generator,
                          device=eligible.device)
    priority = torch.where(eligible, priority, 2.0)
    order = torch.sort(priority, dim=-1, stable=True).indices
    n = eligible.shape[-1]
    rank = torch.empty_like(order).scatter_(
        -1, order, torch.arange(n, device=order.device).expand_as(order))
    if torch.is_tensor(limit):
        limit = limit[:, None]
    return eligible & (rank < limit)


def _first(keep: torch.Tensor, count: int) -> torch.Tensor:
    """Indices [B, count]: the kept entries in index order, then the
    others (argsort of where(keep, idx, n + idx))."""
    n = keep.shape[-1]
    idx = torch.arange(n, device=keep.device)
    key = torch.where(keep, idx, n + idx)
    return torch.sort(key, dim=-1, stable=True).indices[:, :count]


def _take(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """t [B, N, ...] gathered along dim 1 at idx [B, M]."""
    return torch.gather(t, 1, idx.reshape(idx.shape + (1,) * (t.dim() - 2))
                        .expand(idx.shape + t.shape[2:]))


def _std(values, device) -> torch.Tensor:
    return device_tensor(values, torch.float32, device)


class RPNTargets(NamedTuple):
    rpn_match: torch.Tensor  # [B, A] int32: 1 pos, -1 neg, 0 neutral
    rpn_bbox: torch.Tensor   # [B, RPN_TRAIN_ANCHORS_PER_IMAGE, 4] float32


@torch.no_grad()
def rpn_targets(config: Config, generator: Optional[torch.Generator],
                anchors: torch.Tensor, gt_class_ids: torch.Tensor,
                gt_boxes: torch.Tensor, gt_valid: torch.Tensor) -> RPNTargets:
    """RPN match and delta targets (reference data.py:449-591).

    anchors [A, 4] pixels; gt_class_ids [B, G] (negative = crowd);
    gt_boxes [B, G, 4] pixels; gt_valid [B, G] bool."""
    b, a = gt_class_ids.shape[0], anchors.shape[0]
    dev = anchors.device
    is_crowd = (gt_class_ids < 0) & gt_valid
    is_instance = (gt_class_ids > 0) & gt_valid

    # one [B, A, G] IoU matrix, masked two ways (crowd exclusion,
    # data.py:496-509, and instance matching)
    raw_iou = torch.nan_to_num(box_ops.box_iou(anchors[None], gt_boxes),
                               nan=0.0)
    no_crowd = _row_max(torch.where(is_crowd[:, None, :], raw_iou,
                                    0.0)) < 0.001
    overlaps = torch.where(is_instance[:, None, :], raw_iou, 0.0)
    anchor_iou_max = _row_max(overlaps)
    anchor_iou_argmax = torch.argmax(
        torch.where(is_instance[:, None, :], overlaps, -1.0), dim=2)

    match = torch.zeros((b, a), dtype=torch.int32, device=dev)
    # 1. negatives (data.py:532)
    match = torch.where((anchor_iou_max < 0.3) & no_crowd, -1, match)
    # 2. each gt's best anchor is positive whatever its IoU (data.py:536);
    # a scatter-max, so a padded gt never clears a real gt's bit
    gt_best_anchor = torch.argmax(overlaps, dim=1)              # [B, G]
    forced = torch.zeros((b, a), dtype=torch.int32, device=dev).scatter_reduce(
        1, gt_best_anchor, is_instance.to(torch.int32), "amax")
    match = torch.where(forced > 0, 1, match)
    # 3. high-IoU positives (data.py:540)
    match = torch.where(anchor_iou_max >= 0.7, 1, match)

    # subsample (data.py:544-557): at most half positive, a fixed budget
    t = config.RPN_TRAIN_ANCHORS_PER_IMAGE
    pos = _random_keep(generator, match == 1, t // 2)
    n_pos = pos.sum(dim=1)
    neg = _random_keep(generator, match == -1, t - n_pos)
    match = torch.where(pos, 1, torch.where(neg, -1, 0)).to(torch.int32)

    # deltas of the positives, packed in anchor order (data.py:561-589)
    packed = _first(pos, t)
    packed_valid = torch.gather(pos, 1, packed)
    tgt = _take(gt_boxes, torch.gather(anchor_iou_argmax, 1, packed))
    deltas = box_ops.box_deltas(anchors[packed], tgt)
    deltas = deltas / _std(config.RPN_BBOX_STD_DEV, dev)
    deltas = torch.where(packed_valid[..., None], deltas, 0.0)
    return RPNTargets(rpn_match=match, rpn_bbox=deltas)


class MRNTargets(NamedTuple):
    rois: torch.Tensor           # [B, T, 4] normalized
    class_ids: torch.Tensor      # [B, T] int32 (0 for negative and pad)
    deltas: torch.Tensor         # [B, T, 4] float32 (positives only)
    masks: torch.Tensor          # [B, T, 28, 28] float32 0/1
    valid: torch.Tensor          # [B, T] bool: a real RoI (pos or neg)
    positive: torch.Tensor       # [B, T] bool
    gt_assignment: torch.Tensor  # [B, T] int32 matched gt (pos only)


def _nan_to_zero(x: torch.Tensor) -> torch.Tensor:
    return torch.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0)


def _crop_gt_masks(gt_masks: torch.Tensor, rois: torch.Tensor,
                   assignment: torch.Tensor, size: int) -> torch.Tensor:
    """Each RoI's assigned gt mask cropped at the RoI to size x size:
    gt_masks [B, G, H, W], rois [B, T, 4], assignment [B, T] ->
    [B, T, size, size] float32 (reference model.py:494-507)."""
    b, g, h, w = gt_masks.shape
    t = rois.shape[1]
    image = (torch.arange(b, device=rois.device)[:, None] * g
             + assignment.long())
    crops = indexed_crop_and_resize(gt_masks.reshape(b * g, h, w, 1),
                                    rois.reshape(b * t, 4),
                                    image.reshape(-1), size)
    return crops[..., 0].reshape(b, t, size, size)


@torch.no_grad()
def mrn_targets(config: Config, generator: Optional[torch.Generator],
                proposals: torch.Tensor, proposal_valid: torch.Tensor,
                gt_class_ids: torch.Tensor, gt_boxes: torch.Tensor,
                gt_masks: torch.Tensor, gt_valid: torch.Tensor,
                pos_iou: float = 0.5) -> MRNTargets:
    """Head targets (reference model.py:396-576 mrn_samples).

    proposals [B, R, 4] normalized; proposal_valid [B, R]; gt_boxes
    [B, G, 4] normalized; gt_masks [B, G, H, W] (uint8 or float 0/1);
    gt_class_ids [B, G] (negative = crowd). Slots 0..P-1 hold positives
    (P = TRAIN_ROIS_PER_IMAGE * ROI_POSITIVE_RATIO), the rest negatives,
    as the reference concatenates them (model.py:532-533)."""
    b, r = proposals.shape[:2]
    dev = proposals.device
    t = config.TRAIN_ROIS_PER_IMAGE
    p_cap = int(t * config.ROI_POSITIVE_RATIO)
    mh, mw = config.MASK_SHAPE
    is_crowd = (gt_class_ids < 0) & gt_valid
    is_instance = (gt_class_ids > 0) & gt_valid

    no_crowd = _row_max(_masked_iou(proposals, gt_boxes, is_crowd)) < 0.001
    overlaps = _masked_iou(proposals, gt_boxes, is_instance)     # [B, R, G]
    roi_iou_max = _row_max(overlaps)

    pos_bool = (roi_iou_max >= pos_iou) & proposal_valid
    pos_keep = _random_keep(generator, pos_bool, p_cap)
    n_pos = pos_keep.sum(dim=1)
    # negative budget r * pos - pos with r = 1 / ratio (model.py:518-519),
    # a float32 division by a tensor
    ratio = _std(config.ROI_POSITIVE_RATIO, dev)
    n_neg = torch.floor(n_pos.to(torch.float32) / ratio).to(torch.int64) - n_pos
    n_neg = torch.where(n_pos > 0, n_neg, 0)   # model.py:516 needs pos > 0
    n_neg = torch.clamp_max(n_neg, t - p_cap)
    neg_bool = (roi_iou_max < pos_iou) & no_crowd & proposal_valid
    neg_keep = _random_keep(generator, neg_bool, n_neg)

    pos_packed = _first(pos_keep, p_cap)
    neg_packed = _first(neg_keep, t - p_cap)
    pos_valid = torch.gather(pos_keep, 1, pos_packed)
    neg_valid = torch.gather(neg_keep, 1, neg_packed)
    pos_rois = _take(proposals, pos_packed)

    rois = torch.cat([pos_rois, _take(proposals, neg_packed)], dim=1)
    valid = torch.cat([pos_valid, neg_valid], dim=1)
    positive = torch.cat([pos_valid, torch.zeros_like(neg_valid)], dim=1)
    rois = torch.where(valid[..., None], rois, 0.0)

    # gt assignment of the positives (model.py:476-480)
    assignment = torch.argmax(
        torch.where(is_instance[:, None, :], overlaps, -1.0), dim=2)
    pos_assignment = torch.gather(assignment, 1, pos_packed)
    zeros_t = torch.zeros((b, t - p_cap), dtype=torch.int32, device=dev)
    class_ids = torch.where(pos_valid,
                            torch.gather(gt_class_ids, 1, pos_assignment), 0)
    class_ids = torch.cat([class_ids.to(torch.int32), zeros_t], dim=1)

    deltas = box_ops.box_deltas(pos_rois, _take(gt_boxes, pos_assignment))
    deltas = deltas / _std(config.BBOX_STD_DEV, dev)
    deltas = torch.where(pos_valid[..., None], _nan_to_zero(deltas), 0.0)
    deltas = torch.cat([deltas, deltas.new_zeros(b, t - p_cap, 4)], dim=1)

    # mask targets: each positive's gt mask cropped at the RoI to
    # MASK_SHAPE and rounded to 0/1 (model.py:494-507)
    masks = torch.round(_crop_gt_masks(gt_masks, pos_rois, pos_assignment,
                                       mh))
    masks = torch.where(pos_valid[..., None, None], masks, 0.0)
    masks = torch.cat([masks, masks.new_zeros(b, t - p_cap, mh, mw)], dim=1)

    gt_assignment = torch.cat(
        [torch.where(pos_valid, pos_assignment, 0).to(torch.int32), zeros_t],
        dim=1)
    return MRNTargets(rois=rois, class_ids=class_ids, deltas=deltas,
                      masks=masks, valid=valid, positive=positive,
                      gt_assignment=gt_assignment)


class CascadeTargets(NamedTuple):
    class_ids: torch.Tensor   # [B, T] int32 (0 = background)
    deltas: torch.Tensor      # [B, T, 4] float32 (positives only)
    valid: torch.Tensor       # [B, T] bool: in the class loss
    positive: torch.Tensor    # [B, T] bool: in the box loss
    assignment: torch.Tensor  # [B, T] int32 matched gt (pos only)


@torch.no_grad()
def cascade_targets(config: Config, rois: torch.Tensor,
                    roi_valid: torch.Tensor, gt_class_ids: torch.Tensor,
                    gt_boxes: torch.Tensor, gt_valid: torch.Tensor,
                    pos_iou: float, std: torch.Tensor) -> CascadeTargets:
    """Relabeling for a cascade stage > 0 (Cai & Vasconcelos 2018; the
    reference has no cascade): every carried RoI [B, T, 4] (the previous
    stage's refined boxes) is labeled at the stage's IoU threshold, no
    re-sampling; std [4]: this stage's delta normalization."""
    is_crowd = (gt_class_ids < 0) & gt_valid
    is_instance = (gt_class_ids > 0) & gt_valid
    no_crowd = _row_max(_masked_iou(rois, gt_boxes, is_crowd)) < 0.001
    overlaps = _masked_iou(rois, gt_boxes, is_instance)
    roi_iou_max = _row_max(overlaps)
    assignment = torch.argmax(
        torch.where(is_instance[:, None, :], overlaps, -1.0), dim=2)

    positive = (roi_iou_max >= pos_iou) & roi_valid
    # negatives keep the crowd exclusion of the stage-0 sampler
    valid = roi_valid & (positive | no_crowd)
    class_ids = torch.where(positive, torch.gather(gt_class_ids, 1,
                                                   assignment), 0)
    deltas = box_ops.box_deltas(rois, _take(gt_boxes, assignment)) / std
    deltas = torch.where(positive[..., None], _nan_to_zero(deltas), 0.0)
    return CascadeTargets(
        class_ids=class_ids.to(torch.int32), deltas=deltas, valid=valid,
        positive=positive,
        assignment=torch.where(positive, assignment, 0).to(torch.int32))


@torch.no_grad()
def keypoint_targets(config: Config, rois: torch.Tensor,
                     gt_assignment: torch.Tensor, positive: torch.Tensor,
                     gt_keypoints: torch.Tensor):
    """Keypoint heatmap targets (the Mask R-CNN paper's pose task;
    Detectron's keypoint loss semantics).

    rois [B, T, 4] normalized; gt_assignment, positive [B, T];
    gt_keypoints [B, G, K, 3] (y, x, v) in canvas pixels, v the COCO
    visibility (0 unlabeled, 1 occluded, 2 visible; both labeled states
    train). Returns (kp_pos [B, T, K] int32, the flattened heatmap index,
    kp_valid [B, T, K] bool): a keypoint trains iff its RoI is positive,
    it is labeled, and it lands inside the RoI."""
    hh, hw = config.KEYPOINT_SHAPE
    h, w = config.IMAGE_SHAPE[:2]
    dev = rois.device
    kp = _take(gt_keypoints, gt_assignment.long())          # [B, T, K, 3]
    scale = _std([h, w, h, w], dev)
    y1, x1, y2, x2 = (rois * scale).unbind(-1)              # pixels
    eps = _std(1e-6, dev)
    bh = torch.maximum(y2 - y1, eps)[..., None]
    bw = torch.maximum(x2 - x1, eps)[..., None]
    fy = (kp[..., 0] - y1[..., None]) / bh                  # [B, T, K]
    fx = (kp[..., 1] - x1[..., None]) / bw
    iy = torch.floor(fy * hh).to(torch.int32)
    ix = torch.floor(fx * hw).to(torch.int32)
    inside = (fy >= 0.0) & (fy < 1.0) & (fx >= 0.0) & (fx < 1.0)
    valid = (positive[..., None] & (kp[..., 2] > 0) & inside
             & ((y2 - y1) > 0)[..., None] & ((x2 - x1) > 0)[..., None])
    pos = torch.clamp(iy, 0, hh - 1) * hw + torch.clamp(ix, 0, hw - 1)
    return torch.where(valid, pos, 0).to(torch.int32), valid
