"""Batched end-to-end inference (counterpart of
maskrcnn_tpu/detection/pipeline.py).

normalize -> ResNet-FPN -> fused RPN -> proposals (top-k, decode, clip,
NMS 0.7, compact) -> RoIAlign 7x7 -> box head -> detections (class pick,
decode, round, class-offset NMS 0.3, top D) -> RoIAlign 14x14 -> mask
head -> class-channel select -> paste + bit-pack.

The JAX package's inference protocols, each computing what it computes:
* Config.CASCADE_STAGES: the box head runs once a stage, each stage's
  RoIAlign on the boxes the previous stage refined, and the detections
  take the stage-averaged probabilities (`detect_boxes`);
* Config.DETECTION_SOFT_NMS_SIGMA: Gaussian soft-NMS in place of the
  detections' hard NMS (`mrn_refine`, `merge_detections`);
* Config.TTA_HFLIP: the box pipeline on the canvas and on its mirror,
  merged with box fusion (`detect_and_pool_masks_tta`);
* Config.NUM_KEYPOINTS: the keypoint head on the mask head's pooled
  features of the first KEYPOINT_MAX_INSTANCES slots (`predict_step`);
* Config.IMAGE_CANVAS: every op reads the canvas (H, W) from IMAGE_SHAPE.

Every shape is fixed by the config and nothing waits on the host: no
`.item()`, no copy to the CPU, no branch on tensor values. Dynamic-length
results are padded tensors with validity masks, as in the JAX package.
On CUDA tensors RoIAlign, NMS and the paste-and-pack run the port's
kernels (and, under FOLD_BN, the backbone's identity blocks). Under
QUANT_INT8 the model's int8 routes run the backbone, RPN and mask head,
and both RoIAligns read int8 tables (QUANT_INT8_ROI).

Tie order follows JAX: `lax.top_k` and `jnp.argsort` put equal keys in
index order, so every sort here is `stable=True` (torch.topk's tie order
is unspecified). Sigmoid RPN scores saturate under random weights, so
ties are common.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Sequence

import numpy as np
import torch

from maskrcnn_tpu_torch.config import Config
from maskrcnn_tpu_torch.models.mask_rcnn import MaskRCNN
from maskrcnn_tpu_torch.ops import boxes as box_ops
from maskrcnn_tpu_torch.ops import device_tensor, ieee_float32
from maskrcnn_tpu_torch.ops.image import normalize_image
from maskrcnn_tpu_torch.ops.int8_conv import quantize_tensor
from maskrcnn_tpu_torch.quant import Scale, roi_scales
from maskrcnn_tpu_torch.ops.mask_paste import paste_masks_packed
from maskrcnn_tpu_torch.ops.nms import (_iou_plus_one, multiclass_nms_mask,
                                        nms_mask_impl, soft_nms_scores)
from maskrcnn_tpu_torch.ops.roi_align import multilevel_roi_align_impl


class Detections(NamedTuple):
    """Per-image detections, padded to DETECTION_MAX_INSTANCES: [B, D]."""

    class_ids: torch.Tensor   # int32, 0 = padding
    scores: torch.Tensor      # float32
    boxes: torch.Tensor       # [B, D, 4] float32, integral pixel coords
    valid: torch.Tensor       # bool


def _f32(values, device) -> torch.Tensor:
    return device_tensor(values, torch.float32, device)


def _compact(keep: torch.Tensor, count: int) -> torch.Tensor:
    """Indices [B, count] that move the kept rows (already in score order)
    to the front, then the others, each in index order."""
    k = keep.shape[-1]
    idx = torch.arange(k, device=keep.device)
    rank = torch.where(keep, idx, k + idx)
    return torch.sort(rank, dim=-1, stable=True).indices[:, :count]


def rpn_candidates(config: Config, anchors: torch.Tensor,
                   scores: torch.Tensor, rpn_bbox: torch.Tensor
                   ) -> torch.Tensor:
    """Pre-NMS proposal boxes [B, k, 4] in pixels, score-descending: top-k
    (k = PRE_NMS_LIMIT), decode, clip to the canvas.

    anchors [A, 4]; scores [B, A] float32; rpn_bbox [B, A, 4] in the
    compute dtype (only the k survivors are cast to float32)."""
    k = config.PRE_NMS_LIMIT
    order = torch.sort(scores, dim=1, descending=True,
                       stable=True).indices[:, :k]
    deltas = torch.gather(rpn_bbox, 1, order[..., None].expand(-1, -1, 4))
    deltas = deltas.to(torch.float32) * _f32(config.RPN_BBOX_STD_DEV,
                                             scores.device)
    boxes = box_ops.refine_boxes(anchors[order], deltas)
    h, w = config.IMAGE_SHAPE[:2]
    return box_ops.clip_boxes(boxes, (0.0, 0.0, float(h), float(w)))


def rpn_refine_scores(config: Config, anchors: torch.Tensor,
                      scores: torch.Tensor, rpn_bbox: torch.Tensor):
    """Proposal layer (reference model.py:1307-1382), batched.

    Returns (proposals [B, R, 4] normalized, valid [B, R] bool),
    R = RPN_NMS_MAX_ROIS_NUM."""
    boxes = rpn_candidates(config, anchors, scores, rpn_bbox)
    b, k = boxes.shape[:2]
    keep = nms_mask_impl(boxes, torch.ones((b, k), dtype=torch.bool,
                                           device=boxes.device),
                         config.RPN_NMS_THRESHOLD)
    r = config.RPN_NMS_MAX_ROIS_NUM
    take = _compact(keep, r)
    valid = torch.gather(keep, 1, take)
    h, w = config.IMAGE_SHAPE[:2]
    picked = torch.gather(boxes, 1, take[..., None].expand(-1, -1, 4))
    proposals = torch.where(valid[..., None],
                            picked / _f32([h, w, h, w], boxes.device), 0.0)
    if r > k:
        proposals = torch.cat([proposals, proposals.new_zeros(b, r - k, 4)],
                              dim=1)
        valid = torch.cat([valid, valid.new_zeros(b, r - k)], dim=1)
    return proposals, valid


@torch.no_grad()
def rpn_refine(config: Config, anchors: torch.Tensor, rpn_probs: torch.Tensor,
               rpn_bbox: torch.Tensor):
    """The proposal layer on the training RPN's outputs (the JAX
    rpn_refine): rpn_probs [B, A, 2] softmax, rpn_bbox [B, A, 4]; the
    foreground column through `rpn_refine_scores` (its NMS is K2 on the
    card). No gradient: proposals are constants of the step."""
    return rpn_refine_scores(config, anchors, rpn_probs[..., 1], rpn_bbox)


def _take(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """t [B, N, ...] gathered along dim 1 at idx [B, M]."""
    return torch.gather(t, 1, idx.reshape(idx.shape + (1,) * (t.dim() - 2))
                        .expand(idx.shape + t.shape[2:]))


def _detections(take: torch.Tensor, keep: torch.Tensor,
                class_ids: torch.Tensor, scores: torch.Tensor,
                boxes: torch.Tensor) -> Detections:
    """Detections of the candidate rows `take` [B, D] of [B, N] rows;
    rows whose `keep` is False are zeroed."""
    valid = torch.gather(keep, 1, take)
    return Detections(
        class_ids=torch.where(valid, torch.gather(class_ids, 1, take),
                              0).to(torch.int32),
        scores=torch.where(valid, torch.gather(scores, 1, take), 0.0),
        boxes=torch.where(valid[..., None], _take(boxes, take), 0.0),
        valid=valid)


def _select(config: Config, boxes: torch.Tensor, class_ids: torch.Tensor,
            keep: torch.Tensor, scores: torch.Tensor) -> Detections:
    """Candidates [B, N] -> D detection slots: a stable sort by score
    (rows not kept at -1), the class-offset NMS (classes moved apart by
    max(h, w) + 2) and the kept rows moved to the front in order.

    Under DETECTION_SOFT_NMS_SIGMA the NMS is Gaussian soft-NMS: D
    select-and-decay steps, the decayed scores floored at
    max(DETECTION_MIN_CONFIDENCE, 1e-3), then a stable re-sort (the JAX
    package's soft branch)."""
    h, w = config.IMAGE_SHAPE[:2]
    d = config.DETECTION_MAX_INSTANCES
    masked = torch.where(keep, scores, -1.0)
    order = torch.sort(-masked, dim=-1, stable=True).indices
    sboxes = _take(boxes, order)
    sclasses = torch.gather(class_ids, 1, order)
    svalid = torch.gather(keep, 1, order)
    sscores = torch.gather(masked, 1, order)
    if config.DETECTION_SOFT_NMS_SIGMA > 0:
        offset = sclasses.to(sboxes.dtype)[..., None] * (float(max(h, w))
                                                        + 2.0)
        final = soft_nms_scores(sboxes + offset,
                                torch.clamp_min(sscores, 0.0), svalid,
                                config.DETECTION_SOFT_NMS_SIGMA, iters=d)
        fvalid = svalid & (final >= max(config.DETECTION_MIN_CONFIDENCE,
                                        1e-3))
        take = torch.sort(-torch.where(fvalid, final, -1.0), dim=-1,
                          stable=True).indices[:, :d]
        return _detections(take, fvalid, sclasses, final, sboxes)
    nms_keep = multiclass_nms_mask(sboxes, sclasses, svalid,
                                   config.DETECTION_NMS_THRESHOLD,
                                   coord_span=float(max(h, w)))
    return _detections(_compact(nms_keep, d), nms_keep, sclasses, sscores,
                       sboxes)


def mrn_refine(config: Config, proposals: torch.Tensor,
               proposal_valid: torch.Tensor, probs: torch.Tensor,
               deltas: torch.Tensor, windows: torch.Tensor,
               delta_std=None, round_boxes: bool = True) -> Detections:
    """Detection refinement (reference model.py:1389-1487), batched.

    proposals [B, R, 4] normalized; proposal_valid [B, R]; probs
    [B, R, K]; deltas [B, R, K, 4]; windows [B, 4] (y1, x1, y2, x2)
    pixel coords of each image's un-padded region. delta_std: the
    deltas' std (the cascade's last stage; RPN_BBOX_STD_DEV when None).
    round_boxes=False keeps sub-pixel boxes (TTA rounds after its merge).
    Under DETECTION_SOFT_NMS_SIGMA the class-offset NMS is soft-NMS."""
    class_ids = torch.argmax(probs, dim=-1)                     # [B, R]
    class_scores = torch.gather(probs, 2, class_ids[..., None])[..., 0]
    specific = torch.gather(
        deltas, 2, class_ids[..., None, None].expand(-1, -1, 1, 4))[:, :, 0]
    dev = probs.device
    # model.py:1418-1422 uses RPN_BBOX_STD_DEV here (not BBOX_STD_DEV)
    std = config.RPN_BBOX_STD_DEV if delta_std is None else delta_std
    refined = box_ops.refine_boxes(proposals, specific * _f32(std, dev))
    h, w = config.IMAGE_SHAPE[:2]
    boxes = refined * _f32([h, w, h, w], dev)
    boxes = box_ops.clip_boxes(boxes, windows[:, None, :])
    if round_boxes:
        # round before NMS (model.py:1432): a reference quirk kept for
        # parity
        boxes = torch.round(boxes)

    keep = proposal_valid & (class_ids > 0)
    if config.DETECTION_MIN_CONFIDENCE:
        keep = keep & (class_scores >= config.DETECTION_MIN_CONFIDENCE)
    # global score sort, then per-class NMS via class offsets
    return _select(config, boxes, class_ids, keep, class_scores)


def _pool_rois(feature_maps, boxes: torch.Tensor, pool_size: int,
               image_shape, quant_scales: Sequence[Scale] = None
               ) -> torch.Tensor:
    """Multilevel RoIAlign over P2..P5 (NHWC): [B, N, 4] -> [B, N, P, P, C].
    The kernel runs at every batch size on CUDA; the JAX package's
    batch-8 routing rule was a TPU measurement.

    quant_scales: the four levels' int8 scales (quant.roi_scales). The
    maps are quantized with them (the RPN's own quantization) and pooled
    as int8 tables, dequantized in the blend, out in the maps' dtype.
    Unlike the JAX package, which takes int8 tables only on its Pallas
    route (B >= 8 on a TPU, levels at least the patch window), the port
    follows QUANT_INT8_ROI alone: its one RoIAlign has no such limits."""
    levels = feature_maps[:4]
    if quant_scales is None:
        return multilevel_roi_align_impl(levels, boxes, pool_size,
                                         image_shape)
    q = [quantize_tensor(f, s.tensor).contiguous()
         for f, s in zip(levels, quant_scales)]
    return multilevel_roi_align_impl(
        q, boxes, pool_size, image_shape,
        level_scales=[s.value for s in quant_scales],
        out_dtype=levels[0].dtype)


def detect_boxes(model: MaskRCNN, images: torch.Tensor,
                 windows: torch.Tensor, round_boxes: bool = True):
    """normalize -> backbone -> RPN -> proposals -> box head (a stage at a
    time under CASCADE_STAGES) -> refine. Returns (feature maps P2..P6
    NHWC, Detections, the int8 RoI table scales or None).

    Cascade (the JAX detect_boxes' stage loop): after every stage but
    the last, each RoI moves by the deltas of its best foreground class
    at BBOX_STD_DEV / (i + 1), is clipped to the unit box and zeroed where
    invalid; the detections take the stages' mean probabilities and the
    last stage's deltas at BBOX_STD_DEV / stages (float64, then float32,
    as the JAX package computes it). Every stage's RoIAlign reads the
    int8 tables under QUANT_INT8_ROI. round_boxes: see mrn_refine."""
    config = model.config
    dev = images.device
    x = normalize_image(images, config.MEAN_PIXEL)
    feats = model.backbone(x)
    rpn_fg, rpn_bbox = model.rpn_scores(feats)
    proposals, pvalid = rpn_refine_scores(config, model.anchors(), rpn_fg,
                                          rpn_bbox)
    q_scales = roi_scales(model)
    b, r = proposals.shape[:2]
    stages = model.stages
    rois, probs_sum = proposals, None
    for i in range(stages):
        pooled = _pool_rois(feats, rois, config.POOL_SIZE,
                            config.IMAGE_SHAPE, quant_scales=q_scales)
        _, probs, deltas = model.classify_stage(
            pooled.reshape(b * r, *pooled.shape[2:]), i)
        probs = probs.reshape(b, r, -1)
        deltas = deltas.reshape(b, r, config.NUM_CLASSES, 4)
        probs_sum = probs if probs_sum is None else probs_sum + probs
        if i < stages - 1:
            fg = torch.argmax(probs[..., 1:], dim=-1) + 1        # [B, R]
            sel = torch.gather(deltas, 2, fg[..., None, None].expand(
                -1, -1, 1, 4))[:, :, 0]
            # BBOX_STD_DEV / (i + 1), a float32 constant
            std = (np.asarray(config.BBOX_STD_DEV, np.float32)
                   / np.float32(i + 1))
            rois = box_ops.refine_boxes(rois, sel * _f32(std, dev))
            rois = box_ops.clip_boxes(rois, (0.0, 0.0, 1.0, 1.0))
            rois = torch.where(pvalid[..., None], rois, 0.0)
    delta_std = None
    if stages > 1:
        # a division by a tensor: on CUDA a Python scalar's is a
        # reciprocal multiply
        probs_sum = probs_sum / _f32(float(stages), dev)
        delta_std = tuple(float(v) / stages for v in config.BBOX_STD_DEV)
    det = mrn_refine(config, rois, pvalid, probs_sum, deltas, windows,
                     delta_std=delta_std, round_boxes=round_boxes)
    return feats, det, q_scales


def _pool_mask_features(model: MaskRCNN, feats, det: Detections,
                        q_scales) -> torch.Tensor:
    """The mask-head RoIAlign on the detection boxes, normalized per axis
    (right on a rectangular canvas too)."""
    config = model.config
    h, w = config.IMAGE_SHAPE[:2]
    mask_rois = det.boxes / _f32([h, w, h, w], det.boxes.device)
    return _pool_rois(feats, mask_rois, config.MASK_POOL_SIZE,
                      config.IMAGE_SHAPE, quant_scales=q_scales)


def detect_and_pool_masks(model: MaskRCNN, images: torch.Tensor,
                          windows: torch.Tensor):
    """detect_boxes, then the mask-head RoIAlign on the detection boxes.
    Returns (Detections, pooled [B, D, 14, 14, C])."""
    feats, det, q_scales = detect_boxes(model, images, windows)
    return det, _pool_mask_features(model, feats, det, q_scales)


def flip_windows(windows: torch.Tensor, w: int) -> torch.Tensor:
    """Mirror [B, 4] (y1, x1, y2, x2) canvas windows about canvas width w."""
    return torch.stack([windows[:, 0], w - windows[:, 3],
                        windows[:, 2], w - windows[:, 1]], dim=-1)


def flip_boxes(boxes: torch.Tensor, w: int) -> torch.Tensor:
    """Mirror [..., 4] (y1, x1, y2, x2) boxes about canvas width w: x2 is
    exclusive, so columns [x1, x2) map to [w - x2, w - x1)."""
    return torch.stack([boxes[..., 0], w - boxes[..., 3],
                        boxes[..., 2], w - boxes[..., 1]], dim=-1)


def merge_detections(config: Config, a: Detections,
                     b: Detections) -> Detections:
    """Merge two detection sets [B, D] in one (un-flipped) frame: box
    fusion, then per-class NMS or soft-NMS, cut to D slots (the JAX
    merge_detections).

    With TTA_FUSION_IOU > 0 each valid detection's coordinates become the
    score-weighted mean of every valid same-class box (itself included)
    whose +1 IoU with it is at least TTA_FUSION_IOU, as one masked
    product in IEEE float32. A detection matched by none keeps its own
    coordinates, and two equal passes fuse to themselves. The union is
    then sorted by score and deduplicated by the class-offset NMS of the
    single pass (the kernel at N = 2D on the card), or by soft-NMS under
    DETECTION_SOFT_NMS_SIGMA.

    Two known compositions of this design, kept as the JAX package has
    them:
    * the intra-pass coordinate pull: the fusion runs before any NMS,
      over all same-class pairs, so two crowded same-class objects found
      by one pass with IoU >= TTA_FUSION_IOU pull toward each other, not
      only a flip pair;
    * soft-NMS's double decay: under TTA the scores entering the merge
      were already decayed by each pass's soft-NMS, so near pairs of one
      pass decay a second time here; merged scores are not on the scale
      of single-pass soft-NMS scores."""
    h, w = config.IMAGE_SHAPE[:2]
    boxes = torch.cat([a.boxes, b.boxes], dim=1)
    scores = torch.cat([a.scores, b.scores], dim=1)
    class_ids = torch.cat([a.class_ids, b.class_ids], dim=1)
    valid = torch.cat([a.valid, b.valid], dim=1)
    masked = torch.where(valid, scores, -1.0)
    if config.TTA_FUSION_IOU > 0:
        # the class offsets zero cross-class IoU: no fusion across classes
        off = class_ids.to(torch.float32)[..., None] * (float(max(h, w))
                                                       + 2.0)
        iou = _iou_plus_one(boxes.to(torch.float32) + off)
        match = ((iou >= config.TTA_FUSION_IOU) & valid[:, None, :]
                 & valid[:, :, None])
        wgt = torch.where(match, torch.clamp_min(masked, 0.0)[:, None, :],
                          0.0)
        wsum = wgt.sum(dim=2, keepdim=True)
        with ieee_float32():
            fused = torch.matmul(wgt, boxes.to(torch.float32))
        fused = fused / torch.clamp_min(wsum, 1e-8)
        boxes = torch.where(valid[..., None] & (wsum > 0), fused, boxes)
    return _select(config, boxes, class_ids, valid, scores)


def detect_and_pool_masks_tta(model: MaskRCNN, images: torch.Tensor,
                              windows: torch.Tensor):
    """Horizontal-flip test-time augmentation (Config.TTA_HFLIP): the box
    pipeline on the canvases and on their mirror, both with sub-pixel
    boxes; the mirrored detections mapped back and merged
    (merge_detections); the merged boxes rounded once; mask features
    pooled once, from the un-flipped pass's maps. Returns (Detections,
    pooled [B, D, 14, 14, C])."""
    w = int(model.config.IMAGE_SHAPE[1])
    feats, det, q_scales = detect_boxes(model, images, windows,
                                        round_boxes=False)
    det_f = detect_boxes(model, images.flip(2), flip_windows(windows, w),
                         round_boxes=False)[1]
    det_f = det_f._replace(boxes=torch.where(
        det_f.valid[..., None], flip_boxes(det_f.boxes, w), 0.0))
    det = merge_detections(model.config, det, det_f)
    det = det._replace(boxes=torch.where(det.valid[..., None],
                                         torch.round(det.boxes), 0.0))
    return det, _pool_mask_features(model, feats, det, q_scales)


def decode_keypoints(kp_logits: torch.Tensor, boxes: torch.Tensor,
                     valid: torch.Tensor) -> torch.Tensor:
    """Heatmap argmax -> canvas keypoints (the JAX decode_keypoints).

    kp_logits [N, Hh, Wh, K]; boxes [N, 4] canvas pixels (y1, x1, y2,
    x2); valid [N]. Returns [N, K, 3] float32 (y, x, score): the centre of
    the argmax cell (ties to the first) mapped into the box, and the
    spatial softmax's peak; zeros for invalid rows. The cell centre
    divides by the heatmap size as a tensor."""
    n, hh, hw, k = kp_logits.shape
    flat = kp_logits.permute(0, 3, 1, 2).reshape(n, k, hh * hw)
    probs = torch.softmax(flat, dim=-1)
    idx = torch.argmax(flat, dim=-1)                          # [N, K]
    score = torch.gather(probs, 2, idx[..., None])[..., 0]
    iy = torch.div(idx, hw, rounding_mode="floor").to(torch.float32)
    ix = torch.remainder(idx, hw).to(torch.float32)
    y1, x1, y2, x2 = (boxes[:, i, None] for i in range(4))
    size = _f32([hh, hw], boxes.device)
    y = y1 + (iy + 0.5) / size[0] * (y2 - y1)
    x = x1 + (ix + 0.5) / size[1] * (x2 - x1)
    out = torch.stack([y, x, score], dim=-1)
    return torch.where(valid[:, None, None], out, 0.0)


@torch.inference_mode()
def predict_step(model: MaskRCNN, images: torch.Tensor,
                 windows: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Batched inference (reference model.py:1140-1203).

    images [B, H, W, 3] uint8 canvases; windows [B, 4] float32. Returns
    class_ids [B, D] int32, scores [B, D] float32, boxes [B, D, 4]
    float32, valid [B, D] bool and masks_packed [B, D, H, ceil(W/8)]
    uint8 (np.unpackbits order), all on the images' device; under
    NUM_KEYPOINTS also keypoints [B, n, K, 3] float32 (y, x, score) of the
    first n = min(KEYPOINT_MAX_INSTANCES or D, D) slots, from the mask
    head's pooled features (no other RoIAlign)."""
    config = model.config
    h, w = config.IMAGE_SHAPE[:2]
    run = (detect_and_pool_masks_tta if config.TTA_HFLIP
           else detect_and_pool_masks)
    det, pooled = run(model, images, windows)
    b, d = pooled.shape[:2]
    mask_probs = model.predict_masks(pooled.reshape(b * d,
                                                    *pooled.shape[2:]))
    sel = torch.gather(mask_probs, 3, det.class_ids.reshape(
        b * d, 1, 1, 1).long().expand(-1, *mask_probs.shape[1:3], 1))[..., 0]
    packed = paste_masks_packed(sel, det.boxes.reshape(b * d, 4),
                                det.valid.reshape(b * d), h, w)
    out = {"class_ids": det.class_ids, "scores": det.scores,
           "boxes": det.boxes, "valid": det.valid,
           "masks_packed": packed.reshape(b, d, h, packed.shape[-1])}
    if config.NUM_KEYPOINTS > 0:
        n = min(config.KEYPOINT_MAX_INSTANCES or d, d)
        pooled_k = pooled[:, :n]
        logits = model.predict_keypoints(
            pooled_k.reshape(b * n, *pooled_k.shape[2:]))
        kp = decode_keypoints(logits, det.boxes[:, :n].reshape(b * n, 4),
                              det.valid[:, :n].reshape(b * n))
        out["keypoints"] = kp.reshape(b, n, config.NUM_KEYPOINTS, 3)
    return out
