"""Batched end-to-end inference (counterpart of
maskrcnn_tpu/detection/pipeline.py, single pass with hard NMS).

normalize -> ResNet-FPN -> fused RPN -> proposals (top-k, decode, clip,
NMS 0.7, compact) -> RoIAlign 7x7 -> box head -> detections (class pick,
decode, round, class-offset NMS 0.3, top D) -> RoIAlign 14x14 -> mask
head -> class-channel select -> paste + bit-pack.

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

import torch

from maskrcnn_tpu_torch.config import Config
from maskrcnn_tpu_torch.models.mask_rcnn import MaskRCNN
from maskrcnn_tpu_torch.ops import boxes as box_ops
from maskrcnn_tpu_torch.ops import device_tensor
from maskrcnn_tpu_torch.ops.image import normalize_image
from maskrcnn_tpu_torch.ops.int8_conv import quantize_tensor
from maskrcnn_tpu_torch.quant import Scale, roi_scales
from maskrcnn_tpu_torch.ops.mask_paste import paste_masks_packed
from maskrcnn_tpu_torch.ops.nms import multiclass_nms_mask, nms_mask_impl
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


def mrn_refine(config: Config, proposals: torch.Tensor,
               proposal_valid: torch.Tensor, probs: torch.Tensor,
               deltas: torch.Tensor, windows: torch.Tensor) -> Detections:
    """Detection refinement (reference model.py:1389-1487), batched, hard
    NMS.

    proposals [B, R, 4] normalized; proposal_valid [B, R]; probs
    [B, R, K]; deltas [B, R, K, 4]; windows [B, 4] (y1, x1, y2, x2)
    pixel coords of each image's un-padded region."""
    class_ids = torch.argmax(probs, dim=-1)                     # [B, R]
    class_scores = torch.gather(probs, 2, class_ids[..., None])[..., 0]
    specific = torch.gather(
        deltas, 2, class_ids[..., None, None].expand(-1, -1, 1, 4))[:, :, 0]
    dev = probs.device
    # model.py:1418-1422 uses RPN_BBOX_STD_DEV here (not BBOX_STD_DEV)
    refined = box_ops.refine_boxes(
        proposals, specific * _f32(config.RPN_BBOX_STD_DEV, dev))
    h, w = config.IMAGE_SHAPE[:2]
    boxes = refined * _f32([h, w, h, w], dev)
    boxes = box_ops.clip_boxes(boxes, windows[:, None, :])
    # round before NMS (model.py:1432): a reference quirk kept for parity
    boxes = torch.round(boxes)

    keep = proposal_valid & (class_ids > 0)
    if config.DETECTION_MIN_CONFIDENCE:
        keep = keep & (class_scores >= config.DETECTION_MIN_CONFIDENCE)

    # global score sort, then per-class NMS via class offsets
    masked = torch.where(keep, class_scores, -1.0)
    order = torch.sort(-masked, dim=-1, stable=True).indices
    sboxes = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
    sclasses = torch.gather(class_ids, 1, order)
    svalid = torch.gather(keep, 1, order)
    sscores = torch.gather(masked, 1, order)
    nms_keep = multiclass_nms_mask(sboxes, sclasses, svalid,
                                   config.DETECTION_NMS_THRESHOLD,
                                   coord_span=float(max(h, w)))

    take = _compact(nms_keep, config.DETECTION_MAX_INSTANCES)
    valid = torch.gather(nms_keep, 1, take)
    return Detections(
        class_ids=torch.where(valid, torch.gather(sclasses, 1, take),
                              0).to(torch.int32),
        scores=torch.where(valid, torch.gather(sscores, 1, take), 0.0),
        boxes=torch.where(valid[..., None],
                          torch.gather(sboxes, 1,
                                       take[..., None].expand(-1, -1, 4)),
                          0.0),
        valid=valid)


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
                 windows: torch.Tensor):
    """normalize -> backbone -> RPN -> proposals -> box head -> refine.
    Returns (feature maps P2..P6 NHWC, Detections, the int8 RoI table
    scales or None)."""
    config = model.config
    x = normalize_image(images, config.MEAN_PIXEL)
    feats = model.backbone(x)
    rpn_fg, rpn_bbox = model.rpn_scores(feats)
    proposals, pvalid = rpn_refine_scores(config, model.anchors(), rpn_fg,
                                          rpn_bbox)
    q_scales = roi_scales(model)
    b, r = proposals.shape[:2]
    pooled = _pool_rois(feats, proposals, config.POOL_SIZE,
                        config.IMAGE_SHAPE, quant_scales=q_scales)
    _, probs, deltas = model.classify(pooled.reshape(b * r,
                                                     *pooled.shape[2:]))
    det = mrn_refine(config, proposals, pvalid, probs.reshape(b, r, -1),
                     deltas.reshape(b, r, config.NUM_CLASSES, 4), windows)
    return feats, det, q_scales


def detect_and_pool_masks(model: MaskRCNN, images: torch.Tensor,
                          windows: torch.Tensor):
    """detect_boxes, then the mask-head RoIAlign on the detection boxes
    (normalized per axis). Returns (Detections, pooled [B, D, 14, 14, C])."""
    feats, det, q_scales = detect_boxes(model, images, windows)
    h, w = model.config.IMAGE_SHAPE[:2]
    mask_rois = det.boxes / _f32([h, w, h, w], det.boxes.device)
    return det, _pool_rois(feats, mask_rois, model.config.MASK_POOL_SIZE,
                           model.config.IMAGE_SHAPE, quant_scales=q_scales)


@torch.inference_mode()
def predict_step(model: MaskRCNN, images: torch.Tensor,
                 windows: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Batched inference (reference model.py:1140-1203).

    images [B, H, W, 3] uint8 canvases; windows [B, 4] float32. Returns
    class_ids [B, D] int32, scores [B, D] float32, boxes [B, D, 4]
    float32, valid [B, D] bool and masks_packed [B, D, H, ceil(W/8)]
    uint8 (np.unpackbits order), all on the images' device."""
    config = model.config
    h, w = config.IMAGE_SHAPE[:2]
    det, pooled = detect_and_pool_masks(model, images, windows)
    b, d = pooled.shape[:2]
    mask_probs = model.predict_masks(pooled.reshape(b * d,
                                                    *pooled.shape[2:]))
    sel = torch.gather(mask_probs, 3, det.class_ids.reshape(
        b * d, 1, 1, 1).long().expand(-1, *mask_probs.shape[1:3], 1))[..., 0]
    packed = paste_masks_packed(sel, det.boxes.reshape(b * d, 4),
                                det.valid.reshape(b * d), h, w)
    return {"class_ids": det.class_ids, "scores": det.scores,
            "boxes": det.boxes, "valid": det.valid,
            "masks_packed": packed.reshape(b, d, h, packed.shape[-1])}
