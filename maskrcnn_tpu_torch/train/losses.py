"""The five-task Mask R-CNN loss, plus the keypoint task (counterpart of
maskrcnn_tpu/train/losses.py; reference model.py:652-718, 802-845,
922-953, summed at model.py:1623-1629).

Every loss is a masked mean over fixed-shape tensors, as in the JAX
package: where the reference gathers dynamic index lists, boolean masks
weight the terms. An empty selection gives 0, as the reference's
empty-tensor branches.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


def smooth_l1(diff: torch.Tensor) -> torch.Tensor:
    """F.smooth_l1_loss's elementwise core (beta = 1)."""
    a = torch.abs(diff)
    return torch.where(a < 1.0, 0.5 * a * a, a - 0.5)


def _masked_mean(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    num = torch.sum(values * mask)
    den = torch.sum(mask)
    return torch.where(den > 0, num / torch.clamp_min(den, 1.0), 0.0)


def rpn_class_loss(rpn_match: torch.Tensor,
                   rpn_logits: torch.Tensor) -> torch.Tensor:
    """Cross-entropy over the sampled (+-1) anchors (model.py:652-686).
    rpn_match [..., A] int32; rpn_logits [..., A, 2]."""
    target = (rpn_match == 1).long()
    logp = torch.log_softmax(rpn_logits, dim=-1)
    nll = -torch.gather(logp, -1, target[..., None])[..., 0]
    return _masked_mean(nll, (rpn_match != 0).to(torch.float32))


def rpn_box_loss(target_bbox: torch.Tensor, rpn_match: torch.Tensor,
                 rpn_bbox: torch.Tensor) -> torch.Tensor:
    """Smooth-L1 over the positive anchors (model.py:688-718).

    target_bbox [B, T, 4] packed positives first (rpn_targets' layout, the
    reference's np.where packing); rpn_match [B, A]; rpn_bbox [B, A, 4]
    predictions, packed here in the same anchor order."""
    a = rpn_match.shape[-1]
    t = target_bbox.shape[-2]
    pos = rpn_match == 1
    idx = torch.arange(a, device=rpn_match.device)
    packed = torch.sort(torch.where(pos, idx, a + idx), dim=-1,
                        stable=True).indices[..., :t]
    pvalid = torch.gather(pos, -1, packed).to(torch.float32)
    pred = torch.gather(rpn_bbox, -2, packed[..., None].expand(
        *packed.shape, 4))
    diff = smooth_l1(pred - target_bbox)
    num = torch.sum(diff * pvalid[..., None])
    den = torch.sum(pvalid) * 4.0
    return torch.where(den > 0, num / torch.clamp_min(den, 1.0), 0.0)


def mrn_class_loss(target_class_ids: torch.Tensor, logits: torch.Tensor,
                   valid: torch.Tensor) -> torch.Tensor:
    """Head classification cross-entropy over the real (positive and
    negative) RoIs (model.py:802-814)."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, target_class_ids.long()[..., None])[..., 0]
    return _masked_mean(nll, valid.to(torch.float32))


def mrn_box_loss(target_class_ids: torch.Tensor, target_deltas: torch.Tensor,
                 pred_deltas: torch.Tensor,
                 positive: torch.Tensor) -> torch.Tensor:
    """Smooth-L1 on the target class's deltas, positives only
    (model.py:816-845). pred_deltas [..., N, K, 4]."""
    cls = target_class_ids.long()[..., None, None].expand(
        *target_class_ids.shape, 1, 4)
    pred = torch.gather(pred_deltas, -2, cls)[..., 0, :]
    diff = smooth_l1(pred - target_deltas)
    mask = positive.to(torch.float32)[..., None].expand(diff.shape)
    return _masked_mean(diff, mask)


def mask_loss(target_class_ids: torch.Tensor, target_masks: torch.Tensor,
              pred_masks: torch.Tensor,
              positive: torch.Tensor) -> torch.Tensor:
    """Binary cross-entropy on the target class's mask, positives only
    (model.py:922-953). pred_masks [..., N, 28, 28, K] sigmoid
    probabilities; the log terms clamp at eps = 1e-7, as
    F.binary_cross_entropy's."""
    cls = target_class_ids.long()[..., None, None, None].expand(
        *pred_masks.shape[:-1], 1)
    pred = torch.gather(pred_masks, -1, cls)[..., 0]
    eps = 1e-7
    p = torch.clamp(pred, eps, 1.0 - eps)
    bce = -(target_masks * torch.log(p)
            + (1.0 - target_masks) * torch.log(1.0 - p))
    mask = positive.to(torch.float32)[..., None, None].expand(bce.shape)
    return _masked_mean(bce, mask)


def keypoint_loss(kp_pos: torch.Tensor, kp_valid: torch.Tensor,
                  kp_logits: torch.Tensor) -> torch.Tensor:
    """Spatial softmax cross-entropy a keypoint (the Mask R-CNN paper's
    pose task: each visible keypoint is a one-hot class over the heatmap
    positions). kp_pos [..., T, K] flattened target index; kp_valid
    [..., T, K] bool; kp_logits [..., T, Hh, Wh, K]. The mean over the
    valid keypoints."""
    *lead, t, hh, hw, k = kp_logits.shape
    flat = torch.movedim(kp_logits, -1, -3).reshape(*lead, t, k, hh * hw)
    logp = torch.log_softmax(flat, dim=-1)
    nll = -torch.gather(logp, -1, kp_pos.long()[..., None])[..., 0]
    return _masked_mean(nll, kp_valid.to(torch.float32))


class Losses(NamedTuple):
    """The task losses. `mrn_kp` is the optional keypoint branch
    (Config.NUM_KEYPOINTS > 0) and stays 0 when it is off, so the
    five-task sum is unchanged."""

    total: torch.Tensor
    rpn_class: torch.Tensor
    rpn_box: torch.Tensor
    mrn_class: torch.Tensor
    mrn_box: torch.Tensor
    mrn_mask: torch.Tensor
    mrn_kp: torch.Tensor

    def as_dict(self):
        return {f: getattr(self, f) for f in self._fields}
