"""Box algebra on tensors (counterpart of maskrcnn_tpu/ops/boxes.py).

Boxes are (y1, x1, y2, x2) over any leading dims. Each op is one eager
PyTorch kernel, so every step rounds once in float32 as in the JAX
package; nothing is contracted into an FMA.
"""

from __future__ import annotations

import torch


def clip_boxes(boxes: torch.Tensor, window) -> torch.Tensor:
    """Clip boxes to a window (wy1, wx1, wy2, wx2), like jnp.clip:
    min(max(v, lo), hi).

    window: four numbers, or a [..., 4] tensor that broadcasts against
    boxes[..., 0] (one window per image)."""
    if torch.is_tensor(window):
        wy1, wx1, wy2, wx2 = window.to(boxes.dtype).unbind(-1)
    else:
        wy1, wx1, wy2, wx2 = (float(v) for v in window)
    return torch.stack([torch.clamp(boxes[..., 0], wy1, wy2),
                        torch.clamp(boxes[..., 1], wx1, wx2),
                        torch.clamp(boxes[..., 2], wy1, wy2),
                        torch.clamp(boxes[..., 3], wx1, wx2)], dim=-1)


def refine_boxes(boxes: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    """Apply (dy, dx, log dh, log dw) deltas (reference data.py:124-148)."""
    height = boxes[..., 2] - boxes[..., 0]
    width = boxes[..., 3] - boxes[..., 1]
    center_y = boxes[..., 0] + 0.5 * height
    center_x = boxes[..., 1] + 0.5 * width

    center_y = center_y + deltas[..., 0] * height
    center_x = center_x + deltas[..., 1] * width
    height = height * torch.exp(deltas[..., 2])
    width = width * torch.exp(deltas[..., 3])

    y1 = center_y - 0.5 * height
    x1 = center_x - 0.5 * width
    # y2 = y1 + h, not center + h/2: the reference's literal order, kept
    # for bit parity.
    y2 = y1 + height
    x2 = x1 + width
    return torch.stack([y1, x1, y2, x2], dim=-1)


def scale_boxes(boxes: torch.Tensor, scale) -> torch.Tensor:
    """Elementwise scale (reference data.py:95-100 boxes_scale)."""
    return boxes * torch.as_tensor(scale, dtype=boxes.dtype,
                                   device=boxes.device)


def box_deltas(boxes: torch.Tensor, gt_boxes: torch.Tensor) -> torch.Tensor:
    """Regression targets from `boxes` to `gt_boxes` (reference
    data.py:103-121 boxes_deltas): [..., (dy, dx, log dh, log dw)]."""
    height = boxes[..., 2] - boxes[..., 0]
    width = boxes[..., 3] - boxes[..., 1]
    center_y = boxes[..., 0] + 0.5 * height
    center_x = boxes[..., 1] + 0.5 * width

    gt_height = gt_boxes[..., 2] - gt_boxes[..., 0]
    gt_width = gt_boxes[..., 3] - gt_boxes[..., 1]
    gt_center_y = gt_boxes[..., 0] + 0.5 * gt_height
    gt_center_x = gt_boxes[..., 1] + 0.5 * gt_width

    dy = (gt_center_y - center_y) / height
    dx = (gt_center_x - center_x) / width
    dh = torch.log(gt_height / height)
    dw = torch.log(gt_width / width)
    return torch.stack([dy, dx, dh, dw], dim=-1)


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    """(y2 - y1) * (x2 - x1); no +1 convention (that lives only in NMS)."""
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU [..., M, N] of boxes1 [..., M, 4] and boxes2
    [..., N, 4] (reference data.py:151-189 boxes_overlaps). Zero-area
    pairs give 0/0 = nan, as the reference; callers mask padded boxes."""
    b1 = boxes1[..., :, None, :]
    b2 = boxes2[..., None, :, :]
    y1 = torch.maximum(b1[..., 0], b2[..., 0])
    x1 = torch.maximum(b1[..., 1], b2[..., 1])
    y2 = torch.minimum(b1[..., 2], b2[..., 2])
    x2 = torch.minimum(b1[..., 3], b2[..., 3])
    intersection = (torch.clamp_min(x2 - x1, 0.0)
                    * torch.clamp_min(y2 - y1, 0.0))
    area1 = (b1[..., 2] - b1[..., 0]) * (b1[..., 3] - b1[..., 1])
    area2 = (b2[..., 2] - b2[..., 0]) * (b2[..., 3] - b2[..., 1])
    union = area1 + area2 - intersection
    return intersection / union
