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
