"""Image normalisation (counterpart of maskrcnn_tpu/ops/image.py)."""

from __future__ import annotations

import torch

from maskrcnn_tpu_torch.ops import device_tensor


def normalize_image(image: torch.Tensor, mean_pixel) -> torch.Tensor:
    """uint8 RGB [..., H, W, 3] -> float32 minus the per-channel mean."""
    mean = device_tensor(mean_pixel, torch.float32, image.device)
    return image.to(torch.float32) - mean
