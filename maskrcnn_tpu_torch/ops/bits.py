"""Mask bit packing (counterpart of maskrcnn_tpu/ops/bits.py).

MSB-first bit order within each byte, the order of np.packbits and
np.unpackbits, so host code unpacks device output with numpy.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from maskrcnn_tpu_torch.ops import device_tensor


def pack_masks(masks: np.ndarray) -> np.ndarray:
    """Host: [..., W] {0,1} -> [..., ceil(W/8)] uint8 (np.packbits, which
    packs a nonzero element as a 1 bit without a cast)."""
    return np.packbits(masks, axis=-1)


def pack_masks_device(masks: torch.Tensor) -> torch.Tensor:
    """[..., W] bool/{0,1} -> [..., ceil(W/8)] uint8."""
    m = masks.to(torch.uint8)
    pad = (-m.shape[-1]) % 8
    if pad:
        m = F.pad(m, (0, pad))
    m = m.reshape(*m.shape[:-1], -1, 8)
    weights = device_tensor([128, 64, 32, 16, 8, 4, 2, 1], torch.uint8,
                            m.device)
    return (m * weights).sum(dim=-1, dtype=torch.uint8)


def unpack_masks(packed: torch.Tensor, width: int) -> torch.Tensor:
    """[..., W/8] uint8 -> [..., width] uint8 {0,1}."""
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=packed.device)
    bits = (packed[..., None] >> shifts) & 1
    return bits.reshape(*packed.shape[:-1], -1)[..., :width]
