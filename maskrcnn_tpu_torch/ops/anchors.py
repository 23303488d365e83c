"""Pyramid anchor generation (counterpart of maskrcnn_tpu/ops/anchors.py).

A numpy copy, not an import: `maskrcnn_tpu.ops` imports JAX. Anchors are
computed in float64 and cast to float32 exactly like the JAX package and
the reference (utils.py:116-291), so the grid stays bit-equal to both.
Order is (level, y, x, ratio), matching the RPN's NHWC reshape.
"""

from __future__ import annotations

import numpy as np


def generate_level_anchors(scale, ratios, shape, feature_stride,
                           anchor_stride) -> np.ndarray:
    """Anchors for one pyramid level: [h*w*len(ratios), 4] float32
    (y1, x1, y2, x2), ordered (y, x, ratio)."""
    ratios = np.asarray(ratios, np.float64)
    scale = np.float64(scale)
    heights = scale / np.sqrt(ratios)
    widths = scale * np.sqrt(ratios)

    shifts_y = (np.arange(0, shape[0], anchor_stride, dtype=np.float64)
                * feature_stride)
    shifts_x = (np.arange(0, shape[1], anchor_stride, dtype=np.float64)
                * feature_stride)

    cy = shifts_y[:, None, None] + np.zeros(
        (1, shifts_x.shape[0], ratios.shape[0]), np.float64)
    cx = shifts_x[None, :, None] + np.zeros(
        (shifts_y.shape[0], 1, ratios.shape[0]), np.float64)
    h = np.broadcast_to(heights[None, None, :], cy.shape)
    w = np.broadcast_to(widths[None, None, :], cy.shape)

    boxes = np.stack(
        [cy - 0.5 * h, cx - 0.5 * w, cy + 0.5 * h, cx + 0.5 * w], axis=-1)
    return boxes.reshape(-1, 4).astype(np.float32)


def generate_pyramid_anchors(scales, ratios, feature_shapes, feature_strides,
                             anchor_stride) -> np.ndarray:
    """All-level anchors, scale[i] on level i ([261888, 4] at 1024²)."""
    return np.concatenate([
        generate_level_anchors(scales[i], ratios, feature_shapes[i],
                               feature_strides[i], anchor_stride)
        for i in range(len(scales))], axis=0)


def config_anchors(config) -> np.ndarray:
    """Pixel-space anchors [num_anchors, 4] for a Config."""
    return generate_pyramid_anchors(
        config.RPN_ANCHOR_SCALES, config.RPN_ANCHOR_RATIOS,
        config.BACKBONE_SHAPES, config.BACKBONE_STRIDES,
        config.RPN_ANCHOR_STRIDE)
