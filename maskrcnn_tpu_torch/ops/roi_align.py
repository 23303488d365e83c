"""Multilevel RoIAlign (counterpart of maskrcnn_tpu/ops/roi_align.py).

Semantics of the JAX package and the reference (model.py:276-393,
crop_cpu.cpp:13-116):
* FPN level `4 + log2(sqrt(h*w) / (224/sqrt(image_area)))`, rounded half
  to even and clamped to [2, 5];
* tf.crop_and_resize sampling: one bilinear sample per output cell on the
  align-corners grid of `sample_points`;
* samples outside the level read 0.

The plain version is `multilevel_roi_align`: the coordinate prologue
(`roi_levels`, `sample_points`, gathered by `level_geometry`) and the
blend (`roi_align_levels`), in plain PyTorch. The CUDA kernel
(csrc/roi_align.cu, bound as kernels.roi_align) takes the boxes and
computes the same prologue itself, with the same IEEE operations in the
same order; `multilevel_roi_align_impl` hands CUDA tensors to it with no
other op, and CPU tensors to the plain version.
Both blend in float32 and round to the feature dtype once (the JAX XLA
path blends in the table dtype; its Pallas kernel in float32). int8
tables (the Pallas kernel's `level_scales`, Config.QUANT_INT8_ROI) blend
the same way, multiply by the box's level scale and round once to
`out_dtype`.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from maskrcnn_tpu_torch.ops import device_tensor


def level_divisor(image_shape) -> float:
    """224 / sqrt(image area) as the float32 the JAX package divides by (a
    numpy scalar canonicalised to float32 there)."""
    image_area = float(image_shape[0]) * float(image_shape[1])
    return float(np.float32(224.0 / np.sqrt(image_area)))


def roi_levels(boxes: torch.Tensor, image_shape) -> torch.Tensor:
    """0-based FPN level (P2=0..P5=3) per box; boxes [..., 4] normalized."""
    h = boxes[..., 2] - boxes[..., 0]
    w = boxes[..., 3] - boxes[..., 1]
    # the divisor as a tensor: see sample_points on CUDA division by a
    # host scalar
    denom = torch.full_like(h, level_divisor(image_shape))
    lvl = 4.0 + torch.log2(torch.sqrt(h * w) / denom)
    lvl = torch.clamp(torch.round(lvl), 2.0, 5.0)
    return (lvl - 2.0).to(torch.int32)


def sample_points(boxes: torch.Tensor, h_max: torch.Tensor,
                  w_max: torch.Tensor, pool_size: int):
    """Bilinear sample coordinates per output cell: ([M, P], [M, P]).

    boxes [M, 4] normalized; h_max/w_max [M]: the box's level extent
    minus one. Literal op order of crop_cpu.cpp:52-61, one float32
    rounding per step:
        scale = (y2 - y1) * (H - 1) / (P - 1)
        in_y  = y1 * (H - 1) + y * scale
    The divisor is a tensor on the boxes' device: PyTorch's CUDA `div`
    turns division by a host scalar into a multiply by its reciprocal,
    which rounds differently and flips boundary samples between read and
    extrapolated.
    """
    y1, x1, y2, x2 = boxes.unbind(-1)
    steps = torch.arange(pool_size, dtype=torch.float32,
                         device=boxes.device)
    inv = torch.full_like(y1, float(pool_size - 1))
    hs = (y2 - y1) * h_max / inv
    ws = (x2 - x1) * w_max / inv
    in_y = (y1 * h_max)[:, None] + steps[None, :] * hs[:, None]
    in_x = (x1 * w_max)[:, None] + steps[None, :] * ws[:, None]
    return in_y, in_x


def level_geometry(features: Sequence[torch.Tensor], boxes: torch.Tensor,
                   pool_size: int, image_shape):
    """(level [M] int32, in_y [M, P], in_x [M, P]) for boxes [B, N, 4]
    over NHWC levels [B, H_l, W_l, C]: the plain blend's inputs, which the
    kernel computes itself."""
    flat = boxes.reshape(-1, 4).to(torch.float32)
    lvl = roi_levels(flat, image_shape)
    dims = device_tensor([[f.shape[1] - 1.0, f.shape[2] - 1.0]
                          for f in features], torch.float32,
                         boxes.device)[lvl.long()]
    in_y, in_x = sample_points(flat, dims[:, 0], dims[:, 1], pool_size)
    return lvl, in_y, in_x


def _axis_taps(coord: torch.Tensor, extent_max: torch.Tensor):
    """Clamp rules of maskrcnn_tpu.ops.roi_align._crop_core for one axis:
    (start index, weight of start+1, outside) per sample."""
    start = torch.minimum(torch.clamp_min(torch.floor(coord), 0.0),
                          torch.clamp_min(extent_max - 1.0, 0.0))
    frac = torch.minimum(torch.clamp_min(coord, 0.0), extent_max) - start
    outside = (coord < 0.0) | (coord > extent_max)
    return start, frac, outside


def roi_align_levels(levels: Sequence[torch.Tensor],
                     box_level: torch.Tensor, in_y: torch.Tensor,
                     in_x: torch.Tensor, boxes_per_image: int,
                     level_scales: Sequence[float] = None,
                     out_dtype: torch.dtype = None) -> torch.Tensor:
    """The plain blend, in the kernel's (kernels.roi_align) order of
    operations: levels P2..P5 as [B, H_l, W_l, C]; box_level [M] int32
    and in_y/in_x [M, P] from `level_geometry` (M = B*N, image-major).
    Returns [M, P, P, C] in the levels' dtype. int8 levels (the
    int8-table mode) take `level_scales`, four floats: the blend is
    multiplied by the box's level scale and rounded once to
    `out_dtype`."""
    m, p = in_y.shape
    c = levels[0].shape[-1]
    dev = in_y.device
    lvl = box_level.long()
    heights = device_tensor([f.shape[1] for f in levels], torch.int64, dev)
    widths = device_tensor([f.shape[2] for f in levels], torch.int64, dev)
    sizes = device_tensor([f.shape[0] * f.shape[1] * f.shape[2]
                           for f in levels], torch.int64, dev)
    offsets = torch.cumsum(sizes, 0) - sizes
    table = torch.cat([f.reshape(-1, c) for f in levels], dim=0)

    h_l, w_l = heights[lvl], widths[lvl]                   # [M]
    ys, ty, out_y = _axis_taps(in_y, (h_l - 1).to(torch.float32)[:, None])
    xs, tx, out_x = _axis_taps(in_x, (w_l - 1).to(torch.float32)[:, None])
    y0 = ys.long()
    x0 = xs.long()
    y1 = torch.minimum(y0 + 1, (h_l - 1)[:, None])
    x1 = torch.minimum(x0 + 1, (w_l - 1)[:, None])
    img = torch.arange(m, device=dev) // boxes_per_image
    base = offsets[lvl] + img * h_l * w_l                  # [M]

    def corner(yy, xx):
        rows = (base[:, None, None] + yy[:, :, None] * w_l[:, None, None]
                + xx[:, None, :])                          # [M, P, P]
        return table[rows.reshape(-1)].reshape(m, p, p, c).to(torch.float32)

    wy0, wy1 = (1.0 - ty)[:, :, None], ty[:, :, None]      # [M, P, 1]
    wx0, wx1 = (1.0 - tx)[:, None, :], tx[:, None, :]      # [M, 1, P]
    # the kernel's order: weights first, then a left-to-right 4-tap sum
    out = ((corner(y0, x0) * (wy0 * wx0)[..., None]
            + corner(y0, x1) * (wy0 * wx1)[..., None])
           + corner(y1, x0) * (wy1 * wx0)[..., None]) \
        + corner(y1, x1) * (wy1 * wx1)[..., None]
    if table.dtype == torch.int8:
        if level_scales is None or out_dtype is None:
            raise ValueError("roi_align: int8 levels need level_scales and "
                             "out_dtype")
        scale = device_tensor([float(s) for s in level_scales],
                              torch.float32, dev)[lvl]
        out = out * scale[:, None, None, None]
    elif level_scales is not None or out_dtype not in (None, table.dtype):
        raise ValueError("roi_align: level_scales and out_dtype go with "
                         "int8 levels")
    else:
        out_dtype = table.dtype
    inside = ~(out_y[:, :, None] | out_x[:, None, :])
    return torch.where(inside[..., None], out, 0.0).to(out_dtype)


def multilevel_roi_align(features: Sequence[torch.Tensor],
                         boxes: torch.Tensor, pool_size: int,
                         image_shape, level_scales: Sequence[float] = None,
                         out_dtype: torch.dtype = None) -> torch.Tensor:
    """Plain batched multilevel RoIAlign.

    features: P2..P5 as [B, H_l, W_l, C] (NHWC views); boxes [B, N, 4]
    normalized. Returns [B, N, P, P, C] in the feature dtype (int8
    features: in `out_dtype`, dequantized by `level_scales`, as
    `roi_align_levels`). Zero boxes route to P2 and pool real pixels;
    callers mask them downstream.
    """
    b, n = boxes.shape[:2]
    lvl, in_y, in_x = level_geometry(features, boxes, pool_size, image_shape)
    out = roi_align_levels(features, lvl, in_y, in_x, n, level_scales,
                           out_dtype)
    return out.reshape(b, n, pool_size, pool_size, -1)


def multilevel_roi_align_impl(features: Sequence[torch.Tensor],
                              boxes: torch.Tensor, pool_size: int,
                              image_shape, level_scales: Sequence[float] = None,
                              out_dtype: torch.dtype = None) -> torch.Tensor:
    """Device dispatch of multilevel RoIAlign (arguments as
    `multilevel_roi_align`): CUDA tensors go to the kernel, which computes
    the levels and sample points itself (no PyTorch op but the output
    allocation, for contiguous float32 boxes and levels), at every batch
    size; CPU tensors to the plain version."""
    if boxes.device.type == "cpu":
        return multilevel_roi_align(features, boxes, pool_size, image_shape,
                                    level_scales, out_dtype)
    if not boxes.is_cuda:
        raise ValueError(f"roi_align: no implementation for device "
                         f"{boxes.device}")
    from maskrcnn_tpu_torch import kernels
    b, n = boxes.shape[:2]
    flat = boxes.reshape(b * n, 4).to(torch.float32).contiguous()
    out = kernels.roi_align(list(features), flat, pool_size, image_shape,
                            level_scales, out_dtype)
    return out.reshape(b, n, pool_size, pool_size, -1)
