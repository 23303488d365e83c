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
(csrc/roi_align.cu, the mrt::roi_align op of kernels.torch_ops) takes
the boxes and computes the same prologue itself, with the same IEEE
operations in the same order; `multilevel_roi_align_impl` hands CUDA
tensors to it with no other op, and CPU tensors to the plain version.
Both blend in float32 and round to the feature dtype once (the JAX XLA
path blends in the table dtype; its Pallas kernel in float32). int8
tables (the Pallas kernel's `level_scales`, Config.QUANT_INT8_ROI) blend
the same way, multiply by the box's level scale and round once to
`out_dtype`.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from maskrcnn_tpu_torch.kernels import level_divisor, torch_ops
from maskrcnn_tpu_torch.ops import device_tensor


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


def level_geometry(features: Sequence, boxes: torch.Tensor,
                   pool_size: int, image_shape):
    """(level [M] int32, in_y [M, P], in_x [M, P]) for boxes [B, N, 4]
    over NHWC levels [B, H_l, W_l, C] (tensors, or their shapes): the
    plain blend's inputs, which the kernel computes itself."""
    shapes = [_shape(f) for f in features]
    flat = boxes.reshape(-1, 4).to(torch.float32)
    lvl = roi_levels(flat, image_shape)
    dims = device_tensor([[s[1] - 1.0, s[2] - 1.0] for s in shapes],
                         torch.float32, boxes.device)[lvl.long()]
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


def _shape(level) -> tuple:
    return tuple(level.shape) if torch.is_tensor(level) else tuple(level)


def _corners(shapes: Sequence[tuple], box_level: torch.Tensor,
             in_y: torch.Tensor, in_x: torch.Tensor, boxes_per_image: int):
    """The 2x2 footprint of every sample over the levels stacked as one
    [sum B*H_l*W_l, C] table: (rows, weights) for the corners 00, 01, 10,
    11, each [M, P, P], and inside [M, P, P], False where the sample lies
    outside its level (`_crop_core` zeroes it)."""
    m, p = in_y.shape
    dev = in_y.device
    lvl = box_level.long()
    heights = device_tensor([s[1] for s in shapes], torch.int64, dev)
    widths = device_tensor([s[2] for s in shapes], torch.int64, dev)
    sizes = device_tensor([s[0] * s[1] * s[2] for s in shapes], torch.int64,
                          dev)
    offsets = torch.cumsum(sizes, 0) - sizes

    h_l, w_l = heights[lvl], widths[lvl]                   # [M]
    ys, ty, out_y = _axis_taps(in_y, (h_l - 1).to(torch.float32)[:, None])
    xs, tx, out_x = _axis_taps(in_x, (w_l - 1).to(torch.float32)[:, None])
    y0 = ys.long()
    x0 = xs.long()
    y1 = torch.minimum(y0 + 1, (h_l - 1)[:, None])
    x1 = torch.minimum(x0 + 1, (w_l - 1)[:, None])
    img = torch.arange(m, device=dev) // boxes_per_image
    base = offsets[lvl] + img * h_l * w_l                  # [M]

    def rows(yy, xx):
        return (base[:, None, None] + yy[:, :, None] * w_l[:, None, None]
                + xx[:, None, :])                          # [M, P, P]

    wy0, wy1 = (1.0 - ty)[:, :, None], ty[:, :, None]      # [M, P, 1]
    wx0, wx1 = (1.0 - tx)[:, None, :], tx[:, None, :]      # [M, 1, P]
    corners = [(rows(y0, x0), wy0 * wx0), (rows(y0, x1), wy0 * wx1),
               (rows(y1, x0), wy1 * wx0), (rows(y1, x1), wy1 * wx1)]
    inside = ~(out_y[:, :, None] | out_x[:, None, :])
    return corners, inside


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
    table = torch.cat([f.reshape(-1, c) for f in levels], dim=0)
    corners, inside = _corners([f.shape for f in levels], box_level, in_y,
                               in_x, boxes_per_image)

    def tap(k):
        rows, w = corners[k]
        return (table[rows.reshape(-1)].reshape(m, p, p, c)
                .to(torch.float32) * w[..., None])

    # the kernel's order: weights first, then a left-to-right 4-tap sum
    out = ((tap(0) + tap(1)) + tap(2)) + tap(3)
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


def roi_align_backward_levels(grad: torch.Tensor, shapes: Sequence[tuple],
                              box_level: torch.Tensor, in_y: torch.Tensor,
                              in_x: torch.Tensor, boxes_per_image: int,
                              dtype: torch.dtype) -> List[torch.Tensor]:
    """The plain gradient of `roi_align_levels` (float tables): grad
    [M, P, P, C] -> one gradient a level, [B, H_l, W_l, C] in `dtype`.
    Each sample inside its level adds g * w to each corner of its 2x2
    footprint (w the forward's corner weight), corners 00, 01, 10, 11 in
    turn, as the JAX package's `_gather_patches_bwd`; a sample outside
    adds nothing. The sums run in float32 and round to `dtype` once (the
    JAX package multiplies and scatter-adds in the table dtype). On the
    CPU index_add_ adds in index order, so each level value is a
    sequential float32 sum over (corner, box, cell row, cell col); K1-bwd
    adds in that order too, and equals this bit for bit
    (tests/test_torch_determinism.py pins the order)."""
    m, p = in_y.shape
    c = grad.shape[-1]
    corners, inside = _corners(shapes, box_level, in_y, in_x,
                               boxes_per_image)
    g = grad.reshape(m, p, p, c).to(torch.float32)
    sizes = [s[0] * s[1] * s[2] for s in shapes]
    table = g.new_zeros(sum(sizes), c)
    for rows, w in corners:
        contrib = torch.where(inside[..., None], g * w[..., None], 0.0)
        table.index_add_(0, rows.reshape(-1), contrib.reshape(-1, c))
    return [t.reshape(s).to(dtype)
            for t, s in zip(torch.split(table, sizes), shapes)]


def multilevel_roi_align_backward(grad: torch.Tensor, shapes: Sequence[tuple],
                                  dtype: torch.dtype, boxes: torch.Tensor,
                                  pool_size: int, image_shape
                                  ) -> List[torch.Tensor]:
    """Plain gradient of `multilevel_roi_align` for the levels: grad
    [B, N, P, P, C], the levels' shapes [B, H_l, W_l, C] and dtype, boxes
    [B, N, 4] -> the four level gradients (`roi_align_backward_levels`)."""
    n = boxes.shape[1]
    lvl, in_y, in_x = level_geometry(shapes, boxes, pool_size, image_shape)
    return roi_align_backward_levels(grad, shapes, lvl, in_y, in_x, n, dtype)


def _forward(features, boxes, pool_size, image_shape, level_scales=None,
             out_dtype=None):
    """Device dispatch of the forward: K1 (the mrt::roi_align op, whose
    gradient for the levels is K1-bwd) on CUDA, the plain version on the
    CPU."""
    if boxes.device.type == "cpu":
        return multilevel_roi_align(features, boxes, pool_size, image_shape,
                                    level_scales, out_dtype)
    if not boxes.is_cuda:
        raise ValueError(f"roi_align: no implementation for device "
                         f"{boxes.device}")
    b, n = boxes.shape[:2]
    flat = boxes.reshape(b * n, 4).to(torch.float32).contiguous()
    int8 = level_scales is not None
    out = torch_ops.roi_align(
        list(features), flat, pool_size, int(image_shape[0]),
        int(image_shape[1]), [float(s) for s in level_scales] if int8 else [],
        out_dtype if int8 else features[0].dtype)
    return out.reshape(b, n, pool_size, pool_size, -1)


class RoIAlignFunction(torch.autograd.Function):
    """Multilevel RoIAlign with a gradient for the levels on CPU tensors:
    the plain forward and the plain backward (`multilevel_roi_align
    _backward`, the JAX `_gather_patches` VJP's sums in its order; aten's
    autograd through the plain blend would sum in another). On the card
    the mrt::roi_align op carries its own gradient (K1-bwd). No gradient
    reaches the boxes, as in the JAX package (stop_gradient) and the
    reference (model.py:358 detaches them).

    apply(boxes [B, N, 4], pool_size, image_shape, P2, P3, P4, P5) ->
    [B, N, P, P, C]."""

    @staticmethod
    def forward(ctx, boxes, pool_size, image_shape, *levels):
        boxes = boxes.detach()
        ctx.save_for_backward(boxes)
        ctx.geometry = (pool_size, image_shape,
                        [tuple(f.shape) for f in levels], levels[0].dtype)
        return multilevel_roi_align(levels, boxes, pool_size, image_shape)

    @staticmethod
    def backward(ctx, grad):
        boxes, = ctx.saved_tensors
        pool_size, image_shape, shapes, dtype = ctx.geometry
        grads = multilevel_roi_align_backward(grad, shapes, dtype, boxes,
                                              pool_size, image_shape)
        return (None, None, None, *grads)


def multilevel_roi_align_impl(features: Sequence[torch.Tensor],
                              boxes: torch.Tensor, pool_size: int,
                              image_shape, level_scales: Sequence[float] = None,
                              out_dtype: torch.dtype = None) -> torch.Tensor:
    """Device dispatch of multilevel RoIAlign (arguments as
    `multilevel_roi_align`): CUDA tensors go to K1 (mrt::roi_align), which
    computes the levels and sample points itself (no PyTorch op but the
    output allocation, for contiguous float32 boxes and levels), at every
    batch size, with K1-bwd as its gradient; CPU tensors to the plain
    version, through `RoIAlignFunction` when a level requires grad."""
    if (boxes.device.type == "cpu" and level_scales is None
            and torch.is_grad_enabled()
            and any(f.requires_grad for f in features)):
        return RoIAlignFunction.apply(boxes, pool_size, image_shape,
                                      *features)
    return _forward(features, boxes, pool_size, image_shape, level_scales,
                    out_dtype)


def _crop_rows(flat: torch.Tensor, boxes: torch.Tensor, pool_size: int,
               h_max: torch.Tensor, w_max: torch.Tensor,
               lvl_w: torch.Tensor, lvl_off: torch.Tensor) -> torch.Tensor:
    """The JAX package's `_crop_core_rows` over a flat [R, C] row table:
    floor and ceil corners clamped to the plane, weights from the
    unclamped fractions, the four taps summed in order, samples outside
    the plane zeroed. h_max/w_max [N] float32 (plane extent minus one),
    lvl_w [N] and lvl_off [N] int64 (plane width and first row). Integer
    tables blend in float32. The row index is computed in int64 (the JAX
    package sums it in float32, exact below 2^24 rows)."""
    boxes = boxes.to(torch.float32)
    n, c = boxes.shape[0], flat.shape[-1]
    in_y, in_x = sample_points(boxes, h_max, w_max, pool_size)
    out_y = (in_y < 0.0) | (in_y > h_max[:, None])
    out_x = (in_x < 0.0) | (in_x > w_max[:, None])
    y0 = torch.floor(in_y)
    x0 = torch.floor(in_x)
    wy = (in_y - y0)[:, :, None]                           # [N, P, 1]
    wx = (in_x - x0)[:, None, :]                           # [N, 1, P]
    zero = torch.zeros((), device=boxes.device)

    def clip(v, hi):
        return torch.minimum(torch.maximum(v, zero), hi[:, None])

    y0c, x0c = clip(y0, h_max).long(), clip(x0, w_max).long()
    y1c = clip(torch.ceil(in_y), h_max).long()
    x1c = clip(torch.ceil(in_x), w_max).long()
    cdtype = flat.dtype if flat.dtype.is_floating_point else torch.float32

    def corner(yy, xx, w):
        rows = (lvl_off[:, None, None] + yy[:, :, None] * lvl_w[:, None, None]
                + xx[:, None, :])
        g = flat[rows.reshape(-1)].reshape(n, pool_size, pool_size, c)
        return g.to(cdtype) * w[..., None].to(cdtype)

    out = corner(y0c, x0c, (1.0 - wy) * (1.0 - wx))
    out = out + corner(y0c, x1c, (1.0 - wy) * wx)
    out = out + corner(y1c, x0c, wy * (1.0 - wx))
    out = out + corner(y1c, x1c, wy * wx)
    inside = ~(out_y[:, :, None] | out_x[:, None, :])
    return torch.where(inside[..., None], out, 0.0)


def indexed_crop_and_resize(images: torch.Tensor, boxes: torch.Tensor,
                            box_indices: torch.Tensor,
                            crop_size: int) -> torch.Tensor:
    """crop_and_resize with an image index a box (the reference op's
    CropFunction(image, boxes, box_ind)): images [G, H, W, C], boxes
    [N, 4] normalized, box_indices [N] in [0, G) -> [N, crop, crop, C].
    The training mask targets crop each RoI's assigned gt mask with it
    (reference model.py:497-503). Plain PyTorch, no gradient."""
    g, h, w, c = images.shape
    idx = box_indices.long()
    dims = torch.full(idx.shape, 1.0, device=boxes.device)
    return _crop_rows(images.reshape(-1, c), boxes, crop_size,
                      dims * (h - 1.0), dims * (w - 1.0),
                      torch.full_like(idx, w), idx * (h * w))


def crop_and_resize(image: torch.Tensor, boxes: torch.Tensor,
                    crop_size: int) -> torch.Tensor:
    """Single-image crop_and_resize (crop_cpu.cpp:13-116): image
    [H, W, C], boxes [N, 4] normalized -> [N, crop, crop, C]."""
    zeros = torch.zeros(boxes.shape[0], dtype=torch.int64,
                        device=boxes.device)
    return indexed_crop_and_resize(image[None], boxes, zeros, crop_size)
