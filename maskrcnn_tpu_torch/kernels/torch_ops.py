"""The CUDA kernels K1-K4 as torch.library custom ops (namespace "mrt").

The port's CUDA path calls these ops, never the ctypes wrappers
directly: `torch.export` cannot trace a ctypes call on raw pointers, but
it records a custom op as one node, and each op's fake implementation
gives it the output's shape and dtype. The ops are registered for CUDA
tensors only; CPU tensors take the plain PyTorch versions in `ops/`,
so a program exported on the CPU is pure aten.

    mrt::roi_align           K1, float or int8 tables   kernels.roi_align
    mrt::roi_align_backward  K1-bwd (one flat buffer)   kernels
                                                        .roi_align_backward_flat
    mrt::nms                 K2                         kernels.nms
    mrt::bottleneck          K3                         kernels.bottleneck
    mrt::paste_pack          K4                         kernels.paste_pack

mrt::roi_align's gradient for the levels is mrt::roi_align_backward
(`register_autograd`); no gradient reaches the boxes. Each launch counts
on its wrapper (`kernels.<name>.launches`), in a live program and in a
loaded exported one alike.

This module imports torch and the package's ctypes bindings
(`maskrcnn_tpu_torch.kernels`: torch, ctypes and the standard library),
nothing of the model: a process that runs an exported program on the
card imports torch and this module.
"""

from __future__ import annotations

from typing import List

import torch

from maskrcnn_tpu_torch import kernels as _k


@torch.library.custom_op("mrt::roi_align", mutates_args=(),
                         device_types="cuda")
def roi_align(levels: List[torch.Tensor], boxes: torch.Tensor,
              pool_size: int, canvas_h: int, canvas_w: int,
              level_scales: List[float], out_dtype: torch.dtype
              ) -> torch.Tensor:
    """K1: levels P2..P5 NHWC, boxes [B*N, 4] float32 normalized, image
    major -> [B*N, P, P, C] in `out_dtype`. Float levels take no
    `level_scales` ([]) and write their own dtype; int8 levels take four
    scales and write float32 or bfloat16."""
    int8 = levels[0].dtype == torch.int8
    return _k.roi_align(levels, boxes, pool_size, (canvas_h, canvas_w),
                        level_scales if int8 else None,
                        out_dtype if int8 else None)


@roi_align.register_fake
def _(levels, boxes, pool_size, canvas_h, canvas_w, level_scales,
      out_dtype):
    return boxes.new_empty(
        (boxes.shape[0], pool_size, pool_size, levels[0].shape[3]),
        dtype=out_dtype)


@torch.library.custom_op("mrt::roi_align_backward", mutates_args=(),
                         device_types="cuda")
def roi_align_backward(grad: torch.Tensor, boxes: torch.Tensor,
                       shapes: List[int], dtype: torch.dtype, pool_size: int,
                       canvas_h: int, canvas_w: int) -> torch.Tensor:
    """K1-bwd: grad [B*N, P, P, C], the boxes K1 took, the four levels'
    shapes flattened (16 ints) and dtype -> the four level gradients
    flattened into one tensor, level after level (an op's outputs may not
    alias one another, and the kernel writes one buffer)."""
    g = grad.contiguous()
    if g.data_ptr() % 16:
        g = g.clone()
    return _k.roi_align_backward_flat(g, boxes, _dims(shapes), dtype,
                                      pool_size, (canvas_h, canvas_w))


def _dims(shapes: List[int]):
    return [tuple(shapes[4 * i:4 * i + 4]) for i in range(4)]


@roi_align_backward.register_fake
def _(grad, boxes, shapes, dtype, pool_size, canvas_h, canvas_w):
    n = sum(d[0] * d[1] * d[2] * d[3] for d in _dims(shapes))
    return grad.new_empty((n,), dtype=dtype)


def _roi_align_setup(ctx, inputs, output):
    levels, boxes, pool_size, canvas_h, canvas_w = inputs[:5]
    ctx.save_for_backward(boxes)
    ctx.geometry = ([d for f in levels for d in f.shape], levels[0].dtype,
                    pool_size, canvas_h, canvas_w)
    # one gradient slot an input, lists mirrored
    ctx.rest = [[None] * len(x) if isinstance(x, (list, tuple)) else None
                for x in inputs[1:]]


def _roi_align_grad(ctx, grad):
    boxes, = ctx.saved_tensors
    shapes, dtype, pool_size, canvas_h, canvas_w = ctx.geometry
    flat = torch.ops.mrt.roi_align_backward(grad, boxes, shapes, dtype,
                                            pool_size, canvas_h, canvas_w)
    dims = _dims(shapes)
    grads = [t.view(d) for t, d in zip(
        torch.split(flat, [d[0] * d[1] * d[2] * d[3] for d in dims]), dims)]
    return (grads, *ctx.rest)


torch.library.register_autograd("mrt::roi_align", _roi_align_grad,
                                setup_context=_roi_align_setup)


@torch.library.custom_op("mrt::nms", mutates_args=(), device_types="cuda")
def nms(boxes: torch.Tensor, valid: torch.Tensor,
        iou_threshold: float) -> torch.Tensor:
    """K2: boxes [B, N, 4] float32 score-descending, valid [B, N] bool ->
    keep [B, N] bool."""
    return _k.nms(boxes, valid, iou_threshold)


@nms.register_fake
def _(boxes, valid, iou_threshold):
    return torch.empty_like(valid)


@torch.library.custom_op("mrt::bottleneck", mutates_args=(),
                         device_types="cuda")
def bottleneck(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
               w2: torch.Tensor, b2: torch.Tensor, w3: torch.Tensor,
               b3: torch.Tensor) -> torch.Tensor:
    """K3: the folded identity bottleneck, x [B, H, W, 4P] NHWC."""
    return _k.bottleneck(x, w1, b1, w2, b2, w3, b3)


@bottleneck.register_fake
def _(x, w1, b1, w2, b2, w3, b3):
    return torch.empty_like(x)


@torch.library.custom_op("mrt::paste_pack", mutates_args=(),
                         device_types="cuda")
def paste_pack(masks: torch.Tensor, boxes: torch.Tensor, valid: torch.Tensor,
               height: int, width: int) -> torch.Tensor:
    """K4: masks [N, m, m] float32, boxes [N, 4], valid [N] ->
    [N, height, ceil(width / 8)] uint8 bit-packed canvas masks."""
    return _k.paste_pack(masks, boxes, valid, height, width)


@paste_pack.register_fake
def _(masks, boxes, valid, height, width):
    return masks.new_empty((masks.shape[0], height, -(-width // 8)),
                           dtype=torch.uint8)
