"""Greedy NMS under fixed shapes (counterpart of maskrcnn_tpu/ops/nms.py).

Conventions, all the reference's (nms_cpu.cpp:11-70): the +1 pixel-area
IoU, suppression at `iou >= threshold`, boxes pre-sorted by descending
score, and invalid rows that neither survive nor suppress. Results are a
fixed-size keep mask, batched over [..., N].

`nms_mask` is the plain PyTorch version: the greedy recurrence as N
fixed steps of tensor ops (no data-dependent loop, no host sync). The
JAX default, a fixpoint `while_loop`, would read a flag back to the
host on every sweep in eager PyTorch. `nms_mask_impl` dispatches by
device: CUDA tensors go to the kernel (csrc/nms.cu), CPU tensors to
`nms_mask`.

`soft_nms_scores` is Gaussian soft-NMS (the JAX package's `lax.scan` of
select-and-decay steps) as a fixed number of batched tensor steps: plain
PyTorch on every device, with no host sync.
"""

from __future__ import annotations

import torch

from maskrcnn_tpu_torch.ops import device_tensor


def _iou_plus_one(boxes: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU [..., N, N] with the +1 area convention, in the op
    order of maskrcnn_tpu.ops.nms._iou_plus_one (the CUDA kernel follows
    the same order)."""
    y1, x1, y2, x2 = boxes.unbind(-1)
    areas = (x2 - x1 + 1.0) * (y2 - y1 + 1.0)
    yy1 = torch.maximum(y1[..., :, None], y1[..., None, :])
    xx1 = torch.maximum(x1[..., :, None], x1[..., None, :])
    yy2 = torch.minimum(y2[..., :, None], y2[..., None, :])
    xx2 = torch.minimum(x2[..., :, None], x2[..., None, :])
    w = torch.clamp_min(xx2 - xx1 + 1.0, 0.0)
    h = torch.clamp_min(yy2 - yy1 + 1.0, 0.0)
    inter = w * h
    union = areas[..., :, None] + areas[..., None, :] - inter
    return inter / union


def nms_mask(boxes: torch.Tensor, valid: torch.Tensor,
             iou_threshold: float) -> torch.Tensor:
    """Plain greedy NMS: boxes [..., N, 4] score-descending, valid
    [..., N] bool -> keep [..., N] bool."""
    n = boxes.shape[-2]
    lead = boxes.shape[:-2]
    boxes = boxes.reshape(-1, n, 4).to(torch.float32)
    valid = valid.reshape(-1, n)
    thr = device_tensor(iou_threshold, torch.float32, boxes.device)
    later = torch.ones(n, n, dtype=torch.bool,
                       device=boxes.device).triu(diagonal=1)
    # row j suppresses later column i when valid (rows of invalid boxes
    # are cleared, so they never suppress)
    smat = (_iou_plus_one(boxes) >= thr) & later & valid[:, :, None]
    suppressed = torch.zeros_like(valid)
    for j in range(n):
        alive = valid[:, j] & ~suppressed[:, j]
        suppressed = suppressed | (smat[:, j, :] & alive[:, None])
    return (~suppressed & valid).reshape(lead + (n,))


def nms_mask_impl(boxes: torch.Tensor, valid: torch.Tensor,
                  iou_threshold: float) -> torch.Tensor:
    """Device dispatch: the CUDA kernel for CUDA tensors, `nms_mask` for
    CPU tensors. Shapes as `nms_mask`."""
    if boxes.is_cuda:
        from maskrcnn_tpu_torch import kernels
        n = boxes.shape[-2]
        lead = boxes.shape[:-2]
        keep = kernels.nms(boxes.reshape(-1, n, 4).to(torch.float32)
                           .contiguous(),
                           valid.reshape(-1, n).contiguous(), iou_threshold)
        return keep.reshape(lead + (n,))
    if boxes.device.type == "cpu":
        return nms_mask(boxes, valid, iou_threshold)
    raise ValueError(f"nms: no implementation for device {boxes.device}")


def soft_nms_scores(boxes: torch.Tensor, scores: torch.Tensor,
                    valid: torch.Tensor, sigma: float,
                    iters: int) -> torch.Tensor:
    """Gaussian soft-NMS score decay (maskrcnn_tpu.ops.nms.soft_nms_scores),
    batched: boxes [B, N, 4], scores [B, N] (>= 0), valid [B, N] bool ->
    final scores [B, N] float32.

    Each of `iters` steps selects the highest-scored valid box not yet
    selected (ties to the lowest index, as jnp.argmax) and multiplies
    every other unselected score by exp(-iou^2 / sigma) over the +1 IoU;
    the selected box keeps its score at selection. Boxes never selected
    (beyond `iters`, or invalid) return 0.

    The JAX scan's values in six launches a step: the decay matrix is
    computed once (the same elementwise ops the scan applies to a row),
    with 1 on its diagonal so the selected box's own product leaves its
    score as it is; a selected or invalid box is `blocked`. An image with
    nothing left to select has every box blocked, so its step changes
    nothing and the scan's `has` flag is not needed: nothing is read back
    to the host. sigma divides as a float32 tensor (on CUDA a division by
    a Python scalar is a reciprocal multiply)."""
    iou = _iou_plus_one(boxes.to(torch.float32))
    sig = device_tensor(sigma, torch.float32, boxes.device)
    decay = torch.exp(-(iou * iou) / sig)
    decay.diagonal(dim1=-2, dim2=-1).fill_(1.0)
    cur = scores.to(torch.float32)
    blocked = ~valid
    n = decay.shape[-1]
    # a tensor, not a Python scalar: torch.where would make a device
    # scalar of it on every step
    ninf = torch.full((1, 1), float("-inf"), device=cur.device)
    for _ in range(iters):
        i = torch.argmax(torch.where(blocked, ninf, cur), dim=-1,
                         keepdim=True)                           # [B, 1]
        row = torch.gather(decay, 1, i[..., None].expand(-1, 1, n))[:, 0]
        cur = torch.where(blocked, cur, cur * row)
        blocked.scatter_(1, i, True)
    return torch.where(blocked & valid, cur, 0.0)


def multiclass_nms_mask(boxes: torch.Tensor, class_ids: torch.Tensor,
                        valid: torch.Tensor, iou_threshold: float,
                        coord_span: float) -> torch.Tensor:
    """Per-class NMS in one call via the class-offset trick: each class
    moves to a disjoint coordinate range (offset > span + 1, so even the
    +1 convention leaves a gap) and cross-class IoU is exactly 0.

    boxes [..., N, 4] sorted by descending score; class_ids [..., N];
    coord_span strictly larger than any coordinate."""
    offset = class_ids.to(boxes.dtype)[..., None] * (coord_span + 2.0)
    return nms_mask_impl(boxes + offset, valid, iou_threshold)
