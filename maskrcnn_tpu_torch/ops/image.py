"""Image ops on the device (counterpart of maskrcnn_tpu/ops/image.py):
normalization and the batched resample onto the canvas
(Config.DEVICE_RESIZE)."""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from maskrcnn_tpu_torch.ops import device_tensor, ieee_float32


def normalize_image(image: torch.Tensor, mean_pixel) -> torch.Tensor:
    """uint8 RGB [..., H, W, 3] -> float32 minus the per-channel mean."""
    mean = device_tensor(mean_pixel, torch.float32, image.device)
    return image.to(torch.float32) - mean


def axis_resize_matrix(n_out: int, n_src: int, offset: torch.Tensor,
                       src_len: torch.Tensor,
                       out_len: torch.Tensor) -> torch.Tensor:
    """[B, n_out, n_src] bilinear resample matrices of one axis, one an
    image (maskrcnn_tpu.ops.image._axis_resize_matrix, batched).

    offset, src_len, out_len: [B] tensors on the device. Image b's source
    axis of src_len[b] pixels (in a buffer of n_src, zero-padded) maps
    onto the out_len[b] canvas pixels from offset[b]; canvas pixels
    outside that span get zero rows. Half-pixel centers with the edge
    clamped: for an upscale, Pillow's bilinear triangle filter (support
    1) up to its fixed-point weights; at scale 1 a one-hot placement, so
    the copy is exact. A downscale is not reproduced (the caller routes
    it to the host). The ratio divides tensor by tensor."""
    dev = offset.device
    offset, src_len, out_len = (t.to(torch.float32)[:, None]
                                for t in (offset, src_len, out_len))
    rel = torch.arange(n_out, dtype=torch.float32, device=dev) - offset
    src = (rel + 0.5) * (src_len / out_len) - 0.5
    src = torch.minimum(torch.clamp_min(src, 0.0), src_len - 1.0)
    k = torch.arange(n_src, dtype=torch.float32, device=dev)
    weights = torch.clamp_min(1.0 - torch.abs(src[..., None] - k), 0.0)
    inside = (rel >= 0) & (rel < out_len)
    return weights * inside[..., None].to(torch.float32)


def bucket_raws(images: Sequence[np.ndarray]
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Raw uint8 images [h, w, 3] -> (raws, sizes) for
    `batched_resize_pad`: the images zero-padded at the top left of one
    [B, Hb, Wb, 3] bucket, Hb and Wb the largest height and width rounded
    up to multiples of 64 (the JAX Detector's DEVICE_RESIZE bucket), and
    their [B, 2] int32 (h, w)."""
    hb = -(-max(img.shape[0] for img in images) // 64) * 64
    wb = -(-max(img.shape[1] for img in images) // 64) * 64
    raws = np.zeros((len(images), hb, wb, 3), np.uint8)
    for i, img in enumerate(images):
        raws[i, :img.shape[0], :img.shape[1]] = img
    return raws, np.asarray([img.shape[:2] for img in images], np.int32)


def batched_resize_pad(raws: torch.Tensor, windows: torch.Tensor,
                       sizes: torch.Tensor,
                       canvas_hw: Tuple[int, int]) -> torch.Tensor:
    """Raw images to canvases on the device
    (maskrcnn_tpu.ops.image.batched_resize_pad).

    raws [B, Hb, Wb, 3] uint8, each image zero-padded at the top left of
    a shared bucket; windows [B, 4] (y1, x1, y2, x2) canvas windows;
    sizes [B, 2] true (h, w); all on one device, so nothing waits on the
    host. Returns [B, CH, CW, 3] uint8: two products an image (rows,
    then columns) in IEEE float32 whatever the TF32 setting, rounded half
    to even and clipped to [0, 255]."""
    ch, cw = canvas_hw
    b, hb, wb, _ = raws.shape
    win = windows.to(torch.float32)
    vmat = axis_resize_matrix(ch, hb, win[:, 0], sizes[:, 0],
                              win[:, 2] - win[:, 0])        # [B, CH, Hb]
    hmat = axis_resize_matrix(cw, wb, win[:, 1], sizes[:, 1],
                              win[:, 3] - win[:, 1])        # [B, CW, Wb]
    rawf = raws.to(torch.float32).reshape(b, hb, wb * 3)
    with ieee_float32():
        rows = torch.matmul(vmat, rawf).reshape(b, ch, wb, 3)   # [B,CH,Wb,3]
        cols = rows.permute(0, 1, 3, 2).reshape(b, ch * 3, wb)
        out = torch.matmul(cols, hmat.transpose(1, 2))          # [B,CH*3,CW]
    out = out.reshape(b, ch, 3, cw).permute(0, 1, 3, 2)
    return torch.clamp(torch.round(out), 0.0, 255.0).to(
        torch.uint8).contiguous()
