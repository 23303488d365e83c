"""Full-canvas mask pasting (counterpart of maskrcnn_tpu/ops/mask_paste.py).

Bilinear resize is separable, so pasting a 28x28 mask into its box is two
batched matmuls against one-hot interpolation operators,
    full[n] = Wy[n] @ q[n] @ Wx[n]^T,
as in the JAX package, which leaves these to XLA; here they are
`torch.bmm` in float32. The quirks of the reference's PIL pipeline
(uint8 quantisation of mask*255, half-pixel centres, `> 127` threshold)
are kept as documented there. Detections go through in chunks of 8 to
bound the transient [chunk, H, W] float32 canvas.

`paste_masks_packed` dispatches by device: CUDA tensors go to the fused
paste-threshold-pack kernel (csrc/paste_pack.cu, one launch for all
detections, only the packed bits written), CPU tensors to the chunked
matmul version, `paste_masks_packed_plain`, which is the kernel's plain
version.
"""

from __future__ import annotations

import torch

from maskrcnn_tpu_torch.ops.bits import pack_masks_device


def _interp_operator(starts: torch.Tensor, sizes: torch.Tensor,
                     out_dim: int, m: int) -> torch.Tensor:
    """One-hot bilinear operator [N, out_dim, m] (PIL half-pixel
    convention, edge clamp, zero rows outside [start, start+size))."""
    ys = torch.arange(out_dim, dtype=torch.float32, device=starts.device)
    sizes = torch.clamp_min(sizes, 1.0)
    # a true division: `m / tensor` is reciprocal-then-multiply in PyTorch
    ratio = torch.full_like(sizes, float(m)) / sizes
    my = (ys[None, :] - starts[:, None] + 0.5) * ratio[:, None] - 0.5
    inside = ((ys[None, :] >= starts[:, None])
              & (ys[None, :] < starts[:, None] + sizes[:, None]))
    my = torch.clamp(my, 0.0, m - 1.0)
    i0 = torch.floor(my)
    frac = my - i0
    i1 = torch.clamp_max(i0 + 1.0, m - 1.0)
    taps = torch.arange(m, dtype=torch.float32, device=starts.device)
    w0 = (taps[None, None, :] == i0[:, :, None]) * (1.0 - frac)[:, :, None]
    w1 = (taps[None, None, :] == i1[:, :, None]) * frac[:, :, None]
    return (w0 + w1) * inside[:, :, None]


def paste_masks(masks: torch.Tensor, boxes: torch.Tensor, height: int,
                width: int) -> torch.Tensor:
    """masks [N, m, m] in [0, 1] (class-selected), boxes [N, 4] integral
    pixel coords -> [N, height, width] bool."""
    _, mh, mw = masks.shape
    boxes = boxes.to(torch.float32)
    # uint8 quantisation of the reference's convert('L') (data.py:291-294)
    q = torch.floor(torch.clamp(masks.to(torch.float32) * 255.0, 0.0, 255.0))
    y1, x1, y2, x2 = boxes.unbind(-1)
    wy = _interp_operator(y1, y2 - y1, height, mh)           # [N, H, m]
    wx = _interp_operator(x1, x2 - x1, width, mw)            # [N, W, m]
    rows = torch.bmm(wy, q)                                  # [N, H, m]
    return torch.bmm(rows, wx.transpose(1, 2)) > 127.5       # [N, H, W]


def paste_masks_packed_plain(masks: torch.Tensor, boxes: torch.Tensor,
                             valid: torch.Tensor, height: int, width: int,
                             chunk: int = 8) -> torch.Tensor:
    """paste_masks, ANDed with valid [N] and bit-packed per chunk of
    detections, so only the packed bytes outlive a chunk.
    Returns [N, height, ceil(width/8)] uint8 (np.unpackbits order)."""
    out = [pack_masks_device(paste_masks(m, b, height, width)
                             & v[:, None, None])
           for m, b, v in zip(masks.split(chunk), boxes.split(chunk),
                              valid.split(chunk))]
    return torch.cat(out)


def paste_masks_packed(masks: torch.Tensor, boxes: torch.Tensor,
                       valid: torch.Tensor, height: int,
                       width: int) -> torch.Tensor:
    """Device dispatch of `paste_masks_packed_plain` (same arguments and
    result): the CUDA kernel (the mrt::paste_pack op) for CUDA tensors,
    the plain version for CPU tensors."""
    if masks.is_cuda:
        from maskrcnn_tpu_torch.kernels import torch_ops
        return torch_ops.paste_pack(masks.to(torch.float32).contiguous(),
                                    boxes.to(torch.float32).contiguous(),
                                    valid.contiguous(), int(height),
                                    int(width))
    if masks.device.type == "cpu":
        return paste_masks_packed_plain(masks, boxes, valid, height, width)
    raise ValueError(f"paste: no implementation for device {masks.device}")


def _pil_resize_operator(top: torch.Tensor, span: torch.Tensor,
                         out_size: torch.Tensor, in_dim: int,
                         out_dim: int) -> torch.Tensor:
    """[out_dim, in_dim] operator of PIL Image.resize(BILINEAR) applied to
    canvas[top : top+span] with `out_size` output pixels: antialiased
    triangle taps (support scales with the reduction), renormalised,
    rows >= out_size zero. Scalars are 0-dim tensors."""
    span = torch.clamp_min(span.to(torch.float32), 1.0)
    out_size = torch.clamp_min(out_size.to(torch.float32), 1.0)
    top = top.to(torch.float32)
    scale = span / out_size
    fs = torch.clamp_min(scale, 1.0)
    ys = torch.arange(out_dim, dtype=torch.float32, device=top.device)
    ds = torch.arange(in_dim, dtype=torch.float32, device=top.device)
    center = top + (ys + 0.5) * scale
    w = torch.clamp_min(1.0 - torch.abs(ds[None, :] + 0.5
                                        - center[:, None]) / fs, 0.0)
    inside = (ds[None, :] >= top) & (ds[None, :] < top + span)
    w = w * inside
    w = w / torch.clamp_min(w.sum(dim=1, keepdim=True), 1e-12)
    return w * (ys[:, None] < out_size)


def masks_to_original(canvas_masks: torch.Tensor, window: torch.Tensor,
                      orig_h: torch.Tensor, orig_w: torch.Tensor,
                      out_dim: int, chunk: int = 8) -> torch.Tensor:
    """One image's canvas masks [N, CH, CW] bool -> [N, out_dim, out_dim]
    bool in original-image coordinates (mask in rows [:orig_h, :orig_w]):
    the reference's decode_masks (crop the window, PIL-resize, > 127) as
    two matmuls per chunk. window [4] (top, left, bottom, right);
    orig_h/orig_w 0-dim tensors <= out_dim."""
    _, dh, dw = canvas_masks.shape
    window = window.to(torch.float32)
    ry = _pil_resize_operator(window[0], window[2] - window[0], orig_h,
                              dh, out_dim)                   # [OUT, CH]
    rx = _pil_resize_operator(window[1], window[3] - window[1], orig_w,
                              dw, out_dim)                   # [OUT, CW]
    out = [torch.matmul(torch.matmul(ry, m.to(torch.float32) * 255.0),
                        rx.t()) > 127.5
           for m in canvas_masks.split(chunk)]
    return torch.cat(out)
