"""Fused ResNet identity bottleneck, BN pre-folded (counterpart of
maskrcnn_tpu/ops/bottleneck_pallas.py).

    h1 = relu(x @ W1 + b1)            1x1 reduce    C -> P
    h2 = relu(conv3x3(h1) + b2)       3x3, SAME     P -> P
    y  = relu(h2 @ W3 + b3 + x)       1x1 expand    P -> C, residual

NHWC in and out, as in the JAX package. Weights in the layout the kernel
reads, K-major (output channel first, its inputs contiguous), as the
conv weights [O, I, kh, kw] already are: w1 [P, C], w2 [P, 9, P] (out,
tap dy*3+dx, in), w3 [C, P], all in x's dtype; biases float32. Each
weight slice the kernel loads is then one TMA box of 64 inputs by up to
128 outputs, the operand layout wgmma reads. `pack_weights` makes that
layout once, when the weights are loaded.

The plain version follows the Pallas kernel's numerics, not the unfused
module's: each product is accumulated in float32 from the x-dtype
operands, the bias is added in float32, and h1 and h2 are rounded to
x's dtype once, after the relu. The 3x3 reads zeros outside the image
(not relu(b1)), and the residual is added in float32 before the last
relu and the one cast to the output dtype. Any H and W.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

Weights = Tuple[torch.Tensor, ...]


def pack_weights(conv1_w: torch.Tensor, conv1_b: torch.Tensor,
                 conv2_w: torch.Tensor, conv2_b: torch.Tensor,
                 conv3_w: torch.Tensor, conv3_b: torch.Tensor,
                 dtype: torch.dtype, device) -> Weights:
    """Conv2d weights [O, I, kh, kw] and biases of the three folded convs
    -> (w1 [P, C], b1, w2 [P, 9, P], b2, w3 [C, P], b3): weights in
    `dtype`, biases float32, all contiguous on `device`."""
    p, c = conv1_w.shape[:2]

    def weight(w):
        return w.to(device=device, dtype=dtype).contiguous()

    def bias(b):
        return b.to(device=device, dtype=torch.float32).contiguous()

    return (weight(conv1_w.reshape(p, c)), bias(conv1_b),
            weight(conv2_w.permute(0, 2, 3, 1).reshape(p, 9, p)),
            bias(conv2_b),
            weight(conv3_w.reshape(c, p)), bias(conv3_b))


def fused_identity_bottleneck_plain(x: torch.Tensor, w1: torch.Tensor,
                                    b1: torch.Tensor, w2: torch.Tensor,
                                    b2: torch.Tensor, w3: torch.Tensor,
                                    b3: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: x [B, H, W, C] -> same shape
    and dtype. Weights as `pack_weights` returns them."""
    dtype = x.dtype
    _, h, w, _ = x.shape
    xf = x.to(torch.float32)
    h1 = torch.relu(xf @ w1.to(torch.float32).t() + b1).to(dtype)
    # SAME padding of the 3x3: zeros around the image
    h1p = F.pad(h1.to(torch.float32), (0, 0, 1, 1, 1, 1))
    w2f = w2.to(torch.float32)
    acc = None
    for tap in range(9):
        dy, dx = divmod(tap, 3)
        term = h1p[:, dy:dy + h, dx:dx + w] @ w2f[:, tap].t()
        acc = term if acc is None else acc + term
    h2 = torch.relu(acc + b2).to(dtype)
    y = h2.to(torch.float32) @ w3.to(torch.float32).t() + b3 + xf
    return torch.relu(y).to(dtype)


def fused_identity_bottleneck(x: torch.Tensor, w1: torch.Tensor,
                              b1: torch.Tensor, w2: torch.Tensor,
                              b2: torch.Tensor, w3: torch.Tensor,
                              b3: torch.Tensor) -> torch.Tensor:
    """Device dispatch: the CUDA kernel (csrc/bottleneck.cu, the
    mrt::bottleneck op) for CUDA tensors, the plain version for CPU
    tensors. Shapes as the plain
    version."""
    if x.is_cuda:
        from maskrcnn_tpu_torch.kernels import torch_ops
        return torch_ops.bottleneck(x.contiguous(), w1, b1, w2, b2, w3, b3)
    if x.device.type == "cpu":
        return fused_identity_bottleneck_plain(x, w1, b1, w2, b2, w3, b3)
    raise ValueError(f"bottleneck: no implementation for device {x.device}")
