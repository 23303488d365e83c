"""Box, mask and keypoint heads (counterpart of
maskrcnn_tpu/models/heads.py).

All take pooled RoI features in the JAX layout [N, P, P, 256] (NHWC);
the NCHW view the convs read is free because the pooled tensor is
contiguous NHWC, i.e. channels_last.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from maskrcnn_tpu_torch.models.layers import (Conv2d, ConvTranspose2d, Linear,
                                              _add_bias)
from maskrcnn_tpu_torch.models.resnet import FrozenBatchNorm


class BoxHead(nn.Module):
    """pooled [N, 7, 7, 256] -> (logits [N, K], probs [N, K],
    deltas [N, K, 4]), all float32 (reference model.py:724-800)."""

    def __init__(self, num_classes: int, pool_size: int = 7, dtype=None,
                 device=None, fold_bn: bool = False):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.num_classes = num_classes
        # a pool_size conv with no padding: one dense map per RoI
        self.conv1 = Conv2d(256, 1024, pool_size, **kw)
        self.bn1 = FrozenBatchNorm(1024, device, fold_bn)
        self.conv2 = Conv2d(1024, 1024, 1, **kw)
        self.bn2 = FrozenBatchNorm(1024, device, fold_bn)
        self.linear_class = Linear(1024, num_classes, **kw)
        self.linear_bbox = Linear(1024, num_classes * 4, **kw)

    def forward(self, pooled: torch.Tensor):
        x = pooled.to(self.conv1.act_dtype)
        if self.conv1.compute_dtype is None:
            x = self.conv1(x.permute(0, 3, 1, 2))
        else:
            # the training construction: the pool_size conv over a
            # pool_size map is one product, run as a linear over the
            # flattened NHWC features so its weight gradient is one GEMM
            # (cuDNN's NHWC weight gradient for this shape took 44 ms of a
            # B=4 training step on an H100)
            w, b = self.conv1._weights()
            w = w.permute(0, 2, 3, 1).reshape(w.shape[0], -1)
            x = _add_bias(F.linear(x.reshape(x.shape[0], -1), w), b)
            x = x[:, :, None, None]
        x = F.relu(self.bn1(x))
        x = F.relu(self.bn2(self.conv2(x)))
        x = x.reshape(x.shape[0], 1024)
        logits = self.linear_class(x).to(torch.float32)
        bbox = self.linear_bbox(x).to(torch.float32)
        return (logits, torch.softmax(logits, dim=-1),
                bbox.reshape(-1, self.num_classes, 4))


class MaskHead(nn.Module):
    """pooled [N, 14, 14, 256] -> per-class sigmoid masks [N, 28, 28, K]
    float32 (reference model.py:848-920)."""

    def __init__(self, num_classes: int, dtype=None, device=None,
                 fold_bn: bool = False):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        for i in range(1, 5):
            setattr(self, f"conv{i}", Conv2d(256, 256, 3, padding=1, **kw))
            setattr(self, f"bn{i}", FrozenBatchNorm(256, device, fold_bn))
        # kernel == stride: no overlap, equal to the JAX DeconvK2S2
        self.deconv = ConvTranspose2d(256, 256, 2, stride=2, **kw)
        self.conv5 = Conv2d(256, num_classes, 1, **kw)

    def forward(self, pooled: torch.Tensor) -> torch.Tensor:
        x = pooled.to(self.conv1.act_dtype).permute(0, 3, 1, 2)
        for i in range(1, 5):
            x = F.relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x)))
        x = F.relu(self.deconv(x))
        x = self.conv5(x).to(torch.float32)
        return torch.sigmoid(x).permute(0, 2, 3, 1)


def _upsample_axis(x: torch.Tensor, dim: int) -> torch.Tensor:
    """One axis of `upsample_2x`: output 2i + 1 blends inputs i and i + 1
    (0.75, 0.25), output 2i inputs i - 1 and i (0.25, 0.75); outputs 0
    and 2n - 1 are inputs 0 and n - 1 (F.interpolate's clamped edge taps,
    (1, 0) and (0.75, 0.25) on one input, give exactly that)."""
    n = x.shape[dim]
    lo, hi = x.narrow(dim, 0, n - 1), x.narrow(dim, 1, n - 1)
    even = torch.cat([x.narrow(dim, 0, 1), lo * 0.25 + hi * 0.75], dim)
    odd = torch.cat([lo * 0.75 + hi * 0.25, x.narrow(dim, n - 1, 1)], dim)
    return torch.stack([even, odd], dim + 1).flatten(dim, dim + 1)


def upsample_2x(x: torch.Tensor) -> torch.Tensor:
    """x [N, C, H, W] float -> [N, C, 2H, 2W]: the fixed 2x bilinear
    upsample with half-pixel centers of F.interpolate(scale_factor=2,
    mode="bilinear", align_corners=False), width then height, each a
    blend of two taps. Its autograd (slices, products, sums, cat, stack)
    is deterministic. F.interpolate on the CPU contracts a blend into a
    fused multiply-add, so the two differ in the last bits
    (tests/test_torch_determinism.py states the bound)."""
    return _upsample_axis(_upsample_axis(x, 3), 2)


class KeypointHead(nn.Module):
    """pooled [N, P, P, 256] -> per-keypoint heatmap logits [N, 4P, 4P, K]
    float32 (the JAX KeypointHead: `convs` x conv3x3 at `dim` with ReLU,
    the 2x2 stride-2 deconv, ReLU, a 1x1 score conv, then a fixed 2x
    bilinear upsample with half-pixel centers). No BN.

    The upsample is `upsample_2x`: F.interpolate(align_corners=False)'s
    taps written as slices, products and sums, whose gradient is
    deterministic on the card (F.interpolate's bilinear backward is not,
    and raises under the training step's deterministic mode).
    jax.image.resize renormalizes the edge taps instead of clamping the
    coordinate; at an exact 2x upscale both give weights (1) at the edges
    and (0.75, 0.25) inside, equal in exact arithmetic, so values may
    differ in the last bits (tests/test_torch_protocols.py states the
    bound)."""

    def __init__(self, num_keypoints: int, convs: int = 8, dim: int = 512,
                 dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.convs = convs
        for i in range(1, convs + 1):
            setattr(self, f"conv{i}", Conv2d(256 if i == 1 else dim, dim, 3,
                                             padding=1, **kw))
        self.deconv = ConvTranspose2d(dim, dim, 2, stride=2, **kw)
        self.score = Conv2d(dim, num_keypoints, 1, **kw)

    def forward(self, pooled: torch.Tensor) -> torch.Tensor:
        x = pooled.to(self.deconv.act_dtype).permute(0, 3, 1, 2)
        for i in range(1, self.convs + 1):
            x = F.relu(getattr(self, f"conv{i}")(x))
        x = F.relu(self.deconv(x))
        logits = self.score(x).to(torch.float32)
        return upsample_2x(logits).permute(0, 2, 3, 1)
