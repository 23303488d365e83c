"""Box and mask heads (counterpart of maskrcnn_tpu/models/heads.py).

Both take pooled RoI features in the JAX layout [N, P, P, 256] (NHWC);
the NCHW view the convs read is free because the pooled tensor is
contiguous NHWC, i.e. channels_last.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from maskrcnn_tpu_torch.models.layers import Conv2d, ConvTranspose2d, Linear
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
        x = pooled.to(self.conv1.weight.dtype).permute(0, 3, 1, 2)
        x = F.relu(self.bn1(self.conv1(x)))
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
        x = pooled.to(self.conv1.weight.dtype).permute(0, 3, 1, 2)
        for i in range(1, 5):
            x = F.relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x)))
        x = F.relu(self.deconv(x))
        x = self.conv5(x).to(torch.float32)
        return torch.sigmoid(x).permute(0, 2, 3, 1)
