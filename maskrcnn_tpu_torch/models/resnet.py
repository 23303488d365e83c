"""ResNet-50/101 stages (counterpart of maskrcnn_tpu/models/resnet.py).

BatchNorm is frozen by construction, as in the reference
(model.py:1010-1016, 1218-1223): an affine `x * scale + offset` from the
four stored tensors, computed in float32 and applied in the compute
dtype. The stride of a downsampling bottleneck sits on its 1x1 conv1
(reference model.py:179), not on the 3x3.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

# nn.BatchNorm2d(..., eps=0.001) in the reference (model.py:180)
BN_EPS = 1e-3

BLOCKS = {"resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3)}


class FrozenBatchNorm(nn.Module):
    """y = x * scale + offset, scale = w / sqrt(var + eps),
    offset = b - mean * scale. The four tensors are float32 buffers under
    the torch BatchNorm names, so converted checkpoints load 1:1."""

    def __init__(self, features: int, device=None):
        super().__init__()
        kw = dict(dtype=torch.float32, device=device)
        self.register_buffer("weight", torch.ones(features, **kw))
        self.register_buffer("bias", torch.zeros(features, **kw))
        self.register_buffer("running_mean", torch.zeros(features, **kw))
        self.register_buffer("running_var", torch.ones(features, **kw))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale = self.weight / torch.sqrt(self.running_var + BN_EPS)
        offset = self.bias - self.running_mean * scale
        return (x * scale.to(x.dtype)[:, None, None]
                + offset.to(x.dtype)[:, None, None])


class Bottleneck(nn.Module):
    """1x1(stride) -> 3x3 -> 1x1(x4), frozen BN after each conv."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False, dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.conv1 = nn.Conv2d(inplanes, planes, 1, stride=stride, **kw)
        self.bn1 = FrozenBatchNorm(planes, device)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, **kw)
        self.bn2 = FrozenBatchNorm(planes, device)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, **kw)
        self.bn3 = FrozenBatchNorm(planes * 4, device)
        self.downsample = (nn.Sequential(
            nn.Conv2d(inplanes, planes * 4, 1, stride=stride, **kw),
            FrozenBatchNorm(planes * 4, device)) if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x if self.downsample is None else self.downsample(x)
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return F.relu(out + residual)


def make_stage(inplanes: int, planes: int, blocks: int, stride: int,
               dtype=None, device=None) -> nn.Sequential:
    """A stack of bottlenecks; the first one downsamples
    (reference model.py:251-270)."""
    layers = [Bottleneck(inplanes, planes, stride, downsample=True,
                         dtype=dtype, device=device)]
    layers += [Bottleneck(planes * 4, planes, dtype=dtype, device=device)
               for _ in range(1, blocks)]
    return nn.Sequential(*layers)


class StemPool(nn.Module):
    """SamePad(3, 2) + MaxPool(3, 2): pads (0, 1) on both axes with -inf,
    as flax's max_pool does (reference model.py:223-229)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.pad(x, (0, 1, 0, 1), value=float("-inf"))
        return F.max_pool2d(x, 3, 2).contiguous(
            memory_format=torch.channels_last)


def make_stem(dtype=None, device=None) -> nn.Sequential:
    """C1: 7x7/2 conv (pad 3), frozen BN, ReLU, stem pool. Sequential
    indices 0/1 are the checkpoint's `C1.0` / `C1.1`."""
    return nn.Sequential(
        nn.Conv2d(3, 64, 7, stride=2, padding=3, dtype=dtype, device=device),
        FrozenBatchNorm(64, device), nn.ReLU(), StemPool())
