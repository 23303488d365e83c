"""ResNet-50/101 stages (counterpart of maskrcnn_tpu/models/resnet.py).

BatchNorm is frozen by construction, as in the reference
(model.py:1010-1016, 1218-1223): an affine `x * scale + offset` from the
four stored tensors, computed in float32 and applied in the compute
dtype. The stride of a downsampling bottleneck sits on its 1x1 conv1
(reference model.py:179), not on the 3x3.

With `fold_bn` (Config.FOLD_BN, weights from checkpoint.fold) every BN
is the identity and applies nothing, and each identity block (block >= 1
of a stage) runs as one fused op, ops.bottleneck.fused_identity_bottleneck,
on weights packed once by `Bottleneck.pack`.
"""

from __future__ import annotations

from typing import Mapping

import torch
import torch.nn as nn
import torch.nn.functional as F

from maskrcnn_tpu_torch.models.layers import Conv2d
from maskrcnn_tpu_torch.ops.bottleneck import (fused_identity_bottleneck,
                                               pack_weights)

# nn.BatchNorm2d(..., eps=0.001) in the reference (model.py:180)
BN_EPS = 1e-3

BLOCKS = {"resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3)}


class FrozenBatchNorm(nn.Module):
    """y = x * scale + offset, scale = w / sqrt(var + eps),
    offset = b - mean * scale. The four tensors are float32 buffers under
    the torch BatchNorm names, so converted checkpoints load 1:1.
    `folded=True` keeps the buffers (the state dict is unchanged) and
    returns x: the affine already lives in the conv before it."""

    def __init__(self, features: int, device=None, folded: bool = False):
        super().__init__()
        self.folded = folded
        kw = dict(dtype=torch.float32, device=device)
        self.register_buffer("weight", torch.ones(features, **kw))
        self.register_buffer("bias", torch.zeros(features, **kw))
        self.register_buffer("running_mean", torch.zeros(features, **kw))
        self.register_buffer("running_var", torch.ones(features, **kw))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.folded:
            return x
        scale = self.weight / torch.sqrt(self.running_var + BN_EPS)
        offset = self.bias - self.running_mean * scale
        return (x * scale.to(x.dtype)[:, None, None]
                + offset.to(x.dtype)[:, None, None])


class Bottleneck(nn.Module):
    """1x1(stride) -> 3x3 -> 1x1(x4), frozen BN after each conv. A folded
    identity block runs the fused op on the weights `pack` made."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False, dtype=None, device=None,
                 fold_bn: bool = False):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.conv1 = Conv2d(inplanes, planes, 1, stride=stride, **kw)
        self.bn1 = FrozenBatchNorm(planes, device, fold_bn)
        self.conv2 = Conv2d(planes, planes, 3, padding=1, **kw)
        self.bn2 = FrozenBatchNorm(planes, device, fold_bn)
        self.conv3 = Conv2d(planes, planes * 4, 1, **kw)
        self.bn3 = FrozenBatchNorm(planes * 4, device, fold_bn)
        self.downsample = (nn.Sequential(
            Conv2d(inplanes, planes * 4, 1, stride=stride, **kw),
            FrozenBatchNorm(planes * 4, device, fold_bn))
            if downsample else None)
        self.fused = fold_bn and not downsample
        self.packed = None

    @torch.no_grad()
    def pack(self, state: Mapping[str, torch.Tensor], prefix: str) -> None:
        """Pack the fused op's weights from the state dict being loaded
        (`prefix` is this block's, e.g. "fpn.C2.1."): weights in the
        compute dtype, biases kept in float32 as the state holds them,
        which the conv modules (compute-dtype biases) cannot."""
        conv = self.conv1.weight
        self.packed = pack_weights(
            *[state[f"{prefix}conv{i}.{k}"] for i in (1, 2, 3)
              for k in ("weight", "bias")], conv.dtype, conv.device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fused:
            if self.packed is None:
                raise RuntimeError("folded bottleneck used before its "
                                   "weights were loaded")
            # channels_last NCHW <-> contiguous NHWC: free views
            y = fused_identity_bottleneck(x.permute(0, 2, 3, 1),
                                          *self.packed)
            return y.permute(0, 3, 1, 2)
        residual = x if self.downsample is None else self.downsample(x)
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return F.relu(out + residual)


def make_stage(inplanes: int, planes: int, blocks: int, stride: int,
               dtype=None, device=None, fold_bn: bool = False
               ) -> nn.Sequential:
    """A stack of bottlenecks; the first one downsamples
    (reference model.py:251-270)."""
    layers = [Bottleneck(inplanes, planes, stride, downsample=True,
                         dtype=dtype, device=device, fold_bn=fold_bn)]
    layers += [Bottleneck(planes * 4, planes, dtype=dtype, device=device,
                          fold_bn=fold_bn)
               for _ in range(1, blocks)]
    return nn.Sequential(*layers)


def stem_pool(x: torch.Tensor) -> torch.Tensor:
    """SamePad(3, 2) + MaxPool(3, 2) on NCHW: pads (0, 1) on both axes with
    -inf, as flax's max_pool does (reference model.py:223-229)."""
    x = F.pad(x, (0, 1, 0, 1), value=float("-inf"))
    return F.max_pool2d(x, 3, 2).contiguous(memory_format=torch.channels_last)


class StemPool(nn.Module):
    """`stem_pool` as a module of the stem's Sequential."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return stem_pool(x)


def make_stem(dtype=None, device=None, fold_bn: bool = False
              ) -> nn.Sequential:
    """C1: 7x7/2 conv (pad 3), frozen BN, ReLU, stem pool. Sequential
    indices 0/1 are the checkpoint's `C1.0` / `C1.1`."""
    return nn.Sequential(
        Conv2d(3, 64, 7, stride=2, padding=3, dtype=dtype, device=device),
        FrozenBatchNorm(64, device, fold_bn), nn.ReLU(), StemPool())
