"""ResNet-FPN backbone (counterpart of maskrcnn_tpu/models/fpn.py).

Lateral 1x1 convs on C2..C5, nearest x2 top-down adds, 3x3 smoothing
convs, and P6 = P5[::2, ::2] (the reference's MaxPool2d(1, 2),
model.py:109). Attribute names follow the checkpoint (fpn.C1.0,
fpn.C2.0.conv1, fpn.P2_conv2.1, ...).

`remat` (Config.REMAT_BACKBONE in the training construction) recomputes
each ResNet stage C2..C5 in the backward pass instead of keeping its
activations, as the JAX ResNet's nn.remat of a stage.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from maskrcnn_tpu_torch.models.layers import Conv2d
from maskrcnn_tpu_torch.models.resnet import BLOCKS, make_stage, make_stem


def nearest_upsample_2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour x2 of an NCHW map (each pixel repeated 2x2), the
    top-down path's upsample."""
    return F.interpolate(x, scale_factor=2.0)


class FPN(nn.Module):
    """Backbone + pyramid neck: NCHW images -> [P2, P3, P4, P5, P6]."""

    def __init__(self, architecture: str = "resnet101",
                 out_channels: int = 256, dtype=None, device=None,
                 fold_bn: bool = False, remat: bool = False):
        super().__init__()
        self.remat = remat
        blocks = BLOCKS[architecture]
        kw = dict(dtype=dtype, device=device)
        self.C1 = make_stem(fold_bn=fold_bn, **kw)
        kw["fold_bn"] = fold_bn
        self.C2 = make_stage(64, 64, blocks[0], 1, **kw)
        self.C3 = make_stage(256, 128, blocks[1], 2, **kw)
        self.C4 = make_stage(512, 256, blocks[2], 2, **kw)
        self.C5 = make_stage(1024, 512, blocks[3], 2, **kw)
        for lvl, cin in zip((2, 3, 4, 5), (256, 512, 1024, 2048)):
            setattr(self, f"P{lvl}_conv1", Conv2d(
                cin, out_channels, 1, dtype=dtype, device=device))
            # Sequential(SamePad, Conv) in the reference: the conv is `.1`
            setattr(self, f"P{lvl}_conv2", nn.Sequential(
                nn.Identity(),
                Conv2d(out_channels, out_channels, 3, padding=1,
                       dtype=dtype, device=device)))

    def _stage(self, stage: nn.Module, x: torch.Tensor) -> torch.Tensor:
        if self.remat and torch.is_grad_enabled():
            return checkpoint(stage, x, use_reentrant=False,
                              preserve_rng_state=False)
        return stage(x)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        c2 = self._stage(self.C2, self.C1(x))
        c3 = self._stage(self.C3, c2)
        c4 = self._stage(self.C4, c3)
        c5 = self._stage(self.C5, c4)
        p5 = self.P5_conv1(c5)
        p4 = self.P4_conv1(c4) + nearest_upsample_2x(p5)
        p3 = self.P3_conv1(c3) + nearest_upsample_2x(p4)
        p2 = self.P2_conv1(c2) + nearest_upsample_2x(p3)
        p5 = self.P5_conv2(p5)
        p4 = self.P4_conv2(p4)
        p3 = self.P3_conv2(p3)
        p2 = self.P2_conv2(p2)
        return [p2, p3, p4, p5, p5[:, :, ::2, ::2]]
