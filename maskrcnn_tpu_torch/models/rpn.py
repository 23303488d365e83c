"""Region Proposal Network, fused inference form (counterpart of
maskrcnn_tpu/models/rpn.py and MaskRCNN.rpn_scores in
maskrcnn_tpu/models/mask_rcnn.py:148-195).

The class and box 1x1 convs run as ONE 18-channel conv, class channels
first. The foreground score is sigmoid(float32(l1 - l0)): softmax over
two logits, with the subtraction in the compute dtype and the cast
before the sigmoid. The deltas stay in the compute dtype; the proposal
layer casts only its top-k survivors.
"""

from __future__ import annotations

from typing import Iterable, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from maskrcnn_tpu_torch.models.layers import Conv2d, conv2d


class RPN(nn.Module):
    """Shared 3x3 conv -> (2A class logits, 4A box deltas) per location,
    one head for every level."""

    def __init__(self, anchors_per_location: int = 3, anchor_stride: int = 1,
                 dtype=None, device=None):
        super().__init__()
        a = anchors_per_location
        kw = dict(dtype=dtype, device=device)
        self.anchors_per_location = a
        self.conv_shared = Conv2d(256, 512, 3, stride=anchor_stride,
                                  padding=1, **kw)
        self.conv_class = Conv2d(512, 2 * a, 1, **kw)
        self.conv_bbox = Conv2d(512, 4 * a, 1, **kw)

    def forward(self, feature_maps: Sequence[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """NCHW maps -> (scores [B, A] float32, deltas [B, A, 4] compute
        dtype), anchors in (level, y, x, ratio) order."""
        return self.outputs(F.relu(self.conv_shared(f)) for f in feature_maps)

    def outputs(self, shared_maps: Iterable[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The fused 1x1 over each level's shared map (NCHW, after the
        ReLU), levels in order -> (scores, deltas) as `forward`. The int8
        path (quant.rpn_scores_forward) hands its own shared maps here."""
        a = self.anchors_per_location
        weight = torch.cat([self.conv_class.weight, self.conv_bbox.weight])
        bias = torch.cat([self.conv_class.bias, self.conv_bbox.bias])
        scores, deltas = [], []
        for shared in shared_maps:
            # NHWC before the reshape: (y, x, ratio) anchor order
            y = conv2d(shared, weight, bias).permute(0, 2, 3, 1)
            b = y.shape[0]
            cls = y[..., :2 * a].reshape(b, -1, 2)
            scores.append(torch.sigmoid(
                (cls[..., 1] - cls[..., 0]).to(torch.float32)))
            deltas.append(y[..., 2 * a:].reshape(b, -1, 4))
        return torch.cat(scores, dim=1), torch.cat(deltas, dim=1)
