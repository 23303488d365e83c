"""RetinaNet-FPN, the one-stage detector (counterpart of
maskrcnn_tpu/models/retina_fpn.py; reference fpn/retina_fpn.py:12-127).

Bias-free ResNet convs with the stride on the bottleneck's 3x3, P3..P7
(stride-2 convs for P6 and P7, bilinear top-down adds), a dense class
and box head shared across the levels (cls_out's bias -4.595, a prior of
0.01), focal loss on the RPN's anchor matcher, and a class-offset NMS
in `detect`, whose NMS is K2 (csrc/nms.cu) on the card.

Module names follow the JAX tree (`fpn.layer2_block0.conv1`,
`head.cls_out`, ...): `checkpoint.convert.from_jax_retina_params` reads a
`RetinaNet.init` tree. The public functions take and return the JAX
layouts: images [B, H, W, 3], logits [B, A, K], deltas [B, A, 4], anchor
order (level, y, x, ratio).

The top-down upsample is `bilinear_resize`, jax.image.resize's
"bilinear" written out: its weight matrices (half-pixel centres, taps
outside the source renormalised away) made with the same float32 ops,
contracted by two products. F.interpolate clamps the edge taps instead,
which rounds the edge rows differently; the products may also sum in
another order than XLA's einsum (ROADMAP Queue 3 states the tolerance).

Config.QUANT_INT8 (`quant.prepare_retina_quant_params`, `set_quant`):
`forward` runs the int8 twin, `quant.retina_quant_forward`, as the JAX
RetinaNet.forward does for a tree with "quant".
"""

from __future__ import annotations

import functools
from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from maskrcnn_tpu_torch.config import Config
from maskrcnn_tpu_torch.models.layers import Conv2d, set_compute_dtype
from maskrcnn_tpu_torch.models.mask_rcnn import check_supported, resolve_device
from maskrcnn_tpu_torch.models.resnet import FrozenBatchNorm
from maskrcnn_tpu_torch.ops import boxes as box_ops
from maskrcnn_tpu_torch.ops import device_tensor
from maskrcnn_tpu_torch.ops.anchors import generate_pyramid_anchors
from maskrcnn_tpu_torch.ops.nms import multiclass_nms_mask
from maskrcnn_tpu_torch.train.losses import smooth_l1

STRIDES = (8, 16, 32, 64, 128)
PRIOR_BIAS = -4.595   # log(0.01 / 0.99): every class starts at p = 0.01
FOCAL_ALPHA = 0.25


@functools.lru_cache(maxsize=64)
def _resize_matrix(n_in: int, n_out: int, device: torch.device,
                   dtype: torch.dtype) -> torch.Tensor:
    """jax.image.compute_weight_mat for the triangle kernel, scale
    n_out / n_in, no translation, antialias on: [n_in, n_out], made in
    float32 on the CPU, rounded to `dtype` (as jax.image rounds it) and
    kept on `device` (a copy from pageable memory a call would make the
    host wait for the card)."""
    scale = torch.tensor(n_out / n_in, dtype=torch.float32)
    inv = 1.0 / scale
    kernel_scale = torch.clamp_min(inv, 1.0)
    sample = (torch.arange(n_out, dtype=torch.float32) + 0.5) * inv - 0.5
    x = torch.abs(sample[None, :] - torch.arange(
        n_in, dtype=torch.float32)[:, None]) / kernel_scale
    w = torch.clamp_min(1.0 - torch.abs(x), 0.0)
    total = torch.sum(w, dim=0, keepdim=True)
    eps = float(np.finfo(np.float32).eps)
    w = torch.where(torch.abs(total) > 1000.0 * eps,
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, 0.0).to(dtype).to(device)


def bilinear_resize(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """jax.image.resize(x, (B, out_h, out_w, C), "bilinear") of an NCHW
    map -> NCHW, in x's dtype (float32 products: the weights are rounded
    to x's dtype first, as jax.image rounds them)."""
    _, _, h, w = x.shape
    y = x
    if out_h != h:
        wh = _resize_matrix(h, out_h, x.device, x.dtype)
        y = torch.einsum("bchw,hH->bcHw", y, wh)
    if out_w != w:
        ww = _resize_matrix(w, out_w, x.device, x.dtype)
        y = torch.einsum("bchw,wW->bchW", y, ww)
    return y.contiguous(memory_format=torch.channels_last)


class RetinaBottleneck(nn.Module):
    """Bias-free bottleneck (reference fpn/retina_fpn.py:12-42): the stride
    sits on the 3x3 conv2; a shortcut conv when the shape changes."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dtype=None, device=None):
        super().__init__()
        kw = dict(bias=False, dtype=dtype, device=device)
        self.conv1 = Conv2d(inplanes, planes, 1, **kw)
        self.bn1 = FrozenBatchNorm(planes, device)
        self.conv2 = Conv2d(planes, planes, 3, stride=stride, padding=1, **kw)
        self.bn2 = FrozenBatchNorm(planes, device)
        self.conv3 = Conv2d(planes, planes * 4, 1, **kw)
        self.bn3 = FrozenBatchNorm(planes * 4, device)
        self.has_shortcut = stride != 1 or inplanes != planes * 4
        if self.has_shortcut:
            self.shortcut_conv = Conv2d(inplanes, planes * 4, 1,
                                        stride=stride, **kw)
            self.shortcut_bn = FrozenBatchNorm(planes * 4, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        residual = (self.shortcut_bn(self.shortcut_conv(x))
                    if self.has_shortcut else x)
        return F.relu(out + residual)


_STAGES = (("layer2", 64, 1), ("layer3", 128, 2), ("layer4", 256, 2),
           ("layer5", 512, 2))


class RetinaFPN(nn.Module):
    """P3..P7 pyramid (reference fpn/retina_fpn.py:45-122): NCHW images
    -> five 256-channel NCHW maps at strides 8..128."""

    def __init__(self, num_blocks: Sequence[int] = (2, 2, 2, 2), dtype=None,
                 device=None):
        super().__init__()
        self.num_blocks = tuple(num_blocks)
        kw = dict(dtype=dtype, device=device)
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False, **kw)
        self.bn1 = FrozenBatchNorm(64, device)
        inplanes = 64
        for (layer, planes, stride), n in zip(_STAGES, self.num_blocks):
            for i in range(n):
                setattr(self, f"{layer}_block{i}", RetinaBottleneck(
                    inplanes, planes, stride if i == 0 else 1, **kw))
                inplanes = planes * 4
        self.conv6 = Conv2d(2048, 256, 3, stride=2, padding=1, **kw)
        self.conv7 = Conv2d(256, 256, 3, stride=2, padding=1, **kw)
        self.toplayer = Conv2d(2048, 256, 1, **kw)
        self.latlayer1 = Conv2d(1024, 256, 1, **kw)
        self.latlayer2 = Conv2d(512, 256, 1, **kw)
        self.smooth1 = Conv2d(256, 256, 3, padding=1, **kw)
        self.smooth2 = Conv2d(256, 256, 3, padding=1, **kw)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        c = F.relu(self.bn1(self.conv1(x)))
        c = F.max_pool2d(c, 3, 2, padding=1)
        outs = []
        for (layer, _, _), n in zip(_STAGES, self.num_blocks):
            for i in range(n):
                c = getattr(self, f"{layer}_block{i}")(c)
            outs.append(c)
        c3, c4, c5 = outs[1:]
        p6 = self.conv6(c5)
        p7 = self.conv7(F.relu(p6))
        p5 = self.toplayer(c5)
        lat4 = self.latlayer1(c4)
        p4 = bilinear_resize(p5, lat4.shape[2], lat4.shape[3]) + lat4
        lat3 = self.latlayer2(c3)
        p3 = bilinear_resize(p4, lat3.shape[2], lat3.shape[3]) + lat3
        return [self.smooth2(p3), self.smooth1(p4), p5, p6, p7]


class RetinaHead(nn.Module):
    """Shared dense class and box towers (four 3x3 convs each)."""

    def __init__(self, num_classes: int, anchors_per_location: int = 3,
                 dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.num_classes = num_classes
        for i in range(4):
            setattr(self, f"cls{i}", Conv2d(256, 256, 3, padding=1, **kw))
            setattr(self, f"box{i}", Conv2d(256, 256, 3, padding=1, **kw))
        self.cls_out = Conv2d(256, anchors_per_location * num_classes, 3,
                              padding=1, **kw)
        self.box_out = Conv2d(256, anchors_per_location * 4, 3, padding=1,
                              **kw)

    def forward(self, x: torch.Tensor):
        """NCHW level -> (logits [B, H*W*A, K], deltas [B, H*W*A, 4])
        float32, in the JAX NHWC anchor order."""
        cls = box = x
        for i in range(4):
            cls = F.relu(getattr(self, f"cls{i}")(cls))
            box = F.relu(getattr(self, f"box{i}")(box))
        b = x.shape[0]
        cls = self.cls_out(cls).permute(0, 2, 3, 1)
        box = self.box_out(box).permute(0, 2, 3, 1)
        return (cls.reshape(b, -1, self.num_classes).to(torch.float32),
                box.reshape(b, -1, 4).to(torch.float32))


def retina_anchors(config: Config) -> np.ndarray:
    """Anchors on strides 8..128 (P3..P7), one RPN_ANCHOR_SCALES entry a
    level: [A, 4] float32 pixels."""
    d = config.IMAGE_MAX_DIM
    shapes = [(d // s, d // s) for s in STRIDES]
    return generate_pyramid_anchors(config.RPN_ANCHOR_SCALES,
                                    config.RPN_ANCHOR_RATIOS, shapes,
                                    STRIDES, 1)


class RetinaNet(nn.Module):
    """One-stage detector over RetinaFPN on one device (the card unless
    `device` says otherwise). `train=True` keeps float32 master weights
    and computes in COMPUTE_DTYPE, as MaskRCNN's training construction."""

    def __init__(self, config: Config, device=None, train: bool = False,
                 num_blocks: Sequence[int] = (2, 2, 2, 2)):
        super().__init__()
        check_supported(config)
        if train and config.QUANT_INT8:
            raise NotImplementedError("Config.QUANT_INT8 is inference-only")
        device = resolve_device(device)
        self.config = config
        self.compute_dtype = getattr(torch, config.COMPUTE_DTYPE)
        kw = dict(dtype=torch.float32 if train else self.compute_dtype,
                  device=device)
        self.fpn = RetinaFPN(num_blocks, **kw)
        self.head = RetinaHead(config.NUM_CLASSES,
                               len(config.RPN_ANCHOR_RATIOS), **kw)
        self.register_buffer("anchor_boxes", torch.from_numpy(
            retina_anchors(config)).to(device), persistent=False)
        if train:
            set_compute_dtype(self, self.compute_dtype)
        self.to(memory_format=torch.channels_last)
        self.eval()
        self.float_state = None
        self.quant = None

    @property
    def dtype(self) -> torch.dtype:
        return self.compute_dtype

    @property
    def device(self) -> torch.device:
        return self.anchor_boxes.device

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "RetinaNet":
        """The JAX init's distributions: xavier-uniform conv kernels, zero
        biases (cls_out's PRIOR_BIAS), identity BN; drawn in float32 from
        `generator` (a CPU generator) in module order."""
        state = {}
        for name, mod in self.named_modules():
            if isinstance(mod, nn.Conv2d):
                w = torch.empty(mod.weight.shape, dtype=torch.float32)
                nn.init.xavier_uniform_(w, generator=generator)
                state[f"{name}.weight"] = w
                if mod.bias is not None:
                    fill = PRIOR_BIAS if name == "head.cls_out" else 0.0
                    state[f"{name}.bias"] = torch.full(mod.bias.shape, fill)
            elif isinstance(mod, FrozenBatchNorm):
                f = mod.weight.shape
                state.update({f"{name}.weight": torch.ones(f),
                              f"{name}.bias": torch.zeros(f),
                              f"{name}.running_mean": torch.zeros(f),
                              f"{name}.running_var": torch.ones(f)})
        self.load_float_state({k: v.numpy() for k, v in state.items()})
        return self

    def load_float_state(self, state: Dict[str, np.ndarray]) -> None:
        """Load a float32 torch-layout state (numpy); keep it for
        QUANT_INT8 and drop any prepared int8 state."""
        self.load_state_dict({k: torch.from_numpy(np.asarray(v, np.float32))
                              for k, v in state.items()})
        self.float_state = {k: np.asarray(v, np.float32)
                            for k, v in state.items()}
        self.quant = None

    def load_jax_params(self, params) -> None:
        """Load a JAX `RetinaNet.init` tree ({"fpn", "head"})."""
        from maskrcnn_tpu_torch.checkpoint.convert import (
            from_jax_retina_params)
        self.load_float_state(from_jax_retina_params(params))

    def set_quant(self, tree) -> None:
        """Put a `quant.prepare_retina_quant_params` tree on the device."""
        from maskrcnn_tpu_torch import quant
        if not self.config.QUANT_INT8:
            raise ValueError("set_quant needs Config.QUANT_INT8")
        self.quant = quant.to_device(tree, self.dtype, self.device)

    def prepare(self, calib_images=None) -> None:
        """Under QUANT_INT8, calibrate on `calib_images` (uint8 canvases
        [N, H, W, 3]; quant.default_calib_canvases when None) and quantize
        the float32 state, once per set of weights."""
        from maskrcnn_tpu_torch import quant
        if not self.config.QUANT_INT8 or self.quant is not None:
            return
        if calib_images is None:
            calib_images = quant.default_calib_canvases(
                self.config.IMAGE_SHAPE)
        self.set_quant(quant.prepare_retina_quant_params(
            self, self.float_state, calib_images))

    def anchors(self) -> torch.Tensor:
        """Pixel anchors [A, 4] float32 on the device (P3..P7)."""
        return self.anchor_boxes

    def forward(self, images: torch.Tensor):
        """images [B, H, W, 3] float (normalized) -> (logits [B, A, K],
        deltas [B, A, 4]) float32."""
        if self.quant is not None:
            from maskrcnn_tpu_torch import quant
            return quant.retina_quant_forward(self, images)
        if self.config.QUANT_INT8:
            raise RuntimeError("QUANT_INT8 RetinaNet used before prepare / "
                               "set_quant")
        x = images.to(self.dtype).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        outs = [self.head(f) for f in self.fpn(x)]
        return (torch.cat([o[0] for o in outs], dim=1),
                torch.cat([o[1] for o in outs], dim=1))

    def _assigned_gt(self, gt_class_ids, gt_boxes, gt_valid):
        """Each anchor's best instance gt (argmax IoU over the instance
        boxes, the first on ties; 0 when there is none): [B, A]."""
        iou = torch.nan_to_num(box_ops.box_iou(self.anchor_boxes[None],
                                               gt_boxes), nan=0.0)
        iou = torch.where(((gt_class_ids > 0) & gt_valid)[:, None, :], iou,
                          -1.0)
        return torch.argmax(iou, dim=2)

    def losses(self, images: torch.Tensor, gt_class_ids: torch.Tensor,
               gt_boxes: torch.Tensor, gt_valid: torch.Tensor,
               generator: torch.Generator = None):
        """Focal classification (alpha 0.25, gamma 2, over the matched
        and background anchors, / the positive count) plus smooth-L1 box
        regression on the positives (/ 4 x their count), on the RPN's
        anchor targets with RPN_TRAIN_ANCHORS_PER_IMAGE = A, so no
        subsample binds. images [B, H, W, 3] normalized; gt_boxes pixels.
        Returns (total, {"cls", "box"})."""
        from maskrcnn_tpu_torch.train.targets import rpn_targets
        cfg = self.config
        logits, deltas = self.forward(images)
        anchors = self.anchor_boxes
        dense = cfg.replace(RPN_TRAIN_ANCHORS_PER_IMAGE=anchors.shape[0])
        match = rpn_targets(dense, generator, anchors, gt_class_ids,
                            gt_boxes, gt_valid).rpn_match          # [B, A]
        idx = self._assigned_gt(gt_class_ids, gt_boxes, gt_valid)
        assigned = torch.gather(gt_class_ids, 1, idx)
        onehot = F.one_hot(torch.where(match == 1, assigned, 0).long(),
                           cfg.NUM_CLASSES).to(torch.float32)
        p = torch.sigmoid(logits)
        pt = torch.where(onehot > 0, p, 1.0 - p)
        alpha = torch.where(onehot > 0, FOCAL_ALPHA, 1.0 - FOCAL_ALPHA)
        focal = -alpha * (1.0 - pt) ** 2 * torch.log(torch.clamp(pt, 1e-7,
                                                                 1.0))
        include = (match != 0)[..., None].to(torch.float32)
        n_pos = torch.clamp_min((match == 1).sum(), 1).to(torch.float32)
        cls_loss = torch.sum(focal * include) / n_pos

        std = device_tensor(cfg.RPN_BBOX_STD_DEV, torch.float32,
                            anchors.device)
        tgt_box = torch.gather(gt_boxes, 1, idx[..., None].expand(-1, -1, 4))
        t = torch.nan_to_num(box_ops.box_deltas(anchors[None], tgt_box) / std,
                             nan=0.0, posinf=0.0, neginf=0.0)
        pos = (match == 1).to(torch.float32)[..., None]
        box_loss = (torch.sum(smooth_l1(deltas - t) * pos)
                    / torch.clamp_min(pos.sum() * 4.0, 1.0))
        return cls_loss + box_loss, {"cls": cls_loss, "box": box_loss}

    @torch.no_grad()
    def detect(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Dense decode -> class-offset NMS -> DETECTION_MAX_INSTANCES
        slots a image: {"boxes" [B, D, 4] pixels, "scores" [B, D],
        "class_ids" [B, D] int32, "valid" [B, D] bool}, kept boxes first
        in score order and zeros after them. images as `forward`."""
        cfg = self.config
        d = float(cfg.IMAGE_MAX_DIM)
        logits, deltas = self.forward(images)
        dev = logits.device
        probs = torch.sigmoid(logits)[..., 1:]
        best = torch.amax(probs, dim=-1)
        cls = (torch.argmax(probs, dim=-1) + 1).to(torch.int32)
        a = logits.shape[1]
        k = min(cfg.PRE_NMS_LIMIT * 2, a)
        scores, order = torch.sort(best, dim=1, descending=True, stable=True)
        scores, order = scores[:, :k], order[:, :k]
        std = device_tensor(cfg.RPN_BBOX_STD_DEV, torch.float32, dev)
        dl = torch.gather(deltas, 1, order[..., None].expand(-1, -1, 4))
        boxes = box_ops.refine_boxes(self.anchor_boxes[order], dl * std)
        boxes = box_ops.clip_boxes(boxes, (0.0, 0.0, d, d))
        cls = torch.gather(cls, 1, order)
        thr = device_tensor(cfg.DETECTION_MIN_CONFIDENCE, torch.float32, dev)
        keep = multiclass_nms_mask(boxes, cls, scores > thr,
                                   cfg.DETECTION_NMS_THRESHOLD, coord_span=d)
        ar = torch.arange(k, device=dev)
        rank = torch.where(keep, ar, k + ar)
        take = torch.sort(rank, dim=1).indices[:, :cfg.DETECTION_MAX_INSTANCES]
        valid = torch.gather(keep, 1, take)
        return {
            "boxes": torch.where(valid[..., None], torch.gather(
                boxes, 1, take[..., None].expand(-1, -1, 4)), 0.0),
            "scores": torch.where(valid, torch.gather(scores, 1, take), 0.0),
            "class_ids": torch.where(valid, torch.gather(cls, 1, take), 0),
            "valid": valid,
        }
