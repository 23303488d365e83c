"""Mask R-CNN model bundle (counterpart of maskrcnn_tpu/models/mask_rcnn.py).

One nn.Module holding the backbone (`fpn`), `rpn`, box head
(`classifier`) and `mask` head under the checkpoint's attribute names,
so a `checkpoint.convert.from_jax_params` state dict loads with
strict=True. Convolution and linear weights are stored in the compute
dtype (Config.COMPUTE_DTYPE) in channels_last memory; the frozen-BN
tensors stay float32. The stage API takes and returns the JAX layouts
(NHWC maps, [N, P, P, C] pooled features).

Config.FOLD_BN builds every frozen BN folded (it applies nothing) and
runs the backbone's identity blocks as the fused bottleneck op. The
weights must then be folded (checkpoint.fold): `init` folds its float32
draws before the one cast to the compute dtype, and
`checkpoint.convert.load_jax_params` folds a JAX tree. Every
`load_state_dict` repacks the fused blocks' weights from the state
loaded.

Config.QUANT_INT8 (maskrcnn_tpu_torch.quant): `init` and
`load_jax_params` keep the float32 state in `float_state`, which
`quant.prepare_quant_params` quantizes; `set_quant` puts the result on
the device. Then `backbone`, `rpn_scores` and (when the state has the
mask head's kernels) `predict_masks` take the int8 route, as the JAX
package's MaskRCNN routes a tree with "quant". A QUANT_INT8 model used
before `set_quant` raises, except inside `float_path()` (calibration).

Options the port does not implement raise NotImplementedError here
(`check_supported`) instead of running something else. The TPU knobs
(NMS_IMPL, ROI_IMPL, S2D_STEM, REMAT_*, MATMUL_PRECISION) do not change
the function computed and are ignored.
"""

from __future__ import annotations

import contextlib
from typing import List, Mapping, Sequence

import numpy as np
import torch
import torch.nn as nn

from maskrcnn_tpu.config import Config
from maskrcnn_tpu_torch import quant
from maskrcnn_tpu_torch.checkpoint.fold import fold_state_dict
from maskrcnn_tpu_torch.models.fpn import FPN
from maskrcnn_tpu_torch.models.heads import BoxHead, MaskHead
from maskrcnn_tpu_torch.models.resnet import Bottleneck, FrozenBatchNorm
from maskrcnn_tpu_torch.models.rpn import RPN
from maskrcnn_tpu_torch.ops.anchors import config_anchors

# (field, test that it is set away from its default): options that change
# the function computed and are not ported yet
UNPORTED = (
    ("CASCADE_STAGES", lambda v: len(v) > 0),
    ("NUM_KEYPOINTS", lambda v: v != 0),
    ("TTA_HFLIP", bool),
    ("DETECTION_SOFT_NMS_SIGMA", lambda v: v != 0.0),
    ("IMAGE_CANVAS", lambda v: v is not None),
    ("DEVICE_RESIZE", bool),
    ("NUM_DEVICES", lambda v: v > 1),
    ("SP_DEVICES", lambda v: v > 1),
)


def check_supported(config: Config) -> None:
    """Raise NotImplementedError, naming the field, for an option the port
    does not implement."""
    for field, is_set in UNPORTED:
        value = getattr(config, field)
        if is_set(value):
            raise NotImplementedError(
                f"Config.{field}={value!r} is not ported to "
                "maskrcnn_tpu_torch (ROADMAP Queue 1)")


class MaskRCNN(nn.Module):
    """Inference model for a Config on one device."""

    def __init__(self, config: Config, device="cpu"):
        super().__init__()
        check_supported(config)
        self.config = config
        # QUANT_INT8: float32 torch-layout state (numpy) and device state
        self.float_state = None
        self.quant = None
        self._float_ok = False
        dtype = getattr(torch, config.COMPUTE_DTYPE)
        kw = dict(dtype=dtype, device=device)
        fold = dict(fold_bn=config.FOLD_BN)
        self.fpn = FPN(config.BACKBONE, **kw, **fold)
        self.rpn = RPN(len(config.RPN_ANCHOR_RATIOS),
                       config.RPN_ANCHOR_STRIDE, **kw)
        self.classifier = BoxHead(config.NUM_CLASSES, config.POOL_SIZE, **kw,
                                  **fold)
        self.mask = MaskHead(config.NUM_CLASSES, **kw, **fold)
        self.register_buffer(
            "anchor_boxes",
            torch.from_numpy(config_anchors(config)).to(device),
            persistent=False)
        self.to(memory_format=torch.channels_last)
        self.eval()

    @property
    def dtype(self) -> torch.dtype:
        """The compute dtype of the weights."""
        return self.rpn.conv_shared.weight.dtype

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "MaskRCNN":
        """Reference init (model.py:1021-1035): xavier-uniform convs, zero
        biases, N(0, 0.01) linears, identity BN. Values are drawn in
        float32 from `generator` (a CPU generator) in module order, so a
        seed gives the same weights on every device. Under FOLD_BN the
        float32 draws are folded (var=1 gives scale 1/sqrt(1.001), so
        even fresh weights change) before the cast to the compute
        dtype."""
        state = {}
        for name, mod in self.named_modules():
            if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
                w = torch.empty(mod.weight.shape, dtype=torch.float32)
                if isinstance(mod, nn.Linear):
                    w.normal_(0.0, 0.01, generator=generator)
                else:
                    nn.init.xavier_uniform_(w, generator=generator)
                state[f"{name}.weight"] = w
                state[f"{name}.bias"] = torch.zeros(mod.bias.shape)
            elif isinstance(mod, FrozenBatchNorm):
                f = mod.weight.shape
                state.update({f"{name}.weight": torch.ones(f),
                              f"{name}.bias": torch.zeros(f),
                              f"{name}.running_mean": torch.zeros(f),
                              f"{name}.running_var": torch.ones(f)})
        if self.config.FOLD_BN:
            state = {k: torch.from_numpy(np.asarray(v)) for k, v in
                     fold_state_dict({k: v.numpy() for k, v in state.items()},
                                     self.config.BACKBONE).items()}
        self.load_state_dict(state)
        self.keep_float_state({k: v.numpy() for k, v in state.items()})
        return self

    def keep_float_state(self, state: Mapping[str, np.ndarray]) -> None:
        """Under QUANT_INT8, keep the float32 state just loaded for
        quantization and drop any prepared int8 state (it belongs to the
        old weights)."""
        self.quant = None
        if self.config.QUANT_INT8:
            self.float_state = {k: np.asarray(v, np.float32)
                                for k, v in state.items()}

    def set_quant(self, tree) -> None:
        """Put a `quant.prepare_quant_params` tree on the model's device."""
        self.quant = quant.to_device(tree, self.dtype,
                                     self.anchor_boxes.device)

    @contextlib.contextmanager
    def float_path(self):
        """Run the float model under QUANT_INT8 (calibration), whether or
        not an int8 state is set."""
        saved = self.quant
        self.quant, self._float_ok = None, True
        try:
            yield self
        finally:
            self.quant, self._float_ok = saved, False

    def _int8(self) -> bool:
        if self.quant is not None:
            return True
        if self.config.QUANT_INT8 and not self._float_ok:
            raise RuntimeError("QUANT_INT8 model used before set_quant: "
                               "prepare it (api.Detector does) or use "
                               "float_path()")
        return False

    def load_state_dict(self, state_dict: Mapping[str, torch.Tensor],
                        strict: bool = True, assign: bool = False):
        """nn.Module.load_state_dict, then the fused blocks repack their
        weights from `state_dict` (float32 biases stay float32)."""
        result = super().load_state_dict(state_dict, strict, assign)
        for name, mod in self.named_modules():
            if isinstance(mod, Bottleneck) and mod.fused:
                mod.pack(state_dict, f"{name}.")
        return result

    def backbone(self, images: torch.Tensor) -> List[torch.Tensor]:
        """images [B, H, W, 3] float32 -> [P2..P6] as NHWC views."""
        if self._int8():
            return quant.quant_backbone(self, images)
        x = images.to(self.dtype).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        return [p.permute(0, 2, 3, 1) for p in self.fpn(x)]

    def rpn_scores(self, feature_maps: Sequence[torch.Tensor]):
        """NHWC maps -> (scores [B, A] float32, deltas [B, A, 4] compute
        dtype)."""
        if self._int8():
            return quant.quant_rpn_scores(self, feature_maps)
        return self.rpn([f.permute(0, 3, 1, 2) for f in feature_maps])

    def classify(self, pooled: torch.Tensor):
        """Box head over pooled [N, 7, 7, 256]."""
        return self.classifier(pooled)

    def predict_masks(self, pooled: torch.Tensor) -> torch.Tensor:
        """Mask head over pooled [N, 14, 14, 256] -> [N, 28, 28, K]. int8
        only when the state has the head's kernels: stats without its
        activations leave it float, as in the JAX package."""
        if self._int8() and "mask_head/conv1" in self.quant["convs"]:
            return quant.quant_mask_head(self, pooled)
        return self.mask(pooled)

    def anchors(self) -> torch.Tensor:
        """Pixel-space anchors [num_anchors, 4] float32 on the device."""
        return self.anchor_boxes
