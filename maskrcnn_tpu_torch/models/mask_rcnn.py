"""Mask R-CNN model bundle (counterpart of maskrcnn_tpu/models/mask_rcnn.py).

One nn.Module holding the backbone (`fpn`), `rpn`, box head
(`classifier`) and `mask` head under the checkpoint's attribute names,
so a `checkpoint.convert.from_jax_params` state dict loads with
strict=True. Config.CASCADE_STAGES adds a box head a stage past the first
(`classifier2`, ...; `classify_stage`) and Config.NUM_KEYPOINTS the
keypoint head (`keypoint`; `predict_keypoints`), registered after the
mask head so the two-head model's seeded draws stay as they were.
Convolution and linear weights are stored in the compute dtype
(Config.COMPUTE_DTYPE) in channels_last memory; the frozen-BN tensors
stay float32. The stage API takes and returns the JAX layouts
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

`MaskRCNN(config, device, train=True)` is the training construction:
float32 master weights, as the JAX package's flax params, each layer
casting its weight and bias to COMPUTE_DTYPE in `forward`
(models.layers), so gradients and SGD updates stay float32;
Config.REMAT_BACKBONE recomputes each ResNet stage in the backward pass.
FOLD_BN and QUANT_INT8 are inference-only and raise there. The
inference construction keeps its weights in the compute dtype.

NUM_DEVICES > 1 is data parallelism outside the model: `parallel`
(training over torch.distributed, one process a device) and
`api.Detector` (one replica a device). SP_DEVICES > 1, the spatial axis
(`parallel.spatial`), runs `backbone` on row shards when the model has a
`spatial` transport: the training construction under a process group
makes its own (`parallel.spatial.Distributed`), api.Detector gives each
replica group's first model one over the group (`InProcess`); a model
without one runs the whole canvas, as the JAX package's MaskRCNN off a
mesh; under QUANT_INT8 the int8 traversal shards the same way
(`quant.fpn_forward` on the shards). `check_supported` raises ValueError
for a canvas height the shards cannot split. The TPU knobs (NMS_IMPL, ROI_IMPL,
S2D_STEM, MATMUL_PRECISION) do not change the function computed and are
ignored.
"""

from __future__ import annotations

import contextlib
from typing import List, Mapping, Sequence

import numpy as np
import torch
import torch.nn as nn

from maskrcnn_tpu_torch.config import Config
from maskrcnn_tpu_torch import quant
from maskrcnn_tpu_torch.checkpoint.fold import fold_state_dict
from maskrcnn_tpu_torch.models.fpn import FPN
from maskrcnn_tpu_torch.models.heads import BoxHead, KeypointHead, MaskHead
from maskrcnn_tpu_torch.models.layers import set_compute_dtype
from maskrcnn_tpu_torch.models.resnet import Bottleneck, FrozenBatchNorm
from maskrcnn_tpu_torch.models.rpn import RPN
from maskrcnn_tpu_torch.ops.anchors import config_anchors


def check_supported(config: Config) -> None:
    """Raise ValueError for a spatial layout the canvas cannot take
    (parallel.spatial.check_config)."""
    from maskrcnn_tpu_torch.parallel import spatial
    spatial.check_config(config)


def resolve_device(device=None) -> torch.device:
    """The entry points' device: the card ("cuda") unless `device` names
    another. Without a card and no device given, raise: the port never
    moves to the CPU unasked."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the card by default; "
                'pass device="cpu" to run on the CPU')
        device = "cuda"
    return torch.device(device)


# options that apply to inference only (config.py: FOLD_BN "must never be
# used for training")
INFERENCE_ONLY = ("FOLD_BN", "QUANT_INT8")


class MaskRCNN(nn.Module):
    """Model for a Config on one device (the card unless `device` says
    otherwise, see `resolve_device`); `train=True` builds it for training
    (float32 master weights, see the module docstring)."""

    def __init__(self, config: Config, device=None, train: bool = False):
        super().__init__()
        check_supported(config)
        if train:
            for field in INFERENCE_ONLY:
                if getattr(config, field):
                    raise NotImplementedError(
                        f"Config.{field} is inference-only: the training "
                        "construction does not take it")
            from maskrcnn_tpu_torch.parallel import check_world
            check_world(config)
        device = resolve_device(device)
        self.config = config
        # QUANT_INT8: float32 torch-layout state (numpy) and device state
        self.float_state = None
        self.quant = None
        self._float_ok = False
        self.compute_dtype = getattr(torch, config.COMPUTE_DTYPE)
        dtype = torch.float32 if train else self.compute_dtype
        kw = dict(dtype=dtype, device=device)
        fold = dict(fold_bn=config.FOLD_BN)
        self.fpn = FPN(config.BACKBONE, **kw, **fold,
                       remat=train and config.REMAT_BACKBONE)
        self.rpn = RPN(len(config.RPN_ANCHOR_RATIOS),
                       config.RPN_ANCHOR_STRIDE, **kw)
        self.classifier = BoxHead(config.NUM_CLASSES, config.POOL_SIZE, **kw,
                                  **fold)
        self.mask = MaskHead(config.NUM_CLASSES, **kw, **fold)
        self.stages = max(1, len(config.CASCADE_STAGES))
        for i in range(2, self.stages + 1):
            setattr(self, f"classifier{i}", BoxHead(
                config.NUM_CLASSES, config.POOL_SIZE, **kw, **fold))
        if config.NUM_KEYPOINTS > 0:
            self.keypoint = KeypointHead(config.NUM_KEYPOINTS,
                                         config.KEYPOINT_HEAD_CONVS,
                                         config.KEYPOINT_HEAD_DIM, **kw)
        self.register_buffer(
            "anchor_boxes",
            torch.from_numpy(config_anchors(config)).to(device),
            persistent=False)
        if train:
            set_compute_dtype(self, self.compute_dtype)
        self.to(memory_format=torch.channels_last)
        self.eval()
        # the spatial transport `backbone` shards through, or None
        self.spatial = None
        if train and config.SP_DEVICES > 1:
            from maskrcnn_tpu_torch.parallel import spatial
            self.spatial = spatial.Distributed.for_config(config, self)

    @property
    def dtype(self) -> torch.dtype:
        """The compute dtype (the weights' dtype but in the training
        construction, whose weights are float32)."""
        return self.compute_dtype

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
        """images [B, H, W, 3] float32 -> [P2..P6] as NHWC views; on row
        shards through the `spatial` transport when there is one."""
        if self._int8():
            return quant.quant_backbone(self, images)
        x = images.to(self.dtype).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        if self.spatial is None:
            levels = self.fpn(x)
        else:
            from maskrcnn_tpu_torch.parallel import spatial
            levels = spatial.backbone(self.spatial, x)
        return [p.permute(0, 2, 3, 1) for p in levels]

    def rpn_scores(self, feature_maps: Sequence[torch.Tensor]):
        """NHWC maps -> (scores [B, A] float32, deltas [B, A, 4] compute
        dtype)."""
        if self._int8():
            return quant.quant_rpn_scores(self, feature_maps)
        return self.rpn([f.permute(0, 3, 1, 2) for f in feature_maps])

    def rpn_detect(self, feature_maps: Sequence[torch.Tensor]):
        """NHWC maps -> (logits [B, A, 2], probs [B, A, 2], deltas
        [B, A, 4]), float32: the training form of the RPN (the JAX
        MaskRCNN.rpn_detect)."""
        return self.rpn.detect([f.permute(0, 3, 1, 2) for f in feature_maps])

    def classify(self, pooled: torch.Tensor):
        """Box head over pooled [N, 7, 7, 256]."""
        return self.classifier(pooled)

    def classify_stage(self, pooled: torch.Tensor, stage: int):
        """Cascade stage `stage`'s box head (stage 0 is `classifier`).
        The box heads stay float under QUANT_INT8, as in the JAX
        package."""
        head = "classifier" if stage == 0 else f"classifier{stage + 1}"
        return getattr(self, head)(pooled)

    def predict_keypoints(self, pooled: torch.Tensor) -> torch.Tensor:
        """Keypoint head over pooled [N, 14, 14, 256] -> heatmap logits
        [N, 56, 56, K] float32; float under QUANT_INT8, as in the JAX
        package."""
        return self.keypoint(pooled)

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
