"""Configuration of the port (a copy of maskrcnn_tpu/config.py).

The same frozen dataclasses, fields, defaults and derived properties as
the JAX package's config, kept here so the port imports nothing of the
JAX package. The TPU runtime fields (mesh shape, Pallas and remat knobs)
stay so a config can be diffed against the JAX one field for field; the
port ignores those that do not change the function it computes, and
models.mask_rcnn.check_supported rejects the options it has not ported.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class Config:
    """Base configuration (reference: config.py:19-171).

    All names match the reference. Computed attributes (BATCH_SIZE,
    IMAGE_SHAPE, BACKBONE_SHAPES) are properties instead of `__init__`
    mutations.
    """

    NAME: str = "base"

    # Replaces the reference GPU_COUNT knob (config.py:30): number of
    # devices in the data-parallel mesh axis.
    NUM_DEVICES: int = 1
    IMAGES_PER_DEVICE: int = 1
    # Spatial partitioning: groups of SP_DEVICES ICI-adjacent chips
    # cooperate per image, sharding the canvas-H dim (parallel.make_mesh
    # sp axis; GSPMD inserts the conv halo exchanges). Divides per-image
    # activation HBM — the escape hatch from the 1024px training HBM
    # wall (BENCHMARKS.md) and the multi-chip low-latency serving shape.
    # NUM_DEVICES counts ALL mesh devices; the data-parallel width is
    # NUM_DEVICES // SP_DEVICES and IMAGES_PER_DEVICE means images per
    # sp GROUP.
    SP_DEVICES: int = 1

    STEPS_PER_EPOCH: int = 1000
    VALIDATION_STEPS: int = 50

    BACKBONE: str = "resnet101"  # "resnet50" | "resnet101"
    BACKBONE_STRIDES: Tuple[int, ...] = (4, 8, 16, 32, 64)

    NUM_CLASSES: int = 1

    RPN_ANCHOR_SCALES: Tuple[int, ...] = (32, 64, 128, 256, 512)
    RPN_ANCHOR_RATIOS: Tuple[float, ...] = (0.5, 1.0, 2.0)
    RPN_ANCHOR_STRIDE: int = 1

    RPN_NMS_THRESHOLD: float = 0.7
    # ROIs kept after NMS (reference: config.py:76). Also used as the
    # static pre-NMS top-k (reference model.py:1345 uses min(500, anchors)).
    RPN_NMS_MAX_ROIS_NUM: int = 500
    RPN_TRAIN_ANCHORS_PER_IMAGE: int = 128

    IMAGE_MIN_DIM: int = 800
    IMAGE_MAX_DIM: int = 1024
    IMAGE_PADDING: bool = True

    MEAN_PIXEL: Tuple[float, float, float] = (123.7, 116.8, 103.9)

    TRAIN_ROIS_PER_IMAGE: int = 100
    ROI_POSITIVE_RATIO: float = 0.33

    POOL_SIZE: int = 7
    MASK_POOL_SIZE: int = 14
    MASK_SHAPE: Tuple[int, int] = (28, 28)

    # ---- Keypoint branch (beyond the reference: the Mask R-CNN
    # paper's third task head; delldu/MaskRCNN implements boxes+masks
    # only). 0 disables the branch entirely — the default model,
    # params, and losses are bit-identical to the two-head build.
    # 17 = COCO person keypoints. The head pools at MASK_POOL_SIZE
    # (shares the mask head's RoIAlign tables) and regresses one
    # KEYPOINT_SHAPE heatmap per keypoint, trained with a spatial
    # softmax cross-entropy at the ground-truth position.
    # ---- Cascade R-CNN branch (beyond the reference: Cai & Vasconcelos
    # 2018). Empty tuple disables the cascade entirely — the default
    # model, params, and losses are bit-identical to the single-head
    # build. Set e.g. (0.5, 0.6, 0.7) for the paper's 3-stage cascade:
    # stage i gets its own BoxHead trained at IoU threshold
    # CASCADE_STAGES[i] on the previous stage's refined boxes (no
    # re-sampling past stage 0), with delta normalization
    # BBOX_STD_DEV / (i + 1) (the paper's tightening std schedule).
    # Inference refines proposals through the stages and classifies
    # with the stage-averaged probabilities. Mask/keypoint heads are
    # unchanged (they already run on the final detection boxes).
    CASCADE_STAGES: Tuple[float, ...] = ()
    # Train the mask head on the LAST cascade stage's refined,
    # relabeled RoIs instead of the stage-0 sampled RoIs (Cascade Mask
    # R-CNN "mask at the last stage" placement). At inference the mask
    # head always pools from the final cascade-refined detection boxes,
    # so stage-0 mask training sees looser boxes than serving does —
    # this closes that train/serve distribution gap. No effect without
    # CASCADE_STAGES. Measured on the multi-class trained gate:
    # see BENCHMARKS.md "Inference protocols".
    CASCADE_MASK_LAST: bool = False

    NUM_KEYPOINTS: int = 0
    KEYPOINT_SHAPE: Tuple[int, int] = (56, 56)
    KEYPOINT_HEAD_CONVS: int = 8   # Detectron keypoint-head depth
    KEYPOINT_HEAD_DIM: int = 512
    # Inference: run the keypoint head on only the top-K detection
    # slots. The head is the costliest per-RoI compute in the model
    # (8x conv512 at 14x14 ~ 7.4 GFLOP/RoI — ALL 50 padded detection
    # slots would cost as much as the whole backbone); detections are
    # packed valid-first in score order, so the static top-20 slice is
    # exactly the set the COCO keypoint protocol evaluates
    # (OKS maxDets = 20).
    KEYPOINT_MAX_INSTANCES: int = 20

    MAX_GT_INSTANCES: int = 50

    RPN_BBOX_STD_DEV: Tuple[float, float, float, float] = (0.1, 0.1, 0.2, 0.2)
    BBOX_STD_DEV: Tuple[float, float, float, float] = (0.1, 0.1, 0.2, 0.2)

    DETECTION_MAX_INSTANCES: int = 50
    DETECTION_MIN_CONFIDENCE: float = 0.7
    DETECTION_NMS_THRESHOLD: float = 0.3

    LEARNING_RATE: float = 0.001
    LEARNING_MOMENTUM: float = 0.9
    WEIGHT_DECAY: float = 0.0001

    USE_RPN_ROIS: bool = True

    # ---- TPU-specific fields (no reference equivalent) ----
    # Compute dtype for the backbone/heads ("bfloat16" keeps the MXU fed;
    # geometry ops always run in float32).
    COMPUTE_DTYPE: str = "bfloat16"
    # Mesh axis name for data parallelism.
    MESH_AXIS_DP: str = "dp"
    # Rematerialise backbone stage activations during backward. Measured
    # strictly better on v5e at 1024px (12.8 vs 12.0 img/s at batch 4:
    # the HBM pressure relief outweighs the recompute) and required for
    # large per-chip batches. No effect on inference.
    REMAT_BACKBONE: bool = True
    # Rematerialise the RPN/box/mask head activations in the training
    # backward pass (train/step.compute_losses). The RPN shared conv
    # alone holds ~89 MB/img of bf16 activations (512ch over P2..P6)
    # and the mask-head conv stack ~80 MB/img; recomputing them costs
    # ~2 ms/img of extra forward FLOPs but unlocks larger per-chip
    # batches at 1024px (b16 is the HBM-pinned operating point without
    # it — see BENCHMARKS.md training section). No effect on inference.
    REMAT_HEADS: bool = False
    # Matmul/conv precision: "default" lets f32 convs use bf16 passes on
    # TPU (fast); "float32"/"highest" forces full precision — use with
    # COMPUTE_DTYPE="float32" for exact-parity evaluation runs.
    MATMUL_PRECISION: str = "default"
    # NMS backend: "xla" (portable lax loop) or "pallas" (TPU kernel).
    NMS_IMPL: str = "xla"
    # Inference RoIAlign backend: "xla" (patch-gather), "pallas"
    # (per-box DMA kernel, ops/roi_align_pallas.py; falls back to xla
    # when pyramid levels are smaller than its patch window), or "auto"
    # (pallas at batch >= 8 where its per-box issue overhead amortizes,
    # xla below — see BENCHMARKS.md).
    ROI_IMPL: str = "auto"
    # Inference-only: frozen BN folded into conv kernels at weight-load
    # (checkpoint.fold.fold_bn_params); the runtime affine is skipped.
    # Must never be used for training — it changes gradient geometry.
    FOLD_BN: bool = False
    # Space-to-depth stem: 7x7/2 conv on 3 channels -> identical 4x4/1
    # conv on a (2,2)-blocked 12-channel input (better MXU occupancy).
    S2D_STEM: bool = False
    # Inference-only int8 quantization of the backbone + RPN shared conv
    # (quant.py): per-output-channel weight scales, calibrated per-tensor
    # activation scales, int8 MXU convs with f32 dequant epilogues. The
    # param tree must come from quant.prepare_quant_params; geometry ops
    # and box/mask heads stay in COMPUTE_DTYPE. See BENCHMARKS.md for
    # measured speed/accuracy.
    QUANT_INT8: bool = False
    # With QUANT_INT8 + the pallas RoIAlign: also feed the RoIAlign
    # kernel int8 feature tables (re-quantized with the RPN's own
    # per-level scales, dequantized in-kernel). The kernel is
    # DMA-bandwidth-bound so this runs it ~0.72x (gates/
    # int8_roi_dma_gate.py); pooled-feature quantization error equals
    # the RPN-input quantization the int8 path already carries. Off ->
    # the kernel DMAs the bf16 maps even when the backbone is int8
    # (the accuracy-conservative A/B arm for tools/parity_bisect).
    QUANT_INT8_ROI: bool = True
    # Activation-scale calibration method (quant.calibrate):
    #   "amax"       - plain per-tensor max-abs (the r4 default; fast,
    #                  but one outlier activation inflates the scale and
    #                  collapses resolution for the bulk of the range);
    #   "percentile" - clip at the QUANT_PERCENTILE-th percentile of
    #                  |x| (outlier-robust; saturates the tail);
    #   "mse"        - per-tensor clip minimizing quantization MSE over
    #                  a calibration subsample (grid search).
    # Measured on the multiclass trained gate (r5,
    # benchmarks/int8_multiclass_ab_r5.json, identical serving graph
    # for all rules): mse beats amax by +5.3 bbox AP75 / +11.4 segm
    # AP75 and lifts bbox AP50 + segm AP above float; percentile-99.9
    # REGRESSES (spiky activations; the tail is signal). Default is
    # therefore "mse"; use "amax" to reproduce pre-r5 scales or reuse
    # pre-r5 persisted stats files.
    QUANT_CALIB: str = "mse"
    QUANT_PERCENTILE: float = 99.9
    # Stage groups kept FLOAT inside an otherwise-int8 pipeline
    # (subset of {"C2","C3","C4","C5","FPN","RPN","MASK"}): their convs
    # run in COMPUTE_DTYPE from the same prepared tree. Measured r5
    # (int8_stage_ablation_r5.json + int8_fp_rpn_cost_gate.py):
    # ("C4","C5") is the high-IoU serving preset — recovers the int8
    # bbox AP75 collapse (0.388 -> 0.605 on the trained gate, above
    # the float reference) for only 7% throughput (186.9 -> 173.8
    # img/s at b32); RoI tables and mask head are accuracy-free;
    # ("RPN",) helps less and costs more. Default () = maximum
    # throughput.
    QUANT_SKIP: Tuple[str, ...] = ()
    # Gradient accumulation: split each train step's batch into this
    # many sequential micro-batches, average the gradients, apply ONE
    # optimizer update. Batches must arrive micro-stacked
    # [A, B/A, ...] (Trainer reshapes automatically; direct train_step
    # callers use train.step.split_accum). Trades step latency for
    # effective batch beyond the HBM wall (b16 is the largest
    # monolithic step at 1024px on a 16G v5e; accumulation unlocks
    # b32+). Equivalent to torch-style accumulation: per-micro loss
    # normalizers (e.g. the RPN's matched-anchor count) see the micro
    # batch, exactly as N small optimizer-less steps would.
    GRAD_ACCUM_STEPS: int = 1
    # Momentum-buffer dtype for the SGD optimizer ("bfloat16" halves
    # optimizer-state HBM — an HBM-headroom knob, not a speed knob;
    # see train/step.py make_optimizer).
    OPT_MOMENTUM_DTYPE: str = "float32"
    # Produce detection masks in original-image coordinates on device
    # (ops/mask_paste.masks_to_original), replacing the host PIL
    # decode_masks loop (~0.7 s/img single-threaded). Images larger than
    # ORIG_MASK_CANVAS on a side fall back to the host path.
    DEVICE_MASK_DECODE: bool = True
    ORIG_MASK_CANVAS: int = 640  # >= the largest COCO val image side
    # Resize+pad raw images to the canvas ON DEVICE (two MXU matmuls,
    # ops/image.batched_resize_pad): the host ships raw uint8 pixels
    # (~3x less host->device traffic for COCO-sized images) instead of
    # full canvases, and the host PIL resize loop disappears from the
    # serving path. Exact vs the host path at scale 1, PIL-close for
    # upscale; images that need DOWNSCALING (or a dp mesh) fall back to
    # the host path automatically. Off by default: evaluation parity
    # prefers the bit-exact host PIL pipeline (data/codecs.py).
    DEVICE_RESIZE: bool = False
    # Optional rectangular canvas (H, W), both divisible by 64. The
    # reference protocol is the square (MAX_DIM, MAX_DIM) canvas
    # (config.py:86-89, data.py:191-223) and stays the default; a
    # landscape/portrait canvas skips convolving the ~25-40% of the
    # square canvas that COCO-shaped images pad away — a serving-time
    # throughput knob with no reference equivalent (the reference
    # asserts a square multiple-of-64 shape at model.py:978-983).
    IMAGE_CANVAS: Tuple[int, int] = None  # type: ignore[assignment]
    # Horizontal-flip test-time augmentation: the box pipeline runs on
    # the canvas AND its x-mirror, the mirrored detections are mapped
    # back and the union is NMS-merged; masks/keypoints come from the
    # un-flipped features on the merged boxes
    # (detection/pipeline.detect_and_pool_masks_tta). ~1.8x the cost of
    # a single pass for a small AP gain; the reference has no TTA.
    TTA_HFLIP: bool = False
    # TTA matched-pair box fusion: before the merge NMS, every
    # detection's coordinates become the score-weighted average of
    # same-class boxes from BOTH passes with IoU >= this threshold
    # (itself included), so the flip ensemble averages localization
    # noise instead of keeping one pass's box verbatim (the round-4
    # winner-take-all merge cost 5.2 bbox AP75 on the protocol gate).
    # TTA also defers mrn_refine's int-rounding quirk until after the
    # merge so the two passes don't carry +-1px quantization jitter
    # into the match. 0.0 restores the round-4 union-NMS merge.
    TTA_FUSION_IOU: float = 0.5
    # Gaussian Soft-NMS sigma for the final detection refinement
    # (Bodla et al. 2017; ops/nms.soft_nms_scores). 0.0 keeps the
    # reference's hard per-class NMS; a typical value is 0.5. Survivors
    # carry their decayed scores, thresholded at
    # max(DETECTION_MIN_CONFIDENCE, 1e-3). RPN proposal NMS is
    # unaffected (the protocol only changes the detection stage).
    DETECTION_SOFT_NMS_SIGMA: float = 0.0

    # ---- computed attributes (reference: config.py:145-164) ----
    @property
    def BATCH_SIZE(self) -> int:
        n = max(self.NUM_DEVICES, 1)
        assert n % self.SP_DEVICES == 0, (
            f"NUM_DEVICES={n} not divisible by SP_DEVICES="
            f"{self.SP_DEVICES}")
        return self.IMAGES_PER_DEVICE * (n // self.SP_DEVICES)

    @property
    def IMAGE_SHAPE(self) -> Tuple[int, int, int]:
        if self.IMAGE_CANVAS is not None:
            ch, cw = self.IMAGE_CANVAS
            if ch % 64 or cw % 64:
                # same constraint the reference asserts (model.py:978-983)
                raise ValueError(
                    f"IMAGE_CANVAS {self.IMAGE_CANVAS} must be "
                    "divisible by 64")
            return (ch, cw, 3)
        return (self.IMAGE_MAX_DIM, self.IMAGE_MAX_DIM, 3)

    @property
    def BACKBONE_SHAPES(self) -> Tuple[Tuple[int, int], ...]:
        return tuple(
            (int(math.ceil(self.IMAGE_SHAPE[0] / stride)),
             int(math.ceil(self.IMAGE_SHAPE[1] / stride)))
            for stride in self.BACKBONE_STRIDES)

    @property
    def NUM_ANCHORS(self) -> int:
        a = len(self.RPN_ANCHOR_RATIOS)
        total = 0
        for (h, w) in self.BACKBONE_SHAPES:
            hh = len(range(0, h, self.RPN_ANCHOR_STRIDE))
            ww = len(range(0, w, self.RPN_ANCHOR_STRIDE))
            total += hh * ww * a
        return total

    # Static pre-NMS top-k (reference: model.py:1345).
    @property
    def PRE_NMS_LIMIT(self) -> int:
        return min(self.RPN_NMS_MAX_ROIS_NUM, self.NUM_ANCHORS)

    def display(self) -> str:
        """Dump config (reference: config.py:166-171)."""
        lines = ["Configurations:"]
        for f in dataclasses.fields(self):
            lines.append("{:30} {}".format(f.name, getattr(self, f.name)))
        for name in ("BATCH_SIZE", "IMAGE_SHAPE", "BACKBONE_SHAPES",
                     "NUM_ANCHORS"):
            lines.append("{:30} {}".format(name, getattr(self, name)))
        text = "\n".join(lines)
        print(text)
        return text

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class CocoConfig(Config):
    """COCO training config (reference: config.py:174-197)."""

    NAME: str = "coco"
    IMAGES_PER_DEVICE: int = 1
    NUM_CLASSES: int = 1 + 80


@dataclasses.dataclass(frozen=True)
class CocoInferenceConfig(CocoConfig):
    """COCO inference config (reference: config.py:199-204).

    DETECTION_MIN_CONFIDENCE=0 matches the reference eval protocol.
    """

    NUM_DEVICES: int = 1
    IMAGES_PER_DEVICE: int = 1
    DETECTION_MIN_CONFIDENCE: float = 0.0


@dataclasses.dataclass(frozen=True)
class TinyConfig(CocoConfig):
    """Tiny config for fast CPU tests: 128px images, ~3k anchors."""

    NAME: str = "test"
    BACKBONE: str = "resnet50"
    IMAGE_MIN_DIM: int = 128
    IMAGE_MAX_DIM: int = 128
    RPN_ANCHOR_SCALES: Tuple[int, ...] = (8, 16, 32, 64, 128)
    RPN_NMS_MAX_ROIS_NUM: int = 64
    TRAIN_ROIS_PER_IMAGE: int = 16
    MAX_GT_INSTANCES: int = 8
    DETECTION_MAX_INSTANCES: int = 8
    RPN_TRAIN_ANCHORS_PER_IMAGE: int = 32
    COMPUTE_DTYPE: str = "float32"
