#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py                 # from the repository root
    python3 chip_smoke.py --profile DIR   # also write a torch.profiler
                                          # table of one B=8 predict_step
                                          # a model and of one B=4
                                          # training step

Phases, each printing one line:
 1. the card (nvidia-smi name and power limit, torch's device name);
 2. build the CUDA kernels from maskrcnn_tpu_torch/csrc;
 3. RoIAlign kernel, fed only boxes, vs its plain PyTorch version with
    its coordinate prologue on the card: B=8, levels 256/128/64/32,
    C=256, 500 boxes at P=7 and 50 at P=14 (with the edge boxes), in
    float32 with TF32 off and in bfloat16 (the count of differing values
    printed); the op on the card runs no PyTorch op but the mrt::roi_align
    custom op, and launches K1 once; its time at both shapes beside its
    bound and the plain version's; then the same checks, untimed, on the
    768x1024 canvas (levels 192x256 .. 24x32, its own level rule);
 3b. RoIAlign's int8-table mode the same way: int8 levels with four
    level scales, both shapes, bf16 and f32 out, both canvases; bit-equal
    (else at most 1 bf16 ulp, the count printed);
 4. NMS kernel vs its plain version at N = 500, 64, 1,320, 1,345, 2,000 and
    6,000 (above 1,320 the bitmask goes through device memory), boxes at
    0.7 and class-offset boxes at 0.3, with invalid rows: keep masks must
    be identical, one launch a call; the chain's step latency (one
    thread) and K2's chain bound; rpn_refine_scores at
    RPN_NMS_MAX_ROIS_NUM=2000 on the card equal to the CPU;
 4b. fused identity bottleneck kernel vs its plain version at the four
    identity-block shapes of ResNet-101 at B=8 on the 1024² canvas, float32
    and bfloat16, in bfloat16 at the four stage shapes of the 768x1024
    canvas (192x256 .. 24x32), and at odd small sizes (bf16 at every P of
    the four, so every bf16 tile has partial tiles); B=8 bf16 times
    beside the bound, the
    share of the bound reached, the plain version, the same folded block
    as cuDNN bf16 convs and (at the square shapes) version 3's time;
 4c. paste-and-pack kernel vs its plain version: 400 detections on the
    1024² canvas, 400 on the 768x1024 one and 100 on a ragged 1000x997
    one, with edge boxes and
    invalid rows; bits identical except threshold ties, zero outside the
    boxes, in invalid rows and in the padding bits;
 4e. the grouped-RoIAlign gate study (K5, on no path) vs its plain
    version: 2,500 groups, float32 and bf16-cast patches, 3-D and 2-D
    layouts; its bound on the tensor cores, one torch.einsum over all
    groups as the library's time, version 1's time; microseconds per box
    beside K1's at P=7;
 4d. the int8 conv (im2col + torch._int_mm) vs its plain version (a
    float64 conv) at B=8: the 1x1s and the 3x3 of each stage C2-C5, C4's
    strided 1x1 and P2's 3x3; int32 accumulators equal; times beside
    cuDNN's bf16 conv of the shape and the unfused quantize and
    dequantize passes around it;
 5. the slice: Detector(CocoInferenceConfig, ResNet-101, bf16, 1024²
    canvas) with seeded random weights answers three requests (8, 8 and 1
    images); kernel launch counts during them; kernels vs plain versions
    on the run's own FPN maps and proposals; the port on the card vs the
    port on the CPU on a 128-px float32 config;
 5d. the FOLD_BN slice: the same three requests through
    Detector(CocoInferenceConfig with FOLD_BN), 29 bottleneck launches a
    step; on the 128-px float32 config the folded port on the card vs the
    folded port on the CPU, and vs the unfolded port on the card;
 5f. the QUANT_INT8 slice: Detector(CocoInferenceConfig with
    QUANT_INT8), calibrated (mse) on two default canvases (timed), the
    same three requests, both RoIAligns of every step in int8-table mode;
 5g. on the 128-px float32 config with QUANT_INT8 and one set of
    calibration stats, the int8 port on the card vs on the CPU;
 5h. the product surface under the default CocoInferenceConfig as it is
    (ORIG_MASK_CANVAS 640): a seeded float32 state written as a
    reference-layout .pth under build/ and loaded with
    Detector.load_weights into a default and a FOLD_BN Detector (states
    bit-equal to the file's); one request of eight COCO-sized images
    (333-640 px a side, resampled without Pillow, masks decoded on the
    device), the same through the FOLD_BN Detector, one request holding a
    1000x750 image (host mask decode), the eight again under
    DEVICE_MASK_DECODE=False (share of mask pixels apart between the two
    decodes < 0.02), the eight through a DEVICE_RESIZE Detector (canvases
    resampled on the card, equal to the CPU's plain run but at .5 ties,
    the resample's device time); COCO ground truth built from those
    results with build_coco_results and evaluate_coco for bbox and segm
    through the
    host-decode Detector (AP@[.5:.95] >= 0.95, detections with an empty
    box or mask left out on both sides); the native RLE library in use,
    Pillow never imported; B=8 detect_batch end to end on both decode
    routes (median of 3, img/s) and the host resample, host decode and
    RLE encode per image, and the DEVICE_RESIZE route beside them;
 7. training (after 5h, before phase 6's timings): 7a K1-bwd, the
    RoIAlign backward kernel, against its plain version (float32
    index_add_) at the training step's shapes (B=4, N=100, C=256, P=7 and
    14, edge and zero boxes, both canvases; float32 within 1e-5 of a
    level's largest gradient, bf16 within 1 ulp of the float32 sums
    rounded once beside the float32 order slack), one launch a call, its
    time beside its bound and the plain version's; 7b one float32 step
    of the 128-px config on the card against the CPU (the six losses
    within 1e-4 relative, the gradients of fpn.P2_conv1 and a C2 conv
    within 1e-4 of their max: the FPN's gradient passes K1-bwd); 7c the
    CocoConfig training step (ResNet-101, bf16, 1024², float32 master
    weights, REMAT_BACKBONE) through Trainer.fit, 10 steps at B=1 and at
    B=4 on SyntheticLoader batches (masks bit-packed): median ms a step,
    img/s, peak memory, the losses finite, the step count, K1 / K1-bwd /
    K2 launches a step 2 / 2 / 1; one train_step in sync-debug mode; 3
    steps under layers "heads" leave every ResNet weight bit-identical;
 6. one predict_step at B=8 in sync-debug "error" mode (no host sync),
    then the median of 5 timed calls at B=8 and at B=1, for the default,
    the FOLD_BN and the QUANT_INT8 model (--profile: a table of each);
 5i. the inference protocols at the same width, one Detector each:
    cascade (0.5, 0.6, 0.7) + soft-NMS 0.5, flip TTA + soft-NMS 0.5, flip
    TTA with hard NMS, 17 keypoints (8 x conv512 head), and a 768x1024
    canvas under FOLD_BN and under QUANT_INT8: three requests (8, 8 and 1
    images) with every result checked, the kernels' launches of one B=8
    step against the expected counts, every class-offset NMS call of a
    hard TTA step (the merge's at N = 2D) through the kernel and the plain
    version (keep masks identical), one step in sync-debug mode, B=8 and
    B=1 medians (of 3) beside the default's, and the port on the card
    against the CPU at tiny width; soft-NMS's ops and time a call;
 8. after 5i, the serving, RetinaNet, data-parallel, export and
    profiler modules at full width:
    8a BatchingDetector(max_batch=8) over the phase-5 Detector: eight
    threads submit 32 COCO-sized images, every result equal to
    detect_batch's on the batch the server ran (class ids and boxes
    equal, mask pixels apart < 0.02), img/s and p50/p99 latency, and from
    a torch.profiler trace of the same requests the share of the copy
    stream's device-to-host copies that ran beside a kernel;
    8b RetinaNet (CocoInferenceConfig: 1024², 81 classes, bf16), default
    and QUANT_INT8: B=8 detect with its class-offset K2 call (N = 1,000
    boxes an image) held against the plain version (keep masks
    identical), K2's time there beside its bounds, B=8 and B=1 medians;
    8c two gloo ranks on the one card (this script with --dp-rank), one
    image each of 7b's scene: the data-parallel step against the
    one-process step within 1e-4; a one-rank nccl group through
    Trainer.fit for two steps;
    8d predict_step B=8 exported with torch.export (weights as its
    input, K1/K2/K4 as the custom ops of kernels/torch_ops.py), loaded in
    a process importing torch and kernels.torch_ops only: outputs
    bit-identical, its launches and time beside the live step's;
    8e utils.profiler.trace around one step writes a Chrome trace;
then one JSON line of per-kernel numbers (time, launches on the main
path, error, plain version's time, the bound and what sets it, the
library's time; K1 and K1-bwd at P=7 and, in the `_p14` keys, at P=14
(K1-bwd's launches from phase 7c's training runs); K2's chain
bound and version 1's time, and its time at RetinaNet's N = 1,000 in the
`_retina` keys; K5 in float32 and, in the `_bf16` keys, bf16, with
version 1's times), and, last, the result line.
Exits non-zero, printing no result line, without a CUDA device or when
any check fails. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import itertools
import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

CANVAS = (1024, 1024, 3)
# the IMAGE_CANVAS of phase 5i's canvas protocols; phases 3, 3b, 4b and 4c
# hold K1, K3 and K4 against their plain versions at its shapes too
RECT_CANVAS = (768, 1024)
DEVICE = "cuda"


def card_info() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


# about 50-70 ms of a spinning kernel at the H100's clocks
SPIN_CYCLES = 100_000_000


def cuda_ms(fn, iters: int = 20, warmup: int = 3,
            queued: bool = True) -> float:
    """Mean device time of fn over `iters` back-to-back calls. Queued (the
    default), the calls are enqueued behind a spinning kernel, so the card
    runs them back to back and the host's launch cost does not set the
    time (unless enqueueing them outlasts the spin). Not queued: the time
    of the calls as a caller issues them, host cost included."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def edge_boxes(rng: np.random.RandomState, n: int) -> np.ndarray:
    """[n, 4] normalized boxes; rows 0-4 are the edge cases: partly
    outside, zero, extreme wide, extreme tall, bottom-right corner."""
    ctr = rng.rand(n, 2) * 0.8 + 0.1
    sz = rng.rand(n, 2) * 0.25 + 0.02
    y1 = np.clip(ctr[:, 0] - sz[:, 0] / 2, 0, 1)
    y2 = np.clip(ctr[:, 0] + sz[:, 0] / 2, 0, 1)
    x1 = np.clip(ctr[:, 1] - sz[:, 1] / 2, 0, 1)
    x2 = np.clip(ctr[:, 1] + sz[:, 1] / 2, 0, 1)
    b = np.stack([y1, x1, y2, x2], 1).astype(np.float32)
    b[0] = [-0.2, -0.2, 0.3, 0.3]
    b[1] = [0, 0, 0, 0]
    b[2] = [0.1, 0.05, 0.12, 0.95]
    b[3] = [0.05, 0.4, 0.95, 0.44]
    b[4] = [0.9, 0.9, 0.99, 0.999]
    return b


def bf16_ulps(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |got - want| in units of want's bfloat16 spacing."""
    want = want.float()
    _, exp = torch.frexp(want)
    ulp = torch.where(want == 0, torch.full_like(want, 2.0 ** -133),
                      torch.ldexp(torch.ones_like(want), exp - 8))
    return float(((got.float() - want).abs() / ulp).max())


# Published peaks of one H100 SXM (dense): the bound of a kernel is the
# larger of its bytes over the memory rate and its operations over the
# peak rate of their type.
HBM_BYTES_PER_S = 3.35e12
PEAK_BF16 = 989e12   # tensor cores, bf16
PEAK_F32 = 67e12     # float32 outside the tensor cores


def bound(nbytes: float, ops: float, peak: float):
    """(least ms for the work, "bytes" or "operations")."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def roi_bound(roi, levels, boxes, pool, out):
    """K1's bound on these inputs: the table rows its samples read (each
    distinct row once: inside-the-level corners of every sample), the
    output written once and the boxes (16 B each); 4 taps of a multiply
    and an add, and the 4 corner weights, a value, in float32."""
    lvl, in_y, in_x = roi.level_geometry(levels, boxes, pool, CANVAS)
    dev = in_y.device
    m, p = in_y.shape
    n = boxes.shape[1]
    c = levels[0].shape[-1]
    heights = torch.tensor([f.shape[1] for f in levels], device=dev)
    widths = torch.tensor([f.shape[2] for f in levels], device=dev)
    sizes = torch.tensor([f.shape[0] * f.shape[1] * f.shape[2]
                          for f in levels], device=dev)
    lv = lvl.long()
    h_l, w_l = heights[lv], widths[lv]
    ys, _, out_y = roi._axis_taps(in_y, (h_l - 1).float()[:, None])
    xs, _, out_x = roi._axis_taps(in_x, (w_l - 1).float()[:, None])
    y0, x0 = ys.long(), xs.long()
    y1 = torch.minimum(y0 + 1, (h_l - 1)[:, None])
    x1 = torch.minimum(x0 + 1, (w_l - 1)[:, None])
    base = (torch.cumsum(sizes, 0) - sizes)[lv] + (
        torch.arange(m, device=dev) // n) * h_l * w_l
    inside = ~(out_y[:, :, None] | out_x[:, None, :])
    rows = [(base[:, None, None] + yy[:, :, None] * w_l[:, None, None]
             + xx[:, None, :])[inside]
            for yy in (y0, y1) for xx in (x0, x1)]
    distinct = int(torch.unique(torch.cat(rows)).numel())
    nbytes = (distinct * c * levels[0].element_size()
              + out.numel() * out.element_size() + m * 16)
    return bound(nbytes, out.numel() * 12.0, PEAK_F32)


# (P, N) of the box head's and the mask head's RoIAlign
ROI_SHAPES = ((7, 500), (14, 50))


def op_log():
    """A dispatch mode that records in its `computed` the name of every
    PyTorch op run inside it that computes: views (whose result aliases
    an input and writes nothing) left out, in-place ops and copies
    kept."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.computed = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not any(r.alias_info is not None and not r.alias_info.is_write
                       for r in func._schema.returns):
                self.computed.append(func.overloadpacket.__name__)
            return func(*args, **(kwargs or {}))

    return Ops()


def roi_ops_check(kernels, roi, levels, boxes, pool, *args, canvas=CANVAS):
    """The fused op on the card runs no PyTorch op that computes but the
    mrt::roi_align custom op (every PyTorch kernel goes through an op seen
    here; the op's own output allocation runs inside it) and launches K1
    once. Returns the ops seen."""
    before = kernels.roi_align.launches
    with op_log() as ops:
        roi.multilevel_roi_align_impl(levels, boxes, pool, canvas, *args)
    check(ops.computed == ["roi_align"]
          and kernels.roi_align.launches == before + 1,
          f"roi_align op on the card: ops {ops.computed}, launches "
          f"{kernels.roi_align.launches - before}")
    return ops.computed


def roi_op_times(roi, levels, boxes, pool, *args):
    """K1's op on the card (queued), the same op as a caller issues it back
    to back (host cost included), the plain coordinate prologue alone (what
    version 1 ran in PyTorch before its launch) and the plain version."""
    def op():
        return roi.multilevel_roi_align_impl(levels, boxes, pool, CANVAS,
                                             *args)
    return (cuda_ms(op), cuda_ms(op, queued=False),
            cuda_ms(lambda: roi.level_geometry(levels, boxes, pool, CANVAS)),
            cuda_ms(lambda: roi.multilevel_roi_align(levels, boxes, pool,
                                                     CANVAS, *args), iters=5))


def roi_align_phase(kernels, roi):
    """Phase 3: K1 (fed only boxes) against the plain version with its
    PyTorch coordinate prologue, at the slice's shapes: on the 1024²
    canvas (timed) and on the 768x1024 one (rectangular levels and the
    level rule of its area)."""
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    rng = np.random.RandomState(0)
    worst, times = 0.0, {}
    for cfg in (slice_config(), rect_config()):
        canvas = cfg.IMAGE_SHAPE
        for dtype in (torch.float32, torch.bfloat16):
            levels = [torch.randn(8, h, w, 256, generator=gen, device=DEVICE)
                      .to(dtype) for h, w in stage_shapes(cfg)]
            for pool, n in ROI_SHAPES:
                boxes = torch.from_numpy(np.stack(
                    [edge_boxes(rng, n) for _ in range(8)])).to(DEVICE)
                flat = boxes.reshape(-1, 4)
                got = kernels.roi_align(levels, flat, pool, canvas)
                want = roi.multilevel_roi_align(levels, boxes, pool,
                                                canvas).reshape(got.shape)
                torch.cuda.synchronize()
                differ = int((got != want).sum())
                err = float((got.float() - want.float()).abs().max())
                worst = max(worst, err)
                line = (f"{differ} of {got.numel()} values differ, "
                        f"max_abs_err {err:.3g}")
                name = (f"{str(dtype)[6:]} {canvas[0]}x{canvas[1]} B=8 "
                        f"N={n} P={pool} C=256")
                if dtype == torch.float32:
                    check(err <= 1e-5, f"roi_align {name}: err {err}")
                else:
                    ulps = bf16_ulps(got, want)
                    check(ulps <= 1.0, f"roi_align {name}: {ulps} ulp")
                    line += f" ({ulps:g} bf16 ulp)"
                ops = roi_ops_check(kernels, roi, levels, boxes, pool,
                                    canvas=canvas)
                if canvas != CANVAS:
                    print(f"[3] roi_align {name}: {line}; the op ran {ops} "
                          f"and one K1 launch", flush=True)
                    continue
                ms, issued_ms, prologue_ms, plain_ms = roi_op_times(
                    roi, levels, boxes, pool)
                bound_ms, bound_by = roi_bound(roi, levels, boxes, pool, got)
                times[(dtype, pool)] = (ms, plain_ms, issued_ms, bound_ms,
                                        bound_by)
                print(f"[3] roi_align {name}: {line}; op {ms:.4f} ms on the "
                      f"card (bound {bound_ms:.4f} by {bound_by}, "
                      f"{bound_ms / ms:.1%} of it; {issued_ms:.4f} ms a call "
                      f"as issued, host included); the plain prologue that "
                      f"version 1 ran before its launch {prologue_ms:.4f} "
                      f"ms; plain {plain_ms:.4f} ms; the op ran {ops} and "
                      f"one K1 launch", flush=True)
    return worst, times


ROI_SCALES = (0.021, 0.017, 0.032, 0.009)


def roi_int8_phase(kernels, roi):
    """Phase 3b: K1's int8-table mode (fed only boxes) against its plain
    version with its PyTorch prologue at the slice's shapes (int8 P2..P5
    with four level scales), bf16 and f32 out, on the 1024² canvas (timed)
    and the 768x1024 one. Bar: bit-equal; else at most 1 bf16 ulp, the
    count of differing values printed."""
    gen = torch.Generator(device=DEVICE).manual_seed(6)
    rng = np.random.RandomState(6)
    worst, times = 0.0, {}
    for cfg in (slice_config(), rect_config()):
        canvas = cfg.IMAGE_SHAPE
        levels = [torch.randint(-127, 128, (8, h, w, 256), generator=gen,
                                device=DEVICE, dtype=torch.int8)
                  for h, w in stage_shapes(cfg)]
        for pool, n in ROI_SHAPES:
            boxes = torch.from_numpy(np.stack(
                [edge_boxes(rng, n) for _ in range(8)])).to(DEVICE)
            flat = boxes.reshape(-1, 4)
            for out_dtype in (torch.bfloat16, torch.float32):
                args = (ROI_SCALES, out_dtype)
                got = kernels.roi_align(levels, flat, pool, canvas, *args)
                want = roi.multilevel_roi_align(levels, boxes, pool, canvas,
                                                *args).reshape(got.shape)
                torch.cuda.synchronize()
                name = (f"{str(out_dtype)[6:]} {canvas[0]}x{canvas[1]} B=8 "
                        f"N={n} P={pool} C=256")
                check(got.dtype == want.dtype == out_dtype,
                      f"roi_align int8 {name}: out dtype {got.dtype}")
                differ = int((got != want).sum())
                err = float((got.float() - want.float()).abs().max())
                ulps = bf16_ulps(got, want)
                check(differ == 0 or ulps <= 1.0,
                      f"roi_align int8 {name}: {differ} differ, {ulps} bf16 "
                      f"ulp")
                worst = max(worst, err)
                roi_ops_check(kernels, roi, levels, boxes, pool, *args,
                              canvas=canvas)
                line = (f"{differ} of {got.numel()} values differ, "
                        f"max_abs_err {err:.3g} ({ulps:g} bf16 ulp)")
                if canvas != CANVAS:
                    print(f"[3b] roi_align int8 tables -> {name}: {line}",
                          flush=True)
                    continue
                ms, issued_ms, prologue_ms, plain_ms = roi_op_times(
                    roi, levels, boxes, pool, *args)
                bound_ms, bound_by = roi_bound(roi, levels, boxes, pool, got)
                times[(out_dtype, pool)] = (ms, plain_ms, issued_ms,
                                            bound_ms, bound_by)
                print(f"[3b] roi_align int8 tables -> {name}: {line}; op "
                      f"{ms:.4f} ms on the card (bound {bound_ms:.4f} by "
                      f"{bound_by}, {bound_ms / ms:.1%} of it; "
                      f"{issued_ms:.4f} ms a call as issued); plain prologue "
                      f"{prologue_ms:.4f} ms; plain {plain_ms:.4f} ms",
                      flush=True)
    return worst, times


# The int8 convs of ResNet-101 and the FPN at B=8 on the 1024² canvas, per
# stage: (name, input [H, W, C], output channels, kernel side, stride)
INT8_CONVS = tuple(
    conv for stage, s, p in (("C2", 256, 64), ("C3", 128, 128),
                             ("C4", 64, 256), ("C5", 32, 512))
    for conv in ((f"{stage} 1x1 reduce", (s, s, 4 * p), p, 1, 1),
                 (f"{stage} 3x3", (s, s, p), p, 3, 1),
                 (f"{stage} 1x1 expand", (s, s, p), 4 * p, 1, 1))
) + (("C4 1x1 stride 2 (block0 conv1)", (128, 128, 512), 256, 1, 2),
     ("P2 3x3 (P2_conv2, RPN shared conv)", (256, 256, 256), 256, 3, 1))


def int8_conv_phase():
    """Phase 4d: the int8 conv (im2col + torch._int_mm) against its plain
    version (float64 conv) on the card: int32 accumulators exactly equal.
    Times beside cuDNN's bf16 conv of the same shape, and the unfused
    passes around the GEMM: quantizing its bf16 input and the dequantize
    epilogue (scale, bias, ReLU) to bf16."""
    import torch.nn.functional as F
    from maskrcnn_tpu_torch.ops import int8_conv as ic
    gen = torch.Generator(device=DEVICE).manual_seed(7)
    scale = torch.tensor(0.02, device=DEVICE)
    for name, (h, w, c), o, k, stride in INT8_CONVS:
        x = torch.randint(-127, 128, (8, h, w, c), generator=gen,
                          device=DEVICE, dtype=torch.int8)
        wq = torch.randint(-127, 128, (o, k, k, c), generator=gen,
                           device=DEVICE, dtype=torch.int8)
        pad = (k - 1) // 2
        got = ic.int8_conv_gemm(x, wq, stride, pad)
        want = ic.int8_conv_plain(x, wq, stride, pad)
        torch.cuda.synchronize()
        differ = int((got != want).sum())
        check(got.dtype == torch.int32 and differ == 0,
              f"int8 conv {name}: {differ} accumulators differ")
        del want
        gemm_ms = cuda_ms(lambda: ic.int8_conv_gemm(x, wq, stride, pad),
                          iters=10)
        xb = x.to(torch.bfloat16).permute(0, 3, 1, 2)
        wb = wq.to(torch.bfloat16).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        cudnn_ms = cuda_ms(lambda: F.conv2d(xb, wb, stride=stride,
                                            padding=pad), iters=10)
        xh = xb.permute(0, 2, 3, 1)
        q_ms = cuda_ms(lambda: ic.quantize_tensor(xh, scale), iters=10)
        ws = torch.rand(o, generator=gen, device=DEVICE) * 1e-3
        bias = torch.randn(o, generator=gen, device=DEVICE)
        dq_ms = cuda_ms(lambda: ic.dequantize(got, scale, ws, bias,
                                              torch.bfloat16, True), iters=10)
        print(f"[4d] int8 conv {name} B=8 {h}x{w}x{c} -> {o}: int32 "
              f"accumulators equal ({got.numel()}); im2col + _int_mm "
              f"{gemm_ms:.4f} ms, cuDNN bf16 conv {cudnn_ms:.4f} ms; "
              f"quantize input {q_ms:.4f} ms, dequantize epilogue "
              f"{dq_ms:.4f} ms", flush=True)


def nms_boxes(rng, b, n):
    """[b, n, 4] pixel boxes jittered around a few centres per image, so
    suppression chains are long, and [b, n] valid with a tenth invalid."""
    centres = rng.rand(b, 6, 2) * 800 + 100
    ctr = (centres[np.arange(b)[:, None], rng.randint(0, 6, (b, n))]
           + rng.randn(b, n, 2) * 25)
    size = rng.uniform(40, 160, (b, n, 2))
    return (np.concatenate([ctr - size / 2, ctr + size / 2], -1),
            rng.rand(b, n) > 0.1)


# (B, N) of phase 4: the main path's N=500 (not a multiple of 64), a
# multiple of 64, the largest N whose bitmask shared memory holds (1,320),
# and N above it up to a chain of 94 blocks
NMS_SHAPES = ((8, 500), (8, 64), (8, 1320), (8, 1345), (8, 2000),
              (2, 6000))
# K2 version 1 (PERF.md's kernel table, NVIDIA H100 80GB HBM3,
# 700 W): B=8 N=500 at 0.7, two launches
K2_V1_MS = 0.0537


def nms_chain_step(kernels):
    """Cycles and nanoseconds of one dependent step of K2's chain (one
    thread, 64-bit bit-test-and-OR), measured over 1.28 M steps."""
    kernels._nms_chain_probe(100)
    blocks = 20_000
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    cycles = kernels._nms_chain_probe(blocks)
    end.record()
    torch.cuda.synchronize()
    return cycles, start.elapsed_time(end) * 1e6 / (blocks * 64)


def nms_phase(kernels, nms):
    """Phase 4: K2 against the plain version, keep masks identical, at
    every N of NMS_SHAPES, proposals at 0.7 and class-offset boxes at 0.3,
    with invalid rows; one launch a call. At B=8 N=500 (the main path):
    its time beside both bounds (bytes and operations; the chain of N
    dependent steps at the probe's step latency), the plain version's
    and version 1's."""
    rng = np.random.RandomState(1)
    cycles, step_ns = nms_chain_step(kernels)
    print(f"[4] nms chain step: {cycles:.2f} cycles, {step_ns:.3f} ns "
          f"(one thread, 1.28 M dependent steps)", flush=True)
    times = None
    for b, n in NMS_SHAPES:
        boxes, valid = nms_boxes(rng, b, n)
        cases = [("proposals thr 0.7", boxes.astype(np.float32), 0.7)]
        classes = rng.randint(0, 81, (b, n))
        offset = classes[..., None] * (1024.0 + 2.0)
        cases.append(("class-offset thr 0.3",
                      (np.round(boxes) + offset).astype(np.float32), 0.3))
        vt = torch.from_numpy(valid).to(DEVICE)
        for name, bx, thr in cases:
            bt = torch.from_numpy(bx).to(DEVICE)
            before = kernels.nms.launches
            got = kernels.nms(bt, vt, thr)
            calls = kernels.nms.launches - before
            want = nms.nms_mask(bt, vt, thr)
            torch.cuda.synchronize()
            diff = int((got != want).sum())
            check(diff == 0 and calls == 1,
                  f"nms {name} B={b} N={n}: {diff} keep entries differ, "
                  f"{calls} launches")
            ms = cuda_ms(lambda: kernels.nms(bt, vt, thr))
            line = (f"[4] nms {name} B={b} N={n}: keep identical "
                    f"({int(got.sum())} kept), {calls} launch; kernel "
                    f"{ms:.4f} ms")
            if n == 500:
                plain_ms = cuda_ms(lambda: nms.nms_mask(bt, vt, thr),
                                   iters=3, warmup=1)
                # boxes and valid read, keep written once; every pair's
                # IoU (about 12 float32 operations: 4 min/max, 2 widths,
                # area, union, compare)
                bound_ms, bound_by = bound(
                    bt.numel() * 4 + vt.numel() * 2,
                    b * n * (n - 1) / 2 * 12.0, PEAK_F32)
                chain_ms = n * step_ns * 1e-6
                pace = "the chain" if chain_ms > bound_ms else bound_by
                line += (f" (bound {bound_ms:.6f} by {bound_by}; chain "
                         f"bound {chain_ms:.6f}, {n} steps: {pace} sets the "
                         f"pace, {chain_ms / ms:.1%} of it), plain "
                         f"{plain_ms:.4f} ms, v1 {K2_V1_MS} ms (PERF.md)")
                times = times or (ms, plain_ms, bound_ms, bound_by,
                                  chain_ms, calls)
            print(line, flush=True)
    return times


def rpn_nms_2000_phase(kernels):
    """Phase 4: rpn_refine_scores with RPN_NMS_MAX_ROIS_NUM=2000 (so K2
    runs at N=2000, above what its shared memory holds) on the card
    equals the same call on the CPU. The size deltas are 0, so every
    operation before NMS is exact on both (exp(0) = 1; a CPU and a CUDA
    exp may differ in the last bit elsewhere)."""
    from maskrcnn_tpu_torch.detection.pipeline import rpn_refine_scores
    from maskrcnn_tpu_torch.ops.anchors import config_anchors
    cfg = slice_config().replace(RPN_NMS_MAX_ROIS_NUM=2000)
    check(cfg.PRE_NMS_LIMIT == 2000, f"PRE_NMS_LIMIT {cfg.PRE_NMS_LIMIT}")
    rng = np.random.RandomState(9)
    anchors = torch.from_numpy(config_anchors(cfg))
    a = anchors.shape[0]
    scores = torch.from_numpy(rng.rand(2, a).astype(np.float32))
    deltas = np.zeros((2, a, 4), np.float32)
    deltas[..., :2] = rng.randn(2, a, 2) * 0.5
    deltas = torch.from_numpy(deltas)
    before = kernels.nms.launches
    got_p, got_v = rpn_refine_scores(cfg, anchors.to(DEVICE),
                                     scores.to(DEVICE), deltas.to(DEVICE))
    calls = kernels.nms.launches - before
    want_p, want_v = rpn_refine_scores(cfg, anchors, scores, deltas)
    check(calls == 1 and torch.equal(got_v.cpu(), want_v)
          and torch.equal(got_p.cpu(), want_p),
          f"rpn_refine_scores N=2000: card differs from the CPU ({calls} "
          f"launches)")
    print(f"[4] rpn_refine_scores RPN_NMS_MAX_ROIS_NUM=2000, B=2: card "
          f"equals CPU ({int(want_v.sum())} of {want_v.numel()} proposals "
          f"valid), 1 K2 launch", flush=True)


# identity-block shapes (H, W, P) of ResNet-101 on the 1024² canvas: C2 to
# C5 hold 2, 3, 22 and 2 identity blocks
BLOCK_SHAPES = ((256, 256, 64), (128, 128, 128), (64, 64, 256), (32, 32, 512))
# A float32 sum in another order can land an intermediate (h1 or h2) on
# the other side of a bf16 rounding boundary; that one bf16 ulp of an
# intermediate spreads through the next conv. So bf16 outputs are held to
# 2 bf16 ulp except a share of at most 1%, and every error to 2% of the
# output's range.
BF16_SHARE, BF16_RANGE = 0.01, 0.02


def bf16_ulp_share(got: torch.Tensor, want: torch.Tensor, ulps: float):
    """Share of elements more than `ulps` bf16 ulp apart, the spacing
    taken at the larger magnitude of the two."""
    got, want = got.float(), want.float()
    big = torch.maximum(got.abs(), want.abs())
    _, exp = torch.frexp(big)
    ulp = torch.ldexp(torch.ones_like(big), exp - 8)
    far = ((got - want).abs() > ulps * ulp) & (big > 0)
    return float(far.float().mean())


def bottleneck_weights(gen, c, p, dtype):
    """Packed (K-major) folded weights of one block, w1 [P, C], w2 [P, 9,
    P], w3 [C, P]: fan-in scaled, nonzero biases."""
    shapes = ((p, c), (p,), (p, 9, p), (p,), (c, p), (c,))
    out = []
    for i, shape in enumerate(shapes):
        t = torch.randn(*shape, generator=gen, device=DEVICE)
        if i % 2 == 0:
            out.append((t / (shape[-1] * (9 if i == 2 else 1)) ** 0.5)
                       .to(dtype).contiguous())
        else:
            out.append(t * 0.1)
    return out


def cudnn_block(x, w1, b1, w2, b2, w3, b3):
    """The same folded block as three cuDNN convs with bias and relu and
    the residual add: what the unfused folded path costs."""
    import torch.nn.functional as F
    p = w1.shape[0]
    dt = x.dtype
    conv = [w1[:, :, None, None], w2.reshape(p, 3, 3, p).permute(0, 3, 1, 2),
            w3[:, :, None, None]]
    conv = [w.contiguous(memory_format=torch.channels_last) for w in conv]
    b1, b2, b3 = (b.to(dt) for b in (b1, b2, b3))

    def run():
        xc = x.permute(0, 3, 1, 2)
        h = F.relu(F.conv2d(xc, conv[0], b1))
        h = F.relu(F.conv2d(h, conv[1], b2, padding=1))
        return F.relu(F.conv2d(h, conv[2], b3) + xc)
    return run


# version 3 of K3 (wmma; PERF.md's kernel table, NVIDIA H100
# 80GB HBM3, 700 W), by (H, W, P) at B=8
K3_V3_MS = {(256, 256, 64): 1.2275, (128, 128, 128): 1.0877,
            (64, 64, 256): 1.2884, (32, 32, 512): 1.1814}


def k3_bound(b, h, w, p):
    """K3's bound at B x H x W, C = 4P, bf16: x read and y written once,
    the weights and biases read once; 2 * B*H*W * 17 P^2 flops."""
    c = 4 * p
    weights = c * p + 9 * p * p + p * c
    nbytes = 2 * (2 * b * h * w * c) + 2 * weights + 4 * (2 * p + c)
    return bound(nbytes, 2.0 * b * h * w * weights, PEAK_BF16)


def bottleneck_phase(kernels, bt):
    """Phase 4b: K3 against the plain version, float32 (TF32 off) and
    bfloat16, at the slice's block shapes, in bf16 at the 768x1024
    canvas's, and at odd small sizes: in bf16
    at each P of the four, whose tiles differ (8x16 with 64- or 128-column
    slices, 4x16 with the columns split at P=512), H and W that leave
    partial tiles. At B=8 in bf16: its time beside its bound and the share
    of the bound reached, cuDNN's folded block and version 3's time."""
    gen = torch.Generator(device=DEVICE).manual_seed(4)
    worst, times = 0.0, {}
    cases = [(8, h, w, p, dt) for h, w, p in BLOCK_SHAPES
             for dt in (torch.float32, torch.bfloat16)]
    cases += [(2, 4, 4, 16, torch.float32), (2, 25, 37, 16, torch.float32),
              (3, 4, 4, 64, torch.bfloat16)]
    cases += [(2, h, w, p, torch.bfloat16) for _, _, p in BLOCK_SHAPES
              for h, w in ((25, 37), (5, 3))]
    # the 768x1024 canvas's stages, as FOLD_BN runs them there
    cases += [(8, h, w, p, torch.bfloat16) for (h, w), (_, _, p)
              in zip(stage_shapes(rect_config()), BLOCK_SHAPES)]
    for b, h, w, p, dtype in cases:
        c = 4 * p
        x = torch.randn(b, h, w, c, generator=gen, device=DEVICE).to(dtype)
        weights = bottleneck_weights(gen, c, p, dtype)
        got = kernels.bottleneck(x, *weights)
        want = bt.fused_identity_bottleneck_plain(x, *weights)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        scale = float(want.float().abs().max())
        name = f"{str(dtype)[6:]} B={b} {h}x{w} C={c} P={p}"
        if dtype == torch.float32:
            # the same float32 products summed in another order
            check(err <= 1e-4 * scale, f"bottleneck {name}: err {err}")
            line = f"max_abs_err {err:.3g} (max |want| {scale:.3g})"
        else:
            share = bf16_ulp_share(got, want, 2.0)
            check(share <= BF16_SHARE and err <= BF16_RANGE * scale,
                  f"bottleneck {name}: {share:.3g} over 2 bf16 ulp, err "
                  f"{err}")
            worst = max(worst, err)
            line = (f"max_abs_err {err:.3g} (max |want| {scale:.3g}), "
                    f"{share:.3g} of outputs over 2 bf16 ulp")
        if b == 8:
            ms = cuda_ms(lambda: kernels.bottleneck(x, *weights), iters=10)
            plain_ms = cuda_ms(lambda: bt.fused_identity_bottleneck_plain(
                x, *weights), iters=3, warmup=1)
            line += f"; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms"
            if dtype == torch.bfloat16:
                cudnn_ms = cuda_ms(cudnn_block(x, *weights), iters=10)
                bound_ms, bound_by = k3_bound(b, h, w, p)
                line += (f"; bound {bound_ms:.4f} ms by {bound_by}, "
                         f"{bound_ms / ms:.1%} of it; cuDNN bf16 block "
                         f"{cudnn_ms:.4f} ms")
                v3 = K3_V3_MS.get((h, w, p))
                if v3:
                    line += f"; v3 {v3} ms (PERF.md), {v3 / ms:.2f}x"
                times[(h, w, p)] = (ms, plain_ms, cudnn_ms, bound_ms,
                                    bound_by)
        print(f"[4b] bottleneck {name}: {line}", flush=True)
    return worst, times


def paste_phase(kernels, mp, n, h, w):
    """Phase 4c: K4 against the plain version, at 400 detections (B=8 x
    50) on the 1024² and the 768x1024 canvas and on a ragged canvas (a
    row pitch and plane
    offsets that are not 16-byte aligned, padding bits): identical bits
    except threshold ties (pixels whose exact value lies within an ulp of
    127.5), none outside the boxes, in invalid rows or in the padding."""
    from maskrcnn_tpu_torch.ops.bits import unpack_masks
    rng = np.random.RandomState(5)
    masks = torch.from_numpy(rng.rand(n, 28, 28).astype(np.float32)).to(DEVICE)
    boxes = np.round(edge_boxes(rng, n) * [h, w, h, w]).astype(np.float32)
    boxes[5] = [0, 0, h, w]
    boxes[6] = [17, 23, 18, 24]
    boxes[8] = [h - 37, w - 45, h, w]   # touching the bottom-right edge
    boxes_t = torch.from_numpy(boxes).to(DEVICE)
    valid_np = rng.rand(n) > 0.2
    valid_np[:7] = True
    valid_np[7] = False
    valid_np[8] = True
    valid = torch.from_numpy(valid_np).to(DEVICE)
    got = kernels.paste_pack(masks, boxes_t, valid, h, w)
    want = mp.paste_masks_packed_plain(masks, boxes_t, valid, h, w)
    torch.cuda.synchronize()
    check(got.shape == want.shape, f"paste_pack: shape {tuple(got.shape)}")
    padded = unpack_masks(got, got.shape[-1] * 8).bool()
    check(not bool(padded[..., w:].any()), "paste_pack: padding bits set")
    got_bits = padded[..., :w]
    diff = got_bits != unpack_masks(want, w).bool()
    idx = torch.nonzero(diff)
    tie = 2 * float(np.spacing(np.float32(127.5)))
    if len(idx):
        # exact pasted values at the differing pixels, in float64
        d, yy, xx = idx.unbind(1)
        bx = boxes_t
        wy = mp._interp_operator(bx[:, 0], bx[:, 2] - bx[:, 0], h, 28)
        wx = mp._interp_operator(bx[:, 1], bx[:, 3] - bx[:, 1], w, 28)
        q = torch.floor(torch.clamp(masks * 255.0, 0.0, 255.0)).double()
        exact = torch.einsum("nm,nmj,nj->n", wy[d, yy].double(), q[d],
                             wx[d, xx].double())
        far = float((exact - 127.5).abs().max())
        check(far < tie, f"paste_pack: a bit differs {far} from the tie")
    y1, x1, y2, x2 = boxes_t.unbind(1)
    ys = torch.arange(h, device=DEVICE, dtype=torch.float32)
    xs = torch.arange(w, device=DEVICE, dtype=torch.float32)
    in_y = (ys >= y1[:, None]) & (ys < y1[:, None] + (y2 - y1).clamp_min(1)[:, None])
    in_x = (xs >= x1[:, None]) & (xs < x1[:, None] + (x2 - x1).clamp_min(1)[:, None])
    outside = got_bits & ~(in_y[:, :, None] & in_x[:, None, :])
    check(not bool(outside.any()), "paste_pack: bits outside a box")
    check(not bool(got_bits[~valid].any()), "paste_pack: bits in invalid rows")
    check(bool(got_bits[5].any()), "paste_pack: the full-canvas box is empty")
    check(bool(got_bits[8].any()), "paste_pack: the edge box is empty")
    ms = cuda_ms(lambda: kernels.paste_pack(masks, boxes_t, valid, h, w))
    issued_ms = cuda_ms(lambda: kernels.paste_pack(masks, boxes_t, valid, h,
                                                   w), queued=False)
    plain_ms = cuda_ms(lambda: mp.paste_masks_packed_plain(
        masks, boxes_t, valid, h, w), iters=5)
    # masks, boxes and valid read once, the packed bits written once; the
    # pixels inside the valid boxes (this run's data) each take a blend of
    # about 8 operations
    area = float(((y2 - y1).clamp_min(1) * (x2 - x1).clamp_min(1))[valid]
                 .sum())
    bound_ms, bound_by = bound(
        masks.numel() * 4 + boxes_t.numel() * 4 + n + got.numel(),
        area * 8.0, PEAK_F32)
    print(f"[4c] paste_pack N={n} {h}x{w}: {len(idx)} of {diff.numel()} bits "
          f"differ, all threshold ties; none outside boxes, in the padding "
          f"or in {int((~valid).sum())} invalid rows; kernel {ms:.4f} ms "
          f"on the card (bound {bound_ms:.4f} by {bound_by}, "
          f"{bound_ms / ms:.1%} of it; {issued_ms:.4f} ms a call as issued), "
          f"plain {plain_ms:.4f} ms", flush=True)
    return len(idx), ms, plain_ms, bound_ms, bound_by


# K5 version 1 (CUDA cores; PERF.md's kernel table, NVIDIA H100
# 80GB HBM3, 700 W): 2,500 groups, float32 / bf16 patches
K5_V1_MS = {torch.float32: 13.33, torch.bfloat16: 12.07}
PEAK_TF32 = 495e12   # tensor cores, TF32


def k5_bound(n, patches, out):
    """K5's bound for n groups: the patches read and the output written
    once; the first product's operations at the peak of the tensor cores
    that run it (bf16, or TF32 counted twice for float32's high and low
    parts), beside the second product's on the CUDA cores, the two units
    working at once; and, as version 1 counted it, every operation at the
    float32 CUDA-core peak."""
    first = n * 2.0 * 28 * 128 * 40 * 256
    second = n * 2.0 * 4 * 49 * 40 * 256
    nbytes = patches.numel() * patches.element_size() + out.numel() * 4
    f32 = patches.dtype == torch.float32
    t_tc = first * (2 if f32 else 1) / (PEAK_TF32 if f32 else PEAK_BF16)
    t_ops = max(t_tc, second / PEAK_F32) * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ms, bound_by = ((t_bytes, "bytes") if t_bytes >= t_ops
                          else (t_ops, "operations"))
    return bound_ms, bound_by, bound(nbytes, first + second, PEAK_F32)[0]


def group_roi_phase(k1_box_us):
    """Phase 4e: K5, the grouped-RoIAlign gate study, against its plain
    version at the gate's size (2,500 groups of 4 boxes): float32 and
    bf16-cast patches, [128, 40, 256] and [128, 10240], within 1e-5 of
    the output's range. Its time beside its bound, version 1's time and
    one torch.einsum over every group (the library's time; float32 with
    TF32 off); per box beside K1's at P=7, the gate's question."""
    from maskrcnn_tpu_torch.ops import group_roi as gr
    gen = torch.Generator(device=DEVICE).manual_seed(8)
    n = gr.N_GROUPS
    boxes = gr.K * n
    worst, out = 0.0, {}
    for dtype in (torch.float32, torch.bfloat16):
        for shape in ((128, 40, 256), (128, 40 * 256)):
            patches = torch.randn(*shape, generator=gen,
                                  device=DEVICE).to(dtype)
            got = gr.group_roi(patches, n)
            want = gr.group_roi_plain(patches, n)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            scale = float(want.abs().max())
            check(err <= 1e-5 * scale, f"group_roi {dtype} {shape}: err "
                  f"{err} of {scale}")
            worst = max(worst, err)
            ms = cuda_ms(lambda: gr.group_roi(patches, n), iters=5)
            plain_ms = cuda_ms(lambda: gr.group_roi_plain(patches, n),
                               iters=1, warmup=1)
            lib_ms = cuda_ms(lambda: gr.group_roi_einsum(patches, n),
                             iters=3, warmup=1)
            bound_ms, bound_by, cc_ms = k5_bound(n, patches, got)
            v1 = K5_V1_MS[dtype]
            print(f"[4e] group_roi {str(dtype)[6:]} {list(shape)} "
                  f"{n} groups: max_abs_err {err:.3g} (max |want| "
                  f"{scale:.3g}); kernel {ms:.4f} ms = "
                  f"{ms * 1e3 / boxes:.4f} us/box (bound {bound_ms:.4f} ms "
                  f"by {bound_by} on the tensor cores, "
                  f"{bound_ms / ms:.1%} of it; all at the float32 CUDA-core "
                  f"peak {cc_ms:.4f} ms, {cc_ms / ms:.1%}), einsum "
                  f"{lib_ms:.4f} ms, plain {plain_ms:.4f} ms, v1 {v1} ms "
                  f"(PERF.md), {v1 / ms:.2f}x; K1 bf16 P=7 op "
                  f"{k1_box_us:.4f} us/box", flush=True)
            out.setdefault(dtype, (ms, plain_ms, bound_ms, bound_by,
                                   lib_ms, cc_ms))
    return worst, out


def slice_config():
    """CocoInferenceConfig: ResNet-101, 81 classes, bf16, 1024² canvas,
    with masks decoded on the device for images up to 1024 px."""
    from maskrcnn_tpu_torch import CocoInferenceConfig
    return CocoInferenceConfig().replace(ORIG_MASK_CANVAS=1024)


def rect_config():
    """slice_config on the RECT_CANVAS canvas."""
    return slice_config().replace(IMAGE_CANVAS=RECT_CANVAS)


def stage_shapes(cfg):
    """(H, W) of C2..C5 and P2..P5 on cfg's canvas."""
    h, w = cfg.IMAGE_SHAPE[:2]
    return [(h // s, w // s) for s in cfg.BACKBONE_STRIDES[:4]]


def cfg_name(cfg) -> str:
    h, w = cfg.IMAGE_SHAPE[:2]
    stages = len(cfg.CASCADE_STAGES)
    sigma = cfg.DETECTION_SOFT_NMS_SIGMA
    return (f"{cfg.BACKBONE} {h}² " if h == w else
            f"{cfg.BACKBONE} {h}x{w} ") + (
        cfg.COMPUTE_DTYPE
        + (" FOLD_BN" if cfg.FOLD_BN else "")
        + (" QUANT_INT8" if cfg.QUANT_INT8 else "")
        + (f" cascade x{stages}" if stages else "")
        + (" TTA" if cfg.TTA_HFLIP else "")
        + (f" soft-NMS {sigma}" if sigma else "")
        + (f" keypoints {cfg.NUM_KEYPOINTS}" if cfg.NUM_KEYPOINTS else "")
        + (" DEVICE_RESIZE" if cfg.DEVICE_RESIZE else ""))


def make_images(rng, shapes):
    return [rng.randint(0, 256, s + (3,), dtype=np.uint8) for s in shapes]


KERNELS = ("roi_align", "roi_align_backward", "nms", "bottleneck",
           "paste_pack", "group_roi")


def launch_counts(kernels):
    """Launches of every kernel wrapper, K1's int8-mode share, and the
    int8 convs' integer GEMMs."""
    from maskrcnn_tpu_torch.ops.int8_conv import int8_conv_gemm
    counts = {k: getattr(kernels, k).launches for k in KERNELS}
    counts["roi_align_int8"] = kernels.roi_align.int8_launches
    counts["int8_gemm"] = int8_conv_gemm.calls
    return counts


def reset_counts(kernels):
    from maskrcnn_tpu_torch.ops.int8_conv import int8_conv_gemm
    for k in KERNELS:
        getattr(kernels, k).launches = 0
    kernels.roi_align.int8_launches = 0
    int8_conv_gemm.calls = 0


def slice_phase(kernels, cfg, tag="5"):
    """Phase 5 (and 5d, 5f): three requests through the Detector, with the
    kernels' launch counts and checks of every output. Under QUANT_INT8
    the Detector calibrates on two default canvases first (timed). Returns
    the detector, the first request's images and the launches of the
    run."""
    from maskrcnn_tpu_torch.api import Detector
    from maskrcnn_tpu_torch.quant import default_calib_canvases
    t0 = time.perf_counter()
    calib = (default_calib_canvases(cfg.IMAGE_SHAPE, n=2)
             if cfg.QUANT_INT8 else None)
    det = Detector(cfg, device=DEVICE,
                   generator=torch.Generator().manual_seed(0),
                   calib_images=calib)
    torch.cuda.synchronize()
    print(f"[{tag}] Detector {cfg_name(cfg)} on {DEVICE}, seeded init "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if cfg.QUANT_INT8:
        t0 = time.perf_counter()
        det.prepare()
        torch.cuda.synchronize()
        q = det.model.quant
        print(f"[{tag}] calibration ({cfg.QUANT_CALIB}, 2 canvases) and "
              f"quantization {time.perf_counter() - t0:.2f} s: "
              f"{len(q['convs'])} int8 convs, {len(q['acts'])} activation "
              f"scales", flush=True)
    # scale-1 images (min side >= IMAGE_MIN_DIM, max side <= the canvas):
    # no resample, padded windows of several shapes
    rng = np.random.RandomState(2)
    lo, hi = cfg.IMAGE_MIN_DIM, cfg.IMAGE_MAX_DIM
    shapes = [(lo, hi), (hi, hi)] + [
        tuple(int(v) for v in rng.randint(lo // 16, hi // 16 + 1, 2) * 16)
        for _ in range(6)]
    requests = [make_images(rng, shapes), make_images(rng, shapes[::-1]),
                make_images(rng, shapes[2:3])]

    reset_counts(kernels)
    counts = []
    outputs = []
    for images in requests:
        before = launch_counts(kernels)
        handle = det.dispatch_batch(images)
        out = handle[0]
        results = det.fetch(handle)
        counts.append({k: v - before[k]
                       for k, v in launch_counts(kernels).items()})
        outputs.append((images, out, results))
    launches = launch_counts(kernels)

    # one predict_step a request; ResNet-101 has 29 identity blocks; under
    # QUANT_INT8 both RoIAligns of a step read int8 tables
    blocks = 29 if cfg.FOLD_BN else 0
    # one GEMM a quantized conv, the RPN's shared conv once a level (P2-P6)
    gemms = len(det.model.quant["convs"]) + 4 if cfg.QUANT_INT8 else 0
    d = cfg.DETECTION_MAX_INSTANCES
    for r, ((images, out, results), n) in enumerate(zip(outputs, counts)):
        b = len(images)
        int8_roi = n["roi_align"] if cfg.QUANT_INT8 else 0
        check(n["roi_align"] == 2 and n["nms"] >= 2
              and n["paste_pack"] >= 1 and n["bottleneck"] == blocks
              and n["roi_align_int8"] == int8_roi
              and n["int8_gemm"] == gemms,
              f"request {r}: kernel launches {n}")
        check(tuple(out["class_ids"].shape) == (b, d)
              and tuple(out["boxes"].shape) == (b, d, 4)
              and tuple(out["masks_packed"].shape)
              == (b, d, cfg.ORIG_MASK_CANVAS, cfg.ORIG_MASK_CANVAS // 8),
              f"request {r}: output shapes")
        check(bool(torch.isfinite(out["boxes"]).all())
              and bool(torch.isfinite(out["scores"]).all()),
              f"request {r}: non-finite boxes or scores")
        per_image = []
        for img, res in zip(images, results):
            check(res is not None, f"request {r}: an image has no detection")
            cls, scores, boxes, masks = res
            check(len(cls) >= 1 and masks.shape == (len(cls),)
                  + img.shape[:2], f"request {r}: decoded mask shape")
            check(np.isfinite(boxes).all() and np.isfinite(scores).all(),
                  f"request {r}: non-finite decoded values")
            check(all(0 < c < cfg.NUM_CLASSES for c in cls),
                  f"request {r}: class ids out of range")
            per_image.append(len(cls))
        print(f"[{tag}] request {r}: {b} images, detections {per_image}, "
              f"launches " + " ".join(f"{k} {v}" for k, v in n.items()),
              flush=True)
    return det, requests[0], launches


def intermediates_phase(det, images, kernels, roi, nms):
    """Phase 5b: kernels vs plain versions on the run's own FPN maps and
    sorted proposals."""
    from maskrcnn_tpu_torch.detection import pipeline
    from maskrcnn_tpu_torch.ops.image import normalize_image
    cfg, model = det.config, det.model
    batch, _, _ = det._preprocess(images)
    with torch.inference_mode():
        x = normalize_image(batch, cfg.MEAN_PIXEL)
        feats = model.backbone(x)
        fg, deltas = model.rpn_scores(feats)
        cand = pipeline.rpn_candidates(cfg, model.anchors(), fg, deltas)
        ones = torch.ones(cand.shape[:2], dtype=torch.bool, device=DEVICE)
        keep_k = kernels.nms(cand, ones, cfg.RPN_NMS_THRESHOLD)
        keep_p = nms.nms_mask(cand, ones, cfg.RPN_NMS_THRESHOLD)
        diff = int((keep_k != keep_p).sum())
        check(diff == 0, f"nms on the run's proposals: {diff} differ")
        proposals, _ = pipeline.rpn_refine_scores(cfg, model.anchors(), fg,
                                                  deltas)
        got = roi.multilevel_roi_align_impl(feats[:4], proposals,
                                            cfg.POOL_SIZE, cfg.IMAGE_SHAPE)
        want = roi.multilevel_roi_align(feats[:4], proposals, cfg.POOL_SIZE,
                                        cfg.IMAGE_SHAPE)
        ulps = bf16_ulps(got, want)
        err = float((got.float() - want.float()).abs().max())
        check(ulps <= 1.0, f"roi_align on the run's maps: {ulps} ulp")
    print(f"[5] run intermediates: nms keep identical ({int(keep_k.sum())} "
          f"of {keep_k.numel()} kept), roi_align max_abs_err {err:.3g} "
          f"({ulps:g} bf16 ulp)", flush=True)
    return err


def tiny_inputs(h: int = 128, w: int = 128):
    rng = np.random.RandomState(3)
    images = rng.randint(0, 256, (2, h, w, 3), dtype=np.uint8)
    windows = np.array([[0, 0, h, w], [16, 0, h - 16, w]], np.float32)
    return torch.from_numpy(images), torch.from_numpy(windows)


def tiny_config(fold: bool = False, quant: bool = False, **overrides):
    """The 128-px float32 config, every detection kept, with `overrides`
    (an inference protocol at tiny width)."""
    from maskrcnn_tpu_torch import TinyConfig
    return TinyConfig().replace(DETECTION_MIN_CONFIDENCE=0.0, FOLD_BN=fold,
                                QUANT_INT8=quant, **overrides)


def tiny_model(fold: bool, device, act_stats=None, **overrides):
    """The tiny config (`tiny_config`) with seeded weights (folded under
    FOLD_BN). With `act_stats` (calibration stats): QUANT_INT8, quantized
    with them."""
    from maskrcnn_tpu_torch.models.mask_rcnn import MaskRCNN
    from maskrcnn_tpu_torch.quant import prepare_quant_params
    cfg = tiny_config(fold, act_stats is not None, **overrides)
    model = MaskRCNN(cfg, device).init(torch.Generator().manual_seed(5))
    if act_stats is not None:
        model.set_quant(prepare_quant_params(model, model.float_state,
                                             act_stats=act_stats))
    return model


def tiny_act_stats(**overrides):
    """Calibration stats of the tiny int8 model, taken on the CPU: one
    dict for both sides of the int8 parity."""
    from maskrcnn_tpu_torch.models.mask_rcnn import MaskRCNN
    from maskrcnn_tpu_torch.quant import calibrate, default_calib_canvases
    cfg = tiny_config(quant=True, **overrides)
    model = MaskRCNN(cfg, "cpu").init(torch.Generator().manual_seed(5))
    return calibrate(model, model.float_state,
                     default_calib_canvases(cfg.IMAGE_SHAPE, n=2))


def tiny_parity_phase(fold: bool = False, tag: str = "5", act_stats=None,
                      what: str = "", **overrides):
    """Phase 5c (5e under FOLD_BN, 5g under QUANT_INT8 with one shared
    act_stats, 5i under an inference protocol's `overrides`): the port on
    the card against the port on the CPU, 128-px float32 config, TF32
    off; the bar of the CPU parity tests, and keypoints within 1e-3 px
    and 1e-4 in score where both have the detection."""
    from maskrcnn_tpu_torch.detection.pipeline import predict_step
    cpu = tiny_model(fold, "cpu", act_stats, **overrides)
    gpu = tiny_model(fold, DEVICE, act_stats, **overrides)
    images, windows = tiny_inputs(*cpu.config.IMAGE_SHAPE[:2])
    want = predict_step(cpu, images, windows)
    got = predict_step(gpu, images.to(DEVICE), windows.to(DEVICE))
    got = {k: v.cpu() for k, v in got.items()}
    total = equal = mism = nbytes = 0
    dscore = dkp = 0.0
    for i in range(2):
        found = {(int(got["class_ids"][i, s]),
                  tuple(got["boxes"][i, s].tolist())): s
                 for s in torch.nonzero(got["valid"][i]).flatten().tolist()}
        for s in torch.nonzero(want["valid"][i]).flatten().tolist():
            total += 1
            key = (int(want["class_ids"][i, s]),
                   tuple(want["boxes"][i, s].tolist()))
            if key in found:
                p = found[key]
                equal += 1
                dscore = max(dscore, abs(float(want["scores"][i, s])
                                         - float(got["scores"][i, p])))
                a, b = want["masks_packed"][i, s], got["masks_packed"][i, p]
                mism += int((a != b).sum())
                nbytes += a.numel()
                if "keypoints" in want and s < want["keypoints"].shape[1]:
                    d = (want["keypoints"][i, s]
                         - got["keypoints"][i, p]).abs()
                    dkp = max(dkp, float(d[:, :2].max()))
                    check(float(d[:, 2].max()) <= 1e-4,
                          f"tiny cuda vs cpu: keypoint scores {d[:, 2]}")
    share = equal / max(total, 1)
    check(total > 0 and share >= 0.9 and dscore <= 1e-4
          and mism <= 0.01 * max(nbytes, 1) and dkp <= 1e-3,
          f"tiny cuda vs cpu: share {share}, dscore {dscore}, "
          f"mask bytes {mism}/{nbytes}, keypoints {dkp} px")
    print(f"[{tag}] tiny f32{' FOLD_BN' if fold else ''}"
          f"{' QUANT_INT8' if act_stats else ''}{what} predict_step "
          f"cuda vs cpu: {total} valid, (class, box) equal {share:.4f}, max "
          f"|dscore| {dscore:.3g}, mask byte mismatch "
          f"{mism / max(nbytes, 1):.3g}"
          + (f", max |dkeypoint| {dkp:.3g} px" if "keypoints" in want
             else ""), flush=True)


def fold_parity_phase():
    """Phase 5e: the folded port against the unfolded port on the card,
    same seeded weights, at the bar of tests/test_fold.py (valid equal,
    scores within 1e-3, boxes within 0.51 px)."""
    from maskrcnn_tpu_torch.detection.pipeline import predict_step
    images, windows = (t.to(DEVICE) for t in tiny_inputs())
    base = predict_step(tiny_model(False, DEVICE), images, windows)
    fold = predict_step(tiny_model(True, DEVICE), images, windows)
    v = base["valid"]
    check(bool(torch.equal(v, fold["valid"])) and bool(v.any()),
          "folded vs unfolded: valid differs")
    ds = float((base["scores"][v] - fold["scores"][v]).abs().max())
    db = float((base["boxes"][v] - fold["boxes"][v]).abs().max())
    sv = base["scores"][v].abs()
    bv = base["boxes"][v].abs()
    check(bool(((base["scores"][v] - fold["scores"][v]).abs()
                <= 1e-3 + 1e-3 * sv).all())
          and bool(((base["boxes"][v] - fold["boxes"][v]).abs()
                    <= 0.51 + 1e-3 * bv).all()),
          f"folded vs unfolded: |dscore| {ds}, |dbox| {db}")
    print(f"[5e] tiny f32 folded vs unfolded on the card: {int(v.sum())} "
          f"valid, valid equal, max |dscore| {ds:.3g}, max |dbox| {db:.3g}",
          flush=True)


# COCO val image shapes (h, w): every side <= 640, so each is upsampled to
# the 800-px short side and decoded on the device (ORIG_MASK_CANVAS 640)
COCO_SHAPES = ((480, 640), (640, 480), (427, 640), (375, 500), (612, 612),
               (360, 640), (500, 333), (640, 640))
# above ORIG_MASK_CANVAS: resampled to 1024x768, decoded on the host
LARGE_SHAPE = (1000, 750)


def write_reference_pth(cfg, path):
    """A seeded float32 state (the model's init, drawn on the CPU) written
    with torch.save in the reference checkpoint's layout, with the
    `num_batches_tracked` entries a torch BatchNorm state carries. Returns
    the state as numpy arrays."""
    from maskrcnn_tpu_torch.models.mask_rcnn import MaskRCNN
    model = MaskRCNN(cfg.replace(COMPUTE_DTYPE="float32", FOLD_BN=False,
                                 QUANT_INT8=False), "cpu")
    state = model.init(torch.Generator().manual_seed(7)).state_dict()
    saved = dict(state)
    for k in state:
        if k.endswith(".running_mean"):
            saved[k[:-len("running_mean")] + "num_batches_tracked"] = \
                torch.tensor(0)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(saved, path)
    return {k: v.numpy() for k, v in state.items()}


def check_loaded_state(det, state, what):
    """The Detector's state equals the .pth's float32 state (folded under
    FOLD_BN) cast to each tensor's dtype, bit for bit."""
    from maskrcnn_tpu_torch.checkpoint.fold import fold_state_dict
    if det.config.FOLD_BN:
        state = fold_state_dict(state, det.config.BACKBONE)
    own = det.model.state_dict()
    check(set(own) == set(state), f"{what}: state keys differ")
    bad = [k for k, v in own.items()
           if not torch.equal(v.cpu(), torch.from_numpy(
               np.asarray(state[k])).to(v.dtype))]
    check(not bad, f"{what}: {len(bad)} tensors differ from the .pth, "
          f"e.g. {bad[:3]}")


class ImageDataset:
    """evaluate_coco's dataset surface over images held in memory: ids
    1..N, load_image, and the COCO category of a contiguous label."""

    def __init__(self, images):
        self.images = images
        self.ids = list(range(1, len(images) + 1))

    def load_image(self, image_id):
        return self.images[image_id - 1]

    @staticmethod
    def class_id(label_id):
        from maskrcnn_tpu_torch.data.coco import CocoLabel
        return CocoLabel.to_class(label_id)


def matchable(res):
    """A Detector result without the detections that no ground truth can
    match: an int32 box (as evaluate_coco casts it) with no area, or an
    empty mask. Random weights make such detections; their IoU with
    anything is 0. None when nothing is left."""
    if res is None:
        return None
    cls, scores, boxes, masks = res
    b = np.asarray(boxes).astype(np.int32)
    keep = np.flatnonzero((b[:, 2] > b[:, 0]) & (b[:, 3] > b[:, 1])
                          & masks.reshape(len(cls), -1).any(axis=1))
    if not keep.size:
        return None
    return ([cls[i] for i in keep], [scores[i] for i in keep],
            [boxes[i] for i in keep], masks[keep])


class MatchableDetector:
    """A Detector's dispatch_batch/fetch, with `matchable` results."""

    def __init__(self, det):
        self.det = det

    def dispatch_batch(self, images):
        return self.det.dispatch_batch(images)

    def fetch(self, handle):
        return [matchable(r) for r in self.det.fetch(handle)]


def coco_ground_truth(ds, results):
    """A COCO index whose annotations are the detections of `results`
    (one Detector result an image of `ds`, or None), built as
    evaluate_coco builds its results (boxes cast to int32 first), so a
    deterministic step scores AP 1 on them."""
    from maskrcnn_tpu_torch.data.coco import COCO_CLASS_IDS
    from maskrcnn_tpu_torch.eval import rle as rle_lib
    from maskrcnn_tpu_torch.eval.coco_index import COCO
    from maskrcnn_tpu_torch.eval.evaluate import build_coco_results
    anns, images = [], []
    for image_id, img, res in zip(ds.ids, ds.images, results):
        images.append({"id": image_id, "height": img.shape[0],
                       "width": img.shape[1]})
        if res is None:
            continue
        cls, scores, boxes, masks = res
        for r in build_coco_results(ds, image_id, cls, scores,
                                    np.asarray(boxes).astype(np.int32),
                                    np.asarray(masks, np.uint8)):
            r.update(id=len(anns) + 1, iscrowd=0,
                     area=rle_lib.area(r["segmentation"]))
            anns.append(r)
    return COCO({"images": images, "annotations": anns,
                 "categories": [{"id": c, "name": str(c)}
                                for c in COCO_CLASS_IDS[1:]]})


def device_resize_check(det, images, card):
    """Phase 5h, the DEVICE_RESIZE route: the canvases the Detector
    places on the card against `batched_resize_pad`'s plain run on the
    CPU: uint8 equal but where the float64 value of the CPU's matrices
    lies within 1e-4 of a .5 tie (the card's products sum in another
    order), each such value counted; the resample's device time."""
    from maskrcnn_tpu_torch.ops.image import batched_resize_pad, bucket_raws
    batch, windows, scales = det._preprocess(images)
    check(batch.is_cuda and all(s > 1.0 for s in scales),
          "DEVICE_RESIZE: the COCO-sized images go to the device route")
    raws, sizes = bucket_raws(images)
    hb, wb = raws.shape[1:3]
    win = torch.tensor(windows, dtype=torch.int32)
    sizes = torch.from_numpy(sizes)
    canvas = det.config.IMAGE_SHAPE[:2]
    want = batched_resize_pad(torch.from_numpy(raws), win, sizes, canvas)
    got = batch.cpu()
    apart = torch.nonzero(got != want).tolist()
    check(len(apart) <= 1e-4 * got.numel(), f"DEVICE_RESIZE: {len(apart)} "
          "canvas values apart")
    from maskrcnn_tpu_torch.ops.image import axis_resize_matrix
    f = win.to(torch.float32)
    vmat = axis_resize_matrix(canvas[0], hb, f[:, 0], sizes[:, 0],
                              f[:, 2] - f[:, 0]).double()
    hmat = axis_resize_matrix(canvas[1], wb, f[:, 1], sizes[:, 1],
                              f[:, 3] - f[:, 1]).double()
    rawd = torch.from_numpy(raws).double()
    worst = 0.0
    for b, y, x, c in apart:
        exact = float(vmat[b, y] @ rawd[b, :, :, c] @ hmat[b, x])
        worst = max(worst, abs(exact - np.floor(exact) - 0.5))
    check(worst < 1e-4, f"DEVICE_RESIZE: a value apart lies {worst} from "
          "a .5 tie")
    dev_args = (torch.from_numpy(raws).to(DEVICE), win.to(DEVICE),
                sizes.to(DEVICE), canvas)
    ms = cuda_ms(lambda: batched_resize_pad(*dev_args), iters=10)
    print(f"[5h] DEVICE_RESIZE canvases, card vs the CPU's plain run: "
          f"{len(apart)} of {got.numel()} values apart, each within "
          f"{worst:.3g} of a .5 tie; the resample of the {len(images)} "
          f"images ({hb}x{wb} bucket to {canvas[0]}x{canvas[1]}) "
          f"{ms:.4f} ms on the card; {card}", flush=True)


def host_runs(fn, reps: int = 3):
    """Host times of `reps` calls of fn(), in ms (the work ends on the
    host)."""
    runs = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        runs.append((time.perf_counter() - t0) * 1e3)
    return runs


def product_phase(kernels, card, cfg=None, shapes=COCO_SHAPES,
                  large=LARGE_SHAPE):
    """Phase 5h: the Detector's product surface under the default
    CocoInferenceConfig (ORIG_MASK_CANVAS 640). A seeded float32 state is
    written as a reference-layout .pth and loaded with load_weights into
    a default and a FOLD_BN Detector (states bit-equal to the file's);
    one request of eight COCO-sized images (resampled without Pillow,
    masks decoded on the device), the same through the FOLD_BN Detector,
    one request holding a larger image (host decode), and the eight again
    under DEVICE_MASK_DECODE=False (share of mask pixels apart between
    the decodes < 0.02). Ground truth built from the host-decode results
    with build_coco_results; evaluate_coco for bbox and segm must reach
    AP >= 0.95. The native RLE library must be in use and Pillow never
    imported. Then B=8 detect_batch end to end on both decode routes
    (median of 3) and the host resample, host decode and RLE per image.
    Returns the kernels' launches during the requests and evaluations."""
    from pathlib import Path
    from maskrcnn_tpu_torch import CocoInferenceConfig
    from maskrcnn_tpu_torch.api import Detector
    from maskrcnn_tpu_torch.data import codecs
    from maskrcnn_tpu_torch.eval import native
    from maskrcnn_tpu_torch.eval.evaluate import (build_coco_results,
                                                  evaluate_coco)
    cfg = cfg or CocoInferenceConfig()
    t0 = time.perf_counter()
    path = Path(__file__).resolve().parent / "build" / "phase5h_seeded.pth"
    state = write_reference_pth(cfg, path)

    def loaded(c):
        det = Detector(c, device=DEVICE)
        det.load_weights(str(path))
        return det

    det = loaded(cfg)
    fdet = loaded(cfg.replace(FOLD_BN=True))
    hdet = loaded(cfg.replace(DEVICE_MASK_DECODE=False))
    rdet = loaded(cfg.replace(DEVICE_RESIZE=True))
    for d, what in ((det, "default"), (fdet, "FOLD_BN")):
        check_loaded_state(d, state, f"load_weights {what}")
    mib = path.stat().st_size / 2**20
    path.unlink()
    print(f"[5h] seeded float32 state as a .pth ({mib:.1f} MiB), "
          f"load_weights into default, FOLD_BN, host-decode and "
          f"DEVICE_RESIZE Detectors {cfg_name(cfg)} in "
          f"{time.perf_counter() - t0:.1f} s: "
          f"default and FOLD_BN states bit-equal to the file's", flush=True)

    rng = np.random.RandomState(5)
    images = make_images(rng, list(shapes))
    big = make_images(rng, [large])[0]
    reset_counts(kernels)
    counts = {}

    def request(name, d, batch):
        before = launch_counts(kernels)
        handle = d.dispatch_batch(batch)
        route = "device" if handle[-1] else "host"
        results = d.fetch(handle)
        n = {k: v - before[k] for k, v in launch_counts(kernels).items()}
        blocks = 29 if d.config.FOLD_BN else 0
        check(n["roi_align"] == 2 and n["nms"] >= 2 and n["paste_pack"] >= 1
              and n["bottleneck"] == blocks, f"{name}: kernel launches {n}")
        for img, res in zip(batch, results):
            check(res is not None, f"{name}: an image has no detection")
            cls, scores, boxes, masks = res
            check(masks.shape == (len(cls),) + img.shape[:2]
                  and masks.dtype == np.uint8
                  and np.isfinite(boxes).all() and np.isfinite(scores).all()
                  and all(0 < c < cfg.NUM_CLASSES for c in cls),
                  f"{name}: decoded results")
        counts[name] = n
        print(f"[5h] {name}: {len(batch)} images, {route} mask decode, "
              f"detections {[len(r[0]) for r in results]}, launches "
              + " ".join(f"{k} {v}" for k, v in n.items()), flush=True)
        return route, results

    route, dev_res = request("coco-sized request", det, images)
    check(route == "device", "eight COCO-sized images: device decode")
    request("coco-sized request, FOLD_BN", fdet, images)
    route, _ = request(f"request with a {large[0]}x{large[1]} image", det,
                       images[:3] + [big])
    check(route == "host", "an image above ORIG_MASK_CANVAS: host decode")
    route, _ = request("coco-sized request, DEVICE_RESIZE", rdet, images)
    check(route == "device", "DEVICE_RESIZE: device decode")
    device_resize_check(rdet, images, card)
    route, host_res = request("coco-sized request, DEVICE_MASK_DECODE=False",
                              hdet, images)
    check(route == "host", "DEVICE_MASK_DECODE=False: host decode")
    apart = pixels = 0
    for a, b in zip(dev_res, host_res):
        check(a[0] == b[0] and a[2] == b[2], "device vs host decode: the "
              "detections differ")
        apart += int((a[3] != b[3]).sum())
        pixels += a[3].size
    share = apart / pixels
    check(share < 0.02, f"device vs host decode: {share} of pixels apart")
    print(f"[5h] device vs host mask decode on the eight images: same "
          f"detections, {share:.6f} of mask pixels apart ({apart} of "
          f"{pixels})", flush=True)

    # the self-check: ground truth from the host-decode results, then
    # evaluate_coco through the same Detector; detections no ground truth
    # can match are left out on both sides
    ds = ImageDataset(images)
    gt = coco_ground_truth(ds, [matchable(r) for r in host_res])
    dropped = sum(len(r[0]) for r in host_res) - len(gt.anns)
    check(len(gt.anns) >= len(images), f"only {len(gt.anns)} matchable "
          "detections")
    ap = {}
    t0 = time.perf_counter()
    for eval_type in ("bbox", "segm"):
        ap[eval_type] = float(evaluate_coco(MatchableDetector(hdet), ds, gt,
                                            eval_type, batch_size=8)[0])
    eval_s = time.perf_counter() - t0
    check(min(ap.values()) >= 0.95, f"evaluate_coco self-check: AP {ap}")
    check(native.available(), "the native RLE library is not in use")
    launches = launch_counts(kernels)
    print(f"[5h] evaluate_coco against ground truth from the host-decode "
          f"results ({len(gt.anns)} annotations; {dropped} detections with "
          f"an empty box or mask left out): AP@[.5:.95] bbox "
          f"{ap['bbox']:.4f}, segm {ap['segm']:.4f}; RLE route native; "
          f"{2 * len(images) / eval_s:.2f} img/s over both sweeps "
          f"({eval_s:.2f} s)", flush=True)

    # host work per image (medians of 3): resample to the window, decode
    # the canvas masks, RLE-encode the results
    b = len(images)
    resample = statistics.median(host_runs(lambda: [
        codecs.resample_bilinear(img, g[2] - g[0], g[3] - g[1])
        for img, g in zip(images, (det._canvas_geometry(
            h, w, cfg.IMAGE_MIN_DIM, *cfg.IMAGE_SHAPE[:2])[0]
            for h, w in shapes))]))
    out, _, windows, scales, _, _ = hdet.dispatch_batch(images)
    valid = out["valid"].cpu().numpy()
    packed = out["masks_packed"].cpu().numpy()
    canvas = [packed[i][valid[i]] for i in range(b)]
    n_masks = int(valid.sum())
    jobs = list(zip(canvas, scales, windows, images))

    def decode_one(job):
        m, s, w, img = job
        return codecs.decode_masks(m, s, w, img.shape[0], img.shape[1])

    decode = statistics.median(host_runs(lambda: list(map(decode_one,
                                                          jobs))))
    with ThreadPoolExecutor(max_workers=b) as pool:
        threaded = statistics.median(host_runs(
            lambda: list(pool.map(decode_one, jobs))))
    nonempty = sum(int(m.reshape(len(m), -1).any(axis=1).sum())
                   for m in canvas)  # anywhere on the canvas
    rle = statistics.median(host_runs(lambda: [
        build_coco_results(ds, i, r[0], r[1],
                           np.asarray(r[2]).astype(np.int32), r[3])
        for i, r in zip(ds.ids, host_res)]))
    print(f"[5h] host per image: resample {resample / b:.2f} ms, decode "
          f"{decode / b:.2f} ms in series, {threaded / b:.2f} ms over "
          f"{b} threads ({decode / max(n_masks, 1):.3f} ms a mask, "
          f"{n_masks} masks, {nonempty} nonempty), RLE encode {rle / b:.2f} ms; {card}", flush=True)
    for d, name in ((det, "device decode"), (hdet, "host decode"),
                    (rdet, "device resample and decode")):
        d.detect_batch(images)
        runs = []
        for _ in range(3):
            torch.cuda.synchronize()
            t = [time.perf_counter()]
            handle = d.dispatch_batch(images)
            t.append(time.perf_counter())
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            d.fetch(handle)
            t.append(time.perf_counter())
            runs.append([(t[i + 1] - t[i]) * 1e3 for i in range(3)])
        total = [sum(r) for r in runs]
        ms = statistics.median(total)
        split = [statistics.median(r[i] for r in runs) for i in range(3)]
        print(f"[5h] detect_batch B={b} COCO-sized, {name}: median {ms:.2f} "
              f"ms ({b * 1e3 / ms:.2f} img/s), runs "
              f"{[round(r, 2) for r in total]}; medians: dispatch_batch "
              f"(preprocess and enqueue) {split[0]:.2f} ms, then the card "
              f"{split[1]:.2f} ms, fetch {split[2]:.2f} ms; {card}",
              flush=True)
    check("PIL" not in sys.modules, "Pillow was imported")
    print("[5h] Pillow never imported", flush=True)
    return launches


def timing_phase(det, images, card, tag="6", reps: int = 5,
                 warmup: int = 2):
    """Phase 6: predict_step at B=8 and at B=1, the median of `reps`
    calls after `warmup` warm-ups, each timed by CUDA events around the
    call. One B=8 call first runs with synchronising calls turned into
    errors. Returns the canvases, windows and {B: median ms}."""
    from maskrcnn_tpu_torch.detection.pipeline import predict_step
    x, windows, _ = det._preprocess(images)
    win = torch.tensor(windows, dtype=torch.float32, device=DEVICE)
    medians = {}
    for b in (len(images), 1):
        torch.cuda.reset_peak_memory_stats()
        for _ in range(warmup):
            predict_step(det.model, x[:b], win[:b])
        torch.cuda.synchronize()
        if b > 1:
            # the step never waits on the card: a synchronising call raises
            torch.cuda.set_sync_debug_mode("error")
            try:
                predict_step(det.model, x, win)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
        runs = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            predict_step(det.model, x[:b], win[:b])
            end.record()
            torch.cuda.synchronize()
            runs.append(start.elapsed_time(end))
        ms = statistics.median(runs)
        medians[b] = ms
        print(f"[{tag}] predict_step B={b} {cfg_name(det.config)}: median {ms} "
              f"ms/batch ({b * 1000.0 / ms} img/s), runs {runs}, peak mem "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {card}",
              flush=True)
    return x, win, medians


# Phase 7: training. K1-bwd at the training step's shapes: B=4 images,
# N=100 RoIs an image (TRAIN_ROIS_PER_IMAGE), C=256
TRAIN_B, TRAIN_N = 4, 100


def roi_backward_bound(roi, shapes, boxes, pool, grad, dtype):
    """K1-bwd's bound on these inputs: grad_out read once, the four level
    gradients written once in the levels' dtype, the boxes (16 B each);
    four products and four adds a channel of every sample inside its
    level, in float32."""
    lvl, in_y, in_x = roi.level_geometry(shapes, boxes, pool, CANVAS)
    _, inside = roi._corners(shapes, lvl, in_y, in_x, boxes.shape[1])
    c = shapes[0][-1]
    size = torch.tensor([], dtype=dtype).element_size()
    nbytes = (grad.numel() * grad.element_size()
              + sum(int(np.prod(s)) for s in shapes) * size
              + boxes.numel() * 4)
    return bound(nbytes, float(inside.sum()) * c * 8.0, PEAK_F32)


def roi_backward_phase(kernels, roi):
    """Phase 7a: K1-bwd against its plain version (the float32 index_add_
    of ops.roi_align.roi_align_backward_levels) on seeded grad_out at the
    training shapes, the edge boxes and ten zero (padding) boxes an image,
    on the 1024² canvas (timed, both P) and the 768x1024 one. float32
    levels: max |d| <= 1e-5 of the largest |grad| a level; bf16 levels:
    within 1 bf16 ulp of the plain float32 sums rounded once, beside the
    float32 order slack (1e-6 of the level's largest |grad|): the atomics
    add in another order than index_add_. One launch a call."""
    gen = torch.Generator(device=DEVICE).manual_seed(7)
    rng = np.random.RandomState(7)
    worst, times = 0.0, {}
    for cfg in (slice_config(), rect_config()):
        canvas = cfg.IMAGE_SHAPE
        shapes = [(TRAIN_B, h, w, 256) for h, w in stage_shapes(cfg)]
        for pool in (7, 14):
            b = np.stack([edge_boxes(rng, TRAIN_N) for _ in range(TRAIN_B)])
            b[:, -10:] = 0.0
            boxes = torch.from_numpy(b).to(DEVICE)
            flat = boxes.reshape(-1, 4).contiguous()
            for dtype in (torch.float32, torch.bfloat16):
                grad = torch.randn(TRAIN_B * TRAIN_N, pool, pool, 256,
                                   generator=gen, device=DEVICE).to(dtype)
                before = kernels.roi_align_backward.launches
                got = kernels.roi_align_backward(grad, flat, shapes, dtype,
                                                 pool, canvas)
                check(kernels.roi_align_backward.launches == before + 1,
                      "roi_align_backward: one launch a call")
                want = roi.multilevel_roi_align_backward(
                    grad.reshape(TRAIN_B, TRAIN_N, pool, pool, 256),
                    shapes, torch.float32, boxes, pool, canvas)
                torch.cuda.synchronize()
                name = (f"{str(dtype)[6:]} {canvas[0]}x{canvas[1]} "
                        f"B={TRAIN_B} N={TRAIN_N} P={pool} C=256")
                errs, far = [], 0
                for g, w in zip(got, want):
                    scale = float(w.abs().max())
                    err = float((g.float() - w).abs().max())
                    errs.append(err)
                    if dtype == torch.float32:
                        check(err <= 1e-5 * scale,
                              f"roi_align_backward {name}: err {err} of "
                              f"{scale}")
                        worst = max(worst, err)
                        continue
                    rounded = w.to(torch.bfloat16).float()
                    _, exp = torch.frexp(rounded.abs())
                    ulp = torch.where(rounded == 0,
                                      torch.full_like(rounded, 2.0 ** -133),
                                      torch.ldexp(torch.ones_like(rounded),
                                                  exp - 8))
                    apart = (g.float() - rounded).abs()
                    far += int((apart > ulp).sum())
                    check(bool((apart <= ulp + 1e-6 * scale).all()),
                          f"roi_align_backward {name}: beyond 1 bf16 ulp")
                line = (f"max |d| a level {[f'{e:.3g}' for e in errs]}"
                        + (f", {far} values beyond 1 bf16 ulp (inside the "
                           "float32 order slack)" if dtype == torch.bfloat16
                           else ""))
                if canvas != CANVAS:
                    print(f"[7a] roi_align_backward {name}: {line}",
                          flush=True)
                    continue
                ms = cuda_ms(lambda: kernels.roi_align_backward(
                    grad, flat, shapes, dtype, pool, canvas))
                plain_ms = cuda_ms(lambda: roi.multilevel_roi_align_backward(
                    grad.reshape(TRAIN_B, TRAIN_N, pool, pool, 256), shapes,
                    dtype, boxes, pool, canvas), iters=3, warmup=1)
                bound_ms, bound_by = roi_backward_bound(roi, shapes, boxes,
                                                        pool, grad, dtype)
                times[(dtype, pool)] = (ms, plain_ms, bound_ms, bound_by)
                print(f"[7a] roi_align_backward {name}: {line}; {ms:.4f} ms "
                      f"on the card (bound {bound_ms:.4f} by {bound_by}, "
                      f"{bound_ms / ms:.1%} of it); plain {plain_ms:.4f} ms",
                      flush=True)
    return worst, times


def train_scene_config():
    """The 128-px float32 config in the samplers' deterministic regime
    (as tests/torch_port.train_config): every anchor in the RPN sample, 24
    proposals and 24 head slots an image, 3 of them positive."""
    from maskrcnn_tpu_torch import TinyConfig
    from maskrcnn_tpu_torch.ops.anchors import config_anchors
    cfg = TinyConfig().replace(RPN_NMS_MAX_ROIS_NUM=24,
                               TRAIN_ROIS_PER_IMAGE=24,
                               ROI_POSITIVE_RATIO=0.125)
    return cfg.replace(RPN_TRAIN_ANCHORS_PER_IMAGE=len(config_anchors(cfg)))


def train_scene_batch(model, b: int = 2):
    """Two canvases whose gt boxes are three proposals an image of the
    model's own RPN, none with another proposal at IoU 0.5 or more, so
    each image has exactly three positive proposals: no random subsample
    fires, and the card's and the CPU's samplers agree."""
    from maskrcnn_tpu_torch.detection.pipeline import rpn_refine
    from maskrcnn_tpu_torch.ops.boxes import box_iou
    from maskrcnn_tpu_torch.ops.image import normalize_image
    cfg = model.config
    h, w = cfg.IMAGE_SHAPE[:2]
    g = cfg.MAX_GT_INSTANCES
    rng = np.random.RandomState(11)
    images = rng.randint(0, 256, (b, h, w, 3), np.uint8)
    with torch.no_grad():
        feats = model.backbone(normalize_image(torch.from_numpy(images),
                                               cfg.MEAN_PIXEL))
        props, pvalid = rpn_refine(cfg, model.anchors(),
                                   *model.rpn_detect(feats)[1:])
    batch = {"images": images, "gt_class_ids": np.zeros((b, g), np.int32),
             "gt_boxes": np.zeros((b, g, 4), np.float32),
             "gt_masks": np.zeros((b, g, h, w), np.uint8),
             "gt_valid": np.zeros((b, g), bool)}
    for i in range(b):
        live = props[i, pvalid[i]]
        picked = [j for j in np.flatnonzero(pvalid[i].numpy())
                  if min(props[i, j, 2] - props[i, j, 0],
                         props[i, j, 3] - props[i, j, 1]) * h >= 2.0
                  and int((box_iou(props[i, j][None], live)[0] >= 0.5)
                          .sum()) == 1][:3]
        check(len(picked) == 3, "train scene: three isolated proposals")
        for k, j in enumerate(picked):
            px = props[i, j].numpy() * np.array([h, w, h, w], np.float32)
            batch["gt_boxes"][i, k] = px
            batch["gt_class_ids"][i, k] = rng.randint(1, cfg.NUM_CLASSES)
            batch["gt_valid"][i, k] = True
            y1, x1, y2, x2 = np.round(px).astype(int)
            batch["gt_masks"][i, k, y1:y2, x1:x2] = 1
    return batch


def train_parity_phase():
    """Phase 7b: one float32 training forward and gradient of the 128-px
    config on the card (K1 forward, K1-bwd backward, K2) against the same
    on the CPU (the plain versions), TF32 off, the same seeded weights
    and batch: the six losses within 1e-4 relative, the gradients of an
    FPN lateral conv (fpn.P2_conv1) and of a C2 conv within 1e-4 of their
    largest |g|: the FPN's gradient reaches it through K1-bwd."""
    from maskrcnn_tpu_torch.models.mask_rcnn import MaskRCNN
    from maskrcnn_tpu_torch.train.step import compute_losses
    from maskrcnn_tpu_torch.train.trainer import to_device
    cfg = train_scene_config()
    cpu = MaskRCNN(cfg, "cpu", train=True).init(
        torch.Generator().manual_seed(0))
    with torch.no_grad():
        # seeded weights give degenerate proposals at 128 px (deltas of
        # tens); smaller RPN deltas keep them near their anchors
        cpu.rpn.conv_bbox.weight.mul_(0.01)
    card = MaskRCNN(cfg, DEVICE, train=True)
    card.load_state_dict(cpu.state_dict())
    batch = train_scene_batch(cpu)
    names = ("fpn.P2_conv1.weight", "fpn.C2.0.conv1.weight")
    out = []
    for model in (cpu, card):
        dev = model.anchor_boxes.device
        gen = torch.Generator(device=dev).manual_seed(0)
        losses = compute_losses(model, gen, to_device(batch, dev))
        params = dict(model.named_parameters())
        grads = torch.autograd.grad(losses.total, [params[n] for n in names])
        out.append(({k: float(v) for k, v in losses.as_dict().items()},
                    [g.cpu() for g in grads]))
    (l_cpu, g_cpu), (l_card, g_card) = out
    check(l_cpu["mrn_class"] > 0 and l_cpu["mrn_mask"] > 0,
          f"train parity: the head has positives {l_cpu}")
    for k, v in l_cpu.items():
        check(abs(l_card[k] - v) <= 1e-4 * abs(v) + 1e-7,
              f"train parity: loss {k} card {l_card[k]} cpu {v}")
    gaps = []
    for n, a, b in zip(names, g_card, g_cpu):
        scale = float(b.abs().max())
        gap = float((a - b).abs().max())
        check(scale > 0 and gap <= 1e-4 * scale,
              f"train parity: {n} gradient {gap} of {scale}")
        gaps.append(gap / scale)
    rel = max(abs(l_card[k] - v) / max(abs(v), 1e-30) for k, v in l_cpu.items())
    print(f"[7b] tiny float32 training step, card against CPU: losses within "
          f"{rel:.3g} relative {l_card}; gradients of {names[0]} and "
          f"{names[1]} within {gaps[0]:.3g} and {gaps[1]:.3g} of their "
          "max", flush=True)


def train_config_full():
    """CocoConfig as the JAX package trains it: ResNet-101 FPN, 81 classes,
    bf16, the 1024² canvas, 100 training RoIs an image, REMAT_BACKBONE as
    configured."""
    from maskrcnn_tpu_torch import CocoConfig
    return CocoConfig()


class StepClock:
    """A batch iterator that records a CUDA event at every draw: the
    device time between draws is the time a step takes on the card's
    timeline (idle included) once the trainer runs ahead."""

    def __init__(self, batch):
        self.batch = batch
        self.events = []

    def __iter__(self):
        return self

    def __next__(self):
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        self.events.append(event)
        return self.batch

    def step_ms(self):
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in
                zip(self.events, self.events[1:])]


def synthetic_batch(cfg, b):
    """SyntheticLoader's batch with the masks bit-packed, as BatchLoader
    ships them."""
    from maskrcnn_tpu_torch.data.pipeline import SyntheticLoader
    from maskrcnn_tpu_torch.ops.bits import pack_masks
    batch = dict(next(SyntheticLoader(cfg, b)))
    batch["gt_masks_packed"] = pack_masks(batch.pop("gt_masks"))
    return batch


def train_phase(kernels, card):
    """Phase 7c: the training slice at full width through Trainer.fit
    (layers "all"): 10 steps at B=1 and at B=4 of SyntheticLoader batches
    on seeded weights, the median ms a step after 2 warm-ups (the card's
    timeline between steps), img/s, peak memory and the loss trajectory;
    every loss finite and the step count 10; K1, K1-bwd and K2 launches a
    step 2 / 2 / 1; one train_step in sync-debug "error" mode; then 3
    steps under layers "heads": every ResNet weight (C1-C5) bit-identical,
    the RPN's, FPN P layers' and box head's weights moved. Returns a
    function that runs one more B=4 step (for --profile)."""
    from maskrcnn_tpu_torch.models.mask_rcnn import MaskRCNN
    from maskrcnn_tpu_torch.train.step import make_optimizer, train_step
    from maskrcnn_tpu_torch.train.trainer import (LAYER_REGEX, Trainer,
                                                  to_device, trainable_mask)
    cfg = train_config_full()
    t0 = time.perf_counter()
    model = MaskRCNN(cfg, DEVICE, train=True).init(
        torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    print(f"[7c] training MaskRCNN {cfg_name(cfg)}, REMAT_BACKBONE "
          f"{cfg.REMAT_BACKBONE}, float32 weights, seeded init "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    reset_counts(kernels)
    steps = 10
    for b in (1, 4):
        clock = StepClock(synthetic_batch(cfg, b))
        trainer = Trainer(model, log_every=steps)
        before = launch_counts(kernels)
        torch.cuda.reset_peak_memory_stats()
        trainer.fit(clock, cfg.LEARNING_RATE, 1, "all", gen,
                    steps_per_epoch=steps)
        ms_steps = clock.step_ms()
        n = {k: v - before[k] for k, v in launch_counts(kernels).items()}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        traj = [round(r["total"], 4) for r in trainer.step_history]
        check(all(np.isfinite(v) for r in trainer.step_history
                  for v in r.values()), f"B={b}: a loss is not finite")
        check(int(trainer.optimizer.step) == steps,
              f"B={b}: step count {int(trainer.optimizer.step)}")
        want = {"roi_align": 2 * steps, "roi_align_backward": 2 * steps,
                "nms": steps}
        check(all(n[k] == v for k, v in want.items()),
              f"B={b}: launches {n}, want {want}")
        ms = statistics.median(ms_steps[2:])
        print(f"[7c] train step B={b}: median {ms} ms/step ({b * 1000.0 / ms}"
              f" img/s), steps 3-10 {ms_steps[2:]}, peak mem {peak:.2f} GiB, "
              f"total loss {traj}; launches a step K1 "
              f"{n['roi_align'] / steps:g} K1-bwd "
              f"{n['roi_align_backward'] / steps:g} K2 {n['nms'] / steps:g}; "
              f"{card}", flush=True)

    # one step in sync-debug mode: the step never waits on the card
    batch = to_device(synthetic_batch(cfg, 4), DEVICE)
    params = [p for p in model.parameters() if p.requires_grad]
    opt = make_optimizer(cfg, cfg.LEARNING_RATE, params,
                         [True] * len(params))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        metrics = train_step(model, opt, batch, gen)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    check(bool(torch.isfinite(metrics["total"])), "sync-debug step loss")
    print("[7c] one B=4 train_step in sync-debug mode: no host sync",
          flush=True)

    def step_b4():
        train_step(model, opt, batch, gen)

    # layers "heads": the ResNet stays bit-identical
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    trainer = Trainer(model, log_every=steps)
    trainer.fit(itertools.repeat(synthetic_batch(cfg, 1)),
                cfg.LEARNING_RATE, 1, "heads", gen, steps_per_epoch=3)
    torch.cuda.synchronize()
    mask = trainable_mask(model, LAYER_REGEX["heads"])
    after = dict(model.named_parameters())
    frozen = [k for k in before if k.startswith(("fpn.C1", "fpn.C2",
                                                 "fpn.C3", "fpn.C4",
                                                 "fpn.C5"))]
    check(all(torch.equal(before[k], after[k]) for k in frozen),
          "heads: a ResNet weight moved")
    moved = [k for k in ("rpn.conv_shared.weight", "fpn.P2_conv1.weight",
                         "fpn.P5_conv2.1.weight", "classifier.conv1.weight",
                         "classifier.linear_class.weight")
             if not torch.equal(before[k], after[k])]
    check(len(moved) == 5 and all(mask[k] for k in moved),
          f"heads: moved {moved}")
    print(f"[7c] layers heads, 3 steps: {len(frozen)} ResNet tensors "
          f"bit-identical; moved {moved}", flush=True)
    for p in model.parameters():
        p.requires_grad_(True)
    return step_b4


# Phase 5i: the README's serving presets and the other inference
# protocols at full width: (name, overrides, the tiny parity's overrides,
# K1 and K2 launches of one step)
PROTOCOLS = (
    ("box quality: cascade + soft-NMS",
     dict(CASCADE_STAGES=(0.5, 0.6, 0.7), DETECTION_SOFT_NMS_SIGMA=0.5),
     dict(CASCADE_STAGES=(0.5, 0.6, 0.7), DETECTION_SOFT_NMS_SIGMA=0.5),
     4, 1),
    ("mask quality: TTA + soft-NMS",
     dict(TTA_HFLIP=True, DETECTION_SOFT_NMS_SIGMA=0.5),
     dict(TTA_HFLIP=True, DETECTION_SOFT_NMS_SIGMA=0.5), 3, 2),
    ("TTA, hard NMS", dict(TTA_HFLIP=True), dict(TTA_HFLIP=True), 3, 5),
    ("keypoints", dict(NUM_KEYPOINTS=17),
     dict(NUM_KEYPOINTS=4, KEYPOINT_HEAD_CONVS=2, KEYPOINT_HEAD_DIM=32),
     2, 2),
    ("768x1024 canvas, FOLD_BN", dict(IMAGE_CANVAS=RECT_CANVAS, FOLD_BN=True),
     dict(IMAGE_CANVAS=(128, 192), FOLD_BN=True), 2, 2),
    ("max throughput: 768x1024 canvas, QUANT_INT8",
     dict(IMAGE_CANVAS=RECT_CANVAS, QUANT_INT8=True),
     dict(IMAGE_CANVAS=(128, 192), QUANT_INT8=True), 2, 2),
)


def request_shapes(cfg, rng):
    """Eight image shapes that land on the canvas at scale 1 (no
    resample): on the square canvas min side >= IMAGE_MIN_DIM; on a
    rectangular one, images as tall or as wide as the canvas."""
    ch, cw = cfg.IMAGE_SHAPE[:2]
    if ch == cw:
        lo, hi = cfg.IMAGE_MIN_DIM, ch
        return [(lo, hi), (hi, hi)] + [
            tuple(int(v) for v in rng.randint(lo // 16, hi // 16 + 1, 2) * 16)
            for _ in range(6)]
    return [(ch, cw), (ch, cw - cw // 8), (ch - ch // 12, cw),
            (ch - ch // 3, cw), (ch, cw - 3 * cw // 8), (ch - ch // 6, cw),
            (ch, cw - cw // 4), (ch - 5 * ch // 12, cw)]


class NmsCalls:
    """Records every class-offset NMS call the pipeline makes (its
    score-sorted boxes, classes and valid rows), for the kernel's check
    against the plain version on the inputs the callers give it."""

    def __init__(self, pipeline):
        self.pipeline, self.calls = pipeline, []
        self.inner = pipeline.multiclass_nms_mask

    def __enter__(self):
        def record(boxes, class_ids, valid, thr, coord_span):
            self.calls.append((boxes, class_ids, valid, thr, coord_span))
            return self.inner(boxes, class_ids, valid, thr, coord_span)
        self.pipeline.multiclass_nms_mask = record
        return self

    def __exit__(self, *exc):
        self.pipeline.multiclass_nms_mask = self.inner


def soft_nms_cost(nms, card):
    """Phase 5i: soft-NMS (plain PyTorch on every device) at the refine's
    shape (B=8, N=500 score-sorted rows, D=50 steps) and the TTA merge's
    (N=100): the PyTorch ops that compute a call (views aside; on the
    card each is a launch, but for an op on a CPU scalar), its time on
    the card queued, and as a caller issues it (host cost included)."""
    gen = torch.Generator().manual_seed(4)
    for n in (500, 100):
        ctr = torch.rand(8, n, 2, generator=gen) * 900
        size = torch.rand(8, n, 2, generator=gen) * 200 + 8
        boxes = torch.cat([ctr, ctr + size], -1).to(DEVICE)
        scores = torch.sort(torch.rand(8, n, generator=gen), descending=True,
                            dim=-1).values.to(DEVICE)
        valid = (torch.rand(8, n, generator=gen) > 0.3).to(DEVICE)

        def call():
            return nms.soft_nms_scores(boxes, scores, valid, 0.5, 50)
        with op_log() as ops:
            call()
        queued, issued = cuda_ms(call, iters=10), cuda_ms(call, iters=10,
                                                          queued=False)
        print(f"[5i] soft-NMS B=8 N={n}, 50 steps: {len(ops.computed)} "
              f"PyTorch ops a call, {queued:.4f} ms on the card queued, "
              f"{issued:.4f} ms as issued; {card}", flush=True)


def protocols_phase(kernels, nms, card, base_ms):
    """Phase 5i: each of PROTOCOLS through a Detector at full width
    (CocoInferenceConfig: ResNet-101, 81 classes, bf16, seeded weights):
    three requests (8, 8 and 1 images at scale 1), with checks of every
    result (keypoints: the fifth element, finite, [n, 17, 3] float64);
    the kernels' launches of one B=8 step against the expected (K1 once a
    cascade stage and once a TTA pass, plus the mask head's; K2 for each
    RPN, hard detection and hard merge NMS; K3 29 times under FOLD_BN; K4
    once); under hard TTA every class-offset NMS call of the step (the
    merge's at N = 2D) through the kernel and the plain version, keep
    masks identical; one step in sync-debug "error" mode; B=8 and B=1
    step medians (of 3) beside the default's (`base_ms`); the port on the
    card against the port on the CPU at tiny width. Returns the launches
    of the requests and steps."""
    from maskrcnn_tpu_torch.api import Detector
    from maskrcnn_tpu_torch.detection import pipeline
    from maskrcnn_tpu_torch.quant import default_calib_canvases
    soft_nms_cost(nms, card)
    total = {}
    for name, overrides, tiny, k1, k2 in PROTOCOLS:
        cfg = slice_config().replace(**overrides)
        t0 = time.perf_counter()
        calib = (default_calib_canvases(cfg.IMAGE_SHAPE, n=2)
                 if cfg.QUANT_INT8 else None)
        det = Detector(cfg, device=DEVICE,
                       generator=torch.Generator().manual_seed(0),
                       calib_images=calib)
        det.prepare()
        torch.cuda.synchronize()
        print(f"[5i] {name}: Detector {cfg_name(cfg)}, seeded init"
              f"{' and calibration' if cfg.QUANT_INT8 else ''} "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        rng = np.random.RandomState(2)
        shapes = request_shapes(cfg, rng)
        requests = [make_images(rng, shapes), make_images(rng, shapes[::-1]),
                    make_images(rng, shapes[2:3])]
        reset_counts(kernels)
        for r, images in enumerate(requests):
            results = det.detect_batch(images)
            per_image = []
            for img, res in zip(images, results):
                check(res is not None, f"{name} request {r}: an image has "
                      "no detection")
                check(len(res) == (5 if cfg.NUM_KEYPOINTS else 4),
                      f"{name} request {r}: result tuple")
                cls, scores, boxes, masks = res[:4]
                check(len(cls) >= 1 and masks.shape == (len(cls),)
                      + img.shape[:2] and np.isfinite(boxes).all()
                      and np.isfinite(scores).all()
                      and all(0 < c < cfg.NUM_CLASSES for c in cls),
                      f"{name} request {r}: decoded results")
                if cfg.NUM_KEYPOINTS:
                    kp = res[4]
                    check(kp.shape == (len(cls), cfg.NUM_KEYPOINTS, 3)
                          and kp.dtype == np.float64
                          and np.isfinite(kp).all(),
                          f"{name} request {r}: keypoints {kp.shape}")
                per_image.append(len(cls))
            print(f"[5i] {name}: request {r}, {len(images)} images, "
                  f"detections {per_image}", flush=True)

        x, windows, _ = det._preprocess(requests[0])
        win = torch.tensor(windows, dtype=torch.float32, device=DEVICE)
        before = launch_counts(kernels)
        with NmsCalls(pipeline) as rec:
            out = pipeline.predict_step(det.model, x, win)
        step = {k: v - before[k] for k, v in launch_counts(kernels).items()}
        gemms = len(det.model.quant["convs"]) + 4 if cfg.QUANT_INT8 else 0
        want = {"roi_align": k1, "nms": k2,
                "bottleneck": 29 if cfg.FOLD_BN else 0, "paste_pack": 1,
                "roi_align_int8": k1 if cfg.QUANT_INT8 else 0,
                "int8_gemm": gemms, "group_roi": 0, "roi_align_backward": 0}
        check(step == want, f"{name}: launches of one step {step}, want "
              f"{want}")
        d = cfg.DETECTION_MAX_INSTANCES
        check(tuple(out["boxes"].shape) == (8, d, 4)
              and bool(torch.isfinite(out["scores"]).all()),
              f"{name}: step outputs")
        if cfg.NUM_KEYPOINTS:
            n = min(cfg.KEYPOINT_MAX_INSTANCES or d, d)
            check(tuple(out["keypoints"].shape)
                  == (8, n, cfg.NUM_KEYPOINTS, 3)
                  and bool(torch.isfinite(out["keypoints"]).all()),
                  f"{name}: keypoints {tuple(out['keypoints'].shape)}")
        print(f"[5i] {name}: launches of one B=8 step "
              + " ".join(f"{k} {v}" for k, v in step.items()), flush=True)
        _, _, ms = timing_phase(det, requests[0], card, tag="5i", reps=3,
                                warmup=1)
        print(f"[5i] {name}: B=8 {ms[8]:.3f} ms ({ms[8] / base_ms[8]:.3f}x "
              f"the default's {base_ms[8]:.3f}), B=1 {ms[1]:.3f} ms "
              f"({ms[1] / base_ms[1]:.3f}x the default's {base_ms[1]:.3f}); "
              f"{card}", flush=True)
        # the main path's launches end here: the checks below compare
        for k, v in launch_counts(kernels).items():
            total[k] = total.get(k, 0) + v
        merged = ""
        for boxes, class_ids, valid, thr, span in rec.calls:
            offset = class_ids.to(boxes.dtype)[..., None] * (span + 2.0)
            ob = (boxes + offset).contiguous()
            keep_k = kernels.nms(ob, valid.contiguous(), thr)
            keep_p = nms.nms_mask(ob, valid, thr)
            diff = int((keep_k != keep_p).sum())
            check(diff == 0, f"{name}: class-offset NMS at N="
                  f"{boxes.shape[1]}: {diff} keep bits differ")
            merged += (f" N={boxes.shape[1]} ({int(keep_k.sum())} of "
                       f"{int(valid.sum())} kept)")
        if merged:
            print(f"[5i] {name}: class-offset NMS of the step, kernel vs "
                  f"plain, keep masks identical:{merged}", flush=True)
        tiny = {k: v for k, v in tiny.items() if k not in ("FOLD_BN",
                                                          "QUANT_INT8")}
        act_stats = tiny_act_stats(**tiny) if cfg.QUANT_INT8 else None
        tiny_parity_phase(fold=cfg.FOLD_BN, tag="5i", act_stats=act_stats,
                          what=f" {name}", **tiny)
        del det, x, out, rec
        torch.cuda.empty_cache()
    return total


def profile_phase(run, label, out_dir, name):
    """--profile: one step, `run()`, under torch.profiler. Writes the
    table by op and the Chrome trace, and prints the device's busy time
    over the step's kernel window (the profiler's own host cost widens
    the window, so the idle share is an upper bound)."""
    import os
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(out_dir, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    table = prof.key_averages().table(sort_by="cuda_time_total",
                                      row_limit=40)
    with open(os.path.join(out_dir, f"{name}_profile.txt"), "w") as f:
        f.write(table)
    trace = os.path.join(out_dir, f"{name}_trace.json")
    prof.export_chrome_trace(trace)
    with open(trace) as f:
        spans = sorted((e["ts"], e["ts"] + e["dur"])
                       for e in json.load(f)["traceEvents"]
                       if e.get("cat") == "kernel")
    busy, cur_start, cur_end = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_end:
            busy += cur_end - cur_start
            cur_start, cur_end = s, e
        else:
            cur_end = max(cur_end, e)
    busy += cur_end - cur_start
    window = max(e for _, e in spans) - spans[0][0]
    print(f"[profile] {label}: {len(spans)} kernels, "
          f"device busy "
          f"{busy / 1e3:.3f} of {window / 1e3:.3f} ms "
          f"({1 - busy / window:.1%} idle); table and trace in {out_dir}",
          flush=True)


# ---------------------------------------------------------------------
# phase 8: the server, RetinaNet, data parallelism, export, the profiler
# ---------------------------------------------------------------------

def _spans(events, pred):
    """Merged [start, end) microsecond spans of the trace events that
    `pred` takes."""
    spans = sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in events
                   if pred(e))
    merged = []
    for s, e in spans:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _overlap_us(a, b):
    """Microseconds where the merged spans `a` and `b` both run."""
    total, j = 0.0, 0
    for s, e in a:
        for s2, e2 in b:
            total += max(0.0, min(e, e2) - max(s, s2))
    return total


class RecordingDetector:
    """A Detector's dispatch_batch/fetch that records every batch it is
    given (phase 8a repeats them through detect_batch)."""

    def __init__(self, det):
        self.det = det
        self.config = det.config
        self.batches = []

    def dispatch_batch(self, images):
        self.batches.append(list(images))
        return self.det.dispatch_batch(images)

    def fetch(self, handle):
        return self.det.fetch(handle)


def server_phase(det, kernels, card, n_images=32, threads=8, max_batch=8):
    """Phase 8a: BatchingDetector(max_batch=8) over the default Detector;
    eight threads submit 32 COCO-sized images, four each, all at once,
    then wait for their results (a closed loop of one request a thread
    would leave one batch in flight and nothing to overlap).
    Every result equals detect_batch's on the batch the server ran (the
    same padded images): class ids and boxes equal, mask pixels apart
    under 0.02 (5h's metrics). img/s over the run and p50/p99 latency a
    request. Then a traced run of 32 canvas-sized images (scale 1: no
    host resample, so the card and not the host sets the pace): the copy
    stream's device-to-host copies against the kernels."""
    from maskrcnn_tpu_torch.serving import BatchingDetector
    from maskrcnn_tpu_torch.utils.profiler import trace
    rng = np.random.RandomState(8)
    images = make_images(rng, [COCO_SHAPES[i % len(COCO_SHAPES)]
                               for i in range(n_images)])
    det.detect_batch(images[:max_batch])          # warm the B=8 step

    def serve(rec, images=images):
        server = BatchingDetector(rec, max_batch=max_batch,
                                  max_delay_ms=20.0)
        lat = [None] * n_images

        def client(t):
            mine = range(t, n_images, threads)
            sent = {i: (time.perf_counter(), server.submit(images[i]))
                    for i in mine}
            for i, (s, fut) in sent.items():
                results[i] = fut.result(timeout=600)
                lat[i] = (time.perf_counter() - s) * 1e3
        results = [None] * n_images
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=threads) as pool:
            list(pool.map(client, range(threads)))
        wall = time.perf_counter() - t0
        server.close()
        return results, lat, wall, server
    before = launch_counts(kernels)
    rec = RecordingDetector(det)
    results, lat, wall, server = serve(rec)
    launches = {k: v - before[k] for k, v in launch_counts(kernels).items()}
    check(server.images_run == n_images, "8a: every request answered")
    check(all(launches[k] >= len(rec.batches) for k in
              ("roi_align", "nms", "paste_pack")),
          f"8a: the server's batches launched K1, K2 and K4: {launches}")
    # the batches again through detect_batch
    ids = {id(img): i for i, img in enumerate(images)}
    apart = pixels = 0
    for batch in rec.batches:
        want = det.detect_batch(batch)
        for img, w in zip(batch[:len(set(map(id, batch)))], want):
            got = results[ids[id(img)]]
            check(got[0] is not None and w is not None
                  and got[0] == w[0] and got[2] == w[2],
                  "8a: a server result differs from detect_batch's")
            apart += int((got[3] != w[3]).sum())
            pixels += got[3].size
    share = apart / max(pixels, 1)
    check(share < 0.02, f"8a: {share} of mask pixels apart")
    sizes = [len(b) for b in rec.batches]
    lat.sort()
    print(f"[8a] BatchingDetector(max_batch={max_batch}) "
          f"{cfg_name(det.config)}"
          f": {threads} threads, {n_images} COCO-sized requests in "
          f"{len(sizes)} batches {sizes}; results equal detect_batch's on "
          f"the same batches ({share:.6f} of mask pixels apart); "
          f"{n_images / wall:.2f} img/s, latency p50 "
          f"{statistics.median(lat):.1f} ms p99 "
          f"{lat[min(n_images - 1, int(0.99 * n_images))]:.1f} ms; launches "
          + " ".join(f"{k} {launches[k]}" for k in ("roi_align", "nms",
                                                    "paste_pack"))
          + f"; {card}", flush=True)
    # the overlap, from a trace of canvas-sized requests
    out_dir = "build/phase8"
    canvases = make_images(rng, [(1024, 1024)] * n_images)
    det.detect_batch(canvases[:max_batch])
    t0 = time.perf_counter()
    serve(RecordingDetector(det), canvases)
    canvas_rate = n_images / (time.perf_counter() - t0)
    with trace(out_dir, "server") as prof:
        serve(RecordingDetector(det), canvases)
    with open(f"{out_dir}/server.json") as f:
        events = json.load(f)["traceEvents"]
    d2h = [e for e in events if e.get("cat") == "gpu_memcpy"
           and "DtoH" in e.get("name", "")]
    kernels_ev = [e for e in events if e.get("cat") == "kernel"]
    if not d2h or not kernels_ev:
        print(f"[8a] stream overlap: not measured (the trace holds "
              f"{len(d2h)} device-to-host copies and {len(kernels_ev)} "
              "kernels)", flush=True)
        return launches
    streams = sorted({e["args"].get("stream") for e in d2h})
    kernel_streams = sorted({e["args"].get("stream") for e in kernels_ev})
    copies = _spans(d2h, lambda e: True)
    compute = _spans(kernels_ev, lambda e: True)
    copy_us = sum(e - s for s, e in copies)
    both = _overlap_us(copies, compute)
    print(f"[8a] {n_images} requests of 1024x1024 images (scale 1, no "
          f"host resample): {canvas_rate:.2f} img/s; stream overlap "
          f"(torch.profiler trace of them, {out_dir}/server.json): "
          f"{len(d2h)} device-to-host "
          f"copies on stream(s) {streams}, kernels on stream(s) "
          f"{kernel_streams}; {copy_us / 1e3:.3f} ms of copies, "
          f"{both / 1e3:.3f} ms of them ({both / max(copy_us, 1e-9):.1%}) "
          f"while a kernel ran; {card}", flush=True)
    return launches


def retina_phase(kernels, nms, card, base=None):
    """Phase 8b: RetinaNet (CocoInferenceConfig: 1024², 81 classes, bf16)
    with seeded weights, default and QUANT_INT8 (calibrated on two
    default canvases): detect at B=8 and B=1. Every class-offset K2 call
    (N = 2 x PRE_NMS_LIMIT = 1,000 boxes an image) is held against the
    plain version on the same boxes: keep masks identical. K2's
    launches, its time at B=8 N=1,000 beside its bounds, and the B=8 and
    B=1 detect medians of each configuration."""
    from maskrcnn_tpu_torch import CocoInferenceConfig
    from maskrcnn_tpu_torch.models import retina_fpn
    from maskrcnn_tpu_torch.ops.image import normalize_image
    from maskrcnn_tpu_torch.quant import default_calib_canvases
    base = base or CocoInferenceConfig()
    d = base.IMAGE_MAX_DIM
    k = min(2 * base.PRE_NMS_LIMIT, len(retina_fpn.retina_anchors(base)))
    calls = []
    real = retina_fpn.multiclass_nms_mask

    def held(boxes, class_ids, valid, thr, coord_span):
        before = kernels.nms.launches
        keep = real(boxes, class_ids, valid, thr, coord_span)
        offset = class_ids.to(boxes.dtype)[..., None] * (coord_span + 2.0)
        want = nms.nms_mask(boxes + offset, valid, thr)
        calls.append((int((keep != want).sum()), tuple(boxes.shape),
                      kernels.nms.launches - before,
                      (boxes + offset, valid, thr)))
        return keep
    rng = np.random.RandomState(12)
    raw = torch.from_numpy(rng.randint(0, 256, (8, d, d, 3),
                                       dtype=np.uint8)).to(DEVICE)
    x = normalize_image(raw, base.MEAN_PIXEL)
    times, launches = {}, 0
    for quant in (False, True):
        cfg = base.replace(QUANT_INT8=quant)
        net = retina_fpn.RetinaNet(cfg, DEVICE).init(
            torch.Generator().manual_seed(0))
        if quant:
            t0 = time.perf_counter()
            net.prepare(default_calib_canvases(cfg.IMAGE_SHAPE, n=2))
            print(f"[8b] RetinaNet QUANT_INT8 calibrated on two canvases "
                  f"in {time.perf_counter() - t0:.1f} s", flush=True)
        calls.clear()
        before = kernels.nms.launches
        retina_fpn.multiclass_nms_mask = held
        try:
            out = net.detect(x)
        finally:
            retina_fpn.multiclass_nms_mask = real
        torch.cuda.synchronize()
        launches += kernels.nms.launches - before
        check(len(calls) == 1 and calls[0][1] == (8, k, 4)
              and calls[0][2] == 1 and calls[0][0] == 0,
              f"8b: K2 calls {[c[:3] for c in calls]}")
        valid = out["valid"]
        check(bool(valid.any()) and bool(torch.isfinite(
            out["boxes"]).all()) and int(valid.sum(1).min()) > 0,
            "8b: detections")
        name = "QUANT_INT8" if quant else "default"
        # the detect never waits on the card
        torch.cuda.set_sync_debug_mode("error")
        try:
            net.detect(x)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        for b in (8, 1):
            times[(name, b)] = statistics.median(
                cuda_ms(lambda: net.detect(x[:b]), iters=3, warmup=1,
                        queued=False) for _ in range(3))
        print(f"[8b] RetinaNet {name}: B=8 detect, {int(valid.sum())} "
              f"detections, one class-offset K2 call at B=8 N={k} "
              f"(keep mask identical to the plain version's, "
              f"{int(calls[0][3][1].sum())} valid boxes), no host sync "
              f"in a detect; detect B=8 {times[(name, 8)]:.2f} ms, B=1 "
              f"{times[(name, 1)]:.2f} ms (CUDA events around issued "
              f"calls, median of 3); {card}", flush=True)
        del net
    # K2 at the RetinaNet shape, as phase 4 times it
    bx, vt, thr = calls[0][3]
    bx = bx.contiguous()
    ms = cuda_ms(lambda: kernels.nms(bx, vt, thr))
    plain_ms = cuda_ms(lambda: nms.nms_mask(bx, vt, thr), iters=3, warmup=1)
    b, n = vt.shape
    bound_ms, bound_by = bound(bx.numel() * 4 + vt.numel() * 2,
                               b * n * (n - 1) / 2 * 12.0, PEAK_F32)
    _, step_ns = nms_chain_step(kernels)
    chain_ms = n * step_ns * 1e-6
    print(f"[8b] K2 at RetinaNet's B=8 N={n} class-offset boxes (thr "
          f"{thr}): kernel {ms:.4f} ms, bound {bound_ms:.6f} ms by "
          f"{bound_by}, chain bound {chain_ms:.6f} ms ({n} steps), plain "
          f"{plain_ms:.4f} ms; launches on the RetinaNet path {launches}; "
          f"{card}", flush=True)
    return launches, (ms, plain_ms, bound_ms, bound_by, chain_ms)


def _dp_scene(b: int = 2):
    """Phase 7b's 128-px float32 scene: seeded weights (RPN deltas scaled
    as 7b scales them) and `b` images, as (state, batch)."""
    from maskrcnn_tpu_torch.models.mask_rcnn import MaskRCNN
    cfg = train_scene_config()
    cpu = MaskRCNN(cfg, "cpu", train=True).init(
        torch.Generator().manual_seed(0))
    with torch.no_grad():
        cpu.rpn.conv_bbox.weight.mul_(0.01)
    return cpu.state_dict(), train_scene_batch(cpu, b)


def dp_rank_main(rank: int, world: int, port: int, out_path: str,
                 backend: str) -> int:
    """One rank of phase 8c (chip_smoke.py --dp-rank): "gloo", two ranks
    on the card, or "nccl", rank r on card r (tools/chip_phases.py m):
    one data-parallel train_step of the 7b scene, one image a rank, rank
    0 writing the weights and losses; "nccl-fit", one rank:
    Trainer.fit for two steps through the data-parallel path."""
    import torch.distributed as dist
    from maskrcnn_tpu_torch import parallel
    from maskrcnn_tpu_torch.models.mask_rcnn import MaskRCNN
    from maskrcnn_tpu_torch.train import step as pstep
    from maskrcnn_tpu_torch.train.trainer import Trainer, to_device
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    state, batch = _dp_scene(max(world, 2))
    device = (torch.device("cuda", rank) if backend == "nccl"
              else torch.device(DEVICE))
    if device.index is not None:
        torch.cuda.set_device(device)
    dist.init_process_group(backend.split("-")[0],
                            init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        cfg = train_scene_config().replace(NUM_DEVICES=world)
        model = MaskRCNN(cfg, device, train=True)
        model.load_state_dict(state)
        if backend == "nccl-fit":
            trainer = Trainer(model, log_every=1)
            trainer.fit(iter([batch] * 2), 1e-3, 1, "all",
                        parallel.rank_generator(0, rank, device),
                        steps_per_epoch=2)
            hist = trainer.step_history
            check(len(hist) == 2 and all(np.isfinite(r["total"])
                                         for r in hist),
                  f"8c: Trainer.fit over nccl: {hist}")
            print(f"[8c] one-rank nccl group: Trainer.fit 2 steps through "
                  f"the data-parallel path, totals "
                  f"{[round(r['total'], 5) for r in hist]}", flush=True)
            return 0
        per = cfg.IMAGES_PER_DEVICE
        ps = [p for _, p in model.named_parameters()]
        opt = pstep.make_optimizer(cfg, 1e-3, ps, [True] * len(ps))
        dp = parallel.for_config(cfg)
        local = to_device(parallel.rank_slice(batch, rank, per), device)
        gen = torch.Generator(device=device).manual_seed(0)
        losses = pstep.train_step(model, opt, local, gen, dp)
        if rank == 0:
            torch.save({"losses": {k: float(v) for k, v in losses.items()},
                        "params": {n: p.detach().cpu()
                                   for n, p in model.named_parameters()}},
                       out_path)
        return 0
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _ranks(world: int, backend: str, out_path: str):
    """Run `world` ranks of dp_rank_main as subprocesses; wait for all."""
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--dp-rank", str(r), str(world),
         str(port), out_path, backend], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        check(p.returncode == 0, f"8c {backend} rank failed:\n{out[-3000:]}")
    return outs


def _dp_against_one_process(world, backend, label):
    """Run `world` ranks of one data-parallel step (one image each) and
    hold it against the one-process step on the same global batch on the
    first card: losses within 1e-4 relative, every weight within 1e-4 of
    its largest |value|, as 7b; a zero-initialized bias, which is nothing
    but its update, within 3e-3 of its largest update (as
    tests/test_torch_parallel.py: its gradient sums terms of both signs
    over the ranks in another order; measured 1.0e-4 for mask.conv3.bias
    on four cards). Returns (loss gap, weight gap, seconds)."""
    import os
    from maskrcnn_tpu_torch.models.mask_rcnn import MaskRCNN
    from maskrcnn_tpu_torch.train import step as pstep
    from maskrcnn_tpu_torch.train.trainer import to_device
    path = f"build/phase8c_{backend}_rank0.pt"
    t0 = time.perf_counter()
    _ranks(world, backend, path)
    got = torch.load(path)
    os.remove(path)
    state, batch = _dp_scene(max(world, 2))
    batch = {k: v[:world] for k, v in batch.items()}
    model = MaskRCNN(train_scene_config(), DEVICE, train=True)
    model.load_state_dict(state)
    ps = [p for _, p in model.named_parameters()]
    opt = pstep.make_optimizer(model.config, 1e-3, ps, [True] * len(ps))
    losses = pstep.train_step(model, opt, to_device(batch, DEVICE),
                              torch.Generator(device=DEVICE).manual_seed(0))
    rel = 0.0
    for k, v in losses.items():
        v = float(v)
        check(abs(got["losses"][k] - v) <= 1e-4 * abs(v) + 1e-7,
              f"{label}: loss {k} ranks {got['losses'][k]} one {v}")
        rel = max(rel, abs(got["losses"][k] - v) / max(abs(v), 1e-30))
    worst = 0.0
    for n, p in model.named_parameters():
        want = p.detach().cpu()
        init = state[n]
        zero = not init.any()
        scale = float((want - init).abs().max() if zero
                      else want.abs().max())
        gap = float((got["params"][n] - want).abs().max())
        check(gap <= (3e-3 if zero else 1e-4) * scale + 1e-30,
              f"{label}: {n} {gap} of {scale}")
        if not zero:
            worst = max(worst, gap / max(scale, 1e-30))
    return rel, worst, time.perf_counter() - t0


def dp_phase(card):
    """Phase 8c: two gloo ranks on the one card (NCCL refuses two ranks
    on a device) each take one image of the 7b scene: their
    data-parallel step (K1, K1-bwd and K2 on the card, the losses'
    denominators and the gradients all-reduced) against the one-process
    step on the same global batch, as 7b. Then a one-rank nccl group runs
    Trainer.fit for two steps. The multi-device Detector needs more than
    one card."""
    rel, worst, secs = _dp_against_one_process(2, "gloo", "8c")
    print(f"[8c] two gloo ranks on the card, one image each of the 7b "
          f"scene: the data-parallel step equals the one-process step "
          f"(losses within {rel:.3g} relative, weights within {worst:.3g} "
          f"of their max) in {secs:.1f} s; {card}", flush=True)
    outs = _ranks(1, "nccl-fit", "")
    print(outs[0].strip().splitlines()[-1], flush=True)
    print("[8c] the multi-device Detector (NUM_DEVICES > 1, one replica a "
          "card) needs more than one card: not run here", flush=True)


def multi_gpu_phase(det, card):
    """More than one card (tools/chip_phases.py m): one nccl rank a card,
    one image each of the 7b scene, against the one-process step; then
    Detector(NUM_DEVICES = the card count) on eight COCO-sized images
    against the one-card Detector `det` run on the same split (each
    replica's part as its own batch: cuDNN's bf16 convs pick their
    algorithm by batch size): class ids and boxes equal, mask pixels
    apart under 0.02 (5h's metrics); and both detect_batch times on the
    eight (median of 3, host clock)."""
    from maskrcnn_tpu_torch.api import Detector
    n = torch.cuda.device_count()
    check(n > 1, f"the multi-card phase needs more than one card, has {n}")
    rel, worst, secs = _dp_against_one_process(n, "nccl", "multi-gpu")
    print(f"[m] {n} nccl ranks, one a card, one image each of the 7b scene:"
          f" the data-parallel step equals the one-process step (losses "
          f"within {rel:.3g} relative, weights within {worst:.3g} of their "
          f"max, zero-initialized biases within 3e-3 of their update) in "
          f"{secs:.1f} s; {card}", flush=True)
    rng = np.random.RandomState(5)
    images = make_images(rng, list(COCO_SHAPES))
    many = Detector(det.config.replace(NUM_DEVICES=n), device=DEVICE,
                    generator=torch.Generator().manual_seed(0))
    many.model.load_state_dict(det.model.state_dict())
    many._weights = object()
    per = -(-len(images) // n)
    want = [r for i in range(0, len(images), per)
            for r in det.detect_batch(images[i:i + per])]
    got = many.detect_batch(images)
    check(len(many._replicas) == n, "one replica a card")
    apart = pixels = 0
    for a, b in zip(want, got):
        check(a is not None and b is not None and a[0] == b[0]
              and a[2] == b[2], "multi-card Detector: detections differ")
        apart += int((a[3] != b[3]).sum())
        pixels += a[3].size
    share = apart / max(pixels, 1)
    check(share < 0.02, f"multi-card Detector: {share} of mask pixels")
    times = {}
    for name, d in (("one card", det), (f"{n} cards", many)):
        runs = []
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            d.detect_batch(images)
            runs.append((time.perf_counter() - t) * 1e3)
        times[name] = statistics.median(runs)
    print(f"[m] Detector(NUM_DEVICES={n}) on eight COCO-sized images: the "
          f"one-card Detector's detections on the same split ({share:.6f} "
          f"of mask pixels apart); detect_batch median "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in times.items())
          + f"; {card}", flush=True)


EXPORT_CHILD = r"""
import sys, time
import torch
import maskrcnn_tpu_torch.kernels.torch_ops
from maskrcnn_tpu_torch import kernels
sync = torch.cuda.synchronize if torch.cuda.is_available() else lambda: None
path, params_path, io_path, out_path = sys.argv[1:5]
params = torch.load(params_path)
io = torch.load(io_path)
program = torch.export.load(path).module()
names = ("roi_align", "nms", "paste_pack", "bottleneck")
before = {k: getattr(kernels, k).launches for k in names}
with torch.no_grad():
    out = program(params, io["images"], io["windows"])
sync()
launches = {k: getattr(kernels, k).launches - v for k, v in before.items()}
times = []
for _ in range(5):
    sync()
    t0 = time.perf_counter()
    with torch.no_grad():
        program(params, io["images"], io["windows"])
    sync()
    times.append((time.perf_counter() - t0) * 1e3)
model_code = sorted(m for m in sys.modules if m.startswith("maskrcnn")
                    and m not in ("maskrcnn_tpu_torch",
                                  "maskrcnn_tpu_torch.kernels",
                                  "maskrcnn_tpu_torch.kernels.torch_ops"))
torch.save({"out": {k: v.cpu() for k, v in out.items()},
            "launches": launches, "ms": sorted(times)[2],
            "model_code": model_code}, out_path)
"""


def export_phase(det, kernels, card, b=8):
    """Phase 8d: export the default config's predict_step at B=8 on the
    card (weights as the program's input), save it, and load and run it in
    a subprocess that imports torch and kernels.torch_ops only: its
    outputs bit-identical to the live step's, its K1/K2/K4 launches, its
    time beside the live step's (host clock around synchronised calls,
    median of 5)."""
    import os
    from maskrcnn_tpu_torch import export as ex
    from maskrcnn_tpu_torch.detection.pipeline import predict_step
    rng = np.random.RandomState(9)
    images = make_images(rng, [COCO_SHAPES[i] for i in range(b)])
    x, windows, _ = det._preprocess(images)
    win = torch.tensor(windows, dtype=torch.float32).to(DEVICE)
    t0 = time.perf_counter()
    path = "build/phase8d_predict.pt2"
    torch.export.save(ex.export_predict(det.model, b), path)
    export_s = time.perf_counter() - t0
    ep = torch.export.load(path)
    ops = sorted({str(n.target) for n in ep.graph.nodes
                  if n.op == "call_function" and "mrt" in str(n.target)})
    with torch.no_grad():
        want = predict_step(det.model, x, win)
    live = []
    for _ in range(5):
        torch.cuda.synchronize()
        s = time.perf_counter()
        with torch.no_grad():
            predict_step(det.model, x, win)
        torch.cuda.synchronize()
        live.append((time.perf_counter() - s) * 1e3)
    params_path, io_path, out_path = ("build/phase8d_params.pt",
                                      "build/phase8d_io.pt",
                                      "build/phase8d_out.pt")
    torch.save({k: v for k, v in ex.model_params(det.model).items()},
               params_path)
    torch.save({"images": x, "windows": win}, io_path)
    try:
        proc = subprocess.run([sys.executable, "-c", EXPORT_CHILD, path,
                               params_path, io_path, out_path],
                              capture_output=True, text=True, timeout=600)
        check(proc.returncode == 0, f"8d: the loading process failed:\n"
              f"{proc.stderr[-3000:]}")
        got = torch.load(out_path)
    finally:
        for f in (path, params_path, io_path, out_path):
            if os.path.exists(f):
                os.remove(f)
    check(not got["model_code"], f"8d: model code imported "
          f"{got['model_code']}")
    for k, v in want.items():
        check(torch.equal(got["out"][k], v.cpu()),
              f"8d: the loaded program's {k} differs from the live step's")
    n = got["launches"]
    check(n["roi_align"] == 2 and n["nms"] >= 2 and n["paste_pack"] == 1,
          f"8d: launches {n}")
    print(f"[8d] predict_step B={b} {cfg_name(det.config)} exported in "
          f"{export_s:.1f} s (custom ops {ops}), loaded in a process that "
          f"imports torch and kernels.torch_ops only: outputs bit-identical "
          f"to the live step; launches a step K1 {n['roi_align']} K2 "
          f"{n['nms']} K4 {n['paste_pack']}; loaded program "
          f"{got['ms']:.2f} ms, live step {sorted(live)[2]:.2f} ms "
          f"(host clock, median of 5); {card}", flush=True)


def profiler_phase(det, images):
    """Phase 8e: utils.profiler.trace around one predict_step writes a
    Chrome trace with the card's kernels in it."""
    from maskrcnn_tpu_torch.detection.pipeline import predict_step
    from maskrcnn_tpu_torch.utils.profiler import trace
    x, windows, _ = det._preprocess(images)
    win = torch.tensor(windows, dtype=torch.float32).to(DEVICE)
    with trace("build/phase8", "predict_step"):
        with torch.no_grad():
            predict_step(det.model, x, win)
        torch.cuda.synchronize()
    with open("build/phase8/predict_step.json") as f:
        events = json.load(f)["traceEvents"]
    k = [e for e in events if e.get("cat") == "kernel"]
    check(len(events) > 0, "8e: an empty trace")
    names = {e["name"] for e in k}
    print(f"[8e] utils.profiler.trace around one B={len(images)} "
          f"predict_step: build/phase8/predict_step.json, "
          f"{len(events)} events, {len(k)} CUDA kernels "
          f"({len(names)} names, K1 among them: "
          f"{any('roi_align' in n for n in names)})", flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile", metavar="DIR", default=None)
    # phase 8c's ranks: RANK WORLD PORT OUT BACKEND
    parser.add_argument("--dp-rank", nargs=5, default=None,
                        help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.dp_rank:
        rank, world, port, out, backend = args.dp_rank
        return dp_rank_main(int(rank), int(world), int(port), out, backend)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1

    from maskrcnn_tpu_torch import kernels
    from maskrcnn_tpu_torch.ops import bottleneck as bt
    from maskrcnn_tpu_torch.ops import mask_paste as mp
    from maskrcnn_tpu_torch.ops import nms, roi_align as roi

    card = card_info()
    print(card, flush=True)
    probe = torch.zeros(1, device=DEVICE)
    print(f"[1] torch {torch.__version__} cuda {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    check(probe.is_cuda, "the work runs on a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    t0 = time.perf_counter()
    fresh = not kernels.library_path().exists()
    kernels.library()
    print(f"[2] kernels {'built' if fresh else 'found built'} in "
          f"{time.perf_counter() - t0:.2f} s: {kernels.library_path().name}",
          flush=True)

    roi_err, roi_times = roi_align_phase(kernels, roi)
    roi8_err, roi8_times = roi_int8_phase(kernels, roi)
    nms_times = nms_phase(kernels, nms)
    rpn_nms_2000_phase(kernels)
    k3_err, k3_times = bottleneck_phase(kernels, bt)
    k4_ties, *k4_times = paste_phase(kernels, mp, 400, 1024, 1024)
    k4_ragged_ties = paste_phase(kernels, mp, 100, 1000, 997)[0]
    k4_ragged_ties += paste_phase(kernels, mp, 400, *RECT_CANVAS)[0]
    # K1's op on the card, bf16 P=7: 8 x 500 boxes
    k5_err, k5_times = group_roi_phase(
        roi_times[(torch.bfloat16, 7)][0] * 1e3 / 4000)
    int8_conv_phase()

    cfg = slice_config()
    det, images, launches = slice_phase(kernels, cfg)
    run_err = intermediates_phase(det, images, kernels, roi, nms)
    tiny_parity_phase()
    fdet, _, fold_launches = slice_phase(
        kernels, cfg.replace(FOLD_BN=True), tag="5d")
    tiny_parity_phase(fold=True, tag="5e")
    fold_parity_phase()
    qdet, _, quant_launches = slice_phase(
        kernels, cfg.replace(QUANT_INT8=True), tag="5f")
    tiny_parity_phase(tag="5g", act_stats=tiny_act_stats())
    product_launches = product_phase(kernels, card)
    k1b_err, k1b_times = roi_backward_phase(kernels, roi)
    train_parity_phase()
    reset_counts(kernels)
    train_step_b4 = train_phase(kernels, card)
    train_launches = launch_counts(kernels)
    x, win, base_ms = timing_phase(det, images, card)
    timing_phase(fdet, images, card)
    timing_phase(qdet, images, card)
    protocol_launches = protocols_phase(kernels, nms, card, base_ms)
    reset_counts(kernels)
    server_launches = server_phase(det, kernels, card)
    reset_counts(kernels)
    retina_k2, retina_times = retina_phase(kernels, nms, card)
    dp_phase(card)
    reset_counts(kernels)
    export_phase(det, kernels, card)
    profiler_phase(det, images)
    if args.profile:
        from maskrcnn_tpu_torch.detection.pipeline import predict_step
        for d, name in ((det, "predict_step"),
                        (fdet, "predict_step_fold_bn"),
                        (qdet, "predict_step_int8")):
            profile_phase(lambda d=d: predict_step(d.model, x, win),
                          f"predict_step B=8 {cfg_name(d.config)}",
                          args.profile, name)
        profile_phase(train_step_b4, "train_step B=4 "
                      f"{cfg_name(train_config_full())}", args.profile,
                      "train_step")

    # launches: the main-path runs (default, FOLD_BN and QUANT_INT8 slices,
    # the product surface's requests and evaluations, and the protocols'
    # requests and steps); K1's float-table launches apart from its int8
    # ones
    runs = {k: launches[k] + fold_launches[k] + quant_launches[k]
            + product_launches[k] + protocol_launches[k] + train_launches[k]
            + server_launches[k] for k in launches}
    runs["nms"] += retina_k2
    runs["roi_align"] -= runs["roi_align_int8"]
    check(runs["roi_align_backward"] > 0, "K1-bwd never ran on the main "
          "path")

    # K3 at its most frequent shape, C4 (22 of the 29 blocks); no single
    # PyTorch call computes the fused block (cuDNN's three convs beside it)
    k3_ms, k3_plain_ms, k3_cudnn_ms, k3_bound_ms, k3_by = \
        k3_times[(64, 64, 256)]

    def entry(name, source, replaces, err, times, **extra):
        ms, plain_ms, bound_ms, bound_by = times
        return {"name": name, "route": "cuda",
                "source": f"maskrcnn_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": runs[name],
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": None, **extra}

    def roi_entry(name, err, times):
        """K1 at P=7 (the box head) with the mask head's P=14 beside it,
        bf16 out: the op's time, fed only boxes."""
        ms, plain_ms, _, bound_ms, bound_by = times[(torch.bfloat16, 7)]
        ms14, plain14, _, bound14, _ = times[(torch.bfloat16, 14)]
        return entry(name, "roi_align.cu",
                     "maskrcnn_tpu/ops/roi_align_pallas.py:58", err,
                     (ms, plain_ms, bound_ms, bound_by), ms_p14=ms14,
                     bound_ms_p14=bound14, plain_ms_p14=plain14)

    print(json.dumps({"kernels": [
        roi_entry("roi_align", max(roi_err, run_err), roi_times),
        roi_entry("roi_align_int8", roi8_err, roi8_times),
        # K1-bwd at the training step's shapes (B=4, N=100), bf16 levels
        # at P=7 with P=14 and float32 beside it; no PyTorch call on the
        # card's machine computes it (torchvision's roi_align is absent)
        entry("roi_align_backward", "roi_align.cu",
              "maskrcnn_tpu/ops/roi_align.py:176", k1b_err,
              k1b_times[(torch.bfloat16, 7)],
              ms_p14=k1b_times[(torch.bfloat16, 14)][0],
              plain_ms_p14=k1b_times[(torch.bfloat16, 14)][1],
              bound_ms_p14=k1b_times[(torch.bfloat16, 14)][2],
              ms_f32=k1b_times[(torch.float32, 7)][0],
              ms_f32_p14=k1b_times[(torch.float32, 14)][0]),
        # B=8 N=500 at 0.7; the chain bound: N dependent steps at the
        # probe's latency. No PyTorch call computes greedy NMS.
        entry("nms", "nms.cu", "maskrcnn_tpu/ops/nms_pallas.py:35", 0.0,
              nms_times[:4], chain_bound_ms=nms_times[4],
              paced_by=("chain" if nms_times[4] > nms_times[2]
                        else nms_times[3]),
              launches_per_call=nms_times[5],
              # RetinaNet's class-offset call, B=8 N=1,000 (phase 8b)
              ms_retina=retina_times[0], plain_ms_retina=retina_times[1],
              bound_ms_retina=retina_times[2],
              chain_bound_ms_retina=retina_times[4],
              launches_retina=retina_k2),
        entry("bottleneck", "bottleneck.cu",
              "maskrcnn_tpu/ops/bottleneck_pallas.py:38", k3_err,
              (k3_ms, k3_plain_ms, k3_bound_ms, k3_by),
              cudnn_block_ms=k3_cudnn_ms),
        # a bit's error is 0 or 1: 1 where a threshold tie landed on the
        # other side, and tie_bits counts them (1024², 768x1024 and ragged
        # canvas)
        entry("paste_pack", "paste_pack.cu",
              "benchmarks/gates/paste_pack_kernel.py:60",
              float(k4_ties + k4_ragged_ties > 0), k4_times,
              tie_bits=k4_ties + k4_ragged_ties),
        # a study on no path: no launch on the main path by design.
        # float32 patches [128, 40, 256]: the bound at the tensor cores'
        # peak (two TF32 products), the library's time one torch.einsum;
        # bf16 beside it
        entry("group_roi", "group_roi.cu",
              "benchmarks/gates/group_roi_gate.py:29", k5_err,
              k5_times[torch.float32][:4],
              library_ms=k5_times[torch.float32][4],
              bound_ms_cuda_cores=k5_times[torch.float32][5],
              ms_bf16=k5_times[torch.bfloat16][0],
              plain_ms_bf16=k5_times[torch.bfloat16][1],
              bound_ms_bf16=k5_times[torch.bfloat16][2],
              library_ms_bf16=k5_times[torch.bfloat16][4], on_path=False)]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
