#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py                 # from the repository root
    python3 chip_smoke.py --profile DIR   # also write a torch.profiler
                                          # table of one B=8 predict_step

Phases, each printing one line:
 1. the card (nvidia-smi name and power limit, torch's device name);
 2. build the CUDA kernels from maskrcnn_tpu_torch/csrc;
 3. RoIAlign kernel, fed only boxes, vs its plain PyTorch version with
    its coordinate prologue on the card: B=8, levels 256/128/64/32,
    C=256, 500 boxes at P=7 and 50 at P=14 (with the edge boxes), in
    float32 with TF32 off and in bfloat16 (the count of differing values
    printed); the op on the card runs no PyTorch op but the output
    allocation, and launches K1 once; its time at both shapes beside its
    bound and the plain version's;
 3b. RoIAlign's int8-table mode the same way: int8 levels with four
    level scales, both shapes, bf16 and f32 out; bit-equal (else at most
    1 bf16 ulp, the count printed);
 4. NMS kernel vs its plain version at N = 500, 64, 1,320, 1,345, 2,000 and
    6,000 (above 1,320 the bitmask goes through device memory), boxes at
    0.7 and class-offset boxes at 0.3, with invalid rows: keep masks must
    be identical, one launch a call; the chain's step latency (one
    thread) and K2's chain bound; rpn_refine_scores at
    RPN_NMS_MAX_ROIS_NUM=2000 on the card equal to the CPU;
 4b. fused identity bottleneck kernel vs its plain version at the four
    identity-block shapes of ResNet-101 at B=8 on the 1024² canvas, float32
    and bfloat16, and at odd small sizes (bf16 at every P of the four, so
    every bf16 tile has partial tiles); bf16 times beside the bound, the
    share of the bound reached, the plain version, the same folded block
    as cuDNN bf16 convs and version 3's time;
 4c. paste-and-pack kernel vs its plain version: 400 detections on the
    1024² canvas and 100 on a ragged 1000x997 one, with edge boxes and
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
 6. one predict_step at B=8 in sync-debug "error" mode (no host sync),
    then the median of 5 timed calls at B=8 and at B=1, for the default,
    the FOLD_BN and the QUANT_INT8 model (--profile: a table of each);
then one JSON line of per-kernel numbers (time, launches on the main
path, error, plain version's time, the bound and what sets it, the
library's time; K1 at P=7 and, in the `_p14` keys, at P=14; K2's chain
bound and version 1's time; K5 in float32 and, in the `_bf16` keys,
bf16, with version 1's times), and, last, the result line.
Exits non-zero, printing no result line, without a CUDA device or when
any check fails. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

CANVAS = (1024, 1024, 3)
LEVELS = (256, 128, 64, 32)
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


def roi_ops_check(kernels, roi, levels, boxes, pool, *args):
    """The fused op on the card runs no PyTorch op but the output
    allocation (views aside: every PyTorch kernel goes through an op seen
    here) and launches K1 once. Returns the ops seen."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.names = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.names.append(func.overloadpacket.__name__)
            return func(*args, **(kwargs or {}))

    before = kernels.roi_align.launches
    with Ops() as ops:
        roi.multilevel_roi_align_impl(levels, boxes, pool, CANVAS, *args)
    # views and no-op conversions compute nothing; a copy would show as
    # _to_copy, clone or copy_
    compute = [n for n in ops.names
               if n not in ("view", "_unsafe_view", "reshape", "to",
                            "contiguous", "alias")]
    check(compute == ["empty"] and kernels.roi_align.launches == before + 1,
          f"roi_align op on the card: ops {ops.names}, launches "
          f"{kernels.roi_align.launches - before}")
    return ops.names


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
    PyTorch coordinate prologue, at the slice's shapes."""
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    rng = np.random.RandomState(0)
    worst, times = 0.0, {}
    for dtype in (torch.float32, torch.bfloat16):
        levels = [torch.randn(8, s, s, 256, generator=gen, device=DEVICE)
                  .to(dtype) for s in LEVELS]
        for pool, n in ROI_SHAPES:
            boxes = torch.from_numpy(np.stack(
                [edge_boxes(rng, n) for _ in range(8)])).to(DEVICE)
            flat = boxes.reshape(-1, 4)
            got = kernels.roi_align(levels, flat, pool, CANVAS)
            want = roi.multilevel_roi_align(levels, boxes, pool,
                                            CANVAS).reshape(got.shape)
            torch.cuda.synchronize()
            differ = int((got != want).sum())
            err = float((got.float() - want.float()).abs().max())
            worst = max(worst, err)
            line = (f"{differ} of {got.numel()} values differ, "
                    f"max_abs_err {err:.3g}")
            if dtype == torch.float32:
                check(err <= 1e-5, f"roi_align f32 P={pool}: err {err}")
            else:
                ulps = bf16_ulps(got, want)
                check(ulps <= 1.0, f"roi_align bf16 P={pool}: {ulps} ulp")
                line += f" ({ulps:g} bf16 ulp)"
            ops = roi_ops_check(kernels, roi, levels, boxes, pool)
            ms, issued_ms, prologue_ms, plain_ms = roi_op_times(
                roi, levels, boxes, pool)
            bound_ms, bound_by = roi_bound(roi, levels, boxes, pool, got)
            times[(dtype, pool)] = (ms, plain_ms, issued_ms, bound_ms,
                                    bound_by)
            print(f"[3] roi_align {str(dtype)[6:]} B=8 N={n} P={pool} "
                  f"C=256: {line}; op {ms:.4f} ms on the card (bound "
                  f"{bound_ms:.4f} by {bound_by}, {bound_ms / ms:.1%} of "
                  f"it; {issued_ms:.4f} ms a call as issued, host "
                  f"included); the plain prologue that version 1 ran before "
                  f"its launch {prologue_ms:.4f} ms; plain {plain_ms:.4f} "
                  f"ms; the op ran {ops} and one K1 launch", flush=True)
    return worst, times


ROI_SCALES = (0.021, 0.017, 0.032, 0.009)


def roi_int8_phase(kernels, roi):
    """Phase 3b: K1's int8-table mode (fed only boxes) against its plain
    version with its PyTorch prologue at the slice's shapes (int8 P2..P5
    with four level scales), bf16 and f32 out. Bar: bit-equal; else at
    most 1 bf16 ulp, the count of differing values printed."""
    gen = torch.Generator(device=DEVICE).manual_seed(6)
    rng = np.random.RandomState(6)
    levels = [torch.randint(-127, 128, (8, s, s, 256), generator=gen,
                            device=DEVICE, dtype=torch.int8) for s in LEVELS]
    worst, times = 0.0, {}
    for pool, n in ROI_SHAPES:
        boxes = torch.from_numpy(np.stack(
            [edge_boxes(rng, n) for _ in range(8)])).to(DEVICE)
        flat = boxes.reshape(-1, 4)
        for out_dtype in (torch.bfloat16, torch.float32):
            args = (ROI_SCALES, out_dtype)
            got = kernels.roi_align(levels, flat, pool, CANVAS, *args)
            want = roi.multilevel_roi_align(levels, boxes, pool, CANVAS,
                                            *args).reshape(got.shape)
            torch.cuda.synchronize()
            check(got.dtype == want.dtype == out_dtype,
                  f"roi_align int8: out dtype {got.dtype}")
            differ = int((got != want).sum())
            err = float((got.float() - want.float()).abs().max())
            ulps = bf16_ulps(got, want)
            check(differ == 0 or ulps <= 1.0,
                  f"roi_align int8 P={pool} {out_dtype}: {differ} differ, "
                  f"{ulps} bf16 ulp")
            worst = max(worst, err)
            roi_ops_check(kernels, roi, levels, boxes, pool, *args)
            ms, issued_ms, prologue_ms, plain_ms = roi_op_times(
                roi, levels, boxes, pool, *args)
            bound_ms, bound_by = roi_bound(roi, levels, boxes, pool, got)
            times[(out_dtype, pool)] = (ms, plain_ms, issued_ms, bound_ms,
                                        bound_by)
            print(f"[3b] roi_align int8 tables -> {str(out_dtype)[6:]} B=8 "
                  f"N={n} P={pool} C=256: {differ} of {got.numel()} values "
                  f"differ, max_abs_err {err:.3g} ({ulps:g} bf16 ulp); "
                  f"op {ms:.4f} ms on the card (bound {bound_ms:.4f} by "
                  f"{bound_by}, {bound_ms / ms:.1%} of it; {issued_ms:.4f} "
                  f"ms a call as issued); plain prologue {prologue_ms:.4f} "
                  f"ms; plain {plain_ms:.4f} ms", flush=True)
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
    bfloat16, at the slice's block shapes and at odd small sizes: in bf16
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
                v3 = K3_V3_MS[(h, w, p)]
                line += (f"; bound {bound_ms:.4f} ms by {bound_by}, "
                         f"{bound_ms / ms:.1%} of it; cuDNN bf16 block "
                         f"{cudnn_ms:.4f} ms; v3 {v3} ms (PERF.md), "
                         f"{v3 / ms:.2f}x")
                times[(h, w, p)] = (ms, plain_ms, cudnn_ms, bound_ms,
                                    bound_by)
        print(f"[4b] bottleneck {name}: {line}", flush=True)
    return worst, times


def paste_phase(kernels, mp, n, h, w):
    """Phase 4c: K4 against the plain version, at 400 detections (B=8 x
    50) on the 1024² canvas and on a ragged canvas (a row pitch and plane
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


def cfg_name(cfg) -> str:
    return (f"{cfg.BACKBONE} {cfg.IMAGE_MAX_DIM}² {cfg.COMPUTE_DTYPE}"
            + (" FOLD_BN" if cfg.FOLD_BN else "")
            + (" QUANT_INT8" if cfg.QUANT_INT8 else ""))


def make_images(rng, shapes):
    return [rng.randint(0, 256, s + (3,), dtype=np.uint8) for s in shapes]


KERNELS = ("roi_align", "nms", "bottleneck", "paste_pack", "group_roi")


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
        x = normalize_image(torch.from_numpy(batch).to(DEVICE),
                            cfg.MEAN_PIXEL)
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


def tiny_inputs():
    rng = np.random.RandomState(3)
    images = rng.randint(0, 256, (2, 128, 128, 3), dtype=np.uint8)
    windows = np.array([[0, 0, 128, 128], [16, 0, 112, 128]], np.float32)
    return torch.from_numpy(images), torch.from_numpy(windows)


def tiny_model(fold: bool, device, act_stats=None):
    """The 128-px float32 config with seeded weights (folded under
    FOLD_BN), every detection kept. With `act_stats` (calibration stats):
    QUANT_INT8, quantized with them."""
    from maskrcnn_tpu_torch import TinyConfig
    from maskrcnn_tpu_torch.models.mask_rcnn import MaskRCNN
    from maskrcnn_tpu_torch.quant import prepare_quant_params
    cfg = TinyConfig().replace(DETECTION_MIN_CONFIDENCE=0.0, FOLD_BN=fold,
                               QUANT_INT8=act_stats is not None)
    model = MaskRCNN(cfg, device).init(torch.Generator().manual_seed(5))
    if act_stats is not None:
        model.set_quant(prepare_quant_params(model, model.float_state,
                                             act_stats=act_stats))
    return model


def tiny_act_stats():
    """Calibration stats of the tiny int8 model, taken on the CPU: one
    dict for both sides of the int8 parity."""
    from maskrcnn_tpu_torch import TinyConfig
    from maskrcnn_tpu_torch.models.mask_rcnn import MaskRCNN
    from maskrcnn_tpu_torch.quant import calibrate, default_calib_canvases
    cfg = TinyConfig().replace(DETECTION_MIN_CONFIDENCE=0.0, QUANT_INT8=True)
    model = MaskRCNN(cfg, "cpu").init(torch.Generator().manual_seed(5))
    return calibrate(model, model.float_state,
                     default_calib_canvases(cfg.IMAGE_SHAPE, n=2))


def tiny_parity_phase(fold: bool = False, tag: str = "5", act_stats=None):
    """Phase 5c (5e under FOLD_BN, 5g under QUANT_INT8 with one shared
    act_stats): the port on the card against the port on the CPU, 128-px
    float32 config, TF32 off; the bar of the CPU parity tests."""
    from maskrcnn_tpu_torch.detection.pipeline import predict_step
    cpu = tiny_model(fold, "cpu", act_stats)
    gpu = tiny_model(fold, DEVICE, act_stats)
    images, windows = tiny_inputs()
    want = predict_step(cpu, images, windows)
    got = predict_step(gpu, images.to(DEVICE), windows.to(DEVICE))
    got = {k: v.cpu() for k, v in got.items()}
    total = equal = mism = nbytes = 0
    dscore = 0.0
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
    share = equal / max(total, 1)
    check(total > 0 and share >= 0.9 and dscore <= 1e-4
          and mism <= 0.01 * max(nbytes, 1),
          f"tiny cuda vs cpu: share {share}, dscore {dscore}, "
          f"mask bytes {mism}/{nbytes}")
    print(f"[{tag}] tiny f32{' FOLD_BN' if fold else ''}"
          f"{' QUANT_INT8' if act_stats else ''} predict_step "
          f"cuda vs cpu: {total} valid, (class, box) equal {share:.4f}, max "
          f"|dscore| {dscore:.3g}, mask byte mismatch "
          f"{mism / max(nbytes, 1):.3g}", flush=True)


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


def timing_phase(det, images, card, tag="6"):
    """Phase 6: predict_step at B=8 and at B=1, the median of 5 calls
    after 2 warm-ups, each timed by CUDA events around the call. One B=8
    call first runs with synchronising calls turned into errors."""
    from maskrcnn_tpu_torch.detection.pipeline import predict_step
    batch, windows, _ = det._preprocess(images)
    x = torch.from_numpy(batch).to(DEVICE)
    win = torch.tensor(windows, dtype=torch.float32, device=DEVICE)
    for b in (len(images), 1):
        torch.cuda.reset_peak_memory_stats()
        for _ in range(2):
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
        for _ in range(5):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            predict_step(det.model, x[:b], win[:b])
            end.record()
            torch.cuda.synchronize()
            runs.append(start.elapsed_time(end))
        ms = statistics.median(runs)
        print(f"[{tag}] predict_step B={b} {cfg_name(det.config)}: median {ms} "
              f"ms/batch ({b * 1000.0 / ms} img/s), runs {runs}, peak mem "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {card}",
              flush=True)
    return x, win


def profile_phase(det, x, win, out_dir, name="predict_step"):
    """--profile: one predict_step under torch.profiler. Writes the table
    by op and the Chrome trace, and prints the device's busy time over
    the step's kernel window (the profiler's own host cost widens the
    window, so the idle share is an upper bound)."""
    import os
    from torch.profiler import ProfilerActivity, profile
    from maskrcnn_tpu_torch.detection.pipeline import predict_step
    os.makedirs(out_dir, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        predict_step(det.model, x, win)
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
    print(f"[6] profile {cfg_name(det.config)}: {len(spans)} kernels, "
          f"device busy "
          f"{busy / 1e3:.3f} of {window / 1e3:.3f} ms "
          f"({1 - busy / window:.1%} idle); table and trace in {out_dir}",
          flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile", metavar="DIR", default=None)
    args = parser.parse_args()
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
    x, win = timing_phase(det, images, card)
    timing_phase(fdet, images, card)
    timing_phase(qdet, images, card)
    if args.profile:
        profile_phase(det, x, win, args.profile)
        profile_phase(fdet, x, win, args.profile, "predict_step_fold_bn")
        profile_phase(qdet, x, win, args.profile, "predict_step_int8")

    # launches: the three main-path runs (default, FOLD_BN and QUANT_INT8
    # slices); K1's float-table launches apart from its int8 ones
    runs = {k: launches[k] + fold_launches[k] + quant_launches[k]
            for k in launches}
    runs["roi_align"] -= runs["roi_align_int8"]

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
        # B=8 N=500 at 0.7; the chain bound: N dependent steps at the
        # probe's latency. No PyTorch call computes greedy NMS.
        entry("nms", "nms.cu", "maskrcnn_tpu/ops/nms_pallas.py:35", 0.0,
              nms_times[:4], chain_bound_ms=nms_times[4],
              paced_by=("chain" if nms_times[4] > nms_times[2]
                        else nms_times[3]),
              launches_per_call=nms_times[5]),
        entry("bottleneck", "bottleneck.cu",
              "maskrcnn_tpu/ops/bottleneck_pallas.py:38", k3_err,
              (k3_ms, k3_plain_ms, k3_bound_ms, k3_by),
              cudnn_block_ms=k3_cudnn_ms),
        # a bit's error is 0 or 1: 1 where a threshold tie landed on the
        # other side, and tie_bits counts them (1024² and ragged canvas)
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
