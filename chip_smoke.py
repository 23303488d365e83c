#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py                 # from the repository root
    python3 chip_smoke.py --profile DIR   # also write a torch.profiler
                                          # table of one B=8 predict_step

Phases, each printing one line:
 1. the card (nvidia-smi name and power limit, torch's device name);
 2. build the CUDA kernels from maskrcnn_tpu_torch/csrc;
 3. RoIAlign kernel vs its plain PyTorch version on the card: B=8, levels
    256/128/64/32, C=256, 500 boxes at P=7 and 50 at P=14 (with the edge
    boxes), in float32 with TF32 off and in bfloat16;
 4. NMS kernel vs its plain version: N=500 at 0.7, class-offset boxes at
    0.3, with invalid rows; keep masks must be identical;
 5. the slice: Detector(CocoInferenceConfig, ResNet-101, bf16, 1024²
    canvas) with seeded random weights answers three requests (8, 8 and 1
    images); kernel launch counts during them; kernels vs plain versions
    on the run's own FPN maps and proposals; the port on the card vs the
    port on the CPU on a 128-px float32 config;
 6. one predict_step at B=8 in sync-debug "error" mode (no host sync),
    then the median of 5 timed calls at B=8 and at B=1;
then one JSON line of per-kernel numbers and, last, the result line.
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


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn over `iters` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
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


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def roi_align_phase(kernels, roi):
    """Phase 3: K1 against the plain version at the slice's shapes."""
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    rng = np.random.RandomState(0)
    worst, times = 0.0, {}
    for dtype in (torch.float32, torch.bfloat16):
        levels = [torch.randn(8, s, s, 256, generator=gen, device=DEVICE)
                  .to(dtype) for s in LEVELS]
        for pool, n in ((7, 500), (14, 50)):
            boxes = torch.from_numpy(np.stack(
                [edge_boxes(rng, n) for _ in range(8)])).to(DEVICE)
            lvl, in_y, in_x = roi.level_geometry(levels, boxes, pool, CANVAS)
            got = kernels.roi_align(levels, lvl, in_y, in_x, n)
            want = roi.roi_align_levels(levels, lvl, in_y, in_x, n)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            worst = max(worst, err)
            if dtype == torch.float32:
                check(err <= 1e-5, f"roi_align f32 P={pool}: err {err}")
                line = f"max_abs_err {err:.3g}"
            else:
                ulps = bf16_ulps(got, want)
                check(ulps <= 1.0, f"roi_align bf16 P={pool}: {ulps} ulp")
                line = f"max_abs_err {err:.3g} ({ulps:g} bf16 ulp)"
            ms = cuda_ms(lambda: roi.multilevel_roi_align_impl(
                levels, boxes, pool, CANVAS))
            plain_ms = cuda_ms(lambda: roi.multilevel_roi_align(
                levels, boxes, pool, CANVAS), iters=5)
            kern_ms = cuda_ms(lambda: kernels.roi_align(levels, lvl, in_y,
                                                        in_x, n))
            times[(dtype, pool)] = (ms, plain_ms)
            print(f"[3] roi_align {str(dtype)[6:]} B=8 N={n} P={pool} "
                  f"C=256: {line}; kernel op {ms:.4f} ms (launch only "
                  f"{kern_ms:.4f}), plain {plain_ms:.4f} ms", flush=True)
    return worst, times


def nms_phase(kernels, nms):
    """Phase 4: K2 against the plain version, keep masks identical."""
    rng = np.random.RandomState(1)
    b, n = 8, 500
    # boxes jittered around a few centres, so suppression chains are long
    centres = rng.rand(b, 6, 2) * 800 + 100
    ctr = (centres[np.arange(b)[:, None], rng.randint(0, 6, (b, n))]
           + rng.randn(b, n, 2) * 25)
    size = rng.uniform(40, 160, (b, n, 2))
    boxes = np.concatenate([ctr - size / 2, ctr + size / 2], -1)
    valid = rng.rand(b, n) > 0.1
    cases = [("proposals thr 0.7", boxes.astype(np.float32), 0.7)]
    classes = rng.randint(0, 81, (b, n))
    offset = classes[..., None] * (1024.0 + 2.0)
    cases.append(("class-offset thr 0.3",
                  (np.round(boxes) + offset).astype(np.float32), 0.3))
    vt = torch.from_numpy(valid).to(DEVICE)
    times = None
    for name, bx, thr in cases:
        bt = torch.from_numpy(bx).to(DEVICE)
        got = kernels.nms(bt, vt, thr)
        want = nms.nms_mask(bt, vt, thr)
        torch.cuda.synchronize()
        diff = int((got != want).sum())
        check(diff == 0, f"nms {name}: {diff} keep entries differ")
        ms = cuda_ms(lambda: kernels.nms(bt, vt, thr))
        plain_ms = cuda_ms(lambda: nms.nms_mask(bt, vt, thr), iters=3,
                           warmup=1)
        times = times or (ms, plain_ms)
        print(f"[4] nms {name} B={b} N={n}: keep identical "
              f"({int(got.sum())} kept); kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms", flush=True)
    return times


def slice_config():
    """CocoInferenceConfig: ResNet-101, 81 classes, bf16, 1024² canvas,
    with masks decoded on the device for images up to 1024 px."""
    from maskrcnn_tpu_torch import CocoInferenceConfig
    return CocoInferenceConfig().replace(ORIG_MASK_CANVAS=1024)


def cfg_name(cfg) -> str:
    return f"{cfg.BACKBONE} {cfg.IMAGE_MAX_DIM}² {cfg.COMPUTE_DTYPE}"


def make_images(rng, shapes):
    return [rng.randint(0, 256, s + (3,), dtype=np.uint8) for s in shapes]


def slice_phase(kernels, cfg):
    """Phase 5: three requests through the Detector, with the kernels'
    launch counts and checks of every output."""
    from maskrcnn_tpu_torch.api import Detector
    t0 = time.perf_counter()
    det = Detector(cfg, device=DEVICE,
                   generator=torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    print(f"[5] Detector {cfg.BACKBONE} {cfg.COMPUTE_DTYPE} "
          f"{cfg.IMAGE_MAX_DIM}² on {DEVICE}, seeded init "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    # scale-1 images (min side >= IMAGE_MIN_DIM, max side <= the canvas):
    # no resample, padded windows of several shapes
    rng = np.random.RandomState(2)
    lo, hi = cfg.IMAGE_MIN_DIM, cfg.IMAGE_MAX_DIM
    shapes = [(lo, hi), (hi, hi)] + [
        tuple(int(v) for v in rng.randint(lo // 16, hi // 16 + 1, 2) * 16)
        for _ in range(6)]
    requests = [make_images(rng, shapes), make_images(rng, shapes[::-1]),
                make_images(rng, shapes[2:3])]

    kernels.roi_align.launches = 0
    kernels.nms.launches = 0
    counts = []
    outputs = []
    for images in requests:
        before = (kernels.roi_align.launches, kernels.nms.launches)
        handle = det.dispatch_batch(images)
        out = handle[0]
        results = det.fetch(handle)
        counts.append((kernels.roi_align.launches - before[0],
                       kernels.nms.launches - before[1]))
        outputs.append((images, out, results))
    launches = {"roi_align": kernels.roi_align.launches,
                "nms": kernels.nms.launches}

    d = cfg.DETECTION_MAX_INSTANCES
    for r, ((images, out, results), (k1, k2)) in enumerate(
            zip(outputs, counts)):
        b = len(images)
        check(k1 >= 2 and k2 >= 2,
              f"request {r}: kernel launches roi_align {k1}, nms {k2}")
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
        print(f"[5] request {r}: {b} images, detections {per_image}, "
              f"launches roi_align {k1} nms {k2}", flush=True)
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


def tiny_parity_phase():
    """Phase 5c: the port on the card against the port on the CPU, 128-px
    float32 config, TF32 off; the bar of the CPU parity tests."""
    from maskrcnn_tpu_torch import TinyConfig
    from maskrcnn_tpu_torch.detection.pipeline import predict_step
    from maskrcnn_tpu_torch.models.mask_rcnn import MaskRCNN
    cfg = TinyConfig().replace(DETECTION_MIN_CONFIDENCE=0.0)
    cpu = MaskRCNN(cfg, "cpu").init(torch.Generator().manual_seed(5))
    gpu = MaskRCNN(cfg, DEVICE)
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.RandomState(3)
    images = rng.randint(0, 256, (2, 128, 128, 3), dtype=np.uint8)
    windows = np.array([[0, 0, 128, 128], [16, 0, 112, 128]], np.float32)
    want = predict_step(cpu, torch.from_numpy(images),
                        torch.from_numpy(windows))
    got = predict_step(gpu, torch.from_numpy(images).to(DEVICE),
                       torch.from_numpy(windows).to(DEVICE))
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
    print(f"[5] tiny f32 predict_step cuda vs cpu: {total} valid, (class, "
          f"box) equal {share:.4f}, max |dscore| {dscore:.3g}, mask byte "
          f"mismatch {mism / max(nbytes, 1):.3g}", flush=True)


def timing_phase(det, images, card):
    """Phase 6: predict_step at B=8 and at B=1, the median of 5 calls
    after 2 warm-ups, each timed by CUDA events around the call. One B=8
    call first runs with synchronising calls turned into errors."""
    from maskrcnn_tpu_torch.detection.pipeline import predict_step
    batch, windows, _ = det._preprocess(images)
    x = torch.from_numpy(batch).to(DEVICE)
    win = torch.tensor(windows, dtype=torch.float32, device=DEVICE)
    for b in (len(images), 1):
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
        print(f"[6] predict_step B={b} {cfg_name(det.config)}: median {ms} "
              f"ms/batch ({b * 1000.0 / ms} img/s), runs {runs}, peak mem "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {card}",
              flush=True)
    return x, win


def profile_phase(det, x, win, out_dir):
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
    with open(os.path.join(out_dir, "predict_step_profile.txt"), "w") as f:
        f.write(table)
    trace = os.path.join(out_dir, "predict_step_trace.json")
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
    print(f"[6] profile: {len(spans)} kernels, device busy "
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
    nms_ms, nms_plain_ms = nms_phase(kernels, nms)

    cfg = slice_config()
    det, images, launches = slice_phase(kernels, cfg)
    run_err = intermediates_phase(det, images, kernels, roi, nms)
    tiny_parity_phase()
    x, win = timing_phase(det, images, card)
    if args.profile:
        profile_phase(det, x, win, args.profile)

    roi_ms, roi_plain_ms = roi_times[(torch.bfloat16, 7)]
    print(json.dumps({"kernels": [
        {"name": "roi_align", "route": "cuda",
         "source": "maskrcnn_tpu_torch/csrc/roi_align.cu",
         "replaces": "maskrcnn_tpu/ops/roi_align_pallas.py:58",
         "launches": launches["roi_align"],
         "max_abs_err": max(roi_err, run_err),
         "ms": roi_ms, "plain_ms": roi_plain_ms},
        {"name": "nms", "route": "cuda",
         "source": "maskrcnn_tpu_torch/csrc/nms.cu",
         "replaces": "maskrcnn_tpu/ops/nms_pallas.py:35",
         "launches": launches["nms"], "max_abs_err": 0.0,
         "ms": nms_ms, "plain_ms": nms_plain_ms}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
