#!/usr/bin/env python3
"""AP of the port's inference protocols on trained weights (the
counterpart of tools/protocol_ap_ab.py), on the card.

Trains the full-width model (CocoInferenceConfig with 8 gt slots:
ResNet-101, 1024², 81 classes, bf16) from scratch on the multiclass
synthetic scenes (tests/synthetic_scenes.py: 4 classes, occlusion,
iscrowd), 240 steps at B=8 from a pool of 10 batches held on the card,
once single-stage and once with 3 cascade stages, then evaluates bbox and
segm AP, AP50 and AP75 over a held-out set of PNG files under each
protocol:

    baseline | TTA | soft-NMS 0.5 | TTA + soft-NMS | cascade

It also puts the held-out images through the baseline Detector at B=1
and at B=8 (cuDNN picks its bf16 algorithms by batch): AP at both, and
phase 5h's measures of the results (the images with the same class ids
and boxes, mask pixels apart, the largest score gap).

    python tools/protocol_ap_ab_torch.py [--steps 240] [--batch 8]
        [--limit 16] [--save-params DIR] [--load-params DIR]
        [--skip-cascade] [--json-out FILE]

--save-params writes single.pth / cascade.pth (float32 state) for
tools/int8_ablation_gate_torch.py --load-params; --load-params reads them
instead of training. Fails if the cascade's bbox AP75 falls more than
0.05 below the baseline's. Imports torch, numpy and the port.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

import learning_torch as lt  # noqa: E402

POOL = 10


def get_state(args, fname, cfg, make_pool, tag):
    """A trained float32 state: read from --load-params, else trained
    (and written to --save-params)."""
    if args.load_params and (Path(args.load_params) / fname).exists():
        print(f"[{tag}] loaded {Path(args.load_params) / fname}", flush=True)
        return lt.load_state_file(Path(args.load_params) / fname), None
    model, info = lt.train(cfg, make_pool(), args.steps, args.device,
                           lr=args.lr, log_every=40, tag=tag)
    state = lt.float_state(model)
    del model
    if args.save_params:
        lt.save_state(Path(args.save_params) / fname, state)
        print(f"[{tag}] saved {Path(args.save_params) / fname}", flush=True)
    return state, info


def batch_agreement(det, ds, limit):
    """The held-out images through det at B=8 and one at a time: images
    whose results have the same class ids and boxes, mask pixels apart
    among those, and the largest |score| gap."""
    images = [ds.load_image(i) for i in ds.ids[:limit]]
    b8 = []
    for start in range(0, len(images), 8):
        b8 += det.detect_batch(images[start:start + 8])
    b1 = [det.detect_batch([img])[0] for img in images]
    same = apart = pixels = 0
    gap = 0.0
    for a, b in zip(b8, b1):
        if a is None or b is None:
            same += a is None and b is None
            continue
        if (np.array_equal(np.asarray(a[0]), np.asarray(b[0]))
                and np.array_equal(np.asarray(a[2]), np.asarray(b[2]))):
            same += 1
            apart += int((np.asarray(a[3]) != np.asarray(b[3])).sum())
            pixels += np.asarray(a[3]).size
            gap = max(gap, float(np.abs(np.asarray(a[1], np.float64)
                                        - np.asarray(b[1])).max(initial=0)))
    return {"images": len(images), "same_detections": same,
            "mask_pixels_apart": apart / max(pixels, 1),
            "max_score_gap": gap,
            "detections_b8": [0 if r is None else len(r[0]) for r in b8],
            "detections_b1": [0 if r is None else len(r[0]) for r in b1]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=lt.STEPS)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=lt.LR)
    ap.add_argument("--limit", type=int, default=16,
                    help="held-out images")
    ap.add_argument("--save-params", default=None, metavar="DIR")
    ap.add_argument("--load-params", default=None, metavar="DIR")
    ap.add_argument("--skip-cascade", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("protocol_ap_ab_torch: no CUDA device", file=sys.stderr)
        return 1

    cfg = lt.full_config()
    cas = cfg.replace(CASCADE_STAGES=lt.CASCADE)

    def make_pool(c):
        return lambda: lt.device_pool(lt.multiclass_train_batch,
                                      np.random.RandomState(3), c,
                                      args.batch, POOL, args.device)

    record = {"card": lt.card_record(args.device), "steps": args.steps,
              "batch": args.batch, "limit": args.limit, "train": {},
              "arms": {}}
    single, record["train"]["single"] = get_state(
        args, "single.pth", cfg, make_pool(cfg), "single")
    cascade = None
    if not args.skip_cascade:
        cascade, record["train"]["cascade"] = get_state(
            args, "cascade.pth", cas, make_pool(cas), "cascade")

    def save():
        if args.json_out:
            lt.write_record(args.json_out, record)

    with tempfile.TemporaryDirectory() as td:
        root = lt.make_multiclass_coco_dir(Path(td), cfg,
                                           n_images=args.limit)

        def run(name, config, state):
            t0 = time.perf_counter()
            det = lt.detector(config, state, args.device)
            out = lt.evaluate(det, root, limit=args.limit, batch_size=8)
            record["arms"][name] = out
            print(f"{name:18s} " + "  ".join(
                f"{k} AP {v['AP']:.3f} AP50 {v['AP50']:.3f} AP75 "
                f"{v['AP75']:.3f}" for k, v in out.items())
                + f" ({time.perf_counter() - t0:.1f} s)", flush=True)
            save()
            return det

        base = run("baseline", cfg, single)
        run("tta", cfg.replace(TTA_HFLIP=True), single)
        run("soft-nms-0.5", cfg.replace(DETECTION_SOFT_NMS_SIGMA=0.5),
            single)
        run("tta+soft-nms", cfg.replace(TTA_HFLIP=True,
                                        DETECTION_SOFT_NMS_SIGMA=0.5), single)
        if cascade is not None:
            run("cascade", cas, cascade)

        # the same images at B=1 and at B=8
        from maskrcnn_tpu_torch.data.coco import CocoDataset
        ds = CocoDataset(root, "minival", 2014, cfg)
        b1 = lt.evaluate(base, root, limit=args.limit, batch_size=1)
        agree = batch_agreement(base, ds, args.limit)
        record["batch_check"] = {"b8": record["arms"]["baseline"],
                                 "b1": b1, **agree}
        print("B=1 against B=8: AP " + "  ".join(
            f"{k} {b1[k]['AP']:.3f} (B=8 "
            f"{record['arms']['baseline'][k]['AP']:.3f})" for k in b1)
            + f"; {agree['same_detections']} of {agree['images']} images "
            f"with the same class ids and boxes, "
            f"{agree['mask_pixels_apart']:.6f} of their mask pixels apart, "
            f"score gap {agree['max_score_gap']:.3g}", flush=True)
        save()

    arms = record["arms"]
    print("\n| protocol | bbox AP / AP50 / AP75 | segm AP / AP50 / AP75 |")
    print("|---|---|---|")
    for name, r in arms.items():
        b, s = r["bbox"], r["segm"]
        print(f"| {name} | {b['AP']:.3f} / {b['AP50']:.3f} / {b['AP75']:.3f}"
              f" | {s['AP']:.3f} / {s['AP50']:.3f} / {s['AP75']:.3f} |")
    if "cascade" in arms and (arms["cascade"]["bbox"]["AP75"]
                              < arms["baseline"]["bbox"]["AP75"] - 0.05):
        print("FAIL: the cascade's bbox AP75 regressed against the single "
              "head", flush=True)
        return 1
    print("PASS", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
