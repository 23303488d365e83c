#!/usr/bin/env python3
"""int8 accuracy by clip rule and by stage on trained weights (the
counterpart of tools/int8_ablation_gate.py), on the card.

On the single-stage weights of tools/protocol_ap_ab_torch.py (read with
--load-params, else trained with the same recipe), evaluates bbox and segm
AP, AP50 and AP75 over the held-out multiclass PNG set for:

  float            the reference accuracy
  amax-4f          amax clips, 4 calibration frames
  amax-32f         amax clips, 32 frames
  pct-32f          99.9th-percentile clips (Config.QUANT_CALIB)
  mse-32f          MSE-optimal clips (the default rule)
  mse-32f+fp-X     mse-32f with one stage group kept float
                   (Config.QUANT_SKIP: RPN, C4+C5, MASK, C2+C3, FPN), and
                   with float RoI tables (QUANT_INT8_ROI=False)

The calibration frames are training-distribution scenes, seeds 900 + i.

    python tools/int8_ablation_gate_torch.py --load-params DIR
        [--limit 16] [--calib-frames 32] [--skip-ablation] [--json-out FILE]

Fails unless the best int8 arm's bbox AP50 is within 0.05 of float's.
Imports torch, numpy and the port.
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

ABLATIONS = (("fp-ROI", dict(QUANT_INT8_ROI=False)),
             ("fp-RPN", dict(QUANT_SKIP=("RPN",))),
             ("fp-C45", dict(QUANT_SKIP=("C4", "C5"))),
             ("fp-MASK", dict(QUANT_SKIP=("MASK",))),
             ("fp-C23", dict(QUANT_SKIP=("C2", "C3"))),
             ("fp-FPN", dict(QUANT_SKIP=("FPN",))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=lt.STEPS)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--limit", type=int, default=16)
    ap.add_argument("--load-params", default=None, metavar="DIR",
                    help="DIR/single.pth of protocol_ap_ab_torch.py "
                    "--save-params (trained here when absent)")
    ap.add_argument("--calib-frames", type=int, default=32)
    ap.add_argument("--skip-ablation", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("int8_ablation_gate_torch: no CUDA device", file=sys.stderr)
        return 1

    cfg = lt.full_config()
    path = Path(args.load_params or ".") / "single.pth"
    if args.load_params and path.exists():
        state = lt.load_state_file(path)
        print(f"loaded {path}", flush=True)
    else:
        pool = lt.device_pool(lt.multiclass_train_batch,
                              np.random.RandomState(3), cfg, args.batch, 10,
                              args.device)
        model, _ = lt.train(cfg, pool, args.steps, args.device, log_every=40,
                            tag="single")
        state = lt.float_state(model)
        del model, pool

    def frames(n):
        return lt.calib_scenes(
            lambda r: lt.multiclass_scene(r, cfg.IMAGE_MAX_DIM)[0], n)

    calib4, calib32 = frames(4), frames(args.calib_frames)
    record = {"card": lt.card_record(args.device), "limit": args.limit,
              "calib_frames": args.calib_frames, "arms": {}}

    with tempfile.TemporaryDirectory() as td:
        root = lt.make_multiclass_coco_dir(Path(td), cfg,
                                           n_images=args.limit)

        def run(name, config, calib=None):
            t0 = time.perf_counter()
            det = lt.detector(config, state, args.device, calib)
            out = lt.evaluate(det, root, limit=args.limit, batch_size=8)
            record["arms"][name] = out
            print(f"{name:16s} " + "  ".join(
                f"{k} AP {v['AP']:.3f} AP50 {v['AP50']:.3f} AP75 "
                f"{v['AP75']:.3f}" for k, v in out.items())
                + f" ({time.perf_counter() - t0:.1f} s)", flush=True)
            if args.json_out:
                lt.write_record(args.json_out, record)

        q = cfg.replace(QUANT_INT8=True)
        run("float", cfg)
        run("amax-4f", q.replace(QUANT_CALIB="amax"), calib4)
        run("amax-32f", q.replace(QUANT_CALIB="amax"), calib32)
        run("pct-32f", q.replace(QUANT_CALIB="percentile"), calib32)
        run("mse-32f", q.replace(QUANT_CALIB="mse"), calib32)
        if not args.skip_ablation:
            for name, kw in ABLATIONS:
                run(f"mse-32f+{name}", q.replace(QUANT_CALIB="mse", **kw),
                    calib32)

    arms = record["arms"]
    print("\n| arm | bbox AP / AP50 / AP75 | segm AP / AP50 / AP75 |")
    print("|---|---|---|")
    for name, r in arms.items():
        b, s = r["bbox"], r["segm"]
        print(f"| {name} | {b['AP']:.3f} / {b['AP50']:.3f} / {b['AP75']:.3f}"
              f" | {s['AP']:.3f} / {s['AP50']:.3f} / {s['AP75']:.3f} |")
    best = max((r for k, r in arms.items() if k != "float"),
               key=lambda r: r["bbox"]["AP50"])
    if best["bbox"]["AP50"] < arms["float"]["bbox"]["AP50"] - 0.05:
        print("FAIL: no int8 arm within 0.05 of float's bbox AP50",
              flush=True)
        return 1
    print("PASS", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
