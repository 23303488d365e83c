#!/usr/bin/env python3
"""The int8 serving path's accuracy at full width (the counterpart of
tools/tpu_int8_ap_gate.py), on the card.

Trains the full-width model (CocoInferenceConfig with 4 gt slots:
ResNet-101, 1024², 81 classes, bf16) from scratch on the one-class
rectangle scenes of tests/test_learning_ap.py scaled to 1024 px, 240
steps at B=8 from a pool of 10 batches held on the card, then evaluates
the same weights over 8 held-out PNG scenes as

    float (bf16) | int8 with int8 RoI tables | int8 with bf16 RoI tables

(4 calibration scenes, seeds 900 + i). Fails unless each quantized bbox
and segm AP50 is within 0.05 of float's. --runs N repeats the gate from
training on and records every run (the card's runs once differed:
K1-bwd and cuDNN added with float atomics; the training step is
deterministic now, and the runs show it).

    python tools/int8_ap_gate_torch.py [--steps 240] [--batch 8]
        [--runs 1] [--json-out FILE]

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


ARMS = ("float", "int8+roi8", "int8 bf16 RoI")


def gate_run(args, cfg):
    """One run: train, then the three arms over the 8 held-out scenes.
    Returns {"train", "arms"}."""
    pool = lt.device_pool(lt.train_batch, np.random.RandomState(3), cfg,
                          args.batch, 10, args.device)
    model, info = lt.train(cfg, pool, args.steps, args.device, lr=args.lr,
                           log_every=40, tag="one-class 1024")
    state = lt.float_state(model)
    del model, pool
    calib = lt.calib_scenes(lambda r: lt.scene(r, cfg)[0], 4)
    q = cfg.replace(QUANT_INT8=True)
    configs = {"float": (cfg, None), "int8+roi8": (q, calib),
               "int8 bf16 RoI": (q.replace(QUANT_INT8_ROI=False), calib)}
    arms = {}
    with tempfile.TemporaryDirectory() as td:
        root = lt.make_coco_dir(Path(td), cfg)
        for name in ARMS:
            t0 = time.perf_counter()
            config, frames = configs[name]
            det = lt.detector(config, state, args.device, frames)
            arms[name] = lt.evaluate(det, root, limit=8, batch_size=8)
            print(f"{name:14s} bbox AP50 {arms[name]['bbox']['AP50']:.3f}  "
                  f"segm AP50 {arms[name]['segm']['AP50']:.3f} "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
    return {"train": info, "arms": arms}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=lt.STEPS)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=lt.LR)
    ap.add_argument("--runs", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("int8_ap_gate_torch: no CUDA device", file=sys.stderr)
        return 1

    cfg = lt.full_config(MAX_GT_INSTANCES=4)
    record = {"card": lt.card_record(args.device), "steps": args.steps,
              "batch": args.batch, "runs": []}
    failed = []
    for run in range(args.runs):
        out = gate_run(args, cfg)
        record["runs"].append(out)
        if args.json_out:
            lt.write_record(args.json_out, record)
        arms = out["arms"]
        failed += [f"run {run + 1}: {name} {kind} AP50 "
                   f"{arms[name][kind]['AP50']:.3f} against float "
                   f"{arms['float'][kind]['AP50']:.3f}"
                   for name in ARMS[1:] for kind in ("bbox", "segm")
                   if arms[name][kind]["AP50"]
                   < arms["float"][kind]["AP50"] - 0.05]
    if failed:
        print(f"FAIL: {failed}", flush=True)
        return 1
    print("PASS: int8 (int8 and bf16 RoI tables) AP50 within 0.05 of float",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
