#!/usr/bin/env python3
"""Time predict_step in two checkouts of the port on one NVIDIA GPU, in
turns A B B A, each in a fresh process: the default
CocoInferenceConfig Detector (seeded weights) on eight 1024x1024 random
canvases, B=1 and B=8, the host clock around synchronised calls (median
and quartiles of 30, what a lone request sees) and CUDA events around
10 calls queued behind a spinning kernel (the card's time).

    python3 tools/ab_trees.py ROOT_A ROOT_B [--out build/ab_trees.json]

ROOT_A and ROOT_B are repository roots (e.g. a `git archive` of the
parent commit unpacked under build/, and `.`). Prints one JSON line a
run and the card's name and power limit.
"""

import argparse
import json
import os
import subprocess
import sys

CHILD = r"""
import json, statistics, sys, time
sys.path.insert(0, sys.argv[1])
import numpy as np, torch
import maskrcnn_tpu_torch
assert maskrcnn_tpu_torch.__file__.startswith(sys.argv[1])
from maskrcnn_tpu_torch import CocoInferenceConfig
from maskrcnn_tpu_torch.api import Detector
from maskrcnn_tpu_torch.detection.pipeline import predict_step
det = Detector(CocoInferenceConfig(),
               generator=torch.Generator().manual_seed(0))
rng = np.random.RandomState(0)
imgs = [rng.randint(0, 256, (1024, 1024, 3), dtype=np.uint8)
        for _ in range(8)]
x, w, _ = det._preprocess(imgs)
win = torch.tensor(w, dtype=torch.float32).cuda()
out = {}
with torch.no_grad():
    for b in (1, 8):
        for _ in range(5):
            predict_step(det.model, x[:b], win[:b])
        torch.cuda.synchronize()
        host = []
        for _ in range(30):
            torch.cuda.synchronize()
            t = time.perf_counter()
            predict_step(det.model, x[:b], win[:b])
            torch.cuda.synchronize()
            host.append((time.perf_counter() - t) * 1e3)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(200_000_000)
        s.record()
        for _ in range(10):
            predict_step(det.model, x[:b], win[:b])
        e.record()
        torch.cuda.synchronize()
        out[f"B{b}_host_median_ms"] = statistics.median(host)
        out[f"B{b}_host_q1_q3_ms"] = [float(np.percentile(host, 25)),
                                      float(np.percentile(host, 75))]
        out[f"B{b}_queued_ms"] = s.elapsed_time(e) / 10
print("AB " + json.dumps(out), flush=True)
"""


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("root_a")
    ap.add_argument("root_b")
    ap.add_argument("--out", default="build/ab_trees.json")
    args = ap.parse_args()
    roots = {"A": os.path.abspath(args.root_a),
             "B": os.path.abspath(args.root_b)}
    runs = []
    for name in ("A", "B", "B", "A"):
        proc = subprocess.run([sys.executable, "-c", CHILD, roots[name]],
                              capture_output=True, text=True, timeout=900)
        line = [ln for ln in proc.stdout.splitlines()
                if ln.startswith("AB ")]
        if proc.returncode or not line:
            print(f"tree {name} failed:\n{proc.stderr[-3000:]}",
                  file=sys.stderr)
            return 1
        run = dict(json.loads(line[0][3:]), tree=name, root=roots[name])
        runs.append(run)
        print(json.dumps(run), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": card, "runs": runs}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
