#!/usr/bin/env python3
"""Time the full-width training step in two checkouts of the port on one
NVIDIA GPU, each run in a fresh process: chip_smoke.py's phase 7c
(CocoConfig, ResNet-101, 1024², bf16, REMAT_BACKBONE: 10 steps at B=1
and at B=4 through Trainer.fit, the median ms a step on the card's
timeline, peak memory, launches) and one more B=4 step under
torch.profiler (kernels, device busy time over the step's window).

    python3 tools/ab_train_torch.py ROOT_A ROOT_B [--order ABBA]
        [--no-strict B] [--out build/ab_train]

ROOT_A and ROOT_B are repository roots (e.g. a `git archive` of the
parent commit unpacked under build/, and `.`). --order names the runs
in turn (A, B, or C: ROOT_B with train_step's deterministic mode
replaced by a no-op, which prices the mode). Each run's lines are
printed after its letter; the profiles go under --out.
"""

import argparse
import os
import subprocess
import sys

CHILD = r"""
import contextlib, sys
root, out, strict = sys.argv[1], sys.argv[2], sys.argv[3] == "1"
sys.path.insert(0, root)
import torch
import chip_smoke as cs
assert cs.__file__.startswith(root)
from maskrcnn_tpu_torch import kernels
from maskrcnn_tpu_torch.train import step
if not strict:
    step.deterministic = contextlib.nullcontext
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
kernels.library()
card = cs.card_info()
run = cs.train_phase(kernels, card)
cs.profile_phase(run, "train_step B=4", out, "train_step")
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("root_a")
    ap.add_argument("root_b")
    ap.add_argument("--order", default="ABBA")
    ap.add_argument("--out", default="build/ab_train")
    args = ap.parse_args(argv)
    a, b = os.path.abspath(args.root_a), os.path.abspath(args.root_b)
    roots = {"A": a, "B": b, "C": b}
    for i, arm in enumerate(args.order):
        out = os.path.join(os.path.abspath(args.out), f"{i}{arm}")
        proc = subprocess.run(
            [sys.executable, "-c", CHILD, roots[arm], out,
             "0" if arm == "C" else "1"], cwd=roots[arm],
            capture_output=True, text=True)
        for line in proc.stdout.splitlines():
            if line.startswith(("[7c]", "[profile]", "NVIDIA")):
                print(f"[{arm}] {line}", flush=True)
        if proc.returncode:
            print(proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
