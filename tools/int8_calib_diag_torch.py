#!/usr/bin/env python3
"""Where the int8 serving path's accuracy goes at full width: the
calibration subsample, the clip rule and the stage groups, on one set of
trained weights, on the card.

Trains tools/int8_ap_gate_torch.py's model (CocoInferenceConfig with 4 gt
slots, one-class rectangle scenes at 1024², 240 steps at B=8) once, then
evaluates its 8 held-out scenes (bbox AP50 and AP75, segm AP50) in float
and in int8 under:

  mse-4f           the port's calibration (quant.sample_stride)
  mse-4f JAX       the JAX package's subsample stride, numel // 16384
  mse-4f coprime   a stride coprime with the channel count
  amax-4f, pct-4f  the other clip rules
  mse-32f          32 calibration frames (the port's and the coprime
                   stride)
  mse-4f fp-X      one stage group kept float (Config.QUANT_SKIP)

The strides other than the port's are set by replacing
quant.sample_stride for that arm. A diagnosis, not a gate: it prints one
line an arm.

    python tools/int8_calib_diag_torch.py [--steps 240]

Imports torch, numpy and the port.
"""

from __future__ import annotations

import argparse
import math
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

import learning_torch as lt  # noqa: E402


def jax_stride(numel: int, channels: int, size: int) -> int:
    """maskrcnn_tpu/quant.py's subsample stride."""
    return max(1, numel // size)


def coprime_stride(numel: int, channels: int, size: int) -> int:
    """The next stride from numel // size that is coprime with C."""
    stride = max(1, numel // size)
    while math.gcd(stride, channels) != 1:
        stride += 1
    return stride


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=lt.STEPS)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("int8_calib_diag_torch: no CUDA device", file=sys.stderr)
        return 1
    from maskrcnn_tpu_torch import quant as pq

    cfg = lt.full_config(MAX_GT_INSTANCES=4)
    pool = lt.device_pool(lt.train_batch, np.random.RandomState(3), cfg, 8,
                          10, args.device)
    model, _ = lt.train(cfg, pool, args.steps, args.device, log_every=80,
                        tag="diag")
    state = lt.float_state(model)
    del model, pool
    calib4 = lt.calib_scenes(lambda r: lt.scene(r, cfg)[0], 4)
    calib32 = lt.calib_scenes(lambda r: lt.scene(r, cfg)[0], 32)
    port_stride = pq.sample_stride
    q = cfg.replace(QUANT_INT8=True)
    print(f"card: {lt.card_record(args.device)}", flush=True)
    with tempfile.TemporaryDirectory() as td:
        root = lt.make_coco_dir(Path(td), cfg)

        def run(name, config, calib, stride=port_stride):
            pq.sample_stride = stride
            try:
                r = lt.evaluate(lt.detector(config, state, args.device,
                                            calib), root, limit=8,
                                batch_size=8)
            finally:
                pq.sample_stride = port_stride
            print(f"DIAG {name:28s} bbox AP50 {r['bbox']['AP50']:.3f} AP75 "
                  f"{r['bbox']['AP75']:.3f} segm AP50 "
                  f"{r['segm']['AP50']:.3f}", flush=True)

        run("float", cfg, None)
        run("mse-4f", q, calib4)
        run("mse-4f JAX stride", q, calib4, jax_stride)
        run("mse-4f coprime stride", q, calib4, coprime_stride)
        run("amax-4f", q.replace(QUANT_CALIB="amax"), calib4)
        run("pct-4f", q.replace(QUANT_CALIB="percentile"), calib4)
        run("mse-32f", q, calib32)
        run("mse-32f coprime stride", q, calib32, coprime_stride)
        for skip in (("C2", "C3"), ("C4",), ("C5",), ("FPN",), ("RPN",),
                     ("MASK",)):
            run(f"mse-4f fp-{'+'.join(skip)}", q.replace(QUANT_SKIP=skip),
                calib4)
    return 0


if __name__ == "__main__":
    sys.exit(main())
