#!/usr/bin/env python
"""Export the PyTorch/CUDA port's detection pipeline as a torch.export
program plus weights (the counterpart of tools/export_model.py, over
maskrcnn_tpu_torch/export.py):

    python tools/export_model_torch.py --out pipeline.pt2 --batch 8
    python tools/export_model_torch.py --out pipeline.pt2 --weights w.npz \
        --model mask_rcnn_coco.pth
    python tools/export_model_torch.py --out pipeline_int8.pt2 --int8 \
        --calib-stats scales.json

The program takes the weights as an input (`export.model_params`, or the
.npz sidecar through `export.params_from_npz`) and runs where it was
traced: on the card (the default) it calls K1, K2 and K4 (K3 under
FOLD_BN) as the custom ops of maskrcnn_tpu_torch.kernels.torch_ops, so
the loading process imports that module first; traced with --device cpu
it holds aten ops only. A runtime then needs no model code:

    from maskrcnn_tpu_torch import export
    run = export.load_exported("pipeline.pt2")
    out = run(export.params_from_npz("w.npz", "cuda"), images, windows)

The JAX tool's --platforms has no counterpart: torch.export traces on the
device it runs on (--device), and the flag is refused.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", required=True, help="program path")
    ap.add_argument("--weights", default=None,
                    help="also write the .npz weight sidecar here")
    ap.add_argument("--model", default="",
                    help="reference-layout .pth weights to load; random "
                         "init if absent")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--canvas", default=None,
                    help="H,W rectangular canvas (default square "
                         "IMAGE_MAX_DIM)")
    ap.add_argument("--int8", action="store_true",
                    help="export the QUANT_INT8 serving pipeline")
    ap.add_argument("--calib-stats", default=None,
                    help="persisted int8 calibration stats json")
    ap.add_argument("--platforms", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--device", default="cuda",
                    help="torch device to trace on (default=cuda)")
    return ap


def main(argv=None) -> str:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.platforms is not None:
        parser.error("--platforms has no counterpart in the port: "
                     "torch.export traces on the device it runs on "
                     "(--device)")

    from maskrcnn_tpu_torch import export as ex
    from maskrcnn_tpu_torch.api import Detector
    from maskrcnn_tpu_torch.config import CocoInferenceConfig

    overrides = {}
    if args.canvas:
        h, w = (int(v) for v in args.canvas.split(","))
        overrides["IMAGE_CANVAS"] = (h, w)
    if args.int8:
        overrides["QUANT_INT8"] = True
    cfg = CocoInferenceConfig(**overrides)
    det = Detector(cfg, device=args.device,
                   calib_stats_path=args.calib_stats)
    if args.model and os.path.exists(args.model):
        det.load_weights(args.model)
        print(f"loaded weights: {args.model}")
    # QUANT_INT8: calibrate (or read --calib-stats) and quantize
    det.prepare()

    ex.save_exported(det.model, args.batch, args.out)
    size = os.path.getsize(args.out)
    print(f"program: {args.out} ({size / 1e6:.1f} MB, batch={args.batch}, "
          f"traced on {det.device})")
    if args.weights:
        ex.params_to_npz(ex.model_params(det.model), args.weights)
        print(f"weights sidecar: {args.weights} "
              f"({os.path.getsize(args.weights) / 1e6:.1f} MB)")
    return args.out


if __name__ == "__main__":
    main()
