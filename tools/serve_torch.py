#!/usr/bin/env python
"""HTTP front end for the PyTorch/CUDA port (counterpart of
tools/serve.py): POST an image, get JSON detections. Requests are
coalesced into device batches by `maskrcnn_tpu_torch.serving
.BatchingDetector`.

    python tools/serve_torch.py [--model weights.pth] [--port 8500] [--tiny]
                                [--int8 [--int8-skip C4,C5]]
                                [--calib-stats stats.json]

    POST /detect   body: the bytes of an image file of any format the port
                   reads (data/image_io.py: JPEG, PNG, WebP, GIF, BMP, TIFF,
                   PPM/PGM/PBM/PFM, TGA, QOI, ICO, CUR, DIB, PCX, DCX, SGI,
                   Sun raster)
        -> {"detections": [{"class_id", "class_name", "score",
                            "box": [y1, x1, y2, x2],
                            "mask_rle": {"size", "counts"}}, ...]}
    GET /healthz   -> {"ok": true, "batches": N, "images": M}

The Detector runs on the card; --tiny runs TinyConfig on the CPU (the
smoke and test mode). A posted image file (a TIFF's first image, a DCX's
first page, an icon's largest entry, as Pillow reads them) is decoded
without Pillow
(maskrcnn_tpu_torch/data/image_io.py); a file it refuses is answered
500 with the reader's message (chip_smoke.py's phase 9d posts a JPEG, a
WebP and a TIFF).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def make_handler(batcher, class_names):
    from http.server import BaseHTTPRequestHandler

    from maskrcnn_tpu_torch.data.image_io import read_image
    from maskrcnn_tpu_torch.eval import rle as R

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, {"ok": True,
                                 "batches": batcher.batches_run,
                                 "images": batcher.images_run})
            else:
                self._send(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/detect":
                self._send(404, {"error": "not found"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                img = read_image(self.rfile.read(n))
                class_ids, scores, boxes, masks = batcher.detect(img)[:4]
                dets = []
                for i in range(len(class_ids or [])):
                    enc = R.encode(np.asarray(masks[i], np.uint8))
                    cid = int(class_ids[i])
                    dets.append({
                        "class_id": cid,
                        "class_name": (class_names[cid]
                                       if cid < len(class_names) else ""),
                        "score": float(scores[i]),
                        "box": [float(v) for v in boxes[i]],
                        "mask_rle": {"size": list(enc["size"]),
                                     "counts": enc["counts"].decode(
                                         "ascii")},
                    })
                self._send(200, {"detections": dets})
            except Exception as e:
                self._send(500, {"error": f"{type(e).__name__}: {e}"})

        def log_message(self, fmt, *args):  # quiet
            pass

    return Handler


def build_detector(args):
    """The Detector the flags describe."""
    from maskrcnn_tpu_torch.api import Detector
    from maskrcnn_tpu_torch.config import CocoInferenceConfig, TinyConfig

    # DEVICE_RESIZE: raw pixels go to the card and are placed there
    # (ops/image.batched_resize_pad); a batch with an image to downscale
    # takes the host resample
    config = (TinyConfig(DETECTION_MIN_CONFIDENCE=0.0) if args.tiny
              else CocoInferenceConfig(DEVICE_RESIZE=True))
    if args.int8:
        config = config.replace(QUANT_INT8=True)
        if args.int8_skip:
            config = config.replace(
                QUANT_SKIP=tuple(args.int8_skip.split(",")))
    det = Detector(config, "cpu" if args.tiny else None,
                   calib_stats_path=args.calib_stats)
    if os.path.exists(args.model):
        det.load_weights(args.model)
        print(f"loaded {args.model}")
    return det


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="models/mask_rcnn_coco.pth")
    ap.add_argument("--port", type=int, default=8500)
    ap.add_argument("--max-batch", type=int, default=32)
    ap.add_argument("--max-delay-ms", type=float, default=10.0)
    ap.add_argument("--tiny", action="store_true",
                    help="TinyConfig on the CPU (smoke and tests)")
    ap.add_argument("--int8", action="store_true",
                    help="int8 post-training quantization (QUANT_INT8)")
    ap.add_argument("--int8-skip", default=None, metavar="G,G",
                    help="with --int8: stage groups kept float "
                         "(Config.QUANT_SKIP), e.g. C4,C5")
    ap.add_argument("--calib-stats", default=None,
                    help="JSON file keeping the int8 calibration stats "
                         "across restarts (written on the first launch)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from http.server import ThreadingHTTPServer

    from maskrcnn_tpu_torch.data.coco import COCO_CLASS_NAMES
    from maskrcnn_tpu_torch.serving import BatchingDetector

    batcher = BatchingDetector(build_detector(args), args.max_batch,
                               args.max_delay_ms)
    server = ThreadingHTTPServer(
        ("0.0.0.0", args.port), make_handler(batcher, COCO_CLASS_NAMES))
    print(f"serving on :{args.port} (max_batch={args.max_batch}, "
          f"max_delay={args.max_delay_ms}ms)")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        batcher.close()


if __name__ == "__main__":
    main()
