"""High-level inference API (counterpart of maskrcnn_tpu/api.py).

`Detector` places images on the canvas on the host, runs
`predict_step` on its device, decodes masks to original-image
coordinates on the device (`masks_to_original`), and decodes boxes with
numpy, keeping the reference's `/(scale + 1e-5)` quirk. Covered: one
device, float, folded (FOLD_BN) or int8 (QUANT_INT8) weights, no
keypoints; images up to ORIG_MASK_CANVAS on a side.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Sequence

import numpy as np
import torch

from maskrcnn_tpu.config import Config
from maskrcnn_tpu_torch import quant
from maskrcnn_tpu_torch.checkpoint.convert import load_jax_params
from maskrcnn_tpu_torch.detection.pipeline import predict_step
from maskrcnn_tpu_torch.models.mask_rcnn import MaskRCNN
from maskrcnn_tpu_torch.ops import device_tensor
from maskrcnn_tpu_torch.ops.bits import pack_masks_device, unpack_masks
from maskrcnn_tpu_torch.ops.mask_paste import masks_to_original


def _load_calib_stats(path, key):
    """The stats under `key` in the JSON map at `path`; None when the
    file, or the key, is missing or the file is not a JSON map."""
    if not (path and os.path.exists(path)):
        return None
    try:
        with open(path) as f:
            return json.load(f).get(key)
    except (ValueError, AttributeError):
        return None


def _store_calib_stats(path, key, stats) -> None:
    """Merge {key: stats} into the JSON map at `path`, written atomically
    (temporary file and rename); entries that are not maps are dropped."""
    blob = {}
    if os.path.exists(path):
        try:
            with open(path) as f:
                loaded = json.load(f)
            if isinstance(loaded, dict):
                blob = {k: v for k, v in loaded.items() if isinstance(v, dict)}
        except ValueError:
            pass
    blob[key] = stats
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(os.path.abspath(path)),
                               suffix=".tmp")
    with os.fdopen(fd, "w") as f:
        json.dump(blob, f)
    os.replace(tmp, path)


def decode_boxes(boxes: np.ndarray, scale: float, window) -> np.ndarray:
    """Canvas coords -> original coords (reference data.py:331-343,
    including the scale + 1e-5 quirk)."""
    top, left = window[0], window[1]
    out = boxes.astype(np.float64) - np.array([top, left, top, left],
                                              np.float64)
    return out / (scale + 1e-5)


class Detector:
    """Stateful wrapper around `predict_step` on one device."""

    def __init__(self, config: Config, device="cpu",
                 generator: torch.Generator = None, calib_images=None,
                 calib_stats_path=None):
        """Random reference-init weights drawn from `generator` (a CPU
        generator; seed 0 when omitted). Load real weights afterwards
        with `load_jax_params`.

        Config.FOLD_BN (as maskrcnn_tpu.api.Detector) folds the frozen BN
        into the convs: the seeded float32 weights are folded before the
        cast to the compute dtype, and `load_jax_params` takes the
        ordinary, unfolded JAX tree and folds it on the way in.

        Config.QUANT_INT8 (as maskrcnn_tpu.api.Detector): the model is
        calibrated and quantized lazily, at `prepare` (the first request
        calls it), from the float32 weights. calib_images: [N, H, W, 3]
        uint8 canvases (default: quant.default_calib_canvases).
        calib_stats_path: a JSON file of calibration stats keyed by a
        weight fingerprint and the clip rule, the JAX Detector's format
        and key, so either package reads the other's stats and a hit
        skips calibration; a miss calibrates and merges into the file."""
        self.config = config
        self.device = torch.device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.model = MaskRCNN(config, self.device).init(generator)
        self._calib_images = calib_images
        self._calib_stats_path = calib_stats_path

    def load_jax_params(self, params) -> None:
        """Load a JAX parameter tree (nested dicts of arrays, the JAX
        package's layout). Under FOLD_BN it is folded in float32 first;
        an already folded tree folds to itself. Under QUANT_INT8 the next
        request prepares the new weights."""
        load_jax_params(self.model, params)

    def prepare(self) -> None:
        """Under QUANT_INT8, calibrate (or read the stats file) and put
        the int8 state on the device, once per set of weights. May wait
        on the device; the requests after it do not."""
        model = self.model
        if not self.config.QUANT_INT8 or model.quant is not None:
            return
        key = quant.stats_key(self.config, model.float_state)
        path = self._calib_stats_path
        stats = _load_calib_stats(path, key)
        if stats is None:
            calib = self._calib_images
            if calib is None:
                calib = quant.default_calib_canvases(self.config.IMAGE_SHAPE)
            stats = quant.calibrate(model, model.float_state, calib)
            if path:
                _store_calib_stats(path, key, stats)
        model.set_quant(quant.prepare_quant_params(
            model, model.float_state, act_stats=stats))

    @staticmethod
    def _canvas_geometry(h, w, min_dim, ch, cw):
        """Window and scale of data/codecs.resize_image, without the
        resample."""
        scale = max(1.0, min_dim / min(h, w))
        if round(h * scale) > ch or round(w * scale) > cw:
            scale = min(ch / h, cw / w)
        nh, nw = ((round(h * scale), round(w * scale))
                  if scale != 1.0 else (h, w))
        top = (ch - nh) // 2
        left = (cw - nw) // 2
        return (top, left, top + nh, left + nw), scale

    def _preprocess(self, images: Sequence[np.ndarray]):
        """Images -> (uint8 canvases [B, CH, CW, 3], windows, scales).
        Images at scale 1 are copied into the canvas; others go through
        the PIL resample of data/codecs, imported only then."""
        cfg = self.config
        ch, cw = int(cfg.IMAGE_SHAPE[0]), int(cfg.IMAGE_SHAPE[1])
        batch = np.zeros((len(images), ch, cw, 3), np.uint8)
        windows, scales = [], []
        for i, img in enumerate(images):
            window, scale = self._canvas_geometry(
                img.shape[0], img.shape[1], cfg.IMAGE_MIN_DIM, ch, cw)
            if scale != 1.0:
                from maskrcnn_tpu.data.codecs import resize_image
                batch[i] = resize_image(img, cfg.IMAGE_MIN_DIM,
                                        cfg.IMAGE_MAX_DIM,
                                        canvas_shape=(ch, cw))[0]
            else:
                top, left, bottom, right = window
                batch[i, top:bottom, left:right] = img
            windows.append(window)
            scales.append(scale)
        return batch, windows, scales

    def detect_batch(self, images: Sequence[np.ndarray]):
        """Batched detection -> per image (class_ids, scores, boxes, masks)
        in original coordinates, or None when nothing was found."""
        return self.fetch(self.dispatch_batch(images))

    def dispatch_batch(self, images: Sequence[np.ndarray]):
        """Preprocess and enqueue the device work without waiting for it
        (CUDA launches are asynchronous). Returns a handle for `fetch`."""
        cfg = self.config
        out_dim = cfg.ORIG_MASK_CANVAS
        if not cfg.DEVICE_MASK_DECODE or any(
                max(img.shape[:2]) > out_dim for img in images):
            raise ValueError(
                "Detector decodes masks on the device only: every image "
                f"side must be <= ORIG_MASK_CANVAS ({out_dim})")
        self.prepare()
        batch, windows, scales = self._preprocess(images)
        dev = self.device
        win = device_tensor(windows, torch.float32, dev)
        out = predict_step(self.model, torch.from_numpy(batch).to(dev), win)
        with torch.inference_mode():
            masks = unpack_masks(out["masks_packed"],
                                 cfg.IMAGE_SHAPE[1]).to(torch.bool)
            sizes = device_tensor([img.shape[:2] for img in images],
                                  torch.int64, dev)
            orig = torch.stack([
                masks_to_original(masks[i], win[i], sizes[i, 0],
                                  sizes[i, 1], out_dim)
                for i in range(len(images))])
            out["masks_packed"] = pack_masks_device(orig)
        return out, images, windows, scales

    def fetch(self, handle):
        """Wait for a dispatch_batch handle and decode on the host. Mask
        slots past the last valid detection of the batch are not copied
        (valid detections come first in the D slots)."""
        out, images, windows, scales = handle
        small = {k: out[k].cpu().numpy()
                 for k in ("class_ids", "scores", "boxes", "valid")}
        valid = small["valid"]
        used = np.flatnonzero(valid.any(axis=0))
        n = int(used[-1]) + 1 if used.size else 0
        packed = out["masks_packed"][:, :n].cpu().numpy()
        results = []
        for i, img in enumerate(images):
            v = valid[i]
            if not v.any():
                results.append(None)
                continue
            oh, ow = img.shape[:2]
            masks = np.unpackbits(packed[i][v[:n]], axis=-1)[:, :oh, :ow]
            results.append((small["class_ids"][i][v].tolist(),
                            small["scores"][i][v].tolist(),
                            decode_boxes(small["boxes"][i][v], scales[i],
                                         windows[i]).tolist(),
                            masks))
        return results
