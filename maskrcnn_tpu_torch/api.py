"""High-level inference API (counterpart of maskrcnn_tpu/api.py).

`Detector` places images on the canvas on the host (`data.codecs`, no
Pillow) or, under DEVICE_RESIZE, on the device (`ops.image
.batched_resize_pad`), runs `predict_step` on its device and decodes
boxes with numpy, keeping the reference's `/(scale + 1e-5)` quirk. Masks
go back to original-image coordinates on the device
(`masks_to_original`) when every image of a request fits
ORIG_MASK_CANVAS and DEVICE_MASK_DECODE is set; otherwise on the host
(`codecs.decode_masks`, the reference-parity decode, each mask resampled
over its nonzero region only). Keypoints (NUM_KEYPOINTS) go back to
original coordinates on the host in float64. Covered: one device or
Config.NUM_DEVICES weight replicas (`_predict_replicas`), float,
folded (FOLD_BN) or int8 (QUANT_INT8) weights, and every inference
protocol of the JAX Detector (cascade, soft-NMS, flip TTA, keypoints,
rectangular canvases).
"""

from __future__ import annotations

import copy
import json
import os
import tempfile
from typing import Sequence

import numpy as np
import torch

from maskrcnn_tpu_torch.config import Config
from maskrcnn_tpu_torch import quant
from maskrcnn_tpu_torch.checkpoint.convert import (load_jax_params,
                                                  load_state, read_pth)
from maskrcnn_tpu_torch.data.codecs import (decode_boxes, decode_masks,
                                            resample_bilinear)
from maskrcnn_tpu_torch.detection.pipeline import predict_step
from maskrcnn_tpu_torch.models.mask_rcnn import MaskRCNN, resolve_device
from maskrcnn_tpu_torch.ops import device_tensor
from maskrcnn_tpu_torch.ops.bits import pack_masks_device, unpack_masks
from maskrcnn_tpu_torch.ops.image import batched_resize_pad, bucket_raws
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


def _original_keypoints(kp: np.ndarray, valid: np.ndarray, window,
                        scale: float) -> np.ndarray:
    """One image's canvas keypoints [n, K, 3] -> [valid.sum(), K, 3]
    float64 in original coordinates (maskrcnn_tpu/api.py:351-368): y and
    x less the window's top and left, over scale + 1e-5; rows of valid
    detections past the n keypoint slots are zero."""
    rows = kp[valid[:kp.shape[0]]].astype(np.float64)
    rows[..., 0] = (rows[..., 0] - window[0]) / (scale + 1e-5)
    rows[..., 1] = (rows[..., 1] - window[1]) / (scale + 1e-5)
    out = np.zeros((int(valid.sum()),) + rows.shape[1:], np.float64)
    out[:len(rows)] = rows
    return out


def _tree_to(tree, device):
    """A device state (dicts, tensors, quant.Scale) on another device."""
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, quant.Scale):
        return quant.Scale(tree.value, tree.tensor.to(device))
    return tree.to(device)


def replica_devices(n: int, device: torch.device):
    """The NUM_DEVICES devices of a data-parallel Detector: cuda:0..n-1
    for the card (all present, or it raises), or n times the CPU (the
    tests' stand-in)."""
    if device.type == "cpu":
        return [device] * n
    if torch.cuda.device_count() < n:
        raise RuntimeError(f"NUM_DEVICES={n} but {torch.cuda.device_count()} "
                           "CUDA device(s)")
    return [torch.device("cuda", i) for i in range(n)]


class Detector:
    """Stateful wrapper around `predict_step` on one device, or on
    Config.NUM_DEVICES devices, one weight replica each."""

    def __init__(self, config: Config, device=None,
                 generator: torch.Generator = None, calib_images=None,
                 calib_stats_path=None):
        """Random reference-init weights drawn from `generator` (a CPU
        generator; seed 0 when omitted). Load real weights afterwards
        with `load_weights` (a reference `.pth`) or `load_jax_params` (a
        JAX parameter tree). `device` defaults to the card ("cuda");
        without one it raises, unless given device="cpu".

        Config.FOLD_BN (as maskrcnn_tpu.api.Detector) folds the frozen BN
        into the convs: the seeded float32 weights are folded before the
        cast to the compute dtype, and `load_weights` and
        `load_jax_params` take ordinary, unfolded weights and fold them
        on the way in.

        Config.QUANT_INT8 (as maskrcnn_tpu.api.Detector): the model is
        calibrated and quantized lazily, at `prepare` (the first request
        calls it), from the float32 weights. calib_images: [N, H, W, 3]
        uint8 canvases (default: quant.default_calib_canvases).
        calib_stats_path: a JSON file of calibration stats keyed by a
        weight fingerprint and the clip rule, the JAX Detector's format
        and key, so either package reads the other's stats and a hit
        skips calibration; a miss calibrates and merges into the file."""
        self.config = config
        self.device = resolve_device(device)
        self._replicas = None
        if config.NUM_DEVICES > 1:
            self._replica_devices = replica_devices(config.NUM_DEVICES,
                                                    self.device)
            self.device = self._replica_devices[0]
            self._replicas = []
        # a token replaced at every change of weights (the replicas'
        # staleness check)
        self._weights = object()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.model = MaskRCNN(config, self.device).init(generator)
        self._calib_images = calib_images
        self._calib_stats_path = calib_stats_path
        # the fetch's device-to-host copies (`_to_host`)
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)

    def load_weights(self, path: str, reinit_mismatched: bool = False
                     ) -> None:
        """Load a reference `.pth` (the torch state dict of
        mask_rcnn_coco.pth; `torch.load` with weights_only). Under
        FOLD_BN it is folded in float32 first; under QUANT_INT8 the next
        request prepares the new weights. reinit_mismatched=True keeps the
        model's own values for tensors whose shape differs (fine-tuning
        to another NUM_CLASSES); without it they raise ValueError. A
        cascade or keypoint head the file lacks (the reference `.pth`
        has neither) keeps its initialization, and the branches are
        printed. An orbax directory raises: it needs orbax, a JAX
        library."""
        load_state(self.model,
                   read_pth(path, self.model.state_dict()),
                   reinit_mismatched=reinit_mismatched)
        self._weights = object()

    def load_jax_params(self, params) -> None:
        """Load a JAX parameter tree (nested dicts of arrays, the JAX
        package's layout). Under FOLD_BN it is folded in float32 first;
        an already folded tree folds to itself. Under QUANT_INT8 the next
        request prepares the new weights."""
        load_jax_params(self.model, params)
        self._weights = object()

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
        self._weights = object()

    @staticmethod
    def _canvas_geometry(h, w, min_dim, ch, cw):
        """Window and scale of data/codecs.resize_image."""
        scale = max(1.0, min_dim / min(h, w))
        if round(h * scale) > ch or round(w * scale) > cw:
            scale = min(ch / h, cw / w)
        nh, nw = ((round(h * scale), round(w * scale))
                  if scale != 1.0 else (h, w))
        top = (ch - nh) // 2
        left = (cw - nw) // 2
        return (top, left, top + nh, left + nw), scale

    def _preprocess(self, images: Sequence[np.ndarray]):
        """Images -> (uint8 canvases [B, CH, CW, 3] on the device, windows,
        scales).

        On the host each image is resampled to its window
        (codecs.resample_bilinear, as resize_image does) unless at scale
        1, and copied in. Under DEVICE_RESIZE, when no image of the batch
        needs a downscale, the raw pixels go to the device zero-padded
        into a [B, Hb, Wb, 3] bucket (Hb, Wb rounded up to multiples of
        64) and `batched_resize_pad` places them. A batch with an image
        to downscale takes the host path: that is the JAX package's
        routing rule (Config.DEVICE_RESIZE): the device resample
        reproduces Pillow's filter only for an upscale (support 1). A
        NUM_DEVICES Detector places on the host and returns the numpy
        canvases (`_predict_replicas` splits them), as the JAX Detector
        on a mesh does."""
        cfg = self.config
        ch, cw = int(cfg.IMAGE_SHAPE[0]), int(cfg.IMAGE_SHAPE[1])
        geoms = [self._canvas_geometry(img.shape[0], img.shape[1],
                                       cfg.IMAGE_MIN_DIM, ch, cw)
                 for img in images]
        windows = [g[0] for g in geoms]
        scales = [g[1] for g in geoms]
        dev = self.device
        if (cfg.DEVICE_RESIZE and self._replicas is None
                and all(s >= 1.0 for s in scales)):
            raws, sizes = bucket_raws(images)
            batch = batched_resize_pad(
                torch.from_numpy(raws).to(dev, non_blocking=True),
                device_tensor(windows, torch.int32, dev),
                device_tensor(sizes, torch.int32, dev), (ch, cw))
            return batch, windows, scales
        batch = np.zeros((len(images), ch, cw, 3), np.uint8)
        for i, (img, (top, left, bottom, right), scale) in enumerate(
                zip(images, windows, scales)):
            if scale != 1.0:
                img = resample_bilinear(img, bottom - top, right - left)
            batch[i, top:bottom, left:right] = img
        if self._replicas is not None:
            return batch, windows, scales
        batch = torch.from_numpy(batch)
        if dev.type == "cuda":
            # pinned and asynchronous: a copy from pageable memory would
            # hold the host until the card finishes the work queued before
            # it, so a dispatch could not run ahead of the previous batch
            batch = batch.pin_memory()
        return batch.to(dev, non_blocking=True), windows, scales

    def _replica_models(self):
        """The NUM_DEVICES models, replica 0 the Detector's own: the others
        are copies of its current weights (and of its prepared int8
        state and fused-block weights), made once per set of weights."""
        if self._replicas[1:] and self._replicas[1][1] is self._weights:
            return [m for m, _ in self._replicas]
        models = [(self.model, self._weights)]
        for dev in self._replica_devices[1:]:
            m = copy.deepcopy(self.model).to(dev)
            for mod in m.modules():
                if getattr(mod, "packed", None) is not None:
                    mod.packed = tuple(t.to(dev) for t in mod.packed)
            if m.quant is not None:
                m.quant = _tree_to(m.quant, dev)
            models.append((m, self._weights))
        self._replicas = models
        return [m for m, _ in models]

    def _predict_replicas(self, canvases: np.ndarray, windows):
        """Data-parallel predict_step over the NUM_DEVICES replicas (the
        JAX Detector's mesh predict, api.py:62-76, 185-203): the batch is
        padded to a multiple of NUM_DEVICES by repeating its last canvas,
        split in order, each part launched on its replica's device with no
        wait in between, and the outputs gathered on the first device,
        the padding dropped."""
        models = self._replica_models()
        n = len(models)
        b = canvases.shape[0]
        pad = (-b) % n
        win = np.asarray(windows, np.float32)
        if pad:
            canvases = np.concatenate([canvases, canvases[-1:].repeat(pad, 0)])
            win = np.concatenate([win, win[-1:].repeat(pad, 0)])
        per = canvases.shape[0] // n
        outs = []
        for i, m in enumerate(models):
            d = m.anchor_boxes.device
            part = torch.from_numpy(canvases[i * per:(i + 1) * per])
            wpart = torch.from_numpy(win[i * per:(i + 1) * per])
            if d.type == "cuda":
                part, wpart = part.pin_memory(), wpart.pin_memory()
            outs.append(predict_step(m, part.to(d, non_blocking=True),
                                     wpart.to(d, non_blocking=True)))
        return {k: torch.cat([o[k].to(self.device) for o in outs])[:b]
                for k in outs[0]}

    def detect(self, image: np.ndarray):
        """One image -> (class_ids, scores, boxes, masks) in original
        coordinates, or (None, None, None, None) when nothing is found
        (the reference contract, model.py:1120-1121). Under
        NUM_KEYPOINTS the tuple gains a fifth element, the keypoints."""
        out = self.detect_batch([image])[0]
        if out is None:
            return (None,) * (5 if self.config.NUM_KEYPOINTS > 0 else 4)
        return out

    def detect_batch(self, images: Sequence[np.ndarray]):
        """Batched detection -> per image (class_ids, scores, boxes, masks)
        in original coordinates, and under NUM_KEYPOINTS the keypoints
        [n, K, 3] (y, x, score), or None when nothing was found."""
        return self.fetch(self.dispatch_batch(images))

    def dispatch_batch(self, images: Sequence[np.ndarray]):
        """Preprocess and enqueue the device work without waiting for it
        (CUDA launches are asynchronous). Returns a handle for `fetch`.
        Masks are decoded to original coordinates on the device when
        DEVICE_MASK_DECODE is set and every image fits ORIG_MASK_CANVAS;
        otherwise the canvas masks stay packed for `fetch`'s host
        decode."""
        cfg = self.config
        out_dim = cfg.ORIG_MASK_CANVAS
        use_device = cfg.DEVICE_MASK_DECODE and all(
            max(img.shape[:2]) <= out_dim for img in images)
        self.prepare()
        batch, windows, scales = self._preprocess(images)
        dev = self.device
        win = device_tensor(windows, torch.float32, dev)
        if self._replicas is None:
            out = predict_step(self.model, batch, win)
        else:
            out = self._predict_replicas(batch, windows)
        if use_device:
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
        ready = None
        if dev.type == "cuda":
            ready = torch.cuda.Event()
            ready.record()
        return out, images, windows, scales, ready, use_device

    def _to_host(self, tensors, ready):
        """{name: device tensor} -> {name: numpy array}. On the card: on
        the copy stream, after `ready` (the dispatch's event), into pinned
        host buffers, then wait for the copy stream's own event."""
        if ready is None:
            return {k: v.cpu().numpy() for k, v in tensors.items()}
        stream = self._copy_stream
        with torch.cuda.stream(stream):
            stream.wait_event(ready)
            host = {k: torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                    .copy_(v, non_blocking=True)
                    for k, v in tensors.items()}
            done = torch.cuda.Event()
            done.record(stream)
        done.synchronize()
        return {k: v.numpy() for k, v in host.items()}

    def fetch(self, handle):
        """Wait for a dispatch_batch handle and decode on the host. Mask
        slots past the last valid detection of the batch are not copied
        (valid detections come first in the D slots; a valid slot past an
        invalid one is still copied). On the host-decode route each
        image's packed canvas masks go back to its original size through
        one `codecs.decode_masks` call, image after image (a thread pool
        over the images made the decode slower: its small tensor ops hold
        the interpreter lock between them; PERF.md has the times).
        Keypoints go to original coordinates in float64, as the JAX
        Detector maps them; detections past the keypoint slots get zero
        rows.

        On the card the copies run on the Detector's own copy stream,
        after the handle's event, into pinned buffers: a fetch from
        another thread (serving.BatchingDetector's fetcher) then overlaps
        the next batch's compute on the default stream, which a `.cpu()`
        on the shared default stream would queue behind."""
        out, images, windows, scales, ready, use_device = handle
        small = self._to_host({k: v for k, v in out.items()
                               if k != "masks_packed"}, ready)
        valid = small["valid"]
        used = np.flatnonzero(valid.any(axis=0))
        n = int(used[-1]) + 1 if used.size else 0
        packed = self._to_host({"m": out["masks_packed"][:, :n]}, ready)["m"]
        results = []
        for i, img in enumerate(images):
            v = valid[i]
            if not v.any():
                results.append(None)
                continue
            oh, ow = img.shape[:2]
            if use_device:
                masks = np.unpackbits(packed[i][v[:n], :oh], axis=-1,
                                      count=ow)
            else:
                masks = decode_masks(packed[i][v[:n]], scales[i], windows[i],
                                     oh, ow)
            res = (small["class_ids"][i][v].tolist(),
                   small["scores"][i][v].tolist(),
                   decode_boxes(small["boxes"][i][v], scales[i],
                                windows[i]).tolist(),
                   masks)
            if "keypoints" in small:
                res += (_original_keypoints(small["keypoints"][i], v,
                                            windows[i], scales[i]),)
            results.append(res)
        return results
