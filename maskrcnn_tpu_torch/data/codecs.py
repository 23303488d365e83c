"""Host-side image, box and mask codecs (counterpart of
maskrcnn_tpu/data/codecs.py), with no Pillow.

* `resample_bilinear` is Pillow's 8-bit BILINEAR resize (libImaging
  Resample.c: precompute_coeffs, normalize_coeffs_8bpc and the
  horizontal and vertical 8bpc passes), bit for bit: per axis a triangle
  filter widened by the downscale factor, float64 taps rounded to 22-bit
  fixed point, an integer sum per output rounded and clipped to uint8,
  the horizontal pass first. The sums run as torch int32 ops over the
  few taps of an output (never a dense [out, in] matrix).
* `resize_image` places an image on the canvas as the reference protocol
  does (data.py:191-223): scale up so the short side reaches min_dim,
  cap the long side at the canvas, resample, centre-pad with zeros. Its
  canvases are bit-equal to the JAX package's, which resizes with Pillow.
* `encode_boxes` and `encode_masks` (data.py:246-262, 317-328) put a
  training image's boxes and masks on the canvas, the masks resampled
  as 0/255 images and thresholded at 127;
* `decode_boxes` (data.py:331-343, including the /(scale + 1e-5) quirk)
  and `decode_masks` (data.py:265-284: crop the window, resample the
  crop to the original size, threshold at 127) undo the canvas; masks
  come bit-packed, as predict_step returns them.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

_PRECISION_BITS = 22  # Resample.c: 32 - 8 - 2


def _coeffs(in_size: int, out_size: int):
    """Resample.c's precompute_coeffs (triangle filter, support 1) and
    normalize_coeffs_8bpc for one axis: (xmin [out], xend [out], k [out,
    taps] int32). Output j reads inputs xmin[j] .. xend[j] - 1 with the
    fixed-point weights k[j] (0 past the window); xmin and xend never
    decrease with j."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    center = (np.arange(out_size, dtype=np.float64) + 0.5) * scale
    # C's (int) truncates toward zero
    xmin = np.maximum(np.trunc(center - support + 0.5), 0).astype(np.int64)
    xend = np.minimum(np.trunc(center + support + 0.5),
                      in_size).astype(np.int64)
    j = np.arange(ksize)[None, :]
    x = (j + xmin[:, None]).astype(np.float64)
    w = np.maximum(1.0 - np.abs((x - center[:, None] + 0.5)
                                * (1.0 / filterscale)), 0.0)
    w = np.where(j < (xend - xmin)[:, None], w, 0.0)
    # the C loop sums in tap order (float64 adds are not associative) and
    # divides by a nonzero sum only (a zero sum has only zero weights)
    ww = np.zeros(out_size)
    for t in range(ksize):
        ww = ww + w[:, t]
    w = w / np.where(ww == 0.0, 1.0, ww)[:, None]
    k = np.trunc(w * (1 << _PRECISION_BITS) + 0.5).astype(np.int32)
    return xmin, xend, k


def _pass(x: torch.Tensor, dim: int, xmin: np.ndarray, k: np.ndarray,
          offset: int = 0) -> torch.Tensor:
    """One 8bpc pass along `dim` of an int32 tensor of values 0..255,
    whose index 0 along `dim` is input `offset`: one output per row of
    (xmin, k). The tensor must hold every input the outputs' windows
    read; indices of zero-weight taps are clamped into it."""
    ksize = k.shape[1]
    idx = torch.from_numpy(np.minimum(
        xmin[:, None] - offset + np.arange(ksize), x.shape[dim] - 1))
    taps = x.index_select(dim, idx.view(-1)).unflatten(dim, (-1, ksize))
    shape = [1] * taps.dim()
    shape[dim:dim + 2] = k.shape
    acc = taps.mul_(torch.from_numpy(k).view(shape)).sum(
        dim + 1, dtype=torch.int32)
    acc += 1 << (_PRECISION_BITS - 1)
    return acc.bitwise_right_shift_(_PRECISION_BITS).clamp_(0, 255)


def _reach(coeffs, lo: int, hi: int):
    """The outputs [j0, j1) whose windows read any input in [lo, hi), and
    the inputs [i0, i1) their windows read; an axis that keeps its size
    (coeffs None) maps [lo, hi) to itself."""
    if coeffs is None:
        return lo, hi, lo, hi
    xmin, xend, _ = coeffs
    j0 = int(np.searchsorted(xend, lo, side="right"))
    j1 = int(np.searchsorted(xmin, hi, side="left"))
    return j0, j1, int(xmin[j0]), int(xend[j1 - 1])


def resample_bilinear(image_u8, out_h: int, out_w: int) -> np.ndarray:
    """uint8 [H, W] or [H, W, C] -> [out_h, out_w(, C)] uint8, equal to
    Pillow's `Image.resize((out_w, out_h), BILINEAR)` of that image: the
    horizontal pass first, and an axis that keeps its size is not
    resampled."""
    x = torch.from_numpy(np.asarray(image_u8).astype(np.int32))
    if x.shape[1] != out_w:
        xmin, _, k = _coeffs(x.shape[1], out_w)
        x = _pass(x, 1, xmin, k)
    if x.shape[0] != out_h:
        xmin, _, k = _coeffs(x.shape[0], out_h)
        x = _pass(x, 0, xmin, k)
    return x.to(torch.uint8).numpy()


def resize_image(image: np.ndarray, min_dim: int, max_dim: int,
                 canvas_shape: Tuple[int, int] = None,
                 scale_mult: float = 1.0
                 ) -> Tuple[np.ndarray, Tuple[int, int, int, int], float]:
    """uint8 HxWx3 -> (canvas [CH, CW, 3] uint8, window, scale).

    Default square canvas (CH = CW = max_dim); with `canvas_shape=(CH,
    CW)` the cap applies per axis. window = (y1, x1, y2, x2) of the real
    image inside the canvas. scale_mult: scale jitter applied to the
    protocol scale, still capped by the canvas fit and floored so at
    least 8 px of the short side survive.
    """
    h, w = image.shape[:2]
    ch, cw = canvas_shape if canvas_shape is not None else (max_dim,
                                                           max_dim)
    scale = max(1.0, min_dim / min(h, w))
    if scale_mult != 1.0:
        scale = max(scale * scale_mult, 8.0 / min(h, w))
    if round(h * scale) > ch or round(w * scale) > cw:
        scale = min(ch / h, cw / w)
    if scale != 1.0:
        nh, nw = round(h * scale), round(w * scale)
        image = resample_bilinear(image, nh, nw)
    else:
        nh, nw = h, w
    top = (ch - nh) // 2
    left = (cw - nw) // 2
    canvas = np.zeros((ch, cw, 3), np.uint8)
    canvas[top:top + nh, left:left + nw] = image
    return canvas, (top, left, top + nh, left + nw), scale


def encode_boxes(boxes: np.ndarray, scale: float, window) -> np.ndarray:
    """Original coords -> canvas coords (data.py:317-328)."""
    top, left = window[0], window[1]
    out = boxes * scale
    out[:, 0] += top
    out[:, 1] += left
    out[:, 2] += top
    out[:, 3] += left
    return out


def encode_masks(masks: np.ndarray, scale: float, window, max_dim: int,
                 canvas_shape: Tuple[int, int] = None) -> np.ndarray:
    """Instance masks [N, H, W] {0,1} -> canvas masks [N, CH, CW]
    (data.py:246-262; square CH = CW = max_dim by default): each mask as
    a 0/255 image resampled by `scale` (Pillow's bilinear, as
    `resample_bilinear`), thresholded at 127 and placed at the window.
    An output reads only the inputs of its window, and a zero window
    gives 0, so each mask is resampled over the reach of its pixels'
    bounding rows and columns only (as `decode_masks`), and an empty
    mask not at all."""
    n = masks.shape[0]
    ch, cw = canvas_shape if canvas_shape is not None else (max_dim,
                                                           max_dim)
    out = np.zeros((n, ch, cw), np.uint8)
    top, left = window[0], window[1]
    if n == 0:
        return out
    in_h, in_w = masks.shape[1:]
    nh, nw = round(in_h * scale), round(in_w * scale)
    ys = _coeffs(in_h, nh) if in_h != nh else None
    xs = _coeffs(in_w, nw) if in_w != nw else None
    h, w = min(nh, ch - top), min(nw, cw - left)
    for i in range(n):
        rows = np.flatnonzero(masks[i].any(axis=1))
        if not rows.size:
            continue
        cols = np.flatnonzero(masks[i].any(axis=0))
        oy0, oy1, iy0, iy1 = _reach(ys, rows[0], rows[-1] + 1)
        ox0, ox1, ix0, ix1 = _reach(xs, cols[0], cols[-1] + 1)
        x = torch.from_numpy(
            masks[i, iy0:iy1, ix0:ix1].astype(np.int32)) * 255
        if xs is not None:
            x = _pass(x, 1, xs[0][ox0:ox1], xs[2][ox0:ox1], ix0)
        if ys is not None:
            x = _pass(x, 0, ys[0][oy0:oy1], ys[2][oy0:oy1], iy0)
        arr = (x > 127).numpy()
        y1, x1 = min(oy1, h), min(ox1, w)
        if y1 > oy0 and x1 > ox0:
            out[i, top + oy0:top + y1, left + ox0:left + x1] = \
                arr[:y1 - oy0, :x1 - ox0]
    return out


def decode_boxes(boxes: np.ndarray, scale: float, window) -> np.ndarray:
    """Canvas coords -> original coords (data.py:331-343, including the
    scale + 1e-5 quirk)."""
    top, left = window[0], window[1]
    out = boxes.astype(np.float64) - np.array([top, left, top, left],
                                              np.float64)
    return out / (scale + 1e-5)


def decode_masks(packed: np.ndarray, scale: float, window,
                 orig_h: int, orig_w: int) -> np.ndarray:
    """Canvas masks, bit-packed along x ([N, CH, ceil(CW / 8)] uint8, as
    predict_step returns them; np.packbits order) -> original-size masks
    [N, oh, ow] uint8 0/1 (data.py:265-284: crop the window, resample the
    crop as a 0/255 image, threshold at 127), equal to resampling each
    whole crop. An output reads only the inputs of its window, and a
    zero window gives 0, so each mask is unpacked and resampled over the
    bounding rows and columns of its pixels in the window only, and an
    empty mask not at all. `scale` is unused, as in the reference: the
    window sets the crop."""
    top, left, bottom, right = window
    b0 = left // 8
    crop = packed[:, top:bottom, b0:-(-right // 8)]
    x0 = left - 8 * b0  # the window's first column in `crop`'s bits
    h, w = bottom - top, right - left
    out = np.zeros((len(crop), orig_h, orig_w), np.uint8)
    ys = _coeffs(h, orig_h) if h != orig_h else None
    xs = _coeffs(w, orig_w) if w != orig_w else None
    cols = np.unpackbits(np.bitwise_or.reduce(crop, axis=1),
                         axis=-1)[:, x0:x0 + w]
    # rows with a set byte: the edge bytes may hold columns outside the
    # window, so these rows bound the mask's rows from outside
    rows = crop.any(axis=2)
    for n in np.flatnonzero(cols.any(axis=1)):
        r = np.flatnonzero(rows[n])
        c = np.flatnonzero(cols[n])
        oy0, oy1, iy0, iy1 = _reach(ys, r[0], r[-1] + 1)
        ox0, ox1, ix0, ix1 = _reach(xs, c[0], c[-1] + 1)
        bits = np.unpackbits(crop[n, iy0:iy1], axis=-1)
        x = torch.from_numpy(
            bits[:, x0 + ix0:x0 + ix1].astype(np.int32)) * 255
        if xs is not None:
            x = _pass(x, 1, xs[0][ox0:ox1], xs[2][ox0:ox1], ix0)
        if ys is not None:
            x = _pass(x, 0, ys[0][oy0:oy1], ys[2][oy0:oy1], iy0)
        out[n, oy0:oy1, ox0:ox1] = (x > 127).numpy()
    return out
