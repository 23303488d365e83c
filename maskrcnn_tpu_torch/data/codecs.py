"""Host-side image codec (counterpart of maskrcnn_tpu/data/codecs.py).

`resize_image` places an image on the canvas as the reference protocol
does (data.py:191-223): scale up so the short side reaches min_dim, cap
the long side at the canvas, PIL bilinear, centre-pad with zeros. It is
the JAX package's function line for line, so the port's canvases are
bit-equal to the JAX Detector's.

PIL is imported only when an image needs a resample: images at scale 1
are copied into the canvas without it, and the machine that serves may
not have Pillow.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _pil_image():
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            "resize_image needs Pillow to resample an image; images at "
            "scale 1 (short side >= IMAGE_MIN_DIM, long side within the "
            "canvas) need no resample and no Pillow") from e
    return Image


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
        image_cls = _pil_image()
        img = image_cls.fromarray(image).resize((nw, nh), image_cls.BILINEAR)
        image = np.asarray(img)
    else:
        nh, nw = h, w
    top = (ch - nh) // 2
    left = (cw - nw) // 2
    canvas = np.zeros((ch, cw, 3), np.uint8)
    canvas[top:top + nh, left:left + nw] = image
    return canvas, (top, left, top + nh, left + nw), scale
