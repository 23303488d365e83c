"""Tensor canvas: tiled PNG renders of batched feature maps (counterpart
of maskrcnn_tpu/utils/canvas.py; reference tools/canvas.py:33-120).

Everything renders through matplotlib, imported only when a PNG is
written, so the port imports without it.
"""

from __future__ import annotations

import math
import os

import numpy as np


def make_grid(tensor, nrow: int = 8, padding: int = 2) -> np.ndarray:
    """[B, H, W] or [B, H, W, C] (numpy or a tensor) -> one tiled
    [H', W', C] image, min-max normalised; one channel is repeated to
    three."""
    if hasattr(tensor, "detach"):
        tensor = tensor.detach().cpu().numpy()
    t = np.asarray(tensor)
    if t.ndim == 3:
        t = t[..., None]
    b, h, w, c = t.shape
    ncol = min(nrow, b)
    nrows = math.ceil(b / ncol)
    lo, hi = t.min(), t.max()
    t = (t - lo) / (hi - lo + 1e-8)
    grid = np.zeros((nrows * (h + padding) - padding,
                     ncol * (w + padding) - padding, c), t.dtype)
    for i in range(b):
        r, col = divmod(i, ncol)
        grid[r * (h + padding):r * (h + padding) + h,
             col * (w + padding):col * (w + padding) + w] = t[i]
    if c == 1:
        grid = np.repeat(grid, 3, axis=-1)
    return grid


class Canvas:
    """Named drawing surface writing PNGs into `out_dir`."""

    def __init__(self, name: str = "canvas", out_dir: str = "."):
        self.name = name
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)

    def _save(self, image: np.ndarray, suffix: str) -> str:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        path = os.path.join(self.out_dir, f"{self.name}_{suffix}.png")
        plt.figure(figsize=(10, 10))
        plt.imshow(image)
        plt.axis("off")
        plt.savefig(path, bbox_inches="tight")
        plt.close()
        return path

    def draw_tensor(self, tensor, suffix: str = "tensor", nrow: int = 8):
        """BHWC, BHW or BCHW (torch layout) -> tiled grid PNG."""
        if hasattr(tensor, "detach"):
            tensor = tensor.detach().cpu().numpy()
        t = np.asarray(tensor)
        if t.ndim == 4 and t.shape[1] in (1, 3) and t.shape[-1] not in (1, 3):
            t = t.transpose(0, 2, 3, 1)
        return self._save(make_grid(t, nrow=nrow), suffix)

    def draw_image(self, image, suffix: str = "image") -> str:
        return self._save(np.asarray(image), suffix)


def tensor_show(tensor, name: str = "tensor", out_dir: str = ".") -> str:
    """One-shot helper (reference tools/canvas.py:116-120)."""
    return Canvas(name, out_dir).draw_tensor(tensor)
