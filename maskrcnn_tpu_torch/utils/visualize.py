"""Visualization: instance overlays and loss plots (counterpart of
maskrcnn_tpu/utils/visualize.py; reference: utils.py:294-488
display_instances/apply_mask/random_colors/plot_loss).

matplotlib is imported only where a figure is drawn, so the port imports
without it. `render_instances` draws with numpy alone (masks, box
outlines, keypoint dots on a uint8 array) for machines without
matplotlib; `data.image_io.write_png` writes its result.
"""

from __future__ import annotations

import colorsys
import random
import os
from typing import List, Optional, Sequence

import numpy as np


def random_colors(n: int, bright: bool = True, shuffle: bool = True):
    """n visually-distinct RGB tuples: evenly spaced hues at full
    saturation, optionally shuffled so adjacent instances differ
    (same contract as reference utils.py:294-305)."""
    value = 1.0 if bright else 0.7
    colors = [colorsys.hsv_to_rgb(hue, 1.0, value)
              for hue in np.linspace(0.0, 1.0, n, endpoint=False)]
    if shuffle:
        random.shuffle(colors)
    return colors


def apply_mask(image: np.ndarray, mask: np.ndarray, color,
               alpha: float = 0.5) -> np.ndarray:
    """Alpha-blend `color` into the masked pixels of an RGB uint8 image
    (same contract as reference utils.py:307-319), vectorized over the
    channel axis."""
    out = image.astype(np.float32)
    inside = np.asarray(mask) == 1
    rgb = np.asarray(color, np.float32) * 255.0
    out[inside] = out[inside] * (1.0 - alpha) + alpha * rgb
    return out.astype(np.uint8)


def _rgb(color) -> np.ndarray:
    return np.round(np.asarray(color, np.float32) * 255.0).astype(np.uint8)


def render_instances(image: np.ndarray, boxes, masks=None, keypoints=None,
                     colors=None, thickness: int = 1,
                     radius: int = 1) -> np.ndarray:
    """Instances drawn on a copy of `image` (RGB uint8 [H, W, 3]) with
    numpy alone: each mask blended in its instance's colour
    (`apply_mask`), each box outlined `thickness` pixels wide on its
    inside edge, each keypoint a filled dot of `radius` pixels in the
    colour, ringed in white.

    boxes: [N, 4] (y1, x1, y2, x2) in pixels, y2 and x2 exclusive; masks:
    [N, H, W] {0, 1} or None; keypoints: [N, K, 2 or 3] (y, x, ...) or
    None; colors: N RGB tuples in [0, 1] (default: `random_colors(N,
    shuffle=False)`). Returns the drawing, uint8 [H, W, 3]."""
    shown = np.array(image, dtype=np.uint8, copy=True)
    n = 0 if boxes is None else len(boxes)
    h, w = shown.shape[:2]
    colors = colors or random_colors(max(n, 1), shuffle=False)
    yy, xx = np.mgrid[-radius - 1:radius + 2, -radius - 1:radius + 2]
    disc = yy * yy + xx * xx <= radius * radius
    ring = (yy * yy + xx * xx <= (radius + 1) ** 2) & ~disc
    for i in range(n):
        rgb = _rgb(colors[i])
        if masks is not None:
            shown = apply_mask(shown, np.asarray(masks[i]), colors[i])
        y1, x1, y2, x2 = np.clip(np.round(np.asarray(boxes[i], np.float64)),
                                 0, [h, w, h, w]).astype(int)
        if y2 > y1 and x2 > x1:
            t = thickness
            shown[y1:min(y1 + t, y2), x1:x2] = rgb
            shown[max(y2 - t, y1):y2, x1:x2] = rgb
            shown[y1:y2, x1:min(x1 + t, x2)] = rgb
            shown[y1:y2, max(x2 - t, x1):x2] = rgb
        if keypoints is None:
            continue
        for y, x in np.round(np.asarray(keypoints[i])[:, :2]).astype(int):
            for mark, value in ((ring, 255), (disc, rgb)):
                ys, xs = y + yy[mark], x + xx[mark]
                keep = (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)
                shown[ys[keep], xs[keep]] = value
    return shown


def display_instances(image: np.ndarray, boxes, masks, class_ids,
                      class_names: Sequence[str],
                      scores: Optional[Sequence[float]] = None,
                      title: str = "", figsize=(16, 16), ax=None,
                      save_path: Optional[str] = None, keypoints=None):
    """Draw boxes, labels and mask contours (reference: utils.py:322-398).

    boxes: [N, 4] (y1, x1, y2, x2); masks: [N, H, W]; class_ids: [N];
    keypoints: optional [N, K, 3] (y, x, score), drawn as dots in each
    instance's colour. Saves to `save_path` when given, else shows the
    figure.
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib import patches

    n = 0 if boxes is None else len(boxes)
    if ax is None:
        _, ax = plt.subplots(1, figsize=figsize)
    colors = random_colors(max(n, 1))
    h, w = image.shape[:2]
    ax.set_ylim(h + 10, -10)
    ax.set_xlim(-10, w + 10)
    ax.axis("off")
    ax.set_title(title)

    shown = image.copy()
    for i in range(n):
        color = colors[i]
        y1, x1, y2, x2 = boxes[i]
        ax.add_patch(patches.Rectangle(
            (x1, y1), x2 - x1, y2 - y1, linewidth=2, alpha=0.7,
            linestyle="dashed", edgecolor=color, facecolor="none"))
        class_id = int(class_ids[i])
        score = scores[i] if scores is not None else None
        label = class_names[class_id] if class_id < len(class_names) \
            else str(class_id)
        caption = f"{label} {score:.3f}" if score else label
        ax.text(x1, y1 + 8, caption, color="w", size=11,
                backgroundcolor="none")
        if masks is not None:
            shown = apply_mask(shown, np.asarray(masks[i]), color)
        if keypoints is not None:
            kp = np.asarray(keypoints[i])
            ax.scatter(kp[:, 1], kp[:, 0], c=[color], s=14, marker="o",
                       edgecolors="w", linewidths=0.5)
    ax.imshow(shown)
    if save_path:
        plt.savefig(save_path, bbox_inches="tight")
        print(f"saved {save_path}")
    else:
        plt.show()
    plt.close("all")
    return shown


def plot_loss(loss_history: List[dict], val_loss_history: List[dict],
              save: bool = True, log_dir: str = "."):
    """One PNG a loss, training and validation curves by epoch
    (reference utils.py:401-488)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if not loss_history:
        return
    for key in loss_history[0]:
        plt.figure(key, figsize=(8, 5))
        plt.title(key)
        plt.plot([h[key] for h in loss_history], label="train")
        if val_loss_history:
            plt.plot([h.get(key, 0.0) for h in val_loss_history],
                     label="valid")
        plt.xlabel("epoch")
        plt.ylabel("loss")
        plt.legend()
        if save:
            plt.savefig(os.path.join(log_dir, f"{key}.png"))
        plt.close(key)
