"""COCO RLE mask codec — standalone numpy implementation.

A copy of maskrcnn_tpu/eval/rle.py, held equal to it by
tests/test_torch_eval.py.

The environment has no pycocotools wheel, so this module reimplements the
COCO column-major RLE format from its specification (the reference vendors
the canonical C at cocoapi/common/maskApi.c; SURVEY.md section 2.2 maps it).
Everything operates on the interchange dict {'size': [h, w], 'counts':
bytes} used in COCO JSON and result files.

Format notes (must match the spec bit-for-bit to read real COCO
annotation files):
* runs are column-major (Fortran order), alternating background/
  foreground, starting with background;
* the string codec packs each count as little-endian 5-bit groups with a
  continuation bit, chars offset by 48 ('0'), with counts at index >= 3
  stored as deltas vs the count two positions back (maskApi.c:204-231);
* polygon rasterisation upsamples by 5, walks each edge along its
  dominant axis, keeps column-crossing boundary points, and integrates
  (maskApi.c:162-202) — reproduced exactly so gt masks match
  pycocotools'.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Union

import numpy as np

RLE = Dict  # {'size': [h, w], 'counts': bytes | List[int]}


# ---------------------------------------------------------------- codec --

def _counts_to_string(cnts: np.ndarray) -> bytes:
    out = bytearray()
    cnts = np.asarray(cnts, np.int64)
    for i in range(len(cnts)):
        x = int(cnts[i])
        if i > 2:
            x -= int(cnts[i - 2])
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = (x != -1) if (c & 0x10) else (x != 0)
            if more:
                c |= 0x20
            out.append(c + 48)
    return bytes(out)


def _string_to_counts(s: Union[bytes, str]) -> np.ndarray:
    if isinstance(s, str):
        s = s.encode("ascii")
    cnts: List[int] = []
    p = 0
    n = len(s)
    while p < n:
        x = 0
        k = 0
        more = True
        while more:
            c = s[p] - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            p += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(cnts) > 2:
            x += cnts[-2]
        cnts.append(x)
    return np.asarray(cnts, np.uint32)


def _rle_counts(rle: RLE) -> np.ndarray:
    c = rle["counts"]
    if isinstance(c, (bytes, str)):
        return _string_to_counts(c)
    return np.asarray(c, np.uint32)


# ------------------------------------------------------------- en/decode --

def encode(mask: np.ndarray) -> RLE:
    """Binary HxW mask -> compressed RLE (column-major runs).

    Uses the native C++ kernel (native/rle_kernels.cpp) when built,
    falling back to vectorized numpy.
    """
    from maskrcnn_tpu_torch.eval import native
    h, w = mask.shape[:2]
    flat = np.asarray(mask, np.uint8).flatten(order="F")
    if flat.size == 0:
        return {"size": [h, w], "counts": _counts_to_string(np.array([0]))}
    lengths = native.encode_counts(flat)
    if lengths is None:
        change = np.nonzero(np.diff(flat))[0]
        lengths = np.diff(np.concatenate([[-1], change, [flat.size - 1]]))
        if flat[0] != 0:  # runs start with a (possibly empty) bg run
            lengths = np.concatenate([[0], lengths])
    return {"size": [int(h), int(w)],
            "counts": _counts_to_string(lengths.astype(np.uint32))}


def decode(rle: RLE) -> np.ndarray:
    """RLE -> HxW uint8 mask."""
    h, w = rle["size"]
    cnts = _rle_counts(rle).astype(np.int64)
    vals = np.zeros(len(cnts), np.uint8)
    vals[1::2] = 1
    flat = np.repeat(vals, cnts)
    total = h * w
    if flat.size < total:
        flat = np.concatenate([flat, np.zeros(total - flat.size, np.uint8)])
    return flat[:total].reshape((h, w), order="F")


def area(rle: RLE) -> int:
    """Foreground pixel count (odd runs; maskApi.c:72-75)."""
    cnts = _rle_counts(rle).astype(np.int64)
    return int(cnts[1::2].sum())


def to_bbox(rle: RLE) -> np.ndarray:
    """RLE -> [x, y, w, h] tight box (maskApi.c:133-147 semantics)."""
    h, w = rle["size"]
    cnts = _rle_counts(rle).astype(np.int64)
    m = (len(cnts) // 2) * 2
    if m == 0 or h == 0:
        return np.zeros(4)
    cc = np.cumsum(cnts[:m])
    j = np.arange(m)
    t = cc - (j % 2)
    y = t % h
    x = (t - y) // h
    # fg run spanning multiple columns touches full rows
    start_x = x[0::2]
    end_x = x[1::2]
    spans = (end_x > start_x)
    ys = int(y.min()) if not spans.any() else 0
    ye = int(y.max()) if not spans.any() else h - 1
    xs = int(x.min())
    xe = int(x.max())
    return np.array([xs, ys, xe - xs + 1, ye - ys + 1], np.float64)


def merge(rles: Sequence[RLE], intersect: bool = False) -> RLE:
    """Union/intersection of masks (maskApi.c:49-70). Dense numpy merge —
    same result, simpler than the run-merge loop."""
    if len(rles) == 0:
        return {"size": [0, 0], "counts": b"0"}
    if len(rles) == 1:
        return dict(rles[0])
    acc = decode(rles[0]).astype(bool)
    for r in rles[1:]:
        m = decode(r).astype(bool)
        acc = (acc & m) if intersect else (acc | m)
    return encode(acc.astype(np.uint8))


# -------------------------------------------------------------- polygons --

def poly_to_rle(poly: Sequence[float], h: int, w: int) -> RLE:
    """Rasterise one polygon [x0, y0, x1, y1, ...] exactly like
    maskApi.c:162-202 rleFrPoly (5x upsample, dominant-axis edge walk,
    column-crossing integration)."""
    xy = np.asarray(poly, np.float64)
    k = len(xy) // 2
    scale = 5.0
    # C quantizes with (int)(v + .5): truncation toward zero, NOT floor —
    # they differ for negative (out-of-canvas) coordinates
    x = np.trunc(scale * xy[0::2] + 0.5).astype(np.int64)
    y = np.trunc(scale * xy[1::2] + 0.5).astype(np.int64)
    x = np.concatenate([x, x[:1]])
    y = np.concatenate([y, y[:1]])

    us: List[np.ndarray] = []
    vs: List[np.ndarray] = []
    for j in range(k):
        xs, xe, ys, ye = int(x[j]), int(x[j + 1]), int(y[j]), int(y[j + 1])
        dx, dy = abs(xe - xs), abs(ys - ye)
        flip = (dx >= dy and xs > xe) or (dx < dy and ys > ye)
        if flip:
            xs, xe, ys, ye = xe, xs, ye, ys
        if dx >= dy:
            s = (ye - ys) / dx if dx > 0 else 0.0
            d = np.arange(dx + 1)
            t = (dx - d) if flip else d
            us.append(t + xs)
            vs.append(np.trunc(ys + s * t + 0.5).astype(np.int64))
        else:
            s = (xe - xs) / dy if dy > 0 else 0.0
            d = np.arange(dy + 1)
            t = (dy - d) if flip else d
            vs.append(t + ys)
            us.append(np.trunc(xs + s * t + 0.5).astype(np.int64))
    u = np.concatenate(us)
    v = np.concatenate(vs)

    # boundary points where the x (column) changes, downsampled (the C
    # loop's float64 operations, in its order, over all points at once)
    u0, u1, v0, v1 = u[:-1], u[1:], v[:-1], v[1:]
    xd = np.where(u1 < u0, u1, u1 - 1).astype(np.float64)
    xd = (xd + 0.5) / scale - 0.5
    keep = (u1 != u0) & (np.floor(xd) == xd) & (xd >= 0) & (xd <= w - 1)
    yd = np.where(v1 < v0, v1, v0).astype(np.float64)
    yd = (yd + 0.5) / scale - 0.5
    yd = np.minimum(np.maximum(yd, 0.0), float(h))
    xs_list = xd[keep].astype(np.int64)
    ys_list = np.ceil(yd[keep]).astype(np.int64)

    # integrate: sorted crossing positions -> run boundaries
    a = np.concatenate([xs_list * h + ys_list, [h * w]]).astype(np.int64)
    a.sort()
    diffs = np.diff(np.concatenate([[0], a]))
    # collapse zero diffs by pairing (maskApi.c:198-200)
    b: List[int] = [int(diffs[0])]
    j = 1
    while j < len(diffs):
        if diffs[j] > 0:
            b.append(int(diffs[j]))
            j += 1
        else:
            j += 1
            if j < len(diffs):
                b[-1] += int(diffs[j])
                j += 1
    return {"size": [int(h), int(w)],
            "counts": _counts_to_string(np.asarray(b, np.uint32))}


def bbox_to_rle(bb, h: int, w: int) -> RLE:
    """xywh box -> RLE via its 4-gon (maskApi.c:149-156)."""
    xs, ys, bw, bh = [float(v) for v in bb]
    poly = [xs, ys, xs, ys + bh, xs + bw, ys + bh, xs + bw, ys]
    return poly_to_rle(poly, h, w)


def fr_py_objects(obj, h: int, w: int):
    """Convert polygons / uncompressed RLE / boxes to RLE(s)
    (pycocotools mask.frPyObjects surface; reference mask.py:30-46)."""
    if isinstance(obj, dict):
        if isinstance(obj["counts"], (list, np.ndarray)):
            return {"size": [int(h), int(w)],
                    "counts": _counts_to_string(
                        np.asarray(obj["counts"], np.uint32))}
        return dict(obj)
    if isinstance(obj, (list, tuple)) and len(obj) and \
            isinstance(obj[0], (list, tuple, np.ndarray)):
        return [poly_to_rle(p, h, w) for p in obj]
    if isinstance(obj, (list, tuple, np.ndarray)) and len(obj) and \
            not hasattr(obj[0], "__len__"):
        if len(obj) == 4:
            return bbox_to_rle(obj, h, w)
        return poly_to_rle(obj, h, w)
    raise TypeError(f"unsupported object {type(obj)}")


# ------------------------------------------------------------------ IoU --

def bb_iou(dt: np.ndarray, gt: np.ndarray,
           iscrowd: Sequence[int]) -> np.ndarray:
    """Box IoU, xywh, crowd gt uses det-area union (maskApi.c:109-120).

    Returns [m, n] (dt-major like pycocotools)."""
    dt = np.asarray(dt, np.float64).reshape(-1, 4)
    gt = np.asarray(gt, np.float64).reshape(-1, 4)
    m, n = len(dt), len(gt)
    o = np.zeros((m, n))
    for g in range(n):
        gx, gy, gw, gh = gt[g]
        ga = gw * gh
        crowd = bool(iscrowd[g]) if iscrowd is not None else False
        w = np.minimum(dt[:, 0] + dt[:, 2], gx + gw) - np.maximum(
            dt[:, 0], gx)
        h = np.minimum(dt[:, 1] + dt[:, 3], gy + gh) - np.maximum(
            dt[:, 1], gy)
        inter = np.where((w > 0) & (h > 0), w * h, 0.0)
        da = dt[:, 2] * dt[:, 3]
        u = da if crowd else da + ga - inter
        with np.errstate(divide="ignore", invalid="ignore"):
            o[:, g] = np.where(inter > 0, inter / u, 0.0)
    return o


def iou(dt, gt, iscrowd) -> np.ndarray:
    """pycocotools mask.iou: dt/gt are RLE lists or [N,4] xywh arrays.
    Crowd gt: union = area(dt). Returns [len(dt), len(gt)]."""
    if len(dt) == 0 or len(gt) == 0:
        return np.zeros((len(dt), len(gt)))
    if isinstance(dt, np.ndarray) or (isinstance(dt[0], (list, np.ndarray))
                                      and not isinstance(dt[0], dict)):
        return bb_iou(np.asarray(dt), np.asarray(gt), iscrowd)
    # RLE masks: native two-pointer run merge when built, else dense.
    from maskrcnn_tpu_torch.eval import native
    if native.available():
        out = native.iou_matrix([_rle_counts(r) for r in dt],
                                [_rle_counts(r) for r in gt], iscrowd)
        if out is not None:
            return out
    m, n = len(dt), len(gt)
    dmask = np.stack([decode(r).reshape(-1) for r in dt]).astype(np.float32)
    gmask = np.stack([decode(r).reshape(-1) for r in gt]).astype(np.float32)
    inter = dmask @ gmask.T  # [m, n]
    darea = dmask.sum(1)[:, None]
    garea = gmask.sum(1)[None, :]
    union = darea + garea - inter
    if iscrowd is not None:
        crowd = np.asarray(iscrowd, bool)[None, :]
        union = np.where(crowd, darea, union)
    with np.errstate(divide="ignore", invalid="ignore"):
        out = np.where(inter > 0, inter / union, 0.0)
    return out
