"""ctypes bridge to the native RLE kernels (counterpart of
maskrcnn_tpu/eval/native.py).

On first use `native/rle_kernels.cpp` (the JAX package's host library;
rle.py calls its run-length encode and its RLE IoU matrix) is compiled
with the host's C++ compiler into `build/maskrcnn_tpu_torch/` at the
repository root and loaded with ctypes (`utils/native_build.py`).
Nothing is written under `native/`.
This is a host library, not a device kernel. Without a compiler every
function returns None and `rle.py` takes its numpy route; `available()`
says which route is in use.
"""

from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path
from typing import List, Optional

import numpy as np

from maskrcnn_tpu_torch.utils import native_build

SOURCE = Path(__file__).resolve().parent.parent.parent / "native" / \
    "rle_kernels.cpp"

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    return native_build.library_path("rle_kernels", (SOURCE,))


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    try:
        lib = native_build.load("rle_kernels", (SOURCE,))
    except (OSError, subprocess.SubprocessError):
        return None
    u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    lib.rle_encode.argtypes = [u8p, ctypes.c_int64, u32p]
    lib.rle_encode.restype = ctypes.c_int
    lib.rle_iou_matrix.argtypes = [u32p, i64p, ctypes.c_int, u32p, i64p,
                                   ctypes.c_int, u8p, f64p]
    lib.rle_iou_matrix.restype = None
    _LIB = lib
    return _LIB


def available() -> bool:
    """True when the native library is built and loaded (the native
    route); False when rle.py runs its numpy route."""
    return _load() is not None


def encode_counts(flat_mask: np.ndarray) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    flat = np.ascontiguousarray(flat_mask, np.uint8)
    out = np.empty(flat.size + 1, np.uint32)
    k = lib.rle_encode(flat, flat.size, out)
    return out[:k].copy()


def iou_matrix(dt_counts: List[np.ndarray], gt_counts: List[np.ndarray],
               iscrowd) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    m, n = len(dt_counts), len(gt_counts)
    dcat = np.ascontiguousarray(
        np.concatenate(dt_counts) if m else np.empty(0), np.uint32)
    gcat = np.ascontiguousarray(
        np.concatenate(gt_counts) if n else np.empty(0), np.uint32)
    doff = np.zeros(m + 1, np.int64)
    np.cumsum([len(c) for c in dt_counts], out=doff[1:])
    goff = np.zeros(n + 1, np.int64)
    np.cumsum([len(c) for c in gt_counts], out=goff[1:])
    crowd = np.ascontiguousarray(
        np.asarray(iscrowd if iscrowd is not None else [0] * n, np.uint8))
    out = np.zeros(m * n, np.float64)
    lib.rle_iou_matrix(dcat, doff, m, gcat, goff, n, crowd, out)
    return out.reshape(m, n)
