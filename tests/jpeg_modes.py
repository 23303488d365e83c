"""Test-only writers of the JPEG modes Pillow reads but does not write,
through the libjpeg that Pillow bundles (libjpeg-turbo 3.1): arithmetic
coding (SOF9 sequential, SOF10 progressive, with DAC conditioning and
restart intervals), lossless frames (SOF3, predictors 1-7, point
transforms) and arithmetic transcodes of existing files, whose
coefficients, so whose pixels, are the file's own (jpegtran
-arithmetic), and gray files holding any coefficient blocks (to hold an
IDCT to libjpeg's). The writer is `tests/jpeg_modes.c`, compiled here with the
host's C compiler on first use into `build/tests/` and linked to
Pillow's libjpeg, whose `jpeg_aritab` (the QM coder's Qe table) `aritab`
also reads.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

TESTS = Path(__file__).resolve().parent
SOURCE = TESTS / "jpeg_modes.c"
BUILD = TESTS.parent / "build" / "tests"

# J_COLOR_SPACE
GRAY, RGB, YCBCR, CMYK, YCCK = 1, 2, 3, 4, 5

_LIB: Optional[ctypes.CDLL] = None


def pillow_libjpeg() -> str:
    """The path of the libjpeg that Pillow's wheel bundles."""
    import PIL
    libs = Path(PIL.__file__).resolve().parent.parent / "pillow.libs"
    found = glob.glob(str(libs / "libjpeg-*.so*"))
    if not found:
        raise RuntimeError(f"no libjpeg in {libs}")
    return found[0]


def library() -> ctypes.CDLL:
    """The writer, built first if it is not there."""
    global _LIB
    if _LIB is not None:
        return _LIB
    libjpeg = pillow_libjpeg()
    digest = hashlib.sha256(SOURCE.read_bytes() + libjpeg.encode())
    path = BUILD / f"libjpeg_modes_{digest.hexdigest()[:16]}.so"
    if not path.exists():
        BUILD.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=BUILD, suffix=".so.tmp")
        os.close(fd)
        cc = os.environ.get("CC") or shutil.which("gcc") or "cc"
        try:
            subprocess.run([cc, "-O1", "-shared", "-fPIC", "-o", tmp,
                            str(SOURCE), libjpeg,
                            f"-Wl,-rpath,{Path(libjpeg).parent}"],
                           check=True, capture_output=True, timeout=120)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    lib = ctypes.CDLL(str(path))
    out = [ctypes.POINTER(ctypes.POINTER(ctypes.c_ubyte)),
           ctypes.POINTER(ctypes.c_ulong), ctypes.c_char_p]
    lib.mrt_jpeg_write.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 9 + [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int] + out
    lib.mrt_jpeg_transcode.argtypes = [
        ctypes.c_void_p, ctypes.c_ulong, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p] + out
    lib.mrt_jpeg_free.argtypes = [ctypes.c_void_p]
    lib.mrt_jpeg_with_coefficients.argtypes = [
        ctypes.c_char_p, ctypes.c_ulong, ctypes.c_void_p,
        ctypes.c_void_p] + out
    _LIB = lib
    return lib


def _call(fn, *args) -> bytes:
    buf = ctypes.POINTER(ctypes.c_ubyte)()
    size = ctypes.c_ulong()
    err = ctypes.create_string_buffer(256)
    rc = fn(*args, ctypes.byref(buf), ctypes.byref(size), err)
    try:
        if rc:
            raise ValueError(err.value.decode())
        return ctypes.string_at(buf, size.value)
    finally:
        if buf:
            library().mrt_jpeg_free(buf)


def _dac(dac) -> Optional[bytes]:
    """(L, U, K) of tables 0 and 1 as 6 bytes, or None for the defaults."""
    return None if dac is None else bytes(v for t in dac for v in t)


def write(img: np.ndarray, *, space: int = None, quality: int = 85,
          arith: bool = False, progressive: bool = False, restart: int = 0,
          sampling: Sequence = None, dac=None, predictor: int = 0,
          point_transform: int = 0) -> bytes:
    """img (h, w) gray, (h, w, 3) RGB or (h, w, 4) CMYK as a JPEG in
    `space` (default: gray, YCbCr or CMYK). sampling: (h, v) a component
    (default 1x1). restart: an interval in MCUs, or (negative) in MCU
    rows. dac: ((L, U, K) of table 0, of table 1). predictor 1-7: a
    lossless frame with that predictor and point transform."""
    img = np.ascontiguousarray(img, np.uint8)
    comps = 1 if img.ndim == 2 else img.shape[2]
    in_space = {1: GRAY, 3: RGB, 4: CMYK}[comps]
    space = space or {1: GRAY, 3: YCBCR, 4: CMYK}[comps]
    if sampling is None:
        sampling = [(1, 1)] * comps
    flat = (ctypes.c_int * (2 * comps))(*[v for hv in sampling for v in hv])
    lib = library()
    return _call(lib.mrt_jpeg_write, img.ctypes.data, img.shape[1],
                 img.shape[0], comps, in_space, space, quality, int(arith),
                 int(progressive), restart, ctypes.cast(flat, ctypes.c_void_p),
                 _dac(dac), predictor, point_transform)


def transcode(data: bytes, *, arith: bool = True, progressive: bool = False,
              restart: int = 0, dac=None) -> bytes:
    """A JPEG's coefficients written again (arithmetic-coded by default)."""
    lib = library()
    return _call(lib.mrt_jpeg_transcode, data, len(data), int(arith),
                 int(progressive), restart, _dac(dac))


def with_coefficients(coefs: np.ndarray, quant: np.ndarray) -> bytes:
    """A gray JPEG of coefs.shape[0] x coefs.shape[1] blocks holding the
    quantized coefficients coefs [rows, cols, 64] (natural order) under
    the quantization table quant [64] (natural order, values up to
    65535), Huffman-coded with optimized tables (AC values within 1023,
    DC differences within 2047)."""
    from PIL import Image
    import io
    rows, cols = coefs.shape[:2]
    buf = io.BytesIO()
    Image.new("L", (cols * 8, rows * 8)).save(buf, "JPEG")
    base = buf.getvalue()
    coefs = np.ascontiguousarray(coefs, np.int16)
    quant = np.ascontiguousarray(quant, np.uint16)
    return _call(library().mrt_jpeg_with_coefficients, base, len(base),
                 coefs.ctypes.data, quant.ctypes.data)


def aritab() -> list:
    """jpeg_aritab of Pillow's libjpeg: the 114 packed entries (Qe << 16,
    next index after an MPS << 8, the switch bit << 7, next index after
    an LPS)."""
    lib = ctypes.CDLL(pillow_libjpeg())
    table = (ctypes.c_long * 114).in_dll(lib, "jpeg_aritab")
    return list(table)
