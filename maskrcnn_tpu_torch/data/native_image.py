"""ctypes bridge to the port's native image decoder
(`maskrcnn_tpu_torch/csrc/image_decode.cpp`, host C++17).

On first use the source is compiled with the host's C++ compiler into
`build/maskrcnn_tpu_torch/` (`utils/native_build.py`) and loaded with
ctypes. A whole JPEG decode (markers, entropy decoding, IDCT, upsampling,
colour) runs in one call, as does a PNG's after zlib's inflate (the row
filters, Adam7, bit depths, palette and colour); ctypes releases the GIL
for the call, and zlib for the inflate, so decoder threads run in
parallel. There is no fallback: without a compiler `library()` raises a
RuntimeError naming it (the plain Python decoders of image_io.py, 56x
slower, are reached only by `read_image(..., plain=True)`).
"""

from __future__ import annotations

import ctypes
import struct
import subprocess
import threading
import zlib
from pathlib import Path
from typing import Optional

import numpy as np

from maskrcnn_tpu_torch.utils import native_build

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "image_decode.cpp"
# -fwrapv: the IDCT's int32 arithmetic wraps as libjpeg-turbo's does on
# the corrupt coefficients a valid file never holds
CXX_FLAGS = native_build.CXX_FLAGS + ("-fwrapv",)
PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# Pillow's decompression-bomb error: more pixels than twice
# Image.MAX_IMAGE_PIXELS
MAX_PIXELS = 2 * 89_478_485

_LIB: Optional[ctypes.CDLL] = None
_LOCK = threading.Lock()
_MSG_LEN = 512


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    return native_build.library_path("image_decode", SOURCE, CXX_FLAGS)


def library() -> ctypes.CDLL:
    """The decoder library, built on first use; a RuntimeError naming the
    compiler when it cannot be built or loaded."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        try:
            lib = native_build.load("image_decode", SOURCE, CXX_FLAGS)
        except (OSError, subprocess.SubprocessError) as e:
            detail = getattr(e, "stderr", b"") or b""
            raise RuntimeError(
                f"the native image decoder ({SOURCE.name}) could not be "
                f"built with the C++ compiler {native_build.compiler()!r} "
                f"or loaded: {e} {detail.decode(errors='replace')[-2000:]}"
            ) from e
        u8p = ctypes.c_char_p
        i32p = ctypes.POINTER(ctypes.c_int32)
        out = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        lib.mrt_jpeg_size.argtypes = [u8p, ctypes.c_int64, i32p, i32p,
                                      ctypes.c_char_p, ctypes.c_int32]
        lib.mrt_jpeg_decode.argtypes = [u8p, ctypes.c_int64, out,
                                        ctypes.c_int32, ctypes.c_int32,
                                        ctypes.c_char_p, ctypes.c_int32]
        lib.mrt_png_decode.argtypes = [
            u8p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, u8p,
            ctypes.c_int32, out, ctypes.c_char_p, ctypes.c_int32]
        for fn in (lib.mrt_jpeg_size, lib.mrt_jpeg_decode,
                   lib.mrt_png_decode):
            fn.restype = ctypes.c_int
        _LIB = lib
        return lib


def _raise(code: int, msg) -> None:
    text = msg.value.decode(errors="replace")
    if code == 2:
        raise NotImplementedError(text)
    raise ValueError(text)


def check_size(width: int, height: int) -> None:
    """A ValueError for an empty image or one past Pillow's
    decompression-bomb limit."""
    if width < 1 or height < 1 or width * height > MAX_PIXELS:
        raise ValueError(f"image size {width}x{height}: not 1 to "
                         f"{MAX_PIXELS} pixels")


def decode_jpeg(data: bytes) -> np.ndarray:
    """A JPEG file's bytes -> RGB uint8 [H, W, 3]."""
    lib = library()
    msg = ctypes.create_string_buffer(_MSG_LEN)
    h, w = ctypes.c_int32(), ctypes.c_int32()
    code = lib.mrt_jpeg_size(data, len(data), ctypes.byref(h),
                             ctypes.byref(w), msg, _MSG_LEN)
    if code:
        _raise(code, msg)
    check_size(w.value, h.value)
    out = np.empty((h.value, w.value, 3), np.uint8)
    code = lib.mrt_jpeg_decode(data, len(data), out, h.value, w.value, msg,
                               _MSG_LEN)
    if code:
        _raise(code, msg)
    return out


def decode_png(data: bytes) -> np.ndarray:
    """A PNG file's bytes -> RGB uint8 [H, W, 3]: the chunks read and the
    image data inflated here, the rest in one native call."""
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError("not a PNG file")
    lib = library()
    pos = len(PNG_SIGNATURE)
    header = palette = None
    idat = []
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            if len(body) < 13:
                raise ValueError("PNG: bad IHDR chunk")
            header = struct.unpack(">IIBBBBB", body[:13])
        elif kind == b"PLTE":
            palette = body[:len(body) // 3 * 3]
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG: no IHDR chunk")
    width, height, depth, color, _, _, interlace = header
    check_size(width, height)
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"PNG: bad image data: {e}") from None
    msg = ctypes.create_string_buffer(_MSG_LEN)
    out = np.empty((height, width, 3), np.uint8)
    entries = min(len(palette) // 3, 256) if palette is not None else 0
    code = lib.mrt_png_decode(raw, len(raw), width, height, depth, color,
                              interlace, palette, entries, out, msg,
                              _MSG_LEN)
    if code:
        _raise(code, msg)
    return out
