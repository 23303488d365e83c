"""AVIF files and oracles the tests of the port's AVIF reader need, from
Pillow's bundled libavif 1.3 (libavif-*.so beside Pillow, holding aom for
encoding and dav1d for decoding) by ctypes: what Pillow's AVIF writer does
not write (10-bit data, grid items, superres, an image added as a
sequence's frame), the YUV planes avifDecoderRead gives (the decoder's
output before colour conversion), and avifImageYUVToRGB of any 8-bit
planes under any CICP (the colour conversion alone).

The avifImage and avifRGBImage fields are set at their offsets in libavif
1.3's structs (width, height, depth and yuvFormat first; yuvRange at 16,
alphaPremultiplied at 80, the CICP at 104, 106 and 108; avifRGBImage's
depth at 8, format at 12, pixels at 48, rowBytes at 56), which
`check_layout` verifies against avifImageCreate's and
avifRGBImageSetDefaults's values before anything is written. Import PIL
first: the library is loaded from Pillow's wheel.
"""

from __future__ import annotations

import ctypes
import glob
import os
import struct

import numpy as np

_LIB = None
_VP = ctypes.c_void_p
FORMATS = {"444": 1, "422": 2, "420": 3, "400": 4}


class RWData(ctypes.Structure):
    _fields_ = [("data", ctypes.POINTER(ctypes.c_uint8)),
                ("size", ctypes.c_size_t)]


def library():
    """Pillow's bundled libavif, or None where Pillow has no AVIF."""
    global _LIB
    if _LIB is not None:
        return _LIB
    try:
        import PIL
        from PIL import features
    except ImportError:
        return None
    if not features.check("avif"):
        return None
    libs = os.path.join(os.path.dirname(os.path.dirname(PIL.__file__)),
                        "pillow.libs")
    found = sorted(glob.glob(os.path.join(libs, "libavif-*.so*")))
    if not found:
        return None
    lib = ctypes.CDLL(found[0])
    lib.avifDecoderCreate.restype = _VP
    lib.avifEncoderCreate.restype = _VP
    lib.avifImageCreateEmpty.restype = _VP
    lib.avifImageCreate.restype = _VP
    lib.avifImageCreate.argtypes = [ctypes.c_uint32] * 3 + [ctypes.c_int]
    lib.avifDecoderReadMemory.argtypes = [_VP, _VP, ctypes.c_char_p,
                                          ctypes.c_size_t]
    lib.avifImagePlane.restype = ctypes.POINTER(ctypes.c_uint8)
    lib.avifImagePlane.argtypes = [_VP, ctypes.c_int]
    for name in ("avifImagePlaneRowBytes", "avifImagePlaneWidth",
                 "avifImagePlaneHeight"):
        getattr(lib, name).restype = ctypes.c_uint32
        getattr(lib, name).argtypes = [_VP, ctypes.c_int]
    lib.avifImageAllocatePlanes.argtypes = [_VP, ctypes.c_int]
    lib.avifRGBImageSetDefaults.argtypes = [_VP, _VP]
    lib.avifRGBImageAllocatePixels.argtypes = [_VP]
    lib.avifRGBImageFreePixels.argtypes = [_VP]
    lib.avifImageYUVToRGB.argtypes = [_VP, _VP]
    lib.avifDecoderDestroy.argtypes = [_VP]
    lib.avifEncoderDestroy.argtypes = [_VP]
    lib.avifImageDestroy.argtypes = [_VP]
    lib.avifResultToString.restype = ctypes.c_char_p
    lib.avifEncoderWrite.argtypes = [_VP, _VP, ctypes.POINTER(RWData)]
    lib.avifEncoderAddImage.argtypes = [_VP, _VP, ctypes.c_uint64,
                                        ctypes.c_int]
    lib.avifEncoderAddImageGrid.argtypes = [_VP, ctypes.c_uint32,
                                            ctypes.c_uint32, _VP, ctypes.c_int]
    lib.avifEncoderFinish.argtypes = [_VP, ctypes.POINTER(RWData)]
    lib.avifEncoderSetCodecSpecificOption.argtypes = [_VP, ctypes.c_char_p,
                                                      ctypes.c_char_p]
    lib.avifRWDataFree.argtypes = [ctypes.POINTER(RWData)]
    _LIB = lib
    check_layout(lib)
    return lib


def check_layout(lib) -> None:
    """The struct offsets this module writes, against the values
    avifImageCreate and avifRGBImageSetDefaults leave there."""
    img = lib.avifImageCreate(3, 2, 8, FORMATS["420"])
    try:
        got = [ctypes.c_uint32.from_address(img + o).value
               for o in (0, 4, 8, 12, 16)]
        cicp = [ctypes.c_uint16.from_address(img + o).value
                for o in (104, 106, 108)]
        if got != [3, 2, 8, 3, 1] or cicp != [2, 2, 2]:
            raise RuntimeError(f"libavif's avifImage layout: {got} {cicp}")
        rgb = ctypes.create_string_buffer(64)
        lib.avifRGBImageSetDefaults(rgb, img)
        if [ctypes.c_uint32.from_buffer(rgb, o).value
                for o in (0, 4, 8)] != [3, 2, 8]:
            raise RuntimeError("libavif's avifRGBImage layout")
    finally:
        lib.avifImageDestroy(img)


def _result(lib, code) -> None:
    if code:
        raise ValueError(lib.avifResultToString(code).decode())


def decode_yuv(data: bytes):
    """avifDecoderRead: the planes (Y, U, V, A; None where absent) of the
    primary image, 8-bit, as dav1d decodes them."""
    lib = library()
    dec, img = lib.avifDecoderCreate(), lib.avifImageCreateEmpty()
    try:
        _result(lib, lib.avifDecoderReadMemory(dec, img, data, len(data)))
        out = []
        for ch in range(4):
            p = lib.avifImagePlane(img, ch)
            if not p:
                out.append(None)
                continue
            w = lib.avifImagePlaneWidth(img, ch)
            h = lib.avifImagePlaneHeight(img, ch)
            rb = lib.avifImagePlaneRowBytes(img, ch)
            out.append(np.ctypeslib.as_array(p, (h * rb,)).reshape(
                h, rb)[:, :w].copy())
        return out
    finally:
        lib.avifImageDestroy(img)
        lib.avifDecoderDestroy(dec)


def _image(planes, sub: str, depth: int = 8, alpha=None, full=True,
           cicp=(2, 2, 6), premultiplied=False):
    """An avifImage holding `planes` (Y[, U, V]) and alpha."""
    lib = library()
    h, w = planes[0].shape
    img = lib.avifImageCreate(w, h, depth, FORMATS[sub])
    ctypes.c_int.from_address(img + 16).value = 1 if full else 0
    for off, v in zip((104, 106, 108), cicp):
        ctypes.c_uint16.from_address(img + off).value = v
    lib.avifImageAllocatePlanes(img, 1 if alpha is None else 0xFF)
    chans = list(planes) + ([None] * (3 - len(planes)) + [alpha]
                            if alpha is not None else [])
    dtype = np.uint8 if depth == 8 else np.uint16
    for ch, p in enumerate(chans):
        if p is None:
            continue
        ptr = lib.avifImagePlane(img, ch)
        rb = lib.avifImagePlaneRowBytes(img, ch)
        ph, pw = p.shape
        rows = np.ctypeslib.as_array(ptr, (ph * rb,)).reshape(ph, rb)
        rows[:, :pw * dtype().itemsize] = np.ascontiguousarray(
            p, dtype).view(np.uint8).reshape(ph, -1)
    if alpha is not None:
        ctypes.c_int.from_address(img + 80).value = int(premultiplied)
    return img


def yuv_to_rgb(planes, sub: str, matrix: int, full: bool,
               primaries: int = 1, alpha=None, premultiplied=False):
    """avifImageYUVToRGB of 8-bit planes into 8-bit RGB (RGBA where
    `alpha` is given) at avifRGBImageSetDefaults's settings, as Pillow
    converts; a ValueError naming libavif's result where it fails."""
    lib = library()
    img = _image(planes, sub, alpha=alpha, full=full,
                 cicp=(primaries, 2, matrix), premultiplied=premultiplied)
    h, w = planes[0].shape
    rgb = ctypes.create_string_buffer(64)
    try:
        lib.avifRGBImageSetDefaults(rgb, img)
        ctypes.c_uint32.from_buffer(rgb, 8).value = 8
        channels = 3 if alpha is None else 4
        ctypes.c_int.from_buffer(rgb, 12).value = 0 if alpha is None else 1
        lib.avifRGBImageAllocatePixels(rgb)
        try:
            _result(lib, lib.avifImageYUVToRGB(img, rgb))
            pixels = ctypes.c_void_p.from_buffer(rgb, 48).value
            rb = ctypes.c_uint32.from_buffer(rgb, 56).value
            buf = (ctypes.c_uint8 * (h * rb)).from_address(pixels)
            return np.ctypeslib.as_array(buf).reshape(h, rb)[
                :, :w * channels].reshape(h, w, channels).copy()
        finally:
            lib.avifRGBImageFreePixels(rgb)
    finally:
        lib.avifImageDestroy(img)


def _finish(lib, enc, write) -> bytes:
    out = RWData()
    try:
        _result(lib, write(ctypes.byref(out)))
        return ctypes.string_at(out.data, out.size)
    finally:
        lib.avifRWDataFree(ctypes.byref(out))


def encode(planes, sub: str = "420", depth: int = 8, options=None,
           sequence_frame: bool = False) -> bytes:
    """An AVIF of the planes (Y[, U, V], 8-bit or 16-bit values) by
    libavif's encoder (aom) at its defaults: avifEncoderWrite, or with
    `sequence_frame` the image added as a frame (flags 0) and finished,
    which encodes it in aom's good-quality usage; `options`: aom's
    codec-specific options."""
    lib = library()
    img = _image(planes, sub, depth=depth)
    enc = lib.avifEncoderCreate()
    try:
        for k, v in (options or {}).items():
            _result(lib, lib.avifEncoderSetCodecSpecificOption(
                enc, k.encode(), str(v).encode()))
        if sequence_frame:
            _result(lib, lib.avifEncoderAddImage(enc, img, 1, 0))
            return _finish(lib, enc, lambda o: lib.avifEncoderFinish(enc, o))
        return _finish(lib, enc, lambda o: lib.avifEncoderWrite(enc, img, o))
    finally:
        lib.avifEncoderDestroy(enc)
        lib.avifImageDestroy(img)


def encode_grid(cells, cols: int, rows: int, sub: str = "420") -> bytes:
    """A grid ('grid') AVIF of cols x rows cells (each [Y, U, V])."""
    lib = library()
    images = [_image(c, sub) for c in cells]
    arr = (ctypes.c_void_p * len(images))(*images)
    enc = lib.avifEncoderCreate()
    try:
        _result(lib, lib.avifEncoderAddImageGrid(enc, cols, rows, arr, 2))
        return _finish(lib, enc, lambda o: lib.avifEncoderFinish(enc, o))
    finally:
        lib.avifEncoderDestroy(enc)
        for img in images:
            lib.avifImageDestroy(img)


def _box(kind: bytes, body: bytes, full=None) -> bytes:
    if full is not None:
        body = struct.pack(">I", full) + body
    return struct.pack(">I", 8 + len(body)) + kind + body


def container(obus: bytes, width: int, height: int, depth: int = 8,
              profile: int = 0, mono: bool = False, ss=(1, 1)) -> bytes:
    """A minimal still AVIF around one AV1 item (tests of AV1 data
    Pillow's writer cannot make): ftyp, meta (hdlr, pitm, iloc, iinf,
    iprp with ispe, av1C, pixi), mdat."""
    high = depth > 8
    av1c = bytes([0x81, profile << 5,
                  (high << 6) | ((depth == 12) << 5) | (mono << 4)
                  | (ss[0] << 3) | (ss[1] << 2), 0])
    ipco = (_box(b"ispe", struct.pack(">II", width, height), 0)
            + _box(b"av1C", av1c)
            + _box(b"pixi", bytes([1 if mono else 3])
                   + bytes([depth] * (1 if mono else 3)), 0))
    ipma = _box(b"ipma", struct.pack(">IHB", 1, 1, 3) + bytes([1, 0x82, 3]),
                0)
    iinf = _box(b"iinf", struct.pack(">H", 1) + _box(
        b"infe", struct.pack(">HH", 1, 0) + b"av01" + b"\0", 2 << 24), 0)
    ftyp = _box(b"ftyp", b"avif" + bytes(4) + b"avifmif1miaf")

    def meta(offset):
        iloc = _box(b"iloc", bytes([0x44, 0]) + struct.pack(
            ">HHHHII", 1, 1, 0, 1, offset, len(obus)), 0)
        return _box(b"meta", _box(b"hdlr", bytes(4) + b"pict" + bytes(13),
                                  0)
                    + _box(b"pitm", struct.pack(">H", 1), 0) + iloc + iinf
                    + _box(b"iprp", _box(b"ipco", ipco) + ipma), 0)

    head = ftyp + meta(0)
    return ftyp + meta(len(head) + 8) + _box(b"mdat", obus)
