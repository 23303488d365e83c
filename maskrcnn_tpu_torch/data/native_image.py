"""ctypes bridge to the port's native image decoders
(`maskrcnn_tpu_torch/csrc/image_decode.cpp`: JPEG, PNG, GIF, BMP (and
the DIB frames of DIB, ICO and CUR files) and TIFF, with JPEG's
arithmetic and lossless scans in `csrc/jpeg_arith.cpp` and
`jpeg_lossless.cpp`, TIFF's ZSTD, LZMA and CCITT codecs in
`csrc/tiff_zstd.cpp`, `tiff_xz.cpp` and `tiff_fax.cpp`, Netpbm, TGA, QOI, PCX, DCX, SGI and Sun raster in
`csrc/image_plugins.cpp`, JPEG 2000 in `csrc/jpeg2000_decode.cpp`, the
pixels of DDS, BLP and PSD in `csrc/bcn_decode.cpp` (their headers read
here, as `decode_icns` reads ICNS's), those of IM, SPIDER, FITS,
MCIDAS, IMT, XVThumb, PIXAR, GBR, FTEX, XBM, XPM, MSP, FLI and PCD in
`csrc/image_legacy.cpp` (their headers read by data/image_probe.py's
model of each plugin's _open, `plugin_layout`; IPTC's image through the
PPM and JPEG routes), and their shared `image_codec.h` and
`bcn_tables.h`, all compiled into one library;
`csrc/webp_decode.cpp`: WebP; `csrc/avif_decode.cpp` with
`csrc/av1_decode.cpp` and `av1_tables.h`: AVIF, a library of its own;
host C++17).

On first use each library's sources are compiled with the host's C++
compiler into `build/maskrcnn_tpu_torch/` (`utils/native_build.py`,
named by a hash of every file the build reads) and loaded with ctypes;
the libraries link only the C and C++ runtimes. The JPEG IDCT is
libjpeg-turbo's SSE2 code, so the image library builds on x86-64 hosts
(elsewhere its build fails naming SSE2). A whole decode of any
format (headers, entropy decoding and decompression, transforms,
filtering, colour; a TIFF's every strip or tile; PNG's and TIFF's
Deflate through the source's own inflate, TIFF's ZSTD, xz and fax data
through the sources' own decoders) runs in one call (a PNG's chunks are
read here first, and an ICO's or CUR's directory, to pick the frame as
data/image_probe.py's model of Pillow picks it); ctypes releases the
GIL for the call, so decoder threads run in parallel. Every format's
size is read first (one size call) and held to Pillow's
decompression-bomb limit (`check_size`) before the output is allocated
(an animated WebP's canvas, a GIF's screen grown to hold its frame, a
TIFF's image after its orientation). There is no fallback: without a
compiler `library()` and `webp_library()` raise a RuntimeError naming it
(the plain Python decoders of image_io.py, PNG and JPEG only and 56x
slower, are reached only by `read_image(..., plain=True)`); no system
codec (libwebp, giflib, libtiff, zlib, libzstd, liblzma, OpenJPEG,
libavif, libaom, dav1d, Pillow) is loaded (tests/test_torch_image_tiff.py
reads the library's imports).
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

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCE = CSRC / "image_decode.cpp"
# every file the image library's build reads: image_decode.cpp, the JPEG
# scan decoders and TIFF codecs in sources of their own, and every
# header of csrc/ (hashed, so
# that no header an edit touches is left out of the library's name)
SOURCES = (SOURCE, CSRC / "jpeg_arith.cpp", CSRC / "jpeg_lossless.cpp",
           CSRC / "tiff_zstd.cpp", CSRC / "tiff_xz.cpp",
           CSRC / "tiff_fax.cpp", CSRC / "image_plugins.cpp",
           CSRC / "jpeg2000_decode.cpp", CSRC / "jpeg2000_ht.cpp",
           CSRC / "bcn_decode.cpp",
           CSRC / "image_legacy.cpp", *sorted(CSRC.glob("*.h")))
WEBP_SOURCE = CSRC / "webp_decode.cpp"
# the AVIF library: the AV1 decoder, avifImageYUVToRGB's routes, the AV1
# tables it reads and the header of the error type it shares
AVIF_SOURCES = (CSRC / "avif_decode.cpp", CSRC / "av1_decode.cpp",
                CSRC / "av1_decode.h", CSRC / "av1_tables.h",
                CSRC / "image_codec.h")
# -fwrapv: the IDCTs' int32 arithmetic wraps as libjpeg-turbo's does on
# the corrupt coefficients a valid file never holds; -ffp-contract=off:
# JPEG 2000's 9/7 transform rounds each product and sum as OpenJPEG's SSE
# code does (no fused multiply-add, on any host)
CXX_FLAGS = native_build.CXX_FLAGS + ("-fwrapv", "-ffp-contract=off")
PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# LittleCMS 2.17's LAB -> sRGB CLUT as Pillow's convert("RGB") of LAB uses
# it: 33³ nodes of R, G, B as uint16, zlib (csrc/image_decode.cpp
# lab_to_rgb)
LAB_CLUT = Path(__file__).resolve().parent / "lab_srgb_clut.zlib"
# Pillow's decompression-bomb error: more pixels than twice
# Image.MAX_IMAGE_PIXELS
MAX_PIXELS = 2 * 89_478_485

_LIB: Optional[ctypes.CDLL] = None
_WEBP_LIB: Optional[ctypes.CDLL] = None
_AVIF_LIB: Optional[ctypes.CDLL] = None
# one lock a library: they may build at once
_LOCK = threading.Lock()
_WEBP_LOCK = threading.Lock()
_AVIF_LOCK = threading.Lock()
_MSG_LEN = 512


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    return native_build.library_path("image_decode", SOURCES, CXX_FLAGS)


def webp_library_path() -> Path:
    """Where the WebP library for the current source and flags lives."""
    return native_build.library_path("webp_decode", (WEBP_SOURCE,),
                                     CXX_FLAGS)


def avif_library_path() -> Path:
    """Where the AVIF library for the current sources and flags lives."""
    return native_build.library_path("avif_decode", AVIF_SOURCES, CXX_FLAGS)


def _build(stem: str, sources) -> ctypes.CDLL:
    try:
        return native_build.load(stem, sources, CXX_FLAGS)
    except (OSError, subprocess.SubprocessError) as e:
        detail = getattr(e, "stderr", b"") or b""
        names = ", ".join(p.name for p in sources if p.suffix == ".cpp")
        raise RuntimeError(
            f"the native image decoder ({names}) could not be "
            f"built with the C++ compiler {native_build.compiler()!r} "
            f"or loaded: {e} {detail.decode(errors='replace')[-2000:]}"
        ) from e


_U8P = ctypes.c_char_p
_I32P = ctypes.POINTER(ctypes.c_int32)
_OUT = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
# mrt_<format>_size and mrt_<format>_decode of every format but PNG
# (TIFF's, PCX's and DCX's take one more argument, a path flag; DIB's the
# frame's place and kind; JPEG 2000's a mode and a palette)
_SIZE_ARGS = [_U8P, ctypes.c_int64, _I32P, _I32P, ctypes.c_char_p,
              ctypes.c_int32]
_DECODE_ARGS = [_U8P, ctypes.c_int64, _OUT, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_char_p, ctypes.c_int32]


def _declare(lib: ctypes.CDLL, formats, extra=()) -> None:
    for name in formats:
        getattr(lib, f"mrt_{name}_size").argtypes = _SIZE_ARGS + list(extra)
        getattr(lib, f"mrt_{name}_decode").argtypes = (_DECODE_ARGS +
                                                       list(extra))
        for kind in ("size", "decode"):
            getattr(lib, f"mrt_{name}_{kind}").restype = ctypes.c_int


def library() -> ctypes.CDLL:
    """The decoder library of every format but WebP, built on first use; a
    RuntimeError naming the compiler when it cannot be built or
    loaded."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        lib = _build("image_decode", SOURCES)
        _declare(lib, ("jpeg", "bmp", "gif", "ppm", "tga", "qoi", "sgi",
                       "sun"))
        _declare(lib, ("tiff", "pcx", "dcx"), [ctypes.c_int32])
        _declare(lib, ("dib",), [ctypes.c_int64, ctypes.c_int32,
                                 ctypes.c_int64, ctypes.c_int32])
        lib.mrt_zlib_inflate.argtypes = [
            _U8P, ctypes.c_int64, _OUT, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_char_p, ctypes.c_int32]
        lib.mrt_zlib_inflate.restype = ctypes.c_int
        lib.mrt_png_decode.argtypes = [
            _U8P, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, _U8P,
            ctypes.c_int32, _OUT, ctypes.c_char_p, ctypes.c_int32]
        lib.mrt_png_decode.restype = ctypes.c_int
        # JPEG 2000's: Pillow's mode and a P image's palette
        _declare(lib, ("jpeg2000",), [ctypes.c_int32, _U8P])
        lib.mrt_icns_rgb.argtypes = [
            _U8P, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int32, _OUT, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_char_p, ctypes.c_int32]
        lib.mrt_icns_rgb.restype = ctypes.c_int
        lib.mrt_lab_rgb.argtypes = [_OUT, ctypes.c_int64, _OUT,
                                    ctypes.c_char_p, ctypes.c_int32]
        lib.mrt_lab_rgb.restype = ctypes.c_int
        # DDS's, BLP's and PSD's pixels (csrc/bcn_decode.cpp)
        i32, i64 = ctypes.c_int32, ctypes.c_int64
        tail = [_OUT, i32, i32, ctypes.c_char_p, i32]
        lib.mrt_bcn.argtypes = [_U8P, i64, i64, i32, i32] + tail
        lib.mrt_dds_masks.argtypes = [_U8P, i64, i64, i64, ctypes.c_void_p,
                                      i32] + tail
        lib.mrt_blp_dxt.argtypes = [_U8P, i64, i64, i32, i32] + tail
        lib.mrt_psd_planes.argtypes = [_U8P, i64, i64, i32, i32, i32,
                                       _U8P] + tail
        lib.mrt_jpeg_decode_cmyk.argtypes = _DECODE_ARGS
        for name in ("bcn", "dds_masks", "blp_dxt", "psd_planes",
                     "jpeg_decode_cmyk"):
            getattr(lib, f"mrt_{name}").restype = ctypes.c_int
        # the last plugins' pixels (csrc/image_legacy.cpp)
        lib.mrt_raw_tiles.argtypes = [_U8P, i64, ctypes.c_void_p, i32, i32,
                                      _U8P, _OUT, i32, i32, ctypes.c_char_p,
                                      ctypes.c_char_p, i32]
        lib.mrt_xbm.argtypes = [_U8P, i64, i64] + tail
        lib.mrt_xpm.argtypes = [_U8P, i64, i64, i32, _U8P, ctypes.c_void_p,
                                i32, _U8P] + tail
        lib.mrt_msp.argtypes = [_U8P, i64] + tail
        lib.mrt_fli.argtypes = [_U8P, i64, i64, _U8P] + tail
        lib.mrt_pcd.argtypes = [_U8P, i64, i64] + tail
        lib.mrt_fits_gzip.argtypes = [_U8P, i64, i64, i32, i32] + tail
        for name in ("raw_tiles", "xbm", "xpm", "msp", "fli", "pcd",
                     "fits_gzip"):
            getattr(lib, f"mrt_{name}").restype = ctypes.c_int
        lib.mrt_lab_clut.argtypes = [ctypes.c_void_p]
        lib.mrt_lab_clut.restype = None
        # LittleCMS's LAB -> sRGB table (TIFF's LAB; tests/image_corpus.py
        # --lab-clut wrote it from Pillow's liblcms2)
        table = np.frombuffer(zlib.decompress(LAB_CLUT.read_bytes()), "<u2")
        lib.mrt_lab_clut(np.ascontiguousarray(table, np.uint16).ctypes.data)
        _LIB = lib
        return lib


def webp_library() -> ctypes.CDLL:
    """The WebP decoder library, built on first use (as `library`)."""
    global _WEBP_LIB
    with _WEBP_LOCK:
        if _WEBP_LIB is None:
            lib = _build("webp_decode", (WEBP_SOURCE,))
            _declare(lib, ("webp",))
            _WEBP_LIB = lib
        return _WEBP_LIB


def avif_library() -> ctypes.CDLL:
    """The AVIF decoder library, built on first use (as `library`)."""
    global _AVIF_LIB
    with _AVIF_LOCK:
        if _AVIF_LIB is None:
            lib = _build("avif_decode", AVIF_SOURCES)
            i32, i64 = ctypes.c_int32, ctypes.c_int64
            lib.mrt_avif_decode.argtypes = [
                _U8P, i64, _U8P, i64, _OUT, i32, i32, i32, i32, i32, i32,
                i32, ctypes.c_char_p, i32]
            lib.mrt_av1_planes.argtypes = [_U8P, i64, _I32P, ctypes.c_void_p,
                                           ctypes.c_void_p, ctypes.c_void_p,
                                           ctypes.c_char_p, i32]
            lib.mrt_avif_yuv_to_rgb.argtypes = (
                [ctypes.c_void_p] * 3 + [i32] * 8
                + [_OUT, i32, ctypes.c_char_p, i32])
            for name in ("avif_decode", "av1_planes", "avif_yuv_to_rgb"):
                getattr(lib, f"mrt_{name}").restype = ctypes.c_int
            _AVIF_LIB = lib
        return _AVIF_LIB


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
    return _decode(library(), "jpeg", data)


def decode_png(data: bytes) -> np.ndarray:
    """A PNG file's bytes -> RGB uint8 [H, W, 3]: the chunks read and the
    rest (the image data's inflate on) in one native call."""
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
    raw = b"".join(idat)
    msg = ctypes.create_string_buffer(_MSG_LEN)
    out = np.empty((height, width, 3), np.uint8)
    entries = min(len(palette) // 3, 256) if palette is not None else 0
    code = lib.mrt_png_decode(raw, len(raw), width, height, depth, color,
                              interlace, palette, entries, out, msg,
                              _MSG_LEN)
    if code:
        _raise(code, msg)
    return out


def _decode(lib: ctypes.CDLL, name: str, data: bytes,
            *extra) -> np.ndarray:
    """One format's size call, Pillow's size limit, then its decode call
    into an array of that size (`extra`: the format's further
    arguments)."""
    msg = ctypes.create_string_buffer(_MSG_LEN)
    h, w = ctypes.c_int32(), ctypes.c_int32()
    code = getattr(lib, f"mrt_{name}_size")(
        data, len(data), ctypes.byref(h), ctypes.byref(w), msg, _MSG_LEN,
        *extra)
    if code:
        _raise(code, msg)
    check_size(w.value, h.value)
    out = np.empty((h.value, w.value, 3), np.uint8)
    code = getattr(lib, f"mrt_{name}_decode")(data, len(data), out, h.value,
                                              w.value, msg, _MSG_LEN, *extra)
    if code:
        _raise(code, msg)
    return out


def decode_bmp(data: bytes) -> np.ndarray:
    """A BMP file's bytes -> RGB uint8 [H, W, 3]."""
    return _decode(library(), "bmp", data)


def decode_gif(data: bytes) -> np.ndarray:
    """A GIF file's bytes -> the first frame on its screen, RGB uint8
    [H, W, 3]."""
    return _decode(library(), "gif", data)


def decode_tiff(data: bytes, path: bool = False) -> np.ndarray:
    """A TIFF file's bytes -> its first image, RGB uint8 [H, W, 3], after
    its orientation. `path`: the bytes of a file Pillow opens from its
    path, which it memory-maps where it can (an uncompressed image of one
    strip or tile in a mode it maps, whose Orientation 5-8 then turns the
    mapped view, not the image; a ValueError where the view's last row
    would run past the file's end)."""
    return _decode(library(), "tiff", data, int(path))


def decode_ppm(data: bytes) -> np.ndarray:
    """A PPM, PGM, PBM or PFM file's bytes (Pillow's P0CMYK, PyP, PyRGBA
    and PyCMYK too) -> RGB uint8 [H, W, 3]."""
    return _decode(library(), "ppm", data)


def decode_tga(data: bytes) -> np.ndarray:
    """A TGA file's bytes -> RGB uint8 [H, W, 3]."""
    return _decode(library(), "tga", data)


def decode_qoi(data: bytes) -> np.ndarray:
    """A QOI file's bytes -> RGB uint8 [H, W, 3]."""
    return _decode(library(), "qoi", data)


def decode_pcx(data: bytes, path: bool = False) -> np.ndarray:
    """A PCX file's bytes -> RGB uint8 [H, W, 3]. `path`: a file Pillow
    opens from its path, where the seek to an 8-bit image's VGA palette
    raises before a file's start (from bytes it stops there)."""
    return _decode(library(), "pcx", data, int(path))


def decode_dcx(data: bytes, path: bool = False) -> np.ndarray:
    """A DCX file's bytes -> its first page, RGB uint8 [H, W, 3] (`path`
    as decode_pcx's)."""
    return _decode(library(), "dcx", data, int(path))


def decode_sgi(data: bytes) -> np.ndarray:
    """An SGI file's bytes -> RGB uint8 [H, W, 3]."""
    return _decode(library(), "sgi", data)


def decode_sun(data: bytes) -> np.ndarray:
    """A Sun raster file's bytes -> RGB uint8 [H, W, 3]."""
    return _decode(library(), "sun", data)


def decode_dib(data: bytes) -> np.ndarray:
    """A DIB file's bytes (a BMP's info header and pixels without its
    file header) -> RGB uint8 [H, W, 3]."""
    return _decode(library(), "dib", data, 0, 0, 0, 0)


def decode_ico(data: bytes) -> np.ndarray:
    """An ICO file's bytes -> the entry IcoImageFile loads (the largest,
    image_probe.ico_entry), RGB uint8 [H, W, 3]: a PNG through the PNG
    route, a DIB through the BMP decoder with its height halved and its
    AND mask (or a 32-bit entry's alpha) held to what Pillow reads."""
    from maskrcnn_tpu_torch.data.image_probe import ico_entry
    _, _, _, size, offset, bpp = ico_entry(data)
    if data[offset:offset + 8] == PNG_SIGNATURE:
        return decode_png(data[offset:])
    return _decode(library(), "dib", data, offset, 1, offset + size,
                   int(bpp == 32))


def decode_cur(data: bytes) -> np.ndarray:
    """A CUR file's bytes -> the cursor CurImageFile loads
    (image_probe.cur_frame), RGB uint8 [H, W, 3]."""
    from maskrcnn_tpu_torch.data.image_probe import cur_frame
    return _decode(library(), "dib", data, cur_frame(data), 2, 0, 0)


def inflate(data: bytes, limit: int) -> bytes:
    """A whole zlib stream through the decoder's own inflate (PNG's and
    the TIFF route's Deflate; its end and Adler-32 checked), at most
    `limit` bytes: what zlib.decompress gives, or a ValueError where it
    raises. The tests hold the inflate to zlib through it."""
    lib = library()
    msg = ctypes.create_string_buffer(_MSG_LEN)
    out = np.empty(max(limit, 1), np.uint8)
    n = ctypes.c_int64()
    code = lib.mrt_zlib_inflate(data, len(data), out, limit, ctypes.byref(n),
                                msg, _MSG_LEN)
    if code:
        _raise(code, msg)
    return out[:n.value].tobytes()


# Pillow's modes of a JPEG 2000 file, as csrc/jpeg2000_decode.cpp numbers
# them
JPEG2000_MODES = ("L", "I;16", "LA", "RGB", "RGBA", "CMYK", "P", "PA")


def decode_jpeg2000(data: bytes) -> np.ndarray:
    """A JPEG 2000 file's bytes (a JP2 file or a raw J2K codestream) -> RGB
    uint8 [H, W, 3]: the mode (and a P or PA file's palette) as
    Jpeg2KImageFile._open gives them (image_probe.jpeg2000_header), the
    codestream as OpenJPEG 2.5.4 decodes it tile by tile, each tile
    unpacked as Pillow's decoder unpacks it, then convert("RGB")."""
    from maskrcnn_tpu_torch.data.image_probe import jpeg2000_header
    mode, _, palette = jpeg2000_header(data)
    return _decode(library(), "jpeg2000", data, JPEG2000_MODES.index(mode),
                   palette or bytes(768))


# IcnsImagePlugin.IcnsFile.SIZES: a size's entries, in the order
# dataforsize reads them ("png": a PNG or JPEG 2000 image, "rgb": packed
# RGB, "rgb32t": it32's, "mask": an 8-bit mask)
ICNS_READERS = {
    (512, 512, 2): ((b"ic10", "png"),), (512, 512, 1): ((b"ic09", "png"),),
    (256, 256, 2): ((b"ic14", "png"),), (256, 256, 1): ((b"ic08", "png"),),
    (128, 128, 2): ((b"ic13", "png"),),
    (128, 128, 1): ((b"ic07", "png"), (b"it32", "rgb32t"),
                    (b"t8mk", "mask")),
    (64, 64, 1): ((b"icp6", "png"),), (32, 32, 2): ((b"ic12", "png"),),
    (48, 48, 1): ((b"ih32", "rgb"), (b"h8mk", "mask")),
    (32, 32, 1): ((b"icp5", "png"), (b"il32", "rgb"), (b"l8mk", "mask")),
    (16, 16, 2): ((b"ic11", "png"),),
    (16, 16, 1): ((b"icp4", "png"), (b"is32", "rgb"), (b"s8mk", "mask")),
}
_J2K_SIGNATURES = (b"\xff\x4f\xff\x51", b"\x0d\x0a\x87\x0a")


def decode_icns(data: bytes) -> np.ndarray:
    """An ICNS file's bytes -> RGB uint8 [H, W, 3]: the icon
    IcnsImageFile.load reads (bestsize's, image_probe.icns_entries): its
    PNG (from the entry to the file's end, as Pillow's PNG plugin reads
    it) or JPEG 2000 entry (the entry's bytes) through those decoders,
    else its packed RGB (mrt_icns_rgb, its mask only checked: alpha is
    dropped); every entry of the size read, so that one Pillow fails on
    fails here too, and the image's size held to the file's sizes as
    IcnsImageFile's size setter holds it."""
    from maskrcnn_tpu_torch.data.image_probe import icns_entries
    dct, sizes, best = icns_entries(data)
    w, h, scale = best
    image = rgb = None
    for code, kind in ICNS_READERS[best]:
        if code not in dct:
            continue
        start, length = dct[code]
        if kind == "png":
            sig = data[start:start + 12]
            if sig.startswith(PNG_SIGNATURE):
                image = decode_png(data[start:])
            elif (sig.startswith(_J2K_SIGNATURES)
                  or sig == b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a"):
                image = decode_jpeg2000(data[start:start + length])
            else:
                raise ValueError("ICNS: Unsupported icon subimage format")
        elif kind == "mask":
            if len(data) - min(start, len(data)) < w * h:
                raise ValueError("ICNS: not enough image data (mask)")
        else:
            rgb = np.empty((h, w, 3), np.uint8)
            msg = ctypes.create_string_buffer(_MSG_LEN)
            code = library().mrt_icns_rgb(data, len(data), start, length,
                                          int(kind == "rgb32t"), rgb, h, w,
                                          msg, _MSG_LEN)
            if code:
                _raise(code, msg)
    if image is None:
        if rgb is None:
            raise ValueError("ICNS: no RGB image for its size (KeyError)")
        image = rgb
    # the size setter: a size of the file at a whole scale
    ih, iw = image.shape[:2]
    if not any(sw * ss // iw * ih == sh * ss for sw, sh, ss in sizes):
        raise ValueError("ICNS: This is not one of the allowed sizes of "
                         "this image")
    return image


def lab_to_rgb(lab: np.ndarray) -> np.ndarray:
    """LAB pixels [..., 3] uint8 as a LAB image holds them (L, a + 128,
    b + 128) -> Pillow's convert("RGB") of them (LittleCMS's transform,
    csrc/image_decode.cpp lab_to_rgb), RGB uint8 of the same shape."""
    lab = np.ascontiguousarray(lab, np.uint8)
    out = np.empty(lab.shape, np.uint8)
    msg = ctypes.create_string_buffer(_MSG_LEN)
    code = library().mrt_lab_rgb(lab.reshape(-1), lab.size // 3,
                                 out.reshape(-1), msg, _MSG_LEN)
    if code:
        _raise(code, msg)
    return out


def _call(name: str, *args) -> None:
    """One of bcn_decode.cpp's entry points (its message buffer last)."""
    msg = ctypes.create_string_buffer(_MSG_LEN)
    code = getattr(library(), f"mrt_{name}")(*args, msg, _MSG_LEN)
    if code:
        _raise(code, msg)


# DdsImagePlugin's "bcn" tiles: (n, signed) of each FourCC and DXGI format
DDS_FOURCC_BCN = {b"DXT1": (1, 0), b"DXT3": (2, 0), b"DXT5": (3, 0),
                  b"BC4U": (4, 0), b"ATI1": (4, 0), b"BC5S": (5, 1),
                  b"BC5U": (5, 0), b"ATI2": (5, 0)}
DDS_DXGI_BCN = {70: (1, 0), 71: (1, 0), 73: (2, 0), 74: (2, 0), 76: (3, 0),
                77: (3, 0), 79: (4, 0), 80: (4, 0), 82: (5, 0), 83: (5, 0),
                84: (5, 1), 95: (6, 0), 96: (6, 1), 97: (7, 0), 98: (7, 0),
                99: (7, 0)}


def _raw_rgb(data: bytes, pos: int, h: int, w: int, mode: str,
             palette: bytes = b"") -> np.ndarray:
    """Pillow's raw decoder of `mode` rows from data[pos:] (an error where
    they run out), then convert("RGB"): L expanded, LA's and RGBA's alpha
    dropped, P looked up in its RGBA palette."""
    bands = {"L": 1, "LA": 2, "P": 1, "RGBA": 4}[mode]
    need = h * w * bands
    if len(data) - pos < need:
        raise ValueError(f"{mode} image data: image file is truncated")
    px = np.frombuffer(data, np.uint8, need, pos).reshape(h, w, bands)
    if mode == "P":
        return np.frombuffer(palette, np.uint8).reshape(256, 4)[px[..., 0],
                                                               :3].copy()
    if mode in ("L", "LA"):
        return np.repeat(px[..., :1], 3, axis=2)
    return px[..., :3].copy()


def decode_dds(data: bytes) -> np.ndarray:
    """A DDS file's bytes -> its first surface, RGB uint8 [H, W, 3], as
    DdsImageFile reads it (the header held to its _open by
    image_probe.identify): uncompressed RGB(A) under any masks
    (DdsRgbDecoder), L, LA, P under its RGBA palette, R8G8B8A8, or BCn
    blocks (csrc/bcn_decode.cpp). Its load_seek does nothing, so the
    pixels start where _open's reads left the file."""
    height, width = struct.unpack_from("<2I", data, 12)
    pfflags, fourcc, bitcount = struct.unpack_from("<I4sI", data, 80)
    check_size(width, height)
    n, pos = len(data), 128
    if pfflags & 0x40:                                  # DDPF_RGB
        count = 4 if pfflags & 0x1 else 3
        masks = np.array(struct.unpack_from(f"<{count}I", data, 92),
                         np.uint32)
        out = np.empty((height, width, 3), np.uint8)
        _call("dds_masks", data, n, pos, bitcount, masks.ctypes.data, count,
              out, height, width)
        return out
    if pfflags & 0x20000:                               # DDPF_LUMINANCE
        return _raw_rgb(data, pos, height, width,
                        "L" if bitcount == 8 else "LA")
    if pfflags & 0x20:                                  # DDPF_PALETTEINDEXED8
        return _raw_rgb(data, min(pos + 1024, n), height, width, "P",
                        data[pos:pos + 1024])
    if fourcc == b"DX10":
        (dxgi,) = struct.unpack_from("<I", data, pos)
        pos = min(pos + 20, n)
        if dxgi not in DDS_DXGI_BCN:                    # R8G8B8A8
            return _raw_rgb(data, pos, height, width, "RGBA")
        bcn, sign = DDS_DXGI_BCN[dxgi]
    else:
        bcn, sign = DDS_FOURCC_BCN[fourcc]
    out = np.empty((height, width, 3), np.uint8)
    _call("bcn", data, n, pos, bcn, sign, out, height, width)
    return out


def _safe_read(data: bytes, pos: int, size: int) -> bytes:
    """ImageFile._safe_read at `pos`: `size` bytes, an error where the
    file holds fewer."""
    if size <= 0:
        return b""
    if len(data) - min(pos, len(data)) < size:
        raise ValueError("BLP: Truncated File Read")
    return data[pos:pos + size]


def _blp_jpeg(data: bytes, pos: int, offsets, lengths, height: int,
              width: int) -> np.ndarray:
    """BLP1Decoder._decode_jpeg_stream: the shared JPEG header and the
    first mip's data, opened as JpegImageFile opens it (a CMYK frame's
    jpegmode "CMYK": YCCK components read as CMYK), convert("RGB"), then
    its bytes read as BGR rows of the BLP's width."""
    from maskrcnn_tpu_torch.data import image_probe
    (size,) = struct.unpack("<I", _safe_read(data, pos, 4))
    header = _safe_read(data, pos + 4, size)
    pos += 4 + size
    pos += len(_safe_read(data, pos, offsets[0] - pos))
    jpeg = header + _safe_read(data, pos, lengths[0])
    if not image_probe.ACCEPT["JPEG"](jpeg[:16]):
        raise ValueError("BLP: its JPEG: not a JPEG file")
    try:
        _, (jw, jh) = image_probe.OPEN["JPEG"](image_probe._File(jpeg, False))
    except Exception as e:  # noqa: BLE001 - JpegImageFile raises them all
        raise ValueError(f"BLP: its JPEG does not open: {e}") from None
    if jw * jh > MAX_PIXELS:
        raise ValueError("BLP: its JPEG is a decompression bomb")
    lib = library()
    msg = ctypes.create_string_buffer(_MSG_LEN)
    h, w = ctypes.c_int32(), ctypes.c_int32()
    code = lib.mrt_jpeg_size(jpeg, len(jpeg), ctypes.byref(h),
                             ctypes.byref(w), msg, _MSG_LEN)
    if code:
        _raise(code, msg)
    rgb = np.empty((h.value, w.value, 3), np.uint8)
    _call("jpeg_decode_cmyk", jpeg, len(jpeg), rgb, h.value, w.value)
    flat = rgb.reshape(-1)
    if flat.size < height * width * 3:
        raise ValueError("BLP: not enough image data")
    return flat[:height * width * 3].reshape(height, width, 3)[..., ::-1] \
        .copy()


def decode_blp(data: bytes) -> np.ndarray:
    """A BLP file's bytes -> RGB uint8 [H, W, 3], as BlpImagePlugin's
    BLP1Decoder and BLP2Decoder read it: a BLP1 JPEG (the port's JPEG
    decoder), 256-entry BGRA palettes with their index streams, BLP2's
    DXT1/3/5 through the plugin's own Python block decoders
    (csrc/bcn_decode.cpp mrt_blp_dxt); what Pillow fails on (its
    BLPFormatError too: Pillow has failed) a ValueError."""
    magic = data[:4]
    (compression,) = struct.unpack_from("<i", data, 4)
    if magic == b"BLP1":
        alpha = struct.unpack_from("<I", data, 8)[0] != 0
        width, height, encoding = struct.unpack_from("<IIi", data, 12)
        pos = 28
    else:
        encoding, alpha, alpha_encoding = struct.unpack_from("<3b", data, 8)
        alpha = alpha != 0
        width, height = struct.unpack_from("<II", data, 12)
        pos = 20
    check_size(width, height)
    offsets = struct.unpack("<16I", _safe_read(data, pos, 64))
    lengths = struct.unpack("<16I", _safe_read(data, pos + 64, 64))
    pos += 128
    if magic == b"BLP1" and compression == 0:
        return _blp_jpeg(data, pos, offsets, lengths, height, width)
    if magic == b"BLP1" and (compression != 1 or encoding not in (4, 5)):
        raise ValueError(f"BLP: unsupported BLP1 compression {compression} "
                         f"or encoding {encoding}")
    palette = np.frombuffer(_safe_read(data, pos, 1024), np.uint8) \
        .reshape(256, 4)[:, [2, 1, 0]]
    pos = pos + 1024 if magic == b"BLP1" else offsets[0]
    if magic == b"BLP2":
        if compression != 1 or encoding not in (1, 2):
            raise ValueError(f"BLP: unknown BLP2 compression {compression} "
                             f"or encoding {encoding}")
        if encoding == 2:
            kind = {0: 0, 1: 1, 7: 2}.get(alpha_encoding)
            if kind is None:
                raise ValueError("BLP: unsupported alpha encoding "
                                 f"{alpha_encoding}")
            out = np.empty((height, width, 3), np.uint8)
            _call("blp_dxt", data, len(data), pos, kind, int(alpha), out,
                  height, width)
            return out
    index = np.frombuffer(_safe_read(data, pos, lengths[0]), np.uint8)
    if index.size < width * height:
        raise ValueError("BLP: not enough image data")
    return palette[index[:width * height]].reshape(height, width, 3)


# PsdImagePlugin's modes as csrc/bcn_decode.cpp numbers them
PSD_MODES = ("1", "L", "P", "RGB", "RGBA", "CMYK", "LAB")


def decode_psd(data: bytes) -> np.ndarray:
    """A PSD file's bytes -> its merged image, RGB uint8 [H, W, 3], as
    PsdImageFile reads it (image_probe.psd_layout: the mode, channels and
    where the image data starts past the layer section), each channel's
    plane raw or PackBits (csrc/bcn_decode.cpp mrt_psd_planes), then
    convert("RGB") (a P image without a 768-byte palette is black, as
    Pillow's is)."""
    from maskrcnn_tpu_torch.data.image_probe import psd_layout
    mode, (width, height), channels, compression, pos, palette = \
        psd_layout(data)
    check_size(width, height)
    out = np.empty((height, width, 3), np.uint8)
    if palette is not None:
        p = np.frombuffer(palette, np.uint8).reshape(3, 256).T
        palette = np.ascontiguousarray(p).tobytes()
    _call("psd_planes", data, len(data), pos, compression,
          PSD_MODES.index(mode), channels, palette or bytes(768), out,
          height, width)
    return out


def decode_webp(data: bytes) -> np.ndarray:
    """A WebP file's bytes -> the first frame on its canvas, RGB uint8
    [H, W, 3]."""
    return _decode(webp_library(), "webp", data)


# ------------------------------------------------------------------ AVIF

def decode_avif(data: bytes, rgba: bool = False) -> np.ndarray:
    """An AVIF file's bytes -> RGB uint8 [H, W, 3] (`rgba`: the RGBA
    avifImageYUVToRGB gives where the image has alpha, [H, W, 4]): the
    primary item's AV1 key frame and its alpha item's
    (image_probe.avif_layout reads the container as libavif 1.3 does),
    decoded and converted in one call (csrc/avif_decode.cpp). Refused by
    name: grid items and image sequences without items; the AV1 tools
    av1_decode.cpp refuses (10- and 12-bit data, film grain, superres,
    IntraBC); an AV1 frame smaller than the item's ispe (libavif reads
    past the decoded picture)."""
    from maskrcnn_tpu_torch.data import image_probe
    layout = image_probe.avif_layout(data)
    if layout["sequence"]:
        raise NotImplementedError("AVIF: an image sequence without image "
                                  "items, which the port does not read")
    if layout["grid"]:
        raise NotImplementedError("AVIF: a grid ('grid') image item, which "
                                  "the port does not read")
    w, h = layout["size"]
    check_size(w, h)
    lib = avif_library()
    color, alpha = layout["color"], layout["alpha"]
    msg = ctypes.create_string_buffer(_MSG_LEN)
    # no colr nclx box: matrix -1, the sequence header's colour config
    primaries, _, matrix, full = layout["nclx"] or (0, 0, -1, 0)
    channels = 4 if layout["mode"] == "RGBA" else 3
    out = np.empty((h, w, channels), np.uint8)
    code = lib.mrt_avif_decode(
        color, len(color), alpha or b"", len(alpha or b""), out, h, w,
        channels, matrix, primaries, full, int(layout["premultiplied"]), msg,
        _MSG_LEN)
    if code:
        _raise(code, msg)
    if rgba or channels == 3:
        return out
    return np.ascontiguousarray(out[..., :3])


def av1_planes(obus: bytes):
    """The planes of the first frame of AV1 OBUs (Y, U, V; U and V None
    for 4:0:0) and its colour config (tests hold them to libavif's)."""
    lib = avif_library()
    msg = ctypes.create_string_buffer(_MSG_LEN)
    info = (ctypes.c_int32 * 11)()
    code = lib.mrt_av1_planes(obus, len(obus), info, None, None, None, msg,
                              _MSG_LEN)
    if code:
        _raise(code, msg)
    w, h, cw, ch = info[0], info[1], info[2], info[3]
    y = np.empty((h, w), np.uint8)
    u = np.empty((ch, cw), np.uint8)
    v = np.empty((ch, cw), np.uint8)
    code = lib.mrt_av1_planes(obus, len(obus), info, y.ctypes.data,
                              u.ctypes.data, v.ctypes.data, msg, _MSG_LEN)
    if code:
        _raise(code, msg)
    keys = ("width", "height", "chroma_width", "chroma_height", "mono",
            "ss_x", "ss_y", "full_range", "primaries", "transfer", "matrix")
    config = dict(zip(keys, list(info)))
    if config["mono"]:
        return (y, None, None), config
    return (y, u, v), config


# ------------------------------------------------ the last plugins' pixels
# Pillow's modes and raw modes as csrc/image_legacy.cpp numbers them
LEGACY_MODES = ("1", "L", "P", "LA", "PA", "RGB", "RGBA", "CMYK", "YCbCr",
                "I", "F", "I;16", "I;16L", "I;16B")
RAWMODES = ("1", "1;R", "L", "P", "P;2", "P;4", "LA;L", "PA;L", "RGB",
            "RGB;L", "RGBX;L", "RGBA", "RGBA;L", "CMYK;L", "YCbCr;L", "R",
            "G", "B", "I", "I;32", "I;32S", "I;32B", "F", "F;8", "F;8S",
            "F;16", "F;16S", "F;32", "F;32S", "F;32F", "F;32BF", "I;16",
            "I;16L", "I;16B")
# Unpack.c's raw modes for each mode, of those the plugins name (any other
# pair is Pillow's "unknown raw mode for given image mode")
UNPACKERS = {"1": ("1",), "L": ("L",), "P": ("P", "P;2", "P;4"),
             "LA": ("LA;L",), "PA": ("PA;L",),
             "RGB": ("RGB", "RGB;L", "RGBX;L", "R", "G", "B"),
             "RGBA": ("RGBA", "RGBA;L"), "CMYK": ("CMYK;L",),
             "YCbCr": ("YCbCr;L",), "I": ("I", "I;32", "I;32S", "I;32B"),
             "F": ("F", "F;8", "F;8S", "F;16", "F;16S", "F;32", "F;32S",
                   "F;32F", "F;32BF"),
             "I;16": ("I;16",), "I;16L": ("I;16L",), "I;16B": ("I;16B",)}


def _legacy_size(size, what: str):
    """An _open's size as Image.core.new takes it: two ints, (w, h)."""
    if (not isinstance(size, tuple) or len(size) != 2
            or not all(isinstance(v, int) for v in size)):
        raise ValueError(f"{what}: a size Pillow's Image.core.new refuses: "
                         f"{size!r}")
    check_size(*size)
    return size


def _palette_triples(palette: bytes) -> bytes:
    """A palette of RGB triples, black past its entries: 768 bytes."""
    return bytes(palette[:768]).ljust(768, b"\0")


def raw_tiles(data: bytes, mode: str, size, tiles, palette: bytes = b"",
              what: str = "raw") -> np.ndarray:
    """Pillow's raw tiles (offset, raw mode, stride, ystep), or
    ("bit", offset, bits) for BitDecode.c's floats, decoded into an image of
    `mode` as ImageFile.load decodes them, then convert("RGB") (palette: P
    and PA's RGB triples): RGB uint8 [H, W, 3]."""
    w, h = _legacy_size(size, what)
    if mode not in LEGACY_MODES:
        raise ValueError(f"{what}: unrecognized image mode {mode!r}")
    rows = []
    for tile in tiles:
        if tile[0] == "bit":
            if mode != "F":
                raise ValueError(f"{what}: decoder error (the bit decoder "
                                 "decodes F images only)")
            rows.append((tile[1], 0, 0, -1, tile[2]))
            continue
        offset, rawmode, stride, ystep = tile
        if not -2 ** 31 <= stride < 2 ** 31:
            # the raw decoder takes its stride as a C int
            raise ValueError(f"{what}: a stride of {stride} overflows the "
                             "raw decoder's int")
        if rawmode not in UNPACKERS[mode]:
            raise ValueError(f"{what}: unknown raw mode {rawmode!r} for "
                             f"image mode {mode!r}")
        rows.append((offset, RAWMODES.index(rawmode), stride, ystep, 0))
    table = np.array(rows, np.int64).reshape(-1)
    out = np.empty((h, w, 3), np.uint8)
    msg = ctypes.create_string_buffer(_MSG_LEN)
    code = library().mrt_raw_tiles(
        data, len(data), table.ctypes.data, len(rows),
        LEGACY_MODES.index(mode), _palette_triples(palette), out, h, w,
        what.encode(), msg, _MSG_LEN)
    if code:
        _raise(code, msg)
    return out


def _layout(data: bytes, name: str):
    from maskrcnn_tpu_torch.data.image_probe import plugin_layout
    return plugin_layout(data, name)


def decode_im(data: bytes) -> np.ndarray:
    """An IM file's bytes -> RGB uint8 [H, W, 3], as ImImageFile reads it:
    its raw mode's rows bottom-up from the header's end (a G, an R and a B
    plane for RGB3 and RYB3; BitDecode.c's floats for "L*n" of other
    than 8, 16 and 32 bits), a colour Lut making L and P images P and LA
    and PA ones PA (its planes R, G, B)."""
    _, size, lay = _layout(data, "IM")
    mode, rawmode, offset = lay["mode"], lay["rawmode"], lay["offset"]
    w, h = _legacy_size(size, "IM")
    palette = b""
    if lay["palette"] is not None:
        p = lay["palette"]
        if len(p) < 768:            # the file ends inside its Lut
            raise ValueError("IM: image file is truncated")
        palette = bytes(v for i in range(256) for v in (p[i], p[i + 256],
                                                        p[i + 512]))
    if rawmode in ("RGB;T", "RYB;T"):
        tiles = [(offset + k * w * h, band, 0, -1)
                 for k, band in enumerate("GRB")]
    elif (rawmode.startswith("F;") and rawmode[2:].isdigit()
          and int(rawmode[2:]) not in (8, 16, 32)):
        tiles = [("bit", offset, int(rawmode[2:]))]
    else:
        tiles = [(offset, rawmode, 0, -1)]
    return raw_tiles(data, mode, size, tiles, palette, "IM")


def decode_spider(data: bytes) -> np.ndarray:
    """A SPIDER file's bytes -> RGB uint8 [H, W, 3]: its floats (F;32BF or
    F;32F by the header's byte order) past the header (a stack's first
    image past two), truncated and clipped."""
    _, size, lay = _layout(data, "SPIDER")
    return raw_tiles(data, "F", size, [(lay["offset"], lay["rawmode"], 0,
                                        1)], what="SPIDER")


def decode_fits(data: bytes) -> np.ndarray:
    """A FITS file's bytes -> RGB uint8 [H, W, 3], as FitsImageFile reads
    it: the first HDU with an image, its rows bottom-up in the mode BITPIX
    gives (L, I;16, I or F, read as Pillow's raw modes of those names),
    or a GZIP_1 tiled image's heap through FitsGzipDecoder
    (csrc/image_legacy.cpp mrt_fits_gzip, the decoder's own inflate)."""
    mode, size, lay = _layout(data, "FITS")
    if not lay["gzip"]:
        return raw_tiles(data, mode, size, [(lay["offset"], mode, 0, -1)],
                         what="FITS")
    w, h = _legacy_size(size, "FITS")
    out = np.empty((h, w, 3), np.uint8)
    _call("fits_gzip", data, len(data), lay["offset"], lay["bitpix"],
          LEGACY_MODES.index(mode), out, h, w)
    return out


def decode_mcidas(data: bytes, path: bool = False) -> np.ndarray:
    """A McIdas area file's bytes -> RGB uint8 [H, W, 3]: rows of L, I;16B
    or I;32B at the header's stride. `path`: a file Pillow opens from its
    path, whose L and I;16B rows it memory-maps where the rows' span
    fits the file (rows at the stride even where it is shorter than a row,
    the whole rows of a stride of 0 or less)."""
    mode, size, lay = _layout(data, "MCIDAS")
    offset, stride, rawmode = lay["offset"], lay["stride"], lay["rawmode"]
    w, h = _legacy_size(size, "MCIDAS")
    if path and mode in ("L", "I;16B") and offset >= 0:
        row = w * (1 if mode == "L" else 2)
        if stride > 0 and offset + h * stride <= len(data):
            mapped = b"".join(
                data[offset + y * stride:offset + y * stride + row]
                .ljust(row, b"\0") for y in range(h))
            return raw_tiles(mapped, mode, size, [(0, rawmode, 0, 1)],
                             what="MCIDAS")
        if stride <= 0 and offset <= len(data):
            if offset + h * row > len(data):
                raise ValueError("MCIDAS: buffer is not large enough")
            return raw_tiles(data, mode, size, [(offset, rawmode, 0, 1)],
                             what="MCIDAS")
    return raw_tiles(data, mode, size, [(offset, rawmode, stride, 1)],
                     what="MCIDAS")


def decode_imt(data: bytes) -> np.ndarray:
    """An IM Tools file's bytes -> RGB uint8 [H, W, 3]: L rows after the
    header's form feed."""
    mode, size, lay = _layout(data, "IMT")
    if lay is None:
        raise ValueError("IMT: cannot load this image (no form feed ends "
                         "the header)")
    return raw_tiles(data, mode, size, [(lay["offset"], "L", 0, 1)],
                     what="IMT")


# XVThumbImagePlugin.PALETTE: 3-3-2 bits of R, G, B
XV_PALETTE = bytes(v for r in range(8) for g in range(8) for b in range(4)
                   for v in (r * 255 // 7, g * 255 // 7, b * 255 // 3))


def decode_xvthumb(data: bytes) -> np.ndarray:
    """An XV thumbnail's bytes -> RGB uint8 [H, W, 3]: P rows under the
    fixed 3-3-2 palette."""
    _, size, lay = _layout(data, "XVTHUMB")
    return raw_tiles(data, "P", size, [(lay["offset"], "P", 0, 1)],
                     XV_PALETTE, "XVTHUMB")


def decode_pixar(data: bytes) -> np.ndarray:
    """A PIXAR file's bytes -> RGB uint8 [H, W, 3]: RGB rows at 1024."""
    mode, size, _ = _layout(data, "PIXAR")
    return raw_tiles(data, mode, size, [(1024, "RGB", 0, 1)], what="PIXAR")


def decode_gbr(data: bytes) -> np.ndarray:
    """A GIMP brush's bytes -> RGB uint8 [H, W, 3]: L or RGBA pixels after
    the comment, as GbrImageFile.load's frombytes reads them (a short read
    is "not enough image data")."""
    mode, size, lay = _layout(data, "GBR")
    return raw_tiles(data, mode, size, [(lay["offset"], mode, 0, 1)],
                     what="GBR")


def decode_ftex(data: bytes) -> np.ndarray:
    """An FTEX file's bytes -> RGB uint8 [H, W, 3]: its mipmap's data as
    raw RGB (format 1) or BC1 blocks (format 0, csrc/bcn_decode.cpp)."""
    _, size, lay = _layout(data, "FTEX")
    w, h = _legacy_size(size, "FTEX")
    mip = lay["data"]
    if lay["format"] == 1:
        return raw_tiles(mip, "RGB", size, [(0, "RGB", 0, 1)], what="FTEX")
    out = np.empty((h, w, 3), np.uint8)
    _call("bcn", mip, len(mip), 0, 1, 0, out, h, w)
    return out


def decode_xbm(data: bytes) -> np.ndarray:
    """An XBM file's bytes -> RGB uint8 [H, W, 3] (XbmDecode.c)."""
    _, size, lay = _layout(data, "XBM")
    w, h = _legacy_size(size, "XBM")
    out = np.empty((h, w, 3), np.uint8)
    _call("xbm", data, len(data), lay["offset"], out, h, w)
    return out


def decode_xpm(data: bytes) -> np.ndarray:
    """An XPM file's bytes -> RGB uint8 [H, W, 3]: the colour table as
    XpmImageFile._open reads it (image_probe), the pixels as XpmDecoder
    reads them (csrc/image_legacy.cpp mrt_xpm)."""
    _, size, lay = _layout(data, "XPM")
    w, h = _legacy_size(size, "XPM")
    keys = list(lay["palette"])
    colours = b"".join(lay["palette"][k] for k in keys) or b"\0"
    lengths = np.array([len(k) for k in keys] or [0], np.int32)
    out = np.empty((h, w, 3), np.uint8)
    _call("xpm", data, len(data), lay["offset"], lay["bpp"],
          b"".join(keys) or b"\0", lengths.ctypes.data, len(keys), colours,
          out, h, w)
    return out


def decode_msp(data: bytes) -> np.ndarray:
    """An MSP file's bytes -> RGB uint8 [H, W, 3]: version 1's raw "1"
    rows, version 2's runs (MspDecoder, csrc/image_legacy.cpp)."""
    _, size, lay = _layout(data, "MSP")
    if lay["version"] == 1:
        return raw_tiles(data, "1", size, [(32, "1", 0, 1)], what="MSP")
    w, h = _legacy_size(size, "MSP")
    out = np.empty((h, w, 3), np.uint8)
    _call("msp", data, len(data), out, h, w)
    return out


def decode_fli(data: bytes) -> np.ndarray:
    """An FLI or FLC file's bytes -> its first frame, RGB uint8 [H, W, 3]:
    the palette of the frame's first COLOR chunk (FliImageFile._palette)
    and the frame through FliDecode.c (csrc/image_legacy.cpp)."""
    _, size, lay = _layout(data, "FLI")
    w, h = _legacy_size(size, "FLI")
    out = np.empty((h, w, 3), np.uint8)
    _call("fli", data, len(data), lay["offset"], lay["palette"], out, h, w)
    return out


def decode_pcd(data: bytes) -> np.ndarray:
    """A Photo CD file's bytes -> its 768x512 base image, RGB uint8, turned
    as its orientation byte says (PcdDecode.c and PhotoYCC -> RGB,
    csrc/image_legacy.cpp)."""
    _, _, lay = _layout(data, "PCD")
    out = np.empty((512, 768, 3), np.uint8)
    _call("pcd", data, len(data), 96 * 2048, out, 512, 768)
    turns = {1: 1, 3: 3}.get(lay["orientation"], 0)
    return np.ascontiguousarray(np.rot90(out, turns)) if turns else out


def decode_iptc(data: bytes, read) -> np.ndarray:
    """An IPTC/NAA file's bytes -> RGB uint8 [H, W, 3], as
    IptcImageFile.load reads it: the (8, 10) fields' data joined, behind
    a P5 header where the compression is raw, opened as an image file and
    read by `read` (image_io.read_image: the PPM route, or the JPEG one);
    a band of an RGB or CMYK image merged with black bands into its mode
    (the band image must be L), then convert("RGB")."""
    from maskrcnn_tpu_torch.data import image_probe
    mode, size, lay = _layout(data, "IPTC")
    if lay["offset"] is None:
        raise ValueError("IPTC: cannot load this image (no image data "
                         "field)")
    fp = image_probe._File(data, False)
    fp.seek(lay["offset"])
    inner = bytearray(b"P5\n%d %d\n255\n" % size if lay["raw"] else b"")
    while True:
        try:
            tag, length = image_probe.iptc_field(fp)
        except (SyntaxError, IndexError, struct.error) as e:
            raise ValueError(f"IPTC: a field Pillow's load fails on: {e}") \
                from None
        if tag != (8, 10):
            break
        inner += fp.read(length)
    inner = bytes(inner)
    band = lay["band"]
    if band is None:
        return read(inner)
    name = image_probe.identify(inner)
    if name is None:
        raise ValueError("IPTC: its image data is no image file")
    inner_mode, _, _ = image_probe.plugin_layout(inner, name)
    if inner_mode == "?" and name == "TIFF":   # (a PNG's "?" is not L)
        raise NotImplementedError(f"IPTC: a band held as {name}, whose "
                                  "mode the port does not tell")
    if inner_mode != "L":
        raise ValueError(f"IPTC: a band of mode {inner_mode!r}, not L "
                         "(Image.merge: mode mismatch)")
    bands = {"RGB": 3, "CMYK": 4}[mode]
    if not -bands <= band < bands:
        raise ValueError(f"IPTC: band {band} of a {mode} image")
    band %= bands
    gray = read(inner)[..., 0]
    if mode == "RGB":
        out = np.zeros(gray.shape + (3,), np.uint8)
        out[..., band] = gray
        return out
    # CMYK with one band set, through cmyk2rgb
    cmyk = np.zeros(gray.shape + (4,), np.int32)
    cmyk[..., band] = gray
    nk = 255 - cmyk[..., 3:]
    tmp = cmyk[..., :3] * nk + 128
    return np.clip(nk - (((tmp >> 8) + tmp) >> 8), 0, 255).astype(np.uint8)


# what Pillow raises loading the formats it opens and cannot load here
LOAD_ERRORS = {"BUFR": "cannot find loader for this BUFR file",
               "GRIB": "cannot find loader for this GRIB file",
               "HDF5": "cannot find loader for this HDF5 file",
               "MPEG": "cannot load this image",
               "WMF": "cannot find loader for this WMF file"}
