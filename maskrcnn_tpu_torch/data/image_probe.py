"""Which image format a file is, as Pillow 12.1's `Image.open` tells it.

`identify(data)` returns the format name Pillow's `Image.open(f).format`
gives ("PPM", "TGA", "IM", "JPEG2000", ...), None where `Image.open`
raises UnidentifiedImageError, or raises ValueError (naming the plugin)
where a plugin's `_open` raises anything else and so ends `Image.open`
(Pillow raises an OSError, a ValueError or a DecompressionBombError
there; the port raises ValueError for all of them).

The model follows `Image.open` as the JAX package's readers meet it: the
plugins are tried in `Image.ID` order, the five that `preinit` imports
first (BMP with DIB, GIF, JPEG, PPM, PNG), then every other plugin in
the order `init` imports them (ORDER). A plugin with an `_accept` sees
the file's first 16 bytes; if it accepts, or if it has none (IM, IMT,
IPTC, PCD, SPIDER and TGA), its `_open` runs on the whole file, and a
SyntaxError, IndexError, TypeError or struct.error from it (or a
KeyError or EOFError, which ImageFile turns into SyntaxError, or a mode
or size ImageFile refuses) passes the file on to the next plugin. Each
`_open` below copies the logic of Pillow's header checks, not its code;
where an `_open` reads the file with Python's int() or float(), so does
the model, so that the same tokens pass. The decompression-bomb check
(more than MAX_PIXELS pixels) then ends `Image.open` as it does in
Pillow.

JPEG's `_open` is modelled whole (its marker walk up to the first
scan). For the other formats the port read before the probe (BMP, GIF,
PNG, TIFF, WebP) only the conditions that pass a file on are modelled; where
their `_open` would raise, the format is returned and its decoder
raises (a ValueError, or the NotImplementedError naming a mode the port
refuses). IcoImageFile loads its frame inside `_open`: a frame that
fails to load (a file cut short, an AND mask past the data, a PNG
frame whose image data runs into a broken chunk) makes Image.open raise
or pass the file on to plugins that cannot load it either; there the
probe returns "ICO" and the ICO decoder raises the ValueError. AVIF's
`_open` runs libavif 1.3's avifDecoderParse, which the model follows
(`_avif_parse`: the top-level boxes, the meta box's children and their
checks, the items' properties, the primary and alpha items, and for an
item without CICP the search for its AV1 sequence header, whose OBUs
`av1_sequence_header` parses); its size and mode are the image's
(the primary item's ispe; RGBA with an alpha item), and `avif_layout`
hands the items and their colour to the AVIF decoder. The plugins whose files the port decodes past their header
leave what their decoder reads in `_File.layout` (`plugin_layout`).
PSD's `_open` looks (mode, bits) up in
PsdImagePlugin.MODES, whose pairs alone open. tests/test_torch_image_probe.py
holds the model to live Pillow on thousands of seeded prefixes, and
tests/test_torch_image_blp_psd.py on edited AVIF and PSD files.
"""

from __future__ import annotations

import io
import math
import re
import struct
import zlib
from typing import Optional

from maskrcnn_tpu_torch.data.native_image import MAX_PIXELS

# Image.ID after preinit() and init(), as a fresh process's Image.open
# builds it
ORDER = ("BMP", "DIB", "GIF", "JPEG", "PPM", "PNG", "AVIF", "BLP", "BUFR",
         "CUR", "PCX", "DCX", "DDS", "EPS", "FITS", "FLI", "FTEX", "GBR",
         "GRIB", "HDF5", "JPEG2000", "ICNS", "ICO", "IM", "IMT", "IPTC",
         "MCIDAS", "MPEG", "TIFF", "MSP", "PCD", "PIXAR", "PSD", "QOI", "SGI",
         "SPIDER", "SUN", "TGA", "WEBP", "WMF", "XBM", "XPM", "XVTHUMB")
# the format an Image.ID entry's plugin gives (Image.register_open keys
# the plugins by their format upper-cased)
FORMATS = {"XVTHUMB": "XVThumb"}
# what _open_core passes on: ImageFile turns IndexError, TypeError,
# KeyError, EOFError and struct.error from an _open into SyntaxError
_PASS = (SyntaxError, IndexError, TypeError, KeyError, EOFError,
         struct.error)
PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
JP2_MAGIC = b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a"
TIFF_PREFIXES = (b"MM\x00\x2a", b"II\x2a\x00", b"MM\x2a\x00", b"II\x00\x2a",
                 b"MM\x00\x2b", b"II\x2b\x00")


class _Bomb(Exception):
    """Pillow's DecompressionBombError."""


def _le16(s, o=0):
    return struct.unpack_from("<H", s, o)[0]


def _le32(s, o=0):
    return struct.unpack_from("<I", s, o)[0]


def _be16(s, o=0):
    return struct.unpack_from(">H", s, o)[0]


def _be32(s, o=0):
    return struct.unpack_from(">I", s, o)[0]


def _bomb_check(size) -> None:
    w, h = size[0], size[1]
    if w * h > MAX_PIXELS:
        raise _Bomb(f"image size {w}x{h} is past the decompression-bomb "
                    f"limit of {MAX_PIXELS} pixels")


# ----------------------------------------------------------- the accepts

def _avif_accept(p):
    return p[4:8] == b"ftyp" and p[8:12] in (b"avif", b"avis", b"mif1",
                                             b"msf1")


def _fli_accept(p):
    return (len(p) >= 16 and _le16(p, 4) in (0xAF11, 0xAF12)
            and _le16(p, 14) in (0, 3))


ACCEPT = {
    "BMP": lambda p: p.startswith(b"BM"),
    "DIB": lambda p: len(p) >= 4 and _le32(p) in (12, 40, 52, 56, 64, 108,
                                                  124),
    "GIF": lambda p: p.startswith((b"GIF87a", b"GIF89a")),
    "JPEG": lambda p: p.startswith(b"\xff\xd8\xff"),
    "PPM": lambda p: len(p) >= 2 and p[:1] == b"P" and p[1] in b"0123456fy",
    "PNG": lambda p: p.startswith(PNG_MAGIC),
    "AVIF": _avif_accept,
    "BLP": lambda p: p.startswith((b"BLP1", b"BLP2")),
    "BUFR": lambda p: p.startswith((b"BUFR", b"ZCZC")),
    "CUR": lambda p: p.startswith(b"\0\0\2\0"),
    "PCX": lambda p: len(p) >= 2 and p[0] == 10 and p[1] in (0, 2, 3, 5),
    "DCX": lambda p: len(p) >= 4 and _le32(p) == 987654321,
    "DDS": lambda p: p.startswith(b"DDS "),
    "EPS": lambda p: p.startswith(b"%!PS") or (len(p) >= 4
                                               and _le32(p) == 0xC6D3D0C5),
    "FITS": lambda p: p.startswith(b"SIMPLE"),
    "FLI": _fli_accept,
    "FTEX": lambda p: p.startswith(b"FTEX"),
    "GBR": lambda p: len(p) >= 8 and _be32(p) >= 20 and _be32(p, 4) in (1, 2),
    "GRIB": lambda p: len(p) >= 8 and p.startswith(b"GRIB") and p[7] == 1,
    "HDF5": lambda p: p.startswith(b"\x89HDF\r\n\x1a\n"),
    "JPEG2000": lambda p: p.startswith((b"\xff\x4f\xff\x51", JP2_MAGIC)),
    "ICNS": lambda p: p.startswith(b"icns"),
    "ICO": lambda p: p.startswith(b"\0\0\1\0"),
    "MCIDAS": lambda p: p.startswith(b"\0\0\0\0\0\0\0\4"),
    "MPEG": lambda p: p.startswith(b"\0\0\1\xb3"),
    "TIFF": lambda p: p.startswith(TIFF_PREFIXES),
    "MSP": lambda p: p.startswith((b"DanM", b"LinS")),
    "PIXAR": lambda p: p.startswith(b"\x80\xe8\0\0"),
    "PSD": lambda p: p.startswith(b"8BPS"),
    "QOI": lambda p: p.startswith(b"qoif"),
    "SGI": lambda p: len(p) >= 2 and _be16(p) == 474,
    "SUN": lambda p: len(p) >= 4 and _be32(p) == 0x59A66A95,
    "WEBP": lambda p: (p.startswith(b"RIFF") and p[8:12] == b"WEBP"
                       and p[12:16] in (b"VP8 ", b"VP8X", b"VP8L")),
    "WMF": lambda p: p.startswith((b"\xd7\xcd\xc6\x9a\0\0", b"\1\0\0\0")),
    "XBM": lambda p: p.lstrip().startswith(b"#define"),
    "XPM": lambda p: p.startswith(b"/* XPM */"),
    "XVTHUMB": lambda p: p.startswith(b"P7 332"),
}


# ------------------------------------------------------ the formats read
# Each _open_<name>(fp) returns (mode, size) as the plugin's _open leaves
# them, raising what it raises.

_BMP_HEADERS = (40, 52, 56, 64, 108, 124)
_BMP_FIELDS = {32: ((0xFF0000, 0xFF00, 0xFF, 0),
                    (0xFF000000, 0xFF0000, 0xFF00, 0),
                    (0xFF000000, 0xFF00, 0xFF, 0),
                    (0xFF000000, 0xFF0000, 0xFF00, 0xFF),
                    (0xFF, 0xFF00, 0xFF0000, 0xFF000000),
                    (0xFF0000, 0xFF00, 0xFF, 0xFF000000),
                    (0xFF000000, 0xFF00, 0xFF, 0xFF0000), (0, 0, 0, 0)),
               24: ((0xFF0000, 0xFF00, 0xFF),),
               16: ((0xF800, 0x7E0, 0x1F), (0x7C00, 0x3E0, 0x1F))}


def _open_bmp(fp, header=0):
    """BmpImageFile._bitmap: the header's size, and a ValueError where
    _bitmap raises (its depth, bit-fields layout, compression and
    palette size checks, which end Image.open)."""
    if header:
        fp.seek(header)
    size = _le32(fp.read(4))
    data = fp.read(max(size - 4, 0))
    if len(data) < size - 4:
        raise ValueError("BMP: Truncated File Read")
    if size == 12:
        width, height, bits = _le16(data, 0), _le16(data, 2), _le16(data, 6)
        compression, colors = 0, 0
    elif size in _BMP_HEADERS:
        flip = data[7] == 0xFF
        width, h = _le32(data, 0), _le32(data, 4)
        height = 2 ** 32 - h if flip else h
        bits, compression = _le16(data, 10), _le32(data, 12)
        colors = _le32(data, 28)
        if compression == 3:
            if len(data) >= 48:
                masks = [_le32(data, 36 + 4 * i) for i in range(3)]
                masks.append(_le32(data, 48) if len(data) >= 52 else 0)
            else:
                masks = [_le32(fp.read(4)) for _ in range(3)] + [0]
    else:
        raise ValueError(f"BMP: unsupported BMP header type ({size})")
    if bits not in (1, 4, 8, 16, 24, 32):
        raise ValueError(f"BMP: unsupported BMP pixel depth ({bits})")
    if compression == 3:
        fields = _BMP_FIELDS.get(bits, ())
        if tuple(masks if bits == 32 else masks[:3]) not in fields:
            raise ValueError("BMP: unsupported BMP bitfields layout")
    elif compression not in (0, 1, 2):
        raise ValueError(f"BMP: unsupported BMP compression "
                         f"({compression})")
    colors = colors or 1 << bits
    if bits <= 8 and not 0 < colors <= 65536:
        raise ValueError(f"BMP: unsupported BMP palette size ({colors})")
    return "?", (width, height)


def _open_bmp_file(fp):
    head = fp.read(14)
    if not head.startswith(b"BM"):
        raise SyntaxError("not a BMP file")
    _le32(head, 10)
    return _open_bmp(fp)


def _gif_block(fp):
    n = fp.read(1)
    return fp.read(n[0]) if n and n[0] else None


def _open_gif(fp):
    s = fp.read(13)
    size = (_le16(s, 6), _le16(s, 8))
    flags = s[10]
    if flags & 128:
        fp.read(3 << ((flags & 7) + 1))
    # GifImageFile._seek(0): the blocks up to the first image descriptor;
    # an EOFError (passed on) where there is none
    s = fp.read(1)
    if not s or s == b";":
        raise EOFError("no more images in GIF file")
    while True:
        if not s:
            s = fp.read(1)
        if not s or s == b";":
            raise EOFError("image not found in GIF frame")
        if s == b"!":
            s = fp.read(1)
            block = _gif_block(fp)
            if s[0] == 249 and block is not None:
                if block[0] & 1:
                    block[3]
                _le16(block, 1)
            elif s[0] == 254:
                while block:
                    block = _gif_block(fp)
                s = b""
                continue
            elif s[0] == 255 and block is not None:
                if block.startswith(b"NETSCAPE2.0"):
                    block = _gif_block(fp)
                    if block and len(block) >= 3 and block[0] == 1:
                        _le16(block, 1)
            while _gif_block(fp):
                pass
        elif s == b",":
            s = fp.read(9)
            x0, y0 = _le16(s, 0), _le16(s, 2)
            x1, y1 = x0 + _le16(s, 4), y0 + _le16(s, 6)
            if x1 > size[0] or y1 > size[1]:
                size = max(x1, size[0]), max(y1, size[1])
                _bomb_check(size)
            if s[8] & 128:
                fp.read(3 << ((s[8] & 7) + 1))
            fp.read(1)[0]
            return "?", size
        s = b""


def _open_png(fp):
    """PngImageFile._open: the chunks up to IDAT or IEND, each chunk's
    type and checksum checked (a bad one passes the file on); a chunk cut
    short is the decoder's to refuse."""
    fp.read(8)
    size, mode = (0, 0), ""
    while True:
        s = fp.read(8)
        length, cid = _be32(s), s[4:]
        if not re.match(rb"\w\w\w\w", cid):
            raise SyntaxError(f"broken PNG file (chunk {cid!r})")
        if cid in (b"IDAT", b"IEND"):
            return mode, size
        body = fp.read(length)
        if len(body) < length or (cid == b"IHDR" and length < 13):
            return "?", (1, 1)
        if cid == b"IHDR":
            size = (_be32(body), _be32(body, 4))
            mode = ("" if (body[8], body[9]) not in _PNG_MODES else
                    "L" if body[9] == 0 and body[8] in (2, 4, 8) else "?")
            if body[11]:
                raise SyntaxError("unknown filter category")
        crc = fp.read(4)
        if len(crc) < 4 or zlib.crc32(cid + body) != _be32(crc):
            raise SyntaxError(f"broken PNG file (bad header checksum in "
                              f"{cid!r})")


_PNG_MODES = {(1, 0), (2, 0), (4, 0), (8, 0), (16, 0), (8, 2), (16, 2),
              (1, 3), (2, 3), (4, 3), (8, 3), (8, 4), (16, 4), (8, 6),
              (16, 6)}

_PPM_MODES = {b"P1": "1", b"P2": "L", b"P3": "RGB", b"P4": "1", b"P5": "L",
              b"P6": "RGB", b"P0CMYK": "CMYK", b"Pf": "F", b"PyP": "P",
              b"PyRGBA": "RGBA", b"PyCMYK": "CMYK"}
_WHITESPACE = b" \t\n\x0b\x0c\r"


def _ppm_token(fp) -> bytes:
    token = b""
    while len(token) <= 10:
        c = fp.read(1)
        if not c:
            break
        if c in _WHITESPACE:
            if not token:
                continue
            break
        if c == b"#":
            while fp.read(1) not in b"\r\n":
                pass
            continue
        token += c
    if not token:
        raise ValueError("PPM: reached the end of the file in its header")
    if len(token) > 10:
        raise ValueError("PPM: a header token is too long")
    return token


def _open_ppm(fp):
    magic = b""
    for _ in range(6):
        c = fp.read(1)
        if not c or c in _WHITESPACE:
            break
        magic += c
    mode = _PPM_MODES.get(magic)
    if mode is None:
        raise SyntaxError("not a PPM file")
    size = int(_ppm_token(fp)), int(_ppm_token(fp))
    if mode == "F":
        scale = float(_ppm_token(fp))
        if scale == 0.0 or not math.isfinite(scale):
            raise ValueError("PPM: scale must be finite and non-zero")
    elif mode != "1":
        maxval = int(_ppm_token(fp))
        if not 0 < maxval < 65536:
            raise ValueError("PPM: maxval must be greater than 0 and less "
                             "than 65536")
    return mode, size


def _open_tga(fp):
    s = fp.read(18)
    colormaptype, imagetype, depth, flags = s[1], s[2], s[16], s[17]
    size = _le16(s, 12), _le16(s, 14)
    if (colormaptype not in (0, 1) or size[0] <= 0 or size[1] <= 0
            or depth not in (1, 8, 16, 24, 32)):
        raise SyntaxError("not a TGA file")
    if imagetype not in (1, 2, 3, 9, 10, 11):
        raise SyntaxError("unknown TGA mode")
    if flags & 0x30 not in (0, 0x10, 0x20, 0x30):
        raise SyntaxError("unknown TGA orientation")
    if colormaptype and s[7] not in (16, 24, 32):
        raise SyntaxError("unknown TGA map depth")
    return "RGB", size


def _open_qoi(fp):
    if fp.read(4) != b"qoif":
        raise SyntaxError("not a QOI file")
    size = _be32(fp.read(4)), _be32(fp.read(4))
    fp.read(1)[0]
    return "RGB", size


def _ico_entries(fp):
    s = fp.read(6)
    entries = []
    for _ in range(_le16(s, 4)):
        e = fp.read(16)
        width, height = e[0] or 256, e[1] or 256
        nb_color, bpp = e[2], _le16(e, 6)
        depth = bpp or (nb_color != 0 and math.ceil(math.log(nb_color, 2))) \
            or 256
        entries.append((width, height, depth, _le32(e, 8), _le32(e, 12),
                        bpp))
    entries.sort(key=lambda x: x[2])
    entries.sort(key=lambda x: x[0] * x[1], reverse=True)
    return entries


def ico_entry(data: bytes):
    """The (width, height, colour depth, size, offset, bpp) of the
    directory entry IcoImageFile loads: the largest, ties to the lowest
    colour depth, then the first (IcoFile's two sorts)."""
    return _ico_entries(io.BytesIO(data))[0]


def _open_ico(fp):
    entry = _ico_entries(fp)[0]
    # IcoImageFile._open loads the entry: the nested PNG's or DIB's _open
    # passes a file on as they do; a short PNG signature read, a DIB
    # whose header Pillow reads short (struct.error) pass it on too
    fp.seek(entry[4])
    head = fp.read(8)
    fp.seek(entry[4])
    if head == PNG_MAGIC:
        mode, size = _open_png(fp)
    else:
        mode, size = _open_bmp(fp, header=entry[4])
    # the nested image's own ImageFile checks, then its bomb check
    if not mode or size[0] <= 0 or size[1] <= 0:
        raise SyntaxError("an empty mode or size")
    _bomb_check(size)
    return "RGB", size if head == PNG_MAGIC else (size[0], int(size[1] / 2))


def _cur_frame(fp) -> int:
    s = fp.read(6)
    m = b""
    for _ in range(_le16(s, 4)):
        e = fp.read(16)
        if not m:
            m = e
        elif e[0] > m[0] and e[1] > m[1]:
            m = e
    if not m:
        raise TypeError("No cursors were found")
    # _bitmap(header): no seek for a header offset of 0
    return _le32(m, 12) or fp.tell()


def cur_frame(data: bytes) -> int:
    """Where the DIB header of the cursor CurImageFile loads starts: the
    first entry, or a later one larger in both sides."""
    return _cur_frame(io.BytesIO(data))


def _open_cur(fp):
    at = _cur_frame(fp)
    fp.seek(at)
    mode, size = _open_bmp(fp)
    return "RGB", (size[0], size[1] // 2)


def _open_pcx(fp):
    s = fp.read(68)
    if not ACCEPT["PCX"](s):
        raise SyntaxError("not a PCX file")
    bbox = _le16(s, 4), _le16(s, 6), _le16(s, 8) + 1, _le16(s, 10) + 1
    if bbox[2] <= bbox[0] or bbox[3] <= bbox[1]:
        raise SyntaxError("bad PCX image size")
    version, bits, planes = s[1], s[3], s[65]
    _le16(s, 66)
    _le16(s, 12), _le16(s, 14)
    if not ((bits == 1 and planes in (1, 2, 4))
            or (version == 5 and bits == 8 and planes in (1, 3))):
        raise ValueError("PCX: unknown PCX mode")
    if (bits, planes) == (8, 1) and fp.path and len(fp.getbuffer()) < 769:
        # the seek to the palette, 769 bytes before the end, from a path
        raise ValueError("PCX: [Errno 22] Invalid argument")
    return "RGB", (bbox[2] - bbox[0], bbox[3] - bbox[1])


def _open_dcx(fp):
    fp.read(4)
    offsets = []
    for _ in range(1024):
        offset = _le32(fp.read(4))
        if not offset:
            break
        offsets.append(offset)
    fp.seek(offsets[0])
    return _open_pcx(fp)


_SGI_MODES = {(1, 1, 1), (1, 2, 1), (2, 1, 1), (2, 2, 1), (1, 3, 3),
              (2, 3, 3), (1, 3, 4), (2, 3, 4)}


def _open_sgi(fp):
    s = fp.read(512)
    if not ACCEPT["SGI"](s):
        raise ValueError("SGI: not an SGI image file")
    key = (s[3], _be16(s, 4), _be16(s, 10))
    size = _be16(s, 6), _be16(s, 8)
    if key not in _SGI_MODES:
        raise ValueError("SGI: unsupported SGI image mode")
    return "RGB", size


def _open_sun(fp):
    s = fp.read(32)
    if not ACCEPT["SUN"](s):
        raise SyntaxError("not an SUN raster file")
    size = _be32(s, 4), _be32(s, 8)
    depth, file_type = _be32(s, 12), _be32(s, 20)
    palette_type, palette_length = _be32(s, 24), _be32(s, 28)
    if depth not in (1, 4, 8, 24, 32):
        raise SyntaxError("Unsupported Mode/Bit Depth")
    if palette_length:
        if palette_length > 1024:
            raise SyntaxError("Unsupported Color Palette Length")
        if palette_type != 1:
            raise SyntaxError("Unsupported Palette Type")
    if file_type not in (0, 1, 2, 3, 4, 5):
        raise SyntaxError("Unsupported Sun Raster file type")
    return "RGB", size


# ------------------------------------------- the formats the port lacks

def _open_stub(fp):
    """BUFR, GRIB and HDF5: their _open checks the accept again and makes
    up a 1x1 image (Pillow opens the file, and cannot load it)."""
    return "F", (1, 1)


def _open_im(fp):
    if b"\n" not in fp.read(100):
        raise SyntaxError("not an IM file")
    fp.seek(0)
    n = 0
    info = {"Image type": "L", "Image size (x*y)": (512, 512)}
    rawmode = "L"
    tags = {"Comment", "Date", "Digitalization equipment", "File size (no of "
            "images)", "Lut", "Name", "Scale (x,y)", "Image size (x*y)",
            "Image type"}
    s = b""
    while True:
        s = fp.read(1)
        if s == b"\r":
            continue
        if not s or s == b"\0" or s == b"\x1a":
            break
        s = s + fp.readline()
        if len(s) > 100:
            raise SyntaxError("not an IM file")
        if s.endswith(b"\r\n"):
            s = s[:-2]
        elif s.endswith(b"\n"):
            s = s[:-1]
        m = re.match(rb"^([A-Za-z][^:]*):[ \t]*(.*)[ \t]*$", s)
        if not m:
            raise SyntaxError("Syntax error in IM header")
        k, v = (g.decode("latin-1", "replace") for g in m.group(1, 2))
        if k in ("File size (no of images)", "Scale (x,y)",
                 "Image size (x*y)"):
            v = tuple(_im_number(x) for x in v.replace("*", ",").split(","))
            if len(v) == 1:
                v = v[0]
        elif k == "Image type" and v in _IM_OPEN:
            v, rawmode = _IM_OPEN[v]
        info[k] = v
        if k in tags:
            n += 1
    if not n:
        raise SyntaxError("Not an IM file")
    size, mode = info["Image size (x*y)"], info["Image type"]
    while s and not s.startswith(b"\x1a"):
        s = fp.read(1)
    if not s:
        raise SyntaxError("File truncated")
    palette = None
    if "Lut" in info:
        palette = fp.read(768)
        grey = True
        for i in range(256):
            # (a short Lut raises IndexError here, as in Pillow)
            if not palette[i] == palette[i + 256] == palette[i + 512]:
                grey = False
        if not grey and mode in ("L", "LA", "P", "PA"):
            # a colour Lut makes L and P palette images, LA and PA ones PA
            mode, rawmode = (("P", "P") if mode in ("L", "P")
                             else ("PA", "PA;L"))
        else:
            palette = None
    fp.layout = {"mode": mode, "rawmode": rawmode, "offset": fp.tell(),
                 "palette": palette}
    return info["Image type"], size


def _im_number(s):
    try:
        return int(s)
    except ValueError:
        return float(s)


def _im_open_table():
    """ImImagePlugin.OPEN: (mode, raw mode) of each image type."""
    table = {"0 1 image": ("1", "1"), "L 1 image": ("1", "1"),
             "Greyscale image": ("L", "L"), "Grayscale image": ("L", "L"),
             "RGB image": ("RGB", "RGB;L"), "RLB image": ("RGB", "RLB"),
             "RYB image": ("RGB", "RLB"), "B1 image": ("1", "1"),
             "B2 image": ("P", "P;2"), "B4 image": ("P", "P;4"),
             "X 24 image": ("RGB", "RGB"), "L 32 S image": ("I", "I;32"),
             "L 32 F image": ("F", "F;32"), "RGB3 image": ("RGB", "RGB;T"),
             "RYB3 image": ("RGB", "RYB;T"), "LA image": ("LA", "LA;L"),
             "PA image": ("LA", "PA;L"), "RGBA image": ("RGBA", "RGBA;L"),
             "RGBX image": ("RGB", "RGBX;L"), "CMYK image": ("CMYK", "CMYK;L"),
             "YCC image": ("YCbCr", "YCbCr;L")}
    for i in ("8", "8S", "16", "16S", "32", "32F"):
        table[f"L {i} image"] = table[f"L*{i} image"] = ("F", f"F;{i}")
    for i in ("16", "16L", "16B"):
        table[f"L {i} image"] = table[f"L*{i} image"] = (f"I;{i}", f"I;{i}")
    table["L 32S image"] = table["L*32S image"] = ("I", "I;32S")
    for j in range(2, 33):
        table[f"L*{j} image"] = ("F", f"F;{j}")
    return table


_IM_OPEN = _im_open_table()


def _open_imt(fp):
    buffer = fp.read(100)
    if b"\n" not in buffer:
        raise SyntaxError("not an IM file")
    mode, size = "", (0, 0)
    xsize = ysize = 0
    while True:
        if buffer:
            s, buffer = buffer[:1], buffer[1:]
        else:
            s = fp.read(1)
        if not s:
            break
        if s == b"\x0c":
            fp.layout = {"offset": fp.tell() - len(buffer)}
            break
        if b"\n" not in buffer:
            buffer += fp.read(100)
        lines = buffer.split(b"\n")
        s += lines.pop(0)
        buffer = b"\n".join(lines)
        if len(s) == 1 or len(s) > 100:
            break
        if s[0] == ord(b"*"):
            continue
        m = re.match(rb"([a-z]*) ([^ \r\n]*)", s)
        if not m:
            break
        k, v = m.group(1, 2)
        if k == b"width":
            xsize = int(v)
            size = xsize, ysize
        elif k == b"height":
            ysize = int(v)
            size = xsize, ysize
        elif k == b"pixel" and v == b"n8":
            mode = "L"
    return mode, size


def _iptc_int(c) -> int:
    return _be32((b"\0\0\0\0" + c)[-4:])


def iptc_field(fp):
    """IptcImageFile.field: the next field's (tag, size), (None, 0) at
    zeros or the file's end; raises as Pillow's does (IndexError or
    struct.error on a header cut short)."""
    s = fp.read(5)
    if not s.strip(b"\x00"):
        return None, 0
    tag = s[1], s[2]
    if s[0] != 0x1C or tag[0] not in (1, 2, 3, 4, 5, 6, 7, 8, 9, 240):
        raise SyntaxError("invalid IPTC/NAA file")
    size = s[3]
    if size > 132:
        raise ValueError("IPTC: illegal field length")
    if size == 128:
        return tag, 0
    if size > 128:
        return tag, _iptc_int(fp.read(size - 128))
    return tag, _be16(s, 3)


def _open_iptc(fp):
    info = {}
    while True:
        offset = fp.tell()
        tag, size = iptc_field(fp)
        if not tag or tag == (8, 10):
            break
        data = fp.read(size) if size else None
        if tag in info:
            if isinstance(info[tag], list):
                info[tag].append(data)
            else:
                info[tag] = [info[tag], data]
        else:
            info[tag] = data
    layers, component = info[(3, 60)][0], info[(3, 60)][1]
    mode, band = "", None
    if layers == 1 and not component:
        mode = "L"
    else:
        if layers == 3 and component:
            mode = "RGB"
        elif layers == 4 and component:
            mode = "CMYK"
        band = info[(3, 65)][0] - 1 if (3, 65) in info else 0
    size = _iptc_int(info[(3, 20)]), _iptc_int(info[(3, 30)])
    try:
        if _iptc_int(info[(3, 120)]) not in (1, 5):
            raise KeyError
    except KeyError:
        raise ValueError("IPTC: unknown IPTC image compression") from None
    fp.layout = {"offset": offset if tag == (8, 10) else None, "band": band,
                 "raw": _iptc_int(info[(3, 120)]) == 1}
    return mode, size


def _open_pcd(fp):
    fp.seek(2048)
    s = fp.read(1539)
    if not s.startswith(b"PCD_"):
        raise SyntaxError("not a PCD file")
    orientation = s[1538] & 3
    fp.layout = {"orientation": orientation}
    return "RGB", (512, 768) if orientation in (1, 3) else (768, 512)


def _spider_int(f) -> bool:
    try:
        return f - int(f) == 0
    except (ValueError, OverflowError):
        return False


def _spider_header(t) -> int:
    h = (99,) + t
    if not all(_spider_int(h[i]) for i in (1, 2, 5, 12, 13, 22, 23)):
        return 0
    if int(h[5]) not in (1, 3, -11, -12, -21, -22):
        return 0
    if int(h[22]) != int(h[13]) * int(h[23]):
        return 0
    return int(h[22])


def _open_spider(fp):
    f = fp.read(27 * 4)
    big = True
    try:
        t = struct.unpack(">27f", f)
        hdrlen = _spider_header(t)
        if hdrlen == 0:
            big = False
            t = struct.unpack("<27f", f)
            hdrlen = _spider_header(t)
        if hdrlen == 0:
            raise SyntaxError("not a valid Spider file")
    except struct.error:
        raise SyntaxError("not a valid Spider file") from None
    h = (99,) + t
    if int(h[5]) != 1:
        raise SyntaxError("not a Spider 2D image")
    size = int(h[12]), int(h[2])
    istack, imgnumber = int(h[24]), int(h[27])
    offset = hdrlen
    if istack == 0 and imgnumber == 0:
        pass
    elif istack > 0 and imgnumber == 0:
        int(h[26])
        offset = 2 * hdrlen
    elif istack == 0 and imgnumber > 0:
        # SpiderImageFile reads self.stkoffset, which only seek() sets
        raise ValueError("SPIDER: an image within a stack, opened alone")
    else:
        raise SyntaxError("inconsistent stack header values")
    fp.layout = {"offset": offset, "rawmode": "F;32BF" if big else "F;32F"}
    return "F", size


def _open_blp(fp):
    magic = fp.read(4)
    if magic not in (b"BLP1", b"BLP2"):
        raise ValueError("BLP: bad BLP magic")
    struct.unpack("<i", fp.read(4))
    if magic == b"BLP1":
        alpha = struct.unpack("<I", fp.read(4))[0] != 0
    else:
        struct.unpack("<b", fp.read(1))
        alpha = struct.unpack("<b", fp.read(1))[0] != 0
        struct.unpack("<b", fp.read(1))
        fp.seek(1, io.SEEK_CUR)
    size = struct.unpack("<II", fp.read(8))
    if magic == b"BLP1":
        struct.unpack("<i", fp.read(4))
    return "RGBA" if alpha else "RGB", size


_DDS_FOURCC = {b"DXT1", b"DXT3", b"DXT5", b"BC4U", b"ATI1", b"BC5S", b"BC5U",
               b"ATI2"}
_DXGI = {70, 71, 73, 74, 76, 77, 79, 80, 82, 83, 84, 95, 96, 97, 98, 99,
         27, 28, 29}


def _open_dds(fp):
    fp.read(4)
    (header_size,) = struct.unpack("<I", fp.read(4))
    if header_size != 124:
        raise ValueError("DDS: unsupported header size")
    header = fp.read(120)
    if len(header) != 120:
        raise ValueError("DDS: incomplete header")
    flags, height, width = struct.unpack("<3I", header[:12])
    pfflags, fourcc, bitcount = struct.unpack("<I4sI", header[72:84])
    if pfflags & 0x40:                              # RGB
        n = 4 if pfflags & 0x1 else 3
        struct.unpack(f"<{n}I", header[84:84 + 4 * n])
        return "RGB", (width, height)
    if pfflags & 0x20000:                           # LUMINANCE
        if not (bitcount == 8 or (bitcount == 16 and pfflags & 0x1)):
            raise ValueError("DDS: unsupported bitcount")
    elif pfflags & 0x20:                            # PALETTEINDEXED8
        fp.read(1024)
    elif pfflags & 0x4:                             # FOURCC
        if fourcc == b"DX10":
            (dxgi,) = struct.unpack("<I", fp.read(4))
            if dxgi not in _DXGI:
                raise ValueError("DDS: unimplemented DXGI format")
        elif fourcc not in _DDS_FOURCC:
            raise ValueError("DDS: unimplemented pixel format")
    else:
        raise ValueError("DDS: unknown pixel format flags")
    return "RGB", (width, height)


def _open_eps(fp):
    s = fp.read(4)
    if s == b"%!PS":
        fp.seek(0)
    elif _le32(s) == 0xC6D3D0C5:
        fp.seek(_le32(fp.read(8)))
    else:
        raise SyntaxError("not an EPS file")
    info = {}
    box = None
    size = None
    line = bytearray()
    header = True
    trailer_atend = trailer = False
    split = re.compile(r"^%%([^:]*):[ \t]*(.*)[ \t]*$")
    field = re.compile(r"^%[%!\w]([^:]*)[ \t]*$")

    def required():
        if "PS-Adobe" not in info:
            raise SyntaxError("EPS header missing %!PS-Adobe")
        if "BoundingBox" not in info:
            raise SyntaxError("EPS header missing %%BoundingBox")

    def comment(s):
        nonlocal box, trailer_atend
        m = split.match(s)
        if not m:
            return False
        k, v = m.group(1, 2)
        info[k] = v
        if k == "BoundingBox":
            if v == "(atend)":
                trailer_atend = True
            elif not box or (trailer and trailer_atend):
                try:
                    box = [int(float(i)) for i in v.split()]
                except Exception:
                    pass
        return True

    while True:
        byte = fp.read(1)
        if byte == b"":
            if not line:
                if header:
                    required()
                break
        elif byte in b"\r\n":
            if not line:
                continue
        else:
            if len(line) >= 255:
                if line[0] == ord("%"):
                    raise SyntaxError("not an EPS file")
                if header:
                    required()
                    header = False
                line = bytearray()
            line += byte
            continue
        if header:
            if line[:1] != b"%" or line[:13] == b"%%EndComments":
                required()
                header = False
                line = bytearray()
                continue
            s = str(bytes(line), "latin-1")
            if not comment(s):
                m = field.match(s)
                if m:
                    k = m.group(1)
                    info["PS-Adobe" if k.startswith("PS-Adobe") else k] = ""
                elif s[0] != "%":
                    raise ValueError("EPS: bad EPS header")
        elif line[:11] == b"%ImageData:":
            if not size:
                values = line[11:].split(None, 7)
                columns, rows, depth, mode_id = (int(v) for v in values[:4])
                if depth == 1 or (depth == 8 and mode_id in (1, 2, 3, 4)):
                    size = columns, rows
                else:
                    break
        elif line[:5] == b"%%EOF":
            break
        elif trailer and trailer_atend:
            comment(str(bytes(line), "latin-1"))
        elif line[:9] == b"%%Trailer":
            trailer = True
        elif line[:14] == b"%%BeginBinary:":
            fp.seek(int(line[14:]), io.SEEK_CUR)
        line = bytearray()
    if not box:
        raise ValueError("EPS: cannot determine the bounding box")
    return "RGB", size or (box[2] - box[0], box[3] - box[1])


def _open_fits(fp):
    headers = {}
    in_progress = False
    found = None
    while True:
        header = fp.read(80)
        if not header:
            raise ValueError("FITS: truncated FITS file")
        keyword = header[:8].strip()
        if keyword in (b"SIMPLE", b"XTENSION"):
            in_progress = True
        elif headers and not in_progress:
            break
        elif keyword == b"END":
            fp.seek(math.ceil(fp.tell() / 2880) * 2880)
            if not found:
                found = _fits_size(headers)
            in_progress = False
            continue
        if found:
            continue
        value = header[8:].split(b"/")[0].strip()
        if value.startswith(b"="):
            value = value[1:].strip()
        if not headers and (not keyword.startswith(b"SIMPLE")
                            or value != b"T"):
            raise SyntaxError("Not a FITS file")
        headers[keyword] = value
    if not found:
        raise ValueError("FITS: no image data")
    mode, size, gzip, offset, bits = found
    fp.layout = {"gzip": gzip, "offset": offset + fp.tell() - 80,
                 "bitpix": bits}
    return mode, size


def _fits_size(headers):
    """FitsImageFile._parse_headers: (mode, size, whether the data is
    GZIP_1 tiles, the data's offset past the header, BITPIX), or None."""
    prefix, offset = b"", 0
    if (headers.get(b"XTENSION") == b"'BINTABLE'"
            and headers.get(b"ZIMAGE") == b"T"
            and headers[b"ZCMPTYPE"] == b"'GZIP_1  '"):
        table = _fits_axes(headers, b"") or (0, 0)
        offset = table[0] * table[1] * (int(headers[b"BITPIX"]) // 8)
        prefix = b"Z"
    size = _fits_axes(headers, prefix)
    if not size:
        return None
    bits = int(headers[prefix + b"BITPIX"])
    mode = {8: "L", 16: "I;16", 32: "I", -32: "F", -64: "F"}.get(bits, "")
    return mode, size, prefix == b"Z", offset, bits


def _fits_axes(headers, prefix):
    naxis = int(headers[prefix + b"NAXIS"])
    if naxis == 0:
        return None
    if naxis == 1:
        return 1, int(headers[prefix + b"NAXIS1"])
    return int(headers[prefix + b"NAXIS1"]), int(headers[prefix + b"NAXIS2"])


def _open_fli(fp):
    s = s0 = fp.read(128)
    if not (_fli_accept(s) and s[20:22] == b"\0\0" and s[42:80] == bytes(38)
            and s[88:] == bytes(40)):
        raise SyntaxError("not an FLI/FLC file")
    size = _le16(s, 8), _le16(s, 10)
    palette = [(a, a, a) for a in range(256)]
    s = fp.read(16)
    if _le16(s, 4) == 0xF100:
        fp.seek(128 + _le32(s))
        s = fp.read(16)
    if _le16(s, 4) == 0xF1FA:
        chunk_size = None
        for _ in range(_le16(s, 6)):
            if chunk_size is not None:
                fp.seek(chunk_size - 6, io.SEEK_CUR)
            s = fp.read(6)
            chunk_type = _le16(s, 4)
            if chunk_type in (4, 11):
                shift = 2 if chunk_type == 11 else 0
                i = 0
                for _ in range(_le16(fp.read(2))):
                    s = fp.read(2)
                    i += s[0]
                    n = s[1] or 256
                    s = fp.read(n * 3)
                    for k in range(0, len(s), 3):
                        rgb = tuple((s[k + j] << shift) & 255
                                    for j in range(3))
                        if i > 255:
                            raise IndexError("palette index")
                        palette[i] = rgb
                        i += 1
                break
            chunk_size = _le32(s)
            if not chunk_size:
                break
    # seek(0): _seek_check refuses a frame past n_frames, then the first
    # frame's chunk header
    if _le16(s0, 6) == 0:
        raise EOFError("attempt to seek outside sequence")
    fp.seek(128)
    s = fp.read(4)
    if not s:
        raise EOFError("missing frame data")
    _le32(s)
    fp.layout = {"offset": 128, "palette": bytes(v for rgb in palette
                                                 for v in rgb)}
    return "P", size


def _open_ftex(fp):
    fp.read(4)
    struct.unpack("<i", fp.read(4))
    size = struct.unpack("<2i", fp.read(8))
    _, format_count = struct.unpack("<2i", fp.read(8))
    if format_count != 1:
        raise ValueError("FTEX: more than one format")
    fmt, where = struct.unpack("<2i", fp.read(8))
    fp.seek(where)
    (mipmap,) = struct.unpack("<i", fp.read(4))
    fp.layout = {"format": fmt, "data": fp.read(mipmap)}
    if fmt not in (0, 1):
        raise ValueError("FTEX: invalid texture compression format")
    return "RGB", size


def _open_gbr(fp):
    header_size = _be32(fp.read(4))
    if header_size < 20:
        raise SyntaxError("not a GIMP brush")
    version = _be32(fp.read(4))
    if version not in (1, 2):
        raise SyntaxError("unsupported GIMP brush version")
    width, height, depth = (_be32(fp.read(4)) for _ in range(3))
    if width == 0 or height == 0:
        raise SyntaxError("not a GIMP brush")
    if depth not in (1, 4):
        raise SyntaxError("unsupported GIMP brush color depth")
    if version == 2:
        if fp.read(4) != b"GIMP":
            raise SyntaxError("not a GIMP brush, bad magic number")
        _be32(fp.read(4))
    fp.read(header_size - (20 if version == 1 else 28))     # the comment
    _bomb_check((width, height))
    fp.layout = {"offset": fp.tell()}
    return "L" if depth == 1 else "RGBA", (width, height)


def _open_jpeg2000(fp):
    mode, size, _ = _jpeg2000_open(fp)
    return mode, size


def _jpeg2000_open(fp):
    """Jpeg2KImageFile._open: (mode, size, palette), the palette the
    _Palette Pillow builds from a JP2 file's pclr box for mode P or PA, or
    None."""
    sig = fp.read(4)
    if sig == b"\xff\x4f\xff\x51":
        hdr = fp.read(2)
        siz = hdr + fp.read(_be16(hdr) - 2)
        v = struct.unpack_from(">HHIIIIIIIIH", siz)
        size, csiz = (v[2] - v[4], v[3] - v[5]), v[10]
        if csiz == 1:
            ssiz = struct.unpack_from(">B", siz, 38)[0]
            mode = "I;16" if (ssiz & 0x7F) + 1 > 8 else "L"
        elif csiz in (2, 3, 4):
            mode = {2: "LA", 3: "RGB", 4: "RGBA"}[csiz]
        else:
            raise SyntaxError("unable to determine J2K image mode")
        _j2k_comment(fp)
        return mode, size, None
    sig += fp.read(8)
    if sig != JP2_MAGIC:
        raise SyntaxError("not a JPEG 2000 file")
    reader = _Boxes(fp)
    header = None
    while True:
        tbox = reader.next_box_type()
        if tbox == b"jp2h":
            header = reader.read_boxes()
            break
        if tbox == b"ftyp":
            reader.read_fields(">4s")
    size = nc = mode = palette = None
    while header.has_next_box():
        tbox = header.next_box_type()
        if tbox == b"ihdr":
            height, width, nc, bpc = header.read_fields(">IIHB")
            size = width, height
            if nc == 1 and (bpc & 0x7F) > 8:
                mode = "I;16"
            else:
                mode = {1: "L", 2: "LA", 3: "RGB", 4: "RGBA"}.get(nc, mode)
        elif tbox == b"colr" and nc == 4:
            meth, _, _, enumcs = header.read_fields(">BBBI")
            if meth == 1 and enumcs == 12:
                mode = "CMYK"
        elif tbox == b"pclr" and mode in ("L", "LA"):
            ne, npc = header.read_fields(">HB")
            depths = header.read_fields(">" + "B" * npc)
            if max((0, *depths)) <= 8:
                palette = _Palette("RGBA" if npc == 4 else "RGB")
                for _ in range(ne):
                    palette.getcolor(header.read_fields(">" + "B" * npc))
                mode = "P" if mode == "L" else "PA"
        elif tbox == b"res ":
            res = header.read_boxes()
            while res.has_next_box():
                if res.next_box_type() == b"resc":
                    res.read_fields(">HHHHBB")
                    break
    if size is None or mode is None:
        raise SyntaxError("Malformed JP2 header")
    if fp.read(12).endswith(b"jp2c\xff\x4f\xff\x51"):
        fp.seek(_be16(fp.read(2)) - 2, io.SEEK_CUR)
        _j2k_comment(fp)
    return mode, size, palette


class _Palette:
    """ImagePalette.ImagePalette as Jpeg2KImagePlugin fills it from a pclr
    box (getcolor: colours already held keep their index; a new one goes
    at len(palette) // len(mode), a ValueError past 256)."""

    def __init__(self, mode):
        self.mode, self.palette, self.colors = mode, bytearray(), {}

    def getcolor(self, color):
        if self.mode == "RGB" and len(color) == 4:
            if color[3] != 255:
                raise ValueError("cannot add non-opaque RGBA color to RGB "
                                 "palette")
            color = color[:3]
        elif self.mode == "RGBA" and len(color) == 3:
            color += (255,)
        if color in self.colors:
            return self.colors[color]
        n = len(self.mode)
        index = len(self.palette) // n
        if index >= 256:
            raise ValueError("cannot allocate more than 256 colors")
        self.colors[color] = index
        if index * n < len(self.palette):
            self.palette = (self.palette[:index * n] + bytes(color)
                            + self.palette[index * n + n:])
        else:
            self.palette += bytes(color)
        return index

    def table(self) -> bytes:
        """The 256 RGB entries of the P image after putpalette (black past
        the palette's entries), as convert("RGB") looks them up."""
        n = len(self.mode)
        entries = min(len(self.palette) // n, 256)
        out = bytearray(768)
        for i in range(entries):
            out[3 * i:3 * i + 3] = self.palette[n * i:n * i + 3]
        return bytes(out)


def jpeg2000_header(data: bytes):
    """(mode, (width, height), palette) of a JPEG 2000 file as
    Jpeg2KImageFile._open gives them: the mode L, I;16, LA, RGB, RGBA,
    CMYK, P or PA, and for P and PA the 256 RGB entries convert("RGB")
    looks up (else None). The file is one identify() names JPEG2000."""
    mode, size, palette = _jpeg2000_open(_File(data, False))
    return mode, size, palette.table() if palette is not None else None


def _j2k_comment(fp):
    """Jpeg2KImageFile._parse_comment: the codestream's marker segments up
    to a comment, the first tile or its end."""
    while True:
        marker = fp.read(2)
        if not marker:
            return
        if marker[1] in (0x90, 0xD9):
            return
        length = _be16(fp.read(2))
        if marker[1] == 0x64:
            return
        fp.seek(length - 2, io.SEEK_CUR)


class _Boxes:
    """Jpeg2KImagePlugin.BoxReader's reads and what they raise."""

    def __init__(self, fp, length=-1):
        self.fp, self.length, self.remaining = fp, length, -1

    def _can_read(self, n):
        if self.length >= 0 and self.fp.tell() + n > self.length:
            return False
        return n <= self.remaining if self.remaining >= 0 else True

    def _read(self, n):
        if not self._can_read(n):
            raise SyntaxError("Not enough data in header")
        data = self.fp.read(n)
        if len(data) < n:
            raise ValueError("JPEG2000: a header box ends early")
        if self.remaining > 0:
            self.remaining -= n
        return data

    def read_fields(self, fmt):
        return struct.unpack(fmt, self._read(struct.calcsize(fmt)))

    def read_boxes(self):
        n = self.remaining
        return _Boxes(io.BytesIO(self._read(n)), n)

    def has_next_box(self):
        if self.length >= 0:
            return self.fp.tell() + self.remaining < self.length
        return True

    def next_box_type(self):
        if self.remaining > 0:
            self.fp.seek(self.remaining, io.SEEK_CUR)
        self.remaining = -1
        lbox, tbox = self.read_fields(">I4s")
        hlen = 8
        if lbox == 1:
            lbox, hlen = self.read_fields(">Q")[0], 16
        if lbox < hlen or not self._can_read(lbox - hlen):
            raise SyntaxError("Invalid header length")
        self.remaining = lbox - hlen
        return tbox


_ICNS_SIZES = {(512, 512, 2): (b"ic10",), (512, 512, 1): (b"ic09",),
               (256, 256, 2): (b"ic14",), (256, 256, 1): (b"ic08",),
               (128, 128, 2): (b"ic13",),
               (128, 128, 1): (b"ic07", b"it32", b"t8mk"),
               (64, 64, 1): (b"icp6",), (32, 32, 2): (b"ic12",),
               (48, 48, 1): (b"ih32", b"h8mk"),
               (32, 32, 1): (b"icp5", b"il32", b"l8mk"),
               (16, 16, 2): (b"ic11",),
               (16, 16, 1): (b"icp4", b"is32", b"s8mk")}


def _icns_blocks(fp):
    """IcnsFile.__init__: {code: (start, length)} of the file's blocks (a
    repeated code: its last block), walked up to the header's file size;
    struct.error on a short block header, SyntaxError on a size of 0."""
    s = fp.read(8)
    filesize = _be32(s, 4)
    dct = {}
    i = 8
    while i < filesize:
        s = fp.read(8)
        sig, blocksize = s[:4], _be32(s, 4)
        if blocksize <= 0:
            raise SyntaxError("invalid block header")
        i += 8
        dct[sig] = (i, blocksize - 8)
        fp.seek(blocksize - 8, io.SEEK_CUR)
        i += blocksize - 8
    return dct


def icns_entries(data: bytes):
    """An ICNS file's ({code: (start, length)}, its sizes (IcnsFile.
    itersizes: (width, height, scale) in the order of IcnsFile.SIZES), the
    size IcnsImageFile loads (bestsize: the largest))."""
    dct = _icns_blocks(_File(data, False))
    sizes = [size for size, codes in _ICNS_SIZES.items()
             if any(c in dct for c in codes)]
    if not sizes:
        raise ValueError("ICNS: No 32bit icon resources found")
    return dct, sizes, max(sizes)


def _open_icns(fp):
    dct = _icns_blocks(fp)
    sizes = [size for size, codes in _ICNS_SIZES.items()
             if any(c in dct for c in codes)]
    if not sizes:
        raise SyntaxError("No 32bit icon resources found")
    w, h, scale = max(sizes)
    return "RGBA", (w * scale, h * scale)


# PsdImagePlugin.MODES: (Photoshop mode, bits) -> (Pillow's mode, the
# channels it needs); no other key opens (16-bit RGB included)
PSD_MODES = {(0, 1): ("1", 1), (0, 8): ("L", 1), (1, 8): ("L", 1),
             (2, 8): ("P", 1), (3, 8): ("RGB", 3), (4, 8): ("CMYK", 4),
             (7, 8): ("L", 1), (8, 8): ("L", 1), (9, 8): ("LAB", 3)}


def _psd_layout(fp):
    """PsdImageFile._open's walk: (mode, size, channels, compression, the
    offset of the first plane or of the byte-count table, the colour mode
    data of a P image's 768-byte palette or None)."""
    s = fp.read(26)
    if _be16(s, 4) != 1:
        raise SyntaxError("not a PSD file")
    bits, channels, psd_mode = _be16(s, 22), _be16(s, 12), _be16(s, 24)
    mode, need = PSD_MODES[(psd_mode, bits)]
    if need > channels:
        raise ValueError("PSD: not enough channels")
    if mode == "RGB" and channels == 4:
        mode, need = "RGBA", 4
    size = _be32(s, 18), _be32(s, 14)
    palette = None
    n = _be32(fp.read(4))
    if n:
        data = fp.read(n)
        if mode == "P" and n == 768:
            palette = data
    n = _be32(fp.read(4))
    if n:
        end = fp.tell() + n
        while fp.tell() < end:
            fp.read(4)
            _be16(fp.read(2))
            name = fp.read(fp.read(1)[0])
            if not len(name) & 1:
                fp.read(1)
            data = fp.read(_be32(fp.read(4)))
            if len(data) & 1:
                fp.read(1)
    n = _be32(fp.read(4))
    if n:
        end = fp.tell() + n
        _be32(fp.read(4))
        fp.seek(end)
    compression = _be16(fp.read(2))
    offset = fp.tell()
    if compression == 1:
        counts = fp.read(need * size[1] * 2)
        for i in range(0, need * size[1] * 2, 2):
            _be16(counts, i)
    return mode, size, need, compression, offset, palette


def _open_psd(fp):
    _, size, _, _, _, _ = _psd_layout(fp)
    return "RGB", size


def psd_layout(data: bytes):
    """A PSD file's (mode, size, channels, compression, offset, palette)
    as PsdImageFile._open reads them (_psd_layout); the file has been
    told as PSD (identify)."""
    return _psd_layout(_File(data, False))


def _open_wmf(fp):
    s = fp.read(44)
    if s.startswith(b"\xd7\xcd\xc6\x9a\0\0"):
        inch = _le16(s, 14)
        if inch == 0:
            raise ValueError("WMF: invalid inch")
        x0, y0, x1, y1 = struct.unpack_from("<4h", s, 6)
        size = (x1 - x0) * 72 // inch, (y1 - y0) * 72 // inch
        if s[22:26] != b"\x01\x00\t\x00":
            raise SyntaxError("Unsupported WMF file format")
    elif s.startswith(b"\1\0\0\0") and s[40:44] == b" EMF":
        x0, y0, x1, y1, f0, f1, f2, f3 = struct.unpack_from("<8i", s, 8)
        size = x1 - x0, y1 - y0
        try:
            2540.0 * (x1 - x0) / (f2 - f0)
            2540.0 * (y1 - y0) / (f3 - f1)
        except ZeroDivisionError:
            raise ValueError("WMF: a zero frame") from None
    else:
        raise SyntaxError("Unsupported file format")
    return "RGB", size


_XBM_HEAD = re.compile(
    rb"\s*#define[ \t]+.*_width[ \t]+(?P<width>[0-9]+)[\r\n]+"
    b"#define[ \t]+.*_height[ \t]+(?P<height>[0-9]+)[\r\n]+"
    b"(?P<hotspot>"
    b"#define[ \t]+[^_]*_x_hot[ \t]+(?P<xhot>[0-9]+)[\r\n]+"
    b"#define[ \t]+[^_]*_y_hot[ \t]+(?P<yhot>[0-9]+)[\r\n]+"
    b")?"
    rb"[\000-\377]*_bits\[]")


def _open_xbm(fp):
    m = _XBM_HEAD.match(fp.read(512))
    if not m:
        raise SyntaxError("not a XBM file")
    fp.layout = {"offset": m.end()}
    return "1", (int(m.group("width")), int(m.group("height")))


def _open_xpm(fp):
    fp.read(9)
    while True:
        line = fp.readline()
        if not line:
            raise SyntaxError("broken XPM file")
        m = re.match(rb'"([0-9]*) ([0-9]*) ([0-9]*) ([0-9]*)', line)
        if m:
            break
    size = int(m.group(1)), int(m.group(2))
    palette_length, bpp = int(m.group(3)), int(m.group(4))
    palette = {}
    for _ in range(palette_length):
        line = fp.readline().rstrip()
        c = line[1:bpp + 1]
        s = line[bpp + 1:-2].split()
        for i in range(0, len(s), 2):
            if s[i] == b"c":
                rgb = s[i + 1]
                if rgb == b"None":
                    pass
                elif rgb.startswith(b"#"):
                    v = int(rgb[1:], 16)
                    palette[c] = bytes(((v >> 16) & 255, (v >> 8) & 255,
                                        v & 255))
                else:
                    raise ValueError("XPM: cannot read this XPM file")
                break
        else:
            raise ValueError("XPM: cannot read this XPM file")
    fp.layout = {"offset": fp.tell(), "bpp": bpp, "palette": palette}
    return "RGB" if palette_length > 256 else "P", size


def _open_xvthumb(fp):
    fp.read(6)
    fp.readline()
    while True:
        s = fp.readline()
        if not s:
            raise SyntaxError("Unexpected EOF reading XV thumbnail file")
        if s[0] != 35:
            break
    w, h = s.strip().split(maxsplit=2)[:2]
    fp.layout = {"offset": fp.tell()}
    return "P", (int(w), int(h))


def _open_mcidas(fp):
    s = fp.read(256)
    if len(s) != 256:
        raise SyntaxError("not an McIdas area file")
    w = (0, *struct.unpack("!64i", s))
    if w[11] not in (1, 2, 4):
        raise SyntaxError("unsupported McIdas format")
    mode, rawmode = {1: ("L", "L"), 2: ("I;16B", "I;16B"),
                     4: ("I", "I;32B")}[w[11]]
    fp.layout = {"mode": mode, "rawmode": rawmode, "offset": w[34] + w[15],
                 "stride": w[15] + w[10] * w[11] * w[14]}
    return mode, (w[10], w[9])


def _open_mpeg(fp):
    # BitStream reads a byte at a time: past the data's end, an IndexError
    s = fp.read(7)
    bits = int.from_bytes(s[4:7], "big")
    s[6]
    return "RGB", (bits >> 12, bits & 0xFFF)


class _AvifFail(Exception):
    """libavif's avifDecoderParse failing with `result`: Pillow's
    AvifDecoder raises SyntaxError for BMFF parsing failed, truncated data
    and invalid ftyp (Image.open passes the file on), else RuntimeError."""

    PASS = ("BMFF parsing failed", "Truncated data", "Invalid ftyp")

    def __init__(self, result: str):
        super().__init__(result)
        self.result = result


class _AvifStream:
    """libavif's avifROStream over one box's bytes: a read past its end
    fails the parse (BMFF parsing failed)."""

    def __init__(self, data: bytes, start: int = 0, end: int = None):
        self.d, self.pos = data, start
        self.end = len(data) if end is None else end

    def left(self) -> int:
        return self.end - self.pos

    def read(self, n: int) -> bytes:
        if n > self.left():
            raise _AvifFail("BMFF parsing failed")
        out = self.d[self.pos:self.pos + n]
        self.pos += n
        return out

    def u(self, n: int) -> int:
        return int.from_bytes(self.read(n), "big")

    def version(self, enforce: int = None) -> int:
        v = self.u(1)
        self.u(3)
        if enforce is not None and v != enforce:
            raise _AvifFail("BMFF parsing failed")
        return v

    def string(self) -> None:
        end = self.d.find(b"\0", self.pos, self.end)
        if end < 0:
            raise _AvifFail("BMFF parsing failed")
        self.pos = end + 1

    def box(self, top: bool = False):
        """avifROStreamReadBoxHeader: (type, body start, body size; None
        for a top-level box of size 0)."""
        start = self.pos
        size = self.u(4)
        kind = self.read(4)
        if size == 1:
            size = self.u(8)
        if kind == b"uuid":
            self.read(16)
        head = self.pos - start
        if size == 0:
            if not top:
                raise _AvifFail("BMFF parsing failed")
            return kind, self.pos, None
        if size < head:
            raise _AvifFail("BMFF parsing failed")
        if not top and size - head > self.left():
            raise _AvifFail("BMFF parsing failed")
        return kind, self.pos, size - head


def _avif_item(items, iid):
    return items.setdefault(iid, {"type": b"", "extents": [], "props": [],
                                  "ipma": False, "essential": False,
                                  "idat": False, "thmb": 0, "auxl": 0,
                                  "prem": 0})


def _avif_properties(d, start, end):
    """avifParseItemPropertyContainerBox: each property (type, fields)."""
    s = _AvifStream(d, start, end)
    props = []
    while s.left() >= 1:
        kind, at, size = s.box()
        b = _AvifStream(d, at, at + size)
        prop = {"type": kind, "opaque": False}
        if kind == b"ispe":
            b.version(0)
            prop["size"] = b.u(4), b.u(4)
        elif kind == b"auxC":
            b.version(0)
            start_name = b.pos
            b.string()
            prop["alpha"] = d[start_name:b.pos - 1] in (
                b"urn:mpeg:mpegB:cicp:systems:auxiliary:alpha",
                b"urn:mpeg:hevc:2015:auxid:1")
        elif kind == b"colr":
            colour = b.read(4)
            prop["icc"] = colour in (b"rICC", b"prof")
            prop["nclx"] = colour == b"nclx"
            if prop["nclx"]:
                prop["cicp"] = (b.u(2), b.u(2), b.u(2))
                flags = b.u(1)
                if flags & 0x7F:            # reserved bits
                    raise _AvifFail("BMFF parsing failed")
                prop["full_range"] = flags >> 7
        elif kind == b"av1C":
            first = b.u(1)
            if not first >> 7 or first & 0x7F != 1:
                raise _AvifFail("BMFF parsing failed")
            b.read(3)
            c = d[at + 2]
            prop["depth"] = 12 if c & 0x20 else 10 if c & 0x40 else 8
        elif kind == b"pasp":
            b.read(8)
        elif kind == b"clap":
            prop["clap"] = [b.u(4) for _ in range(8)]
        elif kind == b"irot":
            b.read(1)
        elif kind == b"imir":
            b.read(1)
        elif kind == b"pixi":
            b.version(0)
            count = b.u(1)
            if count == 0 or count > 4:
                raise _AvifFail("Not implemented")
            depths = [b.u(1) for _ in range(count)]
            if any(x != depths[0] for x in depths):
                raise _AvifFail("Not implemented")
            prop["depths"] = depths
        elif kind in (b"a1op", b"lsel", b"a1lx", b"clli"):
            b.read({b"a1op": 1, b"lsel": 2, b"a1lx": 1, b"clli": 4}[kind])
        else:
            prop["opaque"] = True
        props.append(prop)
        s.pos = at + size
    return props


def _avif_meta(d, start, end):
    """avifParseMetaBox: the items (type, extents, properties) and the
    primary item's ID."""
    s = _AvifStream(d, start, end)
    s.version(0)
    items, seen, meta = {}, set(), {"primary": 0, "idat": b""}
    first = True
    while s.left() >= 1:
        kind, at, size = s.box()
        b = _AvifStream(d, at, at + size)
        if first:
            if kind != b"hdlr":
                raise _AvifFail("BMFF parsing failed")
            first = False
        elif kind == b"hdlr":
            raise _AvifFail("BMFF parsing failed")
        unique = (b"hdlr", b"iloc", b"pitm", b"idat", b"iprp", b"iinf",
                  b"iref")
        if kind in unique:
            if kind in seen:
                raise _AvifFail("BMFF parsing failed")
            seen.add(kind)
        if kind == b"hdlr":
            b.version(0)
            if b.u(4) != 0 or b.read(4) != b"pict":
                raise _AvifFail("BMFF parsing failed")
            b.read(12)
            b.string()
        elif kind == b"iloc":
            version = b.version()
            if version > 2:
                raise _AvifFail("BMFF parsing failed")
            sizes = b.u(1)
            more = b.u(1)
            off_size, len_size = sizes >> 4, sizes & 15
            base_size, index_size = more >> 4, (more & 15 if version else 0)
            if any(x not in (0, 4, 8) for x in (off_size, len_size,
                                                base_size, index_size)):
                raise _AvifFail("BMFF parsing failed")
            count = b.u(2 if version < 2 else 4)
            for _ in range(count):
                iid = b.u(2 if version < 2 else 4)
                if iid == 0:
                    raise _AvifFail("BMFF parsing failed")
                item = _avif_item(items, iid)
                if item["extents"]:
                    raise _AvifFail("BMFF parsing failed")
                if version in (1, 2):
                    method = b.u(2) & 15
                    if method not in (0, 1):
                        raise _AvifFail("BMFF parsing failed")
                    item["idat"] = method == 1
                b.u(2)
                base = b.u(base_size)
                for _ in range(b.u(2)):
                    offset, length = b.u(off_size), b.u(len_size)
                    item["extents"].append((base + offset, length))
        elif kind == b"pitm":
            if meta["primary"]:
                raise _AvifFail("BMFF parsing failed")
            version = b.version()
            meta["primary"] = b.u(2 if version == 0 else 4)
        elif kind == b"idat":
            meta["idat"] = d[at:at + size]
        elif kind == b"iprp":
            kind2, at2, size2 = b.box()
            if kind2 != b"ipco":
                raise _AvifFail("BMFF parsing failed")
            props = _avif_properties(d, at2, at2 + size2)
            b.pos = at2 + size2
            pairs = set()
            while b.left() >= 1:
                kind3, at3, size3 = b.box()
                if kind3 != b"ipma":
                    raise _AvifFail("BMFF parsing failed")
                m = _AvifStream(d, at3, at3 + size3)
                version = m.u(1)
                flags = m.u(3)
                prev = 0
                for _ in range(m.u(4)):
                    iid = m.u(2 if version < 1 else 4)
                    if iid == 0 or iid <= prev:
                        raise _AvifFail("BMFF parsing failed")
                    prev = iid
                    item = _avif_item(items, iid)
                    if item["ipma"]:
                        raise _AvifFail("BMFF parsing failed")
                    item["ipma"] = True
                    for _ in range(m.u(1)):
                        v = m.u(2 if flags & 1 else 1)
                        bits = 15 if flags & 1 else 7
                        essential, index = v >> bits, v & ((1 << bits) - 1)
                        if index == 0:
                            if essential:
                                raise _AvifFail("BMFF parsing failed")
                            continue
                        if index > len(props):
                            raise _AvifFail("BMFF parsing failed")
                        prop = props[index - 1]
                        if not prop["opaque"]:
                            must = prop["type"] in (b"a1op", b"lsel", b"clap",
                                                    b"irot", b"imir")
                            if essential and prop["type"] == b"a1lx" or (
                                    not essential and must):
                                raise _AvifFail("BMFF parsing failed")
                            item["props"].append(prop)
                        elif essential:
                            item["essential"] = True
                if (version, flags) in pairs:
                    raise _AvifFail("BMFF parsing failed")
                pairs.add((version, flags))
                b.pos = at3 + size3
        elif kind == b"iref":
            version = b.version()
            while b.left() >= 1 and version < 2:
                ref, _, _ = b.box()
                src = b.u(2 if version == 0 else 4)
                if src == 0:
                    raise _AvifFail("BMFF parsing failed")
                for _ in range(b.u(2)):
                    dst = b.u(2 if version == 0 else 4)
                    if dst == 0:
                        raise _AvifFail("BMFF parsing failed")
                    if ref in (b"thmb", b"auxl", b"prem"):
                        _avif_item(items, src)[ref.decode()] = dst
                    elif ref == b"dimg":
                        _avif_item(items, src).setdefault(
                            "dimg", []).append(dst)
        elif kind == b"iinf":
            version = b.version()
            if version > 1:
                raise _AvifFail("BMFF parsing failed")
            for _ in range(b.u(2 if version == 0 else 4)):
                kind4, at4, size4 = b.box()
                if kind4 != b"infe":
                    raise _AvifFail("BMFF parsing failed")
                e = _AvifStream(d, at4, at4 + size4)
                version4 = e.version()
                if version4 not in (2, 3):
                    raise _AvifFail("BMFF parsing failed")
                iid = e.u(2 if version4 == 2 else 4)
                if iid == 0:
                    raise _AvifFail("BMFF parsing failed")
                e.u(2)
                item_type = e.read(4)
                e.string()
                if item_type == b"mime":
                    e.string()
                _avif_item(items, iid)["type"] = item_type
                b.pos = at4 + size4
        s.pos = at + size
    if first:
        raise _AvifFail("BMFF parsing failed")
    return items, meta


def _avif_parse(d: bytes):
    """libavif 1.3's avifDecoderParse of a still image, as far as its
    result does not depend on the AV1 data: the top-level boxes (ftyp
    first, its brands; meta, whose hdlr, iloc, pitm, idat, iprp (ipco,
    ipma) and iinf are read with their checks), then the items' ispe, the
    primary item (Missing or empty image item), its av1C, pixi against
    av1C, its extents against the file. Raises _AvifFail; returns
    (items, info, primary item, alpha item or None), or None for a file
    of tracks alone (an image sequence without items)."""
    s = _AvifStream(d)
    ftyp = meta = None
    moov = False
    while True:
        if s.pos > len(d):
            raise _AvifFail("BMFF parsing failed")
        if s.pos == len(d):
            break
        head = _AvifStream(d, s.pos, min(len(d), s.pos + 32))
        kind, at, size = head.box(top=True)
        if ftyp is None and s.pos:   # a box after a first that is not ftyp
            raise _AvifFail("BMFF parsing failed")
        if kind in (b"ftyp", b"meta", b"moov"):
            if size is None:
                size = len(d) - at
            elif at + size > len(d):
                raise _AvifFail("Truncated data")
        elif size is None:
            raise _AvifFail("BMFF parsing failed")
        s.pos = at + size
        if kind == b"moov":
            moov = True
        if kind == b"ftyp":
            if ftyp is not None or (size - 8) % 4 or size < 8:
                raise _AvifFail("BMFF parsing failed")
            body = d[at:at + size]
            ftyp = [body[:4]] + [body[i:i + 4] for i in range(8, size, 4)]
            if b"avif" not in ftyp and b"avis" not in ftyp:
                raise _AvifFail("Invalid ftyp")
        elif kind == b"meta":
            if meta is not None:
                raise _AvifFail("BMFF parsing failed")
            meta = _avif_meta(d, at, at + size)
        needs_meta = ftyp is not None and b"avif" in ftyp
        needs_moov = ftyp is not None and b"avis" in ftyp
        if ftyp is not None and (not needs_meta or meta is not None) and (
                not needs_moov or moov):
            break
    if ftyp is None:
        raise _AvifFail("Invalid ftyp")
    if (needs_meta and meta is None) or (needs_moov and not moov):
        raise _AvifFail("Truncated data")
    if meta is None:
        return
    items, info = meta
    for item in items.values():
        if not sum(n for _, n in item["extents"]) or item["essential"]:
            continue
        if item["type"] not in (b"av01", b"grid"):
            continue
        ispe = [p for p in item["props"] if p["type"] == b"ispe"]
        if not ispe or 0 in ispe[0]["size"]:
            raise _AvifFail("BMFF parsing failed")
        w, h = ispe[0]["size"]
        if w * h > 16384 * 16384 or w > 32768 or h > 32768:
            raise _AvifFail("BMFF parsing failed")
    item = items.get(info["primary"])
    if (not info["primary"] or item is None or item["essential"]
            or item["type"] not in (b"av01", b"grid") or item["thmb"]
            or not sum(n for _, n in item["extents"])):
        raise _AvifFail("Missing or empty image item")
    size = sum(n for _, n in item["extents"])
    if size > len(d):
        raise _AvifFail("BMFF parsing failed")
    if item["type"] == b"grid":
        # its tiles carry the av1C (the port refuses grids by name)
        tiles = item.get("dimg", [])
        if not tiles or tiles[0] not in items:
            raise _AvifFail("BMFF parsing failed")
        _avif_validate(items[tiles[0]])
    else:
        _avif_validate(item)
    found = None
    for alpha in items.values():
        if (alpha["auxl"] == info["primary"] and not alpha["essential"]
                and alpha["type"] == b"av01"
                and sum(n for _, n in alpha["extents"])):
            aux = [p for p in alpha["props"] if p["type"] == b"auxC"]
            if aux and aux[0].get("alpha"):
                _avif_validate(alpha)
                asize = sum(n for _, n in alpha["extents"])
                if asize > len(d):
                    raise _AvifFail("BMFF parsing failed")
                found = alpha
                break
    colr = [p for p in item["props"] if p["type"] == b"colr"]
    for key in ("icc", "nclx"):
        if sum(p[key] for p in colr) > 1:
            raise _AvifFail("BMFF parsing failed")
    if not any(p["nclx"] for p in colr):
        _avif_harvest_cicp(d, item, info, size)
    return items, info, item, found


def _avif_harvest_cicp(d: bytes, item, info, size: int) -> None:
    """avifDecoderReset with no nclx colr: the item's first 64, 128, ...
    bytes read (avifDecoderPrepareSample, _avif_read) until its AV1
    sequence header parses, the read reaches the item's end or 4,096
    bytes. An item in an idat is read whole at the first step and its
    sample keeps the first step's bytes, so every step parses those; a
    header that never parses leaves the image's CICP unset, which is no
    failure."""
    search = 0
    while True:
        search = min(search + 64, size)
        if not item["idat"] or search <= 64:
            sample = _avif_read(d, item, info, search)
        if av1_sequence_header(sample):
            return
        if search == size or search >= 4096:
            return


class _Bits:
    """libavif's avifBits: MSB-first bits; a read past the end gives 0 and
    sets `error`."""

    def __init__(self, data: bytes):
        self.d, self.pos, self.error = data, 0, False

    def read(self, n: int) -> int:
        v = 0
        for _ in range(n):
            byte = self.pos >> 3
            if byte >= len(self.d):
                self.error = True
                return 0
            v = (v << 1) | ((self.d[byte] >> (7 - (self.pos & 7))) & 1)
            self.pos += 1
        return v

    def uleb128(self) -> int:
        val, i = 0, 0
        while True:
            v = self.read(8)
            more = v & 0x80
            val |= (v & 0x7F) << i
            i += 7
            if not (more and i < 56):
                break
        if val > 0xFFFFFFFF or more:
            self.error = True
            return 0
        return val

    def uvlc(self) -> int:
        n = 0
        while not self.read(1):
            n += 1
            if n == 32:
                return 0xFFFFFFFF
        return ((1 << n) - 1) + self.read(n) if n else 0


def av1_sequence_header(data: bytes) -> bool:
    """libavif 1.3's avifSequenceHeaderParse (obu.c): the OBUs of `data`
    walked to the first sequence header OBU (AV1 spec 5.3, 5.5), which
    must parse whole within its size; False where none does."""
    pos = 0
    while pos < len(data):
        b = _Bits(data[pos:])
        if b.read(1):                                   # forbidden bit
            return False
        obu_type, extension, has_size = b.read(4), b.read(1), b.read(1)
        b.read(1)
        if extension:
            b.read(8)
        size = b.uleb128() if has_size else len(data) - pos - 1 - extension
        if b.error:
            return False
        start = b.pos // 8
        if size > len(data) - pos - start or size < 0:
            return False
        if obu_type == 1:
            return _av1_sequence_header_obu(
                _Bits(data[pos + start:pos + start + size]))
        pos += size + start
    return False


def _av1_sequence_header_obu(b: _Bits) -> bool:
    """parseSequenceHeader: sequence_header_obu() to its
    film_grain_params_present flag, no read past its end."""
    profile = b.read(3)
    if profile > 2:
        return False
    still = b.read(1)
    reduced = b.read(1)
    if reduced and not still:
        return False
    if reduced:
        b.read(5)
    else:
        decoder_model = delay_bits = 0
        if b.read(1):                                   # timing_info
            b.read(32)
            b.read(32)
            if b.read(1) and b.uvlc() == 0xFFFFFFFF:
                return False
            decoder_model = b.read(1)
            if decoder_model:
                delay_bits = b.read(5) + 1
                b.read(32)
                b.read(5)
                b.read(5)
        initial_delay = b.read(1)
        for _ in range(b.read(5) + 1):
            b.read(12)
            if b.read(5) > 7:
                b.read(1)
            if decoder_model and b.read(1):
                b.read(delay_bits)
                b.read(delay_bits)
                b.read(1)
            if initial_delay and b.read(1):
                b.read(4)
    wbits, hbits = b.read(4) + 1, b.read(4) + 1
    b.read(wbits)
    b.read(hbits)
    if not reduced and b.read(1):                       # frame ids
        b.read(4)
        b.read(3)
    b.read(3)
    if not reduced:
        b.read(4)
        order_hint = b.read(1)
        if order_hint:
            b.read(2)
        force = 2 if b.read(1) else b.read(1)
        if force > 0 and not b.read(1):
            b.read(1)
        if order_hint:
            b.read(3)
    b.read(3)
    # color_config()
    high = b.read(1)
    depth = (12 if b.read(1) else 10) if profile == 2 and high else (
        10 if high else 8)
    mono = b.read(1) if profile != 1 else 0
    cp = tc = mc = 2
    if b.read(1):
        cp, tc, mc = b.read(8), b.read(8), b.read(8)
    if mono:
        b.read(1)
    elif not (cp == 1 and tc == 13 and mc == 0):
        b.read(1)
        ssx, ssy = {0: (1, 1), 1: (0, 0)}.get(profile, (1, 0))
        if profile == 2 and depth == 12:
            ssx = b.read(1)
            ssy = b.read(1) if ssx else 0
        if ssx and ssy:
            b.read(2)
    if b.error:
        return False
    if not mono:
        b.read(1)
    b.read(1)                                           # film grain
    return not b.error


def _avif_validate(item) -> None:
    """avifDecoderItemValidateProperties: av1C present, pixi's depths
    those of av1C."""
    config = [p for p in item["props"] if p["type"] == b"av1C"]
    if not config:
        raise _AvifFail("BMFF parsing failed")
    for p in item["props"]:
        if p["type"] == b"pixi" and any(x != config[0]["depth"]
                                        for x in p["depths"]):
            raise _AvifFail("BMFF parsing failed")


def _avif_read(d: bytes, item, info, count: int) -> bytes:
    """avifDecoderItemRead of the item's first `count` bytes: its extents
    in the file or its meta box's idat (read whole); returns the first
    `count` bytes."""
    if not item["extents"]:
        raise _AvifFail("Truncated data")
    if item["idat"] and not info["idat"]:
        raise _AvifFail("No content")
    left = count if not item["idat"] else sum(n for _, n in item["extents"])
    out = b""
    for offset, length in item["extents"]:
        n = min(length, left)
        if item["idat"]:
            if offset > len(info["idat"]) or length > len(info["idat"]) - offset:
                raise _AvifFail("BMFF parsing failed")
            out += info["idat"][offset:offset + n]
        else:
            if offset > len(d):
                raise _AvifFail("BMFF parsing failed")
            if len(d) - offset < n:
                raise _AvifFail("Truncated data")
            out += d[offset:offset + n]
        left -= n
        if not left:
            break
    return out[:count]


def avif_layout(d: bytes) -> dict:
    """What the AVIF decoder reads of a file libavif's parse takes
    (`_avif_parse`; a ValueError where it fails): "size" (w, h) and
    "mode" as Pillow's AvifImageFile gives them (the primary item's ispe;
    RGBA where an alpha auxiliary item is found), "color" and "alpha" the
    items' bytes (alpha None) as avifDecoderItemRead reads them, "nclx"
    (primaries, transfer, matrix, full range) of the colour item's nclx
    colr or None, "premultiplied" (its prem reference to the alpha
    item), "grid" (a 'grid' primary item), "sequence" (tracks alone: no
    item)."""
    try:
        return _avif_layout(d, read_items=True)
    except _AvifFail as e:
        raise ValueError(f"AVIF: Failed to decode image: {e.result}") \
            from None


def _avif_layout(d: bytes, read_items: bool) -> dict:
    """avif_layout, raising _AvifFail; the items not read without
    `read_items` (Image.open does not read them)."""
    parsed = _avif_parse(d)
    if parsed is None:
        return {"sequence": True, "size": (1, 1), "mode": "RGB"}
    items, info, item, alpha = parsed
    w, h = [p for p in item["props"] if p["type"] == b"ispe"][0]["size"]
    nclx = [p for p in item["props"] if p["type"] == b"colr" and p["nclx"]]
    out = {"sequence": False, "size": (w, h),
           "mode": "RGBA" if alpha is not None else "RGB",
           "grid": item["type"] == b"grid",
           "nclx": (nclx[0]["cicp"] + (nclx[0]["full_range"],)
                    if nclx else None),
           "premultiplied": alpha is not None and item["prem"] == next(
               k for k, v in items.items() if v is alpha)}
    if read_items:
        out["color"] = b"" if out["grid"] else _avif_read(
            d, item, info, sum(n for _, n in item["extents"]))
        out["alpha"] = None if alpha is None else _avif_read(
            d, alpha, info, sum(n for _, n in alpha["extents"]))
    return out


def _open_avif(fp):
    """AvifImageFile._open: libavif's avifDecoderParse (_avif_parse): a
    failure Pillow's decoder raises as SyntaxError passes the file on,
    any other ends Image.open; the mode and size of its avifImage
    (avif_layout)."""
    try:
        layout = _avif_layout(fp.read(), read_items=False)
    except _AvifFail as e:
        if e.result in _AvifFail.PASS:
            raise SyntaxError(f"AVIF: {e.result}") from None
        raise ValueError(f"AVIF: Failed to decode image: {e.result}") \
            from None
    return layout["mode"], layout["size"]


def _open_msp(fp):
    s = fp.read(32)
    checksum = 0
    for i in range(0, 32, 2):
        checksum ^= _le16(s, i)
    if checksum != 0:
        raise SyntaxError("bad MSP checksum")
    fp.layout = {"version": 1 if s.startswith(b"DanM") else 2}
    return "1", (_le16(s, 4), _le16(s, 6))


def _open_pixar(fp):
    s = fp.read(512)
    size = _le16(s, 418), _le16(s, 416)
    mode = "RGB" if (_le16(s, 424), _le16(s, 426)) == (14, 2) else ""
    return mode, size


# JpegImagePlugin.MARKER: the marker codes its _open reads (with the
# handlers that read a segment); any other code past 0xFF (but 0x00 and
# 0xFF) ends the open with "no marker found"
_JPEG_SEGMENT = ({0xC4, 0xCC, 0xDA, 0xDB, 0xDC, 0xDD, 0xDF, 0xFE}
                 | set(range(0xE0, 0xF0))
                 | (set(range(0xC0, 0xD0)) - {0xC4, 0xC8, 0xCC}))
_JPEG_BARE = {0xC8, *range(0xD0, 0xDA), *range(0xF0, 0xFE)}


def _jpeg_safe_read(fp, n):
    """ImageFile._safe_read: a short read raises OSError, which ends
    Image.open."""
    if n <= 0:
        return b""
    data = fp.read(n)
    if len(data) < n:
        raise ValueError("JPEG: Truncated File Read")
    return data


def _open_jpeg(fp):
    """JpegImageFile._open: the marker walk up to the first SOS, the
    segments it reads (their lengths, the APP0 JFIF and APP14 Adobe
    fields, DQT's tables, every SOF's size and components, the ICC
    fragments' count) and what each raises; a depth or a number of
    layers Pillow cannot handle is SOF's SyntaxError, which passes the
    file on to the next plugin."""
    if fp.read(3) != b"\xff\xd8\xff":
        raise SyntaxError("not a JPEG file")
    mode, size = "", (0, 0)
    icc = []
    s = b"\xff"
    while True:
        i = s[0]
        if i != 0xFF:
            s = fp.read(1)  # junk
            continue
        s = s + fp.read(1)
        i = _be16(s)
        code = i & 0xFF
        if i >> 8 == 0xFF and (code in _JPEG_SEGMENT or code in _JPEG_BARE):
            if code in _JPEG_SEGMENT:
                n = _be16(fp.read(2)) - 2
                seg = _jpeg_safe_read(fp, n)
                if code == 0xE0 and seg.startswith(b"JFIF"):
                    _be16(seg, 5)
                elif code == 0xEE and seg.startswith(b"Adobe"):
                    _be16(seg, 5)
                elif code == 0xE2 and seg.startswith(b"ICC_PROFILE\0"):
                    icc.append(seg)
                elif code == 0xDB:
                    while len(seg):
                        qt = 1 + (1 if seg[0] // 16 == 0 else 2) * 64
                        if len(seg) < qt:
                            raise SyntaxError("bad quantization table marker")
                        seg = seg[qt:]
                elif 0xC0 <= code <= 0xCF and code not in (0xC4, 0xC8, 0xCC):
                    size = _be16(seg, 3), _be16(seg, 1)
                    mode = {1: "L", 3: "RGB", 4: "CMYK"}.get(seg[5])
                    # SOF's SyntaxError: Image.open tries the next plugin
                    if seg[0] != 8:
                        raise SyntaxError(f"cannot handle {seg[0]}-bit layers")
                    if mode is None:
                        raise SyntaxError(
                            f"cannot handle {seg[5]}-layer images")
                    if icc:
                        icc.sort()
                        icc[0][13]
                        icc = []
                    for k in range(6, len(seg), 3):
                        seg[k:k + 3][2]
            if code == 0xDA:
                return mode, size
            s = fp.read(1)
        elif i in (0, 0xFFFF):
            s = b"\xff"
        elif i == 0xFF00:
            s = fp.read(1)
        else:
            raise SyntaxError("no marker found")


OPEN = {
    "BMP": _open_bmp_file, "DIB": _open_bmp, "GIF": _open_gif,
    "JPEG": _open_jpeg, "PPM": _open_ppm, "PNG": _open_png,
    "AVIF": _open_avif, "BLP": _open_blp, "BUFR": _open_stub,
    "CUR": _open_cur, "PCX": _open_pcx, "DCX": _open_dcx, "DDS": _open_dds,
    "EPS": _open_eps, "FITS": _open_fits, "FLI": _open_fli,
    "FTEX": _open_ftex, "GBR": _open_gbr, "GRIB": _open_stub,
    "HDF5": _open_stub, "JPEG2000": _open_jpeg2000, "ICNS": _open_icns,
    "ICO": _open_ico, "IM": _open_im, "IMT": _open_imt, "IPTC": _open_iptc,
    "MCIDAS": _open_mcidas, "MPEG": _open_mpeg,
    "TIFF": lambda fp: ("?", (1, 1)), "MSP": _open_msp, "PCD": _open_pcd,
    "PIXAR": _open_pixar, "PSD": _open_psd, "QOI": _open_qoi,
    "SGI": _open_sgi, "SPIDER": _open_spider, "SUN": _open_sun,
    "TGA": _open_tga, "WEBP": lambda fp: ("?", (1, 1)), "WMF": _open_wmf,
    "XBM": _open_xbm, "XPM": _open_xpm, "XVTHUMB": _open_xvthumb,
}


class _File(io.BytesIO):
    """The file an _open reads, and whether Image.open was given its
    path (a file object's seeks raise where a BytesIO's stop)."""

    def __init__(self, data: bytes, path: bool):
        super().__init__(data)
        self.path = path
        # what the _open of a format the port reads past its header
        # leaves for the decoder (plugin_layout)
        self.layout = None


def identify(data: bytes, path: bool = False) -> Optional[str]:
    """The format `Image.open` gives the file `data` (a name of ORDER), or
    None where it raises UnidentifiedImageError; a ValueError naming the
    plugin where a plugin's _open, or the decompression-bomb check,
    raises and so ends Image.open. `path`: the file is opened from its
    path rather than from bytes or a file object."""
    prefix = data[:16]
    for name in ORDER:
        accept = ACCEPT.get(name)
        if accept is not None and not accept(prefix):
            continue
        fp = _File(data, path)
        try:
            try:
                mode, size = OPEN[name](fp)
            except _PASS as e:
                raise SyntaxError(str(e)) from None
            if not mode or size[0] <= 0 or size[1] <= 0:
                raise SyntaxError("an empty mode or size")
            _bomb_check(size)
        except (SyntaxError, IndexError, TypeError, struct.error):
            continue
        except (_Bomb, Exception) as e:
            raise ValueError(f"{name}: Pillow's Image.open raises here: "
                             f"{e}") from None
        return FORMATS.get(name, name)
    return None


def plugin_layout(data: bytes, name: str):
    """(mode, size, layout) of a file told as `name` (identify), as that
    plugin's _open leaves them: `layout` the tile's offset and the
    fields its decoder reads (an IM's raw mode and palette, an XPM's
    colour table, a FITS file's BITPIX, ...)."""
    fp = _File(data, False)
    mode, size = OPEN[name.upper()](fp)
    return mode, size, fp.layout
