"""Test-only writers of BMP, GIF, WebP and TIFF files for what Pillow's
own writers do not reach.

BMP, GIF and TIFF are written here with numpy (and the standard
library's zlib) alone: chip_smoke.py writes its BMP, GIF and TIFF scenes
with them on the card, which has no Pillow.

* `encode_bmp`: every header size Pillow reads (12, 40, 52, 56, 64, 108,
  124), 1/4/8-bit palettes (short ones too), 16-bit 5-5-5 and bit-field
  layouts, 24-bit, 32-bit with or without bit fields, BI_RLE8 and
  BI_RLE4 (`rle_ops` spells the operations out: runs, absolute runs,
  deltas, line and bitmap ends), top-down rows.
* `encode_gif`: one frame: global and local colour tables, a frame
  offset inside the logical screen, interlaced rows, a transparency
  index, any LZW minimum code size from 2 to 8, clear codes every
  `clear_every` codes, or none once the code table is full (the deferred
  clear).
* `encode_tiff`: one page of any bit depth and sample layout Pillow
  reads: strips or tiles (edge tiles padded), PlanarConfiguration 1 or
  2, no compression, PackBits, LZW (`tiff_lzw`: libtiff's codes, or the
  old LSB-first ones), Deflate, or JPEG streams given a strip or tile
  (with JPEGTables: `jpeg_split_tables`; `tiff_from_jpeg` wraps a whole
  JPEG file), predictors 2 and 3, FillOrder 2, II or MM byte order,
  classic TIFF or BigTIFF, an Orientation, a ColorMap, ExtraSamples,
  and tags added, overridden or left out on purpose. Pillow's writer
  reaches none of tiles, planes, BigTIFF, FillOrder 2 or subsampled
  YCbCr JPEG. ZSTD strips go through Pillow's bundled libzstd by ctypes
  (`zstd_frame`: level, checksum, content size, window log, long-distance
  matching) and LZMA strips through the standard library's lzma
  (`xz_stream`: check, preset, filters), both loaded only when called,
  so they run where Pillow is (the card has neither).

WebP goes through the system's libwebp encoder, loaded with ctypes when
`encode_webp` is first called (`webp_available()` says whether there is
one): its WebPConfig reaches the simple loop filter, token partitions,
segments and sharpness, which Pillow's writer leaves at their defaults.
`webp_container` wraps VP8/VP8L bitstreams into an animated file with
frames at offsets; `vp8_with_lf_deltas` rewrites a lossy
file's first partition with loop-filter deltas, which libwebp's encoder
never writes.

Their output is only ever held to Pillow's decode of the same bytes.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import io
import re
import struct
from typing import List, Optional, Sequence, Tuple

import numpy as np

# ------------------------------------------------------------------ BMP

_BMP_HEADERS = (12, 40, 52, 56, 64, 108, 124)


def _pack_rows(samples: np.ndarray, bits: int) -> np.ndarray:
    """[h, w] ints below 2**bits -> [h, stride] uint8 rows, padded to 4
    bytes, pixels MSB first within a byte."""
    h, w = samples.shape
    if bits < 8:
        per = 8 // bits
        s = np.pad(samples, ((0, 0), (0, (-w) % per))).reshape(h, -1, per)
        row = np.zeros(s.shape[:2], np.int64)
        for i in range(per):
            row |= s[:, :, i].astype(np.int64) << (8 - bits * (i + 1))
        row = row.astype(np.uint8)
    else:
        row = samples.astype(np.uint8)
    return np.pad(row, ((0, 0), (0, (-row.shape[1]) % 4)))


def bmp_pixels(image: np.ndarray, bits: int,
               masks: Optional[Sequence[int]] = None) -> np.ndarray:
    """The rows of an RGB uint8 image [h, w, 3] (or palette indices
    [h, w]) as BMP pixel rows [h, stride] in top-down order: indices
    packed for bits <= 8, else each channel scaled into its mask (16-bit
    default 5-5-5, 32-bit default B, G, R, X bytes)."""
    if bits <= 8:
        return _pack_rows(np.asarray(image), bits)
    img = np.asarray(image).astype(np.int64)
    h, w = img.shape[:2]
    if bits == 24:
        raw = img[..., ::-1].reshape(h, -1).astype(np.uint8)
        return np.pad(raw, ((0, 0), (0, (-raw.shape[1]) % 4)))
    if masks is None:
        masks = (0x7C00, 0x3E0, 0x1F) if bits == 16 else (
            0xFF0000, 0xFF00, 0xFF)
    word = np.zeros((h, w), np.int64)
    for c, mask in enumerate(masks[:3]):
        if not mask:
            continue
        shift = (mask & -mask).bit_length() - 1
        top = mask >> shift
        word |= ((img[..., c] * top + 127) // 255) << shift
    if len(masks) > 3 and masks[3]:
        shift = (masks[3] & -masks[3]).bit_length() - 1
        word |= ((img[..., 0] ^ img[..., 1]) & (masks[3] >> shift)) << shift
    raw = word.astype("<u2" if bits == 16 else "<u4").view(np.uint8)
    raw = raw.reshape(h, -1)
    return np.pad(raw, ((0, 0), (0, (-raw.shape[1]) % 4)))


def encode_bmp(width: int, height: int, bits: int, pixels: bytes, *,
               header: int = 40, compression: int = 0,
               palette: Optional[np.ndarray] = None, colors: int = 0,
               masks: Optional[Sequence[int]] = None,
               top_down: bool = False) -> bytes:
    """A BMP file around `pixels` (rows in file order, or RLE data).
    palette: [n, 3] RGB; colors: the header's colour count (0: 1 << bits);
    masks: the bit fields (compression 3), after a 40-byte header as three
    words, inside a larger header as four."""
    if header not in _BMP_HEADERS:
        raise ValueError(f"header size {header}")
    if header == 12:
        info = struct.pack("<IHHHH", 12, width, height, 1, bits)
    else:
        info = struct.pack("<IiiHHIIiiII", header, width,
                           -height if top_down else height, 1, bits,
                           compression, len(pixels), 2835, 2835, colors, 0)
        if header > 40:
            m = list(masks or ()) + [0] * 4
            info += struct.pack("<IIII", *m[:4])[:header - 40]
        info += bytes(header - len(info))
    extra = b""
    if header == 40 and compression == 3:
        extra = struct.pack("<III", *masks[:3])
    pal = b""
    if palette is not None:
        pal_entries = np.asarray(palette, np.uint8)[:, ::-1]
        if header != 12:
            pal_entries = np.pad(pal_entries, ((0, 0), (0, 1)))
        pal = pal_entries.tobytes()
    start = 14 + len(info) + len(extra) + len(pal)
    return (b"BM" + struct.pack("<IHHI", start + len(pixels), 0, 0, start)
            + info + extra + pal + pixels)


def rle_ops(indices: np.ndarray, rle4: bool, rng) -> List[tuple]:
    """Pillow's RLE operations for the rows of indices [h, w] (bottom row
    first, as a bottom-up BMP stores them): runs of equal pixels, absolute
    runs of 3 or more, a delta now and then over pixels left at 0, and an
    end of line after each row but the last."""
    ops = []
    h, w = indices.shape
    for r, row in enumerate(indices[::-1]):
        x = 0
        while x < w:
            if rng.rand() < 0.1 and x + 2 < w and not row[x:x + 2].any():
                ops.append(("delta", 2, 0))
                x += 2
                continue
            run = 1
            while x + run < w and run < 255 and row[x + run] == row[x]:
                run += 1
            pair = 2
            while (rle4 and x + pair < w and pair < 255
                   and row[x + pair] == row[x + pair - 2]):
                pair += 1
            if run < 2 and pair >= 4:
                ops.append(("run2", pair, int(row[x]), int(row[x + 1])))
                x += pair
                continue
            if run >= 2 or w - x < 3:
                ops.append(("run", run, int(row[x])))
                x += run
                continue
            n = min(w - x, int(rng.randint(3, 9)))
            if rle4 and n % 2:
                n -= 1              # Pillow reads n // 2 bytes
            if n < 3:
                ops.append(("run", 1, int(row[x])))
                x += 1
                continue
            ops.append(("absolute", row[x:x + n].tolist()))
            x += n
        if r < h - 1:
            ops.append(("eol",))
    ops.append(("eob",))
    return ops


def rle_bytes(ops: Sequence[tuple], rle4: bool, data_offset: int) -> bytes:
    """RLE8/RLE4 data of `ops`; absolute runs padded to an even file
    offset as Pillow's reader aligns them (data_offset: where the data
    starts in the file). A delta is written as Pillow reads it: two
    bytes it skips, then right and up."""
    out = bytearray()
    for op in ops:
        if op[0] == "run":
            _, n, v = op
            out += bytes([n, (v << 4 | v) if rle4 else v])
        elif op[0] == "run2":            # RLE4: a pixel pair alternating
            _, n, a, b = op
            out += bytes([n, a << 4 | b])
        elif op[0] == "absolute":
            vals = op[1]
            out += bytes([0, len(vals)])
            if rle4:
                out += bytes((vals[i] << 4) | vals[i + 1]
                             for i in range(0, len(vals), 2))
            else:
                out += bytes(vals)
            if (data_offset + len(out)) % 2:
                out.append(0)
        elif op[0] == "delta":
            out += bytes([0, 2, 0, 0, op[1], op[2]])
        elif op[0] == "eol":
            out += b"\x00\x00"
        elif op[0] == "eob":
            out += b"\x00\x01"
    return bytes(out)


# ------------------------------------------------------------------ GIF

def _lzw(indices: np.ndarray, min_size: int, clear_every: int = 0,
         deferred: bool = True) -> bytes:
    """GIF LZW of a flat index array, codes LSB first. clear_every > 0
    emits a clear code after that many codes; when the table is full, a
    clear code unless `deferred`, which goes on with the full table."""
    clear, end = 1 << min_size, (1 << min_size) + 1
    acc = nbits = 0
    out = bytearray()
    size = min_size + 1

    def put(code):
        nonlocal acc, nbits
        acc |= code << nbits
        nbits += size
        while nbits >= 8:
            out.append(acc & 255)
            acc >>= 8
            nbits -= 8

    def reset():
        return {(i,): i for i in range(clear)}, end + 1

    table, nxt = reset()
    put(clear)
    emitted = 0
    seq = np.asarray(indices).reshape(-1).tolist()
    w = (seq[0],)
    for k in seq[1:]:
        wk = w + (k,)
        if wk in table:
            w = wk
            continue
        put(table[w])
        emitted += 1
        if nxt < 4096:
            table[wk] = nxt
            nxt += 1
            if nxt - 1 == 1 << size and size < 12:
                size += 1
        elif not deferred:
            put(clear)
            table, nxt = reset()
            size = min_size + 1
        if clear_every and emitted % clear_every == 0:
            put(clear)
            table, nxt = reset()
            size = min_size + 1
        w = (k,)
    put(table[w])
    put(end)
    if nbits:
        out.append(acc & 255)
    return bytes(out)


def _sub_blocks(data: bytes) -> bytes:
    return b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255]
                    for i in range(0, len(data), 255)) + b"\x00"


def _table_bits(palette) -> int:
    n = len(palette)
    bits = max(1, (n - 1).bit_length())
    if n != 1 << bits:
        raise ValueError(f"a colour table of {n} entries")
    return bits


def encode_gif(indices: np.ndarray, screen: Tuple[int, int] = None, *,
               global_palette: Optional[np.ndarray] = None,
               local_palette: Optional[np.ndarray] = None,
               offset: Tuple[int, int] = (0, 0), interlace: bool = False,
               transparency: Optional[int] = None,
               min_code_size: int = 8, clear_every: int = 0,
               deferred: bool = True, version: bytes = b"GIF89a") -> bytes:
    """A one-frame GIF of palette indices [h, w] at `offset` (x, y) in a
    logical screen (w, h; default the frame's). Palettes: [2**k, 3]
    uint8."""
    indices = np.asarray(indices)
    h, w = indices.shape
    sw, sh = screen or (w, h)
    flags = 0
    gct = b""
    if global_palette is not None:
        bits = _table_bits(global_palette)
        flags = 0x80 | (bits - 1)
        gct = np.asarray(global_palette, np.uint8).tobytes()
    out = version + struct.pack("<HHBBB", sw, sh, flags, 0, 0) + gct
    if transparency is not None:
        out += b"!\xf9\x04" + struct.pack("<BHB", 1, 10, transparency) \
            + b"\x00"
    out += b"!\xfe" + _sub_blocks(b"test image")
    lflags = 0x40 if interlace else 0
    lct = b""
    if local_palette is not None:
        bits = _table_bits(local_palette)
        lflags |= 0x80 | (bits - 1)
        lct = np.asarray(local_palette, np.uint8).tobytes()
    out += b"," + struct.pack("<HHHHB", offset[0], offset[1], w, h,
                              lflags) + lct
    rows = indices
    if interlace:
        order = (list(range(0, h, 8)) + list(range(4, h, 8))
                 + list(range(2, h, 4)) + list(range(1, h, 2)))
        rows = indices[order]
    out += bytes([min_code_size]) + _sub_blocks(
        _lzw(rows, min_code_size, clear_every, deferred))
    return out + b";"


def quantize_332(image: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """An RGB image [h, w, 3] as indices into a fixed 256-entry palette (3
    bits of red, 3 of green, 2 of blue): (indices [h, w], palette)."""
    img = np.asarray(image).astype(np.int64)
    idx = (img[..., 0] >> 5) << 5 | (img[..., 1] >> 5) << 2 | img[..., 2] >> 6
    k = np.arange(256)
    palette = np.stack([(k >> 5) * 255 // 7, ((k >> 2) & 7) * 255 // 7,
                        (k & 3) * 255 // 3], -1).astype(np.uint8)
    return idx.astype(np.uint8), palette


# ----------------------------------------------------------------- WebP

_LIBWEBP = None


def _libwebp():
    global _LIBWEBP
    if _LIBWEBP is None:
        name = ctypes.util.find_library("webp")
        if name is None:
            raise OSError("no libwebp to encode with")
        lib = ctypes.CDLL(name)
        lib.WebPConfigInitInternal.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                               ctypes.c_float, ctypes.c_int]
        lib.WebPPictureInitInternal.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.WebPPictureImportRGBA.argtypes = [ctypes.c_void_p,
                                              ctypes.c_char_p, ctypes.c_int]
        lib.WebPPictureImportRGB.argtypes = [ctypes.c_void_p,
                                             ctypes.c_char_p, ctypes.c_int]
        lib.WebPEncode.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.WebPPictureFree.argtypes = [ctypes.c_void_p]
        lib.WebPMemoryWriterInit.argtypes = [ctypes.c_void_p]
        lib.WebPMemoryWriterClear.argtypes = [ctypes.c_void_p]
        lib.WebPGetEncoderVersion.restype = ctypes.c_int
        _LIBWEBP = lib
    return _LIBWEBP


def webp_available() -> bool:
    try:
        _libwebp()
        return True
    except OSError:
        return False


_CONFIG_FIELDS = [
    ("lossless", ctypes.c_int), ("quality", ctypes.c_float),
    ("method", ctypes.c_int), ("image_hint", ctypes.c_int),
    ("target_size", ctypes.c_int), ("target_PSNR", ctypes.c_float),
    ("segments", ctypes.c_int), ("sns_strength", ctypes.c_int),
    ("filter_strength", ctypes.c_int), ("filter_sharpness", ctypes.c_int),
    ("filter_type", ctypes.c_int), ("autofilter", ctypes.c_int),
    ("alpha_compression", ctypes.c_int), ("alpha_filtering", ctypes.c_int),
    ("alpha_quality", ctypes.c_int), ("pass_", ctypes.c_int),
    ("show_compressed", ctypes.c_int), ("preprocessing", ctypes.c_int),
    ("partitions", ctypes.c_int), ("partition_limit", ctypes.c_int),
    ("emulate_jpeg_size", ctypes.c_int), ("thread_level", ctypes.c_int),
    ("low_memory", ctypes.c_int), ("near_lossless", ctypes.c_int),
    ("exact", ctypes.c_int), ("use_delta_palette", ctypes.c_int),
    ("use_sharp_yuv", ctypes.c_int), ("qmin", ctypes.c_int),
    ("qmax", ctypes.c_int), ("pad", ctypes.c_uint32 * 8)]


class _Config(ctypes.Structure):
    _fields_ = _CONFIG_FIELDS


class _MemoryWriter(ctypes.Structure):
    _fields_ = [("mem", ctypes.POINTER(ctypes.c_uint8)),
                ("size", ctypes.c_size_t), ("max_size", ctypes.c_size_t),
                ("pad", ctypes.c_uint32 * 1)]


# WebPPicture: the fields set here, then room to spare for the rest
class _Picture(ctypes.Structure):
    _fields_ = [("use_argb", ctypes.c_int), ("colorspace", ctypes.c_int),
                ("width", ctypes.c_int), ("height", ctypes.c_int),
                ("y", ctypes.c_void_p), ("u", ctypes.c_void_p),
                ("v", ctypes.c_void_p), ("y_stride", ctypes.c_int),
                ("uv_stride", ctypes.c_int), ("a", ctypes.c_void_p),
                ("a_stride", ctypes.c_int), ("pad1", ctypes.c_uint32 * 2),
                ("argb", ctypes.c_void_p), ("argb_stride", ctypes.c_int),
                ("pad2", ctypes.c_uint32 * 3),
                ("writer", ctypes.c_void_p), ("custom_ptr", ctypes.c_void_p),
                ("rest", ctypes.c_uint8 * 256)]


_ENCODER_ABI = 0x020f


def encode_webp(image: np.ndarray, **config) -> bytes:
    """A still WebP file of an RGB [h, w, 3] or RGBA [h, w, 4] uint8 image
    through libwebp's WebPEncode. config: WebPConfig fields (quality,
    method, lossless, segments, filter_type 0 = simple, filter_strength,
    filter_sharpness, partitions, sns_strength, autofilter, exact, ...)."""
    lib = _libwebp()
    img = np.ascontiguousarray(image, np.uint8)
    h, w, ch = img.shape
    cfg = _Config()
    if not lib.WebPConfigInitInternal(ctypes.byref(cfg), 0,
                                      float(config.get("quality", 75)),
                                      _ENCODER_ABI):
        raise RuntimeError("WebPConfigInit failed")
    for key, value in config.items():
        setattr(cfg, key, value)
    pic = _Picture()
    if not lib.WebPPictureInitInternal(ctypes.byref(pic), _ENCODER_ABI):
        raise RuntimeError("WebPPictureInit failed")
    pic.width, pic.height = w, h
    pic.use_argb = int(bool(cfg.lossless))
    writer = _MemoryWriter()
    lib.WebPMemoryWriterInit(ctypes.byref(writer))
    pic.writer = ctypes.cast(lib.WebPMemoryWrite, ctypes.c_void_p).value
    pic.custom_ptr = ctypes.addressof(writer)
    try:
        importer = (lib.WebPPictureImportRGBA if ch == 4
                    else lib.WebPPictureImportRGB)
        if not importer(ctypes.byref(pic), img.tobytes(), w * ch):
            raise RuntimeError("WebPPictureImport failed")
        if not lib.WebPEncode(ctypes.byref(cfg), ctypes.byref(pic)):
            raise RuntimeError("WebPEncode failed")
        return ctypes.string_at(writer.mem, writer.size)
    finally:
        lib.WebPPictureFree(ctypes.byref(pic))
        lib.WebPMemoryWriterClear(ctypes.byref(writer))


def _riff_chunk(fourcc: bytes, body: bytes) -> bytes:
    return fourcc + struct.pack("<I", len(body)) + body + b"\x00" * (
        len(body) & 1)


def webp_chunks(data: bytes) -> List[Tuple[bytes, bytes]]:
    """The (fourcc, body) chunks of a WebP file."""
    pos, out = 12, []
    while pos + 8 <= len(data):
        fourcc = data[pos:pos + 4]
        n = struct.unpack("<I", data[pos + 4:pos + 8])[0]
        out.append((fourcc, data[pos + 8:pos + 8 + n]))
        pos += 8 + n + (n & 1)
    return out


def webp_container(canvas: Tuple[int, int],
                   frames: Sequence[tuple]) -> bytes:
    """An animated WebP file (VP8X with the animation and alpha flags, an
    ANIM chunk, one ANMF a frame). frames: (x, y, width, height, chunks)
    with x and y even and chunks the frame's bitstream chunks (an ALPH
    and a VP8, or a VP8L)."""
    cw, ch = canvas
    body = _riff_chunk(b"VP8X", struct.pack("<I", 0x12)
                       + (cw - 1).to_bytes(3, "little")
                       + (ch - 1).to_bytes(3, "little"))
    body += _riff_chunk(b"ANIM", struct.pack("<IH", 0xFFFFFFFF, 0))
    for x, y, w, h, chunks in frames:
        head = ((x // 2).to_bytes(3, "little") + (y // 2).to_bytes(3, "little")
                + (w - 1).to_bytes(3, "little") + (h - 1).to_bytes(3, "little")
                + (100).to_bytes(3, "little") + b"\x00")
        body += _riff_chunk(b"ANMF", head + b"".join(
            _riff_chunk(c, b) for c, b in chunks))
    return b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WEBP" + body


# ------------------------------------------- VP8 loop-filter deltas

class _BoolDecoder:
    """RFC 6386's boolean decoder (section 7.3), zeros past the end."""

    def __init__(self, data: bytes):
        self.data, self.pos = data, 2
        self.value = (data[0] << 8 | data[1]) if len(data) > 1 else 0
        self.range, self.bit_count = 255, 0

    def get(self, prob: int) -> int:
        split = 1 + (((self.range - 1) * prob) >> 8)
        big = split << 8
        if self.value >= big:
            bit, self.range, self.value = 1, self.range - split, \
                self.value - big
        else:
            bit, self.range = 0, split
        while self.range < 128:
            self.value <<= 1
            self.range <<= 1
            self.bit_count += 1
            if self.bit_count == 8:
                self.bit_count = 0
                if self.pos < len(self.data):
                    self.value |= self.data[self.pos]
                self.pos += 1
        return bit


class _BoolEncoder:
    """RFC 6386's boolean encoder (section 7.3)."""

    def __init__(self):
        self.out = bytearray()
        self.range, self.bottom, self.bit_count = 255, 0, 24

    def _carry(self):
        i = len(self.out) - 1
        while i >= 0 and self.out[i] == 255:
            self.out[i] = 0
            i -= 1
        self.out[i] += 1

    def put(self, bit: int, prob: int) -> None:
        split = 1 + (((self.range - 1) * prob) >> 8)
        if bit:
            self.bottom += split
            self.range -= split
        else:
            self.range = split
        while self.range < 128:
            self.range <<= 1
            if self.bottom & (1 << 31):
                self._carry()
            self.bottom = (self.bottom << 1) & 0xFFFFFFFF
            self.bit_count -= 1
            if not self.bit_count:
                self.out.append((self.bottom >> 24) & 255)
                self.bottom &= (1 << 24) - 1
                self.bit_count = 8

    def flush(self) -> bytes:
        c, v = self.bit_count, self.bottom
        if v & (1 << (32 - c)):
            self._carry()
        v = (v << (c & 7)) & 0xFFFFFFFF
        for _ in range(c >> 3):
            v = (v << 8) & 0xFFFFFFFF
        for _ in range(4):
            self.out.append((v >> 24) & 255)
            v = (v << 8) & 0xFFFFFFFF
        return bytes(self.out)


def _decoder_tables():
    """The coefficient update probabilities [1056] and the 4x4 mode
    probabilities [10][10][9], read from the decoder's C++ source."""
    import re
    from pathlib import Path
    src = (Path(__file__).resolve().parent.parent / "maskrcnn_tpu_torch"
           / "csrc" / "webp_decode.cpp").read_text()

    def table(name):
        body = re.search(name + r"\[[^=]*= \{(.*?)\};", src, re.S).group(1)
        return [int(v) for v in re.findall(r"\d+", body)]

    modes = np.array(table("kBModesProba")).reshape(10, 10, 9)
    return table("kCoeffsUpdateProba"), modes


# libwebp's 4x4 mode tree (kYModesIntra4: a leaf is minus the mode)
_YMODES4 = [0, 1, -1, 2, -2, 3, 4, 6, -3, 5, -4, -5, -6, 7, -7, 8, -8, -9]


def vp8_with_lf_deltas(data: bytes, ref_deltas=(5, -2, 0, 3),
                       mode_deltas=(-4, 0, 6, 0)) -> bytes:
    """A plain lossy WebP file with its VP8 frame's loop-filter deltas
    set: the first partition is decoded symbol by symbol and written
    again with the same probabilities, the filter header's delta update
    replaced (libwebp's encoder writes no deltas). The token partitions
    are kept as they are."""
    update_probas, bmodes = _decoder_tables()
    at = data.index(b"VP8 ") + 8
    vp8 = data[at:at + struct.unpack("<I", data[at - 4:at])[0]]
    tag = vp8[0] | vp8[1] << 8 | vp8[2] << 16
    first = tag >> 5
    width = (vp8[6] | vp8[7] << 8) & 0x3FFF
    height = (vp8[8] | vp8[9] << 8) & 0x3FFF
    dec, enc = _BoolDecoder(vp8[10:10 + first]), _BoolEncoder()

    def copy(prob=128):
        bit = dec.get(prob)
        enc.put(bit, prob)
        return bit

    def value(n, prob=128):
        v = 0
        for _ in range(n):
            v = v << 1 | copy(prob)
        return v

    def put_value(v, n):
        for i in range(n - 1, -1, -1):
            enc.put((v >> i) & 1, 128)

    value(2)                                    # colour space, clamping
    seg_probs = [255, 255, 255]
    update_map = 0
    if copy():                                  # segments
        update_map = copy()
        if copy():
            copy()
            for bits in [7] * 4 + [6] * 4:
                if copy():
                    value(bits + 1)
        if update_map:
            for s in range(3):
                if copy():
                    seg_probs[s] = value(8)
    value(1 + 6 + 3)                            # simple, level, sharpness
    if dec.get(128):                            # the source's deltas: dropped
        if dec.get(128):
            for _ in range(8):
                if dec.get(128):
                    for _ in range(7):
                        dec.get(128)
    enc.put(1, 128)                             # use and update deltas
    enc.put(1, 128)
    for d in list(ref_deltas) + list(mode_deltas):
        enc.put(int(d != 0), 128)
        if d:
            put_value(abs(d), 6)
            enc.put(int(d < 0), 128)
    value(2)                                    # partitions
    value(7)                                    # base quantizer
    for _ in range(5):
        if copy():
            value(5)
    copy()                                      # refresh entropy
    for p in update_probas:
        if copy(p):
            value(8)
    skip_p = value(8) if copy() else None
    mb_w, mb_h = (width + 15) >> 4, (height + 15) >> 4
    top = [0] * (4 * mb_w)
    for _ in range(mb_h):
        left = [0] * 4
        for x in range(mb_w):
            if update_map:
                if not copy(seg_probs[0]):
                    copy(seg_probs[1])
                else:
                    copy(seg_probs[2])
            if skip_p is not None:
                copy(skip_p)
            if copy(145):                       # 16x16
                ymode = (1 if copy(128) else 3) if copy(156) else (
                    2 if copy(163) else 0)
                top[4 * x:4 * x + 4] = [ymode] * 4
                left = [ymode] * 4
            else:
                for yy in range(4):
                    m = left[yy]
                    for xx in range(4):
                        prob = bmodes[top[4 * x + xx]][m]
                        i = _YMODES4[copy(prob[0])]
                        while i > 0:
                            i = _YMODES4[2 * i + copy(prob[i])]
                        m = -i
                        top[4 * x + xx] = m
                    left[yy] = m
            if copy(142) and copy(114):
                copy(183)
    part0 = enc.flush()
    tag = (tag & 0x1F) | (len(part0) << 5)
    frame = bytes([tag & 255, (tag >> 8) & 255, tag >> 16]) + vp8[3:10] \
        + part0 + vp8[10 + first:]
    body = b"WEBP" + _riff_chunk(b"VP8 ", frame)
    return b"RIFF" + struct.pack("<I", len(body)) + body


# ----------------------------------------------------------------- TIFF

# tag types: BYTE, ASCII, SHORT, LONG, RATIONAL, UNDEFINED, LONG8
_TIFF_FMT = {1: "B", 2: "B", 3: "H", 4: "I", 5: "II", 7: "B", 11: "f", 12: "d",
             16: "Q"}
_TIFF_SIZE = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 7: 1, 11: 4, 12: 8, 16: 8}


def _bitrev_table() -> np.ndarray:
    k = np.arange(256)
    out = np.zeros(256, np.int64)
    for b in range(8):
        out |= ((k >> b) & 1) << (7 - b)
    return out.astype(np.uint8)


BITREV = _bitrev_table()


def tiff_rows(samples: np.ndarray, bits: int, byteorder: str) -> np.ndarray:
    """Rows of samples [r, n] (ints below 2**bits, or float32) as TIFF row
    bytes [r, stride]: samples below 8 bits packed MSB first, each row
    padded to a byte; 16- and 32-bit samples in `byteorder`."""
    s = np.asarray(samples)
    r, n = s.shape
    if bits in (16, 32, 64):
        kind = "f" if s.dtype.kind == "f" else "u"
        return s.astype(f"{byteorder}{kind}{bits // 8}").view(
            np.uint8).reshape(r, -1)
    if bits == 8:
        return s.astype(np.uint8)
    v = s.astype(np.int64)
    nbits = n * bits
    out = np.zeros((r, (nbits + 7) // 8), np.int64)
    pos = np.arange(n) * bits
    for b in range(bits):
        bit = (v >> (bits - 1 - b)) & 1
        p = pos + b
        np.add.at(out, (slice(None), p >> 3), bit << (7 - (p & 7)))
    return out.astype(np.uint8)


def tiff_packbits(data: bytes) -> bytes:
    """PackBits: runs of 2 to 128 equal bytes as one, the rest literally
    in pieces of at most 128."""
    out = bytearray()
    i, n = 0, len(data)
    lit = bytearray()

    def flush():
        for k in range(0, len(lit), 128):
            piece = lit[k:k + 128]
            out.append(len(piece) - 1)
            out.extend(piece)
        lit.clear()

    while i < n:
        j = i
        while j < n and j - i < 128 and data[j] == data[i]:
            j += 1
        if j - i >= 2:
            flush()
            out.append(257 - (j - i))
            out.append(data[i])
            i = j
        else:
            lit.append(data[i])
            i += 1
    flush()
    return bytes(out)


def tiff_lzw(data: bytes, old_style: bool = False) -> bytes:
    """TIFF LZW as libtiff writes it: a clear code first, 9- to 12-bit
    codes MSB first with the early change of code width, a clear code
    when the table fills, the end code last. `old_style`: codes LSB
    first and the width changed one code later (the pre-1990 streams
    libtiff still reads)."""
    out = bytearray()
    acc = nacc = 0
    nbits = 9
    limit = 512 if old_style else 511

    def put(code):
        nonlocal acc, nacc
        if old_style:
            acc |= code << nacc
            nacc += nbits
            while nacc >= 8:
                out.append(acc & 255)
                acc >>= 8
                nacc -= 8
        else:
            acc = (acc << nbits) | code
            nacc += nbits
            while nacc >= 8:
                out.append((acc >> (nacc - 8)) & 255)
                nacc -= 8
                acc &= (1 << nacc) - 1

    table = {}
    free = 258
    put(256)
    w = -1
    for byte in data:
        if w < 0:
            w = byte
            continue
        key = (w << 8) | byte
        code = table.get(key)
        if code is not None:
            w = code
            continue
        put(w)
        if free == 4094:
            put(256)
            table.clear()
            free, nbits, limit = 258, 9, 512 if old_style else 511
        else:
            table[key] = free
            free += 1
            if free > limit:
                nbits += 1
                limit = (1 << nbits) - (0 if old_style else 1)
        w = byte
    if w >= 0:
        put(w)
        free += 1
        if free > limit and nbits < 12:
            nbits += 1
    put(257)
    if nacc:
        out.append(((acc << (8 - nacc)) if not old_style else acc) & 255)
    return bytes(out)


def tiff_predict(rows: np.ndarray, stride: int, bits: int,
                 predictor: int, byteorder: str) -> np.ndarray:
    """Row bytes [r, stride_bytes] of segment rows [r, n] with TIFF
    predictor 2 (horizontal differences of `stride` samples apart, mod
    2**bits) or 3 (floating point: each row's float bytes in big-endian
    planes, then byte differences `stride` apart)."""
    s = np.asarray(rows)
    if predictor == 2:
        v = s.astype(np.int64)
        d = v.copy()
        d[:, stride:] = (v[:, stride:] - v[:, :-stride]) % (1 << bits)
        if s.dtype.kind == "f":
            d = s.view(f"u{bits // 8}").astype(np.int64)
            d[:, stride:] = (d[:, stride:] - d[:, :-stride]) % (1 << bits)
            return tiff_rows(d.astype(np.uint64), bits, byteorder)
        return tiff_rows(d, bits, byteorder)
    r, n = s.shape
    planes = s.astype(">f4").view(np.uint8).reshape(r, n, 4).transpose(
        0, 2, 1).reshape(r, 4 * n).astype(np.int64)
    out = planes.copy()
    out[:, stride:] = (planes[:, stride:] - planes[:, :-stride]) % 256
    return out.astype(np.uint8)


_LIBZSTD = None


def _libzstd():
    """Pillow's bundled libzstd (1.5.7), which its libtiff uses."""
    global _LIBZSTD
    if _LIBZSTD is None:
        import glob
        import os

        import PIL
        libs = os.path.join(os.path.dirname(os.path.dirname(PIL.__file__)),
                            "pillow.libs")
        lib = ctypes.CDLL(sorted(glob.glob(os.path.join(
            libs, "libzstd-*.so*")))[0])
        lib.ZSTD_createCCtx.restype = ctypes.c_void_p
        lib.ZSTD_freeCCtx.argtypes = [ctypes.c_void_p]
        lib.ZSTD_CCtx_setParameter.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                               ctypes.c_int]
        lib.ZSTD_CCtx_setParameter.restype = ctypes.c_size_t
        lib.ZSTD_compressBound.argtypes = [ctypes.c_size_t]
        lib.ZSTD_compressBound.restype = ctypes.c_size_t
        lib.ZSTD_compress2.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                       ctypes.c_size_t, ctypes.c_char_p,
                                       ctypes.c_size_t]
        lib.ZSTD_compress2.restype = ctypes.c_size_t
        lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
        _LIBZSTD = lib
    return _LIBZSTD


# ZSTD_cParameter values of zstd.h
_ZSTD_PARAMS = {"level": 100, "window_log": 101, "ldm": 160,
                "content_size": 200, "checksum": 201}


def zstd_frame(data: bytes, level: int = 3, checksum: bool = False,
               content_size: bool = True, window_log: int = 0,
               ldm: bool = False) -> bytes:
    """One zstd frame of `data` through Pillow's libzstd: a compression
    level (1-22, or negative), the XXH64 content checksum, the frame
    content size in the header (without it libzstd's decoder streams),
    a window log (0: the level's), long-distance matching."""
    lib = _libzstd()
    cctx = lib.ZSTD_createCCtx()
    try:
        for name, value in (("level", level), ("checksum", int(checksum)),
                            ("content_size", int(content_size)),
                            ("window_log", window_log), ("ldm", int(ldm))):
            if lib.ZSTD_isError(lib.ZSTD_CCtx_setParameter(
                    cctx, _ZSTD_PARAMS[name], value)):
                raise ValueError(f"zstd parameter {name}={value}")
        cap = lib.ZSTD_compressBound(len(data))
        out = ctypes.create_string_buffer(cap)
        n = lib.ZSTD_compress2(cctx, out, cap, data, len(data))
        if lib.ZSTD_isError(n):
            raise ValueError("zstd compression failed")
        return out.raw[:n]
    finally:
        lib.ZSTD_freeCCtx(cctx)


def xz_liblzma(data: bytes, ids: Sequence[int], start: Optional[int] = None,
               check: int = 4) -> bytes:
    """An .xz stream of `data` through the filters `ids` (a Delta filter of
    distance 3; a BCJ filter's start offset `start`) then LZMA2 at preset
    6, by Pillow's bundled liblzma (lzma_stream_buffer_encode) by ctypes:
    the standard library's lzma may not know ARM64 (10) or RISC-V (11)."""
    import glob
    import os

    import PIL
    libs = os.path.join(os.path.dirname(os.path.dirname(PIL.__file__)),
                        "pillow.libs")
    lib = ctypes.CDLL(glob.glob(os.path.join(libs, "liblzma*"))[0])

    class Filter(ctypes.Structure):
        _fields_ = [("id", ctypes.c_uint64), ("options", ctypes.c_void_p)]

    lzma2 = ctypes.create_string_buffer(256)   # lzma_options_lzma
    if lib.lzma_lzma_preset(lzma2, 6):
        raise RuntimeError("lzma_lzma_preset failed")
    keep, chain = [], (Filter * (len(ids) + 2))()
    for k, fid in enumerate(ids):
        opts = None
        if fid == 3 or start is not None:
            # lzma_options_delta {type, dist} or lzma_options_bcj
            # {start_offset}
            vals = (ctypes.c_uint32 * 8)(*((0, 3) if fid == 3 else (start,)))
            keep.append(vals)
            opts = ctypes.cast(vals, ctypes.c_void_p)
        chain[k] = Filter(fid, opts)
    chain[len(ids)] = Filter(0x21, ctypes.cast(lzma2, ctypes.c_void_p))
    chain[len(ids) + 1] = Filter(0xFFFFFFFFFFFFFFFF, None)
    out = ctypes.create_string_buffer(2 * len(data) + 1024)
    pos = ctypes.c_size_t(0)
    lib.lzma_stream_buffer_encode.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_char_p,
        ctypes.c_size_t, ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t),
        ctypes.c_size_t]
    if lib.lzma_stream_buffer_encode(chain, check, None, data, len(data), out,
                                     ctypes.byref(pos), len(out)):
        raise RuntimeError("lzma_stream_buffer_encode failed")
    return out.raw[:pos.value]


def xz_stream(data: bytes, check: Optional[int] = None, preset: int = 6,
              filters: Optional[list] = None) -> bytes:
    """An .xz stream of `data` by the standard library's lzma (LZMA2
    alone unless `filters` says otherwise; CRC64 unless `check`)."""
    import lzma
    return lzma.compress(data, format=lzma.FORMAT_XZ,
                         check=lzma.CHECK_CRC64 if check is None else check,
                         preset=None if filters else preset, filters=filters)


# ---------------------------------------------------------- TIFF CCITT

# T.4's run codes: {run: bits} of the terminating and make-up codes
_FAX_WHITE = dict(zip(range(64), (
    "00110101 000111 0111 1000 1011 1100 1110 1111 10011 10100 00111 01000 "
    "001000 000011 110100 110101 101010 101011 0100111 0001100 0001000 "
    "0010111 0000011 0000100 0101000 0101011 0010011 0100100 0011000 "
    "00000010 00000011 00011010 00011011 00010010 00010011 00010100 "
    "00010101 00010110 00010111 00101000 00101001 00101010 00101011 "
    "00101100 00101101 00000100 00000101 00001010 00001011 01010010 "
    "01010011 01010100 01010101 00100100 00100101 01011000 01011001 "
    "01011010 01011011 01001010 01001011 00110010 00110011 00110100"
).split()))
_FAX_WHITE.update(zip(range(64, 1729, 64), (
    "11011 10010 010111 0110111 00110110 00110111 01100100 01100101 "
    "01101000 01100111 011001100 011001101 011010010 011010011 011010100 "
    "011010101 011010110 011010111 011011000 011011001 011011010 011011011 "
    "010011000 010011001 010011010 011000 010011011").split()))
_FAX_BLACK = dict(zip(range(64), (
    "0000110111 010 11 10 011 0011 0010 00011 000101 000100 0000100 "
    "0000101 0000111 00000100 00000111 000011000 0000010111 0000011000 "
    "0000001000 00001100111 00001101000 00001101100 00000110111 "
    "00000101000 00000010111 00000011000 000011001010 000011001011 "
    "000011001100 000011001101 000001101000 000001101001 000001101010 "
    "000001101011 000011010010 000011010011 000011010100 000011010101 "
    "000011010110 000011010111 000001101100 000001101101 000011011010 "
    "000011011011 000001010100 000001010101 000001010110 000001010111 "
    "000001100100 000001100101 000001010010 000001010011 000000100100 "
    "000000110111 000000111000 000000100111 000000101000 000001011000 "
    "000001011001 000000101011 000000101100 000001011010 000001100110 "
    "000001100111").split()))
_FAX_BLACK.update(zip(range(64, 1729, 64), (
    "0000001111 000011001000 000011001001 000001011011 000000110011 "
    "000000110100 000000110101 0000001101100 0000001101101 0000001001010 "
    "0000001001011 0000001001100 0000001001101 0000001110010 "
    "0000001110011 0000001110100 0000001110101 0000001110110 "
    "0000001110111 0000001010010 0000001010011 0000001010100 "
    "0000001010101 0000001011010 0000001011011 0000001100100 "
    "0000001100101").split()))
_FAX_EXT = dict(zip(range(1792, 2561, 64), (
    "00000001000 00000001100 00000001101 000000010010 000000010011 "
    "000000010100 000000010101 000000010110 000000010111 000000011100 "
    "000000011101 000000011110 000000011111").split()))
_FAX_EOL = "000000000001"
_FAX_V = {0: "1", 1: "011", 2: "000011", 3: "0000011", -1: "010",
          -2: "000010", -3: "0000010"}


def _fax_run(run: int, black: bool) -> str:
    """A run's make-up codes (2560 at a time past 2560) and terminating
    code."""
    table = _FAX_BLACK if black else _FAX_WHITE
    out = []
    while run >= 2560:
        out.append(_FAX_EXT[2560])
        run -= 2560
    if run >= 64:
        big = run // 64 * 64
        out.append(table.get(big) or _FAX_EXT[big])
        run -= big
    out.append(table[run])
    return "".join(out)


def _fax_codes(row: np.ndarray) -> list:
    """A row of bools (True black) as modified Huffman runs, white
    first: [(code, True for a black run's)]."""
    out, x, black = [], 0, False
    w = len(row)
    while x < w:
        n = x
        while n < w and bool(row[n]) == black:
            n += 1
        run = n - x
        while run >= 2560:
            out.append((_FAX_EXT[2560], black))
            run -= 2560
        if run >= 64:
            big = run // 64 * 64
            table = _FAX_BLACK if black else _FAX_WHITE
            out.append((table.get(big) or _FAX_EXT[big], black))
            run -= big
        out.append(((_FAX_BLACK if black else _FAX_WHITE)[run], black))
        x, black = n, not black
    return out


def _fax_1d(row: np.ndarray) -> str:
    return "".join(code for code, _ in _fax_codes(row))


def _rlew_row(row: np.ndarray, start: int) -> str:
    """A row of RLEW (32771) starting at bit `start` (a 16-bit word):
    its codes, then zeros to where libtiff's Fax3DecodeRLE reads the next
    row from. Its reader takes bytes ahead for its 12- and 13-bit code
    lookups, and after the row keeps a whole 16 bits of them or skips to
    an even byte; so rows are laid where it looks for them, not at the
    next word."""
    loaded, avail, out = start // 8, 0, []
    for code, black in _fax_codes(row):
        need = 13 if black else 12
        for _ in range(2):
            if avail < need:
                loaded += 1
                avail += 8
        avail -= len(code)
        out.append(code)
    avail -= avail - (avail & ~15)
    if avail == 0 and loaded % 2:
        loaded += 1
    bits = "".join(out)
    return bits + "0" * (loaded * 8 - avail - start - len(bits))


def _changes(line: np.ndarray) -> list:
    """A line's changing elements: the pixels whose colour differs from
    the one before (white before the first); even entries turn black."""
    a = np.concatenate([[False], np.asarray(line, bool)])
    return np.flatnonzero(a[1:] != a[:-1]).tolist()


def _fax_2d(row: np.ndarray, ref: np.ndarray) -> str:
    """A row coded against its reference line (T.4 2D / T.6): pass,
    vertical and horizontal modes."""
    import bisect
    w = len(row)
    cur, prev = _changes(row), _changes(ref)

    def next_change(changes, after, black=None):
        i = bisect.bisect_right(changes, after)
        if black is not None and i % 2 != (0 if black else 1):
            i += 1
        return changes[i] if i < len(changes) else w

    out, a0, black = [], -1, False
    while a0 < w:
        a1 = next_change(cur, a0)
        b1 = next_change(prev, a0, not black)
        b2 = next_change(prev, b1)
        if b2 < a1:
            out.append("0001")
            a0 = b2
        elif abs(a1 - b1) <= 3:
            out.append(_FAX_V[a1 - b1])
            a0, black = a1, not black
        else:
            a2 = next_change(cur, a1)
            out.append("001" + _fax_run(a1 - max(a0, 0), black)
                       + _fax_run(a2 - a1, not black))
            a0 = a2
    return "".join(out)


def _bits_to_bytes(bits: str) -> bytes:
    bits += "0" * (-len(bits) % 8)
    return int(bits, 2).to_bytes(len(bits) // 8, "big") if bits else b""


def fax_encode(rows: np.ndarray, compression: int, options: int = 0,
               k: int = 2, eol_at_start: bool = True) -> bytes:
    """A strip or tile of bools [h, w] (True black, as photometric 0
    reads them) in a CCITT compression, bits MSB first: 2 (modified
    Huffman, rows to a byte), 32771 (RLEW, rows laid out where libtiff's
    reader takes them: `_rlew_row`), 3
    (T.4: an EOL before each row; T4Options bit 0 a 1D/2D tag bit after
    it and every k-th row 1D, bit 2 fill bits ending each EOL on a byte;
    `eol_at_start` False leaves the first EOL out) or 4 (T.6 against
    the previous row, then EOFB)."""
    rows = np.asarray(rows, bool)
    w = rows.shape[1]
    ref = np.zeros(w, bool)
    out = ""
    for i, row in enumerate(rows):
        if compression == 2:
            out += _fax_1d(row)
            out += "0" * (-len(out) % 8)
        elif compression == 32771:
            out += _rlew_row(row, len(out))
        elif compression == 3:
            if i or eol_at_start:
                if options & 4:
                    out += "0" * ((4 - len(out)) % 8)
                out += _FAX_EOL
            if options & 1:
                one_d = i % k == 0
                out += ("1" + _fax_1d(row)) if one_d else (
                    "0" + _fax_2d(row, ref))
            else:
                out += _fax_1d(row)
        else:
            out += _fax_2d(row, ref)
        ref = row
    if compression == 4:
        out += _FAX_EOL * 2
    return _bits_to_bytes(out)


def encode_tiff(samples: np.ndarray, *, bits: int = 8, photometric: int = 2,
                compression: int = 1, predictor: int = 1,
                byteorder: str = "<", bigtiff: bool = False,
                rows_per_strip: Optional[int] = None,
                tile: Optional[Tuple[int, int]] = None, planar: int = 1,
                fill_order: int = 1, extra_samples: Sequence[int] = (),
                sample_format: Optional[int] = None,
                colormap: Optional[np.ndarray] = None,
                orientation: Optional[int] = None, old_lzw: bool = False,
                segments: Optional[Sequence[bytes]] = None,
                jpeg_tables: Optional[bytes] = None,
                ycbcr_subsampling: Optional[Tuple[int, int]] = None,
                zlib_level: int = 6, zstd: Optional[dict] = None,
                xz: Optional[dict] = None, fax: Optional[dict] = None,
                tags: Optional[dict] = None,
                omit: Sequence[int] = (), width: Optional[int] = None,
                height: Optional[int] = None) -> bytes:
    """A one-page TIFF file of samples [h, w] or [h, w, spp] (ints below
    2**bits, or float32 with sample_format 3): strips of `rows_per_strip`
    rows (default: one strip) or tiles of `tile` = (width, length) (edge
    tiles padded with zeros); PlanarConfiguration 1 or 2; compression 1
    (none), 5 (LZW; `old_lzw` for LSB-first codes), 8 (Deflate, zlib),
    32773 (PackBits), 50000 (ZSTD: `zstd_frame` with the `zstd`
    arguments), 34925 (LZMA: `xz_stream` with the `xz` arguments), 2, 3,
    4 or 32771 (CCITT, 1-bit samples: `fax_encode` with the `fax`
    arguments; T4Options from its `options`), or
    any compression with `segments` (each strip's or tile's bytes,
    given: a JPEG stream for 7) and `jpeg_tables`; predictor 2 or 3; FillOrder
    2 (every byte of each segment's data bit-reversed); II or MM byte
    order ("<" or ">"), classic or BigTIFF (8-byte offsets, LONG8
    strip and tile offsets). `tags` adds or overrides {tag: (type,
    values)}, `omit` leaves tags out (a file that is corrupt on
    purpose)."""
    import zlib
    a = np.asarray(samples)
    if a.ndim == 2:
        a = a[..., None]
    h, w, spp = a.shape
    segs = []
    if tile:
        tw, th = tile
        across, down = -(-w // tw), -(-h // th)
        grid = np.zeros((down * th, across * tw, spp), a.dtype)
        grid[:h, :w] = a
        boxes = [(y * th, x * tw, th, tw) for y in range(down)
                 for x in range(across)]
    else:
        rps = rows_per_strip or h
        grid = a
        boxes = [(y, 0, min(rps, h - y), w) for y in range(0, h, rps)]
    planes = range(spp) if planar == 2 else [None]
    if segments is None:
        for p in planes:
            for y, x, bh, bw in boxes:
                block = grid[y:y + bh, x:x + bw]
                block = block[..., p] if p is not None else block
                rows = block.reshape(bh, -1)
                stride = 1 if p is not None else spp
                if compression in (2, 3, 4, 32771):
                    data = fax_encode(rows, compression, **(fax or {}))
                    if fill_order == 2:
                        data = BITREV[np.frombuffer(data, np.uint8)].tobytes()
                    segs.append(data)
                    continue
                if predictor in (2, 3):
                    raw = tiff_predict(rows, stride, bits, predictor,
                                       byteorder)
                else:
                    raw = tiff_rows(rows, bits, byteorder)
                data = raw.tobytes()
                if compression == 5:
                    data = tiff_lzw(data, old_lzw)
                elif compression in (8, 32946):
                    data = zlib.compress(data, zlib_level)
                elif compression == 32773:
                    data = tiff_packbits(data)
                elif compression == 50000:
                    data = zstd_frame(data, **(zstd or {}))
                elif compression == 34925:
                    data = xz_stream(data, **(xz or {}))
                if fill_order == 2:
                    data = BITREV[np.frombuffer(data, np.uint8)].tobytes()
                segs.append(data)
    else:
        segs = list(segments)
    off_type = 16 if bigtiff else 4
    t = {256: (4, [width or w]), 257: (4, [height or h]),
         258: (3, [bits] * spp), 259: (3, [compression]),
         262: (3, [photometric]), 277: (3, [spp])}
    if fill_order != 1:
        t[266] = (3, [fill_order])
    if planar != 1:
        t[284] = (3, [planar])
    if predictor != 1:
        t[317] = (3, [predictor])
    if compression in (3, 4) and (fax or {}).get("options"):
        t[292 if compression == 3 else 293] = (4, [fax["options"]])
    if extra_samples:
        t[338] = (3, list(extra_samples))
    if sample_format is not None:
        t[339] = (3, [sample_format] * spp)
    if colormap is not None:
        t[320] = (3, np.asarray(colormap).T.reshape(-1).tolist())
    if orientation is not None:
        t[274] = (3, [orientation])
    if jpeg_tables is not None:
        t[347] = (7, list(jpeg_tables))
    if ycbcr_subsampling is not None:
        t[530] = (3, list(ycbcr_subsampling))
    if tile:
        t[322] = (4, [tile[0]])
        t[323] = (4, [tile[1]])
    elif rows_per_strip:
        t[278] = (4, [rows_per_strip])
    offs_tag, counts_tag = (324, 325) if tile else (273, 279)
    t[counts_tag] = (off_type, [len(s) for s in segs])
    t[offs_tag] = (off_type, [0] * len(segs))    # filled in below
    for tag, value in (tags or {}).items():
        t[tag] = value
    for tag in omit:
        t.pop(tag, None)
    e = byteorder
    head = 16 if bigtiff else 8
    out = bytearray(head)
    offsets = []
    for s in segs:
        offsets.append(len(out))
        out += s
        if len(out) & 1:
            out.append(0)
    if offs_tag in t and offs_tag not in (tags or {}):
        t[offs_tag] = (t[offs_tag][0], offsets)
    entry, count_fmt, inline = (20, "Q", 8) if bigtiff else (12, "I", 4)
    blobs = {}
    for tag, (typ, values) in sorted(t.items()):
        fmt = _TIFF_FMT[typ]
        if typ == 5:
            data = b"".join(struct.pack(e + "II", *v) for v in values)
        else:
            data = struct.pack(f"{e}{len(values)}{fmt}", *values)
        if len(data) > inline:
            blobs[tag] = len(out)
            out += data
            if len(out) & 1:
                out.append(0)
    ifd = len(out)
    out += struct.pack(e + ("Q" if bigtiff else "H"), len(t))
    for tag, (typ, values) in sorted(t.items()):
        count = len(values) if typ != 5 else len(values)
        out += struct.pack(f"{e}HH{count_fmt}", tag, typ, count)
        if tag in blobs:
            out += struct.pack(e + ("Q" if bigtiff else "I"), blobs[tag])
        else:
            if typ == 5:
                data = b"".join(struct.pack(e + "II", *v) for v in values)
            else:
                data = struct.pack(f"{e}{len(values)}{_TIFF_FMT[typ]}",
                                   *values)
            out += data.ljust(inline, b"\x00")
    out += bytes(8 if bigtiff else 4)
    magic = b"II" if e == "<" else b"MM"
    if bigtiff:
        out[:16] = magic + struct.pack(e + "HHHQ", 43, 8, 0, ifd)
    else:
        out[:8] = magic + struct.pack(e + "HI", 42, ifd)
    return bytes(out)


def rgb_to_ycbcr(rgb: np.ndarray) -> np.ndarray:
    """RGB uint8 [h, w, 3] as YCbCr (JFIF's full-range equations,
    rounded)."""
    x = np.asarray(rgb, np.float64)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = 128 - 0.168736 * r - 0.331264 * g + 0.5 * b
    cr = 128 + 0.5 * r - 0.418688 * g - 0.081312 * b
    return np.clip(np.rint(np.stack([y, cb, cr], -1)), 0, 255).astype(np.uint8)


def rgb_to_lab(rgb: np.ndarray) -> np.ndarray:
    """RGB uint8 [h, w, 3] as TIFF's CIELab samples (photometric 8): L*
    scaled to 0-255, a* and b* as signed bytes (sRGB to XYZ, D65 white;
    close enough for test images, not a colour-managed conversion)."""
    c = np.asarray(rgb, np.float64) / 255
    c = np.where(c > 0.04045, ((c + 0.055) / 1.055) ** 2.4, c / 12.92)
    xyz = c @ np.array([[0.4124, 0.2126, 0.0193], [0.3576, 0.7152, 0.1192],
                        [0.1805, 0.0722, 0.9505]])
    xyz /= (0.95047, 1.0, 1.08883)
    f = np.where(xyz > 0.008856, np.cbrt(xyz), 7.787 * xyz + 16 / 116)
    L = 116 * f[..., 1] - 16
    a = 500 * (f[..., 0] - f[..., 1])
    b = 200 * (f[..., 1] - f[..., 2])
    out = np.stack([np.clip(np.rint(L * 2.55), 0, 255),
                    np.clip(np.rint(a), -128, 127) % 256,
                    np.clip(np.rint(b), -128, 127) % 256], -1)
    return out.astype(np.uint8)


def ycbcr_blocks(ycc: np.ndarray, hs: int, vs: int) -> bytes:
    """YCbCr samples [h, w, 3] packed as TIFF's subsampled YCbCr: blocks of
    hs x vs luma samples (row by row) then one Cb and one Cr (the block's
    means), a row of blocks after another; the edges padded by repeating
    the last row and column."""
    h, w, _ = ycc.shape
    bh, bw = -(-h // vs), -(-w // hs)
    pad = np.pad(ycc, ((0, bh * vs - h), (0, bw * hs - w), (0, 0)),
                 mode="edge")
    blocks = pad.reshape(bh, vs, bw, hs, 3).transpose(0, 2, 1, 3, 4)
    luma = blocks[..., 0].reshape(bh, bw, hs * vs)
    chroma = np.rint(blocks[..., 1:].reshape(bh, bw, hs * vs, 2).mean(2))
    return np.concatenate([luma, chroma.astype(np.uint8)], -1).tobytes()


def tiff_compress(data: bytes, compression: int, **kw) -> bytes:
    """One strip's or tile's bytes under `compression` (1, 5, 8, 32773,
    50000 or 34925), as encode_tiff compresses them."""
    import zlib
    if compression == 5:
        return tiff_lzw(data, kw.get("old_lzw", False))
    if compression in (8, 32946):
        return zlib.compress(data, kw.get("zlib_level", 6))
    if compression == 32773:
        return tiff_packbits(data)
    if compression == 50000:
        return zstd_frame(data, **kw.get("zstd", {}))
    if compression == 34925:
        return xz_stream(data, **kw.get("xz", {}))
    return data


def encode_tiff_ycbcr(rgb: np.ndarray, sub: Tuple[int, int] = (2, 2), *,
                      compression: int = 5,
                      rows_per_strip: Optional[int] = None,
                      tile: Optional[Tuple[int, int]] = None, planar: int = 1,
                      **kw) -> bytes:
    """An RGB image [h, w, 3] as a YCbCr TIFF subsampled `sub` = (hs, vs):
    contiguous strips of `rows_per_strip` rows or tiles of `tile` = (width,
    length), each packed as ycbcr_blocks (the image's edges padded), or
    separate planes (of the full-resolution samples); compressed as
    tiff_compress. The other keywords go to encode_tiff."""
    ycc = rgb_to_ycbcr(rgb)
    h, w, _ = ycc.shape
    if planar == 2:
        return encode_tiff(ycc, photometric=6, compression=compression,
                           rows_per_strip=rows_per_strip, tile=tile, planar=2,
                           ycbcr_subsampling=sub, **kw)
    hs, vs = sub
    if tile:
        tw, th = tile
        down, across = -(-h // th), -(-w // tw)
        grid = np.pad(ycc, ((0, down * th - h), (0, across * tw - w), (0, 0)),
                      mode="edge")
        raw = [ycbcr_blocks(grid[y:y + th, x:x + tw], hs, vs)
               for y in range(0, down * th, th)
               for x in range(0, across * tw, tw)]
    else:
        rps = rows_per_strip or h
        raw = [ycbcr_blocks(ycc[y:y + rps], hs, vs) for y in range(0, h, rps)]
    kwc = {k: kw.pop(k) for k in ("old_lzw", "zlib_level", "zstd", "xz")
           if k in kw}
    segs = [tiff_compress(r, compression, **kwc) for r in raw]
    return encode_tiff(ycc, photometric=6, compression=compression,
                       rows_per_strip=rows_per_strip, tile=tile,
                       segments=segs, ycbcr_subsampling=sub, **kw)


def jpeg_segments(data: bytes) -> dict:
    """A baseline JPEG file's parts: "dqt" {table id: 64 bytes, zigzag},
    "dht" {(class, id): 16 counts + symbols}, "sof" (width, height,
    [(id, h, v, tq)]), "sos" [(id, td, ta)], "dri" (0 unset), "data"
    (the entropy-coded data up to EOI, restart markers in it)."""
    out = {"dqt": {}, "dht": {}, "dri": 0}
    pos = 2
    while True:
        marker = data[pos + 1]
        n = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        body = data[pos + 4:pos + 2 + n]
        if marker == 0xDB:
            k = 0
            while k < len(body):
                out["dqt"][body[k] & 15] = body[k + 1:k + 65]
                k += 65
        elif marker == 0xC4:
            k = 0
            while k < len(body):
                m = sum(body[k + 1:k + 17])
                key = (body[k] >> 4, body[k] & 15)
                out["dht"][key] = body[k + 1:k + 17 + m]
                k += 17 + m
        elif marker == 0xDD:
            out["dri"] = struct.unpack(">H", body[:2])[0]
        elif marker in (0xC0, 0xC1):
            h, w, nc = struct.unpack(">HHB", body[1:6])
            out["sof"] = (w, h, [(body[6 + 3 * i], body[7 + 3 * i] >> 4,
                                  body[7 + 3 * i] & 15, body[8 + 3 * i])
                                 for i in range(nc)])
        elif marker == 0xDA:
            nc = body[0]
            out["sos"] = [(body[1 + 2 * i], body[2 + 2 * i] >> 4,
                           body[2 + 2 * i] & 15) for i in range(nc)]
            end = data.rindex(b"\xff\xd9")
            out["data"] = data[pos + 2 + n:end]
            return out
        pos += 2 + n


def encode_tiff_ojpeg(rgb: np.ndarray, *, subsampling: int = 2,
                      quality: int = 85, **kw) -> bytes:
    """An RGB image [h, w, 3] as an old-style JPEG TIFF: Pillow's baseline
    JPEG of it (`subsampling` 0, 1 or 2: 4:4:4, 4:2:2, 4:2:0; a restart
    interval a strip where `rows_per_strip` cuts the image) through
    ojpeg_tiff, which takes the other keywords."""
    from PIL import Image
    h = rgb.shape[0]
    hv = {0: (1, 1), 1: (2, 1), 2: (2, 2)}[subsampling]
    rps = kw.get("rows_per_strip") or h
    extra = {}
    if rps < h:
        assert rps % (8 * hv[1]) == 0, "a strip is whole MCU rows"
        extra["restart_marker_rows"] = rps // (8 * hv[1])
    buf = io.BytesIO()
    Image.fromarray(np.ascontiguousarray(rgb, np.uint8)).save(
        buf, "JPEG", quality=quality, subsampling=subsampling, **extra)
    return ojpeg_tiff(buf.getvalue(), **kw)


def ojpeg_tiff(jpeg: bytes, *, form: str = "tables",
               rows_per_strip: Optional[int] = None, photometric: int = 6,
               tags: Optional[dict] = None, omit: Sequence[int] = ()) -> bytes:
    """A baseline JPEG file (3 components, restart markers a strip apart
    where `rows_per_strip` cuts the image) as an old-style JPEG TIFF
    (compression 6): either whole at JPEGInterchangeFormat, the strips the
    entropy data within it (form "jif"), or split into libtiff's tables
    tags (JPEGProc 1, JPEGQTables, JPEGDCTables, JPEGACTables a component
    each, JPEGRestartInterval) and strips of entropy data (form "tables");
    YCbCrSubsampling the luma's sampling factors. `tags` adds or
    overrides tags, `omit` leaves them out. Numpy and struct only."""
    seg = jpeg_segments(jpeg)
    w, h, comps = seg["sof"]
    hv = comps[0][1:3]
    rps = rows_per_strip or h
    parts = (re.split(b"\xff[\xd0-\xd7]", seg["data"]) if rps < h
             else [seg["data"]])
    t = dict(tags or {})
    t[258] = (3, [8, 8, 8])
    t[530] = (3, list(hv))
    blank = np.zeros((h, w, 3), np.uint8)
    if form == "jif":
        # the stream first (offset 8), the strips pointing into it
        start = 8 + jpeg.index(seg["data"])
        offsets, at = [], start
        for part in parts:
            offsets.append(at)
            at += len(part) + 2
        t[513] = (4, [8])
        t[514] = (4, [len(jpeg)])
        body = encode_tiff(blank, photometric=photometric, compression=6,
                           rows_per_strip=rows_per_strip,
                           segments=[jpeg] + [b""] * (len(parts) - 1), tags=t)
        return _drop_tags(_retag_strips(body, offsets,
                                        [len(p) for p in parts]), omit)
    # a table a component (component m's at index m), leading the first
    # segment (offset 8), the first strip past them
    q = [seg["dqt"][c[3]] for c in comps]
    dc = [seg["dht"][(0, td)] for _, td, _ in seg["sos"]]
    ac = [seg["dht"][(1, ta)] for _, _, ta in seg["sos"]]
    t[512] = (3, [1])
    if rps < h:
        t[515] = (3, [seg["dri"]])
    at = 8
    for tag, group in ((519, q), (520, dc), (521, ac)):
        t[tag] = (4, [])
        for b in group:
            t[tag][1].append(at)
            at += len(b)
    tables = b"".join(q + dc + ac)
    body = encode_tiff(blank, photometric=photometric, compression=6,
                       rows_per_strip=rows_per_strip,
                       segments=[tables + parts[0]] + parts[1:], tags=t)
    strips = _strip_entries(body)
    offsets = [strips[0][0] + len(tables)] + [o for o, _ in strips[1:]]
    counts = [strips[0][1] - len(tables)] + [c for _, c in strips[1:]]
    return _drop_tags(_retag_strips(body, offsets, counts), omit)


def thunder_encode(pixels: np.ndarray) -> bytes:
    """Rows of 4-bit pixels [h, w] as ThunderScan data (libtiff's
    tif_thunder.c decodes it): runs of the last pixel, three 2-bit or two
    3-bit deltas from it, or raw pixels, each row from a last pixel of
    0."""
    two = {0: 0, 1: 1, -1: 3}
    three = {0: 0, 1: 1, 2: 2, 3: 3, -3: 5, -2: 6, -1: 7}
    out = bytearray()
    for row in np.asarray(pixels, np.int64):
        last, i, n = 0, 0, len(row)
        while i < n:
            k = i
            while k < n and k - i < 63 and row[k] == last:
                k += 1
            if k - i >= 2:
                out.append(k - i)
                i = k
                continue
            if i + 3 <= n:
                d = [int(row[i] - last), int(row[i + 1] - row[i]),
                     int(row[i + 2] - row[i + 1])]
                if all(x in two for x in d):
                    out.append(0x40 | two[d[0]] << 4 | two[d[1]] << 2
                               | two[d[2]])
                    last, i = int(row[i + 2]), i + 3
                    continue
            if i + 2 <= n:
                d = [int(row[i] - last), int(row[i + 1] - row[i])]
                if all(x in three for x in d):
                    out.append(0x80 | three[d[0]] << 3 | three[d[1]])
                    last, i = int(row[i + 1]), i + 2
                    continue
            out.append(0xC0 | int(row[i]))
            last, i = int(row[i]), i + 1
    return bytes(out)


def _drop_tags(data: bytes, tags: Sequence[int]) -> bytes:
    """A little-endian classic TIFF with the first IFD's entries of `tags`
    taken out (their data left where it is)."""
    if not tags:
        return data
    out = bytearray(data)
    ifd = struct.unpack("<I", out[4:8])[0]
    n = struct.unpack("<H", out[ifd:ifd + 2])[0]
    kept = [bytes(out[ifd + 2 + 12 * i:ifd + 14 + 12 * i]) for i in range(n)]
    kept = [e for e in kept if struct.unpack("<H", e[:2])[0] not in tags]
    out[ifd:ifd + 2] = struct.pack("<H", len(kept))
    out[ifd + 2:ifd + 2 + 12 * len(kept)] = b"".join(kept)
    out[ifd + 2 + 12 * len(kept):ifd + 6 + 12 * len(kept)] = bytes(4)
    return bytes(out)


def _strip_entries(data: bytes) -> list:
    """[(offset, byte count)] of a little-endian classic TIFF's strips."""
    ifd = struct.unpack("<I", data[4:8])[0]
    n = struct.unpack("<H", data[ifd:ifd + 2])[0]
    vals = {}
    for i in range(n):
        e = ifd + 2 + 12 * i
        tag, typ, count, v = struct.unpack("<HHII", data[e:e + 12])
        if tag in (273, 279):
            vals[tag] = ([v] if count == 1 else
                         list(struct.unpack(f"<{count}I",
                                            data[v:v + 4 * count])))
    return list(zip(vals[273], vals[279]))


def _retag_strips(data: bytes, offsets, counts) -> bytes:
    """A little-endian classic TIFF with its StripOffsets and
    StripByteCounts (LONG, of the same count) replaced."""
    out = bytearray(data)
    ifd = struct.unpack("<I", out[4:8])[0]
    n = struct.unpack("<H", out[ifd:ifd + 2])[0]
    for i in range(n):
        e = ifd + 2 + 12 * i
        tag, typ, count, v = struct.unpack("<HHII", out[e:e + 12])
        if tag not in (273, 279):
            continue
        vals = offsets if tag == 273 else counts
        assert typ == 4 and count == len(vals)
        if count == 1:
            out[e + 8:e + 12] = struct.pack("<I", vals[0])
        else:
            out[v:v + 4 * count] = struct.pack(f"<{count}I", *vals)
    return bytes(out)


def encode_icns(entries: Sequence[Tuple[bytes, bytes]]) -> bytes:
    """An ICNS file of `entries` [(code, data)], in that order."""
    body = b"".join(code + struct.pack(">I", len(data) + 8) + data
                    for code, data in entries)
    return b"icns" + struct.pack(">I", len(body) + 8) + body


def icns_rle(band: bytes) -> bytes:
    """One band of a packed ICNS icon in Apple's RLE: runs of 3 to 130
    equal bytes as (length + 125, byte), the rest as literals of at most
    128 bytes (length - 1, bytes)."""
    out, lit, i = bytearray(), bytearray(), 0
    while i < len(band):
        j = i
        while j < len(band) and j - i < 130 and band[j] == band[i]:
            j += 1
        if j - i >= 3:
            if lit:
                out += bytes([len(lit) - 1]) + lit
                lit = bytearray()
            out += bytes([j - i + 125, band[i]])
            i = j
            continue
        lit.append(band[i])
        i += 1
        if len(lit) == 128:
            out += bytes([127]) + lit
            lit = bytearray()
    if lit:
        out += bytes([len(lit) - 1]) + lit
    return bytes(out)


def icns_rgb(rgb: np.ndarray, rle: bool = True, prefix: bool = False) -> bytes:
    """A packed RGB icon entry of rgb [h, w, 3]: its bands in turn as
    icns_rle, or raw RGB triples; `prefix`: it32's 4 zero bytes first."""
    a = np.ascontiguousarray(rgb, np.uint8)
    data = (b"".join(icns_rle(a[..., k].tobytes()) for k in range(3))
            if rle else a.tobytes())
    return (b"\0" * 4 if prefix else b"") + data


def jpeg_split_tables(data: bytes) -> Tuple[bytes, bytes]:
    """A JPEG file as (a tables-only stream of its DQT and DHT segments,
    the abbreviated stream without them): TIFF's JPEGTables and a
    strip's or tile's data."""
    tables, rest = [b"\xff\xd8"], [b"\xff\xd8"]
    pos = 2
    while data[pos + 1] != 0xDA:
        n = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        (tables if data[pos + 1] in (0xDB, 0xC4) else rest).append(
            data[pos:pos + 2 + n])
        pos += 2 + n
    rest.append(data[pos:])
    return b"".join(tables) + b"\xff\xd9", b"".join(rest)


def jpeg_frame(data: bytes) -> Tuple[int, int, list]:
    """(width, height, [(h, v) sampling factors a component]) of a JPEG
    file's frame header."""
    pos = 2
    while data[pos + 1] not in (0xC0, 0xC1, 0xC2):
        pos += 2 + struct.unpack(">H", data[pos + 2:pos + 4])[0]
    h, w, n = struct.unpack(">HHB", data[pos + 5:pos + 10])
    comps = data[pos + 10:pos + 10 + 3 * n]
    return w, h, [(comps[3 * k + 1] >> 4, comps[3 * k + 1] & 15)
                  for k in range(n)]


def tiff_from_jpeg(data: bytes, byteorder: str = "<") -> bytes:
    """A JPEG file of 3 components (YCbCr) or 1 as a one-strip
    JPEG-compressed TIFF: photometric YCbCr with the stream's luma
    sampling as YCbCrSubsampling, or grayscale."""
    w, h, sampling = jpeg_frame(data)
    ycc = len(sampling) == 3
    shape = (h, w, 3) if ycc else (h, w)
    return encode_tiff(np.broadcast_to(np.uint8(0), shape),
                       photometric=6 if ycc else 1, compression=7,
                       segments=[data], byteorder=byteorder,
                       ycbcr_subsampling=sampling[0] if ycc else None)


# -------------------------------------- PPM, TGA, QOI, PCX, SGI, Sun, ICO
# numpy and the standard library alone (chip_smoke.py writes its PPM, TGA,
# QOI, PCX, SGI and Sun raster scenes with them on the card). Where a
# writer takes `rng`, it draws the encoder's free choices from it:
# whitespace and comments, packet splits, runs across rows.

_PPM_BANDS = {b"P1": 1, b"P2": 1, b"P3": 3, b"P4": 1, b"P5": 1, b"P6": 3,
              b"P0CMYK": 4, b"PyP": 1, b"PyRGBA": 4, b"PyCMYK": 4}


def _ppm_space(rng) -> bytes:
    """One or more whitespace bytes, now and then a comment."""
    if rng is None:
        return b"\n"
    out = b"".join(bytes([b" \t\n\r\x0b\x0c"[rng.randint(6)]])
                   for _ in range(1 + rng.randint(2)))
    if rng.rand() < 0.3:
        out += b"# a comment" + (b"\r" if rng.rand() < 0.5 else b"\n")
    return out


def encode_ppm(samples: np.ndarray, magic: bytes = b"P6", maxval: int = 255,
               rng=None, line: int = 70) -> bytes:
    """A Netpbm file of `samples` (rows top-down): [h, w] for P1/P4 (true
    black), P2/P5 and PyP, [h, w, 3] for P3/P6, [h, w, 4] for P0CMYK,
    PyRGBA and PyCMYK (ints up to maxval). The plain formats (P1-P3)
    write decimal tokens, `line` characters a line (P1 without spaces
    where rng says so); the others bytes, two big-endian where maxval
    passes 255. `rng`: whitespace and comments between header tokens."""
    s = np.asarray(samples)
    h, w = s.shape[:2]
    head = magic + _ppm_space(rng) + str(w).encode() + _ppm_space(rng) + \
        str(h).encode()
    if magic not in (b"P1", b"P4"):
        head += _ppm_space(rng) + str(maxval).encode()
    head += b"\n"
    if magic == b"P4":
        return head + _pack_rows(s.astype(np.int64), 1)[:, :(w + 7) // 8] \
            .tobytes()
    if magic == b"P1":
        flat = s.astype(np.int64).reshape(-1)
        if rng is not None and rng.rand() < 0.5:
            body = "".join(map(str, flat))
            return head + "\n".join(body[i:i + line] for i in
                                    range(0, len(body), line)).encode()
        return head + _plain_lines([str(v) for v in flat], line)
    if magic in (b"P2", b"P3"):
        return head + _plain_lines([str(v) for v in
                                    s.astype(np.int64).reshape(-1)], line)
    dtype = ">u2" if maxval > 255 else np.uint8
    return head + s.astype(dtype).tobytes()


def _plain_lines(tokens, line: int) -> bytes:
    out, cur = [], ""
    for t in tokens:
        if cur and len(cur) + 1 + len(t) > line:
            out.append(cur)
            cur = t
        else:
            cur = f"{cur} {t}" if cur else t
    out.append(cur)
    return ("\n".join(out) + "\n").encode()


def encode_pfm(values: np.ndarray, scale: float = -1.0) -> bytes:
    """A PFM ("Pf", one channel) of float32 values [h, w] (rows top-down;
    the file stores them bottom-up), little-endian for a negative scale."""
    v = np.asarray(values, np.float32)[::-1]
    h, w = v.shape
    return (b"Pf\n%d %d\n%r\n" % (w, h, scale)) + v.astype(
        "<f4" if scale < 0 else ">f4").tobytes()


def _packets(n: int, rng, max_run: int, same: np.ndarray) -> list:
    """Splits n units into (kind, start, count) packets of up to max_run
    units: "run" where the units from the second on repeat the first
    (same[i]: unit i equals unit i - 1), else "lit"; rng, where given,
    cuts packets short at random."""
    out, i = [], 0
    while i < n:
        j = i + 1
        while j < n and j - i < max_run and same[j]:
            j += 1
        kind = "run" if j - i >= 2 else "lit"
        if kind == "lit":
            while (j < n and j - i < max_run
                   and not (j + 1 < n and same[j + 1])):
                j += 1
        count = j - i
        if rng is not None and count > 1 and rng.rand() < 0.3:
            count = 1 + rng.randint(count - 1)
            kind = kind if count > 1 else "lit"
        out.append((kind, i, count))
        i += count
    return out


def _repeats(units: np.ndarray) -> np.ndarray:
    """units [n, k]: whether unit i equals unit i - 1."""
    same = np.zeros(len(units), bool)
    same[1:] = np.all(units[1:] == units[:-1], axis=1)
    return same


def encode_tga(pixels: np.ndarray, imagetype: int, depth: int, *,
               palette: Optional[np.ndarray] = None, map_start: int = 0,
               map_depth: int = 24, top: bool = True, right: bool = False,
               id_field: bytes = b"", rng=None) -> bytes:
    """A TGA file whose decode is `pixels` (rows top-down, columns left to
    right): palette indices or grays [h, w] (types 1/9, 3/11: depth 8;
    depth 1 bits), gray and alpha [h, w, 2] (depth 16), RGB [h, w, 3]
    (types 2/10: depth 24; depth 16 as 5-5-5, the alpha bit set) or RGBA
    [h, w, 4] (depth 32). `palette`: [n, 3] RGB at entry `map_start`,
    stored in `map_depth` bits. `top`/`right`: the origin the flags name
    (rows and columns are stored in that order). Types 9-11 are RLE:
    runs within a row, literal packets split by rng and free to run
    across rows, as TgaRleDecode.c reads them."""
    p = np.asarray(pixels)
    h, w = p.shape[:2]
    if not top:
        p = p[::-1]
    if right:
        p = p[:, ::-1]
    if depth == 1:
        rows = _pack_rows(p.astype(np.int64), 1)[:, :(w + 7) // 8]
        units = rows.reshape(h, -1, 1)
    elif depth == 16 and p.ndim == 3 and p.shape[2] == 3:
        c = p.astype(np.int64) >> 3
        word = (c[..., 0] << 10) | (c[..., 1] << 5) | c[..., 2] | 0x8000
        units = word.astype("<u2").view(np.uint8).reshape(h, w, 2)
    elif p.ndim == 3 and p.shape[2] >= 3:
        order = [2, 1, 0, 3][:p.shape[2]]
        units = p[..., order].astype(np.uint8)
    else:
        units = p.astype(np.uint8).reshape(h, w, -1)
    cmap = b""
    if palette is not None:
        pal = np.asarray(palette, np.int64)
        if map_depth == 16:
            c = pal >> 3
            cmap = ((c[:, 0] << 10) | (c[:, 1] << 5) | c[:, 2]).astype(
                "<u2").tobytes()
        else:
            bgr = pal[:, ::-1]
            if map_depth == 32:
                bgr = np.concatenate([bgr, np.full((len(pal), 1), 255)], 1)
            cmap = bgr.astype(np.uint8).tobytes()
    n_map = 0 if palette is None else len(palette)
    head = struct.pack("<BBBHHBHHHHBB", len(id_field),
                       int(palette is not None), imagetype, map_start, n_map,
                       map_depth if palette is not None else 0, 0, 0, w, h,
                       depth, (0x20 if top else 0) | (0x10 if right else 0))
    if imagetype < 8:
        return head + id_field + cmap + units.tobytes()
    k = units.shape[2]
    body = bytearray()
    flat = units.reshape(-1, k)
    same = _repeats(flat)
    same[::w] = False                       # no run across a row's start
    for kind, start, count in _packets(len(flat), rng, 128, same):
        if kind == "run":
            body += bytes([0x80 | (count - 1)]) + flat[start].tobytes()
        else:
            body += bytes([count - 1]) + flat[start:start + count].tobytes()
    return head + id_field + cmap + bytes(body)


_QOI_END = b"\x00" * 7 + b"\x01"


def encode_qoi(image: np.ndarray, colorspace: int = 0) -> bytes:
    """A QOI file of RGB [h, w, 3] or RGBA [h, w, 4]: every op (runs, the
    index, diffs, luma, RGB and RGBA), as the reference encoder chooses."""
    img = np.asarray(image, np.uint8)
    h, w, ch = img.shape
    px = img.reshape(-1, ch).tolist()
    seen = [None] * 64
    prev = [0, 0, 0, 255]
    out = bytearray(b"qoif" + struct.pack(">IIBB", w, h, ch, colorspace))
    run = 0
    for i, p in enumerate(px):
        v = p + [255] if ch == 3 else p
        if v == prev:
            run += 1
            if run == 62 or i == len(px) - 1:
                out.append(0xC0 | (run - 1))
                run = 0
            continue
        if run:
            out.append(0xC0 | (run - 1))
            run = 0
        hsh = (v[0] * 3 + v[1] * 5 + v[2] * 7 + v[3] * 11) % 64
        if seen[hsh] == v:
            out.append(hsh)
        elif v[3] == prev[3]:
            dr, dg, db = ((v[k] - prev[k] + 128) % 256 - 128 for k in range(3))
            if -2 <= dr < 2 and -2 <= dg < 2 and -2 <= db < 2:
                out.append(0x40 | (dr + 2) << 4 | (dg + 2) << 2 | (db + 2))
            elif -32 <= dg < 32 and -8 <= dr - dg < 8 and -8 <= db - dg < 8:
                out += bytes([0x80 | (dg + 32),
                              (dr - dg + 8) << 4 | (db - dg + 8)])
            else:
                out += bytes([0xFE] + v[:3])
        else:
            out += bytes([0xFF] + v)
        seen[hsh] = v
        prev = v
    return bytes(out) + _QOI_END


def encode_qoi_fast(image: np.ndarray) -> bytes:
    """A QOI file of RGB [h, w, 3] in runs and RGB ops only (numpy over
    the whole image: the scenes' writer)."""
    img = np.asarray(image, np.uint8)
    h, w, _ = img.shape
    flat = img.reshape(-1, 3)
    same = _repeats(flat)
    same[0] = bool(np.all(flat[0] == 0)) and False
    out = [b"qoif" + struct.pack(">IIBB", w, h, 3, 0)]
    starts = np.flatnonzero(~same)
    ends = np.append(starts[1:], len(flat))
    ops = np.zeros((len(starts), 4), np.uint8)
    ops[:, 0] = 0xFE
    ops[:, 1:] = flat[starts]
    runs = ends - starts - 1
    pieces = []
    for k in range(len(starts)):
        pieces.append(ops[k].tobytes())
        r = int(runs[k])
        while r > 0:
            pieces.append(bytes([0xC0 | (min(r, 62) - 1)]))
            r -= 62
    return out[0] + b"".join(pieces) + _QOI_END


def _pcx_rle(line: bytes, rng) -> bytes:
    """One scanline (its planes together) as PCX RLE: runs of up to 63,
    bytes of 0xC0 and above always as runs."""
    arr = np.frombuffer(line, np.uint8).reshape(-1, 1)
    same = _repeats(arr)
    out = bytearray()
    for kind, start, count in _packets(len(arr), rng, 63, same):
        if kind == "run":
            out += bytes([0xC0 | count, line[start]])
        else:
            for b in line[start:start + count]:
                out += bytes([0xC1, b]) if b >= 0xC0 else bytes([b])
    return bytes(out)


def encode_pcx(pixels: np.ndarray, bits: int, planes: int, *,
               palette: Optional[np.ndarray] = None,
               vga: Optional[bytes] = None,
               window: Tuple[int, int] = (0, 0), even: bool = True,
               version: int = 5, rng=None) -> bytes:
    """A PCX file: 1-bit [h, w] in 1 plane (true white), 1-bit palette
    indices [h, w] in 2 or 4 planes (`palette`: 16 RGB entries in the
    header), 8-bit [h, w] in one plane (`vga`: the 769 bytes at the
    file's end, or none) or RGB [h, w, 3] in 3 planes. `window`: the
    image's (xmin, ymin); `even`: rows padded to an even length (the
    header's stride), else the header states the unpadded length."""
    p = np.asarray(pixels)
    h, w = p.shape[:2]
    stride = (w * bits + 7) // 8
    padded = stride + (stride % 2 if even else 0)
    rows = []
    for y in range(h):
        if bits == 1:
            plane_rows = [_pack_rows(((p[y:y + 1].astype(np.int64) >> k) & 1),
                                     1)[0, :stride] for k in range(planes)]
        elif planes == 3:
            plane_rows = [p[y, :, k].astype(np.uint8) for k in range(3)]
        else:
            plane_rows = [p[y].astype(np.uint8)]
        rows.append(b"".join(np.pad(r, (0, padded - len(r))).tobytes()
                             for r in plane_rows))
    header = bytearray(128)
    x0, y0 = window
    struct.pack_into("<BBBBHHHHHH", header, 0, 10, version, 1, bits, x0, y0,
                     x0 + w - 1, y0 + h - 1, 72, 72)
    if palette is not None:
        entries = np.asarray(palette, np.uint8)[:16].tobytes()
        header[16:64] = entries.ljust(48, b"\0")
    header[65] = planes
    struct.pack_into("<HH", header, 66, padded if even else stride, 1)
    body = b"".join(_pcx_rle(r, rng) for r in rows)
    return bytes(header) + body + (vga or b"")


def encode_dcx(pages: Sequence[bytes]) -> bytes:
    """A DCX file of PCX pages."""
    table = 4 + 4 * (len(pages) + 1)
    offsets, pos = [], table
    for page in pages:
        offsets.append(pos)
        pos += len(page)
    return (struct.pack("<I", 987654321) + struct.pack(
        f"<{len(pages) + 1}I", *offsets, 0) + b"".join(pages))


def _sgi_rle_row(row: np.ndarray, bpc: int, rng) -> bytes:
    """One channel's row as SGI RLE packets (count | 0x80 literals, runs
    of one value), then a 0 count; 16-bit counts and values with bpc 2."""
    same = _repeats(row.reshape(-1, 1))
    dt = ">u2" if bpc == 2 else np.uint8
    out = []
    for kind, start, count in _packets(len(row), rng, 127, same):
        if kind == "run":
            out.append(np.array([count, row[start]], dt).tobytes())
        else:
            out.append(np.array([0x80 | count], dt).tobytes()
                       + row[start:start + count].astype(dt).tobytes())
    return b"".join(out) + np.array([0], dt).tobytes()


def encode_sgi(samples: np.ndarray, bpc: int = 1, rle: bool = False,
               dimension: Optional[int] = None, rng=None) -> bytes:
    """An SGI file of samples [h, w] (one channel) or [h, w, 3 or 4] (rows
    top-down; stored bottom-up), 1 or 2 bytes a sample, raw planes or RLE
    (an offset and a length table, a row of packets per channel and
    row)."""
    s = np.asarray(samples)
    if s.ndim == 2:
        s = s[..., None]
    h, w, z = s.shape
    dim = dimension or (3 if z > 1 else 2)
    head = bytearray(512)
    struct.pack_into(">hBBHHHH", head, 0, 474, int(rle), bpc, dim, w, h, z)
    struct.pack_into(">ii", head, 12, 0, 255 if bpc == 1 else 65535)
    planes = [s[::-1, :, c] for c in range(z)]
    if not rle:
        dt = ">u2" if bpc == 2 else np.uint8
        return bytes(head) + b"".join(pl.astype(dt).tobytes() for pl in planes)
    rows = [[_sgi_rle_row(planes[c][y], bpc, rng) for y in range(h)]
            for c in range(z)]
    pos = 512 + 8 * h * z
    starts, lengths, data = [], [], []
    for c in range(z):
        for y in range(h):
            starts.append(pos)
            lengths.append(len(rows[c][y]))
            data.append(rows[c][y])
            pos += len(rows[c][y])
    return (bytes(head) + struct.pack(f">{h * z}I", *starts)
            + struct.pack(f">{h * z}I", *lengths) + b"".join(data))


def _sun_rle(data: bytes, rng) -> bytes:
    """SunRleDecode.c's input: 0x80 n v a run of n + 1 (n up to 255), 0x80
    0 a literal 0x80, other bytes themselves."""
    arr = np.frombuffer(data, np.uint8).reshape(-1, 1)
    same = _repeats(arr)
    out = bytearray()
    for kind, start, count in _packets(len(arr), rng, 256, same):
        if kind == "run" and count >= 3:
            out += bytes([0x80, count - 1, data[start]])
        else:
            for b in data[start:start + count]:
                out += b"\x80\x00" if b == 0x80 else bytes([b])
    return bytes(out)


def encode_sun(pixels: np.ndarray, depth: int, file_type: int = 1, *,
               palette: Optional[np.ndarray] = None, rng=None,
               length: Optional[int] = None) -> bytes:
    """A Sun raster file: 1-bit [h, w] (true black), 4- or 8-bit grays or
    palette indices [h, w] (`palette`: [n, 3] RGB, stored as three
    planes), or RGB [h, w, 3] at depth 24 or 32 (BGR, or RGB for file
    type 3; a fourth byte after them at 32). Raw rows are padded to 16
    bits; file type 2 is RLE over the unpadded rows, runs across rows.
    `length`: the header's data length (the data's, by default; Pillow
    ignores it, but a width of 1 with a length of 1 or 4 makes the file a
    GIMP brush to Pillow's earlier GBR plugin)."""
    p = np.asarray(pixels)
    h, w = p.shape[:2]
    if depth in (1, 4, 8):
        bits = p.astype(np.int64)
        rows = _pack_rows(bits, depth)[:, :(w * depth + 7) // 8]
    else:
        rgb = p[..., :3] if file_type == 3 else p[..., 2::-1]
        if depth == 32:
            rgb = np.concatenate([rgb, np.full((h, w, 1), 7, np.uint8)], 2)
        rows = rgb.astype(np.uint8).reshape(h, -1)
    stride = ((w * depth + 15) // 16) * 2
    pal = b""
    if palette is not None:
        pal = np.asarray(palette, np.uint8).T.tobytes()
    if file_type == 2:
        body = _sun_rle(rows.tobytes(), rng)
    else:
        body = np.pad(rows, ((0, 0), (0, stride - rows.shape[1]))).tobytes()
    return struct.pack(">8I", 0x59A66A95, w, h, depth,
                       len(body) if length is None else length, file_type,
                       1 if pal else 0, len(pal)) + pal + body


def ico_dib(image: np.ndarray, bits: int, palette: Optional[np.ndarray] = None,
            mask: Optional[np.ndarray] = None) -> bytes:
    """An icon's DIB: a 40-byte BITMAPINFOHEADER whose height counts the
    XOR image and the AND mask, the palette, the XOR rows bottom-up, then
    the AND mask's rows (1 bit a pixel, padded to 32 bits; `mask` true
    transparent)."""
    img = np.asarray(image)
    h, w = img.shape[:2]
    bmp = encode_bmp(w, h, bits, bmp_pixels(img, bits)[::-1].tobytes(),
                     palette=palette)
    info = bytearray(bmp[14:])
    struct.pack_into("<i", info, 8, 2 * h)
    m = np.zeros((h, w), np.int64) if mask is None else np.asarray(mask)
    rows = _pack_rows(m.astype(np.int64), 1)
    rows = np.pad(rows, ((0, 0), (0, (-rows.shape[1]) % 4)))
    return bytes(info) + rows[::-1].tobytes()


def encode_ico(entries: Sequence[tuple], kind: int = 1) -> bytes:
    """An ICO (kind 1) or CUR (kind 2) file: entries (payload, width,
    height, bpp, colors): a DIB (ico_dib) or a PNG file, with its
    directory's width and height (256 written as 0), bit count and colour
    count (a CUR's hotspot in their place: 0, 0)."""
    pos = 6 + 16 * len(entries)
    head = struct.pack("<HHH", 0, kind, len(entries))
    table, data = b"", b""
    for payload, w, h, bpp, colors in entries:
        planes, bits = (1, bpp) if kind == 1 else (0, 0)
        table += struct.pack("<BBBBHHII", w % 256, h % 256, colors, 0, planes,
                             bits, len(payload), pos + len(data))
        data += payload
    return head + table + data


# ----------------------------------------------------- DDS, BLP and PSD

DDPF_ALPHAPIXELS, DDPF_FOURCC, DDPF_PALETTEINDEXED8 = 0x1, 0x4, 0x20
DDPF_RGB, DDPF_LUMINANCE = 0x40, 0x20000
# DXGI formats DdsImagePlugin reads
DXGI = {"BC1": 71, "BC1_TYPELESS": 70, "BC2": 74, "BC2_TYPELESS": 73,
        "BC3": 77, "BC3_TYPELESS": 76, "BC4": 80, "BC4_TYPELESS": 79,
        "BC5": 83, "BC5_TYPELESS": 82, "BC5S": 84, "BC6H": 95, "BC6HS": 96,
        "BC7": 98, "BC7_TYPELESS": 97, "BC7_SRGB": 99, "RGBA": 28,
        "RGBA_TYPELESS": 27, "RGBA_SRGB": 29}


def pack_bits(fields, size: int = 16) -> bytes:
    """(value, bits) fields packed LSB first into `size` bytes (a BC6H or
    BC7 block)."""
    v = n = 0
    for value, bits in fields:
        v |= (int(value) & ((1 << bits) - 1)) << n
        n += bits
    assert n <= 8 * size, n
    return v.to_bytes(size, "little")


def encode_dds(width: int, height: int, payload: bytes, *,
               fourcc: bytes = b"\0\0\0\0", dxgi: Optional[int] = None,
               pfflags: Optional[int] = None, bitcount: int = 0,
               masks=(0, 0, 0, 0), palette: bytes = b"",
               header_size: int = 124) -> bytes:
    """A DDS file: its 124-byte header (pixel format flags FOURCC where a
    fourcc or `dxgi` is given, else `pfflags`), a DX10 header where
    `dxgi` is given, a P image's 1024-byte palette, then `payload`."""
    if dxgi is not None:
        fourcc = b"DX10"
    if pfflags is None:
        pfflags = DDPF_FOURCC
    head = struct.pack("<4s7I", b"DDS ", header_size, 0x1007, height, width,
                       0, 0, 0) + bytes(44)
    head += struct.pack("<2I4sI4I", 32, pfflags, fourcc, bitcount, *masks)
    head += struct.pack("<5I", 0x1000, 0, 0, 0, 0)
    if dxgi is not None:
        head += struct.pack("<5I", dxgi, 3, 0, 1, 0)
    return head + palette + payload


def _blocks(pixels: np.ndarray) -> np.ndarray:
    """[h, w, c] -> [bh, bw, 16, c]: 4x4 blocks, the edges padded by
    repeating the last row and column."""
    h, w = pixels.shape[:2]
    ph, pw = -h % 4, -w % 4
    p = np.pad(pixels, ((0, ph), (0, pw), (0, 0)), mode="edge")
    bh, bw = p.shape[0] // 4, p.shape[1] // 4
    return p.reshape(bh, 4, bw, 4, -1).transpose(0, 2, 1, 3, 4).reshape(
        bh, bw, 16, -1)


def bc1_encode(rgb: np.ndarray) -> bytes:
    """BC1 blocks of an RGB image (numpy only): each block's darkest and
    brightest texels as its 565 endpoints (c0 > c1, four colours), each
    texel the nearest of the four."""
    blk = _blocks(rgb.astype(np.int32))
    luma = blk.sum(-1)
    hi = np.take_along_axis(blk, luma.argmax(-1)[..., None, None], 2)[:, :, 0]
    lo = np.take_along_axis(blk, luma.argmin(-1)[..., None, None], 2)[:, :, 0]

    def to565(c):
        return (c[..., 0] >> 3 << 11) | (c[..., 1] >> 2 << 5) | (c[..., 2] >> 3)

    c0, c1 = to565(hi), to565(lo)
    swap = c0 < c1
    c0, c1 = np.where(swap, c1, c0), np.where(swap, c0, c1)
    c1 = np.where(c0 == c1, np.maximum(c1 - 1, 0), c1)
    c0 = np.where(c0 == c1, c0 + 1, c0)

    def from565(v):
        r, g, b = (v >> 11) & 31, (v >> 5) & 63, v & 31
        return np.stack([(r << 3) | (r >> 2), (g << 2) | (g >> 4),
                         (b << 3) | (b >> 2)], -1)

    e0, e1 = from565(c0), from565(c1)
    pal = np.stack([e0, e1, (2 * e0 + e1) // 3, (e0 + 2 * e1) // 3], 2)
    dist = ((blk[:, :, :, None, :] - pal[:, :, None]) ** 2).sum(-1)
    idx = dist.argmin(-1).astype(np.uint32)
    lut = (idx << (2 * np.arange(16, dtype=np.uint32))).sum(-1, dtype=np.uint32)
    out = np.zeros(c0.shape + (8,), np.uint8)
    out[..., 0:2] = np.stack([c0 & 255, c0 >> 8], -1)
    out[..., 2:4] = np.stack([c1 & 255, c1 >> 8], -1)
    out[..., 4:8] = np.stack([(lut >> (8 * k)) & 255 for k in range(4)], -1)
    return out.tobytes()


def bc7_mode6_encode(rgba: np.ndarray) -> bytes:
    """BC7 mode-6 blocks of an RGBA image (numpy only): each block's
    per-channel minimum and maximum as its 7-bit endpoints (p-bits 0),
    each texel's 4-bit index its projection onto the segment."""
    blk = _blocks(rgba.astype(np.int64))
    lo, hi = blk.min(2) >> 1, blk.max(2) >> 1
    e0, e1 = (lo << 1) | (lo >> 6), (hi << 1) | (hi >> 6)
    d = (e1 - e0)[:, :, None]
    num = ((blk - e0[:, :, None]) * d).sum(-1)
    den = np.maximum((d * d).sum(-1), 1)
    idx = np.clip(np.rint(num * 15 / den), 0, 15).astype(np.int64)
    # the first texel's index has 3 bits: swap the endpoints where its
    # index is 8 or more
    flip = idx[:, :, 0] >= 8
    lo2 = np.where(flip[..., None], hi, lo)
    hi2 = np.where(flip[..., None], lo, hi)
    idx = np.where(flip[..., None], 15 - idx, idx)
    n = blk.shape[0] * blk.shape[1]
    fields = [(np.full(n, 1 << 6), 7)]
    for c in range(4):
        fields += [(lo2[..., c].ravel(), 7), (hi2[..., c].ravel(), 7)]
    fields += [(np.zeros(n), 2), (idx[..., 0].ravel(), 3)]
    fields += [(idx[..., t].ravel(), 4) for t in range(1, 16)]
    bits = np.concatenate([(np.asarray(v, np.int64)[:, None]
                            >> np.arange(k)) & 1 for v, k in fields], 1)
    assert bits.shape[1] == 128
    return np.packbits(bits.astype(np.uint8), axis=1,
                       bitorder="little").tobytes()


def dds_mask_pixels(pixels: np.ndarray, masks, bitcount: int) -> bytes:
    """Pixels [h, w, c] (8-bit samples) packed into `bitcount`-bit
    little-endian words under each channel's mask (its top bits)."""
    h, w, c = pixels.shape
    word = np.zeros((h, w), np.uint64)
    for k, m in enumerate(masks[:c]):
        if not m:
            continue
        shift = (m & -m).bit_length() - 1
        bits = (m >> shift).bit_length()
        v = pixels[..., k].astype(np.uint64) >> np.uint64(max(8 - bits, 0))
        word |= (v << np.uint64(shift)) & np.uint64(m)
    nbytes = bitcount // 8
    return word.astype("<u8").view(np.uint8).reshape(h, w, 8)[..., :nbytes] \
        .tobytes()


def encode_blp(width: int, height: int, *, version: int = 2,
               compression: int = 1, encoding: int = 1, alpha: int = 0,
               alpha_encoding: int = 0, offsets=(), lengths=(),
               palette: bytes = b"", body: bytes = b"",
               subtype: int = 0) -> bytes:
    """A BLP1 or BLP2 file: its header, the 16 mip offsets and lengths
    (`offsets`, `lengths`: the first ones, the rest 0), `palette` (256
    BGRA entries, or a BLP1 JPEG's header length and header), then
    `body`."""
    if version == 1:
        head = struct.pack("<4siI2Iii", b"BLP1", compression, alpha, width,
                           height, encoding, subtype)
    else:
        head = struct.pack("<4si4b2I", b"BLP2", compression, encoding, alpha,
                           alpha_encoding, 0, width, height)
    offs = list(offsets) + [0] * (16 - len(offsets))
    lens = list(lengths) + [0] * (16 - len(lengths))
    return head + struct.pack("<16I", *offs) + struct.pack("<16I", *lens) \
        + palette + body


def blp_palette_file(indices: np.ndarray, palette: np.ndarray, *,
                     version: int = 2, alpha: int = 0,
                     encoding: int = None) -> bytes:
    """A palette BLP of `indices` [h, w] under `palette` [256, 4] (RGBA,
    written BGRA)."""
    h, w = indices.shape
    pal = palette[:, [2, 1, 0, 3]].astype(np.uint8).tobytes()
    start = (28 if version == 1 else 20) + 128 + len(pal)
    return encode_blp(w, h, version=version, compression=1,
                      encoding=encoding or (4 if version == 1 else 1),
                      alpha=alpha, offsets=[start], lengths=[w * h],
                      palette=pal, body=indices.astype(np.uint8).tobytes())


def blp_jpeg_file(jpeg: bytes, width: int, height: int, *, split: int = 0,
                  gap: bytes = b"", alpha: int = 0) -> bytes:
    """A BLP1 JPEG: the first `split` bytes of `jpeg` as its shared
    header, `gap` after it, then the rest as the first mip."""
    header, rest = jpeg[:split], jpeg[split:]
    start = 28 + 128 + 4 + len(header) + len(gap)
    return encode_blp(width, height, version=1, compression=0, encoding=5,
                      alpha=alpha, offsets=[start], lengths=[len(rest)],
                      palette=struct.pack("<I", len(header)) + header + gap,
                      body=rest)


def blp_dxt_file(blocks: bytes, width: int, height: int, *,
                 alpha_encoding: int, alpha: int = 1) -> bytes:
    """A BLP2 DXT file (alpha encodings 0, 1 and 7: DXT1, DXT3, DXT5) of
    the given blocks, after a zero palette."""
    start = 20 + 128 + 1024
    return encode_blp(width, height, version=2, compression=1, encoding=2,
                      alpha=alpha, alpha_encoding=alpha_encoding,
                      offsets=[start], lengths=[len(blocks)],
                      palette=bytes(1024), body=blocks)


def packbits_row(row: bytes, rng=None) -> bytes:
    """A row in PackBits (runs of 3 or more, literals up to 128 bytes;
    `rng`: split runs and literals at random and put in no-op bytes)."""
    out = bytearray()
    i, n = 0, len(row)
    while i < n:
        j = i
        while j + 1 < n and row[j + 1] == row[i] and j - i < 127:
            j += 1
        run = j - i + 1
        if rng is not None and run > 1 and rng.rand() < 0.3:
            run = rng.randint(1, run + 1)
        if run >= 3 or (rng is not None and run == 2):
            out += bytes([257 - run, row[i]])
            i += run
            continue
        k = i
        while k < n and k - i < 128 and not (
                k + 2 < n and row[k] == row[k + 1] == row[k + 2]):
            k += 1
        k = max(k, i + 1)
        if rng is not None and k - i > 1 and rng.rand() < 0.3:
            k = i + rng.randint(1, k - i + 1)
        if rng is not None and rng.rand() < 0.05:
            out.append(0x80)
        out += bytes([k - i - 1]) + row[i:k]
        i = k
    return bytes(out)


PSD_MODES = {"1": (0, 1), "L": (1, 8), "P": (2, 8), "RGB": (3, 8),
             "CMYK": (4, 8), "multichannel": (7, 8), "duotone": (8, 8),
             "LAB": (9, 8), "gray": (0, 8)}


def encode_psd(planes: np.ndarray, mode: str = "RGB", *,
               compression: int = 0, palette: Optional[bytes] = None,
               resources=(), layers: bool = False, bits: int = None,
               psd_mode: int = None, rng=None) -> bytes:
    """A PSD file of `planes` [c, h, w] (uint8; mode "1": 0/1 bits) as
    Photoshop lays its merged image out: header, colour mode data (a P
    image's 768-byte palette), image resources ((id, name, data), ...),
    a layer section (one RGB layer of the planes, raw) where `layers`,
    then the compression word and each channel's plane, raw or PackBits
    (`rng`: packets split at random) after the byte-count table."""
    c, h, w = planes.shape
    pmode, pbits = PSD_MODES[mode]
    if psd_mode is not None:
        pmode = psd_mode
    if bits is not None:
        pbits = bits
    head = struct.pack(">4sH6xHIIHH", b"8BPS", 1, c, h, w, pbits, pmode)
    cmd = palette or b""
    head += struct.pack(">I", len(cmd)) + cmd
    res = bytearray()
    for rid, name, data in resources:
        res += b"8BIM" + struct.pack(">H", rid) + bytes([len(name)]) + name
        if not len(name) & 1:
            res += b"\0"
        res += struct.pack(">I", len(data)) + data
        if len(data) & 1:
            res += b"\0"
    head += struct.pack(">I", len(res)) + res
    if layers:
        n = min(c, 3)
        info = struct.pack(">h", 1) + struct.pack(">4iH", 0, 0, h, w, n)
        info += b"".join(struct.pack(">hI", k, 2 + h * w) for k in range(n))
        info += b"8BIMnorm" + bytes([255, 0, 0, 0])
        extra = struct.pack(">II", 0, 0) + bytes([5]) + b"layer" + b"\0\0"
        info += struct.pack(">I", len(extra)) + extra
        for k in range(n):
            info += struct.pack(">H", 0) + planes[k].tobytes()
        if len(info) & 1:
            info += b"\0"
        block = struct.pack(">I", len(info)) + info + struct.pack(">I", 0)
        head += struct.pack(">I", len(block)) + block
    else:
        head += struct.pack(">I", 0)
    rows = []
    for k in range(c):
        p = planes[k]
        if mode == "1":
            p = np.packbits(p.astype(bool), axis=1)
        rows.append([p[y].tobytes() for y in range(h)])
    if compression == 0:
        body = b"".join(r for ch in rows for r in ch)
        return head + struct.pack(">H", 0) + body
    packed = [[packbits_row(r, rng) for r in ch] for ch in rows]
    table = b"".join(struct.pack(">H", len(r)) for ch in packed for r in ch)
    return head + struct.pack(">H", compression) + table + b"".join(
        r for ch in packed for r in ch)


def bc3_encode(rgb: np.ndarray) -> bytes:
    """BC3/DXT5 blocks of an RGB image (numpy only): an opaque alpha block
    (a0 = a1 = 255, every index 0) before each bc1_encode colour block."""
    colour = np.frombuffer(bc1_encode(rgb), np.uint8).reshape(-1, 8)
    alpha = np.zeros_like(colour)
    alpha[:, :2] = 255
    return np.concatenate([alpha, colour], 1).tobytes()


def part2_markers(n: int, offsets=None, matrix=None, *,
                  offset_type: int = 1, matrix_type: int = 2,
                  reversible: bool = True) -> bytes:
    """A JPEG 2000 Part-2 multi-component transform as marker segments for
    a codestream's main header: MCT records (a decorrelation matrix of
    n x n elements, index 1; an offset array of n elements, index 2; each
    of an element type 0-3: int16, int32, float32, float64, big-endian),
    an array-based MCC collection of components 0..n-1 (index 1) naming
    them, and an MCO of that one stage."""
    fmt = {0: ">H", 1: ">i", 2: ">f", 3: ">d"}
    out = b""

    def mct(index, array_type, etype, values):
        body = struct.pack(">HHH", 0, index | (array_type << 8)
                           | (etype << 10), 0)
        body += b"".join(struct.pack(fmt[etype], int(v) & 0xFFFF if etype == 0
                                     else int(v) if etype == 1 else float(v))
                         for v in values)
        return b"\xff\x74" + struct.pack(">H", len(body) + 2) + body

    deco = off = 0
    if matrix is not None:
        out += mct(1, 1, matrix_type, np.asarray(matrix).ravel().tolist())
        deco = 1
    if offsets is not None:
        out += mct(2, 2, offset_type, list(offsets))
        off = 2
    comps = bytes(range(n)) if n <= 256 else b""
    body = struct.pack(">HBHHB", 0, 1, 0, 1, 1) + struct.pack(">H", n) \
        + comps + struct.pack(">H", n) + comps \
        + ((int(reversible) << 16) | (off << 8) | deco).to_bytes(3, "big")
    out += b"\xff\x75" + struct.pack(">H", len(body) + 2) + body
    out += b"\xff\x77\x00\x04\x01\x01"
    return out


def with_main_header_markers(codestream: bytes, segments: bytes) -> bytes:
    """A raw J2K codestream with marker segments put at the end of its main
    header (before its first SOT)."""
    at = 2
    while codestream[at:at + 2] != b"\xff\x90":
        at += 2 + struct.unpack(">H", codestream[at + 2:at + 4])[0]
    return codestream[:at] + segments + codestream[at:]


# ------------------------------------------- IM, SPIDER, FITS and the rest
# The last plugins Pillow decodes (numpy and the standard library alone,
# so that chip_smoke.py writes its scenes in these formats on the card).

def encode_im(image_type: str, width: int, height: int, data: bytes, *,
              lut: Optional[bytes] = None, lines: Sequence[str] = (),
              size: Optional[str] = None) -> bytes:
    """An IM file: its header ("Image type: <image_type> image", the
    size, `lines` more), padded with zeros to 511 bytes and a 0x1A, a Lut
    of 768 bytes (R, G, B planes) where given, then `data` (the rows
    bottom-up, as ImImagePlugin writes and reads them: im_rows)."""
    head = [f"Image type: {image_type} image",
            f"Image size (x*y): {size or f'{width}*{height}'}",
            *lines] + (["Lut: 1"] if lut is not None else [])
    text = "".join(f"{line}\r\n" for line in head).encode("latin-1")
    return (text.ljust(511, b"\0") + b"\x1a" + (lut or b"") + data)


def im_rows(samples: np.ndarray, layers: bool = False) -> bytes:
    """[H, W] or [H, W, C] samples as IM rows: bottom-up, each row's
    channels one after another where `layers` (RGB;L and the like), else
    interleaved."""
    rows = samples[::-1]
    if layers and rows.ndim == 3:
        rows = rows.transpose(0, 2, 1)
    return np.ascontiguousarray(rows).tobytes()


def pack_bits_msb(bits: np.ndarray, lsb_first: bool = False) -> np.ndarray:
    """[H, W] of 0/1 as rows of bytes, the first pixel in the high bit (or
    the low one)."""
    return np.packbits(bits.astype(np.uint8), axis=1,
                       bitorder="little" if lsb_first else "big")


def encode_spider(values: np.ndarray, big: bool = True,
                  stack: bool = False) -> bytes:
    """A SPIDER image of float32 [H, W] (big- or little-endian); `stack`:
    a stack header of one image before the image's own header."""
    h, w = values.shape
    lenbyt = w * 4
    labrec = 1024 // lenbyt + (1 if 1024 % lenbyt else 0)
    labbyt = labrec * lenbyt
    fmt = ">" if big else "<"

    def header(istack, maxim, imgnum):
        hdr = [0.0] * 27
        hdr[0], hdr[1], hdr[4] = 1.0, float(h), 1.0
        hdr[11], hdr[12] = float(w), float(labrec)
        hdr[21], hdr[22] = float(labbyt), float(lenbyt)
        hdr[23], hdr[25], hdr[26] = float(istack), float(maxim), float(imgnum)
        return struct.pack(f"{fmt}27f", *hdr).ljust(labbyt, b"\0")

    pixels = values.astype(f"{fmt}f4").tobytes()
    if stack:
        return header(2, 1, 0) + header(0, 0, 1) + pixels
    return header(0, 0, 0) + pixels


def fits_cards(cards: Sequence[str]) -> bytes:
    """FITS header cards (each padded to 80 bytes), END, padded to 2880."""
    text = b"".join(c.ljust(80).encode("latin-1") for c in (*cards, "END"))
    return text.ljust(-(-len(text) // 2880) * 2880, b" ")


def encode_fits(values: np.ndarray, bitpix: int, *, gzip_tiles: bool = False,
                cards: Sequence[str] = (), little: bool = False) -> bytes:
    """A FITS file of [H, W] values: BITPIX 8, 16, 32, -32 or -64
    (big-endian data, as FITS stores it; `little`: little-endian, the
    byte order of the raw modes Pillow's FITS reader reads the data in),
    or with `gzip_tiles` a BINTABLE of GZIP_1 compressed data (an empty
    primary HDU, the image's 4-byte big-endian values gzipped in the
    heap)."""
    h, w = values.shape
    dtype = {8: ">u1", 16: ">i2", 32: ">i4", -32: ">f4", -64: ">f8"}[bitpix]
    if little:
        dtype = "<" + dtype[1:]
    if not gzip_tiles:
        data = values.astype(dtype).tobytes()
        return (fits_cards(["SIMPLE  = T", f"BITPIX  = {bitpix}",
                            "NAXIS   = 2", f"NAXIS1  = {w}",
                            f"NAXIS2  = {h}", *cards])
                + data.ljust(-(-len(data) // 2880) * 2880, b"\0"))
    import gzip
    heap = gzip.compress(values.astype(">i4").tobytes(), mtime=0)
    table = struct.pack(">ii", len(heap), 0)
    body = table + heap
    return (fits_cards(["SIMPLE  = T", "BITPIX  = 8", "NAXIS   = 0"])
            + fits_cards(["XTENSION= 'BINTABLE'", "BITPIX  = 8",
                          "NAXIS   = 2", "NAXIS1  = 8", "NAXIS2  = 1",
                          "ZIMAGE  = T", "ZCMPTYPE= 'GZIP_1  '",
                          f"ZBITPIX = {bitpix}", "ZNAXIS  = 2",
                          f"ZNAXIS1 = {w}", f"ZNAXIS2 = {h}", *cards])
            + body.ljust(-(-len(body) // 2880) * 2880, b"\0"))


def encode_mcidas(samples: np.ndarray, size: int, *, prefix: int = 0,
                  bands: int = 1, offset: int = 256) -> bytes:
    """A McIdas area file of [H, W] samples of `size` bytes (1, 2 or 4,
    big-endian), each line after `prefix` bytes and followed by the
    samples of `bands` - 1 more bands (zeros)."""
    h, w = samples.shape
    words = [0] * 64
    words[1], words[8], words[9], words[10] = 4, h, w, size
    words[13], words[14], words[33] = bands, prefix, offset
    header = struct.pack(">64i", *words)
    dtype = {1: ">u1", 2: ">u2", 4: ">u4"}[size]
    line = np.zeros((h, prefix + w * size * bands), np.uint8)
    line[:, prefix:prefix + w * size] = np.frombuffer(
        samples.astype(dtype).tobytes(), np.uint8).reshape(h, w * size)
    return header.ljust(offset, b"\0") + line.tobytes()


def encode_imt(gray: np.ndarray, comment: bool = True) -> bytes:
    """An IM Tools file of an [H, W] uint8 image."""
    h, w = gray.shape
    head = (b"* a comment\n" if comment else b"") + \
        f"width {w}\nheight {h}\npixel n8\n".encode()
    return head + b"\x0c" + gray.astype(np.uint8).tobytes()


def encode_xvthumb(indices: np.ndarray) -> bytes:
    """An XV thumbnail of [H, W] indices into its 3-3-2 palette."""
    h, w = indices.shape
    return (b"P7 332\n#XVVERSION:Version 2.28\n#END_OF_COMMENTS\n"
            + f"{w} {h} 255\n".encode() + indices.astype(np.uint8).tobytes())


def encode_pixar(rgb: np.ndarray) -> bytes:
    """A PIXAR file of RGB uint8 [H, W, 3] (raw RGB at 1024)."""
    h, w = rgb.shape[:2]
    header = bytearray(1024)
    header[:4] = b"\x80\xe8\0\0"
    struct.pack_into("<HH", header, 416, h, w)
    struct.pack_into("<HH", header, 424, 14, 2)
    return bytes(header) + rgb.astype(np.uint8).tobytes()


def encode_gbr(pixels: np.ndarray, version: int = 2,
               comment: bytes = b"brush\0") -> bytes:
    """A GIMP brush of [H, W] gray or [H, W, 4] RGBA pixels, version 1 or
    2."""
    h, w = pixels.shape[:2]
    depth = 1 if pixels.ndim == 2 else 4
    fixed = 20 if version == 1 else 28
    head = struct.pack(">5I", fixed + len(comment), version, w, h, depth)
    if version == 2:
        head += b"GIMP" + struct.pack(">I", 25)
    return head + comment + pixels.astype(np.uint8).tobytes()


def encode_ftex(width: int, height: int, payload: bytes, fmt: int = 1,
                gap: bytes = b"") -> bytes:
    """An FTEX file: one format (0 DXT1 blocks, 1 raw RGB), its mipmap's
    `payload` after `gap`."""
    where = 32 + len(gap)
    return (b"FTEX" + struct.pack("<7i", 1, width, height, 1, 1, fmt, where)
            + gap + struct.pack("<i", len(payload)) + payload)


def encode_xbm(bits: np.ndarray, hotspot=None, upper: bool = False,
               per_line: int = 12) -> bytes:
    """An X11 bitmap of [H, W] 0/1 pixels (rows of bytes, the first pixel
    in the low bit)."""
    h, w = bits.shape
    rows = pack_bits_msb(bits, lsb_first=True).reshape(-1)
    text = f"#define im_width {w}\n#define im_height {h}\n"
    if hotspot:
        text += (f"#define im_x_hot {hotspot[0]}\n"
                 f"#define im_y_hot {hotspot[1]}\n")
    fmt = "0x{:02X}" if upper else "0x{:02x}"
    words = [fmt.format(b) for b in rows]
    body = ",\n".join(", ".join(words[i:i + per_line])
                      for i in range(0, len(words), per_line))
    return (text + "static char im_bits[] = {\n" + body + "\n};\n").encode()


def xpm_keys(n: int, bpp: int) -> List[bytes]:
    """n distinct keys of bpp printable characters (no quote)."""
    chars = [c for c in range(35, 127) if c != 92]
    keys = []
    for i in range(n):
        key = bytearray()
        for _ in range(bpp):
            key.append(chars[i % len(chars)])
            i //= len(chars)
        keys.append(bytes(key))
    return keys


def encode_xpm(indices: np.ndarray, colours: np.ndarray, bpp: int = 1, *,
               none: Optional[int] = None,
               pixels_comment: bool = True) -> bytes:
    """An XPM file of [H, W] indices into `colours` (uint8 [N, 3]; entry
    `none` written as None), keys of `bpp` characters."""
    h, w = indices.shape
    keys = xpm_keys(len(colours), bpp)
    out = [b"/* XPM */", b"static char *image[] = {",
           b"/* columns rows colors chars-per-pixel */",
           f'"{w} {h} {len(colours)} {bpp} ",'.encode()]
    for k, (key, rgb) in enumerate(zip(keys, colours)):
        value = b"None" if k == none else ("#%02x%02x%02x" % tuple(
            int(v) for v in rgb)).encode()
        out.append(b'"' + key + b" c " + value + b'",')
    if pixels_comment:
        out.append(b"/* pixels */")
    for y in range(h):
        out.append(b'"' + b"".join(keys[i] for i in indices[y]) + b'"'
                   + (b"," if y + 1 < h else b""))
    out.append(b"};")
    return b"\n".join(out) + b"\n"


def _msp_header(w: int, h: int, version: int) -> bytes:
    words = [0] * 16
    magic = b"DanM" if version == 1 else b"LinS"
    words[0], words[1] = struct.unpack("<HH", magic)
    words[2], words[3], words[4], words[5] = w, h, 1, 1
    words[6], words[7], words[8], words[9] = 1, 1, w, h
    check = 0
    for v in words:
        check ^= v
    words[12] = check
    return struct.pack("<16H", *words)


def encode_msp(bits: np.ndarray, version: int = 2, rng=None) -> bytes:
    """A Windows Paint file of [H, W] 0/1 pixels: version 1 raw rows, or
    version 2's row map and runs (runs of a byte where it repeats, else
    literals of up to 255 bytes; an all-white row left out of the map)."""
    h, w = bits.shape
    rows = pack_bits_msb(bits)
    if version == 1:
        return _msp_header(w, h, 1) + rows.tobytes()
    data = []
    for row in rows:
        if (row == 0xFF).all() and (rng is None or rng.randint(2)):
            data.append(b"")
            continue
        out, i = bytearray(), 0
        while i < len(row):
            j = i
            while j < len(row) and row[j] == row[i] and j - i < 255:
                j += 1
            if j - i >= 3:
                out += bytes((0, j - i, row[i]))
                i = j
                continue
            k = min(len(row), i + (rng.randint(1, 256) if rng else 255))
            out += bytes((k - i,)) + row[i:k].tobytes()
            i = k
        data.append(bytes(out))
    return (_msp_header(w, h, 2) + struct.pack(f"<{h}H", *map(len, data))
            + b"".join(data))


def fli_chunk(kind: int, body: bytes) -> bytes:
    """An FLI subchunk (its size counts its 6-byte header)."""
    if len(body) % 2:
        body += b"\0"
    return struct.pack("<IH", 6 + len(body), kind) + body


def fli_color(palette: np.ndarray, kind: int = 4,
              packets: Sequence[Tuple[int, int]] = ((0, 256),)) -> bytes:
    """A COLOR_256 (4) or COLOR_64 (11) chunk: packets of (skip, count) of
    the palette's entries (uint8 [256, 3])."""
    body = struct.pack("<H", len(packets))
    i = 0
    for skip, count in packets:
        i += skip
        body += bytes((skip, count & 255)) + palette[i:i + count].tobytes()
        i += count
    return fli_chunk(kind, body)


def fli_brun(indices: np.ndarray) -> bytes:
    """A BRUN chunk: each line's packets (runs of a repeated byte,
    literals of the rest)."""
    body = bytearray()
    for row in indices:
        line, i = bytearray(), 0
        packets = 0
        while i < len(row):
            j = i
            while j < len(row) and row[j] == row[i] and j - i < 127:
                j += 1
            if j - i >= 2:
                line += bytes((j - i, row[i]))
                i = j
            else:
                k = i
                while k < len(row) and k - i < 127 and (
                        k + 1 >= len(row) or row[k + 1] != row[k]):
                    k += 1
                k = max(k, i + 1)
                line += bytes(((256 - (k - i)) & 255,)) + row[i:k].tobytes()
                i = k
            packets += 1
        body += bytes((packets & 255,)) + line
    return fli_chunk(15, bytes(body))


def fli_lc(indices: np.ndarray, first: int = 0) -> bytes:
    """An LC (byte delta) chunk over a black frame: lines from `first`,
    each a packet of skipped zeros and literals or runs."""
    body = bytearray(struct.pack("<HH", first, len(indices) - first))
    for row in indices[first:]:
        packets, line, x = 0, bytearray(), 0
        while x < len(row):
            skip = 0
            while x < len(row) and row[x] == 0 and skip < 255:
                x += 1
                skip += 1
            if x >= len(row):
                break
            j = x
            while j < len(row) and row[j] == row[x] and j - x < 127:
                j += 1
            if j - x >= 3:
                line += bytes((skip, (256 - (j - x)) & 255, row[x]))
                x = j
            else:
                k = min(len(row), x + 127)
                line += bytes((skip, k - x)) + row[x:k].tobytes()
                x = k
            packets += 1
        body += bytes((packets,)) + line
    return fli_chunk(12, bytes(body))


def fli_ss2(indices: np.ndarray) -> bytes:
    """An SS2 (word delta) chunk over a black frame: every line its word
    packets (literal words or a repeated word); an odd width's last pixel
    through the flag word that stores it."""
    h, w = indices.shape
    body = bytearray(struct.pack("<H", h))
    even = w - w % 2
    for row in indices:
        line = bytearray()
        if w % 2:
            line += struct.pack("<H", 0x8000 | int(row[-1]))
        words = row[:even].reshape(-1, 2)
        packets, parts, x = 0, bytearray(), 0
        while x < len(words):
            j = x
            while (j < len(words) and (words[j] == words[x]).all()
                   and j - x < 127):
                j += 1
            if j - x >= 2:
                parts += bytes((0, (256 - (j - x)) & 255)) + words[x].tobytes()
                x = j
            else:
                k = min(len(words), x + 127)
                parts += bytes((0, k - x)) + words[x:k].tobytes()
                x = k
            packets += 1
        line += struct.pack("<H", packets) + parts
        body += line
    return fli_chunk(7, bytes(body))


def encode_fli(width: int, height: int, chunks: Sequence[bytes], *,
               magic: int = 0xAF12, prefix: bool = False,
               frames: int = 1) -> bytes:
    """An FLI (0xAF11) or FLC (0xAF12) file whose first frame holds
    `chunks`; `prefix`: an FLC prefix chunk (0xF100) before it."""
    frame_body = b"".join(chunks)
    frame = struct.pack("<IHH8x", 16 + len(frame_body), 0xF1FA,
                        len(chunks)) + frame_body
    pre = struct.pack("<IH10x", 16, 0xF100) if prefix else b""
    body = pre + frame
    header = bytearray(128)
    struct.pack_into("<IHHHHHHI", header, 0, 128 + len(body), magic, frames,
                     width, height, 8, 0, 5)
    return bytes(header) + body


def encode_pcd(y: np.ndarray, cb: np.ndarray, cr: np.ndarray,
               orientation: int = 0) -> bytes:
    """A Photo CD file of its 768x512 base image: Y [512, 768], Cb and Cr
    [256, 384] (PhotoYCC), the orientation byte's low bits."""
    head = bytearray(96 * 2048)
    head[2048:2052] = b"PCD_"
    head[2048 + 1538] = orientation & 3
    chunks = np.concatenate([y.reshape(256, 2 * 768), cb.reshape(256, 384),
                             cr.reshape(256, 384)], axis=1).astype(np.uint8)
    return bytes(head) + chunks.tobytes()


def rgb_to_photo_ycc(rgb: np.ndarray):
    """RGB uint8 [512, 768, 3] as PhotoYCC planes (encode_pcd's), the
    inverse of Pillow's YCC;P to within its rounding."""
    f = rgb.astype(np.float64)
    lum = 0.299 * f[..., 0] + 0.587 * f[..., 1] + 0.114 * f[..., 2]
    y = np.clip(np.round(lum / 1.3584), 0, 255)
    c1 = (f[..., 2] - lum) / 2.2179 + 156
    c2 = (f[..., 0] - lum) / 1.8215 + 137
    def half(c):
        return np.clip(np.round(c.reshape(256, 2, 384, 2).mean((1, 3))), 0,
                       255).astype(np.uint8)

    return y.astype(np.uint8), half(c1), half(c2)


def iptc_field(record: int, dataset: int, data: bytes,
               extended: int = 0) -> bytes:
    """An IPTC/NAA field; `extended`: its length in that many bytes after
    a 0x80 | n length byte."""
    if extended:
        return (bytes((0x1C, record, dataset, 0x80 | extended))
                + len(data).to_bytes(extended, "big") + data)
    return bytes((0x1C, record, dataset)) + struct.pack(">H", len(data)) + data


def encode_iptc(width: int, height: int, data: bytes, *, layers: int = 1,
                component: int = 0, compression: int = 1,
                band: Optional[int] = None, pieces: int = 1) -> bytes:
    """An IPTC/NAA file: the image fields, then its data (raw gray bytes,
    or a JPEG file for compression 5) in `pieces` (8, 10) fields."""
    out = (iptc_field(1, 90, b"\x1b%G") + iptc_field(2, 5, b"title")
           + iptc_field(3, 20, struct.pack(">H", width))
           + iptc_field(3, 30, struct.pack(">H", height))
           + iptc_field(3, 60, bytes((layers, component)))
           + iptc_field(3, 120, bytes((compression,))))
    if band is not None:
        out += iptc_field(3, 65, bytes((band + 1,)))
    step = -(-len(data) // pieces)
    for k in range(pieces):
        part = data[k * step:(k + 1) * step]
        out += iptc_field(8, 10, part, extended=4 if len(part) > 32767 else 0)
    return out


# the corpus's Photo CD files (tests/data/legacy_io: about 0.8 MB each, so
# made here from a seed, and only their digests committed): the base
# image's planes seeded once, under each orientation byte
PCD_SEED = 23


def pcd_cases() -> List[Tuple[str, bytes]]:
    rng = np.random.RandomState(PCD_SEED)
    yy, xx = np.mgrid[0:512, 0:768]
    y = np.clip((yy // 3 + xx // 5) % 200 + rng.randint(0, 40, (512, 768)),
                0, 255)
    cb = rng.randint(60, 250, (256, 384))
    cr = rng.randint(60, 230, (256, 384))
    return [(f"pcd_orientation{o}.pcd", encode_pcd(y, cb, cr, o))
            for o in range(4)]
