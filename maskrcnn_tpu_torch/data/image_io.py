"""Image files without Pillow: every format of Pillow's that the port
reads decodes to RGB uint8, and a PNG writer.

`read_image(f)` (a path, the file's bytes or a binary file object)
returns what `np.asarray(PIL.Image.open(f).convert("RGB"))` returns with
Pillow 12.1 over libjpeg-turbo 3.1, zlib, libwebp 1.6, libtiff 4.7,
OpenJPEG 2.5.4 and libavif 1.3 (dav1d, libyuv),
bit for bit, through the native decoders (`csrc/image_decode.cpp` for
PNG, JPEG, GIF, BMP (with the DIB frames of DIB, ICO and CUR files) and
TIFF, with TIFF's ZSTD, LZMA and CCITT codecs in `csrc/tiff_zstd.cpp`,
`tiff_xz.cpp` and `tiff_fax.cpp`; `csrc/image_plugins.cpp` for Netpbm,
TGA, QOI, PCX, DCX, SGI and Sun raster and ICNS's packed icons;
`csrc/jpeg2000_decode.cpp` for JPEG 2000; `csrc/bcn_decode.cpp` for
the pixels of DDS, BLP and PSD; `csrc/image_legacy.cpp` for IM, SPIDER,
FITS, MCIDAS, IMT, XVThumb, PIXAR, GBR, FTEX, XBM, XPM, MSP, FLI and
PCD; `csrc/webp_decode.cpp` for WebP; `csrc/avif_decode.cpp` with
`csrc/av1_decode.cpp` for AVIF;
built with g++ on first use and called through ctypes outside the GIL,
one call a decode after its size call: data/native_image.py). The format
is told as Pillow's `Image.open` tells it (`format_of`,
data/image_probe.py: its plugins in their order, their `_accept`
functions on the first 16 bytes, and the header checks of their `_open`
that pass a file on to the next plugin or end `Image.open`). It reads:

* PNG: grayscale (bit depths 1, 2, 4, 8, 16), RGB (8, 16), palette (1,
  2, 4, 8), grayscale + alpha and RGBA (8, 16); all five row filters;
  Adam7 interlacing. Alpha and tRNS are dropped and a palette looked up,
  as `convert("RGB")` does; 16-bit grayscale opens in Pillow as "I;16"
  and is clipped to 255, other 16-bit samples give their high byte.
  The image data is inflated by the decoder's own inflate (TIFF's
  Deflate) as Pillow's decoder drives zlib: it stops at the image's
  last byte, so a stream cut in its trailer, or damaged past the image's
  bytes, still decodes; the plain route uses the
  standard library's zlib.
* JPEG: baseline, extended sequential and progressive Huffman coding
  with 8-bit samples, restart intervals and byte stuffing; arithmetic
  coding, sequential and progressive, with DAC conditioning
  (`csrc/jpeg_arith.cpp`; a scan that crosses the end of the
  65,536-byte block of the file Pillow's decoder holds raises, as in
  Pillow); lossless frames at 8 bits, predictors 1-7, point transforms
  (`csrc/jpeg_lossless.cpp`); 1 component
  (grayscale), 3 (YCbCr, or RGB under an Adobe transform 0 or component
  ids R, G, B without JFIF, jdapimin.c's rule) or 4 (CMYK under Adobe
  transform 0 or no Adobe marker, YCCK under transform 2; Pillow's
  inverted "CMYK;I" samples and its cmyk2rgb); sampling factors 1 to 4
  with libjpeg-turbo's upsampler for each ratio (fancy h2v1, h1v2,
  h2v2, box replication elsewhere and for lossless frames); the block
  smoothing libjpeg-turbo gives a progressive file whose scans leave
  coefficients 1-9 incomplete; on corrupt data, what libjpeg-turbo
  makes of it (its SIMD IDCT's bits, its marker walk).
* WebP (RIFF "WEBP" with a "VP8 ", "VP8L" or "VP8X" chunk): lossy (VP8:
  segments, loop-filter deltas, 1 to 8 token partitions, the simple and
  normal loop filters, libwebp's fancy upsampler and YUV -> RGB) and
  lossless (VP8L: every transform, the colour cache, meta prefix codes),
  plain or extended; alpha (ALPH, or VP8L's) dropped, which Pillow's
  RGB never depends on, though a lossy frame's ALPH chunk is decoded as
  libwebp decodes it, so that a file whose alpha libwebp refuses is
  refused here too; an animation's first frame at its offset on the
  canvas cleared to black, as libwebp's WebPAnimDecoder gives it.
* GIF (GIF87a, GIF89a): the first frame, with the screen grown to hold
  it and filled outside it with the transparency index or 0; global or
  local colour table (a table of the grays 0, 1, 2, ... opens in Pillow
  as mode "L": the indices are the gray levels); interlaced rows; LZW
  through Pillow's own decoder (a full code table kept without a clear
  code); transparency dropped.
* BMP ("BM"): the 12-byte OS/2 header and the 40, 52, 56, 64, 108 and
  124-byte ones; 1, 4 and 8-bit palettes (black past a short one),
  16-bit (5-5-5, or 5-6-5 bit fields), 24-bit, 32-bit (BGRX and the
  bit-field layouts Pillow takes; alpha dropped); BI_RLE8 and BI_RLE4 as
  Pillow's RLE decoder reads them; rows bottom-up or top-down; 1- and
  4-bit pixels under a grayscale palette as Pillow misreads them (its
  "L" unpacker, a byte a pixel, or "1" for 2 colours; a "codec
  configuration error" where such a row outruns the stride).
* TIFF (II, MM, the byte-swapped magics Pillow takes, BigTIFF): the
  first image, as TiffImagePlugin opens it: Pillow's own reading of
  uncompressed strips and tiles, and libtiff's decoding of PackBits,
  LZW (its codes and the old LSB-first ones), Deflate (an inflate in
  the C++ source: one call decodes any number of strips), ZSTD (a
  libzstd-equivalent frame decoder in the source), LZMA (an .xz stream
  decoder: LZMA2, Delta and the BCJ filters x86, PowerPC, IA-64, ARM,
  ARM-Thumb, SPARC, ARM64 and RISC-V, every check), CCITT modified
  Huffman, RLEW,
  Group 3 1D and 2D and Group 4 (tif_fax3.c's decoder, damaged lines
  filled as libtiff fills them), ThunderScan (tif_thunder.c) and JPEG
  (strips or tiles each a stream, JPEGTables, YCbCr subsampling 1x1,
  2x1 and 2x2 converted to RGB as Pillow asks libtiff to, RGB,
  grayscale and CMYK components as they are); every other YCbCr
  (uncompressed read raw as Pillow reads it; else libtiff's RGBA
  interface, tif_getimage.c, as TiffDecode.c's _decodeAsRGBA drives it:
  packed subsampling 4x4, 4x2, 4x1, 2x2, 2x1, 1x2 and 1x1 or separate
  1x1 planes, tif_color.c's conversion from ReferenceBlackWhite and
  YCbCrCoefficients, a strip its codec fails on kept as the codec left
  it) and old-style JPEG (tif_ojpeg.c over libjpeg's raw data: the
  tables tags or JPEGInterchangeFormat, restart intervals a strip);
  predictors 2 and 3; strips or tiles (edge tiles cropped),
  contiguous or separate planes, FillOrder 2; bilevel, grayscale of 2
  to 16 bits (16-bit clipped to 255), 32-bit integer and float
  (truncated and clipped), palettes of 1 to 8 bits, LA, PA, RGB and
  RGBA of 8 and 16 bits (extra samples dropped; associated alpha
  un-premultiplied, as Pillow's "RGBa"), CMYK of 8 and 16 bits, LAB
  (Pillow's unpack, a* and b* signed, then its convert: LittleCMS 2.17's
  D50 Lab to sRGB transform as lcms evaluates 8-bit input, a 33³ CLUT
  under tetrahedral interpolation; the CLUT committed,
  data/lab_srgb_clut.zlib); the Orientation tag (2-8,
  or XMP's tiff:Orientation) applied as ImageOps.exif_transpose applies
  it, for TIFF only. A compressed image is decoded with the directory
  as libtiff's TIFFReadDirectory reads it (the first of a repeated tag,
  its types, counts and checks, StripByteCounts it estimates), beside
  Pillow's reading, which gives the mode. A path is read as Pillow reads a path: an
  uncompressed image in one strip or tile of a mode Pillow memory-maps
  (L, P, RGBA, CMYK, I;16) with Orientation 5-8 is the mapped view
  turned, not the image (Pillow's `ImageFile.load`), and a ValueError
  where the view's last row would run past the file's end (Pillow reads
  past its map); bytes and file objects as Pillow reads bytes.

* PPM, PGM, PBM and PFM (PpmImagePlugin): P1-P6 plain and raw, header
  tokens and comments as Pillow's reader takes them (Python's int() of
  each), maxval 1-65535 scaled as PpmDecoder and the plain decoder round
  them (16-bit grays open as mode "I" and are clipped to 255), "Pf"
  floats (truncated and clipped, rows bottom-up), and Pillow's own
  P0CMYK, PyP (no palette: black), PyRGBA and PyCMYK.
* TGA: the (type, depth) pairs of TgaImagePlugin's MODES (colour-mapped
  8-bit, bilevel, 8-bit and 16-bit LA grays, 15/16-, 24- and 32-bit
  colour) raw and RLE (TgaRleDecode.c: literal packets run across rows,
  a run past its row is an error), 16- and 24-bit colour maps at their
  first entry (a map on a gray image is looked up, as Pillow's palette
  makes it; 32-bit maps raise, as Pillow does), the ID field, the
  origin bits.
* QOI: every op of QoiDecoder (the index hash, runs), 3 or 4 channels.
* ICO and CUR: the entry IcoFile (the largest, then the lowest colour
  depth) or CurImagePlugin (the first, or a later one larger in both
  sides) picks: a PNG through the PNG decoder, a DIB through the BMP
  decoder with its height halved, its AND mask or alpha read as Pillow
  reads them; DIB files (Pillow's DIB plugin: a BMP without its file
  header).
* PCX and DCX (its first page): PcxDecode.c's RLE; 1-bit, 1-bit in 2 or
  4 planes (the header's palette), 8-bit gray or with a VGA palette, and
  RGB in three planes, rows padded as Pillow pads them.
* SGI: raw and RLE (SgiRleDecode.c, its bounds checks and short rows),
  1 or 2 bytes a sample (the high byte), 1, 3 or 4 channels.
* Sun raster: file types 0-5 (type 2 RLE, SunRleDecode.c), depths 1, 4,
  8, 24 and 32 in BGR or (type 3) RGB, colour maps on 4- and 8-bit
  images.
* JPEG 2000 (Jpeg2KImagePlugin: JP2 files, JPH files and raw J2K
  codestreams), as Pillow decodes them through OpenJPEG's tile API in
  strict mode: the JP2 boxes OpenJPEG reads (ihdr against SIZ, colr,
  pclr, cmap, cdef, bpcc, boxes past the codestream), the main and
  tile-part markers with OpenJPEG's checks (a cut stream raises), every
  progression order and POC change, precincts, tiles, tile-parts, image
  and tile offsets, quality layers, PPM and PPT, SOP and EPH, the
  code-block mode switches and RGN max-shift, HTJ2K code-blocks (Part
  15, code-block style 0x40: OpenJPEG 2.5.4's ht_dec.c, cleanup and
  refinement passes, its segment rules and its checks of malformed
  blocks; a CAP marker read as OpenJPEG reads it, not at all), the 5/3
  and 9/7 transforms (OpenJPEG's float operations in its order) with RCT
  and ICT, components of their own precision, sign and subsampling; then
  Pillow's side: the mode Jpeg2KImageFile._open gives (L or I;16 by
  precision, LA, RGB, RGBA, CMYK from colr, P and PA from pclr:
  data/image_probe.jpeg2000_header), its unpackers (their shifts and
  offsets, a subsampled component indexed by width / dx, its tile buffer
  kept from tile to tile), the colour space it assumes where colr gives
  none (sYCC where component 1 or 2 is subsampled and component 0 is
  not), its YCbCr -> RGB for sYCC, a pclr palette as
  ImagePalette.getcolor builds it, and the files it refuses (a mode and
  colour space with no unpacker); a CBD marker setting each component's
  depth and sign; Part-2 multi-component transforms as OpenJPEG 2.5.4
  reads them (opj_j2k_read_mct, _mcc, _mco: records of every element
  type, array-based collections, what it skips or fails on), whose MCO
  sets every DC level shift to 0 and then to its collection's offsets;
  COD's transform byte 2 fails, as in OpenJPEG, so no custom transform
  ever runs.

* ICNS (IcnsImagePlugin): the block walk, the size IcnsImageFile loads
  (the largest), every entry of that size read as Pillow reads it (so
  that one Pillow fails on fails here too): a PNG entry through the PNG
  decoder (read from the entry to the file's end), a JPEG 2000 entry
  through the JPEG 2000 decoder, packed RGB (is32, il32, ih32, it32
  after its 4 zero bytes; raw or Apple's RLE, read on past the entry as
  Pillow's file reads run on) with its mask checked; the image's size
  held to a whole scale of one of the file's sizes.
* DDS (DdsImagePlugin): the first surface of every route _open takes:
  BCn blocks as Pillow's C decoder reads them (BC1 of 4 or 3 colours and
  transparent black, BC2, BC3, BC4, BC5 unsigned and signed, BC6H
  unsigned and signed in its 14 modes, BC7 in its 8, partial edge
  blocks; FourCC DXT1/3/5, BC4U, ATI1, BC5U, ATI2, BC5S and the DX10
  DXGI formats), uncompressed RGB(A) under any masks as its Python
  DdsRgbDecoder scales them, L, LA, P under its RGBA palette and
  R8G8B8A8, the pixels starting where _open's reads left the file.
* BLP (BlpImagePlugin): BLP1 JPEG (the shared header and the first mip
  through the JPEG decoder, a CMYK frame's jpegmode "CMYK", the result
  read back as BGR rows of the BLP's width), BLP1 and BLP2 palettes of
  BGRA entries, BLP2 DXT1/3/5 through the plugin's own Python block
  decoders (their rows read back by the image's width).
* PSD (PsdImagePlugin): the merged image after the layer section, each
  channel a plane, raw or PackBits (Pillow's PackDecode.c), in the
  modes of its MODES table ("1", L, P under its 768-byte palette or
  black, RGB, RGBA, CMYK from "C;I" planes, LAB through LittleCMS's
  table, duotone and multichannel as L).
* The last plugins, each header as its `_open` reads it (data/
  image_probe.plugin_layout) and its pixels as its decoder reads them
  (Pillow's raw decoder and unpackers of every raw mode they name, then
  Convert.c's convert("RGB"): palettes black past their entries, CMYK
  through cmyk2rgb, YCbCr through ConvertYCbCr.c's tables, I and 16-bit
  modes clipped, F truncated through L): IM (every image type of
  ImImagePlugin.OPEN, rows bottom-up, RGB3 and RYB3 planes, "L*n"
  floats through BitDecode.c, a colour Lut making L and P images P and
  LA and PA ones PA); SPIDER (either byte order, a stack's first image);
  FITS (BITPIX 8, 16, 32, -32, -64 in Pillow's raw modes L, I;16, I, F,
  rows bottom-up; GZIP_1 tiles through Python's gzip.decompress over the
  decoder's own inflate); MCIDAS (L, I;16B, I;32B at the header's
  stride; from a path, the rows Pillow memory-maps); IMT (L), XVThumb (P
  under its 3-3-2 palette), PIXAR (RGB at 1024), GBR (versions 1 and 2,
  L or RGBA), FTEX (raw RGB, or BC1 through the DDS route); XBM
  (XbmDecode.c); XPM (its colour table of #rrggbb and None, keys of any
  length, P or, past 256 colours, RGB, as XpmDecoder reads its lines);
  MSP (version 1 raw, version 2 MspDecoder's runs and row map); FLI and
  FLC (the first frame through FliDecode.c: COLOR 4 and 11 for the
  palette, BLACK, BRUN, COPY, LC, SS2); PCD (the 768x512 base image
  through PcdDecode.c and PhotoYCC, turned by its orientation byte);
  IPTC (its image data behind a P5 header where raw, else a file of its
  own read by this reader, a band merged with black ones into RGB or
  CMYK as IptcImageFile.load merges it).

* AVIF (AvifImagePlugin over libavif 1.3 and dav1d): the primary item's
  AV1 key frame (an image sequence's primary item, its first frame) and
  its alpha item's, 8-bit, profiles 0-2 (4:0:0, 4:2:0, 4:2:2, 4:4:4),
  every intra tool of the AV1 specification (`csrc/av1_decode.cpp`:
  multiple tiles, palette, CFL, filter intra, directional modes with
  edge filter and upsampling, quantizer matrices, delta q and lf,
  segmentation, lossless WHT, deblocking, CDEF, Wiener and self-guided
  restoration), converted as avifImageYUVToRGB converts for Pillow
  (`csrc/avif_decode.cpp`: libyuv's fixed point and bilinear chroma for
  BT.601, BT.709 and BT.2020 in either range, libavif's float route for
  identity, YCgCo and the other matrices), premultiplied alpha undone
  as libyuv's ARGBUnattenuate does, the frame's top-left part where it
  is larger than the item's ispe. The container is read by
  data/image_probe.py's model of libavif's parse (`avif_layout`).
  Refused by name: 10- and 12-bit data, film grain, superres, IntraBC,
  grid items, a sequence of tracks without items, and an AV1 frame
  smaller than its item's ispe (libavif reads past dav1d's picture,
  memory the codec never wrote).

The contract: a file Pillow decodes decodes to Pillow's pixels, or
raises NotImplementedError naming the format or mode the port does not
read; a file Pillow fails on raises ValueError. Refused by name: RLE
pixels under a 2-colour grayscale BMP palette, old-style JPEG in tiles
or separate planes and of a lossless frame, an IPTC band held as TIFF,
AVIF's 10- and 12-bit data, film grain, superres, IntraBC and grids; a
file of a format Pillow reads that the port does not: EPS (Pillow reads
it through Ghostscript; the refusal names it). An AVIF is read only
where libavif 1.3's parse, which Image.open runs, takes it
(data/image_probe.py models it: the boxes, items, properties and their
checks, and the search for the AV1 sequence header of an item without
an nclx colour); one it fails is a ValueError (or no plugin's). BUFR, GRIB and HDF5 (Pillow's stubs), MPEG and WMF (no
handler off Windows) open in Pillow and fail at load: a ValueError
naming the format and Pillow's error. A ValueError where Pillow fails: a
file no plugin of `Image.open` takes (Pillow's UnidentifiedImageError:
JPEG frames of other than 8 bits or of 2 or 5 layers, which SOF passes
on), a header that ends `Image.open` (BMP's depth, bit-fields layout,
compression and palette checks), what libjpeg-turbo never decodes
(hierarchical and arithmetic-coded lossless frames, fractional sampling
factors, an interleaved MCU of more than 10 blocks), what Pillow's build
never decodes (RLE of more than 8-bit BMP pixels, TIFF's WebP
compression and its SGILog under any photometric Pillow opens), and a
TIFF layout Pillow or libtiff refuses, naming it.
tests/test_torch_image_probe.py holds the probe to Pillow's Image.open,
tests/test_torch_image_outcomes.py the contract on every refused file of
the corpus, tests/test_torch_image_tiff.py,
test_torch_image_tiff_rgba.py, test_torch_image_plugins.py,
test_torch_image_jpeg2000.py, test_torch_image_htj2k.py,
test_torch_image_dds.py, test_torch_image_blp_psd.py,
test_torch_image_legacy.py and test_torch_image_avif.py the decoders to
Pillow's decode on the CPU,
and chip_smoke.py's phase 9 to the corpus's Pillow digests on the card's
host.

`read_image(f, plain=True)` takes the plain Python decoders below
instead (`decode_png`, `decode_jpeg`): 8-bit non-interlaced PNG and
baseline JPEG with 1 or 3 components (YCbCr) and sampling factors 1 or
2, the rest refused (every other format with a NotImplementedError
naming it). They are the reference the native route is held
to on the card, where Pillow is absent; no caller on the main path uses
them. Their JPEG entropy decoding is plain Python over a table of
16-bit windows; everything after it (dequantize, un-zigzag, jidctint.c's
islow IDCT, jdsample.c's fancy upsampling, jdcolor.c's YCbCr -> RGB) is
integer numpy over all blocks at once.
"""

from __future__ import annotations

import os
import re
import struct
import zlib
from typing import BinaryIO, Union

import numpy as np

from maskrcnn_tpu_torch.data import image_probe, native_image
from maskrcnn_tpu_torch.data.native_image import (MAX_PIXELS,  # noqa: F401
                                                  PNG_SIGNATURE)
from maskrcnn_tpu_torch.data.native_image import check_size as _check_size

Source = Union[str, os.PathLike, bytes, bytearray, memoryview, BinaryIO]


def _read_bytes(source: Source) -> bytes:
    if isinstance(source, (bytes, bytearray, memoryview)):
        return bytes(source)
    if hasattr(source, "read"):
        return source.read()
    with open(source, "rb") as f:
        return f.read()


# the formats read, by Pillow's name: their native decoders
# (native_image.decode_<name>)
READ = ("BMP", "DIB", "GIF", "JPEG", "PPM", "PNG", "AVIF", "BLP", "CUR", "PCX",
        "DCX", "DDS", "FITS", "FLI", "FTEX", "GBR", "ICNS", "ICO", "IM",
        "IMT", "IPTC", "JPEG2000", "MCIDAS", "MSP", "PCD", "PIXAR", "PSD",
        "TIFF", "QOI", "SGI", "SPIDER", "SUN", "TGA", "WEBP", "XBM", "XPM",
        "XVThumb")
# the formats whose decoders take the path flag (Pillow reads a file it
# opens from a path otherwise than one it opens from bytes)
PATH_READS = ("TIFF", "PCX", "DCX", "MCIDAS")


def read_image(source: Source, plain: bool = False) -> np.ndarray:
    """An image file (a path, bytes or a binary file object) as RGB uint8
    [H, W, 3]: the pixels Pillow's `Image.open(f).convert("RGB")` gives,
    through the native decoders (a RuntimeError naming the compiler when
    one cannot be built). The format is told as Image.open tells it
    (`format_of`); a format Pillow reads that the port does not read
    raises NotImplementedError naming it, and a file no plugin of Pillow's
    takes raises ValueError (where Pillow raises UnidentifiedImageError,
    an OSError), as does one whose header ends Image.open with an error.
    `plain=True` takes the plain Python decoders (PNG and JPEG only; any
    other format read raises NotImplementedError naming it)."""
    data = _read_bytes(source)
    path = isinstance(source, (str, os.PathLike))
    name = format_of(data, path)
    if name is None:
        raise ValueError("cannot identify the image file: no plugin of "
                         "Pillow's Image.open takes it")
    if name in native_image.LOAD_ERRORS:
        raise ValueError(f"{name}: Pillow opens the file and fails to load "
                         f"it: {native_image.LOAD_ERRORS[name]}")
    if name == "EPS":
        raise NotImplementedError(
            "EPS: Pillow reads EPS only through Ghostscript (its gs "
            "program), and the port carries no PostScript interpreter")
    if name not in READ:
        raise NotImplementedError(
            f"{name}: a format Pillow's Image.open reads (its {name} "
            "plugin), which the port does not read")
    if plain:
        if name == "PNG":
            return decode_png(data)
        if name == "JPEG":
            return decode_jpeg(data)
        raise NotImplementedError(f"{name}: the plain route reads PNG and "
                                  "JPEG only")
    if name == "IPTC":
        return native_image.decode_iptc(data, read_image)
    decode = getattr(native_image, f"decode_{name.lower()}")
    return decode(data, path=path) if name in PATH_READS else decode(data)


def format_of(data: bytes, path: bool = False):
    """The format Pillow's `Image.open` gives the file (its name, as
    `Image.open(f).format`: "PNG", "JPEG", "WEBP", "PPM", "IM", ...), or
    None where it raises UnidentifiedImageError; a ValueError naming the
    plugin where a plugin's header check ends Image.open with an error.
    `path`: the file is opened from its path (image_probe.identify)."""
    return image_probe.identify(data, path)


# --------------------------------------------------------------------- PNG

def _paeth_row(cur: bytearray, prior: bytes, bpp: int) -> None:
    """Undo the Paeth filter of one row in place."""
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = prior[i]
        c = prior[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        if pa <= pb and pa <= pc:
            pred = a
        elif pb <= pc:
            pred = b
        else:
            pred = c
        cur[i] = (cur[i] + pred) & 255


def _average_row(cur: bytearray, prior: bytes, bpp: int) -> None:
    """Undo the Average filter of one row in place."""
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        cur[i] = (cur[i] + ((a + prior[i]) >> 1)) & 255


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """The PNG row filters undone: [height, stride] uint8."""
    if len(raw) < height * (stride + 1):
        raise ValueError("PNG: image data too short")
    rows = np.frombuffer(raw, np.uint8, height * (stride + 1)).reshape(
        height, stride + 1)
    out = np.empty((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        kind = int(rows[y, 0])
        cur = rows[y, 1:]
        if kind == 0:
            row = cur.copy()
        elif kind == 1:
            # a running sum mod 256 over the pixels, per byte of a pixel
            row = np.cumsum(cur.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif kind == 2:
            row = cur + prior
        elif kind in (3, 4):
            buf = bytearray(cur.tobytes())
            (_average_row if kind == 3 else _paeth_row)(
                buf, prior.tobytes(), bpp)
            row = np.frombuffer(bytes(buf), np.uint8)
        else:
            raise ValueError(f"PNG: unknown row filter {kind}")
        out[y] = row
        prior = out[y]
    return out


def decode_png(data: bytes) -> np.ndarray:
    """A PNG file's bytes -> RGB uint8 [H, W, 3] (the plain version)."""
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError("not a PNG file")
    pos = len(PNG_SIGNATURE)
    header = palette = None
    idat = []
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body[:13])
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG: no IHDR chunk")
    width, height, depth, color, _, _, interlace = header
    _check_size(width, height)
    if interlace:
        raise NotImplementedError("PNG: Adam7 interlaced images are not "
                                  "supported")
    if depth != 8:
        raise NotImplementedError(f"PNG: bit depth {depth} is not supported "
                                  "(8 only)")
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}.get(color)
    if channels is None:
        raise ValueError(f"PNG: unknown colour type {color}")
    pixels = _unfilter(zlib.decompress(b"".join(idat)), height,
                       width * channels, channels).reshape(
                           height, width, channels)
    if color == 3:
        if palette is None:
            raise ValueError("PNG: palette image without a PLTE chunk")
        # Pillow's palette holds 256 entries, black past the file's
        table = np.zeros((256, 3), np.uint8)
        table[:len(palette)] = palette[:256]
        return table[pixels[..., 0]]
    if color in (0, 4):
        return np.repeat(pixels[..., :1], 3, axis=2)
    return np.ascontiguousarray(pixels[..., :3])


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def encode_png(image: np.ndarray) -> bytes:
    """uint8 [H, W, 3] (RGB) or [H, W] (grayscale) -> PNG bytes: every row
    filter 0, the data through zlib.compress."""
    image = np.asarray(image)
    if image.dtype != np.uint8 or not (
            image.ndim == 2 or (image.ndim == 3 and image.shape[2] == 3)):
        raise ValueError("encode_png takes uint8 [H, W] or [H, W, 3], not "
                         f"{image.dtype} {image.shape}")
    height, width = image.shape[:2]
    rows = image.reshape(height, -1)
    raw = np.zeros((height, rows.shape[1] + 1), np.uint8)
    raw[:, 1:] = rows
    header = struct.pack(">IIBBBBB", width, height, 8,
                         0 if image.ndim == 2 else 2, 0, 0, 0)
    return (PNG_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes()))
            + _chunk(b"IEND", b""))


def write_png(target: Union[str, os.PathLike, BinaryIO],
              image: np.ndarray) -> None:
    """Write `image` (see encode_png) as a PNG file to a path or a binary
    file object."""
    data = encode_png(image)
    if hasattr(target, "write"):
        target.write(data)
        return
    with open(target, "wb") as f:
        f.write(data)


# -------------------------------------------------------------------- JPEG

# the zigzag position k's coefficient in natural (row-major) order
NATURAL_ORDER = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

_SOF_MODES = {
    0xC2: "progressive", 0xC3: "lossless", 0xC5: "hierarchical sequential",
    0xC6: "hierarchical progressive", 0xC7: "hierarchical lossless",
    0xC9: "arithmetic-coded sequential", 0xCA: "arithmetic-coded progressive",
    0xCB: "arithmetic-coded lossless", 0xCD: "arithmetic-coded hierarchical",
    0xCE: "arithmetic-coded hierarchical", 0xCF: "arithmetic-coded "
    "hierarchical"}

# a marker in the entropy-coded data: 0xFF neither stuffed (0x00) nor a
# restart (0xD0-0xD7)
_MARKER = re.compile(rb"\xff[^\x00\xd0-\xd7]")
_RESTART = re.compile(rb"\xff[\xd0-\xd7]")


def _huffman_lut(counts, symbols) -> list:
    """A table over 16-bit windows: symbol << 5 | code length, 0 where no
    code starts the window."""
    lut = np.zeros(1 << 16, np.int64)
    code = k = 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            span = 1 << (16 - length)
            lut[code * span:(code + 1) * span] = symbols[k] << 5 | length
            code += 1
            k += 1
        code <<= 1
    return lut.tolist()


def _windows(segment: bytes) -> list:
    """The 16 bits starting at each bit position of the segment (stuffing
    removed; zeros past its end), as a list."""
    buf = np.frombuffer(segment + b"\x00\x00\x00\x00", np.uint8).astype(
        np.int64)
    word = (buf[:-3] << 24) | (buf[1:-2] << 16) | (buf[2:-1] << 8) | buf[3:]
    pos = np.arange(8 * len(segment), dtype=np.int64)
    return ((word[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF).tolist()


def _decode_segment(segment: bytes, mcus: int, layout: list, offsets: list,
                    first: int, idx: list, val: list) -> None:
    """Entropy-decode `mcus` MCUs of one restart interval. layout: one
    (predictor slot, DC table, AC table) a block of an MCU; offsets: the
    coefficient-array block of every block in scan order, from `first`.
    Appends the flat index and value of every nonzero coefficient (the DC
    always) to idx and val, in zigzag order within a block."""
    win = _windows(segment)
    preds = [0] * (1 + max(slot for slot, _, _ in layout))
    pos = 0
    b = first
    append_i, append_v = idx.append, val.append
    try:
        for _ in range(mcus):
            for slot, dc, ac in layout:
                base = offsets[b] * 64
                b += 1
                e = dc[win[pos]]
                if not e:
                    raise ValueError("JPEG: bad Huffman code")
                pos += e & 31
                s = e >> 5
                if s:
                    v = win[pos] >> (16 - s)
                    pos += s
                    if v < 1 << (s - 1):
                        v -= (1 << s) - 1
                    preds[slot] += v
                append_i(base)
                append_v(preds[slot])
                k = 1
                while k < 64:
                    e = ac[win[pos]]
                    if not e:
                        raise ValueError("JPEG: bad Huffman code")
                    pos += e & 31
                    rs = e >> 5
                    s = rs & 15
                    if s:
                        k += rs >> 4
                        v = win[pos] >> (16 - s)
                        pos += s
                        if v < 1 << (s - 1):
                            v -= (1 << s) - 1
                        if k < 64:
                            append_i(base + k)
                            append_v(v)
                        k += 1
                    elif rs == 0xF0:
                        k += 16
                    else:
                        break
    except IndexError:
        raise ValueError("JPEG: entropy-coded data ends early") from None


# jidctint.c's constants: FIX(x) at CONST_BITS 13
_CONST_BITS, _PASS1_BITS = 13, 2
_F0298, _F0390, _F0541, _F0765 = 2446, 3196, 4433, 6270
_F0899, _F1175, _F1501, _F1847 = 7373, 9633, 12299, 15137
_F1961, _F2053, _F2562, _F3072 = 16069, 16819, 20995, 25172


def _idct_1d(x):
    """jidctint.c's 8-point islow butterfly on x[0..7] (int64 arrays):
    the eight outputs, before the descale."""
    z1 = (x[2] + x[6]) * _F0541
    tmp2 = z1 - x[6] * _F1847
    tmp3 = z1 + x[2] * _F0765
    tmp0 = (x[0] + x[4]) << _CONST_BITS
    tmp1 = (x[0] - x[4]) << _CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = x[7], x[5], x[3], x[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * _F1175
    t0, t1, t2, t3 = t0 * _F0298, t1 * _F2053, t2 * _F3072, t3 * _F1501
    z1, z2 = z1 * -_F0899, z2 * -_F2562
    z3, z4 = z3 * -_F1961 + z5, z4 * -_F0390 + z5
    t0 += z1 + z3
    t1 += z2 + z4
    t2 += z2 + z3
    t3 += z1 + z4
    return (tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
            tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)


def _range_limit_table() -> np.ndarray:
    """jdmaster.c's post-IDCT range-limit table, indexed by the descaled
    value & 1023: x + 128 clamped to 0..255 for x in [-512, 511]."""
    x = np.arange(1024)
    x = np.where(x >= 512, x - 1024, x)
    return np.clip(x + 128, 0, 255).astype(np.uint8)


_RANGE_LIMIT = _range_limit_table()


def _descale(x, n):
    return (x + (1 << (n - 1))) >> n


def idct_islow(coef: np.ndarray) -> np.ndarray:
    """Dequantized coefficients [N, 8, 8] (natural order, row = vertical
    frequency) -> samples [N, 8, 8] uint8, as jpeg_idct_islow."""
    c = coef.astype(np.int64)
    # pass 1: the columns, into the workspace
    ws = np.stack(_idct_1d([c[:, k, :] for k in range(8)]), axis=1)
    ws = _descale(ws, _CONST_BITS - _PASS1_BITS)
    # pass 2: the rows
    out = np.stack(_idct_1d([ws[:, :, k] for k in range(8)]), axis=2)
    out = _descale(out, _CONST_BITS + _PASS1_BITS + 3)
    return _RANGE_LIMIT[out & 1023]


def _rows_around(p: np.ndarray):
    """The row above and below each row, the edge rows replicated."""
    above = np.concatenate([p[:1], p[:-1]], axis=0)
    below = np.concatenate([p[1:], p[-1:]], axis=0)
    return above, below


def _cols_around(p: np.ndarray):
    left = np.concatenate([p[:, :1], p[:, :-1]], axis=1)
    right = np.concatenate([p[:, 1:], p[:, -1:]], axis=1)
    return left, right


def _interleave(a: np.ndarray, b: np.ndarray, axis: int) -> np.ndarray:
    return np.stack([a, b], axis=axis + 1).reshape(
        *a.shape[:axis], 2 * a.shape[axis], *a.shape[axis + 1:])


def upsample(plane: np.ndarray, h_factor: int, v_factor: int) -> np.ndarray:
    """A component's downsampled plane [h, w] (uint8) upsampled by
    integer factors as jdsample.c does with fancy upsampling on: the
    triangle filters of h2v1, h1v2 and h2v2 (h2v1 and h2v2 only when w > 2),
    else pixel replication."""
    if (h_factor, v_factor) == (1, 1):
        return plane
    p = plane.astype(np.int32)
    w = p.shape[1]
    if (h_factor, v_factor) == (1, 2):
        above, below = _rows_around(p)
        return _interleave((3 * p + above + 1) >> 2,
                           (3 * p + below + 2) >> 2, 0).astype(np.uint8)
    if (h_factor, v_factor) == (2, 1) and w > 2:
        left, right = _cols_around(p)
        return _interleave((3 * p + left + 1) >> 2,
                           (3 * p + right + 2) >> 2, 1).astype(np.uint8)
    if (h_factor, v_factor) == (2, 2) and w > 2:
        above, below = _rows_around(p)
        out = []
        for colsum in (3 * p + above, 3 * p + below):
            left, right = _cols_around(colsum)
            out.append(_interleave((3 * colsum + left + 8) >> 4,
                                   (3 * colsum + right + 7) >> 4, 1))
        return _interleave(out[0], out[1], 0).astype(np.uint8)
    return np.repeat(np.repeat(plane, v_factor, axis=0), h_factor, axis=1)


def _ycc_tables():
    """jdcolor.c's YCbCr -> RGB tables (SCALEBITS 16)."""
    one_half = 1 << 15
    x = np.arange(256, dtype=np.int64) - 128

    def fix(v):
        return int(v * (1 << 16) + 0.5)

    cr_r = (fix(1.40200) * x + one_half) >> 16
    cb_b = (fix(1.77200) * x + one_half) >> 16
    cr_g = -fix(0.71414) * x
    cb_g = -fix(0.34414) * x + one_half
    return cr_r, cb_b, cr_g, cb_g


_CR_R, _CB_B, _CR_G, _CB_G = _ycc_tables()
# range_limit[] of jdcolor.c: x + 512 -> x clamped to 0..255
_CLAMP = np.clip(np.arange(1280) - 512, 0, 255).astype(np.uint8)


def ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """uint8 planes -> RGB uint8 [H, W, 3] (ycc_rgb_convert)."""
    out = np.empty(y.shape + (3,), np.uint8)
    yy = y.astype(np.int32)
    for i, chroma in enumerate((_CR_R[cr], (_CB_G[cb] + _CR_G[cr]) >> 16,
                                _CB_B[cb])):
        out[..., i] = _CLAMP[yy + chroma.astype(np.int32) + 512]
    return out


class _Frame:
    """The parsed frame: size, components and the tables in force."""

    def __init__(self, body: bytes, marker: int):
        precision, self.height, self.width, n = struct.unpack(
            ">BHHB", body[:6])
        _check_size(self.width, self.height)
        if precision != 8:
            raise NotImplementedError(f"JPEG: {precision}-bit samples are not "
                                      "supported (8-bit only)")
        if n == 4:
            raise NotImplementedError("JPEG: CMYK (4-component) images are "
                                      "not supported")
        if n not in (1, 3):
            raise NotImplementedError(f"JPEG: {n} components are not "
                                      "supported (1 or 3)")
        self.ids, self.h, self.v, self.tq = [], [], [], []
        for i in range(n):
            cid, hv, tq = body[6 + 3 * i:9 + 3 * i]
            self.ids.append(cid)
            self.h.append(hv >> 4)
            self.v.append(hv & 15)
            self.tq.append(tq)
        if any(f not in (1, 2) for f in self.h + self.v):
            raise NotImplementedError("JPEG: sampling factors other than 1 "
                                      "and 2 are not supported")
        self.hmax, self.vmax = max(self.h), max(self.v)
        self.mcux = -(-self.width // (8 * self.hmax))
        self.mcuy = -(-self.height // (8 * self.vmax))
        # each component's coefficient blocks: the interleaved MCU grid
        self.bw = [self.mcux * h for h in self.h]
        self.bh = [self.mcuy * v for v in self.v]
        self.base = np.cumsum([0] + [w * h for w, h in
                                     zip(self.bw, self.bh)]).tolist()
        self.quant = [None] * n

    def comp_size(self, c: int):
        """(rows, columns) of component c's downsampled plane."""
        return (-(-self.height * self.v[c] // self.vmax),
                -(-self.width * self.h[c] // self.hmax))


def _scan_blocks(frame: _Frame, comps, dc_luts, ac_luts):
    """(layout, block offsets in scan order, MCU count) of a scan."""
    if len(comps) == 1:
        c = comps[0]
        rows, cols = frame.comp_size(c)
        by, bx = -(-rows // 8), -(-cols // 8)
        grid = (np.arange(by)[:, None] * frame.bw[c]
                + np.arange(bx)[None, :])
        layout = [(0, dc_luts[0], ac_luts[0])]
        return layout, (frame.base[c] + grid.reshape(-1)).tolist(), by * bx
    layout, per_mcu = [], []
    for slot, c in enumerate(comps):
        for v in range(frame.v[c]):
            for h in range(frame.h[c]):
                layout.append((slot, dc_luts[slot], ac_luts[slot]))
                per_mcu.append((c, v, h))
    my, mx = np.meshgrid(np.arange(frame.mcuy), np.arange(frame.mcux),
                         indexing="ij")
    my, mx = my.reshape(-1, 1), mx.reshape(-1, 1)
    cols = [frame.base[c] + (my * frame.v[c] + v) * frame.bw[c]
            + mx * frame.h[c] + h for c, v, h in per_mcu]
    offsets = np.concatenate(cols, axis=1).reshape(-1)
    return layout, offsets.tolist(), frame.mcux * frame.mcuy


def decode_jpeg(data: bytes) -> np.ndarray:
    """A baseline JPEG file's bytes -> RGB uint8 [H, W, 3] (the plain
    version)."""
    if not data.startswith(b"\xff\xd8"):
        raise ValueError("not a JPEG file")
    pos = 2
    frame = None
    qtables, dc_tables, ac_tables = {}, {}, {}
    restart = 0
    jfif = adobe = False
    transform = None
    idx, val = [], []
    while True:
        if pos + 2 > len(data):
            raise ValueError("JPEG: no EOI marker")
        if data[pos] != 0xFF:
            raise ValueError(f"JPEG: marker expected at byte {pos}")
        marker = data[pos + 1]
        if marker == 0xFF:                       # fill byte
            pos += 1
            continue
        if marker == 0xD9:                       # EOI
            break
        if 0xD0 <= marker <= 0xD8 or marker == 0x01:
            pos += 2
            continue
        length = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        body = data[pos + 4:pos + 2 + length]
        pos += 2 + length
        if marker in (0xC0, 0xC1):
            frame = _Frame(body, marker)
        elif marker in _SOF_MODES:
            raise NotImplementedError(f"JPEG: {_SOF_MODES[marker]} mode is "
                                      "not supported (baseline and extended "
                                      "sequential Huffman only)")
        elif marker == 0xC4:
            i = 0
            while i < len(body):
                tc, th = body[i] >> 4, body[i] & 15
                counts = body[i + 1:i + 17]
                n = sum(counts)
                lut = _huffman_lut(counts, list(body[i + 17:i + 17 + n]))
                (dc_tables if tc == 0 else ac_tables)[th] = lut
                i += 17 + n
        elif marker == 0xDB:
            i = 0
            while i < len(body):
                pq, tq = body[i] >> 4, body[i] & 15
                if pq:
                    q = np.frombuffer(body[i + 1:i + 129], ">u2")
                    i += 129
                else:
                    q = np.frombuffer(body[i + 1:i + 65], np.uint8)
                    i += 65
                qtables[tq] = q.astype(np.int32)
        elif marker == 0xDD:
            restart = struct.unpack(">H", body[:2])[0]
        elif marker == 0xE0 and body.startswith(b"JFIF\x00"):
            jfif = True
        elif marker == 0xEE and body.startswith(b"Adobe") and len(body) >= 12:
            adobe, transform = True, body[11]
        elif marker == 0xDA:
            if frame is None:
                raise ValueError("JPEG: scan before the frame header")
            ns = body[0]
            comps, dcl, acl = [], [], []
            for k in range(ns):
                cid, t = body[1 + 2 * k:3 + 2 * k]
                c = frame.ids.index(cid)
                comps.append(c)
                dcl.append(dc_tables[t >> 4])
                acl.append(ac_tables[t & 15])
                if frame.quant[c] is None:
                    frame.quant[c] = qtables[frame.tq[c]]
            end = _MARKER.search(data, pos)
            if end is None:
                raise ValueError("JPEG: entropy-coded data without an end")
            layout, offsets, mcus = _scan_blocks(frame, comps, dcl, acl)
            segments = _RESTART.split(data[pos:end.start()])
            per = restart or mcus
            done = 0
            for seg in segments:
                n = min(per, mcus - done)
                if n <= 0:
                    break
                _decode_segment(seg.replace(b"\xff\x00", b"\xff"), n, layout,
                                offsets, done * len(layout), idx, val)
                done += n
            pos = end.start()
    if frame is None:
        raise ValueError("JPEG: no frame header")
    n = len(frame.ids)
    if n == 3:
        if adobe and transform != 1:
            raise NotImplementedError(
                f"JPEG: Adobe transform {transform} (RGB-coded) is not "
                "supported (YCbCr only)")
        if not jfif and not adobe and frame.ids == [82, 71, 66]:
            raise NotImplementedError("JPEG: RGB-coded images are not "
                                      "supported (YCbCr only)")
    coef = np.zeros(frame.base[-1] * 64, np.int32)
    coef[np.asarray(idx, np.int64)] = val
    coef = coef.reshape(-1, 64)
    planes = []
    for c in range(n):
        q = frame.quant[c]
        if q is None:                            # in no scan
            q = qtables.get(frame.tq[c], np.ones(64, np.int32))
        zz = coef[frame.base[c]:frame.base[c + 1]] * q[None, :]
        nat = np.empty_like(zz)
        nat[:, NATURAL_ORDER] = zz
        samples = idct_islow(nat.reshape(-1, 8, 8))
        bh, bw = frame.bh[c], frame.bw[c]
        plane = samples.reshape(bh, bw, 8, 8).transpose(0, 2, 1, 3).reshape(
            bh * 8, bw * 8)
        rows, cols = frame.comp_size(c)
        plane = upsample(plane[:rows, :cols], frame.hmax // frame.h[c],
                         frame.vmax // frame.v[c])
        planes.append(plane[:frame.height, :frame.width])
    if n == 1:
        return np.repeat(planes[0][..., None], 3, axis=2)
    return ycc_to_rgb(*planes)
