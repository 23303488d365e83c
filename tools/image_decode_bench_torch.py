#!/usr/bin/env python3
"""Host image decode of the PyTorch/CUDA port, timed: the native decoder
(`read_image`, csrc/image_decode.cpp and csrc/webp_decode.cpp) beside
the plain Python route (`read_image(..., plain=True)`, JPEG and PNG
only), over repository JPEG files and the first corpus scene (640x480)
as PNG, lossy WebP (q80), lossless WebP, GIF, BMP and TIFF (uncompressed, LZW
with predictor 2, tiled Deflate with predictor 2, its JPEG stream as
a YCbCr 2x2 JPEG TIFF, ZSTD and LZMA with predictor 2, and its bilevel
as CCITT Group 4, as arithmetic-coded, lossless (predictors 1 and 7)
and block-smoothed JPEG, as irreversible JP2, as AVIF at Pillow's defaults and at speed 0
(committed, tests/data/avif_scenes, csrc/av1_decode.cpp), with the three scenes
each in its layout as reversible JPEG 2000 (committed,
tests/data/jpeg2000_scenes, csrc/jpeg2000_decode.cpp) and as lossless
HTJ2K (committed, tests/data/htj2k_scenes, csrc/jpeg2000_ht.cpp): HT
against Part-1 on the same pixels in one run; the PNG written
here from the JPEG scene's decode
by `image_io.encode_png`, the GIF, BMP, Group 4 and other TIFF ones by
tests/image_writers.py, numpy and the standard library only, the ZSTD
and LZMA ones committed, tests/data/tiff_scenes, since Pillow's writer
makes them, as are the JPEG modes, tests/data/jpeg_scenes); the PNG
scene's image data inflated by the decoder's own inflate (PNG's and
TIFF's) beside zlib.decompress; decodes a second of the committed corpus's two baseline
640x480 JPEG scenes (tests/data/image_io) on 1 and 4 threads, each
route, of its three scenes as lossy WebP and as tiled Deflate TIFF
and of the first scene as AVIF at Pillow's defaults and at speed 0
natively, which shows whether a decode leaves the GIL; and
`data/pipeline.BatchLoader` images a second with 1 and 4 worker threads
over a COCO directory of the corpus's three scenes (a whole training
sample: decode, resample, masks).

    python3 tools/image_decode_bench_torch.py [--reps 5] [--copies 8]
                                              [--json-out F]
    python3 tools/image_decode_bench_torch.py --jpeg-ab ROOT [ROOT ...]
                                              [--rounds 6] [--json-out F]

`--jpeg-ab` times only the native decode of the Huffman JPEG files of
AB_FILES, for the port in each ROOT (a checkout or `git archive` copy:
its package, its library built from its own csrc/), each in a process
of its own, the roots taking turns in every round: a comparison of two
versions of the decoder within one run.

Times are host milliseconds, median of `--reps` decodes of the file's
bytes (Pillow's, where it is installed: `python tests/image_corpus.py
--time-pillow`). chip_smoke.py's phase 9a runs the same functions on the
card's host.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import statistics
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

REPO = Path(__file__).resolve().parent.parent
CORPUS = REPO / "tests" / "data" / "image_io"
# the first scene as ZSTD and LZMA TIFF with predictor 2 (Pillow's writer;
# tests/image_corpus.tiff_scene_cases)
TIFF_SCENES = REPO / "tests" / "data" / "tiff_scenes"
COMMITTED_TIFF = {"tiff_zstd_predictor": "scene_baseline_420_zstd_predictor.tif",
                  "tiff_lzma_predictor": "scene_baseline_420_lzma_predictor.tif"}
# the scenes as arithmetic-coded JPEG (their coefficients re-coded), the
# first scene's decode as lossless JPEG and the first scene re-coded
# progressive without its last two scans (block-smoothed), by Pillow's
# libjpeg-turbo (tests/image_corpus.jpeg_scene_cases)
JPEG_SCENES = REPO / "tests" / "data" / "jpeg_scenes"
COMMITTED_JPEG = {"jpeg_arith": "scene_baseline_420_arith.jpg",
                  "jpeg_arith_progressive":
                      "scene_baseline_420_arith_progressive.jpg",
                  "jpeg_lossless_p1": "scene_baseline_420_lossless_p1.jpg",
                  "jpeg_lossless_p7": "scene_baseline_420_lossless_p7.jpg",
                  "jpeg_smoothed": "scene_baseline_420_smoothed.jpg"}
# the scenes as JPEG 2000 (tests/image_corpus.jpeg2000_scene_cases): each
# scene's JPEG decode, reversible, in a layout of its own (the first
# Pillow's default JP2, the second a raw J2K with tiles and precincts in
# RPCL order, the third a JP2 of quality layers with PLT), and the first
# scene's decode as an irreversible JP2 (timed only)
JPEG2000_SCENES = REPO / "tests" / "data" / "jpeg2000_scenes"
# DDS, BLP and PSD files of every route (tests/image_corpus.texture_cases),
# their digests in an index of their own
TEXTURES = REPO / "tests" / "data" / "texture_io"
# the last plugins' files (tests/image_corpus.legacy_cases), their digests
# in an index of their own
LEGACY = REPO / "tests" / "data" / "legacy_io"
JPEG2000_FILES = ("scene_baseline_420_default.jp2",
                  "scene_baseline_444_tiles_rpcl.j2k",
                  "scene_progressive_layers_plt.jp2")
COMMITTED_JPEG2000 = {
    "jpeg2000": "scene_baseline_420_default.jp2",
    "jpeg2000_irreversible": "scene_baseline_420_irreversible.jp2"}
# the scenes as lossless HTJ2K (tests/image_corpus.htj2k_scene_cases):
# each scene's JPEG decode in a layout of its own (the first a raw
# codestream of cleanup passes, the second a JPH file of tiles and
# precincts in RPCL order with refinement passes, the third a JPH file of
# three quality layers with refinement passes)
HTJ2K_SCENES = REPO / "tests" / "data" / "htj2k_scenes"
HTJ2K_FILES = ("scene_baseline_420_ht.j2c",
               "scene_baseline_444_ht_tiles_rpcl.jph",
               "scene_progressive_ht_layers.jph")
# the scenes as AVIF at Pillow's defaults and the first at speed 0
# (tests/image_corpus.avif_scene_cases, csrc/av1_decode.cpp)
AVIF_SCENES = REPO / "tests" / "data" / "avif_scenes"
AVIF_FILES = ("scene_baseline_420.avif", "scene_baseline_444.avif",
              "scene_progressive.avif")
AVIF_SPEED0 = "scene_baseline_420_speed0.avif"
# the formats whose timed files are all three scenes' (format_scenes)
LAYOUTS = ("jpeg2000_layouts", "htj2k_layouts")
TIMED = ("images/sample.jpg", "output/detections.jpg",
         "tests/data/image_io/scene_progressive.jpg")
# the JPEG scenes as lossy WebP, each in the JPEG scene's slot
WEBP_SCENES = ("scene_baseline_420_q80.webp", "scene_baseline_444_q80.webp",
               "scene_progressive_q80.webp")
LOSSLESS_SCENE = "scene_baseline_420_lossless.webp"


def corpus_index() -> dict:
    return json.loads((CORPUS / "index.json").read_text())


def image_writers():
    """tests/image_writers.py (its BMP and GIF writers are numpy only)."""
    sys.path.insert(0, str(REPO / "tests"))
    import image_writers
    return image_writers


# the TIFF files a scene is written as (tests/image_writers.encode_tiff;
# tiles of 256x256, GeoTIFF's usual, so that the edge tiles are cropped)
TIFF_WRITES = {"raw": dict(),
               "lzw_predictor": dict(compression=5, predictor=2),
               "tiled_lzw_predictor": dict(compression=5, predictor=2,
                                           tile=(256, 256)),
               "tiled_deflate_predictor": dict(compression=8, predictor=2,
                                               tile=(256, 256))}


# the modes of libtiff's RGBA route, LAB and ICNS a scene is written as
# (tests/image_writers.py, numpy only), each decoding to pixels other than
# the JPEG file's: YCbCr 2x2 in LZW strips of 16 rows, YCbCr 1x1 in
# separate Deflate planes, the scene's own JPEG stream as old-style JPEG
# (the tables tags; the progressive scene the first scene's stream), LAB
# in LZW strips of 16 rows, and the scene's decode as a PNG ic10 entry on
# a 1024² canvas
RGBA_MODES = ("tiff_ycbcr22_lzw", "tiff_ycbcr11_planar", "tiff_ojpeg",
              "tiff_lab_lzw", "icns")


def rgba_mode(fmt: str, k: int, data: bytes, img) -> tuple:
    """(name suffix, bytes) of scene k (its JPEG file `data`, its decode
    `img`) in one of RGBA_MODES."""
    from maskrcnn_tpu_torch.data import image_io
    iw = image_writers()
    if fmt == "tiff_ycbcr22_lzw":
        return "_ycbcr22.tif", iw.encode_tiff_ycbcr(img, (2, 2), compression=5,
                                                    rows_per_strip=16)
    if fmt == "tiff_ycbcr11_planar":
        return "_ycbcr11.tif", iw.encode_tiff_ycbcr(
            img, (1, 1), planar=2, compression=8, rows_per_strip=16)
    if fmt == "tiff_ojpeg":
        if k == 2:
            data = (CORPUS / list(corpus_index()["scenes"])[0]).read_bytes()
        return "_ojpeg.tif", iw.ojpeg_tiff(data)
    if fmt == "tiff_lab_lzw":
        return "_lab.tif", iw.encode_tiff(iw.rgb_to_lab(img), photometric=8,
                                          compression=5, rows_per_strip=16)
    import numpy as np
    canvas = np.zeros((1024, 1024, 3), np.uint8)
    canvas[:img.shape[0], :img.shape[1]] = img
    return ".icns", iw.encode_icns([(b"ic10", image_io.encode_png(canvas))])


# the DDS, BLP, PSD and Part-2 JPEG 2000 files a scene is written as
# (tests/image_writers.py, numpy only), each decoding to pixels other than
# the JPEG file's: BC1 (DXT1) and BC7 (mode 6) DDS, 5-6-5 RGB-mask DDS,
# BLP2 DXT5 (read by BlpImagePlugin's own Python block decoder), the
# scene's own JPEG stream as BLP1 JPEG (its channels swapped, as Pillow
# reads them), PackBits RGB PSD, raw CMYK PSD, and the committed tiled
# J2K scene with a Part-2 transform (MCT, MCC and MCO markers: offsets
# that shift each component's DC level)
TEXTURE_MODES = ("dds_bc1", "dds_bc7", "dds_rgb565", "blp2_dxt5",
                 "blp1_jpeg", "psd_rgb_packbits", "psd_cmyk", "j2k_part2")


def texture_mode(fmt: str, k: int, data: bytes, img) -> tuple:
    """(name suffix, bytes) of scene k (its JPEG file `data`, its decode
    `img`) in one of TEXTURE_MODES."""
    import numpy as np
    iw = image_writers()
    h, w = img.shape[:2]
    if fmt == "dds_bc1":
        return "_bc1.dds", iw.encode_dds(w, h, iw.bc1_encode(img),
                                         fourcc=b"DXT1")
    if fmt == "dds_bc7":
        rgba = np.concatenate([img, np.full((h, w, 1), 255, np.uint8)], 2)
        return "_bc7.dds", iw.encode_dds(w, h, iw.bc7_mode6_encode(rgba),
                                         dxgi=iw.DXGI["BC7"])
    if fmt == "dds_rgb565":
        masks = (0xF800, 0x7E0, 0x1F, 0)
        return "_rgb565.dds", iw.encode_dds(
            w, h, iw.dds_mask_pixels(img, masks, 16), pfflags=iw.DDPF_RGB,
            bitcount=16, masks=masks)
    if fmt == "blp2_dxt5":
        return "_dxt5.blp", iw.blp_dxt_file(iw.bc3_encode(img), w, h,
                                            alpha_encoding=7)
    if fmt == "blp1_jpeg":
        return "_jpeg.blp", iw.blp_jpeg_file(data, w, h, split=len(data) // 2)
    planes = np.ascontiguousarray(img.transpose(2, 0, 1))
    if fmt == "psd_rgb_packbits":
        return "_rgb.psd", iw.encode_psd(planes, "RGB", compression=1)
    if fmt == "psd_cmyk":
        # "C;I" planes: the stored bytes are the RGB ones, K stored 255
        cmyk = np.concatenate([planes, np.full((1, h, w), 255, np.uint8)])
        return "_cmyk.psd", iw.encode_psd(cmyk, "CMYK")
    cs = (JPEG2000_SCENES / "scene_baseline_444_tiles_rpcl.j2k").read_bytes()
    return "_part2.j2k", iw.with_main_header_markers(cs, iw.part2_markers(
        3, [128 + 24 * k, 96, 160], np.eye(3)))


# the last plugins a scene is written as (tests/image_writers.py, numpy
# only), each decoding to pixels other than the JPEG file's: IM RGB (its
# rows layer by layer, bottom-up), SPIDER and FITS BITPIX -32 of its gray
# (the mean of its channels) as floats (the FITS data little-endian, as
# Pillow's raw mode F reads it), XPM under a 3-3-2 palette with keys of
# two characters, MSP version 2 of its bilevel, an FLC frame of BRUN lines
# under the 3-3-2 palette, GBR RGBA, and the scene on a 768x512 Photo CD
# base image (PhotoYCC, chroma at half size)
LEGACY_MODES = ("im_rgb", "spider", "fits_f32", "xpm", "msp_v2", "fli",
                "gbr_rgba", "pcd")


def legacy_mode(fmt: str, img) -> tuple:
    """(name suffix, bytes) of a scene's decode `img` in one of
    LEGACY_MODES."""
    import numpy as np
    iw = image_writers()
    h, w = img.shape[:2]
    gray = img.astype(np.float32).mean(-1)
    if fmt == "im_rgb":
        return ".im", iw.encode_im("RGB", w, h, iw.im_rows(img, True))
    if fmt == "spider":
        return ".spi", iw.encode_spider(gray)
    if fmt == "fits_f32":
        return "_f32.fits", iw.encode_fits(gray, -32, little=True)
    if fmt == "xpm":
        idx, palette = iw.quantize_332(img)
        return ".xpm", iw.encode_xpm(idx, palette, 2)
    if fmt == "msp_v2":
        return ".msp", iw.encode_msp((gray > 110).astype(np.uint8), 2)
    if fmt == "fli":
        idx, palette = iw.quantize_332(img)
        return ".flc", iw.encode_fli(w, h, [iw.fli_color(palette),
                                            iw.fli_brun(idx)])
    if fmt == "gbr_rgba":
        rgba = np.concatenate([img, np.full((h, w, 1), 255, np.uint8)], 2)
        return ".gbr", iw.encode_gbr(rgba)
    canvas = np.zeros((512, 768, 3), np.uint8)
    canvas[:min(h, 512), :min(w, 768)] = img[:512, :768]
    return ".pcd", iw.encode_pcd(*iw.rgb_to_photo_ycc(canvas))


# the small lossless plugins a scene is written as (tests/image_writers.py,
# numpy only): Netpbm P6, TGA RLE, QOI (runs and RGB ops), PCX (RLE, three
# planes), SGI RLE and Sun raster RLE
PLUGIN_SCENES = ("ppm", "tga_rle", "qoi", "pcx", "sgi_rle", "sun_rle")


def plugin_scene(fmt: str, img) -> tuple:
    """(extension, bytes) of an RGB image in one of PLUGIN_SCENES."""
    iw = image_writers()
    if fmt == "ppm":
        return "ppm", iw.encode_ppm(img, b"P6")
    if fmt == "tga_rle":
        return "tga", iw.encode_tga(img, 10, 24)
    if fmt == "qoi":
        return "qoi", iw.encode_qoi_fast(img)
    if fmt == "pcx":
        return "pcx", iw.encode_pcx(img, 8, 3)
    if fmt == "sgi_rle":
        return "sgi", iw.encode_sgi(img, 1, True)
    return "ras", iw.encode_sun(img, 24, 2)


@functools.lru_cache(maxsize=None)
def scene_files(fmt: str, count: int = 3) -> tuple:
    """((name, bytes), ...) of the corpus's first `count` JPEG scenes (of
    three) in one format, in the order of the index's scenes: "jpeg" the
    files; "png" (image_io.encode_png: filter 0, zlib's level 6), "bmp" (24-bit), "gif" (a fixed 3-3-2 palette) and
    "tiff_<write>" (a TIFF_WRITES layout) written from their native
    decodes; "webp" the
    committed q80 files; "webp_lossless" the committed lossless file of
    the first scene (its JPEG decode's pixels) and the other two as their
    JPEG files; "tiff_jpeg" the baseline scenes' own JPEG streams as
    one-strip YCbCr JPEG TIFF (tests/image_writers.tiff_from_jpeg: the
    4:2:0 scene's subsampling 2x2, the 4:4:4 one's 1x1) and the
    progressive scene as its JPEG file (libtiff's reading of a
    progressive strip is not held to Pillow here); "tiff_zstd_predictor"
    and "tiff_lzma_predictor" the committed ZSTD or LZMA TIFF of the
    first scene (its JPEG decode's pixels) and the other two as their
    JPEG files; COMMITTED_JPEG's formats the committed arithmetic,
    lossless or smoothed JPEG file of the first scene and the other two
    as their JPEG files; "jpeg2000" and "jpeg2000_irreversible" the
    committed default and irreversible JP2 of the first scene and the
    other two as their JPEG files; "jpeg2000_layouts" each scene's
    committed reversible JPEG 2000 file (JPEG2000_FILES: its JPEG decode's
    pixels); "htj2k_layouts" each
    scene's committed lossless HTJ2K file (HTJ2K_FILES: its JPEG decode's
    pixels); "tiff_group4" the scenes' bilevel (mean of the channels
    below 110 black) as CCITT Group 4; PLUGIN_SCENES written from their
    native decodes (plugin_scene); RGBA_MODES (rgba_mode); TEXTURE_MODES
    (texture_mode); LEGACY_MODES (legacy_mode); "avif" the committed
    scenes as AVIF at Pillow's defaults, "avif_png" their decodes as PNG,
    "avif_speed0" the committed first scene at speed 0 (the other two as
    their AVIF files)."""
    from maskrcnn_tpu_torch.data import image_io
    names = list(corpus_index()["scenes"])[:count]
    out = []
    for k, name in enumerate(names):
        data = (CORPUS / name).read_bytes()
        stem = name.rsplit(".", 1)[0]
        if fmt in ("avif", "avif_png", "avif_speed0"):
            avif = AVIF_SPEED0 if fmt == "avif_speed0" and k == 0 \
                else AVIF_FILES[k]
            blob = (AVIF_SCENES / avif).read_bytes()
            if fmt == "avif_png":
                avif = avif.rsplit(".", 1)[0] + ".png"
                blob = image_io.encode_png(image_io.read_image(blob))
            out.append((avif, blob))
        elif fmt == "webp" or (fmt == "webp_lossless" and k == 0):
            webp = WEBP_SCENES[k] if fmt == "webp" else LOSSLESS_SCENE
            out.append((webp, (CORPUS / webp).read_bytes()))
        elif fmt in COMMITTED_TIFF and k == 0:
            out.append((COMMITTED_TIFF[fmt],
                        (TIFF_SCENES / COMMITTED_TIFF[fmt]).read_bytes()))
        elif fmt in COMMITTED_JPEG and k == 0:
            out.append((COMMITTED_JPEG[fmt],
                        (JPEG_SCENES / COMMITTED_JPEG[fmt]).read_bytes()))
        elif fmt in COMMITTED_JPEG2000 and k == 0:
            out.append((COMMITTED_JPEG2000[fmt], (
                JPEG2000_SCENES / COMMITTED_JPEG2000[fmt]).read_bytes()))
        elif fmt == "jpeg2000_layouts":
            out.append((JPEG2000_FILES[k],
                        (JPEG2000_SCENES / JPEG2000_FILES[k]).read_bytes()))
        elif fmt == "htj2k_layouts":
            out.append((HTJ2K_FILES[k],
                        (HTJ2K_SCENES / HTJ2K_FILES[k]).read_bytes()))
        elif fmt == "tiff_group4":
            bilevel = image_io.read_image(data).mean(-1) < 110
            out.append((f"{stem}_group4.tif", image_writers().encode_tiff(
                bilevel, bits=1, photometric=0, compression=4)))
        elif fmt in PLUGIN_SCENES:
            ext, blob = plugin_scene(fmt, image_io.read_image(data))
            out.append((f"{stem}.{ext}", blob))
        elif fmt in RGBA_MODES:
            suffix, blob = rgba_mode(fmt, k, data, image_io.read_image(data))
            out.append((f"{stem}{suffix}", blob))
        elif fmt in TEXTURE_MODES:
            suffix, blob = texture_mode(fmt, k, data,
                                        image_io.read_image(data))
            out.append((f"{stem}{suffix}", blob))
        elif fmt in LEGACY_MODES:
            suffix, blob = legacy_mode(fmt, image_io.read_image(data))
            out.append((f"{stem}{suffix}", blob))
        elif fmt == "tiff_jpeg" and "progressive" not in name:
            out.append((f"{stem}_jpeg.tif", image_writers().tiff_from_jpeg(
                data)))
        elif fmt in ("png", "bmp", "gif") or (fmt.startswith("tiff_")
                                              and fmt[5:] in TIFF_WRITES):
            iw = image_writers()
            img = image_io.read_image(data)
            h, w = img.shape[:2]
            if fmt == "png":
                out.append((f"{stem}.png", image_io.encode_png(img)))
            elif fmt == "bmp":
                blob = iw.encode_bmp(w, h, 24,
                                     iw.bmp_pixels(img, 24)[::-1].tobytes())
                out.append((f"{stem}.bmp", blob))
            elif fmt == "gif":
                idx, palette = iw.quantize_332(img)
                out.append((f"{stem}.gif",
                            iw.encode_gif(idx, global_palette=palette)))
            else:
                out.append((f"{stem}_{fmt[5:]}.tif",
                            iw.encode_tiff(img, **TIFF_WRITES[fmt[5:]])))
        else:
            out.append((name, data))
    return tuple(out)


FORMAT_TIMES = ("png", "webp", "webp_lossless", "gif", "bmp", "tiff_raw",
                "tiff_lzw_predictor", "tiff_tiled_deflate_predictor",
                "tiff_jpeg", "tiff_zstd_predictor", "tiff_lzma_predictor",
                "tiff_group4") + PLUGIN_SCENES + tuple(COMMITTED_JPEG) + tuple(
                    COMMITTED_JPEG2000) + LAYOUTS + RGBA_MODES + \
    TEXTURE_MODES + LEGACY_MODES + ("avif", "avif_speed0")


def format_scenes() -> dict:
    """{name: bytes} of the first scene as PNG, lossy WebP, lossless WebP,
    GIF, BMP, and TIFF uncompressed, LZW with predictor 2, tiled Deflate with
    predictor 2, YCbCr 2x2 JPEG, ZSTD and LZMA with predictor 2 and its
    bilevel as Group 4, as PPM P6, TGA RLE, QOI, PCX, SGI RLE and Sun
    RLE, as arithmetic-coded sequential and progressive JPEG, lossless
    JPEG with predictors 1 and 7 and a block-smoothed progressive JPEG,
    as reversible and irreversible JP2, and the three scenes each as
    reversible JPEG 2000 and as lossless HTJ2K in its layout (LAYOUTS), in
    RGBA_MODES, TEXTURE_MODES and LEGACY_MODES, and as AVIF at Pillow's
    defaults and at speed 0 (the files decode_times times beside
    TIMED)."""
    return {name: data for fmt in FORMAT_TIMES
            for name, data in scene_files(fmt, 3 if fmt in LAYOUTS else 1)}


@functools.lru_cache(maxsize=None)
def _scene_decode(k: int):
    from maskrcnn_tpu_torch.data import image_io
    name = list(corpus_index()["scenes"])[k]
    return name.rsplit(".", 1)[0], image_io.read_image(CORPUS / name)


# "jpeg_modes": each scene's turns through its committed JPEG files that
# hold its JPEG file's pixels (JPEG_SCENES: the first scene's arithmetic
# sequential, arithmetic progressive and lossless files, the others'
# arithmetic sequential and progressive ones)
JPEG_MODE_TURNS = (("scene_baseline_420_arith.jpg",
                    "scene_baseline_420_arith_progressive.jpg",
                    "scene_baseline_420_lossless_p1.jpg"),
                   ("scene_baseline_444_arith.jpg",
                    "scene_baseline_444_arith_progressive.jpg"),
                   ("scene_progressive_arith.jpg",
                    "scene_progressive_arith_progressive.jpg"))


def coco_scene_dir(root: Path, copies: int, fmt: str = "jpeg",
                   limit: Optional[int] = None) -> str:
    """A COCO directory (minival 2014 names) of the corpus's scenes in
    `fmt` (scene_files; "plugins": image i in PLUGIN_SCENES[(i - 1) %
    6], each written when its image is; "jpeg_modes": copy c of scene j
    JPEG_MODE_TURNS[j][c % its length]; "rgba_modes": image i in
    RGBA_MODES[(i - 1) % 5], and "rgba_modes_png" each of those files'
    decode as PNG; "texture_modes" image i in TEXTURE_MODES[(i - 1) % 8],
    "texture_modes_png" as PNG; "legacy_modes" image i in
    LEGACY_MODES[(i - 1) % 8], "legacy_modes_png" as PNG), each `copies`
    times (the first
    `limit` images of those, where given), with the JPEG scenes'
    annotations. Returns the directory."""
    index = corpus_index()
    root = Path(root) / "coco"
    (root / "annotations").mkdir(parents=True, exist_ok=True)
    (root / "val2014").mkdir(exist_ok=True)
    images, anns = [], []
    turns = {"rgba_modes": RGBA_MODES, "texture_modes": TEXTURE_MODES,
             "legacy_modes": LEGACY_MODES}
    files = (scene_files(fmt) if fmt not in (
        "plugins", "jpeg_modes", "rgba_modes", "rgba_modes_png",
        "texture_modes", "texture_modes_png", "legacy_modes",
        "legacy_modes_png") else None)
    for k in range(copies):
        for j, (scene, scene_anns) in enumerate(index["scenes"].items()):
            i = len(images) + 1
            shape = index["files"][scene]["shape"]
            if limit is not None and i > limit:
                break
            if files is not None:
                name, data = files[j]
            elif fmt == "jpeg_modes":
                turns = JPEG_MODE_TURNS[j]
                name = turns[k % len(turns)]
                data = (JPEG_SCENES / name).read_bytes()
            elif fmt.startswith(("rgba_modes", "texture_modes",
                                 "legacy_modes")):
                from maskrcnn_tpu_torch.data import image_io
                modes = turns[fmt.replace("_png", "")]
                name, data = scene_files(modes[(i - 1) % len(modes)])[j]
                decoded = image_io.read_image(data)
                shape = decoded.shape[:2]  # (ICNS: its 1024² canvas, PCD
                # its 768x512 base image)
                if fmt.endswith("_png"):
                    name = name.rsplit(".", 1)[0] + ".png"
                    data = image_io.encode_png(decoded)
            else:
                stem, img = _scene_decode(j)
                ext, data = plugin_scene(
                    PLUGIN_SCENES[(i - 1) % len(PLUGIN_SCENES)], img)
                name = f"{stem}.{ext}"
            h, w = shape
            file_name = f"COCO_val2014_{i:012d}{Path(name).suffix}"
            (root / "val2014" / file_name).write_bytes(data)
            images.append({"id": i, "height": h, "width": w,
                           "file_name": file_name, "source": name})
            for a in scene_anns:
                anns.append(dict(a, id=len(anns) + 1, image_id=i))
    with open(root / "annotations" / "instances_minival2014.json", "w") as f:
        json.dump({"images": images, "annotations": anns,
                   "categories": index["categories"]}, f)
    return str(root)


def median_ms(fn, reps: int) -> float:
    runs = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        runs.append((time.perf_counter() - t) * 1e3)
    return statistics.median(runs)


def decode_times(reps: int = 5) -> dict:
    """{file: {"native_ms", "plain_ms" (None where the plain route refuses
    the file)}}, medians of `reps`: TIMED, then format_scenes()."""
    from maskrcnn_tpu_torch.data import image_io
    out = {}
    files = {name: (REPO / name).read_bytes() for name in TIMED}
    files.update(format_scenes())
    for name, data in files.items():
        image_io.read_image(data)                       # the build, once
        row = {"native_ms": median_ms(lambda: image_io.read_image(data),
                                      reps)}
        try:
            image_io.read_image(data, plain=True)
            row["plain_ms"] = median_ms(
                lambda: image_io.read_image(data, plain=True), reps)
        except NotImplementedError:
            row["plain_ms"] = None
        out[name] = row
    return out


def inflate_times(reps: int = 5) -> dict:
    """{"own_ms", "zlib_ms", "bytes", "zlib"}: the PNG scene's image data
    (its IDAT chunks joined) inflated by the decoder's own inflate
    (native_image.inflate) and by zlib.decompress (the zlib Python runs,
    its version under "zlib"), medians of `reps`."""
    import struct
    import zlib

    from maskrcnn_tpu_torch.data import native_image
    data = scene_files("png", 1)[0][1]
    pos, z = 8, b""
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        if kind == b"IDAT":
            z += data[pos + 8:pos + 8 + length]
        pos += 12 + length
    raw = zlib.decompress(z)
    if native_image.inflate(z, len(raw)) != raw:
        raise RuntimeError("the decoder's inflate differs from zlib's")
    return {"own_ms": median_ms(lambda: native_image.inflate(z, len(raw)),
                                reps),
            "zlib_ms": median_ms(lambda: zlib.decompress(z), reps),
            "bytes": len(z), "zlib": zlib.ZLIB_RUNTIME_VERSION}


def decode_rates(decodes: int = 48) -> dict:
    """{route: {threads: decodes a second}}: `decodes` decodes (a quarter
    of them on the plain route) of the two baseline JPEG scenes
    ("native", "plain"), of the three lossy WebP scenes ("webp"), of
    the three scenes as tiled Deflate TIFF with predictor 2 ("tiff") or
    of the first scene as AVIF at Pillow's defaults ("avif") and at
    speed 0 ("avif_speed0"), spread over 1 and 4 threads."""
    from concurrent.futures import ThreadPoolExecutor

    from maskrcnn_tpu_torch.data import image_io
    jpeg = [(CORPUS / n).read_bytes()
            for n in ("scene_baseline_420.jpg", "scene_baseline_444.jpg")]
    files = {"webp": [(CORPUS / n).read_bytes() for n in WEBP_SCENES],
             "tiff": [d for _, d in scene_files(
                 "tiff_tiled_deflate_predictor")],
             "avif": [(AVIF_SCENES / AVIF_FILES[0]).read_bytes()],
             "avif_speed0": [(AVIF_SCENES / AVIF_SPEED0).read_bytes()]}
    out = {}
    for route in ("native", "plain", "webp", "tiff", "avif", "avif_speed0"):
        n = decodes // 4 if route == "plain" else decodes
        data = files.get(route, jpeg)

        def decode(i, plain=route == "plain", data=data):
            return image_io.read_image(data[i % len(data)], plain=plain)

        out[route] = {}
        for threads in (1, 4):
            with ThreadPoolExecutor(threads) as pool:
                list(pool.map(decode, range(threads)))
                t = time.perf_counter()
                list(pool.map(decode, range(n)))
                out[route][threads] = n / (time.perf_counter() - t)
    return out


def loader_rate(root: str, workers: int, samples: int = 96,
                warmup: int = 8) -> float:
    """BatchLoader images a second over the COCO directory at `root`
    (CocoConfig: 1024² canvas, batch 4): samples pulled after `warmup`
    over the seconds they took."""
    from maskrcnn_tpu_torch.config import CocoConfig
    from maskrcnn_tpu_torch.data.coco import CocoDataset
    from maskrcnn_tpu_torch.data.pipeline import BatchLoader
    cfg = CocoConfig()
    ds = CocoDataset(root, "minival", 2014, cfg)
    batch = 4
    loader = BatchLoader(ds, batch, num_workers=workers, prefetch=2, seed=0)
    try:
        for _ in range(warmup // batch):
            next(loader)
        t = time.perf_counter()
        for _ in range(samples // batch):
            next(loader)
        return samples / (time.perf_counter() - t)
    finally:
        loader.close()


def loader_rates(copies: int = 8) -> dict:
    """{workers: images/s} for 1 and 4 workers."""
    with tempfile.TemporaryDirectory() as tmp:
        root = coco_scene_dir(Path(tmp), copies)
        return {w: loader_rate(root, w) for w in (1, 4)}


# the Huffman JPEG files `--jpeg-ab` times: the repository's sample and
# the corpus's three 640x480 scenes (chip_smoke.py 9d's JPEG sweep)
AB_FILES = ("images/sample.jpg", "tests/data/image_io/scene_baseline_420.jpg",
            "tests/data/image_io/scene_baseline_444.jpg",
            "tests/data/image_io/scene_progressive.jpg")


def jpeg_ms(reps: int) -> dict:
    """{file: ms}: the least of `reps` means of 5 native decodes of each
    of AB_FILES (this repository's bytes), by the maskrcnn_tpu_torch
    first on sys.path."""
    from maskrcnn_tpu_torch.data import native_image
    out = {}
    for name in AB_FILES:
        data = (REPO / name).read_bytes()
        native_image.decode_jpeg(data)  # builds the library
        best = float("inf")
        for _ in range(reps):
            t = time.perf_counter()
            for _ in range(5):
                native_image.decode_jpeg(data)
            best = min(best, (time.perf_counter() - t) / 5 * 1e3)
        out[name] = best
    return out


def jpeg_ab(roots, rounds: int, reps: int) -> dict:
    """{root: {file: [ms of each round]}}, each root's port timed by
    jpeg_ms in a process of its own, the roots in turn in each round."""
    import subprocess
    out = {r: {n: [] for n in AB_FILES} for r in roots}
    for _ in range(rounds):
        for root in roots:
            res = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--jpeg-ms",
                 os.path.abspath(root), "--reps", str(reps)],
                check=True, capture_output=True, text=True)
            for name, ms in json.loads(res.stdout.splitlines()[-1]).items():
                out[root][name].append(ms)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--copies", type=int, default=8)
    ap.add_argument("--json-out", default=None)
    ap.add_argument("--jpeg-ab", nargs="+", default=None, metavar="ROOT")
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--jpeg-ms", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.jpeg_ms:
        sys.path.insert(0, args.jpeg_ms)
        print(json.dumps(jpeg_ms(args.reps)))
        return 0
    if args.jpeg_ab:
        ab = jpeg_ab(args.jpeg_ab, args.rounds, args.reps)
        for root, files in ab.items():
            print(f"{root}: " + ", ".join(
                f"{Path(n).name} median {statistics.median(v):.3f} "
                f"min {min(v):.3f} ms" for n, v in files.items()), flush=True)
        if args.json_out:
            with open(args.json_out, "w") as f:
                json.dump({"jpeg_ab_ms": ab, "reps": args.reps}, f, indent=1)
        return 0
    times = decode_times(args.reps)
    for name, row in times.items():
        print(f"{name}: " + ", ".join(
            f"{k} {v:.2f}" if v is not None else f"{k} refused"
            for k, v in row.items()), flush=True)
    inflate = inflate_times(args.reps)
    print(f"PNG scene's image data ({inflate['bytes']} bytes) inflated: "
          f"own {inflate['own_ms']:.2f} ms, zlib {inflate['zlib']} "
          f"{inflate['zlib_ms']:.2f} ms", flush=True)
    threads = decode_rates()
    for route, row in threads.items():
        print(f"{route} decodes of the scenes: 1 thread "
              f"{row[1]:.1f}/s, 4 threads {row[4]:.1f}/s "
              f"({row[4] / row[1]:.2f}x)", flush=True)
    rates = loader_rates(args.copies)
    print(f"BatchLoader over the corpus scenes: 1 worker {rates[1]:.1f} "
          f"img/s, 4 workers {rates[4]:.1f} img/s "
          f"({rates[4] / rates[1]:.2f}x)", flush=True)
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump({"decode_ms": times, "inflate_ms": inflate,
                       "decode_threads": threads,
                       "loader_img_s": rates, "reps": args.reps}, f,
                      indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
