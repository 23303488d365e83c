"""The image reader's committed corpus, `tests/data/image_io/`: small
seeded files of every JPEG, PNG, WebP, GIF, BMP and TIFF mode the port
reads (the WebP, GIF, BMP and TIFF modes each at 1x1, 5x3, 37x53 and
16x24), a few it refuses, three COCO-sized (640x480) synthetic scenes as JPEG files, one
of them progressive, with their annotations (chip_smoke.py's phase 9d
reads them as a COCO directory), the same three scenes as lossy WebP
(q80), and the first scene's JPEG decode as lossless WebP; beside it,
`tests/data/tiff_scenes/`, the first scene's JPEG decode as ZSTD and
LZMA TIFF (Pillow's writer, predictor 2) with their digests.

`index.json` beside the files gives each file's rows, columns and the
SHA-256 of Pillow 12.1.0's decode (np.asarray(Image.open(f).convert(
"RGB"))), the word each refused file's NotImplementedError names, the
text of Pillow's error on each file it fails on ("errors"), and the
scenes' annotations. The card's machine has no Pillow: chip_smoke.py
holds the port's reader to these digests there.

Every file is made here from seeded numpy arrays: by Pillow where Pillow
writes the mode, by a byte edit of a Pillow file (an Adobe transform set
to 2 for YCCK, the Adobe marker removed, a frame marker or precision
rewritten), or by the test-only writers (tests/jpeg_writer.py,
tests/image_writers.py, whose `encode_tiff` writes every TIFF; the PNG
writer below). The files of libtiff's RGBA route and the rest
(tiff_rgba_cases): YCbCr by image_writers.encode_tiff_ycbcr, old-style
JPEG by image_writers.encode_tiff_ojpeg (Pillow's JPEG, split), LAB
(image_writers.rgb_to_lab), 16-bit CMYK and ThunderScan
(image_writers.thunder_encode) by encode_tiff, xz
chains by the standard library's lzma or, for ARM64 and RISC-V,
Pillow's liblzma (image_writers.xz_liblzma); ICNS files (icns_cases) by
image_writers.encode_icns over Pillow's PNG and JPEG 2000 entries and
image_writers.icns_rgb. The `refused_*` files are classed by Pillow's
outcome (write_outcome): "refused" where the port does not read what
Pillow reads (STILL_REFUSED), else a digest or, where Pillow fails,
"errors" with its error's text. `--lab-clut` writes LittleCMS's LAB ->
sRGB table the port's LAB decode uses (maskrcnn_tpu_torch/data/
lab_srgb_clut.zlib, from Pillow's liblcms2) and prints the digest of
Pillow's conversion of all 2**24 LAB pixels. Regenerate with `python
tests/image_corpus.py` (needs Pillow, and the system's libwebp for the
encoder options Pillow does not reach; the digests then change only if
Pillow's decode does);
`--time-pillow` prints Pillow's decode times of the files
tools/image_decode_bench_torch.py times instead, `--time-htj2k` those of
its scenes as HTJ2K and as Part-1 JPEG 2000 alone; `--htj2k` writes the
HTJ2K files alone (htj2k_cases, the HT scenes) and `--htj2k-tables`
csrc/htj2k_tables.h; `--avif` writes the AVIF files alone (avif_cases,
the AVIF refusals, `tests/data/avif_scenes/`: needs OpenCV's libaom for
the 10-bit, 12-bit and superres files) and `--av1-tables`
csrc/av1_tables.h (tests/av1_libaom.py); `--rgba-icns` writes
tiff_rgba_cases, icns_cases and the refused files alone, every other
file and entry kept.
"""

from __future__ import annotations

import hashlib
import io
import json
import re
import struct
import sys
import zlib
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(1, str(Path(__file__).resolve().parent.parent))

import image_writers as iw  # noqa: E402
from jpeg_writer import encode_jpeg, scan_offsets  # noqa: E402

CORPUS = Path(__file__).resolve().parent / "data" / "image_io"
INDEX = CORPUS / "index.json"
# the first scene as ZSTD and LZMA TIFF (tiff_scene_cases), under a size
# bound of its own (test_tiff_scenes_are_whole_and_small)
TIFF_SCENES = CORPUS.parent / "tiff_scenes"
# the scenes as arithmetic-coded and lossless JPEG (jpeg_scene_cases),
# under a size bound of their own (test_jpeg_scenes_are_whole_and_small)
JPEG_SCENES = CORPUS.parent / "jpeg_scenes"
# the scenes as JPEG 2000 (jpeg2000_scene_cases), under a size bound of
# their own (test_jpeg2000_scenes_are_whole_and_small)
JPEG2000_SCENES = CORPUS.parent / "jpeg2000_scenes"
# the scenes as HTJ2K (htj2k_scene_cases), under a size bound of their own
# (test_htj2k_scenes_are_whole_and_small)
HTJ2K_SCENES = CORPUS.parent / "htj2k_scenes"
PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
ADAM7 = [(0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2)]
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def seeded_image(rng, h, w, channels=3):
    """Smooth gradients with noise and a hard edge (the IDCT, the
    upsampling and the range limit all see work)."""
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([(yy * 7 + xx * 3) % 256, (xx * 11) % 256,
                     255 - (yy * 5) % 256, (yy * xx) % 256],
                    -1)[..., :channels]
    img = base + rng.randint(-40, 41, base.shape)
    img[: h // 2, : w // 3] = 255
    return np.clip(img, 0, 255).astype(np.uint8)


# ------------------------------------------------------------------ PNG

def _pack(samples: np.ndarray, depth: int) -> np.ndarray:
    """Rows of samples [h, n] as PNG row bytes of `depth`-bit samples."""
    h, n = samples.shape
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(h, -1)
    if depth == 8:
        return samples.astype(np.uint8)
    per = 8 // depth
    s = np.pad(samples, ((0, 0), (0, (-n) % per))).reshape(h, -1, per)
    out = np.zeros(s.shape[:2], np.int64)
    for i in range(per):
        out |= s[:, :, i].astype(np.int64) << (8 - depth * (i + 1))
    return out.astype(np.uint8)


def _filter(rows: np.ndarray, bpp: int, rng) -> bytes:
    """Each row filtered with a filter drawn from rng (all five)."""
    out = bytearray()
    prior = np.zeros(rows.shape[1], np.int64)
    zeros = np.zeros(bpp, np.int64)
    for row in rows.astype(np.int64):
        kind = int(rng.randint(5))
        left = np.concatenate([zeros, row])[:len(row)]
        up_left = np.concatenate([zeros, prior])[:len(row)]
        if kind == 0:
            pred = np.zeros_like(row)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = prior
        elif kind == 3:
            pred = (left + prior) // 2
        else:
            p = left + prior - up_left
            pa, pb, pc = (np.abs(p - left), np.abs(p - prior),
                          np.abs(p - up_left))
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prior, up_left))
        out.append(kind)
        out += ((row - pred) % 256).astype(np.uint8).tobytes()
        prior = row
    return bytes(out)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def png_bytes(samples: np.ndarray, width: int, depth: int, color: int,
              rng, interlace: int = 0, palette: bytes = None,
              trns: bytes = None) -> bytes:
    """A PNG of samples [H, W * channels] (ints below 2**depth): rows
    filtered with random filters, Adam7 passes when interlace is 1."""
    ch = CHANNELS[color]
    bpp = max(1, ch * depth // 8)
    h = samples.shape[0]
    if interlace:
        pixels = samples.reshape(h, width, ch)
        raw = b""
        for x0, y0, dx, dy in ADAM7:
            sub = pixels[y0::dy, x0::dx]
            if sub.size:
                raw += _filter(_pack(sub.reshape(sub.shape[0], -1), depth),
                               bpp, rng)
    else:
        raw = _filter(_pack(samples, depth), bpp, rng)
    out = PNG_SIGNATURE + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", width, h, depth, color, 0, 0, interlace))
    if palette is not None:
        out += _chunk(b"PLTE", palette)
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    # two IDAT chunks: the reader joins them
    data = zlib.compress(raw)
    half = len(data) // 2
    return (out + _chunk(b"IDAT", data[:half]) + _chunk(b"IDAT", data[half:])
            + _chunk(b"IEND", b""))


def seeded_png(seed: int, h: int, w: int, depth: int, color: int,
               interlace: int = 0, trns: bool = False) -> bytes:
    rng = np.random.RandomState(seed)
    top = (1 << depth) - 1
    palette = tr = None
    if color == 3:
        n = min(1 << depth, 200)
        palette = rng.randint(0, 256, 3 * n).astype(np.uint8).tobytes()
        samples = rng.randint(0, n, (h, w))
        if trns:
            tr = bytes(rng.randint(0, 256, min(n, 5)).astype(np.uint8))
    else:
        samples = rng.randint(0, top + 1, (h, w * CHANNELS[color]))
        if depth == 16:
            # around the clip of 16-bit grayscale ("I;16" -> 255)
            samples.flat[:3] = [255, 256, 1000]
        if trns and color in (0, 2):
            n = 1 if color == 0 else 3
            tr = struct.pack(">" + "H" * n, *rng.randint(0, top + 1, n))
    return png_bytes(samples, w, depth, color, rng, interlace, palette, tr)


# ----------------------------------------------------------------- JPEG

def pil_jpeg(img: np.ndarray, mode: str = None, **kw) -> bytes:
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(np.asarray(img, np.uint8), mode).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _adobe_at(data: bytes) -> int:
    return data.index(b"Adobe") - 4


def without_adobe(data: bytes) -> bytes:
    """The file with its Adobe APP14 segment removed."""
    i = _adobe_at(data)
    return data[:i] + data[i + 2 + struct.unpack(">H", data[i + 2:i + 4])[0]:]


def with_transform(data: bytes, transform: int) -> bytes:
    """The file with its Adobe transform byte rewritten."""
    out = bytearray(data)
    out[_adobe_at(data) + 4 + 11] = transform
    return bytes(out)


def patched_sof(data: bytes, marker: int = None,
                precision: int = None) -> bytes:
    """The file with its frame marker or sample precision rewritten."""
    i = next(i for i in range(len(data) - 1) if data[i] == 0xFF
             and data[i + 1] in (0xC0, 0xC1, 0xC2))
    out = bytearray(data)
    if marker is not None:
        out[i + 1] = marker
    if precision is not None:
        out[i + 4] = precision
    return bytes(out)


def drop_scan(data: bytes, k: int) -> bytes:
    """The file without its k-th scan (negative: from the end)."""
    s = scan_offsets(data)
    k %= len(s)
    end = s[k + 1] if k + 1 < len(s) else data.rindex(b"\xff\xd9")
    return data[:s[k]] + data[end:]


def jpeg_cases():
    """(name, bytes) of every read JPEG of the corpus, small and odd-sized."""
    rng = np.random.RandomState(14)
    img = seeded_image(rng, 37, 53)
    tall = seeded_image(rng, 53, 37)
    tiny = seeded_image(rng, 5, 3)
    gray = seeded_image(rng, 37, 53, 1)[..., 0]
    cmyk = seeded_image(rng, 37, 53, 4)
    planes = [img[..., k] for k in range(3)]
    cases = [
        ("baseline_444.jpg", pil_jpeg(img, quality=90, subsampling="4:4:4")),
        ("baseline_422_restart.jpg", pil_jpeg(img, quality=75,
                                              subsampling="4:2:2",
                                              restart_marker_blocks=2)),
        ("baseline_420_optimized.jpg", pil_jpeg(tall, quality=50,
                                                subsampling="4:2:0",
                                                optimize=True)),
        ("baseline_420_5x3.jpg", pil_jpeg(tiny, quality=95,
                                          subsampling="4:2:0")),
        ("gray.jpg", pil_jpeg(gray, quality=85)),
        ("progressive_420.jpg", pil_jpeg(img, quality=85, progressive=True,
                                         subsampling="4:2:0")),
        ("progressive_444_5x3.jpg", pil_jpeg(tiny, quality=90,
                                             progressive=True,
                                             subsampling="4:4:4")),
        ("progressive_422_restart.jpg", pil_jpeg(tall, quality=80,
                                                 progressive=True,
                                                 subsampling="4:2:2",
                                                 restart_marker_blocks=1)),
        ("progressive_gray_restart_rows.jpg", pil_jpeg(
            gray, quality=70, progressive=True, restart_marker_rows=1)),
        ("cmyk_adobe.jpg", pil_jpeg(cmyk, "CMYK", quality=90)),
        ("cmyk_adobe_uninverted.jpg", pil_jpeg(255 - cmyk, "CMYK",
                                               quality=90)),
        ("cmyk_no_adobe.jpg", without_adobe(pil_jpeg(cmyk, "CMYK",
                                                     quality=90))),
        ("cmyk_progressive.jpg", pil_jpeg(cmyk, "CMYK", quality=80,
                                          progressive=True)),
        ("ycck.jpg", with_transform(pil_jpeg(cmyk, "CMYK", quality=90), 2)),
        ("ycck_uninverted.jpg", with_transform(
            pil_jpeg(255 - cmyk, "CMYK", quality=90), 2)),
        ("adobe_rgb.jpg", pil_jpeg(img, quality=90, keep_rgb=True)),
        ("rgb_component_ids.jpg", without_adobe(pil_jpeg(img, quality=90,
                                                         keep_rgb=True))),
        ("writer_440.jpg", encode_jpeg(planes, [(1, 2), (1, 1), (1, 1)])),
        ("writer_411.jpg", encode_jpeg(planes, [(4, 1), (1, 1), (1, 1)])),
        ("writer_h3v1.jpg", encode_jpeg(planes, [(3, 1), (1, 1), (1, 1)],
                                        restart=3)),
        ("writer_h4v2_chroma_h2v1.jpg", encode_jpeg(
            planes, [(4, 2), (2, 1), (1, 1)], interleaved=False)),
        ("writer_h1v4.jpg", encode_jpeg(planes, [(1, 4), (1, 1), (1, 1)])),
        ("writer_420_scan_a_component.jpg", encode_jpeg(
            planes, [(2, 2), (1, 1), (1, 1)], interleaved=False, restart=4)),
        ("writer_gray_h2v2.jpg", encode_jpeg([gray], [(2, 2)])),
        ("writer_ycck_420.jpg", encode_jpeg(
            [cmyk[..., k] for k in range(4)], [(2, 2), (1, 1), (1, 1),
                                               (2, 2)], jfif=False,
            adobe=2)),
        ("writer_adobe_transform_5.jpg", encode_jpeg(
            planes, [(1, 1)] * 3, jfif=False, adobe=5)),
        ("writer_progressive_bands.jpg", encode_jpeg(
            planes, [(2, 2), (1, 1), (1, 1)], bands=[(1, 9), (10, 63)],
            restart=3)),
        # no scan of coefficients 10-63 of the first component:
        # coefficients 1-9 are whole, so libjpeg-turbo does not smooth
        ("writer_progressive_high_band_missing.jpg", drop_scan(encode_jpeg(
            planes, [(2, 2), (1, 1), (1, 1)], bands=[(1, 9), (10, 63)]),
            2)),
    ]
    return cases


# the corpus's four sizes of each JPEG mode of jpeg_mode_cases
MODE_SIZES = ((1, 1), (5, 3), (37, 53), (16, 24))


def jpeg_modes():
    """The writer of the JPEG modes Pillow reads but does not write
    (tests/jpeg_modes.py: tests/jpeg_modes.c built against Pillow's
    libjpeg-turbo 3.1)."""
    import jpeg_modes
    return jpeg_modes


def first_scans(data: bytes, k: int) -> bytes:
    """The file with only its first k scans (and EOI)."""
    s = scan_offsets(data)
    end = s[k] if k < len(s) else data.rindex(b"\xff\xd9")
    return data[:end] + b"\xff\xd9"


def jpeg_mode_cases():
    """(name, bytes) of the JPEG modes read since arithmetic coding,
    lossless frames and block smoothing came in, each at MODE_SIZES:
    arithmetic-coded sequential and progressive files (gray, 4:2:0, 4:2:2,
    4:4:4, CMYK and YCCK; restart intervals; DAC conditioning other than
    the default) and a Pillow file's coefficients re-coded arithmetic,
    written by Pillow's libjpeg-turbo; lossless files (predictors 1-7,
    point transforms 0 and 2, gray, RGB and YCbCr, subsampled chroma,
    restarts every MCU row), the same; and progressive Pillow files cut to
    their first scans, which libjpeg-turbo block-smooths."""
    jm = jpeg_modes()
    dac = ((2, 5, 10), (1, 3, 2))
    s420 = [(2, 2), (1, 1), (1, 1)]
    s422 = [(2, 1), (1, 1), (1, 1)]
    out = []
    for h, w in MODE_SIZES:
        rng = np.random.RandomState(19 + h * 100 + w)
        img = seeded_image(rng, h, w)
        gray = img[..., 0]
        cmyk = seeded_image(rng, h, w, 4)
        modes = {
            "arith_gray": jm.write(gray, arith=True),
            "arith_420": jm.write(img, arith=True, sampling=s420),
            "arith_422": jm.write(img, arith=True, sampling=s422),
            "arith_444": jm.write(img, arith=True),
            "arith_420_restart": jm.write(img, arith=True, sampling=s420,
                                          restart=2),
            "arith_444_dac": jm.write(img, arith=True, dac=dac),
            "arith_cmyk": jm.write(cmyk, arith=True),
            "arith_ycck_420": jm.write(cmyk, space=jm.YCCK, arith=True,
                                       sampling=s420 + [(2, 2)]),
            "arith_progressive_gray": jm.write(gray, arith=True,
                                               progressive=True),
            "arith_progressive_420": jm.write(img, arith=True,
                                              progressive=True,
                                              sampling=s420),
            "arith_progressive_422_restart": jm.write(
                img, arith=True, progressive=True, sampling=s422, restart=1),
            "arith_progressive_444_dac": jm.write(img, arith=True,
                                                  progressive=True, dac=dac),
            "arith_progressive_cmyk": jm.write(cmyk, arith=True,
                                               progressive=True),
            "arith_transcoded_420": jm.transcode(pil_jpeg(img, quality=85)),
            "lossless_gray_p4": jm.write(gray, predictor=4),
            "lossless_ycc_p1": jm.write(img, predictor=1),
            "lossless_ycc_420_p5": jm.write(img, predictor=5, sampling=s420),
            "lossless_rgb_p1_pt2": jm.write(img, predictor=1,
                                            point_transform=2,
                                            space=jm.RGB),
            "lossless_rgb_p7_pt2": jm.write(img, predictor=7,
                                            point_transform=2,
                                            space=jm.RGB),
            "lossless_rgb_p2_restart": jm.write(img, predictor=2,
                                                restart=-1, space=jm.RGB),
        }
        for psv in range(1, 8):
            modes[f"lossless_rgb_p{psv}"] = jm.write(img, predictor=psv,
                                                     space=jm.RGB)
        p420 = pil_jpeg(img, quality=85, progressive=True)
        for k in (1, 2, 3, 5, 7, 9):
            modes[f"smooth_420_first_{k}_scans"] = first_scans(p420, k)
        modes["smooth_444_last_scan_dropped"] = drop_scan(pil_jpeg(
            img, quality=85, progressive=True, subsampling="4:4:4"), -1)
        modes["smooth_gray_first_2_scans"] = first_scans(pil_jpeg(
            gray, quality=85, progressive=True), 2)
        for mode, data in modes.items():
            out.append((f"jpeg_{mode}_{h}x{w}.jpg", data))
    return out


def jpeg_outcome_cases():
    """(name, bytes) of byte edits that were refused before these modes
    were read, and now give Pillow's outcome (its pixels, or an error):
    Huffman data under an arithmetic or a lossless frame marker, and a
    progressive file without its last scan (block-smoothed)."""
    rng = np.random.RandomState(15)
    img = seeded_image(rng, 24, 24)
    base = pil_jpeg(img, quality=90)
    return [
        ("refused_progressive_last_scan_missing.jpg",
         drop_scan(pil_jpeg(img, quality=90, progressive=True), -1)),
        ("refused_arithmetic.jpg", patched_sof(base, marker=0xC9)),
        ("refused_lossless.jpg", patched_sof(base, marker=0xC3)),
    ]


def refused_cases():
    """(name, bytes, word the NotImplementedError names)."""
    rng = np.random.RandomState(15)
    img = seeded_image(rng, 24, 24)
    base = pil_jpeg(img, quality=90)
    planes = [img[..., k] for k in range(3)]
    lossless = jpeg_modes().write(img, predictor=1)
    return [
        # libjpeg-turbo codes no arithmetic lossless frame
        ("refused_arithmetic_lossless.jpg",
         lossless.replace(b"\xff\xc3", b"\xff\xcb", 1),
         "arithmetic-coded lossless"),
        ("refused_hierarchical.jpg", patched_sof(base, marker=0xC5),
         "hierarchical"),
        ("refused_12bit.jpg", patched_sof(base, precision=12), "12-bit"),
        ("refused_2_components.jpg", encode_jpeg(planes[:2], [(1, 1)] * 2),
         "2 components"),
        ("refused_fractional_sampling.jpg", encode_jpeg(
            planes, [(3, 1), (2, 1), (1, 1)]), "fractional"),
        ("refused_mcu_of_11_blocks.jpg", encode_jpeg(
            planes, [(3, 3), (1, 1), (1, 1)]), "more than 10 blocks"),
    ]


def png_cases():
    """(name, bytes) of every PNG mode: bit depths, Adam7, tRNS."""
    cases = []
    seed = 100
    for color, depths in ((0, (1, 2, 4, 8, 16)), (2, (8, 16)),
                          (3, (1, 2, 4, 8)), (4, (8, 16)), (6, (8, 16))):
        for depth in depths:
            for interlace in (0, 1):
                seed += 1
                h, w = (19, 27) if interlace else (5, 3)
                trns = color in (0, 2, 3) and depth != 16 and not interlace
                name = (f"png_c{color}_d{depth}"
                        f"{'_adam7' if interlace else ''}"
                        f"{'_trns' if trns else ''}.png")
                cases.append((name, seeded_png(seed, h, w, depth, color,
                                               interlace, trns)))
    # Adam7 at sizes with empty passes
    for h, w in ((1, 1), (2, 3), (3, 2)):
        seed += 1
        cases.append((f"png_c2_d8_adam7_{h}x{w}.png",
                      seeded_png(seed, h, w, 8, 2, 1)))
    return cases


# ------------------------------------------------- WebP, GIF and BMP

# (rows, columns) of every WebP, GIF and BMP mode's files
SIZES = ((1, 1), (5, 3), (37, 53), (16, 24))


def pil_bytes(img: np.ndarray, fmt: str, mode: str = None, **kw) -> bytes:
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(img, mode).save(buf, fmt, **kw)
    return buf.getvalue()


def pil_animation(frames, **kw) -> bytes:
    from PIL import Image
    ims = [Image.fromarray(f) for f in frames]
    buf = io.BytesIO()
    ims[0].save(buf, "WEBP", save_all=True, append_images=ims[1:],
                duration=100, **kw)
    return buf.getvalue()


def frame_chunks(data: bytes):
    """A still WebP file's bitstream chunks (ALPH and VP8, or VP8L)."""
    return [(c, b) for c, b in iw.webp_chunks(data) if c != b"VP8X"]


def with_scale_bits(data: bytes) -> bytes:
    """A plain lossy WebP file with the VP8 frame's scaling bits set (2
    horizontally, 1 vertically), which libwebp ignores."""
    out = bytearray(data)
    at = data.index(b"VP8 ") + 8
    out[at + 7] |= 0x80
    out[at + 9] |= 0x40
    return bytes(out)


def webp_modes(rng, h, w):
    """{mode: bytes} of every WebP mode at h x w."""
    img = seeded_image(rng, h, w)
    rgba = seeded_image(rng, h, w, 4)
    rgba[..., 3] = np.where(rgba[..., 3] > 128, 255, rgba[..., 3])
    second = np.roll(img, 1, axis=1)
    flat = np.full_like(img, 90)
    flat[h // 2:, w // 2:] = img[h // 2:, w // 2:]
    few = (rng.randint(0, 2, (h, w, 1)) * 200 + 30).repeat(3, 2).astype(
        np.uint8)
    sixteen = rng.randint(0, 16, (h, w))
    palette = rng.randint(0, 256, (16, 3)).astype(np.uint8)
    canvas = (w + 6, h + 4)
    return {
        "lossy_q0_m0": pil_bytes(img, "WEBP", quality=0, method=0),
        "lossy_q50_m4": pil_bytes(img, "WEBP", quality=50, method=4),
        "lossy_q100_m6": pil_bytes(img, "WEBP", quality=100, method=6),
        "lossy_alpha": pil_bytes(rgba, "WEBP", quality=80),
        "lossy_scale_bits": with_scale_bits(pil_bytes(img, "WEBP",
                                                      quality=80)),
        "lossy_loop_filter_deltas": iw.vp8_with_lf_deltas(
            pil_bytes(img, "WEBP", quality=60)),
        "lossy_simple_filter": iw.encode_webp(img, quality=60, filter_type=0,
                                              filter_strength=60),
        # libwebp writes one token partition at methods 3 to 6
        "lossy_2_partitions": iw.encode_webp(img, quality=75, partitions=1,
                                             method=0),
        "lossy_8_partitions": iw.encode_webp(img, quality=75, partitions=3,
                                             method=2),
        "lossy_skipped_macroblocks": iw.encode_webp(flat, quality=50,
                                                    method=2),
        "lossy_1_segment_no_filter": iw.encode_webp(
            img, quality=60, segments=1, filter_strength=0),
        "lossy_4_segments_sharpness_7": iw.encode_webp(
            img, quality=40, segments=4, sns_strength=100,
            filter_strength=80, filter_sharpness=7),
        "lossless": pil_bytes(img, "WEBP", lossless=True),
        "lossless_exact_alpha": pil_bytes(rgba, "WEBP", lossless=True,
                                          exact=True),
        "lossless_2_colours": pil_bytes(few, "WEBP", lossless=True),
        "lossless_16_colours": pil_bytes(palette[sixteen], "WEBP",
                                         lossless=True),
        "animation_lossy": pil_animation([img, second], quality=70),
        "animation_lossless": pil_animation([img, second], lossless=True),
        "animation_offset_lossy": iw.webp_container(canvas, [
            (2, 4, w, h, frame_chunks(pil_bytes(rgba, "WEBP",
                                                quality=70)))]),
        "animation_offset_lossless": iw.webp_container(canvas, [
            (4, 2, w, h, frame_chunks(pil_bytes(img, "WEBP",
                                                lossless=True)))]),
    }


def gif_indices(rng, h, w, n):
    """Indices below n in diagonal bands, one pixel in 20 drawn at random
    (LZW finds runs and strings)."""
    yy, xx = np.mgrid[0:h, 0:w]
    idx = (yy * 3 + xx * 5) // 4 % n
    noise = rng.rand(h, w) < 0.05
    idx[noise] = rng.randint(0, n, int(noise.sum()))
    return idx.astype(np.uint8)


def gif_modes(rng, h, w):
    """{mode: bytes} of every GIF mode at h x w."""
    idx = gif_indices(rng, h, w, 256)
    pal = rng.randint(0, 256, (256, 3)).astype(np.uint8)
    gray = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, 1)
    small = gif_indices(rng, h, w, 4)
    sixteen = gif_indices(rng, h, w, 16)
    return {
        "global_table": iw.encode_gif(idx, global_palette=pal),
        "local_table": iw.encode_gif(sixteen, global_palette=pal[16:32],
                                     local_palette=pal[:16], min_code_size=4),
        "interlaced": iw.encode_gif(sixteen, global_palette=pal[:16],
                                    interlace=True, min_code_size=4),
        "code_size_2": iw.encode_gif(small, global_palette=pal[:4],
                                     min_code_size=2),
        "code_size_4_short_table": iw.encode_gif(
            sixteen, global_palette=pal[:8], min_code_size=4),
        "clear_codes": iw.encode_gif(sixteen, global_palette=pal[:16],
                                     clear_every=5, deferred=False,
                                     min_code_size=4, version=b"GIF87a"),
        "offset_frame_transparency": iw.encode_gif(
            sixteen, (w + 7, h + 3), global_palette=pal[:16], offset=(3, 2),
            transparency=9, min_code_size=4),
        "frame_past_the_screen": iw.encode_gif(
            small, (max(1, w - 1), h), global_palette=pal[:4], offset=(1, 1),
            min_code_size=2),
        "grayscale_table": iw.encode_gif(idx, global_palette=gray),
        "no_table": iw.encode_gif(sixteen, min_code_size=4),
        "pillow": pil_bytes(seeded_image(rng, h, w), "GIF"),
    }


def bmp_modes(rng, h, w):
    """{mode: bytes} of every BMP mode at h x w (rows bottom-up unless
    the mode says top-down)."""
    img = seeded_image(rng, h, w)
    pal = rng.randint(0, 256, (256, 3)).astype(np.uint8)
    gray = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, 1)
    out = {}

    def rows(x, bits, masks=None, top_down=False):
        r = iw.bmp_pixels(x, bits, masks)
        return (r if top_down else r[::-1]).tobytes()

    # every header size: 1-bit 40, 4-bit 108, 8-bit 124
    for bits, header in ((1, 40), (4, 108), (8, 124)):
        idx = rng.randint(0, 1 << bits, (h, w))
        out[f"{bits}bit_header_{header}"] = iw.encode_bmp(
            w, h, bits, rows(idx, bits), header=header,
            palette=pal[:1 << bits])
    idx = rng.randint(0, 256, (h, w))
    out["8bit_short_palette"] = iw.encode_bmp(
        w, h, 8, rows(idx, 8), palette=pal[:100], colors=100)
    out["8bit_grayscale"] = iw.encode_bmp(w, h, 8, rows(idx, 8),
                                          palette=gray)
    bw = np.array([[0, 0, 0], [255, 255, 255]], np.uint8)
    out["1bit_black_white"] = iw.encode_bmp(
        w, h, 1, rows(rng.randint(0, 2, (h, w)), 1), palette=bw)
    out["8bit_os2_header"] = iw.encode_bmp(w, h, 8, rows(idx, 8), header=12,
                                           palette=pal)
    out["16bit_555_header_64"] = iw.encode_bmp(w, h, 16, rows(img, 16),
                                               header=64)
    m565 = (0xF800, 0x7E0, 0x1F)
    out["16bit_565_bitfields"] = iw.encode_bmp(
        w, h, 16, rows(img, 16, m565), compression=3, masks=m565)
    out["16bit_565_header_52"] = iw.encode_bmp(
        w, h, 16, rows(img, 16, m565), header=52, compression=3, masks=m565)
    out["24bit"] = iw.encode_bmp(w, h, 24, rows(img, 24))
    out["8bit_top_down_header_56"] = iw.encode_bmp(
        w, h, 8, rows(idx, 8, top_down=True), header=56, palette=pal,
        top_down=True)
    out["32bit_bgrx"] = iw.encode_bmp(w, h, 32, rows(img, 32))
    rgba = (0xFF, 0xFF00, 0xFF0000, 0xFF000000)
    out["32bit_rgba_bitfields"] = iw.encode_bmp(
        w, h, 32, rows(img, 32, rgba), header=108, compression=3, masks=rgba)
    for rle4 in (False, True):
        bits = 4 if rle4 else 8
        idx = rng.randint(0, 3, (h, w))
        idx[: h // 2, : w // 2] = 2
        p = pal[:16] if rle4 else pal
        start = 14 + 40 + 4 * len(p)
        # RLE4 top-down, RLE8 bottom-up
        ops = iw.rle_ops(idx[::-1] if rle4 else idx, rle4, rng)
        out[f"rle{bits}{'_top_down' if rle4 else ''}"] = iw.encode_bmp(
            w, h, bits, iw.rle_bytes(ops, rle4, start),
            compression=2 if rle4 else 1, palette=p, top_down=rle4)
    return out


def format_cases():
    """(name, bytes) of every WebP, GIF and BMP mode at every size, and a
    GIF whose LZW code table fills without a clear code."""
    rng = np.random.RandomState(16)
    cases = []
    for ext, modes in (("webp", webp_modes), ("gif", gif_modes),
                       ("bmp", bmp_modes)):
        for h, w in SIZES:
            for mode, data in modes(rng, h, w).items():
                cases.append((f"{ext}_{mode}_{h}x{w}.{ext}", data))
    idx = rng.randint(0, 256, (64, 72)).astype(np.uint8)
    cases.append(("gif_deferred_clear_64x72.gif", iw.encode_gif(
        idx, global_palette=rng.randint(0, 256, (256, 3)).astype(
            np.uint8))))
    return cases


def format_refused_cases():
    """(name, bytes, word the NotImplementedError names) of BMP files
    Pillow refuses or reads with the wrong unpacker."""
    rng = np.random.RandomState(17)
    img = seeded_image(rng, 6, 5)
    jpeg = pil_jpeg(img, quality=90)
    rows = iw.bmp_pixels(img, 24)[::-1].tobytes()
    gray16 = np.repeat(np.arange(16, dtype=np.uint8)[:, None], 3, 1)
    idx = rng.randint(0, 16, (6, 5))
    return [
        ("refused_bmp_jpeg.bmp", iw.encode_bmp(5, 6, 24, jpeg,
                                               compression=4), "JPEG"),
        ("refused_bmp_png.bmp", iw.encode_bmp(
            5, 6, 24, png_bytes(img.reshape(6, -1), 5, 8, 2, rng),
            compression=5), "PNG"),
        ("refused_bmp_bitfields_layout.bmp", iw.encode_bmp(
            5, 6, 32, iw.bmp_pixels(img, 32, (0xFF00, 0xFF0000, 0xFF000000))
            [::-1].tobytes(), compression=3,
            masks=(0xFF00, 0xFF0000, 0xFF000000)), "bit-fields layout"),
        ("refused_bmp_2bit.bmp", iw.encode_bmp(5, 6, 2, rows), "depth 2"),
        ("refused_bmp_rle_24bit.bmp", iw.encode_bmp(5, 6, 24, b"\x00\x01",
                                                    compression=1), "RLE"),
        ("refused_bmp_4bit_grayscale.bmp", iw.encode_bmp(
            5, 6, 4, iw.bmp_pixels(idx, 4)[::-1].tobytes(), palette=gray16),
         "grayscale palette"),
    ]


# ----------------------------------------------------------------- TIFF

def tiff_jpeg_segments(img, rows=None, tile=None, tables=False, **kw):
    """Pillow's JPEG streams of each strip of `rows` rows (all of them by
    default) or each `tile` (width, length) of img, edge tiles padded;
    with `tables`, (the JPEGTables, the abbreviated streams)."""
    h, w = img.shape[:2]
    segs = []
    if tile:
        tw, th = tile
        for y in range(0, h, th):
            for x in range(0, w, tw):
                blk = np.zeros((th, tw) + img.shape[2:], np.uint8)
                part = img[y:y + th, x:x + tw]
                blk[:part.shape[0], :part.shape[1]] = part
                segs.append(pil_jpeg(blk, **kw))
    else:
        for y in range(0, h, rows or h):
            segs.append(pil_jpeg(img[y:y + (rows or h)], **kw))
    if not tables:
        return segs
    return (iw.jpeg_split_tables(segs[0])[0],
            [iw.jpeg_split_tables(sg)[1] for sg in segs])


def tiff_modes(rng, h, w):
    """{mode: bytes} of every TIFF mode, compression, predictor, layout
    and orientation the reader takes, at h x w."""
    img = seeded_image(rng, h, w)
    rgba = seeded_image(rng, h, w, 4)
    gray = img[..., 0]
    cmyk = seeded_image(rng, h, w, 4)
    u16 = (img.astype(np.int64) * 257 + rng.randint(0, 257, img.shape))
    cmap = rng.randint(0, 65536, (256, 3))
    fl = (img[..., 1].astype(np.float32) * 1.17 - 20.5)
    enc = iw.encode_tiff
    out = {
        "bilevel_raw": enc(gray > 120, bits=1, photometric=1),
        "bilevel_min_is_white_packbits": enc(gray > 90, bits=1, photometric=0,
                                             compression=32773),
        "bilevel_fill_order_2_raw": enc(gray > 120, bits=1, photometric=1,
                                        fill_order=2),
        "gray2_lzw": enc(gray >> 6, bits=2, photometric=1, compression=5),
        "gray4_min_is_white_deflate": enc(gray >> 4, bits=4, photometric=0,
                                          compression=8),
        "gray8_min_is_white_raw": enc(gray, photometric=0),
        "gray8_lzw_predictor": enc(gray, photometric=1, compression=5,
                                   predictor=2),
        "gray8_tiled_lzw": enc(gray, photometric=1, compression=5,
                               tile=(16, 16)),
        "gray12_lzw": enc(u16[..., 0] >> 4, bits=12, photometric=1,
                          compression=5),
        "gray16_deflate_predictor": enc(u16[..., 0], bits=16, photometric=1,
                                        compression=8, predictor=2),
        "gray16_big_endian_lzw_predictor": enc(
            u16[..., 1], bits=16, photometric=1, compression=5, predictor=2,
            byteorder=">"),
        "gray16_signed_raw": enc(u16[..., 2], bits=16, photometric=1,
                                 sample_format=2),
        "int32_signed_deflate": enc(
            (img[..., 0].astype(np.int64) * 3 - 120) % (1 << 32), bits=32,
            photometric=1, sample_format=2, compression=8),
        "float32_deflate_predictor3": enc(fl, bits=32, photometric=1,
                                          sample_format=3, compression=8,
                                          predictor=3),
        "float32_big_endian_raw": enc(fl, bits=32, photometric=1,
                                      sample_format=3, byteorder=">"),
        "palette1_raw": enc(gray & 1, bits=1, photometric=3,
                            colormap=cmap[:2]),
        "palette2_packbits": enc(gray & 3, bits=2, photometric=3,
                                 colormap=cmap[:4], compression=32773),
        "palette4_lzw": enc(gray & 15, bits=4, photometric=3,
                            colormap=cmap[:16], compression=5),
        "palette8_short_colormap_deflate": enc(
            gray, photometric=3, compression=8,
            tags={320: (3, cmap[:200].T.reshape(-1).tolist())}),
        "la_lzw": enc(rgba[..., :2], photometric=1, extra_samples=[2],
                      compression=5),
        "pa_raw": enc(np.dstack([gray, img[..., 1]]), photometric=3,
                      extra_samples=[2], colormap=cmap),
        "rgb_raw": enc(img),
        "rgb_packbits": enc(img, compression=32773),
        "rgb_lzw": enc(img, compression=5),
        "rgb_lzw_old_style": enc(img, compression=5, old_lzw=True),
        "rgb_lzw_predictor_strips_of_2": enc(img, compression=5, predictor=2,
                                             rows_per_strip=2),
        "rgb_deflate_predictor": enc(img, compression=8, predictor=2),
        "rgb_deflate_32946": enc(img, compression=32946),
        "rgb_tiled_deflate_predictor": enc(img, compression=8, predictor=2,
                                           tile=(16, 16)),
        "rgb_planar_lzw": enc(img, compression=5, planar=2,
                              rows_per_strip=4),
        "rgb_planar_raw": enc(img, planar=2),
        "rgb_bigtiff_deflate": enc(img, compression=8, bigtiff=True),
        "rgb_big_endian_lzw": enc(img, compression=5, byteorder=">"),
        "rgb_fill_order_2_lzw": enc(img, compression=5, fill_order=2),
        "rgb16_lzw_predictor": enc(u16, bits=16, compression=5, predictor=2),
        "rgb16_big_endian_deflate": enc(u16, bits=16, compression=8,
                                        byteorder=">"),
        "rgba_unassociated_lzw": enc(rgba, extra_samples=[2], compression=5),
        "rgba_associated_deflate": enc(rgba, extra_samples=[1],
                                       compression=8),
        "rgba_no_extra_samples_planar_tiled": enc(rgba, compression=8,
                                                  planar=2, tile=(16, 16)),
        "rgba16_associated_lzw": enc(
            np.dstack([u16, u16[..., :1]]), bits=16, extra_samples=[1],
            compression=5),
        "rgbx_raw": enc(rgba, extra_samples=[0]),
        "cmyk_lzw": enc(cmyk, photometric=5, compression=5),
        "cmyk_extra_sample_deflate": enc(np.dstack([cmyk, gray]),
                                         photometric=5, extra_samples=[0],
                                         compression=8),
        "ycbcr_jpeg_2x2": enc(img, photometric=6, compression=7,
                              segments=tiff_jpeg_segments(
                                  img, subsampling="4:2:0", quality=85),
                              ycbcr_subsampling=(2, 2)),
        "ycbcr_jpeg_2x1_strips_of_8": enc(
            img, photometric=6, compression=7, rows_per_strip=8,
            segments=tiff_jpeg_segments(img, 8, subsampling="4:2:2",
                                         quality=75),
            ycbcr_subsampling=(2, 1)),
        "ycbcr_jpeg_1x1_tiled": enc(
            img, photometric=6, compression=7, tile=(16, 16),
            segments=tiff_jpeg_segments(img, tile=(16, 16),
                                         subsampling="4:4:4", quality=90),
            ycbcr_subsampling=(1, 1)),
        "rgb_jpeg_adobe_streams": enc(
            img, photometric=2, compression=7,
            segments=tiff_jpeg_segments(img, keep_rgb=True, quality=90)),
        "rgb_jpeg_ycbcr_streams": enc(
            img, photometric=2, compression=7,
            segments=tiff_jpeg_segments(img, subsampling="4:4:4",
                                         quality=90)),
        "gray_jpeg": enc(gray, photometric=1, compression=7,
                         segments=tiff_jpeg_segments(gray, quality=80)),
        "cmyk_jpeg": enc(cmyk, photometric=5, compression=7,
                         segments=tiff_jpeg_segments(cmyk, mode="CMYK",
                                                      quality=80)),
    }
    tables, segs = tiff_jpeg_segments(img, 16, tables=True,
                                       subsampling="4:2:0", quality=70)
    out["ycbcr_jpeg_tables_strips_of_16"] = enc(
        img, photometric=6, compression=7, rows_per_strip=16, segments=segs,
        jpeg_tables=tables)
    for o in range(2, 9):
        out[f"rgb_orientation_{o}"] = enc(img, compression=5, orientation=o)
    xmp = b'<rdf:Description tiff:Orientation="6"/>'
    out["rgb_xmp_orientation_6"] = enc(img, compression=8,
                                       tags={700: (1, list(xmp))})
    # ZSTD, LZMA and CCITT (no draw from rng: the files above stay as
    # they were)
    out.update({
        "rgb_zstd": enc(img, compression=50000),
        "rgb_zstd_predictor_strips_of_8": enc(
            img, compression=50000, predictor=2, rows_per_strip=8,
            zstd=dict(level=19, checksum=True)),
        "gray_zstd_tiled_big_endian": enc(
            gray, photometric=1, compression=50000, tile=(16, 16),
            byteorder=">", zstd=dict(level=1, content_size=False)),
        "gray16_zstd_predictor_big_endian": enc(
            u16[..., 0], bits=16, photometric=1, compression=50000,
            predictor=2, byteorder=">"),
        "rgb_lzma": enc(img, compression=34925),
        "rgb_lzma_predictor_strips_of_8": enc(
            img, compression=34925, predictor=2, rows_per_strip=8,
            xz=dict(check=1, preset=9)),
        "gray_lzma_tiled_big_endian": enc(
            gray, photometric=1, compression=34925, tile=(16, 16),
            byteorder=">", xz=dict(check=10, preset=0)),
        "gray_lzma_delta": enc(gray, photometric=1, compression=34925,
                               xz=dict(filters=[{"id": 3, "dist": 1},
                                                {"id": 0x21, "preset": 6}])),
    })
    bilevel = gray > 120
    fax_modes = {"ccitt_rle": (2, {}), "ccitt_rlew": (32771, {}),
                 "group3": (3, {}), "group3_fill_bits": (3, {"options": 4}),
                 "group3_2d": (3, {"options": 1}),
                 "group3_2d_k4_fill_bits": (3, {"options": 5, "k": 4}),
                 "group4": (4, {})}
    for name, (compression, fax) in fax_modes.items():
        for fill in (1, 2):
            out[f"bilevel_{name}" + ("_fill_order_2" if fill == 2 else "")] = \
                enc(bilevel, bits=1, photometric=0, compression=compression,
                    fax=fax, fill_order=fill)
    out["bilevel_group3_rows_of_3_big_endian"] = enc(
        bilevel, bits=1, photometric=0, compression=3, rows_per_strip=3,
        byteorder=">")
    out["bilevel_group4_tiled_min_is_black"] = enc(
        bilevel, bits=1, photometric=1, compression=4, tile=(16, 16))
    return out


def tiff_cases():
    """(name, bytes) of every TIFF mode at every size."""
    rng = np.random.RandomState(18)
    return [(f"tiff_{mode}_{h}x{w}.tif", data) for h, w in SIZES
            for mode, data in tiff_modes(rng, h, w).items()]


def tiff_pillow_cases():
    """(name, bytes) of TIFF files Pillow's writer (its libtiff) makes in
    ZSTD, LZMA and CCITT Group 4."""
    rng = np.random.RandomState(19)
    img = seeded_image(rng, 6, 5)
    from PIL import Image

    def pil_tiff(mode, **kw):
        buf = io.BytesIO()
        Image.fromarray(img).convert(mode).save(buf, "TIFF", **kw)
        return buf.getvalue()

    return [("pillow_tiff_group4.tif", pil_tiff("1", compression="group4")),
            ("pillow_tiff_lzma.tif", pil_tiff("RGB", compression="lzma")),
            ("pillow_tiff_zstd.tif", pil_tiff("RGB", compression="zstd"))]


def tiff_refused_cases():
    """(name, bytes, word the NotImplementedError names) of TIFF files of
    a compression or mode the reader refuses."""
    rng = np.random.RandomState(19)
    img = seeded_image(rng, 6, 5)
    junk = dict(segments=[bytes(rng.randint(0, 256, 40).astype(np.uint8))])
    # old-style JPEG in tiles or planes: a 16x16 JPEG at
    # JPEGInterchangeFormat, every strip or tile its bytes
    big = np.zeros((32, 32, 3), np.uint8)
    jif = pil_jpeg(seeded_image(rng, 16, 16), quality=90, subsampling=0)
    # an xz stream with the x86 BCJ filter before LZMA2
    bcj = iw.xz_stream(img.tobytes(), filters=[{"id": 4}, {"id": 0x21}])
    return [
        ("refused_tiff_lzma_bcj_x86.tif", iw.encode_tiff(
            img, compression=34925, segments=[bcj]), "BCJ filter x86"),
        ("refused_tiff_webp.tif", iw.encode_tiff(img, compression=50001,
                                                 **junk), "WebP"),
        ("refused_tiff_old_style_jpeg.tif", iw.encode_tiff(
            img, compression=6, photometric=6, **junk), "old-style JPEG"),
        ("refused_tiff_thunderscan.tif", iw.encode_tiff(
            img[..., 0] >> 4, bits=4, photometric=1, compression=32809,
            **junk), "ThunderScan"),
        ("refused_tiff_sgilog.tif", iw.encode_tiff(
            img[..., 0], bits=16, photometric=1, compression=34676, **junk),
         "SGILog"),
        ("refused_tiff_lab.tif", iw.encode_tiff(img, photometric=8), "LAB"),
        ("refused_tiff_ycbcr_uncompressed.tif", iw.encode_tiff(
            img, photometric=6, ycbcr_subsampling=(1, 1)), "YCbCr"),
        ("refused_tiff_cmyk16.tif", iw.encode_tiff(
            seeded_image(rng, 6, 5, 4).astype(np.int64) * 257, bits=16,
            photometric=5, compression=5), "16-bit CMYK"),
    ] + [(f"refused_tiff_old_style_jpeg_{name}.tif", iw.encode_tiff(
        big, compression=6, photometric=6, segments=[jif] * n,
        tags={513: (4, [8]), 514: (4, [len(jif)]), 530: (3, [1, 1])}, **kw),
        "old-style JPEG in tiles or separate planes")
        for name, n, kw in (("tiles", 4, dict(tile=(16, 16))),
                            ("planar", 3, dict(planar=2)))]


# xz filter chains a TIFF's LZMA strip may hold: (name, filters before
# LZMA2); ARM64 (10) and RISC-V (11) through Pillow's liblzma
XZ_CHAINS = (("x86", [4]), ("powerpc", [5]), ("ia64", [6]), ("arm", [7]),
             ("armthumb", [8]), ("sparc", [9]), ("arm64", [10]),
             ("riscv", [11]), ("delta", [3]), ("delta_x86", [3, 4]))


def xz_chain(data: bytes, ids) -> bytes:
    """An .xz stream of `data` through the filters `ids` then LZMA2 (a
    Delta filter of distance 3): the standard library's lzma, or Pillow's
    bundled liblzma by ctypes for ARM64 and RISC-V."""
    import lzma
    if not {10, 11} & set(ids):
        return lzma.compress(data, format=lzma.FORMAT_XZ, filters=[
            {"id": i, "dist": 3} if i == 3 else {"id": i}
            for i in ids] + [{"id": lzma.FILTER_LZMA2}])
    return iw.xz_liblzma(data, ids)


def tiff_rgba_cases():
    """(name, bytes) of the TIFF modes read since libtiff's RGBA route:
    YCbCr (tests/image_writers.encode_tiff_ycbcr) at every subsampling
    tif_getimage.c puts (contiguous LZW strips, Deflate tiles, one
    PackBits strip), cosited and centred positioning, ReferenceBlackWhite
    and YCbCrCoefficients, separate planes in ZSTD strips and LZMA tiles,
    packed 2x2 read raw (uncompressed: Pillow's raw route); 16-bit CMYK
    (LZW planes, uncompressed); LAB (image_writers.rgb_to_lab: raw, LZW
    planes, big-endian Deflate tiles); ThunderScan
    (image_writers.thunder_encode, FillOrder 1 and 2); LZMA strips under
    each xz filter (xz_chain); old-style JPEG (image_writers.ojpeg_tiff
    over Pillow's JPEG: the tables tags, a restart interval a strip, and
    JPEGInterchangeFormat)."""
    rng = np.random.RandomState(23)
    img = seeded_image(rng, 9, 13)
    out = []
    for hs, vs in ((4, 4), (4, 2), (4, 1), (2, 2), (2, 1), (1, 2), (1, 1)):
        sub = f"{hs}{vs}"
        out.append((f"tiff_ycbcr_{sub}_lzw_strips.tif", iw.encode_tiff_ycbcr(
            img, (hs, vs), compression=5, rows_per_strip=4)))
        out.append((f"tiff_ycbcr_{sub}_deflate_tiles.tif",
                    iw.encode_tiff_ycbcr(img, (hs, vs), compression=8,
                                         tile=(16, 16))))
        out.append((f"tiff_ycbcr_{sub}_packbits_small.tif",
                    iw.encode_tiff_ycbcr(img[:5, :3], (hs, vs),
                                         compression=32773)))
    out += [
        ("tiff_ycbcr_22_cosited.tif", iw.encode_tiff_ycbcr(
            img, (2, 2), tags={531: (3, [2])})),
        ("tiff_ycbcr_22_centred.tif", iw.encode_tiff_ycbcr(
            img, (2, 2), tags={531: (3, [1])})),
        ("tiff_ycbcr_21_refbw_coefficients.tif", iw.encode_tiff_ycbcr(
            img, (2, 1), tags={532: (5, [(16, 1), (235, 1), (128, 1),
                                         (240, 1), (128, 1), (240, 1)]),
                               529: (5, [(2126, 10000), (7152, 10000),
                                         (722, 10000)])})),
        ("tiff_ycbcr_11_planar_zstd_strips.tif", iw.encode_tiff_ycbcr(
            img, (1, 1), planar=2, compression=50000, rows_per_strip=4)),
        ("tiff_ycbcr_11_planar_lzma_tiles.tif", iw.encode_tiff_ycbcr(
            img, (1, 1), planar=2, compression=34925, tile=(16, 16))),
        ("tiff_ycbcr_22_packed_raw.tif", iw.encode_tiff_ycbcr(
            img[:6, :4], (2, 2), compression=1)),
    ]
    cmyk = seeded_image(rng, 6, 5, 4).astype(np.int64) * 257
    out += [("tiff_cmyk16_planar_lzw.tif", iw.encode_tiff(
                cmyk, bits=16, photometric=5, compression=5, planar=2)),
            ("tiff_cmyk16_raw_be.tif", iw.encode_tiff(
                cmyk, bits=16, photometric=5, byteorder=">"))]
    pix = np.clip(np.cumsum(rng.randint(-2, 3, (7, 11)), 1) + 7, 0, 15)
    pix[:, :3] = 9
    for fill in (1, 2):
        segs = [iw.thunder_encode(pix[y:y + 4]) for y in range(0, 7, 4)]
        if fill == 2:
            segs = [iw.BITREV[np.frombuffer(x, np.uint8)].tobytes()
                    for x in segs]
        out.append((f"tiff_thunderscan_fill{fill}.tif", iw.encode_tiff(
            pix, bits=4, photometric=1 if fill == 1 else 0,
            compression=32809, rows_per_strip=4, segments=segs,
            fill_order=fill)))
    small = seeded_image(rng, 6, 5)
    for name, ids in XZ_CHAINS:
        out.append((f"tiff_lzma_{name}.tif", iw.encode_tiff(
            small, compression=34925,
            segments=[xz_chain(small.tobytes(), ids)])))
    lab = iw.rgb_to_lab(img)
    out += [("tiff_lab_raw.tif", iw.encode_tiff(lab, photometric=8)),
            ("tiff_lab_lzw_planar.tif", iw.encode_tiff(
                lab, photometric=8, compression=5, planar=2)),
            ("tiff_lab_deflate_tiles_be.tif", iw.encode_tiff(
                lab, photometric=8, compression=8, tile=(16, 16),
                byteorder=">"))]
    scene = seeded_image(rng, 24, 32)
    out += [
        ("tiff_ojpeg_tables_420.tif", iw.encode_tiff_ojpeg(scene)),
        ("tiff_ojpeg_tables_422_strips.tif", iw.encode_tiff_ojpeg(
            scene, subsampling=1, rows_per_strip=8)),
        ("tiff_ojpeg_jif_444.tif", iw.encode_tiff_ojpeg(
            scene, subsampling=0, form="jif")),
        ("tiff_ojpeg_jif_420_strips.tif", iw.encode_tiff_ojpeg(
            scene, form="jif", rows_per_strip=16)),
    ]
    return out


# ---------------------------- PPM, TGA, QOI, ICO, CUR, DIB, PCX, SGI, Sun

def _pil(img, fmt: str, mode: str = None, **kw) -> bytes:
    from PIL import Image
    im = Image.fromarray(img)
    if mode:
        im = im.convert(mode)
    buf = io.BytesIO()
    im.save(buf, fmt, **kw)
    return buf.getvalue()


def plugin_modes(rng, h, w):
    """{(extension, mode): bytes} of every mode of the small lossless
    plugins at h x w: Pillow's writer where it writes the mode, else
    tests/image_writers.py's (plain and maxval-scaled Netpbm, TGA colour
    maps, 15-bit pixels, origins and RLE Pillow does not emit, QOI's
    reference encoder, icons and cursors of DIB payloads, planar 1-bit
    and windowed PCX, DCX, SGI RLE and 16-bit grays, Sun raster)."""
    rgb = seeded_image(rng, h, w)
    rgba = seeded_image(rng, h, w, 4)
    gray = rgb[..., 0]
    bits = rng.randint(0, 2, (h, w))
    idx16 = rng.randint(0, 16, (h, w))
    idx4 = rng.randint(0, 4, (h, w))
    pal = rng.randint(0, 256, (256, 3)).astype(np.uint8)
    gray_vga = b"\x0c" + np.repeat(np.arange(256, dtype=np.uint8), 3).tobytes()
    out = {
        ("pbm", "p4"): _pil(bits.astype(bool), "PPM"),
        ("pbm", "p1"): iw.encode_ppm(bits, b"P1", rng=rng),
        ("pgm", "p5"): _pil(gray, "PPM"),
        ("pgm", "p2"): iw.encode_ppm(gray, b"P2", rng=rng),
        ("pgm", "p5_16bit"): _pil(gray.astype(np.int32) * 257, "PPM", "I"),
        ("pgm", "p5_maxval_100"): iw.encode_ppm(gray * 100 // 255, b"P5",
                                                100, rng=rng),
        ("pgm", "p2_maxval_1000"): iw.encode_ppm(
            gray.astype(np.int64) * 4 % 1001, b"P2", 1000, rng=rng),
        ("ppm", "p6"): _pil(rgb, "PPM"),
        ("ppm", "p3"): iw.encode_ppm(rgb, b"P3", rng=rng),
        ("ppm", "p6_maxval_4095"): iw.encode_ppm(
            rgb.astype(np.int64) * 16, b"P6", 4095, rng=rng),
        ("ppm", "p3_maxval_15"): iw.encode_ppm(rgb >> 4, b"P3", 15, rng=rng),
        ("ppm", "p0cmyk"): iw.encode_ppm(rgba, b"P0CMYK", rng=rng),
        ("ppm", "pycmyk"): iw.encode_ppm(rgba, b"PyCMYK", rng=rng),
        ("ppm", "pyrgba"): iw.encode_ppm(rgba, b"PyRGBA", rng=rng),
        ("ppm", "pyp"): iw.encode_ppm(gray, b"PyP", rng=rng),
        ("pfm", "little_endian"): _pil(gray.astype(np.float32) * 1.37 - 20,
                                       "PPM"),
        ("pfm", "big_endian"): iw.encode_pfm(
            gray.astype(np.float32) * 1.5 - 30, 2.5),
        ("tga", "l"): _pil(gray, "TGA"),
        ("tga", "la"): _pil(np.dstack([gray, rgb[..., 1]]), "TGA", "LA"),
        ("tga", "p"): _pil(gray, "TGA", "P"),
        ("tga", "1"): _pil(bits.astype(bool), "TGA"),
        ("tga", "rgb"): _pil(rgb, "TGA"),
        ("tga", "rgba"): _pil(rgba, "TGA"),
        ("tga", "rgb15"): iw.encode_tga(rgb, 2, 16),
        ("tga", "map16"): iw.encode_tga(idx16, 1, 8, palette=pal[:16],
                                        map_depth=16),
        ("tga", "map24_start_3"): iw.encode_tga(idx16 + 3, 1, 8,
                                                palette=pal[:16], map_start=3),
        ("tga", "l_map"): iw.encode_tga(idx4, 3, 8, palette=pal[:8]),
        ("tga", "bottom_right_id"): iw.encode_tga(
            rgb, 2, 24, top=False, right=True, id_field=b"an id field"),
        ("tga", "rle_l"): _pil(gray, "TGA", compression="tga_rle"),
        ("tga", "rle_p"): _pil(gray, "TGA", "P", compression="tga_rle"),
        ("tga", "rle_rgb"): _pil(rgb, "TGA", compression="tga_rle"),
        ("tga", "rle_rgba"): _pil(rgba, "TGA", compression="tga_rle"),
        ("tga", "rle_rgb15"): iw.encode_tga(rgb, 10, 16, rng=rng),
        ("tga", "rle_la_bottom"): iw.encode_tga(
            np.dstack([gray, gray]), 11, 16, top=False, rng=rng),
        ("tga", "rle_map24"): iw.encode_tga(idx4, 9, 8, palette=pal[:4],
                                            rng=rng),
        ("tga", "rle_rgba_bottom"): iw.encode_tga(rgba, 10, 32, top=False,
                                                  rng=rng),
        ("qoi", "rgb"): _pil(rgb, "QOI"),
        ("qoi", "rgba"): _pil(rgba, "QOI"),
        ("qoi", "rgba_linear"): iw.encode_qoi(rgba, 1),
        ("ico", "dib24"): iw.encode_ico([(iw.ico_dib(rgb, 24), w, h, 24, 0)]),
        ("ico", "dib8"): iw.encode_ico([(iw.ico_dib(gray, 8, palette=pal),
                                         w, h, 8, 0)]),
        ("ico", "dib4_mask"): iw.encode_ico([(iw.ico_dib(
            idx16, 4, palette=pal[:16], mask=bits), w, h, 4, 16)]),
        ("ico", "dib1"): iw.encode_ico([(iw.ico_dib(bits, 1, palette=pal[:2]),
                                         w, h, 1, 2)]),
        ("ico", "two_entries"): iw.encode_ico([
            (iw.ico_dib(rgb[:1, :1], 24), 1, 1, 24, 0),
            (iw.ico_dib(rgb, 24), w, h, 24, 0)]),
        ("ico", "png"): _pil(rgba, "ICO", sizes=[(w, h)]),
        ("ico", "dib32"): _pil(rgba, "ICO", sizes=[(w, h)],
                               bitmap_format="bmp"),
        ("cur", "dib24"): iw.encode_ico([(iw.ico_dib(rgb, 24), w, h, 24, 0)],
                                        kind=2),
        ("cur", "dib8"): iw.encode_ico([(iw.ico_dib(gray, 8, palette=pal),
                                         w, h, 8, 0)], kind=2),
        ("dib", "24bit"): _pil(rgb, "DIB"),
        ("dib", "8bit"): _pil(gray, "DIB", "P"),
        ("pcx", "1"): _pil(bits.astype(bool), "PCX"),
        ("pcx", "l"): _pil(gray, "PCX"),
        ("pcx", "p"): _pil(gray, "PCX", "P"),
        ("pcx", "rgb"): iw.encode_pcx(rgb, 8, 3, rng=rng),
        ("pcx", "rgb_odd_stride"): iw.encode_pcx(rgb, 8, 3, even=False,
                                                 rng=rng),
        ("pcx", "planar4"): iw.encode_pcx(idx16, 1, 4, palette=pal[:16],
                                          rng=rng),
        ("pcx", "planar2"): iw.encode_pcx(idx4, 1, 2, palette=pal[:16],
                                          rng=rng),
        ("pcx", "l_window"): iw.encode_pcx(gray, 8, 1, vga=gray_vga,
                                           window=(3, 7), rng=rng),
        ("dcx", "first_page"): iw.encode_dcx([
            iw.encode_pcx(rgb, 8, 3, rng=rng),
            iw.encode_pcx(gray, 8, 1, vga=gray_vga)]),
        ("sgi", "l"): _pil(gray, "SGI"),
        ("sgi", "rgb"): _pil(rgb, "SGI"),
        ("sgi", "rgba"): _pil(rgba, "SGI"),
        ("sgi", "rgb16"): _pil(rgb, "SGI", bpc=2),
        ("sgi", "l16"): iw.encode_sgi(gray.astype(np.int64) * 257 + 3, 2),
        ("sgi", "dimension1"): iw.encode_sgi(gray, 1, dimension=1),
        ("sgi", "rle_l"): iw.encode_sgi(gray, 1, True, rng=rng),
        ("sgi", "rle_rgb"): iw.encode_sgi(rgb, 1, True, rng=rng),
        ("sgi", "rle_rgba"): iw.encode_sgi(rgba, 1, True, rng=rng),
        ("sgi", "rle_rgb16"): iw.encode_sgi(rgb.astype(np.int64) * 251, 2,
                                            True, rng=rng),
    }
    sun = {"1": (bits, 1, 1, None), "4": (idx16, 4, 1, None),
           "8": (gray, 8, 1, None), "24": (rgb, 24, 1, None),
           "32": (rgb, 32, 1, None), "24_rgb": (rgb, 24, 3, None),
           "32_rgb": (rgb, 32, 3, None), "8_palette": (gray, 8, 1, pal),
           "4_palette": (idx16, 4, 1, pal[:16]),
           "type0": (rgb, 24, 0, None), "type4": (gray, 8, 4, None),
           "type5": (rgb, 32, 5, None), "rle_1": (bits, 1, 2, None),
           "rle_8": (gray, 8, 2, None), "rle_24": (rgb, 24, 2, None),
           "rle_32": (rgb, 32, 2, None),
           "rle_8_palette": (idx16, 8, 2, pal[:16])}
    for mode, (px, depth, kind, p) in sun.items():
        data = iw.encode_sun(px, depth, kind, palette=p, rng=rng)
        if w == 1 and struct.unpack(">I", data[16:20])[0] in (1, 4):
            # what Pillow's GBR plugin would take (plugin_refused_cases)
            data = iw.encode_sun(px, depth, kind, palette=p, rng=rng,
                                 length=0)
        out[("ras", mode)] = data
    return out


def plugin_cases():
    """(name, bytes) of every plugin mode at every size."""
    rng = np.random.RandomState(20)
    cases = []
    for h, w in SIZES:
        for (ext, mode), data in plugin_modes(rng, h, w).items():
            cases.append((f"{ext}_{mode}_{h}x{w}.{ext}", data))
    return cases


def plugin_refused_cases():
    """(name, bytes, format) of files of Pillow's plugins the port once did
    not read, one a plugin Pillow writes or whose header is a few bytes,
    and a 1x1 Sun raster whose length field Pillow's GBR plugin takes
    first (and fails on: not enough image data); of these the port now
    refuses only EPS and AVIF (STILL_REFUSED)."""
    from PIL import Image
    rng = np.random.RandomState(21)
    img = seeded_image(rng, 6, 5)
    gray = img[..., 0]
    out = [("refused_sun_gbr_1x1.ras", iw.encode_sun(img[:1, :1], 24),
            "GBR")]
    for fmt, ext, mode, kw in (
            ("IM", "im", "RGB", {}), ("SPIDER", "spi", "F", {}),
            ("MSP", "msp", "1", {}), ("XBM", "xbm", "1", {}),
            ("EPS", "eps", "RGB", {}), ("DDS", "dds", "RGB", {}),
            ("BLP", "blp", "P", {}),
            ("AVIF", "avif", "RGB", {})):
        out.append((f"refused_{ext}.{ext}", _pil(img, fmt, mode, **kw), fmt))
    icns = _pil(np.repeat(np.repeat(img, 4, 0), 4, 1)[:16, :16], "ICNS")
    out.append(("refused_icns.icns", icns, "ICNS"))
    xpm = (b'/* XPM */\nstatic char *x[] = {\n"2 1 2 1",\n'
           b'"a c #ff0000",\n"b c #00ff00",\n"ab"};\n')
    out.append(("refused_xpm.xpm", xpm, "XPM"))
    psd = (b"8BPS\x00\x01" + bytes(6) + struct.pack(">HIIHH", 3, 1, 2, 8, 3)
           + bytes(12) + bytes(6))
    out.append(("refused_psd.psd", psd, "PSD"))
    out.append(("refused_fits.fits",
                b"".join(c.ljust(80).encode() for c in (
                    "SIMPLE  = T", "BITPIX  = 8", "NAXIS   = 2",
                    "NAXIS1  = 5", "NAXIS2  = 6", "END"))
                .ljust(2880) + gray.tobytes().ljust(2880, b"\0"), "FITS"))
    assert all(Image.open(io.BytesIO(d)).format == f for _, d, f in out)
    return out


def avif_refused_cases():
    """(name, bytes, word) of byte edits of the refused AVIF that libavif's
    parse fails on: the primary item's ID (Missing or empty image item,
    which ends Image.open), the hdlr box (BMFF parsing failed, which
    passes the file on), pixi's depths (Not implemented), the file cut
    inside the meta box (Truncated data)."""
    data = (CORPUS / "refused_avif.avif").read_bytes()
    pitm = data.index(b"pitm") + 8
    hdlr = data.index(b"hdlr") + 12
    pixi = data.index(b"pixi") + 9

    def edit(at, value):
        e = bytearray(data)
        e[at] = value
        return bytes(e)

    return [("refused_avif_no_primary.avif", edit(pitm + 1, 7), "AVIF"),
            ("refused_avif_hdlr.avif", edit(hdlr, ord("v")), "AVIF"),
            ("refused_avif_pixi.avif", edit(pixi, 10), "AVIF"),
            ("refused_avif_cut.avif", data[:100], "AVIF")]


def icns_cases():
    """(name, bytes) of ICNS files (tests/image_writers.encode_icns): PNG
    entries at 1x and 2x, a JPEG 2000 entry, packed RGB (RLE and raw, it32
    with its prefix) with and without masks, and two sizes (the largest
    read)."""
    rng = np.random.RandomState(24)

    def smooth(h, w):
        yy, xx = np.mgrid[0:h, 0:w]
        return np.stack([(yy * 3 + xx) % 256, (xx * 5) % 256,
                         (255 - yy * 2) % 256], -1).astype(np.uint8)

    def flat(h, w):
        # bands of 32 equal pixels (RLE runs), a noisy corner (literals)
        yy, xx = np.mgrid[0:h, 0:w]
        img = np.stack([(yy // 4 * 9) % 256, (xx // 32 * 70) % 256,
                        np.full((h, w), 200)], -1).astype(np.uint8)
        img[:4, :6] = seeded_image(rng, 4, 6)
        return img

    return [
        ("icns_png_icp4.icns", iw.encode_icns(
            [(b"icp4", _pil(seeded_image(rng, 16, 16), "PNG"))])),
        ("icns_png_ic11_2x.icns", iw.encode_icns(
            [(b"ic11", _pil(smooth(32, 32), "PNG", "P"))])),
        ("icns_jpeg2000_ic12.icns", iw.encode_icns(
            [(b"ic12", _pil(smooth(32, 32), "JPEG2000"))])),
        ("icns_is32_rle_mask.icns", iw.encode_icns(
            [(b"is32", iw.icns_rgb(seeded_image(rng, 16, 16))),
             (b"s8mk", bytes(range(256)))])),
        ("icns_il32_raw.icns", iw.encode_icns(
            [(b"il32", iw.icns_rgb(seeded_image(rng, 32, 32), rle=False))])),
        ("icns_ih32_rle.icns", iw.encode_icns(
            [(b"ih32", iw.icns_rgb(flat(48, 48))),
             (b"h8mk", bytes(48 * 48))])),
        ("icns_it32_two_sizes.icns", iw.encode_icns(
            [(b"is32", iw.icns_rgb(smooth(16, 16))),
             (b"it32", iw.icns_rgb(flat(128, 128), prefix=True))])),
    ]


# ------------------------------------------------------------ JPEG 2000

def jpeg2000_writer():
    """tests/jpeg2000_writer.py: OpenJPEG 2.5's encoder in Pillow's
    bundled libopenjp2 by ctypes, and the JP2 box and PPT/PPM edits."""
    import jpeg2000_writer
    return jpeg2000_writer


def jpeg2000_modes(rng, h, w):
    """{(name, extension): bytes} of the JPEG 2000 layouts at h x w: Pillow's
    writer (reversible and irreversible, with and without MCT, raw J2K,
    tiles with image and tile offsets, precincts, each progression order,
    quality layers, PLT, signed samples; modes L, I;16, LA, RGB, RGBA);
    OpenJPEG's encoder by ctypes (each code-block mode switch and all six,
    SOP and EPH, POC, tile-parts by resolution, layer and component, RGN,
    subsampled components, 12-bit, signed 16-bit and mixed precisions);
    byte edits of those (packet headers in PPT and PPM markers, JP2 boxes:
    CMYK, sYCC, no colr box, a cdef box, pclr palettes of 3 and 4 columns
    for P and PA)."""
    jw = jpeg2000_writer()
    img = seeded_image(rng, h, w)
    gray = img[..., 0]
    alpha = img[..., 1]
    tiny = h * w < 4
    # OpenJPEG's encoder takes at most 1 + log2 of the smaller side levels
    levels = min(3, min(h, w).bit_length())
    # its rate allocation needs room for the packet headers: one lossless
    # layer on the smallest images
    layers = (20, 5, 1) if h * w >= 100 else (0,)
    out = {}
    pil = {"rgb": {}, "rgb_mct": {"mct": 1},
           "rgb_irreversible": {"irreversible": True},
           "rgb_irreversible_mct": {"irreversible": True, "mct": 1},
           "rgb_tiles_offsets": dict(tile_size=(8, 8), num_resolutions=2,
                                     **({} if tiny else dict(
                                         tile_offset=(1, 2), offset=(3, 5)))),
           "rgb_precincts": dict(precinct_size=(128, 128),
                                 num_resolutions=levels,
                                 codeblock_size=(16, 16)),
           "rgb_layers": dict(quality_layers=[40, 10, 1]),
           "rgb_irreversible_layers": dict(irreversible=True,
                                           quality_layers=[30, 8]),
           "rgb_plt": dict(plt=True, quality_layers=[20, 1])}
    for order in ("RLCP", "RPCL", "PCRL", "CPRL"):
        pil[f"rgb_{order.lower()}"] = dict(
            progression=order, precinct_size=(64, 64),
            num_resolutions=levels, quality_layers=[20, 5, 1])
    for name, kw in pil.items():
        out[(name, "jp2")] = _pil(img, "JPEG2000", **kw)
    out[("rgb", "j2k")] = _pil(img, "JPEG2000", no_jp2=True)
    for name, mode in (("l", "L"), ("i16", "I;16"), ("la", "LA"),
                       ("rgba", "RGBA")):
        out[(name, "jp2")] = _pil(np.dstack([img, alpha]), "JPEG2000", mode)
    out[("l_signed", "jp2")] = _pil(gray, "JPEG2000", signed=True)
    planes = [img[..., k].astype(np.int32) for k in range(3)]

    def enc(*args, **kw):
        # OpenJPEG's encoder cannot write some layouts of the smallest
        # images (its output buffer is sized by the image): those are left
        # out at that size
        try:
            return jw.encode(*args, **kw)
        except ValueError:
            return None

    def jp2(cs, *args, **kw):
        return None if cs is None else jw.jp2_file(cs, *args, **kw)

    def packed(cs, where):
        return None if cs is None else jw.packed_headers(cs, where)
    for name, bits in (("bypass", jw.BYPASS), ("reset", jw.RESET),
                       ("termall", jw.TERMALL), ("vsc", jw.VSC),
                       ("pterm", jw.PTERM), ("segsym", jw.SEGSYM),
                       ("all_switches", 63)):
        out[(name, "j2k")] = enc(planes, mode=bits, layers=layers)
    out[("all_switches_irreversible", "j2k")] = enc(
        planes, mode=63, irreversible=True, mct=True, layers=layers[1:] or layers)
    out[("sop_eph", "j2k")] = enc(planes, sop=True, eph=True,
                                  layers=layers)
    out[("poc", "j2k")] = enc(planes, layers=layers, pocs=[
        (0, 0, 2, 3, 3, "RLCP"), (0, 0, 3, 6, 3, "CPRL")])
    for part in "RLC":
        out[(f"tileparts_{part.lower()}", "j2k")] = enc(
            planes, tile=(8, 8), resolutions=2, layers=layers,
            tile_parts=part)
    out[("rgn", "j2k")] = enc(planes, roi=(0, 5), layers=layers[1:] or layers)
    tiled = enc(planes, sop=True, eph=True, tile=(8, 8), resolutions=2,
                layers=layers, tile_parts="R")
    out[("ppt", "j2k")] = packed(tiled, "ppt")
    out[("ppm", "j2k")] = packed(tiled, "ppm")
    ch, cw = -(-h // 2), -(-w // 2)
    chroma = [img[::2, ::2, k].astype(np.int32)[:ch, :cw] for k in (1, 2)]
    out[("subsampled_420", "j2k")] = enc([planes[0]] + chroma,
                                         sub=[(1, 1), (2, 2), (2, 2)],
                                         resolutions=2)
    out[("sycc_422", "jp2")] = jp2(enc(
        [planes[0]] + [img[:, ::2, k].astype(np.int32) for k in (1, 2)],
        sub=[(1, 1), (2, 1), (2, 1)], resolutions=2), h, w, 3, enumcs=18)
    g = gray.astype(np.int32)
    out[("l12", "j2k")] = enc([g * 16 + (g >> 4)], prec=[12])
    out[("l16_signed", "j2k")] = enc([g * 256 - 32768], prec=[16],
                                     signed=[True])
    out[("rgb_mixed_precision", "j2k")] = enc(
        [planes[0], planes[1] * 4, planes[2] >> 4], prec=[8, 10, 4])
    out[("cmyk", "jp2")] = jp2(enc(planes + [alpha.astype(
        np.int32)]), h, w, 4, enumcs=12)
    out[("sycc", "jp2")] = jp2(enc(planes), h, w, 3, enumcs=18)
    out[("no_colr", "jp2")] = jp2(enc(planes), h, w, 3, enumcs=None)
    out[("cdef", "jp2")] = jp2(
        enc(planes + [alpha.astype(np.int32)]), h, w, 4,
        extra=jw.cdef_box([(0, 0, 1), (1, 0, 2), (2, 0, 3), (3, 1, 0)]))
    index = (g % 9).astype(np.int32)
    entries = [(17 * k, 255 - 20 * k, (k * 53) % 256) for k in range(8)]
    entries.insert(3, entries[1])  # a repeated colour: Pillow's getcolor
    out[("p", "jp2")] = jp2(
        enc([index]), h, w, 1,
        extra=jw.pclr_box(entries, (7, 7, 7)) + jw.cmap_box(3))
    out[("pa", "jp2")] = jp2(
        enc([index, alpha.astype(np.int32)]), h, w, 2,
        extra=jw.pclr_box(entries, (7, 7, 7)) + jw.cmap_box(3))
    out[("p_rgba_palette", "jp2")] = jp2(
        enc([index]), h, w, 1, extra=jw.pclr_box(
            [e + (255 - 9 * k,) for k, e in enumerate(entries)], (7,) * 4)
        + jw.cmap_box(4))
    return {k: v for k, v in out.items() if v is not None}


def jpeg2000_cases():
    """(name, bytes) of every JPEG 2000 layout at every size."""
    rng = np.random.RandomState(22)
    cases = []
    for h, w in SIZES:
        for (name, ext), data in jpeg2000_modes(rng, h, w).items():
            cases.append((f"jp2_{name}_{h}x{w}.{ext}", data))
    return cases


def htj2k_writer():
    """tests/htj2k_writer.py: the test-only HTJ2K (Part 15) writer, numpy
    only."""
    import htj2k_writer
    return htj2k_writer


# the HTJ2K layouts of the corpus (htj2k_writer.encode's keywords, the
# image's components), each a raw codestream (.j2c); those in HTJ2K_JPH
# also as a JPH file. "rgb_refinement_layer" is the standard's layout of
# the refinement passes in a later layer, which OpenJPEG 2.5.4 reads over
# its Part-1 segment limits (the passes land in the cleanup's segment):
# Pillow's outcome on it is a digest of other pixels or an error
HTJ2K_LAYOUTS = {
    "rgb": {}, "rgb_refined": dict(refine="lossless"),
    "rgb_refined_all": dict(refine="all"),
    "rgb_sigprop": dict(refine="sigprop"),
    "rgb_vsc": dict(refine="all", style=8),
    "rgb_styles": dict(refine="lossless", style=1 | 2 | 32),
    "rgb_irreversible": dict(irreversible=True),
    "rgb_irreversible_refined": dict(irreversible=True, refine="all",
                                     step_exponent=3),
    "rgb_no_mct": dict(mct=False), "rgb_levels0": dict(levels=0),
    "rgb_levels2": dict(levels=2),
    "rgb_cblk32": dict(cblk=(32, 32), refine="lossless"),
    "rgb_cblk16": dict(cblk=(16, 16)),
    "rgb_cblk128x16": dict(cblk=(128, 16), refine="lossless"),
    "rgb_cblk8x128": dict(cblk=(8, 128)),
    "rgb_layers": dict(layers=3, layer_of="spread", refine="lossless"),
    "rgb_refinement_layer": dict(layers=2, layer_of="refinement",
                                 refine="lossless"),
    "rgb_termall_refinement_layer": dict(layers=2, layer_of="refinement",
                                         refine="lossless", style=4),
    "rgb_termall_split": dict(layers=3, layer_of="split", refine="lossless",
                              style=4),
    "rgb_rlcp": dict(progression="RLCP", layers=2, layer_of="spread"),
    "rgb_rpcl_precincts": dict(progression="RPCL", layers=2,
                               layer_of="spread", refine="lossless",
                               precincts=[(4, 4)] * 6),
    "rgb_tiles": dict(tile=(8, 8), levels=2, refine="lossless"),
    "rgb_sop_eph": dict(sop=True, eph=True, layers=2, layer_of="spread"),
    "rgb_cpf": dict(cpf=True), "l": dict(), "l_refined":
        dict(refine="lossless"), "l12": dict(prec=12),
    "l_signed": dict(signed=True), "la": dict(), "rgba": dict()}
HTJ2K_JPH = ("rgb", "rgb_refined", "rgb_irreversible", "l", "la", "rgba")


def htj2k_image(rng, h, w, layout):
    """The seeded image of an HTJ2K layout at h x w, as the writer takes
    it (its components and precision)."""
    img = seeded_image(rng, h, w, 4).astype(np.int64)
    if layout.startswith("rgba"):
        return img
    if layout.startswith("la"):
        return img[..., :2]
    if layout.startswith("l12"):
        return img[..., 0] * 16 + (img[..., 0] >> 4)
    if layout.startswith("l_signed"):
        return img[..., 0] - 128
    if layout.startswith("l"):
        return img[..., 0]
    return img[..., :3]


def htj2k_modes(rng, h, w):
    """{(name, extension): bytes} of the HTJ2K layouts at h x w."""
    hw = htj2k_writer()
    out = {}
    for layout, kw in HTJ2K_LAYOUTS.items():
        img = htj2k_image(rng, h, w, layout)
        cs = hw.encode(img, **kw)
        out[(layout, "j2c")] = cs
        if layout in HTJ2K_JPH:
            nc = 1 if img.ndim == 2 else img.shape[2]
            out[(layout, "jph")] = hw.jph_file(cs, h, w, nc,
                                               bpc=kw.get("prec", 8) - 1)
    return out


def htj2k_cases():
    """(name, bytes) of every HTJ2K layout at every size."""
    rng = np.random.RandomState(24)
    return [(f"htj2k_{name}_{h}x{w}.{ext}", data) for h, w in SIZES
            for (name, ext), data in htj2k_modes(rng, h, w).items()]


def htj2k_scene_cases(jpeg_scenes):
    """(name, bytes, source JPEG scene, what it holds) of the scenes as
    lossless HTJ2K for phase 9d's sweep and 9a's times (committed,
    `HTJ2K_SCENES`): each scene's JPEG decode in one layout: the first as
    a raw codestream (5 levels, 64x64 code-blocks, cleanup passes), the
    second as a JPH file of 256x256 tiles, 32x32 code-blocks and 64x64
    precincts in RPCL order with refinement passes, the third as a JPH
    file of three quality layers with refinement passes."""
    from PIL import Image
    hw = htj2k_writer()
    layouts = (("j2c", "ht", {}),
               ("jph", "ht_tiles_rpcl", dict(
                   tile=(256, 256), cblk=(32, 32), progression="RPCL",
                   precincts=[(6, 6)] * 6, refine="lossless")),
               ("jph", "ht_layers", dict(layers=3, layer_of="spread",
                                         refine="lossless")))
    out = []
    for (name, data, _), (ext, label, kw) in zip(jpeg_scenes, layouts):
        decoded = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        cs = hw.encode(decoded, **kw)
        if ext == "jph":
            cs = hw.jph_file(cs, *decoded.shape)
        out.append((f"{name.rsplit('.', 1)[0]}_{label}.{ext}", cs, name,
                    "same"))
    return out


def write_htj2k(index, scenes) -> None:
    """The HTJ2K files of the corpus under Pillow's outcome (a digest, or
    its error's text), the refused HT stub's outcome, and the HTJ2K scenes
    with their index."""
    for name, data in htj2k_cases():
        write_outcome(index, name, data)
    for name, data, _ in jpeg2000_refused_cases():
        write_outcome(index, name, data)
    HTJ2K_SCENES.mkdir(exist_ok=True)
    scene_index = {}
    for name, data, source, holds in htj2k_scene_cases(scenes):
        (HTJ2K_SCENES / name).write_bytes(data)
        shape, digest = pillow_digest(data)
        scene_index[name] = {"shape": shape, "sha256": digest,
                             "source": source, "pixels": holds}
    (HTJ2K_SCENES / "index.json").write_text(
        json.dumps(scene_index, indent=1) + "\n")


def _insert_marker(cs: bytes, after: int, marker: bytes) -> bytes:
    """A codestream with `marker` (a whole segment) after the main-header
    segment whose marker is `after`."""
    i = 2
    while struct.unpack(">H", cs[i:i + 2])[0] != after:
        i += 2 + struct.unpack(">H", cs[i + 2:i + 4])[0]
    i += 2 + struct.unpack(">H", cs[i + 2:i + 4])[0]
    return cs[:i] + marker + cs[i:]


def jpeg2000_refused_cases():
    """(name, bytes, word) of the JPEG 2000 parts the port refused by name
    before it read them, byte-edited from an OpenJPEG codestream: HTJ2K
    code-blocks (COD's style byte 0x40) and a Part-15 CAP marker; Part-2
    multi-component transforms (an MCT marker, a CBD marker, and
    OpenJPEG's own Part-2 stream, COD's transform byte 2, which OpenJPEG
    2.5.4 fails on)."""
    jw = jpeg2000_writer()
    rng = np.random.RandomState(23)
    img = seeded_image(rng, 6, 5)
    cs = jw.encode([img[..., k].astype(np.int32) for k in range(3)])
    cod = cs.index(b"\xff\x52")
    ht = bytearray(cs)
    ht[cod + 12] |= 0x40
    cap = b"\xff\x50\x00\x08\x00\x02\x00\x00\x00\x00"
    mct = b"\xff\x74\x00\x06\x00\x00\x00\x00"
    cbd = b"\xff\x78\x00\x07\x00\x03\x07\x07\x07"
    transform = bytearray(jw.encode(
        [img[..., k].astype(np.int32) for k in range(3)],
        custom_mct=(np.eye(3, dtype=np.float32), [128] * 3)))
    return [("refused_jp2_htj2k.j2k", bytes(ht), "HTJ2K"),
            ("refused_jp2_part2_transform.j2k", bytes(transform), "Part-2"),
            ("refused_jp2_cap.j2k", _insert_marker(cs, 0xFF51, cap), "HTJ2K"),
            ("refused_jp2_part2_mct.j2k", _insert_marker(cs, 0xFF52, mct),
             "Part-2"),
            ("refused_jp2_part2_cbd.j2k", _insert_marker(cs, 0xFF51, cbd),
             "Part-2")]


# ------------------------------------------------------ DDS, BLP and PSD

# DDS, BLP and PSD files (texture_cases), with an index of their own
# (a digest or Pillow's error each) under a size bound of their own
# (tests/test_torch_image_dds.py)
TEXTURES = CORPUS.parent / "texture_io"


def _blocks_random(rng, h, w, size):
    return rng.randint(0, 256, ((w + 3) // 4) * ((h + 3) // 4) * size) \
        .astype(np.uint8).tobytes()


def dds_modes(rng, h, w):
    """(route, bytes) of every DdsImagePlugin route at one size: Pillow's
    writer (DXT1/3/5, BC2/3/5, RGB, RGBA, L, LA), random blocks of every
    FourCC and DXGI BCn format (every 128-bit BC6H/BC7 block is input the
    decoder takes), BC7 mode 6 from the image, uncompressed RGB(A) under
    other masks (5-6-5, 10-10-10-2, a zero mask), P and R8G8B8A8."""
    rgba = seeded_image(rng, h, w, 4)
    rgb = np.ascontiguousarray(rgba[..., :3])
    dxgi = iw.DXGI
    out = []
    for fmt, mode in (("DXT1", "RGBA"), ("DXT3", "RGBA"), ("DXT5", "RGBA"),
                      ("BC2", "RGBA"), ("BC3", "RGBA"), ("BC5", "RGB")):
        out.append((f"pillow_{fmt.lower()}", _pil(rgba, "DDS", mode,
                                                  pixel_format=fmt)))
    for mode in ("RGB", "RGBA", "L", "LA"):
        out.append((f"pillow_{mode.lower()}", _pil(rgba, "DDS", mode)))
    for fourcc in (b"DXT1", b"DXT3", b"DXT5", b"BC4U", b"ATI1", b"BC5U",
                   b"ATI2", b"BC5S"):
        size = 8 if fourcc in (b"DXT1", b"BC4U", b"ATI1") else 16
        out.append((f"fourcc_{fourcc.decode().lower()}", iw.encode_dds(
            w, h, _blocks_random(rng, h, w, size), fourcc=fourcc)))
    for name in ("BC1", "BC1_TYPELESS", "BC2", "BC2_TYPELESS", "BC3",
                 "BC3_TYPELESS", "BC4", "BC4_TYPELESS", "BC5",
                 "BC5_TYPELESS", "BC5S", "BC6H", "BC6HS", "BC7",
                 "BC7_TYPELESS", "BC7_SRGB"):
        size = 8 if name.startswith(("BC1", "BC4")) else 16
        out.append((f"dx10_{name.lower()}", iw.encode_dds(
            w, h, _blocks_random(rng, h, w, size), dxgi=dxgi[name])))
    out.append(("dx10_bc7_mode6", iw.encode_dds(
        w, h, iw.bc7_mode6_encode(rgba), dxgi=dxgi["BC7"])))
    for name in ("RGBA", "RGBA_SRGB", "RGBA_TYPELESS"):
        out.append((f"dx10_{name.lower()}",
                    iw.encode_dds(w, h, rgba.tobytes(), dxgi=dxgi[name])))
    for name, bits, masks, alpha in (
            ("rgb565", 16, (0xF800, 0x7E0, 0x1F, 0), False),
            ("rgb10a2", 32, (0x3FF00000, 0xFFC00, 0x3FF, 0xC0000000), True),
            ("rgb_zero_mask", 24, (0xFF0000, 0, 0xFF, 0), False),
            ("bgr555_alpha", 16, (0x7C00, 0x3E0, 0x1F, 0x8000), True)):
        pf = iw.DDPF_RGB | (iw.DDPF_ALPHAPIXELS if alpha else 0)
        out.append((name, iw.encode_dds(
            w, h, iw.dds_mask_pixels(rgba, masks, bits), pfflags=pf,
            bitcount=bits, masks=masks)))
    palette = rng.randint(0, 256, 1024).astype(np.uint8).tobytes()
    out.append(("p", iw.encode_dds(
        w, h, rng.randint(0, 256, h * w).astype(np.uint8).tobytes(),
        pfflags=iw.DDPF_PALETTEINDEXED8, bitcount=8, palette=palette)))
    return out


def blp_modes(rng, h, w):
    """(route, bytes) of every BlpImagePlugin route at one size: BLP1 JPEG
    (RGB, grayscale, CMYK, YCCK, with alpha; the JPEG split between the
    shared header and the mip, bytes between), BLP1 and BLP2 palettes
    (with alpha; Pillow's own writer), BLP2 DXT1/3/5 with and without
    alpha (random blocks)."""
    img = seeded_image(rng, h, w, 3)
    out = []
    rgb_jpeg = _pil(img, "JPEG", "RGB", quality=90)
    cmyk_jpeg = _pil(img, "JPEG", "CMYK", quality=90)
    for name, jpeg, alpha in (
            ("blp1_jpeg", rgb_jpeg, 0), ("blp1_jpeg_alpha", rgb_jpeg, 1),
            ("blp1_jpeg_gray", _pil(img, "JPEG", "L"), 0),
            ("blp1_jpeg_cmyk", cmyk_jpeg, 0),
            ("blp1_jpeg_ycck", with_transform(cmyk_jpeg, 2), 0)):
        out.append((name, iw.blp_jpeg_file(jpeg, w, h, split=len(jpeg) // 3,
                                           gap=b"\x00gap", alpha=alpha)))
    idx = rng.randint(0, 256, (h, w)).astype(np.uint8)
    pal = rng.randint(0, 256, (256, 4)).astype(np.uint8)
    for v in (1, 2):
        out.append((f"blp{v}_palette", iw.blp_palette_file(idx, pal,
                                                           version=v)))
        out.append((f"blp{v}_palette_alpha", iw.blp_palette_file(
            idx, pal, version=v, alpha=8, encoding=5 if v == 1 else None)))
    out.append(("blp2_pillow", _pil(img, "BLP", "P")))
    for name, enc, size in (("dxt1", 0, 8), ("dxt3", 1, 16), ("dxt5", 7, 16)):
        for alpha in (0, 1):
            out.append((f"blp2_{name}" + ("_alpha" if alpha else ""),
                        iw.blp_dxt_file(_blocks_random(rng, h, w, size), w, h,
                                        alpha_encoding=enc, alpha=alpha)))
    return out


def psd_modes(rng, h, w):
    """(route, bytes) of every PsdImagePlugin mode at one size, raw and
    PackBits (packets split at random, no-op bytes): bitmap, grayscale
    (modes 0 and 1), duotone, multichannel, P with and without its
    768-byte palette, RGB, RGBA, RGB of 5 channels, CMYK of 4 and 5, LAB;
    RGB after a layer section and image resources."""
    img = seeded_image(rng, h, w, 4)
    planes = np.ascontiguousarray(img.transpose(2, 0, 1))
    pal = rng.randint(0, 256, 768).astype(np.uint8).tobytes()
    out = []
    for name, mode, c, kw in (
            ("bitmap", "1", 1, {}), ("gray", "gray", 1, {}), ("l", "L", 1, {}),
            ("duotone", "duotone", 1, {}),
            ("multichannel", "multichannel", 2, {}),
            ("p", "P", 1, {"palette": pal}), ("p_no_palette", "P", 1, {}),
            ("rgb", "RGB", 3, {}), ("rgba", "RGB", 4, {}),
            ("rgb5", "RGB", 5, {}), ("cmyk", "CMYK", 4, {}),
            ("cmyk5", "CMYK", 5, {}), ("lab", "LAB", 3, {}),
            ("rgb_layers", "RGB", 3, {"layers": True, "resources": [
                (1005, b"", b"resolution"), (1039, b"icc", b"x" * 5)]})):
        p = np.concatenate([planes] * 2)[:c]
        if mode == "1":
            p = (p > 127).astype(np.uint8)
        for comp in (0, 1):
            out.append((f"{name}_{'rle' if comp else 'raw'}", iw.encode_psd(
                p, mode, compression=comp, rng=rng if comp else None, **kw)))
    return out


def texture_cases():
    """(name, bytes) of the DDS, BLP and PSD modes at the corpus's four
    sizes."""
    out = []
    for ext, modes, seed in (("dds", dds_modes, 70), ("blp", blp_modes, 71),
                             ("psd", psd_modes, 72)):
        rng = np.random.RandomState(seed)
        for h, w in SIZES:
            for route, data in modes(rng, h, w):
                out.append((f"{ext}_{route}_{h}x{w}.{ext}", data))
    return out


def texture_error_cases():
    """(name, bytes) of DDS, BLP and PSD files Pillow fails on: cut BCn,
    raw and PackBits data, a BLP encoding, compression or alpha encoding
    it does not take, a BLP1 JPEG that is not one, a PSD of ZIP
    compression, a 16-bit RGB PSD (no mode of Pillow's)."""
    rng = np.random.RandomState(73)
    img = seeded_image(rng, 9, 7, 4)
    rgb = np.ascontiguousarray(img[..., :3])
    bc7 = iw.encode_dds(7, 9, iw.bc7_mode6_encode(img), dxgi=iw.DXGI["BC7"])
    dxt1 = _pil(img, "DDS", "RGBA", pixel_format="DXT1")
    planes = np.ascontiguousarray(img.transpose(2, 0, 1)[:3])
    psd = iw.encode_psd(planes, "RGB", compression=1)
    raw = iw.encode_psd(planes, "RGB")
    zip_at = len(raw) - planes.size - 2          # the compression word
    blocks = _blocks_random(rng, 9, 7, 16)
    return [
        ("dds_cut_bc7.dds", bc7[:-1]),
        ("dds_cut_dxt1.dds", dxt1[:140]),
        ("dds_cut_l.dds", _pil(img, "DDS", "L")[:-3]),
        ("blp_bad_blp1_encoding.blp", iw.blp_palette_file(
            img[..., 0], img.reshape(-1, 4)[:256].repeat(5, 0)[:256],
            version=1, encoding=3)),
        ("blp_blp2_raw_bgra.blp", iw.blp_dxt_file(blocks, 7, 9,
                                                  alpha_encoding=7)[:8]
         + b"\x03" + iw.blp_dxt_file(blocks, 7, 9, alpha_encoding=7)[9:]),
        ("blp_blp2_alpha_encoding_8.blp", iw.blp_dxt_file(
            blocks, 7, 9, alpha_encoding=8)),
        ("blp_cut_dxt5.blp", iw.blp_dxt_file(blocks, 7, 9,
                                             alpha_encoding=7)[:-5]),
        ("blp_jpeg_not_a_jpeg.blp", iw.blp_jpeg_file(
            b"\xff\xd8\xff\xe0" + bytes(40), 7, 9)),
        ("psd_cut_rle.psd", psd[:-2]),
        ("psd_zip.psd", raw[:zip_at] + b"\x00\x02" + raw[zip_at + 2:]),
        ("psd_rgb16.psd", iw.encode_psd(
            np.ascontiguousarray(rgb.transpose(2, 0, 1)), "RGB", bits=16)),
    ]


def write_textures() -> None:
    """The DDS, BLP and PSD files and their index (texture_io/index.json:
    "files" digests, "errors" Pillow's error texts)."""
    TEXTURES.mkdir(exist_ok=True)
    for p in TEXTURES.iterdir():
        p.unlink()
    index = {"files": {}, "errors": {}}
    for name, data in texture_cases() + texture_error_cases():
        (TEXTURES / name).write_bytes(data)
        got = pillow_outcome(data)
        if isinstance(got, str):
            index["errors"][name] = re.sub(r" <[^>]* at 0x[0-9a-f]+>", "",
                                           got)
        else:
            index["files"][name] = {"shape": got[0], "sha256": got[1]}
    (TEXTURES / "index.json").write_text(
        json.dumps(index, separators=(",", ":")) + "\n")


# ------------------------------------- IM, SPIDER, FITS and the rest

# the files of the last plugins the port reads (legacy_cases), with an
# index of their own (tests/test_torch_image_legacy.py); the Photo CD
# files are made at test time (image_writers.pcd_cases) and only their
# digests are kept ("generated")
LEGACY = CORPUS.parent / "legacy_io"


def _im_cases(rng, h, w):
    """IM files: Pillow's writer in every mode it writes, and
    image_writers.encode_im for the image types it does not (1-bit "L 1",
    2- and 4-bit palettes, Luts that make L and LA images P and PA, a grey
    non-linear Lut, RGB3 and RYB3 planes, X 24, the "L 8" to "L 32F" and
    "L*n" floats of 2 to 31 bits, "L 32 S" and "L 32 F")."""
    img = seeded_image(rng, h, w, 4)
    g = img[..., 0]
    out = []
    for mode in ("1", "L", "LA", "P", "PA", "I", "I;16", "I;16L", "I;16B",
                 "F", "RGB", "RGBA", "RGBX", "CMYK", "YCbCr"):
        from PIL import Image
        if mode in ("I", "F"):
            im = Image.fromarray(g.astype(np.int32) * 3 - 100).convert(mode)
        elif mode.startswith("I;16"):
            im = Image.frombytes(mode, (w, h), img[..., :2].tobytes())
        elif mode in ("P", "PA"):
            im = Image.fromarray(img[..., :3]).convert(
                "P", palette=Image.ADAPTIVE, colors=11).convert(mode)
        elif mode in ("1", "L"):
            im = Image.fromarray(g).convert(mode)
        elif mode == "LA":
            im = Image.fromarray(img[..., :2], "LA")
        else:
            im = Image.fromarray(img).convert(mode)
        buf = io.BytesIO()
        im.save(buf, "IM")
        out.append((f"im_pillow_{mode.replace(';', '').lower()}",
                    buf.getvalue()))
    colour = rng.randint(0, 256, 768).astype(np.uint8).tobytes()
    grey = bytes(np.tile(rng.randint(0, 256, 256).astype(np.uint8), 3))
    bits = (g > 127).astype(np.uint8)
    for name, kind, data, lut in (
            ("l1", "L 1", iw.im_rows(iw.pack_bits_msb(bits)), None),
            ("b2", "B2", iw.im_rows(rng.randint(
                0, 256, (h, (2 * w + 7) // 8)).astype(np.uint8)), None),
            ("b4", "B4", iw.im_rows(rng.randint(
                0, 256, (h, (4 * w + 7) // 8)).astype(np.uint8)), None),
            ("b4_lut", "B4", iw.im_rows(g), colour),
            ("grey_lut_colour", "Greyscale", iw.im_rows(g), colour),
            ("grey_lut_grey", "Greyscale", iw.im_rows(g), grey),
            ("la_lut", "LA", iw.im_rows(img[..., :2], True), colour),
            ("pa_lut", "PA", iw.im_rows(img[..., :2], True), colour),
            ("rgb_lut", "RGB", iw.im_rows(img[..., :3], True), colour),
            ("rgb3", "RGB3", b"".join(iw.im_rows(img[..., k])
                                      for k in range(3)), None),
            ("ryb3", "RYB3", b"".join(iw.im_rows(img[..., k])
                                      for k in range(3)), None),
            ("x24", "X 24", iw.im_rows(img[..., :3]), None),
            ("l32s_image", "L 32 S", iw.im_rows(
                g.astype("<i4") * 5 - 300), None),
            ("l32f_image", "L 32 F", iw.im_rows(
                g.astype("<u4") * 5), None)):
        out.append((f"im_{name}", iw.encode_im(kind, w, h, data, lut=lut)))
    for t, dt in (("8", "u1"), ("8S", "i1"), ("16", "<u2"), ("16S", "<i2"),
                  ("32", "<u4"), ("32F", "<f4"), ("32S", "<i4")):
        v = g.astype(np.int64) * 3 - 200
        if dt[-1] in "12" or dt in ("<u4",):
            info = np.iinfo(np.dtype(dt))
            v = np.clip(v, info.min, info.max)
        data = iw.im_rows(v.astype(dt))
        star = "*" if t != "32S" else " "
        out.append((f"im_l{t.lower()}", iw.encode_im(f"L {t}", w, h, data)))
        out.append((f"im_lstar{t.lower()}",
                    iw.encode_im(f"L{star}{t}", w, h, data)))
    for j in (2, 5, 12, 24, 31):
        data = rng.randint(0, 256, ((w * j + 7) // 8) * h).astype(
            np.uint8).tobytes()
        out.append((f"im_lstar_bits{j}", iw.encode_im(f"L*{j}", w, h, data)))
    return out


def legacy_modes(rng, h, w):
    """(route, bytes) of every route of the last plugins at one size."""
    img = seeded_image(rng, h, w, 4)
    rgb = np.ascontiguousarray(img[..., :3])
    g = img[..., 0]
    f = g.astype(np.float32) * 1.7 - 60.5
    bits = (g > 127).astype(np.uint8)
    out = _im_cases(rng, h, w)
    out.append(("spider_pillow", _pil(f, "SPIDER")))
    for big in (True, False):
        name = "be" if big else "le"
        out.append((f"spider_{name}", iw.encode_spider(f, big)))
        out.append((f"spider_{name}_stack", iw.encode_spider(f, big, True)))
    for bitpix in (8, 16, 32, -32, -64):
        v = f if bitpix < 0 else g.astype(np.int64) * (
            1 if bitpix == 8 else 300) - (0 if bitpix == 8 else 100)
        out.append((f"fits_{bitpix}".replace("-", "f"),
                    iw.encode_fits(v, bitpix)))
    for bitpix in (8, 16, 32):
        v = g.astype(np.int64) * (1 if bitpix == 8 else 300)
        out.append((f"fits_gzip_{bitpix}", iw.encode_fits(
            v, bitpix, gzip_tiles=True)))
    for size, prefix, bands in ((1, 0, 1), (1, 3, 2), (2, 4, 1), (4, 0, 3)):
        out.append((f"mcidas_{size}_{prefix}_{bands}", iw.encode_mcidas(
            g.astype(np.int64) * (1 if size == 1 else 2), size,
            prefix=prefix, bands=bands)))
    out.append(("imt", iw.encode_imt(g)))
    out.append(("xvthumb", iw.encode_xvthumb(g)))
    out.append(("pixar", iw.encode_pixar(rgb)))
    for v in (1, 2):
        out.append((f"gbr_v{v}_l", iw.encode_gbr(g, v)))
        out.append((f"gbr_v{v}_rgba", iw.encode_gbr(img, v)))
    out.append(("ftex_rgb", iw.encode_ftex(w, h, rgb.tobytes(), 1)))
    out.append(("ftex_dxt1", iw.encode_ftex(w, h, iw.bc1_encode(rgb), 0,
                                            gap=b"gap!")))
    out.append(("xbm_pillow", _pil(g, "XBM", "1")))
    out.append(("xbm_hotspot_upper", iw.encode_xbm(bits, (1, 2), True, 5)))
    for bpp, n in ((1, 6), (2, 60), (2, 300)):
        idx = rng.randint(0, n, (h, w))
        colours = rng.randint(0, 256, (n, 3)).astype(np.uint8)
        out.append((f"xpm_{bpp}_{n}", iw.encode_xpm(
            idx, colours, bpp, pixels_comment=n != 60)))
    out.append(("msp_pillow_v1", _pil(g, "MSP", "1")))
    out.append(("msp_v1", iw.encode_msp(bits, 1)))
    out.append(("msp_v2", iw.encode_msp(bits, 2, rng)))
    palette = rng.randint(0, 256, (256, 3)).astype(np.uint8)
    idx = rng.randint(0, 256, (h, w)).astype(np.uint8)
    idx[:, : w // 2] = 7                                 # runs
    out.append(("fli_brun", iw.encode_fli(w, h, [iw.fli_color(palette),
                                                 iw.fli_brun(idx)])))
    out.append(("fli_copy_color64", iw.encode_fli(w, h, [
        iw.fli_color(palette // 4, 11, ((0, 100), (20, 50))),
        iw.fli_chunk(16, idx.tobytes())], magic=0xAF11)))
    out.append(("fli_black_lc", iw.encode_fli(w, h, [
        iw.fli_color(palette), iw.fli_chunk(13, b""), iw.fli_lc(idx)])))
    out.append(("fli_ss2", iw.encode_fli(w, h, [iw.fli_color(palette),
                                                iw.fli_ss2(idx)])))
    jpeg_l = _pil(g, "JPEG", "L", quality=90)
    for name, data, kw in (
            ("raw_l", g.tobytes(), {}),
            ("raw_rgb_band1", g.tobytes(), dict(layers=3, component=1,
                                                band=1)),
            ("raw_cmyk_band3", g.tobytes(), dict(layers=4, component=1,
                                                 band=3)),
            ("jpeg_l", jpeg_l, dict(compression=5, pieces=2)),
            ("jpeg_rgb", _pil(rgb, "JPEG", quality=90), dict(compression=5)),
            ("jpeg_rgb_band2", jpeg_l, dict(compression=5, layers=3,
                                            component=1, band=2))):
        out.append((f"iptc_{name}", iw.encode_iptc(w, h, data, **kw)))
    return out


def legacy_cases():
    """(name, bytes) of the last plugins' routes at the corpus's four
    sizes."""
    rng = np.random.RandomState(75)
    out = []
    for h, w in SIZES:
        for route, data in legacy_modes(rng, h, w):
            ext = route.split("_")[0]
            out.append((f"{route}_{h}x{w}.{ext}", data))
    return out


def legacy_error_cases():
    """(name, bytes) of files of the last plugins that Pillow opens and
    fails on (and a FITS file whose data ends inside its first 80 bytes,
    which it decodes): IM raw modes it has no unpacker for (RLB, LA with
    PA;L) and
    a file cut in its data, BitDecode floats cut short, a SPIDER file
    cut, GZIP_1 FITS of BITPIX -32 (FitsGzipDecoder reads no
    bytes) and of a broken gzip member, a McIdas stride shorter than a
    row, an IM Tools header with no form feed, a GBR cut, an XPM with a
    pixel of its None colour and one with a key not in its table, an
    XBM and an MSP version 2 cut, an FLC whose prefix chunk FliDecode.c
    meets as its frame, an FLI BRUN line that overruns, an IPTC file with no
    image data field, and the stubs (BUFR, GRIB, HDF5) and
    MPEG, which Pillow opens and cannot load."""
    rng = np.random.RandomState(76)
    img = seeded_image(rng, 9, 7, 4)
    g = img[..., 0]
    bits = (g > 127).astype(np.uint8)
    palette = rng.randint(0, 256, (256, 3)).astype(np.uint8)
    gz = iw.encode_fits(g.astype(np.int64), 16, gzip_tiles=True)
    heap = gz.index(b"\x1f\x8b")
    brun = iw.fli_brun(g)
    return [
        ("im_rlb_no_unpacker.im", iw.encode_im(
            "RLB", 7, 9, iw.im_rows(img[..., :3], True))),
        ("im_pa_no_unpacker.im", iw.encode_im(
            "PA", 7, 9, iw.im_rows(img[..., :2], True))),
        ("im_cut.im", _pil(img[..., :3], "IM")[:-5]),
        ("im_bits_cut.im", iw.encode_im("L*12", 7, 9, bytes(80))),
        ("spider_cut.spi", iw.encode_spider(g.astype(np.float32))[:-3]),
        # the data ends inside its first 80 bytes: the tile starts 80
        # bytes before the end of _open's last read (Pillow decodes it)
        ("fits_cut_in_its_first_card.fits", iw.encode_fits(g, 8)[:2920]),
        ("fits_gzip_f32.fits", iw.encode_fits(g.astype(np.int64), -32,
                                              gzip_tiles=True)),
        ("fits_gzip_broken.fits", gz[:heap + 12] + b"\xff" * 9
         + gz[heap + 21:]),
        # a line prefix of -3 bytes: a stride of 4, shorter than a row,
        # the file cut so that Pillow's memory map of a path does not
        # hold the rows either (from a path as from bytes, the stride fails)
        ("mcidas_short_stride.mcidas", (iw.encode_mcidas(g, 1)[:56]
         + struct.pack(">i", -3) + iw.encode_mcidas(g, 1)[60:])[:276]),
        ("imt_no_form_feed.imt", iw.encode_imt(g).replace(b"\x0c", b"\n")),
        ("gbr_cut.gbr", iw.encode_gbr(img, 2)[:-9]),
        ("xpm_none_pixel.xpm", iw.encode_xpm(
            np.arange(63).reshape(9, 7) % 4, palette[:4], 1, none=2)),
        ("xpm_unknown_key.xpm", iw.encode_xpm(
            np.arange(63).reshape(9, 7) % 4, palette[:4], 1)
         .replace(b'"#', b'"~', 1)),
        ("xbm_cut.xbm", iw.encode_xbm(bits)[:-20]),
        ("msp_v2_cut.msp", iw.encode_msp(bits, 2)[:-3]),
        ("fli_prefix_chunk.fli", iw.encode_fli(7, 9, [
            iw.fli_color(palette), brun], prefix=True)),
        ("fli_brun_overrun.fli", iw.encode_fli(7, 9, [
            iw.fli_color(palette), brun[:7] + b"\x64" + brun[8:]])),
        ("iptc_no_image_data.iptc", iw.encode_iptc(7, 9, g.tobytes())
         .split(b"\x1c\x08\x0a")[0]),
        ("bufr_stub.bufr", b"BUFR" + bytes(60)),
        ("grib_stub.grib", b"GRIB\0\0\0\1" + bytes(60)),
        ("hdf5_stub.h5", b"\x89HDF\r\n\x1a\n" + bytes(60)),
        ("mpeg_stub.mpg", b"\0\0\1\xb3\x05\x00\x30" + bytes(40)),
    ]


def write_legacy() -> None:
    """The last plugins' files and their index (legacy_io/index.json:
    "files" digests, "errors" Pillow's error texts, "generated" the
    digests of image_writers.pcd_cases, made at test time)."""
    LEGACY.mkdir(exist_ok=True)
    for p in LEGACY.iterdir():
        p.unlink()
    index = {"files": {}, "errors": {}, "generated": {}}
    for name, data in legacy_cases() + legacy_error_cases():
        (LEGACY / name).write_bytes(data)
        got = pillow_outcome(data)
        if isinstance(got, str):
            index["errors"][name] = re.sub(r" <[^>]* at 0x[0-9a-f]+>", "",
                                           got)
        else:
            index["files"][name] = {"shape": got[0], "sha256": got[1]}
    for name, data in iw.pcd_cases():
        shape, digest = pillow_digest(data)
        index["generated"][name] = {"shape": shape, "sha256": digest}
    (LEGACY / "index.json").write_text(
        json.dumps(index, separators=(",", ":")) + "\n")


def part2_cases():
    """(name, bytes) of raw J2K codestreams with Part-2 transforms as
    OpenJPEG 2.5.4 decodes them: OpenJPEG's own MCT, MCC and MCO markers
    (opj_set_MCT: 3 and 4 components, reversible and irreversible, DC
    shifts, tiles) under COD's transform byte 0 or 1 (it fails on 2),
    whose offsets become the components' DC level shifts; the writer's
    markers of every element type (image_writers.part2_markers) over an
    OpenJPEG codestream."""
    jw = jpeg2000_writer()
    rng = np.random.RandomState(74)
    out = []
    for nc, irr, tile, cod in ((3, False, None, 0), (3, True, None, 1),
                               (4, False, (8, 8), 0), (4, True, None, 0),
                               (3, False, (8, 16), 1)):
        img = seeded_image(rng, 13, 19, 4)[..., :nc]
        matrix = rng.uniform(-1, 1, (nc, nc)).astype(np.float32)
        shift = rng.randint(-300, 300, nc)
        cs = bytearray(jw.encode([img[..., k].astype(np.int32)
                                  for k in range(nc)],
                                 custom_mct=(matrix, shift),
                                 irreversible=irr, tile=tile))
        cs[cs.index(b"\xff\x52") + 8] = cod
        name = (f"jp2_part2_opj_{nc}c_{'irrev' if irr else 'rev'}"
                f"{'_tiles' if tile else ''}_cod{cod}.j2k")
        out.append((name, bytes(cs)))
    img = seeded_image(rng, 11, 9, 3)
    cs = jw.encode([img[..., k].astype(np.int32) for k in range(3)], mct=True)
    for etype, offsets in ((0, [40000, 5, 128]), (1, [-70, 128, 100000]),
                           (2, [127.9, -3.5, 1e10]), (3, [128.0, 255.5, -1.0])):
        out.append((f"jp2_part2_offsets_type{etype}.j2k",
                    iw.with_main_header_markers(cs, iw.part2_markers(
                        3, offsets, np.eye(3), offset_type=etype,
                        matrix_type=etype))))
    out.append(("jp2_part2_no_stage.j2k", iw.with_main_header_markers(
        cs, b"\xff\x77\x00\x03\x00")))
    return out


# --------------------------------------------------------------- scenes

SCENE_CATEGORIES = [{"id": 1, "name": "person"}, {"id": 3, "name": "car"},
                    {"id": 18, "name": "dog"}, {"id": 44, "name": "bottle"}]


def scene(seed: int, h: int = 480, w: int = 640):
    """A COCO-sized synthetic photo: a graded background with texture and
    a few filled rectangles and ellipses of COCO categories. Returns
    (RGB uint8 [h, w, 3], annotations without ids)."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    bg = np.stack([90 + 60 * np.sin(yy / 57 + seed), 120 + 50 * np.cos(
        xx / 83), 100 + 40 * np.sin((xx + yy) / 131)], -1)
    bg += rng.normal(0, 6, bg.shape)
    anns = []
    for k in range(6):
        bh, bw = rng.randint(60, 200), rng.randint(60, 220)
        y1, x1 = rng.randint(0, h - bh), rng.randint(0, w - bw)
        color = rng.randint(20, 236, 3)
        cat = SCENE_CATEGORIES[k % len(SCENE_CATEGORIES)]["id"]
        if k % 2:
            cy, cx = y1 + bh / 2, x1 + bw / 2
            inside = ((yy - cy) / (bh / 2)) ** 2 + ((xx - cx) / (bw / 2)) ** 2
            mask = inside <= 1
            t = np.linspace(0, 2 * np.pi, 24, endpoint=False)
            poly = np.stack([cx + bw / 2 * np.cos(t), cy + bh / 2 * np.sin(t)],
                            1).reshape(-1)
        else:
            mask = (yy >= y1) & (yy < y1 + bh) & (xx >= x1) & (xx < x1 + bw)
            poly = np.array([x1, y1, x1 + bw, y1, x1 + bw, y1 + bh, x1,
                             y1 + bh], np.float64)
        bg[mask] = color + rng.normal(0, 10, (int(mask.sum()), 3))
        anns.append({"category_id": cat, "iscrowd": 0,
                     "bbox": [float(x1), float(y1), float(bw), float(bh)],
                     "area": float(mask.sum()),
                     "segmentation": [[round(float(v), 2) for v in poly]]})
    return np.clip(bg, 0, 255).astype(np.uint8), anns


def scene_cases():
    """(name, bytes, annotations) of the three 640x480 scenes."""
    out = []
    for name, seed, kw in (
            ("scene_baseline_420.jpg", 1, dict(quality=85)),
            ("scene_baseline_444.jpg", 2, dict(quality=80,
                                                subsampling="4:4:4")),
            ("scene_progressive.jpg", 3, dict(quality=85,
                                               progressive=True))):
        img, anns = scene(seed)
        out.append((name, pil_jpeg(img, **kw), anns))
    return out


def format_scene_cases(jpeg_scenes):
    """(name, bytes, source JPEG scene) of the scenes as WebP: the three
    scenes' arrays as lossy WebP (q80), and the first JPEG scene's Pillow
    decode as lossless WebP (its pixels, so its detections, are the JPEG
    file's)."""
    from PIL import Image
    out = []
    for (name, _, _), seed in zip(jpeg_scenes, (1, 2, 3)):
        img, _ = scene(seed)
        out.append((name.rsplit(".", 1)[0] + "_q80.webp",
                    pil_bytes(img, "WEBP", quality=80), name))
    first, data, _ = jpeg_scenes[0]
    decoded = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    out.append((first.rsplit(".", 1)[0] + "_lossless.webp",
                pil_bytes(decoded, "WEBP", lossless=True), first))
    return out


def tiff_scene_cases(jpeg_scenes):
    """(name, bytes, source JPEG scene) of the first JPEG scene's Pillow
    decode as TIFF with predictor 2 by Pillow's writer (its libtiff,
    strips of 34 rows): ZSTD and LZMA. The card cannot write these (no
    Pillow, and chip_smoke.py loads no lzma), so they are committed,
    beside the corpus (`TIFF_SCENES`), for phase 9d's sweeps and 9a's
    times; their pixels, so their detections, are the JPEG file's."""
    from PIL import Image
    first, data, _ = jpeg_scenes[0]
    decoded = Image.open(io.BytesIO(data)).convert("RGB")
    stem = first.rsplit(".", 1)[0]
    out = []
    for comp in ("zstd", "lzma"):
        buf = io.BytesIO()
        decoded.save(buf, "TIFF", compression=comp, tiffinfo={317: 2})
        out.append((f"{stem}_{comp}_predictor.tif", buf.getvalue(), first))
    return out


def jpeg_scene_cases(jpeg_scenes):
    """(name, bytes, source JPEG scene, what it holds) of the scenes in the
    JPEG modes read natively since arithmetic coding and lossless frames:
    each scene's coefficients re-coded arithmetic sequential and
    progressive (jpegtran -arithmetic: the JPEG file's pixels), the first
    scene's Pillow decode as lossless JPEG with predictors 1 and 7 (RGB,
    point transform 0: its pixels), and the first scene re-coded
    progressive without its last two scans (block-smoothed: other
    pixels). The card cannot write these (no libjpeg), so they are
    committed (`JPEG_SCENES`) for phase 9d's sweep and 9a's times."""
    from PIL import Image
    jm = jpeg_modes()
    out = []
    for name, data, _ in jpeg_scenes:
        stem = name.rsplit(".", 1)[0]
        out.append((f"{stem}_arith.jpg", jm.transcode(data), name, "same"))
        out.append((f"{stem}_arith_progressive.jpg",
                    jm.transcode(data, progressive=True), name, "same"))
    first, data, _ = jpeg_scenes[0]
    stem = first.rsplit(".", 1)[0]
    decoded = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    for psv in (1, 7):
        out.append((f"{stem}_lossless_p{psv}.jpg",
                    jm.write(decoded, predictor=psv, space=jm.RGB), first,
                    "same"))
    progressive = jm.transcode(data, arith=False, progressive=True)
    out.append((f"{stem}_smoothed.jpg", drop_scan(drop_scan(progressive, -1),
                                                  -1), first, "smoothed"))
    return out


def refused_jp2_case():
    """(name, bytes) of the JPEG 2000 file the corpus held among Pillow's
    formats the port refused (plugin_refused_cases' seeded image as
    Pillow's RGB JP2), now decoded to its digest."""
    rng = np.random.RandomState(21)
    return "refused_jp2.jp2", _pil(seeded_image(rng, 6, 5), "JPEG2000", "RGB")


def jpeg2000_scene_cases(jpeg_scenes):
    """(name, bytes, source JPEG scene, what it holds) of the scenes as
    JPEG 2000 for phase 9d's sweep and 9a's times (committed,
    `JPEG2000_SCENES`): each scene's JPEG decode written reversibly in
    one layout (its pixels): the first as Pillow's default JP2, the
    second as a raw J2K codestream with 256x256 tiles and 64x64 precincts
    in RPCL order, the third as a JP2 of three quality layers (the last
    lossless) with PLT markers; and the first scene's decode as an
    irreversible JP2 at rate 8 (other pixels, timed only)."""
    from PIL import Image
    layouts = (("jp2", {}), ("j2k", dict(no_jp2=True, tile_size=(256, 256),
                                          precinct_size=(64, 64),
                                          progression="RPCL")),
               ("jp2", dict(quality_layers=[40, 10, 1], plt=True)))
    names = ("default", "tiles_rpcl", "layers_plt")
    out = []
    for (name, data, _), (ext, kw), label in zip(jpeg_scenes, layouts, names):
        decoded = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        stem = name.rsplit(".", 1)[0]
        out.append((f"{stem}_{label}.{ext}", _pil(decoded, "JPEG2000", **kw),
                    name, "same"))
    first, data, _ = jpeg_scenes[0]
    decoded = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    out.append((first.rsplit(".", 1)[0] + "_irreversible.jp2",
                _pil(decoded, "JPEG2000", irreversible=True,
                     quality_layers=[8]), first, "irreversible"))
    return out


def pillow_outcome(data: bytes):
    """(shape, digest) of Pillow's decode, or the text of its error."""
    try:
        return pillow_digest(data)
    except Exception as e:  # noqa: BLE001 - any error is Pillow's outcome
        return f"{type(e).__name__}: {e}"


def pillow_digest(data: bytes):
    from PIL import Image
    img = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    return list(img.shape[:2]), hashlib.sha256(img.tobytes()).hexdigest()


def time_pillow(reps: int = 5, jpeg2000_only: bool = False) -> None:
    """Pillow's `np.asarray(Image.open(f).convert("RGB"))` of the files
    tools/image_decode_bench_torch.py times (with `jpeg2000_only`, of its
    scenes as HTJ2K and as Part-1 JPEG 2000 alone), host ms, median of
    reps."""
    from PIL import Image

    from tools import image_decode_bench_torch as bench
    files = {name: (bench.REPO / name).read_bytes() for name in bench.TIMED}
    files.update(bench.format_scenes())
    if jpeg2000_only:
        files = {name: data for name, data in files.items()
                 if (HTJ2K_SCENES / name).exists()
                 or (JPEG2000_SCENES / name).exists()}
    for name, data in files.items():
        ms = bench.median_ms(lambda: np.asarray(Image.open(io.BytesIO(
            data)).convert("RGB")), reps)
        print(f"{name}: pillow_ms {ms:.2f}", flush=True)


def write_jpeg2000(index, scenes) -> None:
    """The JPEG 2000 files of the corpus and their index entries, and the
    JPEG 2000 scenes with theirs."""
    for name, data in jpeg2000_cases() + [refused_jp2_case()]:
        (CORPUS / name).write_bytes(data)
        shape, digest = pillow_digest(data)
        index["files"][name] = {"shape": shape, "sha256": digest}
        index["refused"].pop(name, None)
    for name, data, _ in jpeg2000_refused_cases():
        write_outcome(index, name, data)
    JPEG2000_SCENES.mkdir(exist_ok=True)
    scene_index = {}
    for name, data, source, holds in jpeg2000_scene_cases(scenes):
        (JPEG2000_SCENES / name).write_bytes(data)
        shape, digest = pillow_digest(data)
        scene_index[name] = {"shape": shape, "sha256": digest,
                             "source": source, "pixels": holds}
    (JPEG2000_SCENES / "index.json").write_text(
        json.dumps(scene_index, indent=1) + "\n")


# ------------------------------------------------------------------ AVIF

# the scenes as AVIF (avif_scene_cases), under a size bound of their own
# (test_avif_scenes_are_whole_and_small)
AVIF_SCENES = CORPUS.parent / "avif_scenes"
# the AV1 tables of the port's AV1 decoder (tests/av1_libaom.py)
AV1_TABLES = (Path(__file__).resolve().parent.parent / "maskrcnn_tpu_torch"
              / "csrc" / "av1_tables.h")
# aom options Pillow's writer passes (advanced=), one corpus file each
AVIF_TOOLS = (("qm", {"enable-qm": "1"}),
              ("qm_levels", {"enable-qm": "1", "qm-min": "0", "qm-max": "8"}),
              ("no_cdef", {"enable-cdef": "0"}),
              ("cdef", {"enable-cdef": "1"}),
              ("restoration", {"enable-restoration": "1"}),
              ("no_restoration", {"enable-restoration": "0"}),
              ("chroma_deltaq", {"enable-chroma-deltaq": "1"}),
              ("deltaq3", {"deltaq-mode": "3"}),
              ("aq1", {"aq-mode": "1"}),
              ("palette", {"enable-palette": "1"}),
              ("no_filter_intra", {"enable-filter-intra": "0"}),
              ("no_smooth", {"enable-smooth-intra": "0"}),
              ("no_paeth", {"enable-paeth-intra": "0"}),
              ("no_cfl", {"enable-cfl-intra": "0"}),
              ("no_tx64", {"enable-tx64": "0"}),
              ("no_rect", {"enable-rect-partitions": "0"}),
              ("ab_partitions", {"enable-ab-partitions": "1"}),
              ("partitions_1to4", {"enable-1to4-partitions": "1"}),
              ("sb128", {"sb-size": "128"}),
              ("reduced_tx_set", {"reduced-tx-type-set": "1"}),
              ("no_angle_delta", {"enable-angle-delta": "0"}),
              ("no_edge_filter", {"enable-intra-edge-filter": "0"}),
              ("sharpness7", {"sharpness": "7"}),
              ("lossless", {"lossless": "1"}),
              ("no_directional", {"enable-directional-intra": "0"}),
              ("tune_ssim", {"tune": "ssim"}))


def avif_cases():
    """(name, bytes) of Pillow's AVIF files: the encoder's settings
    (quality 0, 50, 75 and 100, speed 0, 6 and 10, 4:0:0, 4:2:0, 4:2:2
    and 4:4:4, full and limited range, one tile and 2x2 tiles in one tile
    group or two, alpha straight and premultiplied, an image sequence's
    first frame, CDEF at speed 0 on a crop of the first scene), the
    aom tools AVIF_TOOLS switches, sizes 1x1, 5x3 and 37x53; and two
    files of OpenCV's libaom encoder (tests/av1_libaom.encode_av1) in a
    container of tests/avif_writer: a full (not reduced) sequence header,
    a 4:2:0 frame of profile 0."""
    from PIL import Image

    import av1_libaom
    import avif_writer
    rng = np.random.RandomState(25)
    small = seeded_image(rng, 53, 37)
    region = seeded_image(rng, 64, 96)
    wide = seeded_image(rng, 144, 176)
    rgba = seeded_image(rng, 40, 56, 4)
    out = []
    for q in (0, 50, 75, 100):
        out.append((f"avif_q{q}.avif", _pil(small, "AVIF", quality=q)))
    for speed in (0, 10):
        out.append((f"avif_speed{speed}.avif",
                    _pil(small, "AVIF", speed=speed)))
    # aom's all-intra encoder turns CDEF off unless asked: at speed 0 with
    # it, on a crop of the first scene (seeded images draw strength 0),
    # CDEF beside loop restoration
    scene = _decoded((CORPUS / "scene_baseline_420.jpg").read_bytes())
    out.append(("avif_speed0_cdef.avif", _pil(
        np.ascontiguousarray(scene[300:428, 100:228]), "AVIF", speed=0,
        advanced={"enable-cdef": "1"})))
    for sub in ("4:0:0", "4:2:2", "4:4:4"):
        out.append((f"avif_{sub.replace(':', '')}.avif",
                    _pil(small, "AVIF", subsampling=sub)))
    out.append(("avif_limited.avif", _pil(small, "AVIF", range="limited")))
    out.append(("avif_limited_444.avif", _pil(small, "AVIF", range="limited",
                                              subsampling="4:4:4")))
    out.append(("avif_gray.avif", _pil(small, "AVIF", "L")))
    out.append(("avif_tiles_2x2.avif", _pil(wide, "AVIF", tile_rows=1,
                                            tile_cols=1, autotiling=False)))
    # a frame header OBU and two tile group OBUs
    out.append(("avif_tile_groups.avif", _pil(
        wide, "AVIF", tile_rows=1, tile_cols=1, autotiling=False,
        advanced={"num-tile-groups": "2"})))
    out.append(("avif_rgba.avif", _pil(rgba, "AVIF", "RGBA")))
    out.append(("avif_rgba_premultiplied.avif",
                _pil(rgba, "AVIF", "RGBA", alpha_premultiplied=True)))
    out.append(("avif_rgba_444_q40.avif", _pil(rgba, "AVIF", "RGBA",
                                               subsampling="4:4:4",
                                               quality=40)))
    for name, opts in AVIF_TOOLS:
        out.append((f"avif_tool_{name}.avif",
                    _pil(region, "AVIF", advanced=opts)))
    out.append(("avif_1x1.avif", _pil(np.full((1, 1, 3), 77, np.uint8),
                                      "AVIF")))
    out.append(("avif_5x3.avif", _pil(seeded_image(rng, 3, 5), "AVIF")))
    out.append(("avif_37x53.avif", _pil(small, "AVIF", quality=90)))
    frames = [Image.fromarray(seeded_image(rng, 24, 40)) for _ in range(3)]
    buf = io.BytesIO()
    frames[0].save(buf, "AVIF", save_all=True, append_images=frames[1:])
    out.append(("avif_sequence.avif", buf.getvalue()))
    yuv = [rng.randint(0, 256, (32, 48)).astype(np.uint8),
           rng.randint(0, 256, (16, 24)).astype(np.uint8),
           rng.randint(0, 256, (16, 24)).astype(np.uint8)]
    if av1_libaom.libaom_path() is not None:
        out.append(("avif_libaom_good_quality.avif", avif_writer.container(
            av1_libaom.encode_av1(yuv), 48, 32)))
    return out


def avif_refused_cases_av1():
    """(name, bytes, word) of AVIF files Pillow decodes that the port
    refuses by name: 10-bit and 12-bit data and superres (OpenCV's libaom
    encoder in tests/avif_writer.container), a grid item (libavif's
    encoder), film grain and IntraBC (Pillow's writer: film-grain-test,
    tune-content=screen on a screen-like image)."""
    import av1_libaom
    import avif_writer
    rng = np.random.RandomState(26)
    y = rng.randint(0, 256, (32, 48)).astype(np.uint16)
    c = rng.randint(0, 256, (16, 24)).astype(np.uint16)
    out = []
    if av1_libaom.libaom_path() is not None:
        out.append(("refused_avif_10bit.avif", avif_writer.container(
            av1_libaom.encode_av1([y * 4, c * 4, c * 4], depth=10), 48, 32,
            depth=10), "10-bit"))
        out.append(("refused_avif_12bit.avif", avif_writer.container(
            av1_libaom.encode_av1([y * 16, c * 16, c * 16], depth=12,
                                  profile=2), 48, 32, depth=12, profile=2),
            "12-bit"))
        out.append(("refused_avif_superres.avif", avif_writer.container(
            av1_libaom.encode_av1([y.astype(np.uint8), c.astype(np.uint8),
                                   c.astype(np.uint8)],
                                  superres_denominator=16), 48, 32),
            "superres"))
    cell_y = rng.randint(0, 256, (64, 64)).astype(np.uint8)
    cell_c = rng.randint(0, 256, (32, 32)).astype(np.uint8)
    out.append(("refused_avif_grid.avif", avif_writer.encode_grid(
        [[cell_y, cell_c, cell_c]] * 2, 2, 1), "grid"))
    region = seeded_image(rng, 64, 96)
    out.append(("refused_avif_film_grain.avif", _pil(
        region, "AVIF", advanced={"film-grain-test": "1"}), "film grain"))
    # a four-colour 16x16 pattern repeated, a white bar across it: aom's
    # screen-content search copies blocks (IntraBC)
    t = rng.randint(0, 4, (16, 16))
    pal = np.array([[255, 255, 255], [0, 0, 0], [200, 0, 0], [0, 0, 200]],
                   np.uint8)
    screen = np.tile(pal[t], (6, 10, 1))
    screen[40:60, 30:90] = 255
    out.append(("refused_avif_intrabc.avif", _pil(
        screen, "AVIF", advanced={"tune-content": "screen"}), "IntraBC"))
    return out


def avif_scene_cases(scenes):
    """(name, bytes, source) of the three scenes as AVIF at Pillow's
    defaults, and the first at speed 0 (self-guided restoration), at
    speed 0, quality 60, 4:4:4 (Wiener and self-guided units; seeded
    images draw no Wiener unit from aom) and at speed 0 with CDEF on
    (aom's all-intra default is off) (chip_smoke.py's phases 9a and 9d
    read them)."""
    out = []
    for k, (name, data, _) in enumerate(scenes):
        img = _decoded(data)
        stem = name.rsplit(".", 1)[0]
        out.append((f"{stem}.avif", _pil(img, "AVIF"), name))
        if k == 0:
            out.append((f"{stem}_speed0.avif", _pil(img, "AVIF", speed=0),
                        name))
            out.append((f"{stem}_speed0_q60_444.avif",
                        _pil(img, "AVIF", speed=0, quality=60,
                             subsampling="4:4:4"), name))
            out.append((f"{stem}_speed0_cdef.avif",
                        _pil(img, "AVIF", speed=0,
                             advanced={"enable-cdef": "1"}), name))
    return out


def _decoded(data: bytes):
    from PIL import Image
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def write_avif(index, scenes) -> None:
    """The AVIF files of the corpus and their index entries (the refusals
    under Pillow's outcome), and the AVIF scenes with theirs."""
    for name, data in avif_cases():
        (CORPUS / name).write_bytes(data)
        shape, digest = pillow_digest(data)
        index["files"][name] = {"shape": shape, "sha256": digest}
    for name, data, _ in avif_refused_cases_av1():
        write_outcome(index, name, data)
    for name, data, _ in avif_refused_cases():
        write_outcome(index, name, data)
    write_outcome(index, "refused_avif.avif",
                  (CORPUS / "refused_avif.avif").read_bytes())
    AVIF_SCENES.mkdir(exist_ok=True)
    scene_index = {}
    for name, data, source in avif_scene_cases(scenes):
        (AVIF_SCENES / name).write_bytes(data)
        shape, digest = pillow_digest(data)
        scene_index[name] = {"shape": shape, "sha256": digest,
                             "source": source}
    (AVIF_SCENES / "index.json").write_text(
        json.dumps(scene_index, indent=1) + "\n")


# the files of Pillow's formats and modes the port does not read, by name
# (their NotImplementedError's word); every other file the refused cases
# make is decoded to its digest, or is one Pillow fails on ("errors"). A
# few of these are stubs Pillow fails on too, of a format the port does
# not read: their refusal names the format or mode first
STILL_REFUSED = {
    "refused_tiff_old_style_jpeg_tiles.tif": "old-style JPEG in tiles",
    "refused_tiff_old_style_jpeg_planar.tif": "old-style JPEG in tiles",
    "refused_eps.eps": "EPS", "refused_avif_10bit.avif": "10-bit",
    "refused_avif_12bit.avif": "12-bit",
    "refused_avif_superres.avif": "superres",
    "refused_avif_grid.avif": "grid",
    "refused_avif_film_grain.avif": "film grain",
    "refused_avif_intrabc.avif": "IntraBC"}


def lab_clut() -> bytes:
    """LittleCMS 2.17's LAB -> sRGB table as Pillow's convert("RGB") of a
    LAB image uses it (data/lab_srgb_clut.zlib, zlib of 33³ x 3 uint16,
    little-endian, L slowest): Pillow's bundled liblcms2 by ctypes, the
    transform ImageCms.buildTransform makes (cmsCreateLab2Profile(NULL),
    cmsCreate_sRGBProfile, perceptual) at 16 bits and unoptimized,
    evaluated at the node inputs OptimizeByResampling samples
    (_cmsQuantizeVal: i * 65535 / 32 rounded): its CLUT's nodes."""
    import ctypes
    import glob
    import os

    import PIL
    libs = os.path.join(os.path.dirname(os.path.dirname(PIL.__file__)),
                        "pillow.libs")
    lib = ctypes.CDLL(glob.glob(os.path.join(libs, "liblcms2*"))[0])
    vp = ctypes.c_void_p
    lib.cmsCreateLab2Profile.restype = vp
    lib.cmsCreate_sRGBProfile.restype = vp
    lib.cmsCreateTransform.restype = vp
    lib.cmsCreateTransform.argtypes = [vp, ctypes.c_uint32, vp,
                                       ctypes.c_uint32, ctypes.c_uint32,
                                       ctypes.c_uint32]
    lib.cmsDoTransform.argtypes = [vp, vp, vp, ctypes.c_uint32]
    lab16 = (10 << 16) | (3 << 3) | 2          # TYPE_Lab_16
    rgb16 = (4 << 16) | (3 << 3) | 2           # TYPE_RGB_16
    noopt = 0x0100                             # cmsFLAGS_NOOPTIMIZE
    xform = lib.cmsCreateTransform(lib.cmsCreateLab2Profile(None), lab16,
                                   lib.cmsCreate_sRGBProfile(), rgb16, 0,
                                   noopt)
    nodes = [int(np.floor(i * 65535 / 32 + 0.5)) for i in range(33)]
    grid = np.array(np.meshgrid(nodes, nodes, nodes, indexing="ij"))
    inp = np.ascontiguousarray(grid.reshape(3, -1).T, np.uint16)
    out = np.zeros_like(inp)
    lib.cmsDoTransform(xform, inp.ctypes.data, out.ctypes.data, len(inp))
    return zlib.compress(out.astype("<u2").tobytes(), 9)


BCN_TABLES = (Path(__file__).resolve().parent.parent / "maskrcnn_tpu_torch"
              / "csrc" / "bcn_tables.h")


def bcn_tables() -> str:
    """The BC6H/BC7 partition and anchor tables as Pillow's bcn decoder
    holds them, read off its decode of crafted BC7 blocks (the C header
    csrc/bcn_tables.h). One block a partition: mode 1 (two subsets) or
    mode 2 (three), every endpoint 0 but the second one of subset 1 (red
    at its maximum) and of subset 2 (green), every index bit 1; a texel
    of subset 1 is then red, of subset 2 green, of subset 0 black, and the
    anchor of a subset, whose index is a bit shorter, is darker (weight 27
    or 21 of 64 where the others have 64)."""
    from PIL import Image
    tables = {}
    for mode, ns in ((1, 2), (2, 3)):
        blocks = []
        for part in range(64):
            if mode == 1:
                f = [(0b10, 2), (part, 6)]
                f += [(63 if (ch == 0 and e == 3) else 0, 6)
                      for ch in range(3) for e in range(4)]
                f += [(0, 1), (1, 1), ((1 << 46) - 1, 46)]
            else:
                f = [(0b100, 3), (part, 6)]
                f += [(31 if (ch, e) in ((0, 3), (1, 5)) else 0, 5)
                      for ch in range(3) for e in range(6)]
                f += [((1 << 29) - 1, 29)]
            blocks.append(iw.pack_bits(f))
        dds = iw.encode_dds(256, 4, b"".join(blocks), dxgi=iw.DXGI["BC7"])
        px = np.asarray(Image.open(io.BytesIO(dds)).convert("RGB"))
        subsets, anchors = [], [[], []]
        for part in range(64):
            blk = px[:, 4 * part:4 * part + 4].reshape(16, 3).astype(int)
            sub = [(1 if t[0] else 2 if t[1] else 0) for t in blk]
            assert sub[0] == 0
            subsets.append(sum(s << (ns - 1) * i for i, s in enumerate(sub)))
            for k in range(1, ns):
                dark = [i for i in range(16)
                        if sub[i] == k and 0 < blk[i][k - 1] < 255]
                assert len(dark) == 1, (mode, part, k, blk.tolist())
                anchors[k - 1].append(dark[0])
        tables[ns] = subsets, anchors

    def rows(values, fmt, per):
        items = [fmt.format(v) for v in values]
        return ",\n".join("    " + ", ".join(items[i:i + per])
                           for i in range(0, len(items), per))

    p2, (a2, _) = tables[2]
    p3, (a3a, a3b) = tables[3]
    return "\n".join([
        "// The BC6H and BC7 partition and anchor tables as Pillow 12.1's bcn",
        "// decoder holds them, read off its decode of crafted BC7 blocks: written",
        "// by `python tests/image_corpus.py --bcn-tables`; do not edit.",
        "#pragma once", "", "#include <cstdint>", "", "namespace mrt {", "",
        "// two subsets: bit n of a partition's entry is texel n's subset",
        "inline constexpr uint16_t kBcPartition2[64] = {",
        rows(p2, "0x{:04x}", 8) + "};", "",
        "// three subsets: bits 2n, 2n + 1 are texel n's subset",
        "inline constexpr uint32_t kBcPartition3[64] = {",
        rows(p3, "0x{:08x}", 6) + "};", "",
        "// the anchor texel of subset 1 of two, of subsets 1 and 2 of three",
        "inline constexpr uint8_t kBcAnchor2[64] = {",
        rows(a2, "{}", 16) + "};",
        "inline constexpr uint8_t kBcAnchor3a[64] = {",
        rows(a3a, "{}", 16) + "};",
        "inline constexpr uint8_t kBcAnchor3b[64] = {",
        rows(a3b, "{}", 16) + "};", "", "}  // namespace mrt", ""])


HTJ2K_TABLES = (Path(__file__).resolve().parent.parent / "maskrcnn_tpu_torch"
                / "csrc" / "htj2k_tables.h")


def openjpeg_library() -> Path:
    """Pillow's bundled libopenjp2 (OpenJPEG 2.5.4)."""
    import glob
    import os

    import PIL
    libs = os.path.join(os.path.dirname(os.path.dirname(PIL.__file__)),
                        "pillow.libs")
    return Path(sorted(glob.glob(os.path.join(libs,
                                              "libopenjp2-*.so.2.5.4")))[0])


def _vlc_table_at(data: bytes, off: int):
    """The 1,024 little-endian uint16 at `off` where they are an HT VLC
    decoding table (ht_dec.c's layout: c_q << 7 | 7 bits of the stream),
    else None: every entry's codeword length (its low 3 bits) is 1-7 and
    every entry equals the entry at its index masked to that length (a
    prefix code in each of the 8 contexts), e_k within rho and e_1 within
    e_k, and context 0 has no insignificant quad (there the MEL codes
    one)."""
    t = np.frombuffer(data[off:off + 2048], "<u2").astype(np.int64)
    length = t & 7
    if (length == 0).any():
        return None
    idx = np.arange(1024)
    if not (t == t[(idx & ~127) | (idx & ((1 << length) - 1))]).all():
        return None
    rho, e_1, e_k = (t >> 4) & 15, (t >> 8) & 15, (t >> 12) & 15
    if (e_k & ~rho).any() or (e_1 & ~e_k).any() or (rho[:128] == 0).any():
        return None
    return t.astype(np.uint16)


def htj2k_tables() -> str:
    """OpenJPEG 2.5.4's HT VLC tables (ht_dec.c's vlc_tbl0 and vlc_tbl1)
    as Pillow's bundled libopenjp2 holds them: the two tables its .rodata
    holds, found by their structure (_vlc_table_at) in a scan of the
    library file, the first not overlapping the second; the header
    csrc/htj2k_tables.h."""
    data = openjpeg_library().read_bytes()
    tables, off = [], 0
    while off + 2048 <= len(data) and len(tables) < 3:
        t = _vlc_table_at(data, off)
        if t is None:
            off += 2
            continue
        tables.append(t)
        off += 2048
    assert len(tables) == 2, f"{len(tables)} HT VLC tables in the library"

    def rows(values):
        items = [f"0x{int(v):04x}" for v in values]
        return ",\n".join("    " + ", ".join(items[i:i + 8])
                          for i in range(0, len(items), 8))

    return "\n".join([
        "// OpenJPEG 2.5.4's HT VLC decoding tables (ht_dec.c's vlc_tbl0 for the",
        "// initial row of quads, vlc_tbl1 for the others), read off Pillow's",
        "// bundled libopenjp2: written by `python tests/image_corpus.py",
        "// --htj2k-tables`; do not edit. Index: c_q << 7 | the next 7 bits of the",
        "// VLC stream; entry: bits 0-2 the codeword's length, 3 u_off, 4-7 rho,",
        "// 8-11 e_1, 12-15 e_k.",
        "#pragma once", "", "#include <cstdint>", "", "namespace mrt {", "",
        "inline constexpr uint16_t kHtVlcTable0[1024] = {",
        rows(tables[0]) + "};", "",
        "inline constexpr uint16_t kHtVlcTable1[1024] = {",
        rows(tables[1]) + "};", "", "}  // namespace mrt", ""])


def lab_table_digest() -> str:
    """SHA-256 of Pillow's convert("RGB") of every LAB pixel (L, a + 128,
    b + 128 in the image, L slowest): the RGB bytes of all 2**24."""
    from PIL import Image
    v = np.arange(256, dtype=np.uint8)
    L, A, B = np.meshgrid(v, v, v, indexing="ij")
    # the image's a and b are the raw bytes' xor 128 (ImagingUnpackLAB)
    raw = np.stack([L, A ^ 128, B ^ 128], -1)
    im = Image.frombytes("LAB", (4096, 4096), raw.tobytes())
    return hashlib.sha256(np.asarray(im.convert("RGB")).tobytes()).hexdigest()


def write_outcome(index, name: str, data: bytes) -> None:
    """A file made as a refusal, under Pillow's outcome: "refused"
    (STILL_REFUSED), its digest, or its error's text ("errors")."""
    (CORPUS / name).write_bytes(data)
    for key in ("files", "refused", "errors"):
        index[key].pop(name, None)
    if name in STILL_REFUSED:
        index["refused"][name] = STILL_REFUSED[name]
        return
    got = pillow_outcome(data)
    if isinstance(got, str):
        # (the text without the file object's address)
        index["errors"][name] = re.sub(r" <[^>]* at 0x[0-9a-f]+>", "", got)
    else:
        index["files"][name] = {"shape": got[0], "sha256": got[1]}


def write_outcomes(index) -> None:
    """The files made as refusals (refused_cases, format_refused_cases,
    tiff_refused_cases, plugin_refused_cases, avif_refused_cases), each
    under Pillow's outcome (write_outcome)."""
    for name, data, _ in (refused_cases() + format_refused_cases()
                          + tiff_refused_cases() + plugin_refused_cases()):
        write_outcome(index, name, data)
    for name, data, _ in avif_refused_cases():
        write_outcome(index, name, data)


def write_textures_slice(index) -> None:
    """The DDS, BLP and PSD files (write_textures), the Part-2 JPEG 2000
    files and every refusal under Pillow's outcome; every other file and
    entry kept."""
    write_textures()
    for name, data in part2_cases():
        (CORPUS / name).write_bytes(data)
        shape, digest = pillow_digest(data)
        index["files"][name] = {"shape": shape, "sha256": digest}
    write_outcomes(index)
    for name, data, _ in jpeg2000_refused_cases():
        write_outcome(index, name, data)


def write_slice(index) -> None:
    """The TIFF modes of libtiff's RGBA route and the rest, the ICNS files
    (their index entries), and the refusals (the JPEG 2000 ones too) under
    Pillow's outcome; every other file and entry kept."""
    for name, data in tiff_rgba_cases() + icns_cases():
        (CORPUS / name).write_bytes(data)
        shape, digest = pillow_digest(data)
        index["files"][name] = {"shape": shape, "sha256": digest}
    write_outcomes(index)
    for name, data, _ in jpeg2000_refused_cases():
        write_outcome(index, name, data)


LAB_CLUT = (Path(__file__).resolve().parent.parent / "maskrcnn_tpu_torch"
            / "data" / "lab_srgb_clut.zlib")


def main() -> int:
    if "--av1-tables" in sys.argv[1:]:
        import av1_libaom
        AV1_TABLES.write_text(av1_libaom.header(av1_libaom.read_tables()))
        print(f"{AV1_TABLES}: written from {av1_libaom.libaom_path().name}")
        return 0
    if "--avif" in sys.argv[1:]:
        # the AVIF files alone, every other file and entry kept
        index = json.loads(INDEX.read_text())
        scenes = [(name, (CORPUS / name).read_bytes(), None)
                  for name in index["scenes"]]
        write_avif(index, scenes)
        INDEX.write_text(json.dumps(index, separators=(",", ":")) + "\n")
        return 0
    if "--bcn-tables" in sys.argv[1:]:
        BCN_TABLES.write_text(bcn_tables())
        print(f"{BCN_TABLES}: written from Pillow's bcn decoder")
        return 0
    if "--htj2k-tables" in sys.argv[1:]:
        HTJ2K_TABLES.write_text(htj2k_tables())
        print(f"{HTJ2K_TABLES}: written from {openjpeg_library().name}")
        return 0
    if "--lab-clut" in sys.argv[1:]:
        LAB_CLUT.write_bytes(lab_clut())
        print(f"{LAB_CLUT}: all 2**24 LAB pixels through Pillow: "
              f"{lab_table_digest()}")
        return 0
    if "--textures" in sys.argv[1:]:
        index = json.loads(INDEX.read_text())
        write_textures_slice(index)
        INDEX.write_text(json.dumps(index, separators=(",", ":")) + "\n")
        return 0
    if "--legacy" in sys.argv[1:]:
        write_legacy()
        return 0
    if "--rgba-icns" in sys.argv[1:]:
        index = json.loads(INDEX.read_text())
        write_slice(index)
        INDEX.write_text(json.dumps(index, separators=(",", ":")) + "\n")
        return 0
    if "--time-pillow" in sys.argv[1:]:
        time_pillow()
        return 0
    if "--time-htj2k" in sys.argv[1:]:
        time_pillow(7, jpeg2000_only=True)
        return 0
    if "--htj2k" in sys.argv[1:]:
        # the HTJ2K files alone, every other file and entry kept
        index = json.loads(INDEX.read_text())
        scenes = [(name, (CORPUS / name).read_bytes(), None)
                  for name in index["scenes"]]
        write_htj2k(index, scenes)
        INDEX.write_text(json.dumps(index, separators=(",", ":")) + "\n")
        return 0
    if "--jpeg2000" in sys.argv[1:]:
        # the JPEG 2000 files alone, every other file and entry kept
        index = json.loads(INDEX.read_text())
        scenes = [(name, (CORPUS / name).read_bytes(), None)
                  for name in index["scenes"]]
        write_jpeg2000(index, scenes)
        INDEX.write_text(json.dumps(index, separators=(",", ":")) + "\n")
        return 0
    CORPUS.mkdir(parents=True, exist_ok=True)
    index = {"files": {}, "refused": {}, "errors": {}, "scenes": {},
             "format_scenes": {}}
    for name, data in (jpeg_cases() + png_cases() + format_cases()
                       + tiff_cases() + tiff_pillow_cases()
                       + plugin_cases() + jpeg_mode_cases()
                       + tiff_rgba_cases() + icns_cases()):
        (CORPUS / name).write_bytes(data)
        shape, digest = pillow_digest(data)
        index["files"][name] = {"shape": shape, "sha256": digest}
    # "errors": files Pillow raises on (its error's text), which the port
    # raises on too
    for name, data in jpeg_outcome_cases():
        (CORPUS / name).write_bytes(data)
        got = pillow_outcome(data)
        if isinstance(got, str):
            index["errors"][name] = got
        else:
            index["files"][name] = {"shape": got[0], "sha256": got[1]}
    write_outcomes(index)
    scenes = scene_cases()
    for name, data, anns in scenes:
        (CORPUS / name).write_bytes(data)
        shape, digest = pillow_digest(data)
        index["files"][name] = {"shape": shape, "sha256": digest}
        index["scenes"][name] = anns
    # "format_scenes": each WebP scene's JPEG scene (its annotations)
    for name, data, source in format_scene_cases(scenes):
        (CORPUS / name).write_bytes(data)
        shape, digest = pillow_digest(data)
        index["files"][name] = {"shape": shape, "sha256": digest}
        index["format_scenes"][name] = source
    index["categories"] = SCENE_CATEGORIES
    write_jpeg2000(index, scenes)
    write_htj2k(index, scenes)
    write_textures_slice(index)
    write_legacy()
    write_avif(index, scenes)
    INDEX.write_text(json.dumps(index, separators=(",", ":")) + "\n")
    TIFF_SCENES.mkdir(exist_ok=True)
    scene_index = {}
    for name, data, source in tiff_scene_cases(scenes):
        (TIFF_SCENES / name).write_bytes(data)
        shape, digest = pillow_digest(data)
        scene_index[name] = {"shape": shape, "sha256": digest,
                             "source": source}
    (TIFF_SCENES / "index.json").write_text(
        json.dumps(scene_index, indent=1) + "\n")
    JPEG_SCENES.mkdir(exist_ok=True)
    scene_index = {}
    for name, data, source, holds in jpeg_scene_cases(scenes):
        (JPEG_SCENES / name).write_bytes(data)
        shape, digest = pillow_digest(data)
        scene_index[name] = {"shape": shape, "sha256": digest,
                             "source": source, "pixels": holds}
    (JPEG_SCENES / "index.json").write_text(
        json.dumps(scene_index, indent=1) + "\n")
    size = sum(p.stat().st_size for p in CORPUS.iterdir())
    print(f"{len(list(CORPUS.iterdir()))} files, {size} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
