"""The TIFF modes Pillow 12.1.0 reads through libtiff 4.7.1's RGBA
interface (tif_getimage.c: YCbCr that is not contiguous JPEG, and
old-style JPEG, tif_ojpeg.c, over libjpeg-turbo 3.1.3) and the last
modes of the port's TIFF reader (LAB through LittleCMS 2.17's transform
as Pillow converts it, 16-bit CMYK, ThunderScan, every xz filter of an
LZMA strip, a tile wider than 2**24 pixels), against live
Pillow: seeded files written here and their single-byte edits give
Pillow's outcome, its pixels or an error (a ValueError here).

YCbCr files come from tests/image_writers.encode_tiff_ycbcr (packed
blocks of every subsampling tif_getimage.c puts, or separate planes),
old-style JPEG from image_writers.encode_tiff_ojpeg (Pillow's baseline
JPEG split into the tables tags, or whole at JPEGInterchangeFormat),
ThunderScan from image_writers.thunder_encode, xz streams with the ARM64
and RISC-V filters from Pillow's bundled liblzma by ctypes
(image_writers.xz_liblzma)."""

import io
import struct
import sys
import warnings
import zlib
from pathlib import Path

import numpy as np
import pytest

from maskrcnn_tpu_torch.data import image_io

pytest.importorskip("PIL")
from PIL import Image  # noqa: E402

TESTS = Path(__file__).resolve().parent
sys.path.insert(0, str(TESTS))

import image_corpus as ic  # noqa: E402
import image_writers as iw  # noqa: E402

SUBSAMPLINGS = ((4, 4), (4, 2), (4, 1), (2, 2), (2, 1), (1, 2), (1, 1))


def outcome(read, data: bytes):
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return read(data)
    except Exception as e:  # noqa: BLE001 - any error is Pillow's outcome
        return e


def pillow(data: bytes):
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def same_outcome(data: bytes) -> str:
    """'' where the port gives Pillow's outcome, else what differs."""
    want, got = outcome(pillow, data), outcome(image_io.read_image, data)
    if isinstance(want, Exception):
        return "" if isinstance(got, ValueError) else \
            f"Pillow raised {want!r}, the port gave {got!r}"
    if isinstance(got, Exception):
        return f"Pillow read it, the port raised {got!r}"
    if got.shape != want.shape or not np.array_equal(got, want):
        return f"{int((got != want).any(-1).sum())} pixels differ"
    return ""


def edits(data: bytes, seed: int, count: int):
    """`count` copies of `data`, each with one byte set at random."""
    rng = np.random.RandomState(seed)
    for _ in range(count):
        b = bytearray(data)
        b[rng.randint(len(b))] = rng.randint(256)
        yield bytes(b)


# ----------------------------------------------------- YCbCr through RGBA

@pytest.mark.parametrize("hs,vs", SUBSAMPLINGS)
def test_ycbcr_subsampling_layouts_equal_pillow(hs, vs):
    """Each subsampling tif_getimage.c puts, at sizes its blocks do not
    divide (its edge blocks, the 4x4 put's skip of a tile's right edge in
    4x2 blocks), in one strip, strips of 3 and 4 rows, 16x16 tiles, under
    LZW, Deflate, PackBits, ZSTD and LZMA; and separate planes, which
    libtiff puts at 1x1 only."""
    rng = np.random.RandomState(hs * 10 + vs)
    for h, w in ((1, 1), (5, 3), (9, 13), (17, 33)):
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        for comp, kw in ((5, {}), (8, {"rows_per_strip": 3}),
                         (32773, {"rows_per_strip": 4}),
                         (50000, {"tile": (16, 16)}),
                         (34925, {"tile": (16, 16)})):
            data = iw.encode_tiff_ycbcr(img, (hs, vs), compression=comp, **kw)
            assert not same_outcome(data), (h, w, comp, kw, same_outcome(data))
        data = iw.encode_tiff_ycbcr(img, (hs, vs), planar=2, compression=8,
                                    rows_per_strip=2)
        assert not same_outcome(data), (h, w, "planar", same_outcome(data))


def test_ycbcr_conversion_tags_orientation_and_byte_order_equal_pillow():
    """tif_color.c's tables from ReferenceBlackWhite and YCbCrCoefficients
    as rationals, floats, doubles and shorts (a wrong count dropped, a
    green coefficient of 0 refused), libtiff's defaults, a missing
    YCbCrSubsampling (2x2), subsampling libtiff refuses, Orientation 1-8
    (the raster is not turned; Pillow's exif_transpose turns the image),
    big-endian files and a predictor."""
    rng = np.random.RandomState(5)
    img = rng.randint(0, 256, (11, 13, 3)).astype(np.uint8)
    tagsets = [
        {532: (5, [(16, 1), (235, 1), (128, 1), (240, 1), (128, 1),
                   (240, 1)])},
        {532: (5, [(1, 3), (2551, 10), (127, 1), (255, 1), (0, 1), (256, 1)]),
         529: (5, [(2126, 10000), (7152, 10000), (722, 10000)])},
        {532: (5, [(0, 0)] * 6)},
        {529: (5, [(1, 3), (0, 1), (1, 3)])},
        {532: (11, [0.5, 250.25, 128.0, 255.0, 127.5, 254.0])},
        {532: (12, [1.0, 254.0, 128.0, 255.0, 128.0, 255.0])},
        {532: (3, [10, 255, 128, 255, 128])},
        {530: (3, [3, 1])}, {530: (3, [2, 4])},
    ]
    files = [iw.encode_tiff_ycbcr(img, (2, 2), tags=t) for t in tagsets]
    files.append(iw.encode_tiff_ycbcr(img, (2, 2), omit=[530]))
    files += [iw.encode_tiff_ycbcr(img, (4, 2), orientation=o,
                                   rows_per_strip=4) for o in range(1, 9)]
    files += [iw.encode_tiff_ycbcr(img, (2, 1), byteorder=">",
                                   compression=c) for c in (5, 50000)]
    files.append(iw.encode_tiff_ycbcr(img, (2, 2), compression=8,
                                      predictor=2))
    for k, data in enumerate(files):
        assert not same_outcome(data), (k, same_outcome(data))


def test_ycbcr_byte_edits_give_pillows_outcome():
    """Single-byte edits of YCbCr files (packed strips, packed tiles,
    separate planes): tif_getimage.c goes on past a strip its codec fails
    on with what the buffer holds, and a strip or tile it cannot fill ends
    the decode where it is the block's first read."""
    rng = np.random.RandomState(6)
    img = rng.randint(0, 256, (11, 13, 3)).astype(np.uint8)
    bases = [iw.encode_tiff_ycbcr(img, (2, 2), rows_per_strip=4),
             iw.encode_tiff_ycbcr(img, (4, 2), tile=(16, 16), compression=8),
             iw.encode_tiff_ycbcr(img, (1, 1), planar=2, rows_per_strip=5,
                                  compression=32773)]
    for k, base in enumerate(bases):
        for data in edits(base, k, 120):
            assert not same_outcome(data), (k, same_outcome(data))


# ------------------------------------------------------- old-style JPEG

@pytest.mark.parametrize("form", ["tables", "jif"])
def test_old_style_jpeg_equals_pillow(form):
    """Both forms (the tables tags, JPEGInterchangeFormat) at 4:4:4, 4:2:2
    and 4:2:0, one strip or strips a restart interval each, at sizes the
    MCUs do not divide; the photometric tag missing or RGB (read as
    YCbCr), SamplesPerPixel or BitsPerSample missing, a YCbCrSubsampling
    that differs from the stream's (the stream's counts), no
    StripByteCounts (the tables form's strips then cannot be read), the
    tables missing, no JPEGProc."""
    rng = np.random.RandomState(7)
    for h, w in ((8, 8), (37, 53), (64, 40)):
        img = np.clip(ic.seeded_image(rng, h, w).astype(int), 0, 255)
        img = img.astype(np.uint8)
        for sub in (0, 1, 2):
            for rps in (None, 16 if sub else 8):
                if rps and rps >= h:
                    continue
                data = iw.encode_tiff_ojpeg(img, form=form, subsampling=sub,
                                            rows_per_strip=rps)
                assert not same_outcome(data), (h, w, sub, rps,
                                                same_outcome(data))
    img = ic.seeded_image(rng, 32, 48)
    variants = [dict(photometric=2), dict(omit=[262]), dict(omit=[277]),
                dict(omit=[258]), dict(omit=[279]), dict(omit=[512]),
                dict(omit=[519]), dict(tags={530: (3, [1, 1])}),
                dict(tags={274: (3, [6])}), dict(photometric=1)]
    for kw in variants:
        data = iw.encode_tiff_ojpeg(img, form=form, **kw)
        assert not same_outcome(data), (kw, same_outcome(data))


def test_old_style_jpeg_byte_edits_give_pillows_outcome():
    """Single-byte edits of both forms, in one strip and in strips: a
    table libjpeg refuses ends the decode; a restart marker out of turn
    is an error under tif_ojpeg.c's source (its resync_to_restart fails),
    after which the next strip cannot start; an image taller than the
    stream's frame repeats libjpeg's last raw iMCU row."""
    rng = np.random.RandomState(8)
    img = ic.seeded_image(rng, 32, 48)
    bases = [iw.encode_tiff_ojpeg(img, form="tables", subsampling=2,
                                  rows_per_strip=16),
             iw.encode_tiff_ojpeg(img, form="jif", subsampling=0,
                                  rows_per_strip=8),
             iw.encode_tiff_ojpeg(img, form="tables", subsampling=1)]
    for k, base in enumerate(bases):
        for data in edits(base, 10 + k, 100):
            assert not same_outcome(data), (k, same_outcome(data))
    # ImageLength past the frame's 16-bit height
    base = iw.encode_tiff_ojpeg(img, subsampling=0)
    ifd = struct.unpack("<I", base[4:8])[0]
    tall = bytearray(base)
    tall[ifd + 2 + 12 + 10] = 1
    assert not same_outcome(bytes(tall))


def test_old_style_jpeg_without_tables_is_pillows_failure():
    """The corpus's old-style JPEG file without its tables fails in Pillow
    ("Missing JPEG tables"), and here with a ValueError."""
    data = (ic.CORPUS / "refused_tiff_old_style_jpeg.tif").read_bytes()
    assert isinstance(outcome(pillow, data), Exception)
    with pytest.raises(ValueError, match="old-style JPEG"):
        image_io.read_image(data)


# -------------------------------------------------------------------- LAB

# SHA-256 of Pillow 12.1.0's convert("RGB") of all 2**24 LAB pixels (the
# image's L, a + 128, b + 128; L slowest), computed once by
# `python tests/image_corpus.py --lab-clut` (2 s of Pillow's time)
LAB_TABLE_SHA256 = "f1ae0609778284fb45d7ac0f0ab7e164dae97539e23c975eef6fd284ccf16101"


def test_lab_conversion_of_every_pixel_equals_pillows_digest():
    """Every one of the 2**24 LAB pixels through the port's LittleCMS
    evaluation (csrc/image_decode.cpp lab_to_rgb over the committed CLUT,
    data/lab_srgb_clut.zlib) gives Pillow's RGB, held to the digest; and
    the committed CLUT is the one Pillow's liblcms2 samples."""
    import hashlib

    from maskrcnn_tpu_torch.data import native_image
    v = np.arange(256, dtype=np.uint8)
    lab = np.stack(np.meshgrid(v, v, v, indexing="ij"), -1)
    rgb = native_image.lab_to_rgb(lab)
    assert hashlib.sha256(rgb.tobytes()).hexdigest() == LAB_TABLE_SHA256
    assert zlib.decompress(ic.lab_clut()) == zlib.decompress(
        native_image.LAB_CLUT.read_bytes())


def test_lab_files_and_byte_edits_equal_pillow():
    """LAB TIFF (Pillow's LAB unpack: a* and b* signed; planes copied as
    they are) raw, LZW, Deflate tiles, separate planes raw and compressed,
    big-endian, with a predictor, and byte edits of them."""
    rng = np.random.RandomState(12)
    for h, w in ((1, 1), (5, 3), (9, 13), (17, 33)):
        lab = iw.rgb_to_lab(ic.seeded_image(rng, h, w))
        lab[0, 0] = (200, 130, 250)
        files = [iw.encode_tiff(lab, photometric=8),
                 iw.encode_tiff(lab, photometric=8, compression=5),
                 iw.encode_tiff(lab, photometric=8, compression=8,
                                tile=(16, 16), byteorder=">"),
                 iw.encode_tiff(lab, photometric=8, planar=2),
                 iw.encode_tiff(lab, photometric=8, planar=2, compression=5),
                 iw.encode_tiff(lab, photometric=8, compression=8,
                                predictor=2)]
        for k, data in enumerate(files):
            assert not same_outcome(data), (h, w, k, same_outcome(data))
    for k, data in enumerate(files[:2] + files[4:5]):
        for edited in edits(data, 30 + k, 40):
            assert not same_outcome(edited), (k, same_outcome(edited))


# --------------------------------------- CMYK16, ThunderScan, xz, big tiles

def test_cmyk16_and_thunderscan_equal_pillow():
    """16-bit CMYK (both byte orders, uncompressed and LZW, contiguous and
    planar) and ThunderScan (tif_thunder.c: runs, 2- and 3-bit deltas, raw
    pixels; strips; FillOrder 2; photometric 0 and 1), their byte edits,
    and a ThunderScan row of too many or too few pixels."""
    rng = np.random.RandomState(9)
    cmyk = ic.seeded_image(rng, 7, 9, 4).astype(np.int64) * 257 + 3
    files = [iw.encode_tiff(cmyk, bits=16, photometric=5, compression=c,
                            planar=p, byteorder=bo)
             for c in (1, 5) for p in (1, 2) for bo in ("<", ">")]
    for h, w in ((1, 1), (6, 5), (17, 33)):
        pix = np.clip(np.cumsum(rng.randint(-2, 3, (h, w)), 1) + 7, 0, 15)
        pix[:, : w // 3] = 9
        for photo, rps, fill in ((1, None, 1), (0, 2, 2)):
            segs = [iw.thunder_encode(pix[y:y + (rps or h)])
                    for y in range(0, h, rps or h)]
            if fill == 2:
                segs = [iw.BITREV[np.frombuffer(x, np.uint8)].tobytes()
                        for x in segs]
            files.append(iw.encode_tiff(pix, bits=4, photometric=photo,
                                        compression=32809,
                                        rows_per_strip=rps, segments=segs,
                                        fill_order=fill))
    pix = np.full((2, 5), 3)
    files.append(iw.encode_tiff(pix, bits=4, compression=32809,
                                segments=[bytes([0xC3] * 12)]))
    files.append(iw.encode_tiff(pix, bits=4, compression=32809,
                                segments=[bytes([0xC3] * 3)]))
    for k, data in enumerate(files):
        assert not same_outcome(data), (k, same_outcome(data))
    for k, data in enumerate(files[:2] + files[8:10]):
        for edited in edits(data, 20 + k, 40):
            assert not same_outcome(edited), (k, same_outcome(edited))


@pytest.mark.parametrize("name,ids", ic.XZ_CHAINS)
def test_xz_filter_chains_equal_pillow(name, ids):
    """Each BCJ filter and Delta in an LZMA strip decodes as liblzma 5.8.2
    decodes it (a strip of several LZMA2 chunks, the filters converting
    past the strip's end as far as they look ahead), with a start offset
    where the filter takes one (through Pillow's liblzma)."""
    rng = np.random.RandomState(len(name))
    img = rng.randint(0, 256, (61, 67, 3)).astype(np.uint8)
    flat = img.reshape(-1)
    for v in (0xE8, 0xE9, 0xEB, 0xF0, 0xF8, 0x48, 0x40, 0x7F, 0x94, 0x90,
              0xEF, 0x17, 0x97, 0x25):
        flat[rng.rand(flat.size) < 0.03] = v
    data = iw.encode_tiff(img, compression=34925,
                          segments=[ic.xz_chain(img.tobytes(), ids)])
    assert not same_outcome(data), same_outcome(data)
    if ids != [3]:
        start = iw.xz_liblzma(img.tobytes(), ids, start=256)
        data = iw.encode_tiff(img, compression=34925, segments=[start])
        assert not same_outcome(data), same_outcome(data)


def test_tile_wider_than_2_24_pixels_gives_pillows_outcome():
    """An 8x8 image in a tile of 2**24 + 16 columns or rows (libtiff takes
    it; its Deflate data runs out, as in Pillow), and uncompressed (Pillow's
    own raw reading)."""
    img = np.zeros((8, 8, 3), np.uint8)
    for tw, th in (((1 << 24) + 16, 16), (16, (1 << 24) + 16)):
        for comp, seg in ((8, zlib.compress(bytes(4096))), (1, bytes(4096))):
            data = iw.encode_tiff(img, compression=comp, segments=[seg],
                                  tile=(16, 16),
                                  tags={322: (4, [tw]), 323: (4, [th])})
            assert not same_outcome(data), (tw, th, comp, same_outcome(data))
