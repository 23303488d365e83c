"""The port's TIFF reader (csrc/image_decode.cpp through
data/native_image.py, what `image_io.read_image` runs) against Pillow
12.1.0 over libtiff 4.7.1, libjpeg-turbo 3.1.3 and zlib: every TIFF mode
of the committed corpus at every size decodes to its digest (the digests
chip_smoke.py's phase 9a holds the card's host to) and every refused
file names its mode; seeded files made here (tests/image_writers.py's
`encode_tiff`, Pillow's own TIFF writer and JPEG streams) give Pillow's
live outcome, pixels or an error: every mode, compression, predictor,
byte order, layout (strips, tiles, planes), FillOrder, orientation and
JPEG colour case, and broken strip tables; a file read from its path
gives what Pillow gives from the path (its memory map of uncompressed
files); the C++ inflate equals zlib.decompress; decoder threads give one
thread's arrays; the JAX package's CocoDataset reads a COCO directory of
the scenes as TIFF as the port's does. ZSTD, LZMA and CCITT:
tests/test_torch_image_tiff_codecs.py."""

import hashlib
import importlib.util
import io
import json
import re
import subprocess
import sys
import warnings
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest

from maskrcnn_tpu_torch.data import image_io, native_image

TESTS = Path(__file__).resolve().parent
REPO = TESTS.parent
sys.path.insert(0, str(TESTS))

import image_corpus as ic  # noqa: E402
import image_writers as iw  # noqa: E402

INDEX = json.loads(ic.INDEX.read_text())
SIZE = re.compile(r"^tiff_(.+)_(\d+)x(\d+)\.tif$")
# every TIFF mode of the corpus: {mode: [files]}
MODES = {}
for _name in INDEX["files"]:
    if SIZE.match(_name):
        MODES.setdefault(SIZE.match(_name).group(1), []).append(_name)
REFUSED = {n: w for n, w in INDEX["refused"].items() if n.endswith(".tif")}


def digest(img: np.ndarray) -> str:
    return hashlib.sha256(img.tobytes()).hexdigest()


def outcome(read, data: bytes):
    """read(data), or the exception it raised."""
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return read(data)
    except Exception as e:  # noqa: BLE001 - any error is Pillow's outcome
        return e


def pillow(data: bytes):
    from PIL import Image
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def assert_like_pillow(data: bytes, what: str = "") -> None:
    """The native decode equals Pillow's, or both raise (the native
    route a ValueError: a file Pillow fails on is corrupt to it)."""
    want, got = outcome(pillow, data), outcome(image_io.read_image, data)
    if isinstance(want, Exception):
        assert isinstance(got, ValueError), f"{what}: Pillow raised {want!r}, " \
            f"the port gave {got if isinstance(got, Exception) else got.shape}"
        return
    assert not isinstance(got, Exception), f"{what}: {got!r}"
    assert got.shape == want.shape, what
    assert np.array_equal(got, want), (
        f"{what}: {int((got != want).any(-1).sum())} pixels differ")


@pytest.mark.parametrize("mode", sorted(MODES))
def test_corpus_mode_at_every_size_equals_its_digest(mode):
    """Each TIFF mode's files (1x1, 5x3, 37x53 and 16x24) decode natively
    to their Pillow digests, without Pillow."""
    names = MODES[mode]
    sizes = {tuple(map(int, SIZE.match(n).groups()[1:])) for n in names}
    assert sizes == set(ic.SIZES), sizes
    for name in names:
        img = image_io.read_image(ic.CORPUS / name)
        entry = INDEX["files"][name]
        assert list(img.shape) == entry["shape"] + [3], name
        assert digest(img) == entry["sha256"], name


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_corpus_refused_file_names_its_mode(name):
    """Old-style JPEG in tiles or separate planes raises
    NotImplementedError naming the mode."""
    with pytest.raises(NotImplementedError, match=re.escape(REFUSED[name])):
        image_io.read_image(ic.CORPUS / name)


def test_corpus_covers_the_tiff_modes():
    """Every compression the reader takes (ZSTD, LZMA and each CCITT mode
    among them), both predictors, tiles, planes, BigTIFF, FillOrder 2,
    both byte orders, JPEG with tables and each YCbCr subsampling, and
    orientations 2-8 (and XMP's) are in the corpus, Pillow's own ZSTD,
    LZMA and Group 4 files are read to their digests, and the files once
    refused decode to their digests or, where Pillow fails, raise
    ValueError; old-style JPEG in tiles or planes alone is refused by
    name."""
    joined = " ".join(MODES)
    for part in ("raw", "packbits", "lzw", "lzw_old_style", "deflate",
                 "32946", "jpeg", "predictor", "predictor3", "tiled",
                 "planar", "bigtiff", "fill_order_2", "big_endian",
                 "jpeg_tables", "2x2", "2x1", "1x1", "xmp_orientation",
                 "zstd", "zstd_predictor", "lzma", "lzma_delta",
                 "ccitt_rle", "ccitt_rlew", "group3", "group3_2d",
                 "group3_fill_bits", "group4", "group4_tiled"):
        assert part in joined, part
    assert {f"rgb_orientation_{o}" for o in range(2, 9)} <= set(MODES)
    assert {f"pillow_tiff_{c}.tif" for c in ("group4", "lzma", "zstd")} \
        <= set(INDEX["files"])
    assert set(REFUSED) == {"refused_tiff_old_style_jpeg_tiles.tif",
                            "refused_tiff_old_style_jpeg_planar.tif"}
    for name in ("refused_tiff_lzma_bcj_x86.tif", "refused_tiff_cmyk16.tif",
                 "refused_tiff_ycbcr_uncompressed.tif",
                 "refused_tiff_lab.tif"):
        assert name in INDEX["files"], name
    for name in ("refused_tiff_webp.tif", "refused_tiff_old_style_jpeg.tif",
                 "refused_tiff_thunderscan.tif", "refused_tiff_sgilog.tif"):
        assert name in INDEX["errors"], name


# ----------------------------------------------------- live Pillow: modes

RNG_SHAPE = (37, 53)


def _samples(rng, bits, spp, kind="u"):
    h, w = RNG_SHAPE
    if kind == "f":
        return rng.rand(h, w, spp).astype(np.float32) * 300 - 20
    return rng.randint(0, 1 << bits, (h, w, spp)).astype(np.int64)


def _modes():
    """(name, bits, samples a pixel, "u" or "f", encode_tiff keywords; a
    colormap's bits) of every sample layout Pillow reads."""
    out = []
    for ph in (0, 1):
        for bits in (1, 2, 4, 8, 16):
            out.append((f"gray{bits}_ph{ph}", bits, 1, "u",
                        dict(bits=bits, photometric=ph)))
    out += [("gray12", 12, 1, "u", dict(bits=12, photometric=1)),
            ("signed16", 16, 1, "u", dict(bits=16, photometric=1,
                                          sample_format=2)),
            ("signed8", 8, 1, "u", dict(photometric=1, sample_format=2)),
            ("int32", 32, 1, "u", dict(bits=32, photometric=1,
                                       sample_format=1)),
            ("sint32", 32, 1, "u", dict(bits=32, photometric=1,
                                        sample_format=2)),
            ("float32", 32, 1, "f", dict(bits=32, photometric=1,
                                         sample_format=3)),
            ("float32_ph0", 32, 1, "f", dict(bits=32, photometric=0,
                                             sample_format=3))]
    for bits in (1, 2, 4, 8):
        out.append((f"palette{bits}", bits, 1, "u",
                    dict(bits=bits, photometric=3, colormap=bits)))
    out += [("la", 8, 2, "u", dict(photometric=1, extra_samples=[2])),
            ("pa", 8, 2, "u", dict(photometric=3, extra_samples=[2],
                                   colormap=8)),
            ("px", 8, 2, "u", dict(photometric=3, extra_samples=[0],
                                   colormap=8)),
            ("rgb", 8, 3, "u", dict()), ("rgb16", 16, 3, "u", dict(bits=16))]
    for ex in ([], [0], [1], [2], [0, 0], [1, 0], [2, 0], [0, 0, 0],
               [1, 0, 0], [2, 0, 0], [999]):
        out.append((f"rgba_extra{''.join(map(str, ex))}", 8,
                    3 + max(1, len(ex)), "u", dict(extra_samples=ex)))
    for ex in ([], [0], [1], [2]):
        out.append((f"rgba16_extra{''.join(map(str, ex))}", 16, 4, "u",
                    dict(bits=16, extra_samples=ex)))
    for ex in ([], [0], [0, 0]):
        out.append((f"cmyk_extra{''.join(map(str, ex))}", 8, 4 + len(ex),
                    "u", dict(photometric=5, extra_samples=ex)))
    return out


MODE_CASES = _modes()
LAYOUTS = [dict(), dict(rows_per_strip=5), dict(tile=(16, 16)),
           dict(planar=2, rows_per_strip=7), dict(planar=2, tile=(16, 32))]
COMPRESSIONS = [dict(compression=1), dict(compression=5),
                dict(compression=5, old_lzw=True), dict(compression=8),
                dict(compression=32946), dict(compression=32773),
                dict(compression=5, predictor=2),
                dict(compression=8, predictor=2),
                dict(compression=8, predictor=3),
                dict(compression=5, predictor=3)]


@pytest.mark.parametrize("name,bits,spp,kind,kw", MODE_CASES,
                         ids=[m[0] for m in MODE_CASES])
def test_mode_layouts_and_compressions_equal_pillow(name, bits, spp, kind,
                                                    kw):
    """One sample layout under every compression (both LZW code styles,
    both Deflate tags, PackBits), predictor 2 and 3, strips, tiles with
    cropped edges and separate planes, in both byte orders: Pillow's
    pixels, or an error where Pillow raises (a predictor on samples it
    does not take, separate planes Pillow's decoder cannot unpack; one
    case is left out: separate planes of a one-band mode in tiles, which
    Pillow unpacks from past its tile buffer)."""
    pytest.importorskip("PIL")
    rng = np.random.RandomState(len(name) * 7 + spp)
    samples = _samples(rng, bits, spp, kind)
    kw = dict(kw)
    if "colormap" in kw:
        kw["colormap"] = rng.randint(0, 65536, (1 << kw["colormap"], 3))
    for layout in LAYOUTS:
        if (layout.get("planar") == 2 and layout.get("tile") and spp > 1
                and name in ("pa", "px")):
            continue
        for comp in COMPRESSIONS:
            if comp.get("predictor") == 3 and kw.get("sample_format") != 3:
                continue
            if comp.get("predictor") == 2 and bits < 8:
                continue
            for bo in "<>":
                data = iw.encode_tiff(samples, byteorder=bo,
                                      **{**kw, **layout, **comp})
                assert_like_pillow(data, f"{name} {layout} {comp} {bo}")


@pytest.mark.parametrize("orientation", list(range(10)))
def test_orientations_equal_pillow(orientation):
    """Orientation 2-8 transposes the image as ImageOps.exif_transpose does
    (0, 1 and 9 leave it), over every route; an XMP tiff:Orientation
    applies where the tag is absent, and not over it."""
    pytest.importorskip("PIL")
    rng = np.random.RandomState(orientation)
    img = rng.randint(0, 256, (37, 53, 3))
    gray = img[..., 0]
    for kw in (dict(), dict(compression=8), dict(compression=5, tile=(16, 16)),
               dict(photometric=1, bits=1), dict(compression=32773,
                                                 rows_per_strip=3),
               dict(compression=7)):
        s = gray % 2 if kw.get("bits") == 1 else (
            gray if "photometric" in kw else img)
        if kw.get("compression") == 7:
            kw = dict(kw, photometric=6, segments=[ic.pil_jpeg(img)],
                      ycbcr_subsampling=(2, 2))
        assert_like_pillow(iw.encode_tiff(s, orientation=orientation, **kw),
                           f"orientation {orientation} {kw.keys()}")
        xmp = (f'<x:xmpmeta><rdf:Description tiff:Orientation="'
               f'{orientation}"/></x:xmpmeta>').encode()
        assert_like_pillow(iw.encode_tiff(s, tags={700: (1, list(xmp))},
                                          **kw), f"XMP {orientation}")
        xmp = f"<tiff:Orientation>{orientation}</tiff:Orientation>".encode()
        assert_like_pillow(iw.encode_tiff(
            s, tags={700: (1, list(xmp)), 274: (3, [1])}, **kw),
            f"XMP under the tag {orientation}")


# the TIFF modes whose raw mode is the mode and one of Image._MAPMODES:
# (samples shape, encode_tiff arguments)
MAP_MODES = {
    "L": ((7, 5), dict(photometric=1)),
    "P": ((7, 5), dict(photometric=3)),
    "RGBA": ((7, 5, 4), dict(extra_samples=[2])),
    "CMYK": ((7, 5, 4), dict(photometric=5)),
    "I;16": ((7, 5), dict(photometric=1, bits=16)),
    "I;16B": ((7, 5), dict(photometric=1, bits=16, byteorder=">")),
}


@pytest.mark.parametrize("orientation", range(1, 9))
@pytest.mark.parametrize("mode", sorted(MAP_MODES))
def test_path_reads_equal_pillows_path_reads(mode, orientation, tmp_path):
    """An uncompressed one-strip TIFF of a mode Pillow memory-maps, read
    from its path, gives Image.open(path).convert("RGB") (for Orientation
    5-8 the mapped view turned, not the image), and from its bytes gives
    Image.open(BytesIO(...)); in strips the two agree."""
    from PIL import Image
    shape, kw = MAP_MODES[mode]
    rng = np.random.RandomState(orientation)
    samples = rng.randint(0, 65536 if kw.get("bits") == 16 else 256, shape)
    if mode == "P":
        kw = dict(kw, colormap=rng.randint(0, 65536, (256, 3)))
    for layout in (dict(), dict(rows_per_strip=3)):
        data = iw.encode_tiff(samples, orientation=orientation, **kw,
                              **layout)
        path = tmp_path / f"{mode.replace(';', '')}.tif"
        path.write_bytes(data)
        with Image.open(path) as im:
            assert im.mode == mode
            want_path = np.asarray(im.convert("RGB"))
        want_bytes = pillow(data)
        for source in (path, str(path)):
            got = image_io.read_image(source)
            assert got.shape == want_path.shape
            assert np.array_equal(got, want_path), (mode, orientation)
        with open(path, "rb") as f:
            assert np.array_equal(image_io.read_image(f), want_bytes)
        assert np.array_equal(image_io.read_image(data), want_bytes)
        mapped = orientation >= 5 and not layout
        assert (want_path.shape != want_bytes.shape) == (
            mapped and shape[0] != shape[1])


@pytest.mark.parametrize("orientation", range(5, 9))
def test_path_read_of_a_wide_tile_stays_in_the_file(orientation, tmp_path):
    """One uncompressed tile wider than an L image 10 wide and 100 tall:
    Pillow maps it from the path with the tile's 16-byte stride, and the
    turned view's 10 rows of 100 pixels overlap. Whole, the file reads as
    Pillow reads it from its path; with the tile moved to 160 bytes
    before the end (enough for Pillow's size check, 10 strides, not for
    the last row) the read raises ValueError where Pillow reads past the
    end of its map."""
    from PIL import Image
    samples = np.random.RandomState(orientation).randint(0, 256, (100, 10))
    kw = dict(photometric=1, tile=(16, 112), orientation=orientation)
    data = iw.encode_tiff(samples, **kw)
    path = tmp_path / "wide_tile.tif"
    path.write_bytes(data)
    with Image.open(path) as im:
        want = np.asarray(im.convert("RGB"))
    assert want.shape == (100, 10, 3)
    assert np.array_equal(image_io.read_image(path), want)
    assert np.array_equal(image_io.read_image(data), pillow(data))
    cut = iw.encode_tiff(samples, **kw,
                         tags={324: (4, [len(data) - 160])})
    assert len(cut) == len(data)
    path.write_bytes(cut)
    with pytest.raises(ValueError, match="last row runs past the end"):
        image_io.read_image(path)


@pytest.mark.parametrize("compression", [1, 5, 8, 32773])
def test_strip_tables_equal_pillow(compression):
    """RowsPerStrip absent, past the image and of every size; strips
    shorter than the rows they hold, byte counts missing, zero or short,
    offsets missing, strip tables too long or too short for the rows,
    truncated files, BigTIFF and the byte-swapped magic numbers Pillow
    takes (libtiff does not): Pillow's uncompressed reader and libtiff
    each have their rules, and the port follows the one Pillow runs."""
    pytest.importorskip("PIL")
    rng = np.random.RandomState(compression)
    img = rng.randint(0, 256, (37, 53, 3))
    enc = iw.encode_tiff
    c = dict(compression=compression)
    cases = [("no rps", enc(img, **c))]
    for rps in (1, 5, 36, 37, 38, 1000, 0xFFFFFFFF):
        cases.append((f"rps {rps}", enc(img, tags={278: (4, [rps])}, **c)))
    d = enc(img, rows_per_strip=5, **c)
    for cut in (0.3, 0.6, 0.9, 0.99):
        cases.append((f"cut {cut}", d[:int(len(d) * cut)]))
    cases += [
        ("no counts", enc(img, omit=[279], **c)),
        ("no counts rps5", enc(img, rows_per_strip=5, omit=[279], **c)),
        ("no offsets", enc(img, omit=[273], **c)),
        ("rps 10 over 5", enc(img, rows_per_strip=5,
                              tags={278: (4, [10])}, **c)),
        ("rps 5 over 10", enc(img, rows_per_strip=10,
                              tags={278: (4, [5])}, **c)),
        ("zero counts", enc(img, rows_per_strip=5, tags={279: (4, [0] * 8)},
                            **c)),
        ("zero count", enc(img, tags={279: (4, [0])}, **c)),
        ("short counts", enc(img, rows_per_strip=5,
                             tags={279: (4, [10] * 8)}, **c))]
    for n in (3, 7, 9):
        cases.append((f"{n} strips", enc(img, rows_per_strip=5, tags={
            278: (4, [-(-37 // n)])}, **c)))
    for bo in "<>":
        for big in (False, True):
            d = bytearray(enc(img, byteorder=bo, bigtiff=big, **c))
            cases.append((f"bigtiff {big} {bo}", bytes(d)))
            if not big:
                d[2:4] = d[2:4][::-1]
                cases.append((f"swapped magic {bo}", bytes(d)))
    for tile in ((16, 16), (32, 16), (16, 48), (64, 64)):
        cases.append((f"tile {tile}", enc(img, tile=tile, **c)))
        cases.append((f"tile {tile} bilevel", enc(
            img[..., 0] % 2, bits=1, photometric=1, tile=tile, **c)))
    for what, data in cases:
        assert_like_pillow(data, what)


@pytest.mark.parametrize("compression", [1, 5])
def test_oversized_tile_and_strip_dimensions_equal_pillow(compression):
    """BigTIFF's LONG8 TileWidth, TileLength and RowsPerStrip near 2**61,
    2**63 and 2**64 - 1 (negative as a signed value): Pillow's pixels
    where its arithmetic allows them (a row stride that fits its raw
    decoder's C int, and one row to read), an error otherwise, and never
    a read outside the file."""
    pytest.importorskip("PIL")
    rng = np.random.RandomState(compression + 7)
    img = rng.randint(0, 256, (37, 53, 3))
    bilevel = img[..., 0] % 2
    big = dict(bigtiff=True, compression=compression)
    cases = []
    for v in (2 ** 31, 2 ** 33, 2 ** 61, 2 ** 63 - 1, 2 ** 64 - 1):
        cases.append((f"rps {v}", iw.encode_tiff(
            img, rows_per_strip=5, tags={278: (16, [v])}, **big)))
        for tile in ((v, 16), (16, v), (v, v)):
            tags = {322: (16, [tile[0]]), 323: (16, [tile[1]])}
            cases.append((f"tile {tile}", iw.encode_tiff(
                img, tile=(16, 16), tags=tags, **big)))
            for s in (bilevel, bilevel[:1]):
                cases.append((f"tile {tile} bilevel {s.shape}", iw.encode_tiff(
                    s, bits=1, photometric=1, tile=(16, 16), tags=tags,
                    **big)))
    for what, data in cases:
        assert_like_pillow(data, what)


@pytest.mark.parametrize("compression", [1, 5, 8, 32773])
def test_fill_order_2_equals_pillow(compression):
    """FillOrder 2: Pillow's bit-reversing unpackers on uncompressed data
    (and its raw modes missing for some layouts), libtiff's reversal of
    each compressed byte otherwise; layouts without a FillOrder 2 mode
    are refused as Pillow refuses them."""
    pytest.importorskip("PIL")
    rng = np.random.RandomState(compression + 1)
    g = rng.randint(0, 256, (37, 53))
    img = rng.randint(0, 256, (37, 53, 3))
    for s, kw in ((g % 2, dict(bits=1, photometric=1)),
                  (g % 2, dict(bits=1, photometric=0)),
                  (g % 16, dict(bits=4, photometric=1)),
                  (g % 4, dict(bits=2, photometric=3,
                               colormap=rng.randint(0, 65536, (4, 3)))),
                  (g, dict(photometric=1)), (g, dict(photometric=0)),
                  (g * 200, dict(bits=16, photometric=1)), (img, dict()),
                  (np.dstack([img, g]), dict(extra_samples=[2]))):
        for bo in "<>":
            assert_like_pillow(iw.encode_tiff(
                s, fill_order=2, compression=compression, byteorder=bo, **kw),
                f"{kw} {bo}")


# ------------------------------------------------------ live Pillow: JPEG

def _segments(img, rows=None, tile=None, **kw):
    return ic.tiff_jpeg_segments(img, rows, tile, **kw)


@pytest.mark.parametrize("sub,factors", [("4:2:0", (2, 2)),
                                         ("4:2:2", (2, 1)),
                                         ("4:4:4", (1, 1))])
def test_jpeg_ycbcr_equals_pillow(sub, factors):
    """YCbCr JPEG strips and tiles at each subsampling, converted to RGB
    by libjpeg as Pillow asks libtiff to (JPEGCOLORMODE_RGB): whole
    streams, abbreviated ones under JPEGTables, progressive and
    restart-marker streams; a YCbCrSubsampling tag that disagrees with
    the stream is an error, an absent one is taken from the first
    strip's frame (libtiff's fix-up)."""
    pytest.importorskip("PIL")
    img = ic.seeded_image(np.random.RandomState(factors[0] * 3 + factors[1]),
                          37, 53)
    zeros = np.zeros_like(img)
    for layout in (dict(rows=None), dict(rows=16), dict(rows=32),
                   dict(tile=(16, 16)), dict(tile=(32, 16))):
        tk = dict(rows_per_strip=layout.get("rows"), tile=layout.get("tile"))
        for q in (50, 95):
            segs = _segments(img, subsampling=sub, quality=q, **layout)
            for tag in (factors, (2, 2), None):
                assert_like_pillow(iw.encode_tiff(
                    zeros, photometric=6, compression=7, segments=segs,
                    ycbcr_subsampling=tag, **tk), f"{layout} q{q} {tag}")
            tables, abbr = _segments(img, tables=True, subsampling=sub,
                                     quality=q, **layout)
            assert_like_pillow(iw.encode_tiff(
                zeros, photometric=6, compression=7, segments=abbr,
                jpeg_tables=tables, ycbcr_subsampling=factors, **tk),
                f"tables {layout} q{q}")
            for extra in (dict(progressive=True),
                          dict(restart_marker_blocks=1)):
                assert_like_pillow(iw.encode_tiff(
                    zeros, photometric=6, compression=7,
                    segments=_segments(img, subsampling=sub, quality=q,
                                       **extra, **layout),
                    ycbcr_subsampling=factors, **tk),
                    f"{extra} {layout} q{q}")


def test_jpeg_colour_follows_photometric_not_the_stream():
    """libtiff, not the stream's JFIF or Adobe marker, picks the colour
    transform: YCbCr streams under photometric RGB give their raw
    components, Adobe RGB streams (component ids R, G, B) under
    photometric YCbCr are converted; grayscale (both photometrics),
    CMYK, and a last strip whose stream is taller than the strip."""
    pytest.importorskip("PIL")
    img = ic.seeded_image(np.random.RandomState(3), 37, 53)
    zeros = np.zeros_like(img)
    for layout in (dict(rows=None), dict(rows=8), dict(tile=(16, 16))):
        tk = dict(rows_per_strip=layout.get("rows"), tile=layout.get("tile"))
        ycc = _segments(img, subsampling="4:4:4", quality=90, **layout)
        rgb = _segments(img, keep_rgb=True, quality=90, **layout)
        assert_like_pillow(iw.encode_tiff(zeros, photometric=2, compression=7,
                                          segments=ycc, **tk), "RGB/YCbCr")
        assert_like_pillow(iw.encode_tiff(zeros, photometric=2, compression=7,
                                          segments=rgb, **tk), "RGB/Adobe")
        assert_like_pillow(iw.encode_tiff(
            zeros, photometric=6, compression=7, segments=rgb,
            ycbcr_subsampling=(1, 1), **tk), "YCbCr/Adobe")
        gray = img[..., 0]
        for ph in (0, 1):
            assert_like_pillow(iw.encode_tiff(
                np.zeros_like(gray), photometric=ph, compression=7,
                segments=_segments(gray, quality=80, **layout), **tk),
                f"gray {ph}")
        cmyk = ic.seeded_image(np.random.RandomState(4), 37, 53, 4)
        assert_like_pillow(iw.encode_tiff(
            np.zeros_like(cmyk), photometric=5, compression=7,
            segments=_segments(cmyk, mode="CMYK", quality=80, **layout),
            **tk), "CMYK")
    tall = np.zeros((48, 53, 3), np.uint8)
    tall[:37] = img
    segs = _segments(img, 16, subsampling="4:2:0")
    segs[-1] = ic.pil_jpeg(tall[32:48], subsampling="4:2:0")
    assert_like_pillow(iw.encode_tiff(zeros, photometric=6, compression=7,
                                      segments=segs, rows_per_strip=16),
                       "a last strip taller than the strip")
    segs = _segments(img, 16, subsampling="4:2:0")
    segs[0] = ic.pil_jpeg(img[:20], subsampling="4:2:0")
    assert_like_pillow(iw.encode_tiff(zeros, photometric=6, compression=7,
                                      segments=segs, rows_per_strip=16),
                       "a first strip taller than the strip")


@pytest.mark.parametrize("photometric,bits", [(1, 1), (1, 2), (1, 4),
                                               (1, 12), (1, 16), (3, 1),
                                               (3, 4), (3, 16)])
def test_jpeg_of_other_bit_depths_is_refused_as_libtiff_refuses(
        photometric, bits):
    """A JPEG-compressed TIFF whose BitsPerSample is not its stream's 8
    (bilevel, 2- and 4-bit gray or palette, 12- and 16-bit): libtiff's
    JPEGPreDecode refuses it (Pillow raises), and so does the port, before
    a strip is decoded into a buffer sized for those samples."""
    img = ic.seeded_image(np.random.RandomState(bits), 37, 53)
    gray = img[..., 0]
    colormap = (np.random.RandomState(0).randint(0, 65536, (1 << min(bits, 8), 3))
                if photometric == 3 else None)
    for layout in (dict(rows=None), dict(rows=8), dict(tile=(16, 16))):
        data = iw.encode_tiff(
            np.zeros_like(gray), bits=bits, photometric=photometric,
            compression=7, colormap=colormap,
            segments=_segments(gray, quality=80, **layout),
            rows_per_strip=layout.get("rows"), tile=layout.get("tile"))
        with pytest.raises(ValueError):
            image_io.read_image(data)
        if importlib.util.find_spec("PIL"):
            assert_like_pillow(data, f"{photometric} {bits} {layout}")


@pytest.mark.parametrize("scene", ["scene_baseline_420.jpg",
                                   "scene_baseline_444.jpg"])
def test_scene_jpeg_wrapped_as_tiff_equals_pillow(scene):
    """chip_smoke.py's phase 9d TIFF sweep: a baseline scene's own JPEG
    stream as a one-strip YCbCr TIFF (tests/image_writers.tiff_from_jpeg)
    in both byte orders."""
    pytest.importorskip("PIL")
    data = (ic.CORPUS / scene).read_bytes()
    for bo in "<>":
        tiff = iw.tiff_from_jpeg(data, bo)
        assert_like_pillow(tiff, scene)
    assert image_io.read_image(tiff).shape == (480, 640, 3)


PILLOW_MODES = ("RGB", "L", "RGBA", "CMYK", "1", "P", "LA", "I;16", "I",
                "F", "PA")


@pytest.mark.parametrize("mode", PILLOW_MODES)
def test_pillow_written_files_equal_pillow(mode):
    """Pillow's own TIFF writer: every mode it writes under raw, PackBits,
    LZW, both Deflates and JPEG (RGB, L, RGBA, CMYK), with a predictor
    (tiffinfo 317), an orientation (274) and a second page (the first is
    read). Its LZMA, ZSTD and CCITT files are refused by name (the
    corpus's refused files). Pillow's writer aborts the process for JPEG
    from other modes and for a predictor on bilevel images: not
    written."""
    pytest.importorskip("PIL")
    from PIL import Image
    img = ic.seeded_image(np.random.RandomState(5), 37, 53)
    if mode in ("I;16", "I", "F"):
        im = Image.fromarray(img[..., 0].astype(np.int32) * 300).convert(mode)
    else:
        im = Image.fromarray(img).convert(mode)
    for comp in (None, "packbits", "tiff_lzw", "tiff_adobe_deflate",
                 "tiff_deflate", "jpeg"):
        if comp == "jpeg" and mode not in ("RGB", "L", "RGBA", "CMYK"):
            continue
        for extra in ({}, {"tiffinfo": {317: 2}}, {"tiffinfo": {274: 6}},
                      {"quality": 40}):
            if mode == "1" and 317 in extra.get("tiffinfo", {}):
                continue
            buf = io.BytesIO()
            try:
                im.save(buf, "TIFF", compression=comp, **extra)
            except (OSError, ValueError, TypeError):
                continue
            assert_like_pillow(buf.getvalue(), f"{mode} {comp} {extra}")
    buf = io.BytesIO()
    im.save(buf, "TIFF", save_all=True, append_images=[im.rotate(90)],
            compression="tiff_lzw")
    assert_like_pillow(buf.getvalue(), f"{mode} two pages")


# ------------------------------------------------------------- inflate

@pytest.mark.parametrize("strategy", ["default", "filtered", "huffman",
                                      "rle", "fixed"])
def test_inflate_equals_zlib(strategy):
    """The decoder's own inflate (the TIFF route's Deflate) equals
    zlib.decompress over seeded data at every level: stored, fixed and
    dynamic blocks, long matches, empty input."""
    kinds = {"default": zlib.Z_DEFAULT_STRATEGY, "filtered": zlib.Z_FILTERED,
             "huffman": zlib.Z_HUFFMAN_ONLY, "rle": zlib.Z_RLE,
             "fixed": zlib.Z_FIXED}
    rng = np.random.RandomState(len(strategy))
    inputs = [b"", b"a", bytes(70000),
              rng.randint(0, 256, 5000).astype(np.uint8).tobytes(),
              np.repeat(rng.randint(0, 4, 3000), rng.randint(1, 40, 3000))
              .astype(np.uint8).tobytes(),
              (ic.CORPUS / "scene_baseline_420.jpg").read_bytes()[:40000]]
    for data in inputs:
        for level in (0, 1, 6, 9):
            obj = zlib.compressobj(level, zlib.DEFLATED, 15, 9,
                                   kinds[strategy])
            z = obj.compress(data) + obj.flush()
            assert native_image.inflate(z, len(data) + 8) == data, (
                len(data), level)


def test_inflate_refuses_what_zlib_refuses():
    """A bad Adler-32, a truncated stream, a bad header, a preset
    dictionary and corrupt bytes: an error wherever zlib.decompress
    raises, zlib's data otherwise."""
    rng = np.random.RandomState(11)
    data = rng.randint(0, 8, 4000).astype(np.uint8).tobytes()
    z = zlib.compress(data, 9)
    bad_adler = z[:-1] + bytes([z[-1] ^ 1])
    with pytest.raises(zlib.error):
        zlib.decompress(bad_adler)
    with pytest.raises(ValueError, match="incorrect data check"):
        native_image.inflate(bad_adler, len(data) + 8)
    cases = [z[:len(z) // 2], z[:-4], b"\x78\x9c", b"\x78\x9d" + z[2:],
             b"\x79\x9c" + z[2:],
             zlib.compressobj(6, zlib.DEFLATED, 15, 9, 0, b"dict").compress(
                 data)]
    for pos in range(2, len(z), max(1, len(z) // 60)):
        flipped = bytearray(z)
        flipped[pos] ^= 0x5A
        cases.append(bytes(flipped))
    for case in cases:
        want = outcome(zlib.decompress, case)
        got = outcome(lambda d: native_image.inflate(d, len(data) + 64), case)
        if isinstance(want, Exception):
            assert isinstance(got, ValueError), case[:8]
        else:
            assert got == want


# ----------------------------------------------------- threads, routes

def test_four_threads_decode_tiff_like_one():
    """Each decode is one ctypes call that releases the GIL, after its
    size call: four threads over TIFF files of every compression give
    the one-thread arrays."""
    files = [(ic.CORPUS / n).read_bytes() for m in sorted(MODES)
             for n in MODES[m] if "37x53" in n]
    want = [image_io.read_image(d) for d in files]
    with ThreadPoolExecutor(4) as pool:
        got = list(pool.map(image_io.read_image, files * 2))
    for k, img in enumerate(got):
        assert np.array_equal(img, want[k % len(files)])


def test_plain_route_and_size_limit():
    """The plain route names TIFF as a format it does not read; a TIFF of
    more pixels than Pillow's decompression-bomb limit raises before any
    output is allocated, its orientation counted."""
    data = (ic.CORPUS / "tiff_rgb_lzw_5x3.tif").read_bytes()
    assert image_io.format_of(data) == "TIFF"
    with pytest.raises(NotImplementedError, match="TIFF: the plain route"):
        image_io.read_image(data, plain=True)
    huge = iw.encode_tiff(np.zeros((2, 2, 3), np.uint8), compression=5,
                          tags={256: (4, [20000]), 257: (4, [20000])})
    with pytest.raises(ValueError, match="image size"):
        image_io.read_image(huge)
    rotated = iw.encode_tiff(np.zeros((3, 5, 3), np.uint8), orientation=6)
    assert image_io.read_image(rotated).shape == (5, 3, 3)


NO_SYSTEM_CODECS = """
import re, sys
from maskrcnn_tpu_torch.data import image_io
for name in sys.argv[1:]:
    image_io.read_image("tests/data/image_io/" + name)
maps = open("/proc/self/maps").read().split()
bad = sorted({p for p in maps if re.match(r"lib(tiff|jpeg|webp)[.-]",
                                          p.rsplit("/", 1)[-1])
              or "pillow.libs" in p})
bad += sorted(m for m in sys.modules if m == "PIL" or m.startswith("PIL."))
print("BAD", bad)
"""


def test_tiff_decode_loads_no_libtiff_and_links_no_zlib():
    """Decoding every TIFF mode in a fresh interpreter loads no libtiff,
    libjpeg or Pillow, and the decoder library names only the C and C++
    runtimes and imports no zlib, libtiff, libzstd, XXH or liblzma
    symbol."""
    names = [MODES[m][0] for m in sorted(MODES)]
    proc = subprocess.run([sys.executable, "-c", NO_SYSTEM_CODECS, *names],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert "BAD []" in proc.stdout, proc.stdout + proc.stderr
    path = native_image.library_path()
    out = subprocess.run(["ldd", str(path)], capture_output=True,
                         text=True).stdout
    libs = {line.split()[0].rsplit("/", 1)[-1]
            for line in out.splitlines() if line.strip()}
    runtimes = ("linux-vdso", "libstdc++", "libgcc_s", "libc.", "libm.",
                "ld-linux")
    assert libs and all(lib.startswith(runtimes) for lib in libs), libs
    undefined = subprocess.run(["nm", "-D", "--undefined-only", str(path)],
                               capture_output=True, text=True).stdout
    assert not re.search(r"\b(inflate|TIFF|ZSTD_|lzma_|XXH)\w*",
                         undefined), undefined


# ---------------------------------------- the JAX package's CocoDataset

def _coco_dir(root: Path) -> Path:
    """A COCO directory of the three scenes as TIFF (from their JPEG
    files' native decodes): LZW with predictor 2 in strips, tiled Deflate
    with predictor 2, and the baseline scenes' JPEG streams as YCbCr
    JPEG TIFF; and the first scene uncompressed in one strip, as L with
    Orientation 5 and 8 and as RGBA with Orientation 6 and 7, which
    Pillow memory-maps from a path (the mapped view, 640 wide, is what
    it turns)."""
    images, anns, files = [], [], []
    for k, scene in enumerate(INDEX["scenes"]):
        data = (ic.CORPUS / scene).read_bytes()
        img = image_io.read_image(data)
        files.append(iw.encode_tiff(img, compression=5, predictor=2,
                                    rows_per_strip=64))
        files.append(iw.encode_tiff(img, compression=8, predictor=2,
                                    tile=(256, 256), byteorder="><"[k % 2]))
        if "progressive" not in scene:
            files.append(iw.tiff_from_jpeg(data))
        if k == 0:
            alpha = (img[..., 1:2] // 2 + 128).astype(np.uint8)
            for o in (5, 8):
                files.append(iw.encode_tiff(img[..., 0], photometric=1,
                                            orientation=o))
            for o in (6, 7):
                files.append(iw.encode_tiff(
                    np.concatenate([img, alpha], -1), extra_samples=[2],
                    orientation=o))
    (root / "val2014").mkdir(parents=True)
    (root / "annotations").mkdir()
    for i, data in enumerate(files, 1):
        file_name = f"COCO_val2014_{i:012d}.tif"
        (root / "val2014" / file_name).write_bytes(data)
        images.append({"id": i, "height": 480, "width": 640,
                       "file_name": file_name})
        anns.append({"id": i, "image_id": i, "category_id": 1, "iscrowd": 0,
                     "bbox": [10.0 * i, 20.0, 100.0, 80.0], "area": 8000.0,
                     "segmentation": [[10.0 * i, 20.0, 10.0 * i + 100, 20.0,
                                       10.0 * i + 100, 100.0, 10.0 * i,
                                       100.0]]})
    with open(root / "annotations" / "instances_minival2014.json", "w") as f:
        json.dump({"images": images, "annotations": anns,
                   "categories": INDEX["categories"]}, f)
    return root


def test_jax_coco_dataset_reads_tiff_as_the_port(tmp_path):
    """maskrcnn_tpu/data/coco.py's load_image and load (Pillow, from the
    file's path) against the port's (its native reader) on TIFF files."""
    pytest.importorskip("PIL")
    from maskrcnn_tpu.config import TinyConfig
    from maskrcnn_tpu.data import coco as jax_coco
    from maskrcnn_tpu_torch import TinyConfig as PortTinyConfig
    from maskrcnn_tpu_torch.data import coco as port_coco
    root = str(_coco_dir(tmp_path / "coco"))
    ref = jax_coco.CocoDataset(root, "minival", 2014, TinyConfig())
    port = port_coco.CocoDataset(root, "minival", 2014, PortTinyConfig())
    assert port.ids == ref.ids and len(port.ids) == 12
    for i, image_id in enumerate(port.ids):
        np.testing.assert_array_equal(port.load_image(image_id),
                                      ref.load_image(image_id))
        for a, b in zip(port.load(i), ref.load(i)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_a_tag_whose_data_runs_past_the_file_ends_the_directory():
    """Pillow's ImageFileDirectory load stops at the first tag whose data
    runs past the file's end (its read raises, the load warns and
    returns), dropping every tag after it: a count so set on Compression
    drops the strip tags (no plugin takes the file), on the last tag
    (PlanarConfiguration) nothing the image needs; the port reads the
    directory as far as Pillow does."""
    import struct
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(ic.seeded_image(np.random.RandomState(80), 5, 7)).save(
        buf, "TIFF")
    data = buf.getvalue()
    ifd = struct.unpack_from("<I", data, 4)[0]
    entries = {struct.unpack_from("<H", data, ifd + 2 + 12 * k)[0]: k
               for k in range(struct.unpack_from("<H", data, ifd)[0])}
    edits = {}
    for tag in (259, 284):
        edited = bytearray(data)
        struct.pack_into("<I", edited, ifd + 2 + 12 * entries[tag] + 4,
                         2_621_441)
        edits[tag] = bytes(edited)
        assert_like_pillow(edits[tag], f"tag {tag}")
    with pytest.raises(ValueError, match="data organization"):
        image_io.read_image(edits[259])
    assert np.array_equal(image_io.read_image(edits[284]), pillow(data))
