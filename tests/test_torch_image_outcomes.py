"""The reader's contract (data/image_io.read_image) against Pillow 12.1.0
on the files it once refused: where Pillow decodes a file the port
decodes it to the same pixels, or raises NotImplementedError naming the
format or mode it does not read; where Pillow fails the port raises
ValueError; `format_of` gives `Image.open(f).format` on every corpus file.
Beside that, what this reader learned to read by it: ICNS (Pillow's
IcnsImagePlugin: the container, bestsize, PNG and JPEG 2000 entries,
packed RGB with its RLE, masks, the size check), BMP under a grayscale
palette read with Pillow's wrong unpacker, and the JPEG frames Pillow's
Image.open passes on to its next plugin."""

import io
import json
import struct
import sys
import warnings
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

INDEX = json.loads(ic.INDEX.read_text())
REFUSED_FILES = sorted(p.name for p in ic.CORPUS.iterdir()
                       if p.name.startswith("refused_"))
# stubs of formats the port does not read, which Pillow fails on too: the
# refusal names the format first (a 1x1 Sun raster whose length field
# Pillow's GBR plugin takes, refused_sun_gbr_1x1.ras, is no longer among
# them: the port reads GBR, and raises ValueError where Pillow fails on it
# with "not enough image data")
STUBS = {
    "refused_eps.eps": "EPS, which Pillow reads through Ghostscript (not on "
                       "this machine), and whose refusal names Ghostscript",
    "refused_tiff_old_style_jpeg_tiles.tif": "old-style JPEG in tiles, which "
    "the port does not read (a JPEGInterchangeFormat stream each tile here, "
    "which libtiff fails on)",
    "refused_tiff_old_style_jpeg_planar.tif": "old-style JPEG in separate "
    "planes, as the tiles",
}


def outcome(read, data):
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


@pytest.mark.parametrize("name", REFUSED_FILES)
def test_refused_corpus_file_gives_pillows_outcome(name):
    """Every refused_* file of the corpus: Pillow's pixels, or a
    NotImplementedError naming the format or mode where Pillow reads what
    the port does not, or a ValueError where Pillow fails (but the stubs,
    STUBS, refused by name)."""
    data = (ic.CORPUS / name).read_bytes()
    want, got = outcome(pillow, data), outcome(image_io.read_image, data)
    if name in STUBS:
        assert isinstance(want, Exception), name
        assert isinstance(got, NotImplementedError), (name, got)
        assert INDEX["refused"][name] in str(got)
        return
    if isinstance(want, Exception):
        assert isinstance(got, ValueError), (name, want, got)
        assert name in INDEX["errors"]
        return
    if isinstance(got, NotImplementedError):
        assert INDEX["refused"][name] in str(got), (name, got)
        return
    assert not isinstance(got, Exception), (name, got)
    assert np.array_equal(got, want), name
    assert name in INDEX["files"]


EXTENSIONS = sorted({p.suffix for p in ic.CORPUS.iterdir()} - {".json"})


@pytest.mark.parametrize("ext", EXTENSIONS)
def test_format_of_equals_image_open_format(ext):
    """format_of gives `Image.open(f).format` on every corpus file of an
    extension, the refused ones included; where Image.open raises, None
    (UnidentifiedImageError) or a ValueError naming the plugin."""
    for path in sorted(ic.CORPUS.glob(f"*{ext}")):
        data = path.read_bytes()
        try:
            want = Image.open(io.BytesIO(data)).format
        except Image.UnidentifiedImageError:
            want = None
        except Exception:  # noqa: BLE001 - an _open that ends Image.open
            with pytest.raises(ValueError):
                image_io.format_of(data)
            continue
        assert image_io.format_of(data) == want, path.name


def test_jpeg_frames_pillow_passes_on():
    """A frame of 8 bits and 1, 3 or 4 layers is JPEG; any other depth or
    layer count is SOF's SyntaxError, so Image.open tries the next plugin
    and raises UnidentifiedImageError (a ValueError here)."""
    rng = np.random.RandomState(3)
    img = ic.seeded_image(rng, 16, 16)
    base = ic.pil_jpeg(img)
    sof = base.index(b"\xff\xc0")
    for precision in (8, 12, 16, 0):
        for layers in (1, 2, 3, 4, 5):
            data = bytearray(base)
            data[sof + 4] = precision
            data[sof + 9] = layers
            data = bytes(data)
            try:
                want = Image.open(io.BytesIO(data)).format
            except Image.UnidentifiedImageError:
                want = None
            assert image_io.format_of(data) == want, (precision, layers)
            assert not same_outcome(data), (precision, layers,
                                            same_outcome(data))


def test_bmp_headers_and_grayscale_palettes_give_pillows_outcome():
    """BmpImageFile._bitmap's checks end Image.open (a ValueError naming
    BMP), in BMP files and in ICO and CUR frames; 1- and 4-bit pixels
    under a grayscale palette are read with Pillow's wrong unpacker ("L"
    a byte a pixel, "1" a bit a pixel, for 2 colours), a decode where a
    row of it fits the stride and "codec configuration error" where it
    does not."""
    rng = np.random.RandomState(4)
    for w in range(1, 10):
        for bits, colours in ((1, 16), (4, 16), (4, 2), (1, 4)):
            idx = rng.randint(0, min(colours, 1 << bits), (3, w))
            gray = np.repeat(np.arange(colours, dtype=np.uint8)[:, None],
                             3, 1) if colours > 2 else np.array(
                                 [[0] * 3, [255] * 3], np.uint8)
            data = iw.encode_bmp(w, 3, bits, iw.bmp_pixels(idx, bits)
                                 [::-1].tobytes(), palette=gray)
            assert not same_outcome(data), (w, bits, colours,
                                            same_outcome(data))
    for name in ("refused_bmp_2bit.bmp", "refused_bmp_bitfields_layout.bmp",
                 "refused_bmp_jpeg.bmp", "refused_bmp_png.bmp"):
        with pytest.raises(ValueError, match="BMP"):
            image_io.format_of((ic.CORPUS / name).read_bytes())


# ------------------------------------------------------------------- ICNS

def _png(img, mode=None):
    buf = io.BytesIO()
    im = Image.fromarray(img)
    (im.convert(mode) if mode else im).save(buf, "PNG")
    return buf.getvalue()


def test_icns_entries_equal_pillow():
    """PNG entries at each code (1x and 2x scales, modes RGB, P, RGBA, L),
    JPEG 2000 entries, packed RGB (RLE and raw, it32's prefix) with and
    without masks, several sizes (the largest read), a PNG of another size
    at a whole scale of a size (read at its own size), and Pillow's own
    ICNS writer's file."""
    rng = np.random.RandomState(5)
    files = []
    for code, side in ((b"icp4", 16), (b"ic11", 32), (b"icp5", 32),
                       (b"ic12", 64), (b"icp6", 64), (b"ic07", 128)):
        img = rng.randint(0, 256, (side, side, 3)).astype(np.uint8)
        for mode in (None, "P", "RGBA", "L"):
            files.append(iw.encode_icns([(code, _png(img, mode))]))
    img = rng.randint(0, 256, (32, 32, 3)).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG2000")
    files.append(iw.encode_icns([(b"ic12", buf.getvalue())]))
    for code, mask, side, prefix in ((b"is32", b"s8mk", 16, False),
                                     (b"il32", b"l8mk", 32, False),
                                     (b"ih32", b"h8mk", 48, False),
                                     (b"it32", b"t8mk", 128, True)):
        img = ic.seeded_image(rng, side, side)
        img[side // 2:, :] = 77
        for rle in (True, False):
            entry = iw.icns_rgb(img, rle, prefix)
            files.append(iw.encode_icns([(code, entry)]))
            files.append(iw.encode_icns([(code, entry),
                                         (mask, bytes(side * side))]))
    files.append(iw.encode_icns([
        (b"is32", iw.icns_rgb(ic.seeded_image(rng, 16, 16))),
        (b"ic07", _png(ic.seeded_image(rng, 128, 128)))]))
    files.append(iw.encode_icns([(b"ic10", _png(ic.seeded_image(
        rng, 512, 512)))]))
    files.append((ic.CORPUS / "refused_icns.icns").read_bytes())
    for k, data in enumerate(files):
        assert not same_outcome(data), (k, same_outcome(data))
        assert image_io.format_of(data) == "ICNS"


def test_icns_refusals_and_edits_give_pillows_outcome():
    """A PNG of no whole scale of the file's sizes (640x480 in ic10: "This
    is not one of the allowed sizes of this image"), an entry neither PNG
    nor JPEG 2000, a short mask, a mask alone (no RGB: Pillow's KeyError),
    an RLE band that runs over, and single-byte edits and cuts of packed
    files (the RLE reads on past an entry, as Pillow's file reads do)."""
    rng = np.random.RandomState(6)
    bad = [iw.encode_icns([(b"ic10", _png(ic.seeded_image(rng, 480, 640)))]),
           iw.encode_icns([(b"ic08", b"neither PNG nor JPEG 2000")]),
           iw.encode_icns([(b"is32", iw.icns_rgb(ic.seeded_image(
               rng, 16, 16))), (b"s8mk", bytes(10))]),
           iw.encode_icns([(b"l8mk", bytes(32 * 32))]),
           iw.encode_icns([(b"is32", bytes([0xFF, 7]) * 200)])]
    for k, data in enumerate(bad):
        assert isinstance(outcome(pillow, data), Exception), k
        with pytest.raises(ValueError):
            image_io.read_image(data)
    flat = np.zeros((32, 32, 3), np.uint8)
    flat[8:, 4:] = (9, 200, 30)
    flat[:3, :5] = ic.seeded_image(rng, 3, 5)
    bases = [iw.encode_icns([(b"il32", iw.icns_rgb(flat)),
                             (b"is32", iw.icns_rgb(flat[:16, :16]))]),
             iw.encode_icns([(b"it32", iw.icns_rgb(np.resize(flat, (
                 128, 128, 3)), prefix=True)), (b"t8mk", bytes(128 * 128))])]
    for k, base in enumerate(bases):
        edit_rng = np.random.RandomState(10 + k)
        for _ in range(60):
            data = bytearray(base)
            data[edit_rng.randint(8, len(data))] = edit_rng.randint(256)
            data = bytes(data)
            assert not same_outcome(data), (k, same_outcome(data))
            cut = bytes(base[:edit_rng.randint(16, len(base))])
            assert not same_outcome(cut), (k, len(cut), same_outcome(cut))


def test_icns_block_walk_as_icnsfile():
    """IcnsFile's walk: a block of size 0 (Image.open passes the file on),
    a header size short of the blocks (those past it unread), a repeated
    code (the last kept), a block running past the file's end."""
    rng = np.random.RandomState(7)
    a = iw.icns_rgb(ic.seeded_image(rng, 16, 16))
    b = iw.icns_rgb(ic.seeded_image(rng, 16, 16))
    files = [b"icns" + struct.pack(">I", 24) + b"is32" + struct.pack(">I", 0)
             + a,
             iw.encode_icns([(b"is32", a)])[:4] + struct.pack(">I", 8)
             + iw.encode_icns([(b"is32", a)])[8:],
             iw.encode_icns([(b"is32", a), (b"is32", b)]),
             iw.encode_icns([(b"is32", a)])[:-20]]
    for k, data in enumerate(files):
        assert not same_outcome(data), (k, same_outcome(data))
        try:
            want = Image.open(io.BytesIO(data)).format
        except Image.UnidentifiedImageError:
            want = None
        assert image_io.format_of(data) == want, k
