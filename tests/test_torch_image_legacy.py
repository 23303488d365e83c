"""The port's readers of the last plugins Pillow 12.1.0 decodes here (IM,
SPIDER, FITS, MCIDAS, IMT, XVTHUMB, PIXAR, GBR, FTEX, XBM, XPM, MSP,
FLI, PCD and IPTC: data/image_probe.py's model of each _open,
data/native_image.py's decode_<format>, csrc/image_legacy.cpp) against
live Pillow: the committed files (tests/data/legacy_io, written by
`python tests/image_corpus.py --legacy`) to their digests and Pillow's
decode, or a ValueError where Pillow fails; the Photo CD files, made
from a seed here, to their committed digests; seeded single-byte edits,
cuts and insertions of every route's files, each giving Pillow's outcome;
ConvertYCbCr.c's and PhotoYCC's tables over every (Cb, Cr) pair; the
stubs, MPEG and WMF, which Pillow opens and cannot load, as ValueErrors,
and EPS refused by name; and libavif 1.3's search for the AV1 sequence
header of an item with no nclx colour (data/image_probe.py
_avif_harvest_cicp) on edited and cut AVIF files."""

import hashlib
import io
import json
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest

from maskrcnn_tpu_torch.data import image_io, image_probe, native_image

pytest.importorskip("PIL")
from PIL import Image  # noqa: E402

TESTS = Path(__file__).resolve().parent
sys.path.insert(0, str(TESTS))

import image_corpus as ic  # noqa: E402
import image_writers as iw  # noqa: E402

INDEX = json.loads((ic.LEGACY / "index.json").read_text())
# the formats read here, by the extension legacy_cases gives their files
EXTENSIONS = ("im", "spider", "fits", "mcidas", "imt", "xvthumb", "pixar",
              "gbr", "ftex", "xbm", "xpm", "msp", "fli", "iptc")


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
    """'' where the port gives Pillow's outcome (its pixels, or a
    ValueError where Pillow fails), else what differs."""
    want, got = outcome(pillow, data), outcome(image_io.read_image, data)
    if isinstance(want, Exception):
        return "" if isinstance(got, ValueError) else \
            f"Pillow raised {want!r}, the port gave {got!r}"
    if isinstance(got, Exception):
        return f"Pillow read it, the port raised {got!r}"
    if got.shape != want.shape or not np.array_equal(got, want):
        return f"{int((got != want).any(-1).sum())} pixels differ"
    return ""


def digest(img: np.ndarray) -> str:
    return hashlib.sha256(img.tobytes()).hexdigest()


def test_legacy_corpus_is_whole_and_small():
    """The index names every file of tests/data/legacy_io (each route of
    the 14 committed formats at the corpus's four sizes, and the files
    Pillow fails on), which hold at most 1 MB; READ holds 37 formats."""
    files = {p.name for p in ic.LEGACY.iterdir()} - {"index.json"}
    assert files == set(INDEX["files"]) | set(INDEX["errors"])
    assert sum((ic.LEGACY / n).stat().st_size for n in files) <= 1_000_000
    routes = {}
    for name in files:
        stem, ext = name.rsplit(".", 1)
        route, size = stem.rsplit("_", 1)
        if "x" in size and size.replace("x", "").isdigit():
            routes.setdefault(route, set()).add(size)
    assert all(len(s) == 4 for s in routes.values())
    assert {r.split("_")[0] for r in routes} == set(EXTENSIONS)
    assert len([r for r in routes if r.startswith("im_")]) >= 45
    assert len(routes) >= 90
    assert set(INDEX["generated"]) == {name for name, _ in iw.pcd_cases()}
    assert len(image_io.READ) == 37 and {
        "IM", "SPIDER", "FITS", "MCIDAS", "IMT", "XVThumb", "PIXAR", "GBR",
        "FTEX", "XBM", "XPM", "MSP", "FLI", "PCD", "IPTC"} <= set(
            image_io.READ)


def pillow_path(path):
    return np.asarray(Image.open(path).convert("RGB"))


@pytest.mark.parametrize("name", sorted(INDEX["files"]))
def test_legacy_file_equals_pillow_and_its_digest(name):
    """Read from its bytes and from its path (as chip_smoke.py reads it;
    Pillow memory-maps some paths), equal to Pillow's and the digest."""
    path = ic.LEGACY / name
    got = image_io.read_image(path.read_bytes())
    np.testing.assert_array_equal(got, pillow(path.read_bytes()))
    np.testing.assert_array_equal(image_io.read_image(path),
                                  pillow_path(path))
    entry = INDEX["files"][name]
    assert list(got.shape) == entry["shape"] + [3]
    assert digest(got) == entry["sha256"]


@pytest.mark.parametrize("name", sorted(INDEX["errors"]))
def test_legacy_file_pillow_fails_on_raises(name):
    path = ic.LEGACY / name
    for source, read in ((path.read_bytes(), pillow), (path, pillow_path)):
        assert isinstance(outcome(read, source), Exception)
        with pytest.raises(ValueError):
            image_io.read_image(source)


@pytest.mark.parametrize("name", sorted(INDEX["generated"]))
def test_pcd_file_equals_pillow_and_its_digest(name):
    """The Photo CD base image (768x512, turned by the orientation byte),
    made from image_writers.PCD_SEED."""
    data = dict(iw.pcd_cases())[name]
    got = image_io.read_image(data)
    np.testing.assert_array_equal(got, pillow(data))
    entry = INDEX["generated"][name]
    assert list(got.shape) == entry["shape"] + [3]
    assert digest(got) == entry["sha256"]


def _edits(base: bytes, rng, n: int):
    for _ in range(n):
        e = bytearray(base)
        r = rng.rand()
        if r < 0.6:
            for _ in range(rng.randint(1, 4)):
                at = (rng.randint(0, len(e)) if rng.rand() < 0.5
                      else rng.randint(0, min(len(e), 300)))
                e[at] = (rng.randint(256) if rng.rand() < 0.5
                         else e[at] ^ (1 << rng.randint(8)))
        elif r < 0.85:
            e = e[:rng.randint(1, len(e))]
        else:
            at = rng.randint(0, len(e))
            e = e[:at] + bytes([rng.randint(256)]) * rng.randint(1, 5) \
                + e[at:]
        yield bytes(e)


@pytest.mark.parametrize("ext", EXTENSIONS)
def test_legacy_edits_give_pillows_outcome(ext):
    """Seeded single-byte (to three-byte) edits, cuts and insertions of
    every route's 5x3 and 16x24 files of a format (the header fields,
    the raw tiles' offsets and strides, the runs and chunks of MSP and
    FLI, the XPM colour table, the IPTC fields): Pillow's pixels, or a
    ValueError where Pillow fails."""
    rng = np.random.RandomState(sum(map(ord, ext)))
    names = sorted(n for n in INDEX["files"] if n.endswith("." + ext)
                   and ("_5x3." in n or "_16x24." in n))
    assert names
    per = max(10, 960 // len(names))
    for name in names:
        base = (ic.LEGACY / name).read_bytes()
        for data in _edits(base, rng, per):
            assert not same_outcome(data), (name, same_outcome(data),
                                            data[:64])


def test_pcd_edits_give_pillows_outcome():
    """Edits of the Photo CD header (its magic, the orientation byte) and
    cuts of the base image."""
    base = iw.pcd_cases()[1][1]
    for at in (2048, 2050, 2048 + 1538):
        for v in (0, 1, 2, 3, 0x43, 255):
            e = bytearray(base)
            e[at] = v
            assert not same_outcome(bytes(e)), (at, v)
    for n in (96 * 2048, 96 * 2048 + 2303, 96 * 2048 + 2304,
              len(base) - 1, len(base) + 10):
        data = (base + bytes(10))[:n]
        assert not same_outcome(data), n
    assert not same_outcome(base[:2048 + 1539])


def test_ycbcr_and_photo_ycc_conversions_equal_pillows():
    """IM's YCC images (ConvertYCbCr.c's YCbCr -> RGB tables) and Photo
    CD's PhotoYCC (Unpack.c's YCC;P): every (Cb, Cr) pair at 52 values of
    Y, as one 3,408x1,024 image each, equal Pillow's conversion."""
    ys = np.arange(0, 256, 5)
    y, cb, cr = np.meshgrid(ys, np.arange(256), np.arange(256),
                            indexing="ij")
    planes = np.stack([y, cb, cr], -1).astype(np.uint8).reshape(-1, 1024, 3)
    h = planes.shape[0]
    data = iw.encode_im("YCC", 1024, h, iw.im_rows(planes, True))
    assert not same_outcome(data)
    # PhotoYCC through Pillow's raw decoder (its "YCC;P" unpacker) beside
    # the port's PCD decoder of the same samples
    y2 = planes[..., 0].reshape(-1)[:512 * 768].reshape(512, 768)
    cb2 = planes[..., 1].reshape(-1)[:256 * 384].reshape(256, 384)
    cr2 = planes[..., 2].reshape(-1)[-256 * 384:].reshape(256, 384)
    pcd = iw.encode_pcd(y2, cb2, cr2)
    want = np.empty((512, 768, 3), np.uint8)
    for k in range(2):
        line = np.stack([y2[k::2], np.repeat(cb2, 2, 1),
                         np.repeat(cr2, 2, 1)], -1)
        want[k::2] = np.asarray(Image.frombytes(
            "RGB", (768, 256), line.astype(np.uint8).tobytes(), "raw",
            "YCC;P"))
    np.testing.assert_array_equal(image_io.read_image(pcd), want)


def test_stubs_mpeg_and_wmf_raise_and_eps_is_refused_by_name():
    """BUFR, GRIB, HDF5 (Pillow's stubs) and MPEG open in Pillow and fail
    at load, as does a WMF file (no handler off Windows): a ValueError
    naming the format and Pillow's error; EPS, which Pillow reads through
    Ghostscript, a NotImplementedError naming Ghostscript."""
    files = {name: (ic.LEGACY / name).read_bytes() for name in (
        "bufr_stub.bufr", "grib_stub.grib", "hdf5_stub.h5", "mpeg_stub.mpg")}
    files["wmf"] = (b"\xd7\xcd\xc6\x9a\0\0" + np.array(
        [0, 0, 100, 50], "<i2").tobytes() + np.array([72], "<u2").tobytes()
        + bytes(6) + b"\x01\x00\t\x00" + bytes(40))
    for name, data in files.items():
        fmt = Image.open(io.BytesIO(data)).format
        assert image_io.format_of(data) == fmt
        with pytest.raises(OSError) as e:
            pillow(data)
        with pytest.raises(ValueError, match=f"{fmt}: .*{e.value}"):
            image_io.read_image(data)
    eps = (ic.CORPUS / "refused_eps.eps").read_bytes()
    with pytest.raises(NotImplementedError, match="EPS: .*Ghostscript"):
        image_io.read_image(eps)


def test_mcidas_from_a_path_as_pillows_memory_map(tmp_path):
    """From a path Pillow memory-maps McIdas L and I;16B rows: a stride
    shorter than a row overlaps them (from bytes, a codec configuration
    error) and a stride of 0 or less is the whole rows'; the port reads a
    path as Pillow does."""
    rng = np.random.RandomState(26)
    g = rng.randint(0, 256, (6, 9)).astype(np.int64)
    for size, prefix in ((1, -4), (2, -7), (1, -9), (1, 0), (2, 3)):
        base = bytearray(iw.encode_mcidas(g, size, prefix=max(prefix, 0)))
        base[56:60] = np.array([prefix], ">i4").tobytes()
        path = tmp_path / f"m{size}{prefix}.mcidas"
        path.write_bytes(bytes(base))
        want = outcome(lambda p: np.asarray(Image.open(p).convert("RGB")),
                       path)
        got = outcome(image_io.read_image, path)
        if isinstance(want, Exception):
            assert isinstance(got, ValueError), (size, prefix, want, got)
        else:
            np.testing.assert_array_equal(got, want)
        assert not same_outcome(bytes(base)), (size, prefix)


def test_iptc_bands_and_inner_files():
    """IPTC's image data as a raw P5 or any image file Image.open takes:
    an L image is the file's own decode, a band of an RGB or CMYK image
    merged with black bands (a JPEG or PNG band of another mode than L,
    or band 0 of one, is Image.merge's error), a band index past the
    image's bands an IndexError, a negative one Python's index from the
    end."""
    rng = np.random.RandomState(27)
    img = ic.seeded_image(rng, 11, 13)
    files = []
    for mode in ("L", "RGB", "CMYK"):
        jpeg = ic._pil(img, "JPEG", mode, quality=90)
        png = ic._pil(img, "PNG", mode if mode != "CMYK" else "L")
        for inner, compression in ((jpeg, 5), (png, 5)):
            for layers, component, band in ((1, 0, None), (3, 1, 0),
                                            (3, 1, 2), (4, 1, 1), (4, 1, 3),
                                            (3, 1, -1), (4, 1, 6)):
                files.append(iw.encode_iptc(
                    13, 11, inner, layers=layers, component=component,
                    compression=compression, band=band, pieces=3))
    for k, data in enumerate(files):
        assert not same_outcome(data), (k, same_outcome(data))


def _avif_open(data: bytes):
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return Image.open(io.BytesIO(data)).format
    except Image.UnidentifiedImageError:
        return None
    except Exception:  # noqa: BLE001 - any other error ends Image.open
        return "raise"


def _format_of(data: bytes):
    try:
        return image_io.format_of(data)
    except ValueError:
        return "raise"


def test_av1_sequence_header_search_gives_image_opens_outcome():
    """AVIF files whose colour item has no nclx colr (its colour type
    edited), so that libavif 1.3 reads the item's first 64, 128, ...
    bytes until its AV1 sequence header parses: the OBUs and the header
    edited, the file cut inside the item, the item's extent grown past
    the file's end, over the corpus's file and Pillow's of larger images
    (items of hundreds of bytes): Image.open's outcome each time."""
    pytest.importorskip("PIL.AvifImagePlugin")
    from PIL import features
    if not features.check("avif"):
        pytest.skip("Pillow without AVIF")
    rng = np.random.RandomState(28)
    files = [(ic.CORPUS / "refused_avif.avif").read_bytes()]
    for side in (40, 96):
        noise = rng.randint(0, 256, (side, side, 3), dtype=np.uint8)
        files.append(ic._pil(noise, "AVIF", "RGB", quality=90))
    outcomes = set()
    for base in files:
        f = bytearray(base)
        at = f.find(b"nclx")
        f[at:at + 4] = b"nclX"
        mdat = f.find(b"mdat") + 4
        for _ in range(300):
            e = bytearray(f)
            kind = rng.randint(3)
            if kind == 0:
                for _ in range(rng.randint(1, 4)):
                    k = mdat + rng.randint(0, min(48, len(e) - mdat))
                    e[k] = (rng.randint(256) if rng.rand() < 0.5
                            else e[k] ^ (1 << rng.randint(8)))
            elif kind == 1:
                e = e[:rng.randint(mdat - 8, len(e))]
                if len(e) > mdat and rng.rand() < 0.5:
                    k = mdat + rng.randint(0, min(48, len(e) - mdat))
                    e[k] = rng.randint(256)
            else:
                k = rng.randint(0, len(e))
                e[k] = rng.randint(256)
            data = bytes(e)
            want = _avif_open(data)
            outcomes.add(want)
            assert _format_of(data) == want, (want, data.hex())
    assert {"AVIF", None} <= outcomes


def test_av1_sequence_header_parser():
    """av1_sequence_header on OBUs written here: a reduced still-picture
    header, a full one with timing and decoder model info, behind a
    temporal delimiter and padding; cut at every byte (False until the
    header is whole), a forbidden bit, a size field past the data."""
    def obu(kind, payload, size=True):
        head = bytes([(kind << 3) | (2 if size else 0)])
        return head + (bytes([len(payload)]) if size else b"") + payload

    def bits(fields):
        s = "".join(format(v, f"0{n}b") for n, v in fields)
        s += "0" * (-len(s) % 8)
        return bytes(int(s[i:i + 8], 2) for i in range(0, len(s), 8))

    reduced = bits([(3, 0), (1, 1), (1, 1), (5, 8), (4, 9), (4, 9),
                    (10, 639), (10, 479), (3, 0), (3, 0), (1, 0), (1, 0),
                    (1, 1), (1, 1), (8, 1), (8, 13), (8, 0), (1, 0),
                    (1, 0)])
    full = bits([(3, 0), (1, 0), (1, 0), (1, 1), (32, 1), (32, 30), (1, 1),
                 (1, 1), (1, 1), (5, 4), (32, 1), (5, 3), (5, 3), (1, 0),
                 (5, 0), (12, 0), (5, 9), (1, 0), (1, 1), (5, 0), (5, 0),
                 (1, 0), (4, 9), (4, 9), (10, 639), (10, 479), (1, 0),
                 (3, 0), (4, 0), (1, 1), (2, 0), (1, 1), (1, 0), (1, 0),
                 (3, 6),
                 (3, 0), (1, 0), (1, 0), (1, 0), (1, 0), (2, 0), (1, 0),
                 (1, 0)])
    for header in (reduced, full):
        data = obu(2, b"") + obu(15, b"\0\0\0") + obu(1, header)
        assert image_probe.av1_sequence_header(data)
        assert image_probe.av1_sequence_header(obu(1, header, False))
        for n in range(len(data)):
            assert not image_probe.av1_sequence_header(data[:n]), n
        assert not image_probe.av1_sequence_header(b"\x80" + data[1:])
        assert not image_probe.av1_sequence_header(
            data[:-len(header) - 1] + bytes([len(header) + 1]) + header)
