"""The port's model of Pillow 12.1's `Image.open` (data/image_probe.py,
what `image_io.read_image` tells a file's format by) against live
Pillow: the plugin order a fresh process builds, every plugin's
`_accept` on seeded prefixes, and the outcome of `Image.open` on
thousands of seeded files: each plugin's magic followed by seeded bytes,
files of Pillow's writers cut short and byte-edited, TGA-shaped headers
(TGA has no magic and comes after IM, IMT, IPTC, PCD and SPIDER, which
have none either: headers made so that each of those takes the file are
among them) and random bytes. The probe names Pillow's format where
Image.open opens the file, and raises ValueError where it raises;
`read_image` then gives Pillow's pixels for the formats read, raises
NotImplementedError naming any other format (EPS), and ValueError
where Pillow raises, in Image.open or in its load (the stubs, MPEG and
WMF, which Pillow opens and cannot load). For the six formats read
before the probe (BMP, GIF, JPEG, PNG, TIFF, WebP) their decoders are
left to raise where Pillow's
_open would (their own tests hold them to Pillow), and their byte edits
are not drawn here; nor are AVIF's, whose box structure the probe
models but whose ISOBMFF items libavif checks further: their edits are
drawn in tests/test_torch_image_blp_psd.py and test_torch_image_avif.py."""

import io
import json
import random
import struct
import subprocess
import sys
import warnings

import numpy as np
import pytest

from maskrcnn_tpu_torch.data import image_io, image_probe, native_image

pytest.importorskip("PIL")

# the formats whose decoders predate the probe (MPO: Pillow's name for a
# JPEG with an MPF segment)
OLD = {"BMP", "GIF", "JPEG", "PNG", "TIFF", "WEBP"}

MAGICS = {
    "BMP": b"BM", "DIB": struct.pack("<I", 40), "GIF": b"GIF89a",
    "JPEG": b"\xff\xd8\xff", "PPM": b"P6", "PNG": b"\x89PNG\r\n\x1a\n",
    "AVIF": b"\0\0\0\x1cftypavif", "BLP": b"BLP2", "BUFR": b"BUFR",
    "CUR": b"\0\0\2\0", "PCX": b"\x0a\x05",
    "DCX": struct.pack("<I", 987654321), "DDS": b"DDS |\0\0\0",
    "EPS": b"%!PS", "FITS": b"SIMPLE  =                    T",
    "FLI": b"\0\0\0\0\x12\xaf", "FTEX": b"FTEX",
    "GBR": struct.pack(">II", 28, 2), "GRIB": b"GRIB\0\0\0\1",
    "HDF5": b"\x89HDF\r\n\x1a\n", "J2K": b"\xff\x4f\xff\x51",
    "JP2": b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a", "ICNS": b"icns",
    "ICO": b"\0\0\1\0",
    "IM": b"Image type: RGB image\r\nImage size (x*y): 3*2\r\n",
    "IMT": b"width 3\nheight 2\npixel n8\n", "IPTC": b"\x1c\x03\x3c\x00\x02",
    "MCIDAS": b"\0\0\0\0\0\0\0\4", "MPEG": b"\0\0\1\xb3", "TIFF": b"II*\0",
    "MSP": b"DanM", "PCD": bytes(2048) + b"PCD_IPI", "PIXAR": b"\x80\xe8\0\0",
    "PSD": b"8BPS\0\1", "QOI": b"qoif", "SGI": b"\x01\xda",
    "SUN": b"\x59\xa6\x6a\x95", "TGA": b"\0\0\2",
    "WEBP": b"RIFF\0\0\0\0WEBPVP8 ", "WMF": b"\xd7\xcd\xc6\x9a\0\0",
    "EMF": b"\1\0\0\0", "XBM": b"#define", "XPM": b"/* XPM */",
    "XVTHUMB": b"P7 332",
}


def pillow_open(data: bytes):
    """("ok", format) where Image.open opens the file, ("none",) where it
    raises UnidentifiedImageError, ("raise", name) where it raises
    anything else."""
    from PIL import Image, UnidentifiedImageError
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            im = Image.open(io.BytesIO(data))
    except UnidentifiedImageError:
        return ("none",)
    except Exception as e:  # noqa: BLE001 - any error ends Image.open
        return ("raise", type(e).__name__)
    return ("ok", "JPEG" if im.format == "MPO" else im.format)


def pillow_rgb(data: bytes):
    from PIL import Image
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    except Exception:  # noqa: BLE001
        return None


def check(data: bytes, what: str) -> str:
    """Holds the probe and read_image to Pillow on one file; returns
    Pillow's outcome (its format, "none" or "raise")."""
    want = pillow_open(data)
    try:
        got = ("ok", image_probe.identify(data))
        if got[1] is None:
            got = ("none",)
    except ValueError:
        got = ("raise",)
    if got[0] == "ok" and got[1] in OLD and want[0] != "ok":
        # Pillow's _open refuses it: the old decoder must raise
        with pytest.raises((ValueError, NotImplementedError)):
            image_io.read_image(data)
        return want[0]
    if got == ("ok", "ICO") and want != got:
        # IcoImageFile loads its frame inside Image.open: a frame that
        # fails to load makes Image.open raise, or (a SyntaxError from a
        # PNG frame's chunks) pass the file on to plugins that cannot
        # load it either; the port's decoder raises the ValueError
        assert pillow_rgb(data) is None, what
        with pytest.raises(ValueError):
            image_io.read_image(data)
        return want[0]
    assert got[0] == want[0] and (want[0] != "ok" or got[1] == want[1]), (
        what, data[:48], want, got)
    if want[0] != "ok":
        with pytest.raises(ValueError):
            image_io.read_image(data)
        return want[0]
    fmt = want[1]
    if fmt in OLD:
        return fmt
    if fmt not in image_io.READ and fmt not in native_image.LOAD_ERRORS:
        with pytest.raises(NotImplementedError, match=fmt):
            image_io.read_image(data)
        return fmt
    pixels = pillow_rgb(data)
    if pixels is None:
        with pytest.raises(ValueError):
            image_io.read_image(data)
    else:
        got_px = image_io.read_image(data)
        assert got_px.shape == pixels.shape and np.array_equal(got_px,
                                                               pixels), what
    return fmt


def test_plugin_order_is_a_fresh_image_open_order():
    """ORDER is Image.ID as a fresh process's first Image.open builds it:
    preinit's five modules, then init's; the plugins without an _accept
    are IM, IMT, IPTC, PCD, SPIDER and TGA, and the probe has an accept
    for every other one."""
    code = ("import io, json\nfrom PIL import Image\n"
            "try:\n    Image.open(io.BytesIO(b'x'))\nexcept Exception:\n"
            "    pass\nImage.init()\n"
            "print(json.dumps([Image.ID, [k for k in Image.ID "
            "if Image.OPEN[k][1] is None]]))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True).stdout
    order, acceptless = json.loads(out)
    assert tuple(order) == image_probe.ORDER
    assert set(acceptless) == {"IM", "IMT", "IPTC", "PCD", "SPIDER", "TGA"}
    assert set(image_probe.ACCEPT) == set(order) - set(acceptless)
    assert set(image_probe.OPEN) == set(order)


def test_accepts_equal_pillows():
    """Every _accept on each magic, the magics cut short, and 4,000
    seeded 16-byte prefixes (an accept that raises is one that does not
    take the file)."""
    from PIL import Image
    Image.init()
    rng = random.Random(0)
    prefixes = [m[:16] for m in MAGICS.values()]
    prefixes += [m[:k] for m in MAGICS.values() for k in range(len(m[:16]))]
    prefixes += [bytes(rng.getrandbits(8) for _ in range(16))
                 for _ in range(4000)]
    for name, accept in image_probe.ACCEPT.items():
        pillow_accept = Image.OPEN[name][1]
        for p in prefixes:
            try:
                want = pillow_accept(p)
            except struct.error:
                # DIB's accept reads 4 bytes: _open_core passes a shorter
                # file on
                want = False
            assert bool(accept(p)) == (want is True), (name, p)


def _tails(seed: int):
    rng = random.Random(seed)
    for name, magic in MAGICS.items():
        for _ in range(30):
            n = rng.choice([0, 1, 2, 5, 10, 20, 40, 100, 300, 1000])
            pool = [0, 1, 2, 8, 10, 32, 255] if rng.random() < 0.3 else None
            tail = bytes(rng.choice(pool) if pool else rng.getrandbits(8)
                         for _ in range(n))
            yield name, magic + tail


@pytest.mark.parametrize("seed", [0, 1])
def test_each_plugins_magic_and_seeded_bytes(seed):
    outcomes = set()
    for name, data in _tails(seed):
        outcomes.add(check(data, name))
    # the tails reach the plugins' refusals, Image.open's errors and the
    # headers a few bytes make
    assert {"none", "raise", "BUFR", "GRIB", "HDF5", "IMT", "MPEG",
            "TGA"} <= outcomes


def _writer_files(seed: int):
    """Pillow's writers' files of the formats outside OLD and AVIF, a few
    of the writers here (Sun raster, CUR, DCX), each cut short and
    byte-edited."""
    sys.path.insert(0, str(image_io.__file__).rsplit("/maskrcnn_tpu_torch",
                                                      1)[0] + "/tests")
    import image_corpus as ic
    import image_writers as iw
    from PIL import Image
    rng = np.random.RandomState(seed)
    r = random.Random(seed)
    files = []
    for h, w in ((5, 3), (2, 9)):
        img = ic.seeded_image(rng, h, w)
        for fmt, mode, kw in (
                ("PPM", "1", {}), ("PPM", "L", {}), ("PPM", "RGB", {}),
                ("PPM", "I", {}), ("PPM", "F", {}), ("TGA", "L", {}),
                ("TGA", "P", {}), ("TGA", "RGBA", {}),
                ("TGA", "RGB", {"compression": "tga_rle"}),
                ("QOI", "RGBA", {}), ("ICO", "RGBA", {"sizes": [(w, h)]}),
                ("ICO", "RGBA", {"sizes": [(w, h)], "bitmap_format": "bmp"}),
                ("PCX", "P", {}), ("PCX", "1", {}), ("SGI", "RGB", {}),
                ("SGI", "RGBA", {"bpc": 2}), ("SPIDER", "F", {}),
                ("IM", "RGB", {}), ("MSP", "1", {}), ("EPS", "RGB", {}),
                ("JPEG2000", "RGB", {}), ("DDS", "RGB", {}),
                ("BLP", "P", {}), ("XBM", "1", {}), ("DIB", "RGB", {})):
            buf = io.BytesIO()
            Image.fromarray(img).convert(mode).save(buf, fmt, **kw)
            files.append((fmt, buf.getvalue()))
        files += [("SUN", iw.encode_sun(img, 24, 2, rng=rng)),
                  ("CUR", iw.encode_ico([(iw.ico_dib(img, 24), w, h, 24, 0)],
                                        kind=2)),
                  ("DCX", iw.encode_dcx([iw.encode_pcx(img, 8, 3)]))]
    for name, data in files:
        yield name, data
        for _ in range(6):
            yield name + " cut", data[:r.randrange(len(data))]
        for _ in range(14):
            e = bytearray(data)
            i = (r.randrange(min(len(data), 64)) if r.random() < 0.7
                 else r.randrange(len(data)))
            e[i] = r.getrandbits(8)
            yield name + " edited", bytes(e)


@pytest.mark.parametrize("seed", [0, 1])
def test_writers_files_cut_and_edited(seed):
    outcomes = {check(data, name) for name, data in _writer_files(seed)}
    assert {"none", "raise", "PPM", "TGA", "QOI", "ICO", "PCX", "DCX", "SGI",
            "SUN", "CUR", "DIB", "SPIDER", "IM", "EPS", "JPEG2000"} <= outcomes


def _tga_header(rng, id_field=b"", maptype=0, imagetype=2, depth=24,
                w=None, h=None, flags=0x20, map_start=0, map_len=0,
                map_depth=0):
    w = w or rng.randrange(1, 40)
    h = h or rng.randrange(1, 40)
    return struct.pack("<BBBHHBHHHHBB", len(id_field), maptype, imagetype,
                       map_start, map_len, map_depth, 0, 0, w, h, depth,
                       flags) + id_field


def _tga_shaped(seed: int, n: int = 2500):
    """Seeded TGA headers (every type, depth, map type, ID length, origin
    bits) with random bodies, and headers whose ID field makes IM, IMT,
    IPTC or PCD take the file before TGA is tried."""
    rng = random.Random(seed)
    for _ in range(n):
        h = bytearray(rng.getrandbits(8) for _ in range(18))
        h[1] = rng.choice([0, 1, 1, rng.getrandbits(8)])
        h[2] = rng.choice([1, 2, 3, 9, 10, 11, rng.getrandbits(8)])
        h[16] = rng.choice([1, 8, 16, 24, 32])
        h[12:16] = struct.pack("<HH", rng.randrange(1, 40),
                               rng.randrange(1, 40))
        if rng.random() < 0.5:
            h[0] = rng.choice([0, 28, 10, 32, 65, 73, 42])
        if rng.random() < 0.3:
            h[7] = rng.choice([16, 24, 32])
        body = bytes(rng.getrandbits(8) for _ in range(
            rng.choice([0, 10, 100, 3000])))
        if rng.random() < 0.2:
            body = body[:50] + b"\n" + body[50:]
        yield "TGA-shaped", bytes(h) + body
    for _ in range(10):
        w, h = rng.randrange(2, 9), rng.randrange(2, 9)
        data = bytes(rng.getrandbits(8) for _ in range(w * h * 3))
        # IM: a first line that matches its key: value pattern, then tags
        im_id = (b"x:\nImage type: RGB image\nImage size (x*y): "
                 + b"%d*%d\n\x1a" % (w, h))
        head = _tga_header(rng, b"", w=w + 0x2020, h=h + 0x2020)
        im = bytearray(head[:18])
        im[0] = ord("I")
        yield "TGA taken by IM", bytes(im) + im_id.ljust(73, b"\0") + data
        # IMT: a space first, then its lines and a form feed
        imt = bytearray(_tga_header(rng, bytes(32), w=w + 0x2020,
                                    h=h + 0x2020))
        imt[18:18 + 27] = b"\nwidth %d\nheight %d\npixel n8\n\x0c" % (
            w, h)
        yield "TGA taken by IMT", bytes(imt) + data
        # IPTC: 0x1C first; the header's first field spans the rest of it
        fields = (b"\x1c\x03\x3c\x00\x02\x01\x00"
                  + b"\x1c\x03\x14\x00\x02" + struct.pack(">H", w)
                  + b"\x1c\x03\x1e\x00\x02" + struct.pack(">H", h)
                  + b"\x1c\x03\x78\x00\x01\x01")
        iptc = bytes([0x1C, 1, 2, 0, 13]) + bytes([0, 24]) + bytes(5) + \
            struct.pack("<HH", w, h) + bytes([8, 0x20])
        yield "TGA taken by IPTC", iptc + fields + b"\x1c\x08\x0a\x00\x00" \
            + data
        # PCD: "PCD_" at byte 2048 of a valid TGA
        pcd = bytearray(_tga_header(rng, b"", w=32, h=32) + bytes(4000))
        pcd[2048:2052] = b"PCD_"
        yield "TGA taken by PCD", bytes(pcd)


@pytest.mark.parametrize("seed", [0, 1])
def test_tga_shaped_headers(seed):
    """TGA is taken only where no earlier plugin (IM, IMT, IPTC, PCD,
    SPIDER among them) takes the file."""
    seen = {}
    for name, data in _tga_shaped(seed):
        seen.setdefault(name, set()).add(check(data, name))
    assert "TGA" in seen["TGA-shaped"]
    for plugin in ("IM", "IMT", "IPTC", "PCD"):
        assert seen[f"TGA taken by {plugin}"] == {plugin}


def test_random_bytes():
    rng = random.Random(5)
    for _ in range(2000):
        data = bytes(rng.getrandbits(8) for _ in range(rng.choice(
            [0, 1, 3, 16, 64, 600])))
        check(data, "random")


def test_path_reads_as_pillow_opens_a_path(tmp_path):
    """An 8-bit PCX shorter than its VGA palette's 769 bytes: from bytes
    Pillow's seek stops at the file's start (no palette: mode L), from a
    path it raises; read_image follows the path or the bytes it is
    given."""
    from PIL import Image
    sys.path.insert(0, str(tmp_path))
    head = bytearray(128)
    struct.pack_into("<BBBBHHHH", head, 0, 10, 5, 1, 8, 0, 0, 2, 1)
    head[65] = 1
    struct.pack_into("<H", head, 66, 4)
    data = bytes(head) + bytes([0xC4, 7, 1, 2, 3, 4])
    path = tmp_path / "small.pcx"
    path.write_bytes(data)
    want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    assert np.array_equal(image_io.read_image(data), want)
    with pytest.raises(OSError):
        Image.open(path)
    with pytest.raises(ValueError, match="PCX"):
        image_io.read_image(path)
    assert image_io.format_of(data) == "PCX"
    with pytest.raises(ValueError, match="PCX"):
        image_io.format_of(data, path=True)


def test_a_jpeg_needs_three_marker_bytes():
    """Pillow's JPEG _accept takes \\xff\\xd8\\xff, not the SOI marker
    alone: a file of \\xff\\xd8 followed by other bytes is no JPEG to
    it (the reader took it for one before the probe)."""
    from PIL import Image
    buf = io.BytesIO()
    Image.new("RGB", (8, 8), (10, 20, 30)).save(buf, "JPEG")
    data = buf.getvalue()
    assert check(data, "JPEG") == "JPEG"
    assert check(b"\xff\xd8\x00" + data[3:], "SOI alone") == "none"


def test_jpeg2000_mode_is_pillows():
    """The probe's JPEG 2000 mode (image_probe.jpeg2000_header, one model
    of Jpeg2KImageFile._open that also names the format) is Image.open's
    mode on every JPEG 2000 file of the corpus (L, I;16 by the first
    component's precision, LA, RGB, RGBA from a raw codestream's SIZ; a
    JP2's ihdr, CMYK from colr, P and PA from pclr) and on cut and edited
    copies of their headers that Image.open still opens."""
    sys.path.insert(0, str(image_io.__file__).rsplit("/maskrcnn_tpu_torch",
                                                      1)[0] + "/tests")
    import image_corpus as ic
    from PIL import Image
    index = json.loads(ic.INDEX.read_text())
    names = sorted(n for n in index["files"] if n.startswith("jp2_")
                   and n.endswith("_5x3." + n.rsplit(".", 1)[1]))
    rng = random.Random(3)
    modes = set()
    for name in names:
        data = (ic.CORPUS / name).read_bytes()
        copies = [data] + [data[:rng.randrange(len(data))] for _ in range(2)]
        for _ in range(4):
            e = bytearray(data)
            e[rng.randrange(min(len(data), 120))] = rng.getrandbits(8)
            copies.append(bytes(e))
        for d in copies:
            try:
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")
                    im = Image.open(io.BytesIO(d))
            except Exception:  # noqa: BLE001 - Image.open refuses it
                continue
            if im.format != "JPEG2000":
                continue
            mode, size, palette = image_probe.jpeg2000_header(d)
            assert (mode, size) == (im.mode, im.size), name
            assert (palette is not None) == (mode in ("P", "PA")), name
            modes.add(mode)
    assert modes == {"L", "I;16", "LA", "RGB", "RGBA", "CMYK", "P", "PA"}
