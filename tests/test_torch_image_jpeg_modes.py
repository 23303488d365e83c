"""The JPEG modes the port reads since arithmetic coding, lossless frames
and block smoothing came in, and the libtiff route's own reading of a
TIFF directory, against Pillow 12.1.0 (libjpeg-turbo 3.1, libtiff 4.7.1)
live: seeded files of tests/jpeg_modes.py (Pillow's own libjpeg-turbo)
and single-byte edits of them, the QM coder's Qe table against
libjpeg-turbo's `jpeg_aritab`, Pillow's 64 KiB blocks that an arithmetic
scan cannot cross, the SIMD IDCT on coefficients of corrupt data, and
single-byte edits of the corpus's LZW, Deflate and PackBits TIFF files,
where libtiff's TIFFReadDirectory decides (rows that libtiff leaves
undecoded, which Pillow's output leaves undefined, are set aside and
counted)."""

import ctypes
import glob
import io
import os
import re
import struct
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from maskrcnn_tpu_torch.data import image_io

TESTS = Path(__file__).resolve().parent
sys.path.insert(0, str(TESTS))

import image_corpus as ic  # noqa: E402
import image_writers as iw  # noqa: E402
import jpeg_modes as jm  # noqa: E402

REPO = TESTS.parent
ARITH_SOURCE = REPO / "maskrcnn_tpu_torch" / "csrc" / "jpeg_arith.cpp"


def pillow(data: bytes) -> np.ndarray:
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def outcome(read, data: bytes):
    try:
        return read(data)
    except Exception as e:  # noqa: BLE001 - any error is an outcome
        return e


def differs(data: bytes) -> str:
    """'' where the port gives Pillow's outcome (its pixels, or an error
    where Pillow raises: a ValueError, or a NotImplementedError naming a
    mode the port does not read), else what differs."""
    want, got = outcome(pillow, data), outcome(image_io.read_image, data)
    if isinstance(want, Exception):
        if isinstance(got, (ValueError, NotImplementedError)):
            return ""
        return f"Pillow raised {want!r}, the port gave {got!r}"[:300]
    if isinstance(got, Exception):
        return f"Pillow read it, the port raised {got!r}"
    if got.shape != want.shape or not np.array_equal(got, want):
        return f"{int((got != want).any(-1).sum())} pixels differ"
    return ""


def edited(data: bytes, n: int, seed: int, lo: int = 2):
    """n copies of data, each with one byte of [lo, len) set at random."""
    rng = np.random.RandomState(seed)
    for _ in range(n):
        d = bytearray(data)
        d[rng.randint(lo, len(d))] = rng.randint(256)
        yield bytes(d)


def assert_like_pillow(files, edits: int, seed: int):
    bad = []
    for k, (what, data) in enumerate(files):
        for j, d in enumerate([data, *edited(data, edits, seed + k)]):
            why = differs(d)
            if why:
                bad.append((what, j, why))
    assert not bad, bad[:4]


# ------------------------------------------------------------ arithmetic

def test_qe_table_equals_libjpeg_turbos():
    """The committed Qe table (ITU T.81 Table D.2, packed as jaricom.c
    packs it) is libjpeg-turbo's `jpeg_aritab`, read from Pillow's
    libjpeg, entry by entry."""
    entries = re.findall(r"V\(0x([0-9a-f]{4}), (\d+), (\d+), (\d)\)",
                         ARITH_SOURCE.read_text())
    ours = [(int(q, 16) << 16) | (int(mps) << 8) | (int(sw) << 7) | int(lps)
            for q, lps, mps, sw in entries]
    assert len(ours) == 114
    assert ours == jm.aritab()


def _arith_files(h, w, seed):
    rng = np.random.RandomState(seed)
    img = ic.seeded_image(rng, h, w)
    cmyk = ic.seeded_image(rng, h, w, 4)
    dac = ((rng.randint(0, 4), rng.randint(4, 16), rng.randint(1, 63)),
           (0, 1, rng.randint(1, 63)))
    out = []
    for progressive in (False, True):
        for samp in ([(1, 1)] * 3, [(2, 1), (1, 1), (1, 1)],
                     [(2, 2), (1, 1), (1, 1)], [(1, 2), (1, 1), (1, 1)]):
            for restart in (0, 3):
                out.append((f"prog={progressive} {samp} rst={restart}",
                            jm.write(img, arith=True, progressive=progressive,
                                     sampling=samp, restart=restart)))
        out.append((f"prog={progressive} dac", jm.write(
            img, arith=True, progressive=progressive, dac=dac)))
        out.append((f"prog={progressive} gray", jm.write(
            img[..., 1], arith=True, progressive=progressive, restart=2)))
        out.append((f"prog={progressive} cmyk", jm.write(
            cmyk, arith=True, progressive=progressive)))
        out.append((f"prog={progressive} ycck", jm.write(
            cmyk, space=jm.YCCK, arith=True, progressive=progressive,
            sampling=[(2, 2), (1, 1), (1, 1), (2, 2)])))
    return out


@pytest.mark.parametrize("h,w", [(37, 53), (5, 3), (64, 48), (17, 129)],
                         ids=lambda v: str(v))
def test_seeded_arithmetic_files_equal_pillow(h, w):
    """Arithmetic-coded sequential and progressive files (4:4:4, 4:2:2,
    4:2:0, 4:4:0; with and without restarts; DAC conditioning; gray,
    CMYK and YCCK) of Pillow's libjpeg-turbo decode to Pillow's pixels."""
    files = _arith_files(h, w, h * 7 + w)
    for what, data in files:
        np.testing.assert_array_equal(image_io.read_image(data), pillow(data),
                                      err_msg=what)
    assert len(files) == 24


def test_arithmetic_transcodes_keep_the_pixels():
    """A Huffman file's coefficients re-coded arithmetic, sequential and
    progressive, with restarts (jpegtran -arithmetic), decode to the
    Huffman file's pixels, as in Pillow."""
    rng = np.random.RandomState(3)
    img = ic.seeded_image(rng, 45, 61)
    for kw in (dict(quality=90), dict(quality=70, subsampling="4:2:0"),
               dict(quality=80, progressive=True)):
        base = ic.pil_jpeg(img, **kw)
        want = image_io.read_image(base)
        for tkw in (dict(), dict(progressive=True), dict(restart=5)):
            data = jm.transcode(base, **tkw)
            np.testing.assert_array_equal(image_io.read_image(data), want)
            np.testing.assert_array_equal(pillow(data), want)


def test_arithmetic_edits_equal_pillow():
    """Single-byte edits of arithmetic-coded files give Pillow's outcome:
    a marker in the data (zero bytes from there), a magnitude or spectral
    overflow (the rest of the interval left), resynchronised restarts,
    edited DAC segments and frame headers."""
    files = _arith_files(29, 41, 5)
    assert_like_pillow([files[i] for i in (1, 4, 8, 11, 14, 16, 17)], 60,
                       seed=40)


def test_arithmetic_scan_past_pillows_block_raises():
    """Pillow hands libjpeg its file in blocks of 65536 bytes and an
    arithmetic scan cannot suspend: a scan whose data crosses the end of
    the block in which its SOS segment ends raises (Pillow's "broken data
    stream"), one that starts in a later block and ends in it decodes."""
    rng = np.random.RandomState(8)
    big = rng.randint(0, 256, (200, 200, 3)).astype(np.uint8)
    data = jm.write(big, arith=True, quality=95)
    assert len(data) > 65536
    with pytest.raises(OSError):
        pillow(data)
    with pytest.raises(ValueError, match="block"):
        image_io.read_image(data)
    small = jm.write(big[:40, :40], arith=True, quality=95)
    for pad_bytes, reads in ((64_000, False), (66_000, True),
                             (130_000, False), (131_500, True)):
        # APP15 segments before the frame move the scan's SOS segment
        pieces = -(-pad_bytes // 60_000)
        sizes = [pad_bytes // pieces] * (pieces - 1)
        sizes.append(pad_bytes - sum(sizes))
        pad = b"".join(b"\xff\xef" + struct.pack(">H", q - 2) + bytes(q - 4)
                       for q in sizes)
        moved = small[:2] + pad + small[2:]
        if reads:
            np.testing.assert_array_equal(image_io.read_image(moved),
                                          pillow(moved))
            np.testing.assert_array_equal(image_io.read_image(moved),
                                          image_io.read_image(small))
        else:
            with pytest.raises(OSError):
                pillow(moved)
            with pytest.raises(ValueError, match="block"):
                image_io.read_image(moved)


def test_arithmetic_jpeg_tiff_strip_equals_pillow():
    """An arithmetic-coded stream in a JPEG TIFF (compression 7) reaches
    libtiff's JPEG codec, whose source ends in a fake EOI rather than in
    Pillow's blocks: the port gives Pillow's outcome."""
    rng = np.random.RandomState(11)
    img = ic.seeded_image(rng, 24, 32)
    for kw in (dict(), dict(progressive=True)):
        stream = jm.write(img, space=jm.RGB, arith=True, **kw)
        data = iw.encode_tiff(img, compression=7, segments=[stream])
        assert differs(data) == "", kw


# -------------------------------------------------------------- lossless

def _lossless_files(h, w, seed):
    rng = np.random.RandomState(seed)
    img = ic.seeded_image(rng, h, w)
    out = []
    for psv in range(1, 8):
        for pt in (0, 2):
            out.append((f"rgb p{psv} pt{pt}", jm.write(
                img, predictor=psv, point_transform=pt, space=jm.RGB)))
    out.append(("ycc p3", jm.write(img, predictor=3)))
    out.append(("gray p6 pt1", jm.write(img[..., 2], predictor=6,
                                        point_transform=1)))
    out.append(("ycc 4:2:0 p4", jm.write(img, predictor=4,
                                        sampling=[(2, 2), (1, 1), (1, 1)])))
    out.append(("ycc 4:2:2 p5", jm.write(img, predictor=5,
                                        sampling=[(2, 1), (1, 1), (1, 1)])))
    out.append(("rgb p2 restart rows", jm.write(img, predictor=2,
                                                restart=-1, space=jm.RGB)))
    out.append(("rgb p7 restart 2 rows", jm.write(img, predictor=7,
                                                  restart=-2, space=jm.RGB)))
    return out


@pytest.mark.parametrize("h,w", [(37, 53), (5, 3), (33, 18)],
                         ids=lambda v: str(v))
def test_seeded_lossless_files_equal_pillow(h, w):
    """Lossless files (predictors 1-7, point transforms 0 and 2, RGB,
    YCbCr and gray, subsampled chroma, restarts every MCU row or two) of
    Pillow's libjpeg-turbo decode to Pillow's pixels; predictor 1 with no
    point transform gives the RGB input back."""
    files = _lossless_files(h, w, h + w)
    for what, data in files:
        np.testing.assert_array_equal(image_io.read_image(data), pillow(data),
                                      err_msg=what)
    rng = np.random.RandomState(h + w)
    img = ic.seeded_image(rng, h, w)
    np.testing.assert_array_equal(image_io.read_image(files[0][1]), img)
    assert len(files) == 20


def test_lossless_edits_equal_pillow():
    """Single-byte edits of lossless files give Pillow's outcome: SSSS 16,
    markers in the data (zero differences from a reset predictor for the
    rest of the interval), restart markers and scan parameters edited,
    the quantization table index no lossless frame reads."""
    files = _lossless_files(23, 31, 9)
    assert_like_pillow([files[i] for i in (0, 9, 13, 15, 16, 18, 19)], 60,
                       seed=70)


def test_lossless_colour_conversion_raises_as_in_pillow():
    """libjpeg-turbo converts no colour space in a lossless frame: where
    the Adobe transform or JFIF makes its components YCbCr (Pillow asks
    for RGB) or YCCK (CMYK), the decode raises; RGB, CMYK and gray
    components decode."""
    rng = np.random.RandomState(16)
    img = ic.seeded_image(rng, 16, 24)
    rgb = jm.write(img, predictor=2)
    at = rgb.index(b"Adobe") + 11
    for transform in (0, 1, 2, 0xAA):
        data = rgb[:at] + bytes([transform]) + rgb[at + 1:]
        assert differs(data) == "", transform
        if transform:
            with pytest.raises(ValueError, match="color conversion"):
                image_io.read_image(data)
    cmyk = ic.seeded_image(rng, 16, 24, 4)
    for data in (jm.write(cmyk, predictor=1),
                 jm.write(cmyk, space=jm.YCCK, predictor=1),
                 jm.write(img[..., 0], predictor=3)):
        assert differs(data) == ""


def test_sof11_hierarchical_12_bit_and_2_component_files_are_refused():
    """What Pillow fails on the port fails on too (a ValueError): an
    arithmetic lossless frame and hierarchical frames, which libjpeg-turbo
    does not decode (named), and 12-bit samples, which no plugin of
    Pillow's opens."""
    rng = np.random.RandomState(13)
    img = ic.seeded_image(rng, 16, 16)
    lossless = jm.write(img, predictor=1)
    sof11 = lossless.replace(b"\xff\xc3", b"\xff\xcb", 1)
    base = ic.pil_jpeg(img)
    cases = [(sof11, "arithmetic-coded lossless")]
    for marker, word in ((0xC5, "hierarchical sequential"),
                         (0xC6, "hierarchical progressive"),
                         (0xCD, "arithmetic-coded hierarchical")):
        cases.append((ic.patched_sof(base, marker=marker), word))
    cases.append((ic.patched_sof(base, precision=12), "no plugin of Pillow's"))
    for data, word in cases:
        with pytest.raises(Exception):
            pillow(data)
        with pytest.raises(ValueError, match=word):
            image_io.read_image(data)


# ------------------------------------------------------- block smoothing

def test_smoothing_of_scans_cut_short_equals_pillow():
    """A progressive file (4:2:0, 4:4:4, 4:2:2; with and without its
    chroma's last refinement, so that smoothing runs) whose scans are cut
    short at quarters of their data: the rows past the last whole iMCU
    row of the last scan smooth with the coefficient bits from before it
    (jdcoefct.c's last_good_iMCU_row), as in Pillow."""
    bad = total = 0
    for seed, sub in enumerate(("4:2:0", "4:4:4", "4:2:2")):
        rng = np.random.RandomState(50 + seed)
        img = ic.seeded_image(rng, rng.randint(20, 90), rng.randint(20, 90))
        for full in (ic.pil_jpeg(img, quality=85, progressive=True,
                                 subsampling=sub),):
            full = ic.drop_scan(full, -2)
            offs = ic.scan_offsets(full)
            for k in range(len(offs)):
                sos = offs[k]
                start = sos + 2 + struct.unpack(">H", full[sos + 2:sos + 4])[0]
                nxt = offs[k + 1] if k + 1 < len(offs) else \
                    full.rindex(b"\xff\xd9")
                for frac in (0.0, 0.25, 0.5, 0.75):
                    cut = full[:start + int((nxt - start) * frac)] + full[nxt:]
                    total += 1
                    bad += differs(cut) != ""
    assert total > 60 and bad == 0


def test_smoothed_edits_equal_pillow():
    """Single-byte edits of progressive files libjpeg-turbo smooths give
    Pillow's outcome (frame sizes edited to thousands of blocks among
    them)."""
    rng = np.random.RandomState(12)
    img = ic.seeded_image(rng, 37, 53)
    files = [("drop last", ic.drop_scan(ic.pil_jpeg(img, quality=85,
                                                    progressive=True), -1)),
             ("first 3", ic.first_scans(ic.pil_jpeg(
                 img, quality=80, progressive=True, subsampling="4:4:4"), 3))]
    assert_like_pillow(files, 80, seed=90)


def test_idct_of_corrupt_coefficients_equals_libjpeg_turbos_simd():
    """Blocks whose dequantized coefficients leave 16 bits (quantizers up
    to 65535): the port's IDCT gives the bits of libjpeg-turbo's SIMD
    islow IDCT, which Pillow runs, where jidctint.c's C would differ."""
    rng = np.random.RandomState(5)
    for trial in range(24):
        scale = (3, 30, 300, 1023)[trial % 4]
        coefs = rng.randint(-scale, scale + 1, (2, 3, 64))
        coefs *= rng.rand(2, 3, 64) < (0.05, 0.3, 1.0)[trial % 3]
        coefs[..., 0] = rng.randint(-1000, 1000, (2, 3))
        if trial % 5 == 0:
            coefs[0, 0, 1:] = 0
        quant = rng.randint(1, (8, 64, 255, 65535)[trial % 4] + 1, 64)
        data = jm.with_coefficients(coefs, quant)
        np.testing.assert_array_equal(image_io.read_image(data), pillow(data),
                                      err_msg=str(trial))


def _huffman_restart_files():
    rng = np.random.RandomState(17)
    img = ic.seeded_image(rng, 37, 53)
    return {
        "baseline 4:2:0 rst=1": ic.pil_jpeg(img, quality=85,
                                            restart_marker_blocks=1),
        "baseline 4:4:4 rst=rows": ic.pil_jpeg(img, quality=90,
                                               subsampling="4:4:4",
                                               restart_marker_rows=1),
        "progressive 4:2:0 rst=2": ic.pil_jpeg(img, quality=80,
                                               progressive=True,
                                               restart_marker_blocks=2),
        "gray rst=3": ic.pil_jpeg(img[..., 0], quality=75,
                                  restart_marker_blocks=3),
    }


@pytest.mark.parametrize("what", list(_huffman_restart_files()))
def test_huffman_restart_codes_resync_as_libjpeg(what):
    """Each RSTn of a Huffman scan rewritten to RST(n-2), (n-1), (n+1) and
    (n+2): libjpeg's read_restart_marker and jpeg_resync_to_restart keep
    one of the next two unread (the interval after it decodes as zeros),
    skip one of the two before it with the interval that follows, and the
    port gives Pillow's pixels in each case."""
    data = _huffman_restart_files()[what]
    sos = data.index(b"\xff\xda")
    codes = [m.start() + 1 for m in re.finditer(rb"\xff[\xd0-\xd7]",
                                                data[sos:])]
    assert len(codes) >= 4
    bad = []
    for at in (sos + c for c in codes):
        n = data[at] - 0xD0
        for step in (-2, -1, 1, 2):
            d = bytearray(data)
            d[at] = 0xD0 + (n + step) % 8
            why = differs(bytes(d))
            if why:
                bad.append((at, step, why))
    assert not bad, bad[:4]


def test_baseline_without_huffman_tables_takes_the_standard_ones():
    """libjpeg-turbo's sequential Huffman decoder fills a table slot 0 or
    1 no DHT defined with T.81 Annex K's (for Motion-JPEG); its
    progressive and lossless decoders do not, and raise."""
    rng = np.random.RandomState(14)
    img = ic.seeded_image(rng, 20, 28)
    for data in (ic.pil_jpeg(img, quality=75), ic.pil_jpeg(img, quality=75,
                                                           progressive=True),
                 jm.write(img, predictor=1)):
        i = data.index(b"\xff\xc4")
        cut = data[:i] + data[i + 2 + struct.unpack(">H",
                                                    data[i + 2:i + 4])[0]:]
        assert differs(cut) == ""


# --------------------------------------------------- libtiff's directory

def _undefined(data: bytes, tmp: Path) -> bool:
    """Whether libtiff (Pillow's, by ctypes) leaves bytes of a strip or
    tile undecoded where Pillow reads the file: its decode into buffers
    of two fills differs."""
    if isinstance(outcome(pillow, data), Exception):
        return False
    import PIL
    libs = os.path.join(os.path.dirname(os.path.dirname(PIL.__file__)),
                        "pillow.libs")
    lib = ctypes.CDLL(sorted(glob.glob(os.path.join(libs,
                                                    "libtiff-*.so*")))[0])
    lib.TIFFOpen.restype = ctypes.c_void_p
    lib.TIFFOpen.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.TIFFSetWarningHandler.argtypes = [ctypes.c_void_p]
    lib.TIFFSetErrorHandler.argtypes = [ctypes.c_void_p]
    lib.TIFFSetWarningHandler(None)
    lib.TIFFSetErrorHandler(None)
    for name in ("TIFFClose", "TIFFIsTiled", "TIFFStripSize", "TIFFTileSize",
                 "TIFFNumberOfStrips", "TIFFNumberOfTiles"):
        getattr(lib, name).argtypes = [ctypes.c_void_p]
    for name in ("TIFFStripSize", "TIFFTileSize"):
        getattr(lib, name).restype = ctypes.c_ssize_t
    for kind in ("Strip", "Tile"):
        read = getattr(lib, f"TIFFReadEncoded{kind}")
        read.argtypes = [ctypes.c_void_p, ctypes.c_uint32, ctypes.c_void_p,
                         ctypes.c_ssize_t]
        read.restype = ctypes.c_ssize_t
    path = tmp / "libtiff.tif"
    path.write_bytes(data)
    t = lib.TIFFOpen(str(path).encode(), b"r")
    if not t:
        return False
    try:
        kind = "Tile" if lib.TIFFIsTiled(t) else "Strip"
        size = getattr(lib, f"TIFF{kind}Size")(t)
        for s in range(getattr(lib, f"TIFFNumberOf{kind}s")(t)):
            got = []
            for fill in (0x55, 0xAA):
                buf = ctypes.create_string_buffer(bytes([fill]) * size, size)
                getattr(lib, f"TIFFReadEncoded{kind}")(t, s, buf, -1)
                got.append(buf.raw)
            if got[0] != got[1]:
                return True
        return False
    finally:
        lib.TIFFClose(t)


LIBTIFF_FILES = sorted(
    p.name for p in ic.CORPUS.iterdir()
    if p.name.startswith("tiff_") and p.suffix == ".tif"
    and re.search(r"lzw|deflate|packbits", p.name))


# the TIFF modes the port refuses by name that Pillow reads (ROADMAP
# Queue 1), which an edited Photometric or Compression can make
REFUSED_TIFF = (r"NotImplementedError\([\"']TIFF: (YCbCr images that are not "
                r"JPEG|old-style JPEG|ThunderScan|SGILog|WebP|LAB|16-bit CMYK)")


@pytest.mark.parametrize("part", range(4))
def test_libtiff_directory_edits_equal_pillow(part, tmp_path):
    """Single-byte edits anywhere in the corpus's LZW, Deflate and PackBits
    TIFF files (three each of every such file, 2,400 and more in all):
    each gives Pillow's outcome, where libtiff's TIFFReadDirectory reads
    the directory again (the first of a repeated tag, the types and counts
    each tag's reader takes, PlanarConfiguration and RowsPerStrip values
    it refuses, strip arrays padded to the strip count, StripByteCounts
    estimated or running past the file, the Colormap a palette image
    needs) and libtiff decodes (an LZW strip that does not start with a
    clear code). Edits whose strips libtiff leaves partly undecoded, which
    Pillow's output leaves undefined, are set aside and named, as are
    edits that make a mode the port refuses by name (REFUSED_TIFF)."""
    files = LIBTIFF_FILES[part::4]
    bad, undefined, refused, total = [], [], [], 0
    for k, name in enumerate(files):
        data = (ic.CORPUS / name).read_bytes()
        rng = np.random.RandomState(1000 + 97 * part + k)
        for _ in range(40):
            d = bytearray(data)
            pos = rng.randint(0, len(d))
            d[pos] = rng.randint(256)
            d = bytes(d)
            total += 1
            why = differs(d)
            if why and _undefined(d, tmp_path):
                undefined.append((name, pos))
            elif why and re.search(REFUSED_TIFF, why):
                refused.append((name, pos))
            elif why:
                bad.append((name, pos, why))
    assert total >= 600 and len(undefined) <= total // 50, undefined
    assert len(refused) <= total // 100, refused
    assert not bad, bad[:4]


def _lzw_literals(values) -> bytes:
    """An LZW strip of a clear code, `values` as literal codes and the end
    code, with the code widths a decoder's growing table sets (no clear
    code as the table fills)."""
    codes, nbits, free, maxcode = [(256, 9)], 9, 258, 510
    for k, v in enumerate(values):
        codes.append((int(v), nbits))
        if k:
            free += 1
            if free > maxcode:
                nbits = min(nbits + 1, 12)
                maxcode = (1 << nbits) - 2
    codes.append((257, nbits))
    acc = nacc = 0
    out = bytearray()
    for code, width in codes:
        acc, nacc = (acc << width) | code, nacc + width
        while nacc >= 8:
            out.append((acc >> (nacc - 8)) & 0xFF)
            nacc -= 8
    if nacc:
        out.append((acc << (8 - nacc)) & 0xFF)
    return bytes(out)


def _tag_entry(data: bytes, tag: int) -> int:
    order = ">" if data[:2] == b"MM" else "<"
    ifd = struct.unpack(order + "I", data[4:8])[0]
    count = struct.unpack(order + "H", data[ifd:ifd + 2])[0]
    for k in range(count):
        at = ifd + 2 + 12 * k
        if struct.unpack(order + "H", data[at:at + 2])[0] == tag:
            return at
    raise KeyError(tag)


def _patched(data: bytes, entry: int, **fields) -> bytes:
    """The file with the IFD entry of tag `entry` given another tag, type,
    count or value."""
    at = _tag_entry(data, entry)
    out = bytearray(data)
    for name, (off, fmt) in {"tag": (0, "H"), "type": (2, "H"),
                             "count": (4, "I"), "value": (8, "I")}.items():
        if name in fields:
            out[at + off:at + off + struct.calcsize(fmt)] = struct.pack(
                "<" + fmt, fields[name])
    return bytes(out)


def test_libtiff_route_edges_equal_pillow():
    """What the edit sweep found, case by case, against live Pillow:
    libtiff's LZW table grows 1,024 entries past 4,095 before a clear code
    must come; a RowsPerStrip past 2**31 fails Pillow's strip buffer
    (0xFFFFFFFF is the whole image); Pillow asks libtiff for its rows of
    its own mode (an IFD it stops reading early leaves it one band where
    libtiff has three), which must hold a whole strip; libtiff's
    StripByteCounts estimate counts an InkNames entry one longer where no
    byte of it is a NUL; and a size, compression, photometric or
    samples tag that Pillow reads as bytes, text or a fraction ends its
    open."""
    rng = np.random.RandomState(17)
    outcomes = []
    for n in (4500, 5000):
        values = rng.randint(0, 256, n)
        data = iw.encode_tiff(values[None, :].astype(np.uint8), photometric=1,
                              compression=5, segments=[_lzw_literals(values)])
        outcomes.append(isinstance(outcome(image_io.read_image, data),
                                   Exception))
        assert differs(data) == "", n
    assert outcomes == [False, True]
    img = rng.randint(0, 256, (20, 13, 3)).astype(np.uint8)
    one_strip = iw.encode_tiff(img, compression=5, rows_per_strip=20)
    for rps in (2 ** 31 - 1, 2 ** 31, 0xCC000008, 0xFFFFFFFF):
        data = _patched(one_strip, 278, type=4, value=rps)
        assert differs(data) == "", hex(rps)
    for comp, pred in ((5, 1), (8, 2), (50000, 2), (34925, 1), (32773, 1)):
        for rps in (None, 2, 8, 100):
            small = rng.randint(0, 256, (5, 3, 3)).astype(np.uint8)
            kw = {} if rps is None else {"rows_per_strip": min(rps, 5)}
            data = iw.encode_tiff(small, compression=comp, predictor=pred,
                                  **kw)
            if rps is not None:
                data = _patched(data, 278, type=4, value=rps)
            data = _patched(data, 262, count=0x37000001)
            assert differs(data) == "", (comp, pred, rps)
    la = (ic.CORPUS / "tiff_la_lzw_5x3.tif").read_bytes()
    for typ in (1, 2, 3, 4, 6, 7, 9):
        for count in (1, 2, 3, 5):
            data = _patched(la, 279, tag=333, type=typ, count=count)
            assert differs(data) == "", (typ, count)
    rgb = (ic.CORPUS / "tiff_rgb_lzw_5x3.tif").read_bytes()
    for tag in (256, 257, 258, 259, 262, 277):
        for typ in (1, 2, 5, 7, 11):
            data = _patched(rgb, tag, type=typ)
            assert differs(data) == "", (tag, typ)
