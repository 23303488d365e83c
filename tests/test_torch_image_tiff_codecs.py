"""TIFF's ZSTD (50000), LZMA (34925) and CCITT (2, 3, 4, 32771)
compressions in the port's reader (csrc/tiff_zstd.cpp, tiff_xz.cpp and
tiff_fax.cpp, compiled into the image library beside image_decode.cpp)
against Pillow 12.1.0 over libtiff 4.7.1, libzstd 1.5.7 and liblzma
5.8.2: seeded strips written here and their byte-edited copies give
Pillow's outcome, its pixels or an error.

ZSTD frames come from Pillow's bundled libzstd by ctypes
(tests/image_writers.zstd_frame), .xz streams from the standard
library's lzma, CCITT data from Pillow's writer and from
tests/image_writers.fax_encode (RLEW, T4Options, tiles, FillOrder 2).
Where libtiff leaves rows of a strip or tile undecoded (T.6 data that
ends early; a fax tile whose decode fails, which TIFFReadEncodedTile
takes for success), Pillow's pixels there are whatever its buffer held,
so those files are not compared: Pillow's libtiff, called by ctypes into
buffers of two fills, says which they are."""

import ctypes
import glob
import io
import lzma
import os
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


def edits(data: bytes, lo: int, hi: int, n: int, seed: int):
    """n copies of data with one to three bytes of [lo, hi) set or a bit
    flipped."""
    rng = np.random.RandomState(seed)
    for _ in range(n):
        d = bytearray(data)
        for _ in range(rng.randint(1, 4)):
            p = rng.randint(lo, hi)
            if rng.rand() < 0.6:
                d[p] = rng.randint(256)
            else:
                d[p] ^= 1 << rng.randint(8)
        yield bytes(d)


def assert_edits_like_pillow(data: bytes, n: int, seed: int, keep=None):
    """The file and n byte-edited copies of its data (between the header
    and the first directory) give Pillow's outcome; `keep(d)` False
    leaves a copy out."""
    end = int.from_bytes(data[4:8], "big" if data[:2] == b"MM" else "little")
    bad = []
    for k, d in enumerate([data, *edits(data, 8, end, n, seed)]):
        if keep is not None and not keep(d):
            continue
        why = same_outcome(d)
        if why:
            bad.append((k, why))
    assert not bad, bad[:5]


# ------------------------------------------------------------------ ZSTD

def _image(seed: int, h: int, w: int, kind: str) -> np.ndarray:
    rng = np.random.RandomState(seed)
    if kind == "noise":
        return rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    if kind == "flat":
        return np.full((h, w, 3), rng.randint(256), np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([(xx * 3 + yy) % 256, (yy * 5) % 256,
                    ((xx ^ yy) * 7) % 256], -1)
    return (img + rng.randint(0, 9, img.shape)).astype(np.uint8)


ZSTD_CASES = [
    dict(level=1), dict(level=3, checksum=True), dict(level=9),
    dict(level=19, content_size=False), dict(level=22, checksum=True),
    dict(level=-5), dict(level=3, window_log=10, content_size=False),
    dict(level=12, ldm=True, window_log=11, checksum=True,
         content_size=False),
]


@pytest.mark.parametrize("k,kw", list(enumerate(ZSTD_CASES)))
def test_zstd_levels_and_options_equal_pillow(k, kw):
    """libzstd's levels 1-22 and negative, the checksum, frames with and
    without their content size (libzstd's single pass or its streaming
    decoder), small windows whose output buffer wraps, long-distance
    matching; predictor 2, strips; and byte-edited copies."""
    img = _image(k, 90 + 7 * k, 130, ("texture", "noise", "flat")[k % 3])
    data = iw.encode_tiff(img, compression=50000, zstd=kw,
                          predictor=1 + k % 2, rows_per_strip=40)
    assert not same_outcome(data)
    assert np.array_equal(image_io.read_image(data), img)
    assert_edits_like_pillow(data, 60, seed=k)


@pytest.mark.parametrize("level", [*range(1, 23), -1, -7])
def test_zstd_every_level_equals_pillow(level):
    """Each of libzstd's levels 1-22 (and two negative ones): its block
    and sequence shapes, with the checksum on odd levels; and a few
    byte-edited copies."""
    img = _image(100 + level, 64, 96, "texture")
    data = iw.encode_tiff(img, compression=50000, predictor=2,
                          zstd=dict(level=level, checksum=bool(level % 2)))
    assert np.array_equal(image_io.read_image(data), img)
    assert_edits_like_pillow(data, 12, seed=100 + level)


def test_zstd_frames_in_a_strip_equal_pillow():
    """Two frames (libtiff stops at the first frame's end), a skippable
    frame first or last, data after the frame, a frame short of the
    strip or past it, a truncated frame, a bad checksum, a window past
    libzstd's limit with and without a content size, a dictionary ID,
    the reserved bit, and an empty frame, each as Pillow reads it."""
    img = _image(1, 40, 50, "noise")
    raw = img.tobytes()
    half = len(raw) // 2
    skip = (0x184D2A53).to_bytes(4, "little") + (5).to_bytes(4, "little") \
        + b"hello"
    frame = iw.zstd_frame(raw, checksum=True, content_size=False)

    def edit(f, pos, value):
        f = bytearray(f)
        f[pos] = value
        return bytes(f)

    segs = [
        iw.zstd_frame(raw[:half]) + iw.zstd_frame(raw[half:]),
        iw.zstd_frame(raw) + iw.zstd_frame(raw[:10]),
        skip + iw.zstd_frame(raw), iw.zstd_frame(raw) + skip,
        iw.zstd_frame(raw) + b"junk" * 3, iw.zstd_frame(raw)[:-5],
        iw.zstd_frame(raw + b"x" * 100, content_size=False, checksum=True),
        iw.zstd_frame(raw[:-3]), iw.zstd_frame(b""),
        frame[:-1] + bytes([frame[-1] ^ 1]),
        edit(frame, 5, (18 << 3) | 1),          # window 2**28 + 1/8
        edit(iw.zstd_frame(raw), 4, iw.zstd_frame(raw)[4] | 1),  # dict ID
        edit(frame, 4, frame[4] | 8),            # reserved bit
    ]
    for k, seg in enumerate(segs):
        data = iw.encode_tiff(img, compression=50000, segments=[seg])
        assert not same_outcome(data), (k, same_outcome(data))


# ----------------------------------------------------------------- LZMA

def _preset(preset: int) -> list:
    """LZMA2 at an xz preset with its dictionary cut to 1 MiB (the strips
    are smaller; the encoder then needs tens of MiB, not 674)."""
    return [{"id": lzma.FILTER_LZMA2, "preset": preset,
             "dict_size": 1 << 20}]


XZ_CASES = (
    [dict(check=c, filters=_preset(p))
     for c, p in ((lzma.CHECK_NONE, 0), (lzma.CHECK_CRC32, 3),
                  (lzma.CHECK_CRC64, 6), (lzma.CHECK_SHA256, 9))]
    + [dict(filters=_preset(p | lzma.PRESET_EXTREME)) for p in (0, 5, 9)]
    + [dict(filters=[{"id": lzma.FILTER_DELTA, "dist": d},
                     {"id": lzma.FILTER_LZMA2, "preset": 1}])
       for d in (1, 3, 256)])


@pytest.mark.parametrize("k,kw", list(enumerate(XZ_CASES)))
def test_xz_checks_presets_and_delta_equal_pillow(k, kw):
    """.xz streams of every check (none, CRC32, CRC64, SHA-256), presets
    with and without PRESET_EXTREME, Delta before LZMA2, random data
    (uncompressed LZMA2 chunks); predictor 2, strips; and byte-edited
    copies."""
    img = _image(20 + k, 70 + 5 * k, 110, ("texture", "noise", "flat")[k % 3])
    data = iw.encode_tiff(img, compression=34925, xz=kw,
                          predictor=1 + k % 2, rows_per_strip=30)
    assert not same_outcome(data)
    assert np.array_equal(image_io.read_image(data), img)
    assert_edits_like_pillow(data, 50, seed=20 + k)


@pytest.mark.parametrize("preset", [p | e for e in (0, lzma.PRESET_EXTREME)
                                    for p in range(10)])
def test_xz_every_preset_equals_pillow(preset):
    """Each xz preset 0-9, with and without PRESET_EXTREME (dictionary
    sizes, lc/lp/pb, match finders), on a CRC64 stream; and a few
    byte-edited copies."""
    img = _image(200 + preset % 64, 48, 80, "texture")
    data = iw.encode_tiff(img, compression=34925, predictor=2,
                          xz=dict(filters=_preset(preset)))
    assert np.array_equal(image_io.read_image(data), img)
    assert_edits_like_pillow(data, 10, seed=200 + preset % 64)


def _with_check(stream: bytes, check: int) -> bytes:
    """An .xz stream with its header's and footer's check ID set (their
    CRC32s made again)."""
    import zlib
    s = bytearray(stream)
    for flags in (6, len(s) - 4):
        s[flags + 1] = check
    s[8:12] = zlib.crc32(bytes(s[6:8])).to_bytes(4, "little")
    s[-8 - 4:-8] = zlib.crc32(bytes(s[-8:-2])).to_bytes(4, "little")
    return bytes(s)


def test_xz_streams_and_filters_as_liblzma_reads_them():
    """A check ID liblzma does not know is skipped unverified (a stream
    made with none, its ID changed to 2 and its field left empty: liblzma
    then takes 4 bytes of the index as the check); two streams (the second
    never read); a truncated stream; Delta of distance 2 and 4 in one
    chain; and each BCJ filter the standard library writes decodes as
    liblzma decodes it (ARM64 and RISC-V: test_torch_image_tiff_rgba)."""
    img = _image(3, 30, 40, "texture")
    raw = img.tobytes()
    two = iw.xz_stream(raw[:100]) + iw.xz_stream(raw[100:])
    segs = [iw.xz_stream(raw) + iw.xz_stream(b"more"), two,
            iw.xz_stream(raw)[:-30],
            _with_check(iw.xz_stream(raw, check=lzma.CHECK_NONE), 2),
            iw.xz_stream(raw, filters=[{"id": lzma.FILTER_DELTA, "dist": 2},
                                       {"id": lzma.FILTER_DELTA, "dist": 4},
                                       {"id": lzma.FILTER_LZMA2}])]
    for k, seg in enumerate(segs):
        data = iw.encode_tiff(img, compression=34925, segments=[seg])
        assert not same_outcome(data), (k, same_outcome(data))
    names = {lzma.FILTER_X86: "x86", lzma.FILTER_POWERPC: "PowerPC",
             lzma.FILTER_IA64: "IA-64", lzma.FILTER_ARM: "ARM",
             lzma.FILTER_ARMTHUMB: "ARM-Thumb", lzma.FILTER_SPARC: "SPARC"}
    for fid, name in names.items():
        seg = iw.xz_stream(raw, filters=[{"id": fid},
                                         {"id": lzma.FILTER_LZMA2}])
        data = iw.encode_tiff(img, compression=34925, segments=[seg])
        assert not isinstance(outcome(pillow, data), Exception)
        assert not same_outcome(data), (name, same_outcome(data))


# ---------------------------------------------------------------- CCITT

_LIBTIFF = None


def _libtiff():
    """Pillow's bundled libtiff (4.7.1), by ctypes."""
    global _LIBTIFF
    if _LIBTIFF is None:
        import PIL
        libs = os.path.join(os.path.dirname(os.path.dirname(PIL.__file__)),
                            "pillow.libs")
        lib = ctypes.CDLL(sorted(glob.glob(os.path.join(
            libs, "libtiff-*.so*")))[0])
        lib.TIFFOpen.restype = ctypes.c_void_p
        lib.TIFFOpen.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
        lib.TIFFClose.argtypes = [ctypes.c_void_p]
        lib.TIFFSetWarningHandler.argtypes = [ctypes.c_void_p]
        lib.TIFFSetErrorHandler.argtypes = [ctypes.c_void_p]
        lib.TIFFSetWarningHandler(None)
        lib.TIFFSetErrorHandler(None)
        for kind in ("Strip", "Tile"):
            read = getattr(lib, f"TIFFReadEncoded{kind}")
            read.argtypes = [ctypes.c_void_p, ctypes.c_uint32,
                             ctypes.c_void_p, ctypes.c_ssize_t]
            read.restype = ctypes.c_ssize_t
            for name in (f"TIFF{kind}Size", f"TIFFNumberOf{kind}s"):
                getattr(lib, name).argtypes = [ctypes.c_void_p]
            getattr(lib, f"TIFF{kind}Size").restype = ctypes.c_ssize_t
            getattr(lib, f"TIFFNumberOf{kind}s").restype = ctypes.c_uint32
        _LIBTIFF = lib
    return _LIBTIFF


def undefined(data: bytes, tmp: Path) -> bool:
    """Whether libtiff leaves a pixel of the image undecoded (its decode
    of every strip or tile into buffers of two fills differs) where Pillow
    reads the file."""
    if isinstance(outcome(pillow, data), Exception):
        return False
    lib = _libtiff()
    path = tmp / "libtiff.tif"
    path.write_bytes(data)
    im = Image.open(io.BytesIO(data))
    tiled = 322 in im.tag_v2
    width = im.tag_v2[322] if tiled else im.size[0]
    kind = "Tile" if tiled else "Strip"
    t = lib.TIFFOpen(str(path).encode(), b"rm")
    try:
        size = getattr(lib, f"TIFF{kind}Size")(t)
        row = (width + 7) // 8
        for s in range(getattr(lib, f"TIFFNumberOf{kind}s")(t)):
            got = []
            for fill in (0x55, 0xAA):
                buf = ctypes.create_string_buffer(bytes([fill]) * size, size)
                getattr(lib, f"TIFFReadEncoded{kind}")(t, s, buf, -1)
                got.append(np.unpackbits(np.frombuffer(
                    buf.raw, np.uint8).reshape(-1, row), 1)[:, :width])
            if not np.array_equal(*got):
                return True
        return False
    finally:
        lib.TIFFClose(t)


def _bilevel(seed: int, h: int, w: int) -> np.ndarray:
    rng = np.random.RandomState(seed)
    a = rng.rand(h, w) > 0.5
    a[h // 3:] = (np.add.outer(np.arange(h - h // 3), np.arange(w))
                  // rng.randint(2, 20)) % 2 == 0
    return a


PILLOW_FAX = [("group3", {}), ("group3", {292: 1}), ("group3", {292: 5}),
              ("group4", {}), ("group4", {266: 2}), ("tiff_ccitt", {}),
              ("tiff_raw_16", {266: 2}), ("group3", {278: 7})]


@pytest.mark.parametrize("k,mode", list(enumerate(PILLOW_FAX)))
def test_pillow_written_ccitt_equals_pillow(k, mode, tmp_path):
    """Pillow's writer (its libtiff) in Group 3 1D and 2D (T4Options 1,
    5), Group 4, modified Huffman and RLEW, FillOrder 2, strips; and
    byte-edited copies: damaged lines filled as libtiff fills them, T.4
    data read again without EOLs where its EOL is not found, as libtiff
    4.7 reads it."""
    compression, info = mode
    a = _bilevel(40 + k, 30 + 11 * k, 45 + 9 * k)
    buf = io.BytesIO()
    Image.fromarray(~a).save(buf, "TIFF", compression=compression,
                             tiffinfo=info)
    data = buf.getvalue()
    if compression != "tiff_raw_16":  # (libtiff reads its own RLEW
        # rows where its lookahead lands: tests/image_writers._rlew_row)
        assert np.array_equal(image_io.read_image(data)[..., 0] == 0, a)
    assert_edits_like_pillow(data, 50, seed=40 + k,
                             keep=lambda d: not undefined(d, tmp_path))


WRITER_FAX = [(2, {}), (32771, {}), (3, {}), (3, {"options": 4}),
              (3, {"options": 1}), (3, {"options": 5, "k": 3}),
              (3, {"options": 2}), (3, {"eol_at_start": False}), (4, {})]


@pytest.mark.parametrize("k,mode", list(enumerate(WRITER_FAX)))
def test_ccitt_layouts_equal_pillow(k, mode, tmp_path):
    """tests/image_writers.fax_encode in each CCITT mode (T4Options' fill
    bits, its uncompressed-mode bit, which libtiff does not read, a first
    row without its EOL), in strips and in tiles, II and MM, FillOrder 1
    and 2, photometric 0 and 1; and byte-edited copies."""
    compression, fax = mode
    rng = np.random.RandomState(60 + k)
    for tile, order, fill, photometric in (((16, 16), "<", 1, 0),
                                           (None, ">", 2, 1),
                                           ((32, 16), ">", 2, 0)):
        a = _bilevel(60 + k, rng.randint(20, 50), rng.randint(20, 70))
        kw = dict(tile=tile) if tile else dict(rows_per_strip=9)
        data = iw.encode_tiff(a, bits=1, photometric=photometric,
                              compression=compression, fax=fax,
                              byteorder=order, fill_order=fill, **kw)
        img = image_io.read_image(data)[..., 0]
        if fax.get("eol_at_start", True):
            assert np.array_equal(img == (0 if photometric == 0 else 255),
                                  a)
        assert_edits_like_pillow(data, 25, seed=60 + k,
                                 keep=lambda d: not undefined(d, tmp_path))


# ---------------------------------------------------- the committed scenes

def test_committed_scene_tiffs_equal_their_digests_and_the_jpeg():
    """tests/data/tiff_scenes: the first scene as ZSTD and LZMA TIFF
    (Pillow's writer, predictor 2) decode to their Pillow digests, which
    are the JPEG scene's decode."""
    import hashlib
    import json
    index = json.loads((ic.TIFF_SCENES / "index.json").read_text())
    assert len(index) == 2
    for name, entry in index.items():
        img = image_io.read_image(ic.TIFF_SCENES / name)
        assert list(img.shape) == entry["shape"] + [3]
        assert hashlib.sha256(img.tobytes()).hexdigest() == entry["sha256"]
        source = image_io.read_image(ic.CORPUS / entry["source"])
        assert np.array_equal(img, source), name
