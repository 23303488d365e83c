"""The port's native image decoder (csrc/image_decode.cpp through
data/native_image.py, what `image_io.read_image` runs) against Pillow
12.1.0 over libjpeg-turbo 3.1: the committed corpus (tests/data/image_io,
tests/image_corpus.py) decodes to Pillow's pixels here and to its
committed digests, which chip_smoke.py's phase 9a holds the card's host
to; seeded cases of every mode at odd sizes; the refused modes name
themselves; the native route equals the plain Python route wherever that
one reads; a failed build raises naming the compiler, with no fallback."""

import hashlib
import io
import json
import struct
import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

import chip_smoke
from maskrcnn_tpu_torch.data import image_io, native_image

TESTS = Path(__file__).resolve().parent
sys.path.insert(0, str(TESTS))

import image_corpus as ic  # noqa: E402
from jpeg_writer import encode_jpeg  # noqa: E402

INDEX = json.loads(ic.INDEX.read_text())
REPO = TESTS.parent


def pillow(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def digest(img: np.ndarray) -> str:
    return hashlib.sha256(img.tobytes()).hexdigest()


@pytest.mark.parametrize("name", sorted(INDEX["files"]))
def test_corpus_file_equals_pillow_and_its_digest(name):
    data = (ic.CORPUS / name).read_bytes()
    got = image_io.read_image(data)
    np.testing.assert_array_equal(got, pillow(data))
    entry = INDEX["files"][name]
    assert list(got.shape) == entry["shape"] + [3]
    assert digest(got) == entry["sha256"]


@pytest.mark.parametrize("name", sorted(INDEX["refused"]))
def test_refused_corpus_file_names_its_mode(name):
    with pytest.raises(NotImplementedError, match=INDEX["refused"][name]):
        image_io.read_image(ic.CORPUS / name)


@pytest.mark.parametrize("name", sorted(INDEX["errors"]))
def test_corpus_file_pillow_refuses_raises(name):
    """The corpus's byte edits that Pillow raises on (a lossless frame
    marker over a baseline scan, whose parameters libjpeg refuses) raise
    a ValueError here too."""
    data = (ic.CORPUS / name).read_bytes()
    with pytest.raises(Exception):
        pillow(data)
    with pytest.raises(ValueError):
        image_io.read_image(data)


def test_corpus_is_whole_and_small():
    """The index names every file of the corpus, the JPEG and PNG files
    hold at most 400 KB in all, the arithmetic, lossless and smoothed
    JPEG modes (jpeg_*) 200 KB, the WebP, GIF and BMP ones 600 KB, the
    TIFF ones 500 KB, those of Pillow's other plugins (the small
    lossless ones read, and the refused ones) 700 KB, the JPEG 2000
    layouts (jp2_*, refused_jp2_*) 400 KB, the HTJ2K ones (htj2k_*)
    300 KB and the AVIF ones (.avif) 300 KB, the scenes are
    COCO-sized and one is progressive, and the generator would write the
    same bytes again."""
    files = {p.name for p in ic.CORPUS.iterdir()} - {"index.json"}
    assert files == (set(INDEX["files"]) | set(INDEX["refused"])
                     | set(INDEX["errors"]))
    group = {".webp": "formats", ".gif": "formats", ".bmp": "formats",
             ".tif": "tiff"}
    plugins = (".ppm .pgm .pbm .pfm .tga .qoi .ico .cur .dib .pcx .dcx "
               ".sgi .ras .im .spi .msp .xbm .eps .jp2 .dds .blp "
               ".icns .xpm .psd .fits").split()
    group.update({ext: "plugins" for ext in plugins})
    group[".avif"] = "avif"
    sizes = [("jpeg_modes" if p.name.startswith("jpeg_")
              else "jpeg2000" if p.name.startswith(("jp2_", "refused_jp2_"))
              else "htj2k" if p.name.startswith("htj2k_")
              else group.get(p.suffix, "jpeg_png"), p.stat().st_size)
             for p in ic.CORPUS.iterdir() if p.name != "index.json"]
    limits = {"jpeg_png": 400_000, "jpeg_modes": 200_000,
              "formats": 600_000, "tiff": 500_000, "plugins": 700_000,
              "jpeg2000": 400_000, "htj2k": 300_000, "avif": 300_000}
    for name, limit in limits.items():
        assert sum(n for g, n in sizes if g == name) <= limit, name
    assert {INDEX["files"][s]["shape"][0] for s in INDEX["scenes"]} == {480}
    assert any("progressive" in s for s in INDEX["scenes"])
    for name, data in ic.jpeg_cases()[:6] + ic.png_cases()[:4]:
        assert (ic.CORPUS / name).read_bytes() == data, name


def test_jpeg_scenes_are_whole_and_small_and_their_pixels():
    """The scenes as arithmetic-coded and lossless JPEG
    (tests/data/jpeg_scenes, kept apart from the corpus's bounds) are the
    files their index names, hold at most 1.5 MB in all and decode to
    their Pillow digests, and those that re-code a scene's coefficients or
    its decode give that scene's pixels."""
    scenes = json.loads((ic.JPEG_SCENES / "index.json").read_text())
    files = {p.name for p in ic.JPEG_SCENES.iterdir()} - {"index.json"}
    assert files == set(scenes)
    assert sum((ic.JPEG_SCENES / n).stat().st_size for n in files) \
        <= 1_500_000
    for name, entry in scenes.items():
        img = image_io.read_image(ic.JPEG_SCENES / name)
        assert list(img.shape) == entry["shape"] + [3]
        assert digest(img) == entry["sha256"], name
        if entry["pixels"] == "same":
            assert digest(img) == INDEX["files"][entry["source"]]["sha256"]


def test_tiff_scenes_are_whole_and_small():
    """The ZSTD and LZMA TIFF scenes (tests/data/tiff_scenes, kept apart
    from the corpus's bounds) are the files their index names and hold at
    most 900 KB in all."""
    scenes = json.loads((ic.TIFF_SCENES / "index.json").read_text())
    files = {p.name for p in ic.TIFF_SCENES.iterdir()} - {"index.json"}
    assert files == set(scenes)
    assert sum((ic.TIFF_SCENES / n).stat().st_size for n in files) <= 900_000


def _cmyk_cases(rng, h, w):
    cmyk = ic.seeded_image(rng, h, w, 4)
    for inverted in (False, True):
        data = ic.pil_jpeg(255 - cmyk if inverted else cmyk, "CMYK",
                           quality=85)
        yield f"cmyk inverted={inverted}", data
        yield f"ycck inverted={inverted}", ic.with_transform(data, 2)
        yield f"cmyk no Adobe inverted={inverted}", ic.without_adobe(data)


SAMPLING = [[(1, 1)] * 3, [(2, 1), (1, 1), (1, 1)], [(2, 2), (1, 1), (1, 1)],
            [(1, 2), (1, 1), (1, 1)], [(4, 1), (1, 1), (1, 1)],
            [(3, 1), (1, 1), (1, 1)], [(2, 4), (1, 1), (1, 1)],
            [(4, 2), (2, 1), (2, 1)], [(1, 1), (2, 2), (2, 2)]]


def _seeded_cases(h, w):
    rng = np.random.RandomState(h * 100 + w)
    img = ic.seeded_image(rng, h, w)
    planes = [img[..., k] for k in range(3)]
    for sub in ("4:4:4", "4:2:0"):
        yield f"progressive {sub} restart", ic.pil_jpeg(
            img, quality=85, progressive=True, subsampling=sub,
            restart_marker_blocks=1)
    yield from _cmyk_cases(rng, h, w)
    rgb = ic.pil_jpeg(img, quality=90, keep_rgb=True)
    yield "Adobe RGB", rgb
    yield "R,G,B ids", ic.without_adobe(rgb)
    for factors in SAMPLING:
        blocks = sum(a * b for a, b in factors)
        yield f"sampling {factors}", encode_jpeg(
            planes, factors, interleaved=blocks <= 10, restart=2)
    for color, depths in ((0, (1, 2, 4, 16)), (2, (16,)), (3, (1, 2, 4)),
                          (4, (16,)), (6, (16,))):
        for depth in depths:
            yield f"png c{color} d{depth}", ic.seeded_png(
                h * w + depth, h, w, depth, color)
    yield "png Adam7", ic.seeded_png(h + w, h, w, 8, 2, interlace=1)
    yield "png Adam7 palette d2", ic.seeded_png(h + w, h, w, 2, 3,
                                                interlace=1)


@pytest.mark.parametrize("size", [(37, 53), (5, 3)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_seeded_modes_equal_pillow(size):
    """Progressive with restart intervals, CMYK and YCCK (inverted and
    not, with and without the Adobe marker), Adobe RGB and R,G,B ids,
    sampling factors 4:4:4 to 4x2 (4:2:2, 4:2:0, 4:4:0, 4:1:1, 3, and
    chroma sampled above luma), PNG bit depths 1, 2, 4 and 16 in each
    colour type that allows them, and Adam7."""
    seen = 0
    for what, data in _seeded_cases(*size):
        np.testing.assert_array_equal(image_io.read_image(data),
                                      pillow(data), err_msg=what)
        seen += 1
    assert seen == 31


def test_truncated_progressive_equals_pillow_or_is_refused():
    """A progressive file missing scans, cut at every scan: where its scans
    leave coefficients 1-9 incomplete libjpeg-turbo block-smooths the
    blocks (jdcoefct.c decompress_smooth_data), as the port does; a file
    whose only missing band is 10-63, or its DC scan, is not smoothed.
    Every cut equals Pillow's pixels (or raises where Pillow does: a cut
    that leaves a later scan without its Huffman table)."""
    rng = np.random.RandomState(21)
    img = ic.seeded_image(rng, 37, 53)
    full = ic.pil_jpeg(img, quality=85, progressive=True)
    planes = [img[..., k] for k in range(3)]
    bands = encode_jpeg(planes, [(2, 2), (1, 1), (1, 1)],
                        bands=[(1, 9), (10, 63)])
    equal = raised = 0
    for source in (full, bands):
        n = len(ic.scan_offsets(source))
        for k in range(1, n + 1):
            for cut in (ic.drop_scan(source, k - 1), ic.first_scans(source, k)):
                try:
                    want = pillow(cut)
                except Exception:  # noqa: BLE001 - Pillow's outcome
                    with pytest.raises(ValueError):
                        image_io.read_image(cut)
                    raised += 1
                    continue
                np.testing.assert_array_equal(image_io.read_image(cut), want)
                equal += 1
    assert equal >= 20 and equal + raised == 2 * (len(ic.scan_offsets(
        full)) + len(ic.scan_offsets(bands)))


def test_native_route_equals_plain_route():
    """Wherever the plain Python decoders read a file (the repository's
    images, the corpus's baseline JPEGs and 8-bit PNGs), the native route
    gives the same pixels."""
    names = [REPO / n for n in chip_smoke.IMAGE_DIGESTS] + [
        ic.CORPUS / n for n in sorted(INDEX["files"])]
    both = 0
    for path in names:
        data = path.read_bytes()
        try:
            plain = image_io.read_image(data, plain=True)
        except NotImplementedError:
            continue
        np.testing.assert_array_equal(image_io.read_image(data), plain,
                                      err_msg=path.name)
        both += 1
    assert both >= 25


def test_png_image_data_inflates_as_zlib_decompress():
    """The native route inflates a PNG's image data with the decoder's own
    inflate (TIFF's Deflate) as Pillow's decoder drives zlib, the plain
    route with zlib.decompress: on good, stored and dynamic streams, a
    bad Adler-32, truncated streams, bytes after the stream, more or less
    data than the image holds and flipped bytes, the native route gives
    Pillow's pixels or raises a ValueError where Pillow raises, and the
    plain one the same pixels or zlib's error or a ValueError. Pillow
    stops at the image's last row: a stream cut in its trailer, or
    damaged past the image's bytes, still decodes where zlib.decompress
    raises."""
    pytest.importorskip("PIL")
    from PIL import Image
    rng = np.random.RandomState(21)
    h, w = 37, 53
    good = ic.png_bytes(rng.randint(0, 256, (h, w * 3)), w, 8, 2, rng)
    pos, idat = 8, b""
    while pos < len(good):
        length, kind = struct.unpack(">I4s", good[pos:pos + 8])
        if kind == b"IDAT":
            idat += good[pos + 8:pos + 8 + length]
        pos += 12 + length
    raw = zlib.decompress(idat)
    streams = [zlib.compress(raw, level) for level in (0, 1, 9)]
    z = streams[-1]
    streams += [z[:-1] + bytes([z[-1] ^ 1]), z[:-4], z[:len(z) // 2], b"",
                z + b"junk", zlib.compress(raw + bytes(100)),
                zlib.compress(raw[:-10])]
    for k in range(2, len(z), max(1, len(z) // 40)):
        flipped = bytearray(z)
        flipped[k] ^= 0x5A
        streams.append(bytes(flipped))
    head = good[:8 + 25]                             # signature, IHDR
    for k, stream in enumerate(streams):
        png = (head + ic._chunk(b"IDAT", stream)
               + ic._chunk(b"IEND", b""))
        try:
            want = np.asarray(Image.open(io.BytesIO(png)).convert("RGB"))
        except OSError:
            with pytest.raises(ValueError):
                image_io.read_image(png)
            continue
        np.testing.assert_array_equal(image_io.read_image(png), want,
                                      err_msg=str(k))
        try:
            plain = image_io.read_image(png, plain=True)
        except (ValueError, zlib.error):
            continue
        np.testing.assert_array_equal(plain, want, err_msg=str(k))


def test_read_image_never_takes_the_plain_route(monkeypatch):
    def refuse(data):
        raise AssertionError("the plain route ran")
    monkeypatch.setattr(image_io, "decode_jpeg", refuse)
    monkeypatch.setattr(image_io, "decode_png", refuse)
    for name in ("images/sample.jpg", "images/synthetic_scene.png"):
        assert image_io.read_image(REPO / name).dtype == np.uint8


FAILED_BUILD = r"""
import os, sys
from pathlib import Path
os.environ["CXX"] = "/nonexistent/g++-for-a-test"
from maskrcnn_tpu_torch.data import image_io, native_image
from maskrcnn_tpu_torch.utils import native_build
native_build.BUILD_DIR = Path(sys.argv[1])
native_image.CXX_FLAGS = native_image.CXX_FLAGS + ("-DFAILED_BUILD_TEST",)
try:
    image_io.read_image("images/sample.jpg")
except RuntimeError as e:
    print("RAISED", e)
"""


def test_failed_build_raises_naming_the_compiler(tmp_path):
    """Without a compiler the reader raises a RuntimeError naming it; it
    never drops to the plain route, and the failed build leaves no
    temporary file in its build directory (a directory of this test's
    own: other test processes build in the shared one at the same
    time)."""
    build = tmp_path / "build"
    proc = subprocess.run([sys.executable, "-c", FAILED_BUILD, str(build)],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert "RAISED" in proc.stdout, proc.stdout + proc.stderr
    assert "/nonexistent/g++-for-a-test" in proc.stdout
    assert build.is_dir()
    assert not list(build.glob("*.so.tmp"))


def test_library_path_follows_every_source(tmp_path):
    """The image library is built from several sources (image_decode.cpp,
    the TIFF codecs' and their header): its path hashes every file the
    build reads, so an edit to any of them names another library."""
    from maskrcnn_tpu_torch.utils import native_build
    sources = [tmp_path / p.name for p in native_image.SOURCES]
    for src, dst in zip(native_image.SOURCES, sources):
        dst.write_bytes(src.read_bytes())
    assert {p.suffix for p in sources} == {".cpp", ".h"}
    assert len(sources) >= 5
    first = native_build.library_path("image_decode", sources,
                                      native_image.CXX_FLAGS)
    assert first.name == native_image.library_path().name
    seen = {first}
    for path in sources:
        path.write_bytes(path.read_bytes() + b"\n// an edit\n")
        seen.add(native_build.library_path("image_decode", sources,
                                           native_image.CXX_FLAGS))
    assert len(seen) == len(sources) + 1


def test_corrupt_files_raise_value_errors():
    data = (REPO / "images" / "sample.jpg").read_bytes()
    with pytest.raises(ValueError, match="truncated"):
        image_io.read_image(data[:len(data) // 2])
    # a PPM header before a JPEG: a 5x3 PPM (its first 45 bytes are the
    # pixels); bytes no plugin of Pillow's takes; an XPM header whose one
    # pixel is its colour; an EPS header, a format Pillow reads (through
    # Ghostscript) that the port does not
    ppm = image_io.read_image(b"P6\n5 3\n255\n" + data)
    assert np.array_equal(ppm, np.frombuffer(data[:45], np.uint8).reshape(
        3, 5, 3))
    with pytest.raises(ValueError, match="no plugin of Pillow's"):
        image_io.read_image(b"Q6\n5 3\n255\n" + data)
    assert np.array_equal(image_io.read_image(
        b'/* XPM */\n"1 1 1 1",\n"a c #ff0000",\n"a"'),
        np.array([[[255, 0, 0]]], np.uint8))
    with pytest.raises(NotImplementedError, match="EPS: .*Ghostscript"):
        image_io.read_image(b"%!PS-Adobe-3.0\n%%BoundingBox: 0 0 5 3\n")
    # a TIFF header before a JPEG: a TIFF whose directory is garbage
    with pytest.raises(ValueError, match="TIFF"):
        image_io.read_image(b"II*\x00" + data)
    # "BM" before a JPEG: a BMP whose header runs past the file, which
    # BmpImageFile._bitmap's read of it ends Image.open on
    with pytest.raises(ValueError, match="BMP: .*Truncated File Read"):
        image_io.read_image(b"BM" + data)
    png = (ic.CORPUS / "png_c2_d8_trns.png").read_bytes()
    broken = bytearray(png)
    broken[24] = 7                                   # bit depth 7
    # no mode of Pillow's PNG plugin (nor the header's checksum): Pillow
    # identifies no image, and the PNG decoder names the depth
    with pytest.raises(ValueError, match="no plugin of Pillow's"):
        image_io.read_image(bytes(broken))
    with pytest.raises(ValueError, match="bit depth 7"):
        native_image.decode_png(bytes(broken))
