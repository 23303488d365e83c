"""The port's AVIF reader (csrc/av1_decode.cpp, csrc/avif_decode.cpp,
data/native_image.decode_avif) against Pillow 12.1.0 over libavif 1.3
and dav1d: every AVIF file of the committed corpus (Pillow's encoder over
its qualities, speeds, subsamplings, ranges, tiles, alpha and the aom
tools its `advanced=` options switch; sizes 1x1 to the 640x480 scenes;
a libaom-encoded file with a full sequence header) decodes to Pillow's
digest; the YUV planes of the AV1 decoder equal those libavif's
avifDecoderRead gives (before colour conversion); the conversion equals
avifImageYUVToRGB on seeded planes under every CICP matrix, range and
subsampling (libyuv's routes and libavif's own); the refused files
(10- and 12-bit, superres, grid, film grain, IntraBC) raise
NotImplementedError naming their tool; cut and seeded byte-edited files
and `colr` edits give Pillow's outcome; `av1_tables.h` equals a fresh
read of OpenCV's libaom (tests/av1_libaom.py).

Known differences from Pillow on edited files, counted by
test_avif_edits_give_pillows_outcome: an AV1 frame smaller than its
item's ispe (libavif then reads past dav1d's picture: Pillow returns
those bytes, the port raises NotImplementedError naming it), and AV1
data edited so that dav1d's OBU parsing fails or reads the frame otherwise where the
specification's decoding process does not (a frame OBU's size cut short
inside the item, a sequence header's width raised)."""

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
from PIL import Image, features  # noqa: E402

TESTS = Path(__file__).resolve().parent
sys.path.insert(0, str(TESTS))

import av1_libaom  # noqa: E402
import avif_writer  # noqa: E402
import image_corpus as ic  # noqa: E402

INDEX = json.loads(ic.INDEX.read_text())
AVIF_FILES = sorted(n for n in INDEX["files"] if n.endswith(".avif"))
AVIF_REFUSED = sorted(n for n in INDEX["refused"] if n.endswith(".avif"))
AVIF_ERRORS = sorted(n for n in INDEX["errors"] if n.endswith(".avif"))
SCENES = json.loads((ic.AVIF_SCENES / "index.json").read_text())


def _pillow_avif():
    if not features.check("avif") or avif_writer.library() is None:
        pytest.skip("Pillow without AVIF")


def _digest(img) -> str:
    return hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()


def _pillow(data: bytes):
    """Pillow's convert("RGB") or its error."""
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    except Exception as e:  # noqa: BLE001 - any error is Pillow's outcome
        return e


def _port(data: bytes):
    try:
        return image_io.read_image(data)
    except Exception as e:  # noqa: BLE001 - the outcome is compared
        return e


@pytest.mark.parametrize("name", AVIF_FILES)
def test_avif_corpus_file_decodes_to_pillows_digest(name):
    """The committed file decodes to the digest of Pillow's decode, in
    Pillow's mode and size (image_probe's Image.open model)."""
    data = (ic.CORPUS / name).read_bytes()
    img = image_io.read_image(data)
    entry = INDEX["files"][name]
    assert list(img.shape) == entry["shape"] + [3]
    assert _digest(img) == entry["sha256"]
    layout = image_probe.avif_layout(data)
    assert layout["size"] == (img.shape[1], img.shape[0])


def test_avif_corpus_covers_the_encoder_and_its_tools():
    """The corpus holds Pillow's settings (qualities 0-100, speeds 0-10,
    every subsampling, limited range, 2x2 tiles, alpha both ways) and one
    file a tool of AVIF_TOOLS, and the files decoded hold 4:0:0, 4:2:2,
    4:4:4, RGBA and premultiplied alpha."""
    want = {"avif_q0.avif", "avif_q100.avif", "avif_speed0.avif",
            "avif_speed10.avif", "avif_400.avif", "avif_422.avif",
            "avif_444.avif", "avif_limited.avif", "avif_tiles_2x2.avif",
            "avif_rgba.avif", "avif_rgba_premultiplied.avif",
            "avif_1x1.avif", "avif_5x3.avif", "avif_37x53.avif",
            "avif_sequence.avif"}
    assert want <= set(AVIF_FILES)
    assert {f"avif_tool_{n}.avif" for n, _ in ic.AVIF_TOOLS} <= set(
        AVIF_FILES)
    prem = image_probe.avif_layout(
        (ic.CORPUS / "avif_rgba_premultiplied.avif").read_bytes())
    assert prem["mode"] == "RGBA" and prem["premultiplied"]
    tiles = (ic.CORPUS / "avif_tiles_2x2.avif").read_bytes()
    _, config = native_image.av1_planes(image_probe.avif_layout(tiles)[
        "color"])
    assert config["width"] == 176


@pytest.mark.parametrize("name", AVIF_FILES)
def test_av1_planes_equal_libavifs(name):
    """The AV1 decoder's Y, U and V planes of the file's colour item equal
    avifDecoderRead's (dav1d's), 4:0:0 with no chroma."""
    _pillow_avif()
    data = (ic.CORPUS / name).read_bytes()
    want = avif_writer.decode_yuv(data)
    got, config = native_image.av1_planes(
        image_probe.avif_layout(data)["color"])
    for plane, (g, w) in enumerate(zip(got, want[:3])):
        if w is None:
            assert g is None, (name, plane)
            continue
        assert g is not None and g.shape == w.shape, (name, plane)
        assert np.array_equal(g, w), (name, plane, int((g != w).sum()))


@pytest.mark.parametrize("name", sorted(SCENES))
def test_avif_scene_decodes_to_pillows_digest(name):
    """The scenes as AVIF (tests/data/avif_scenes: Pillow's defaults, and
    the first scene at speed 0) decode to their digests and their planes
    equal libavif's."""
    data = (ic.AVIF_SCENES / name).read_bytes()
    img = image_io.read_image(data)
    assert list(img.shape) == SCENES[name]["shape"] + [3]
    assert _digest(img) == SCENES[name]["sha256"]
    if avif_writer.library() is not None:
        want = avif_writer.decode_yuv(data)
        got, _ = native_image.av1_planes(image_probe.avif_layout(data)[
            "color"])
        assert all(np.array_equal(g, w) for g, w in zip(got, want[:3]))


def test_avif_scenes_are_whole_and_small():
    """The AVIF scenes' index names every file there, 640x480 each, and
    they hold at most 400 KB."""
    files = {p.name for p in ic.AVIF_SCENES.iterdir()} - {"index.json"}
    assert files == set(SCENES)
    assert all(e["shape"] == [480, 640] for e in SCENES.values())
    assert sum((ic.AVIF_SCENES / n).stat().st_size for n in files) <= 400_000


@pytest.mark.parametrize("name", AVIF_REFUSED)
def test_avif_refusal_names_its_tool(name):
    """A file Pillow decodes whose AV1 tool or item the port does not
    read raises NotImplementedError naming it (10-bit, 12-bit, superres,
    grid, film grain, IntraBC)."""
    with pytest.raises(NotImplementedError, match=INDEX["refused"][name]):
        image_io.read_image((ic.CORPUS / name).read_bytes())


@pytest.mark.parametrize("name", AVIF_ERRORS)
def test_avif_file_pillow_fails_on_raises_value_error(name):
    with pytest.raises(ValueError):
        image_io.read_image((ic.CORPUS / name).read_bytes())


def test_refusal_files_are_what_pillow_decodes():
    """Every refused AVIF decodes in Pillow (the refusal is the port's)."""
    _pillow_avif()
    for name in AVIF_REFUSED:
        got = _pillow((ic.CORPUS / name).read_bytes())
        assert isinstance(got, np.ndarray), (name, got)


def test_av1_tables_equal_a_fresh_read():
    """csrc/av1_tables.h is what `python tests/image_corpus.py
    --av1-tables` writes from OpenCV's libaom 3.14.1."""
    if av1_libaom.libaom_path() is None:
        pytest.skip("OpenCV's libaom 3.14.1 is absent")
    assert ic.AV1_TABLES.read_text() == av1_libaom.header(
        av1_libaom.read_tables())


def test_libaom_decoder_agrees_on_the_corpus():
    """OpenCV's libaom decoder, a third decoder, gives the port's planes
    on the corpus's 4:2:0 files of several qualities and tools."""
    if av1_libaom.libaom_path() is None:
        pytest.skip("OpenCV's libaom 3.14.1 is absent")
    for name in ("avif_q0.avif", "avif_q100.avif", "avif_tool_qm.avif",
                 "avif_tool_palette.avif", "avif_tool_restoration.avif",
                 "avif_tiles_2x2.avif"):
        color = image_probe.avif_layout((ic.CORPUS / name).read_bytes())[
            "color"]
        want = av1_libaom.decode_av1(color)
        got, _ = native_image.av1_planes(color)
        assert all(np.array_equal(g, w) for g, w in zip(got, want)), name


_MATRICES = [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 12, 14, 15, 16]


@pytest.mark.parametrize("matrix", _MATRICES)
def test_yuv_to_rgb_equals_libavif(matrix):
    """native avifImageYUVToRGB (mrt_avif_yuv_to_rgb) against libavif's on
    seeded 8-bit planes: 4:4:4, 4:2:2, 4:2:0 and 4:0:0, odd sizes, full
    and limited range, the matrix under primaries 1 (BT.709), 2, 5, 9
    and 4 (chromaticity-derived NCL's libyuv and float routes): the same
    pixels, or an error both ways."""
    _pillow_avif()
    lib = native_image.avif_library()
    rng = np.random.RandomState(matrix)
    for sub, (sx, sy) in (("444", (0, 0)), ("422", (1, 0)),
                          ("420", (1, 1)), ("400", (1, 1))):
        h, w = 23, 37
        y = rng.randint(0, 256, (h, w)).astype(np.uint8)
        cw, ch = (w + sx) >> sx, (h + sy) >> sy
        u = rng.randint(0, 256, (ch, cw)).astype(np.uint8)
        v = rng.randint(0, 256, (ch, cw)).astype(np.uint8)
        planes = [y] if sub == "400" else [y, u, v]
        for full in (False, True):
            for primaries in ((1, 2, 5, 9, 4) if matrix == 12 else (1,)):
                try:
                    want = avif_writer.yuv_to_rgb(planes, sub, matrix, full,
                                                  primaries)
                except ValueError:
                    want = None
                out = np.empty((h, w, 3), np.uint8)
                msg = native_image.ctypes.create_string_buffer(256)
                code = lib.mrt_avif_yuv_to_rgb(
                    y.ctypes.data, u.ctypes.data, v.ctypes.data, w, h, sx,
                    sy, int(sub == "400"), matrix, primaries, int(full), out,
                    3, msg, 256)
                key = (sub, full, primaries)
                if want is None:
                    assert code == 1, key
                else:
                    assert code == 0, (key, msg.value)
                    assert np.array_equal(out, want), (
                        key, int((out != want).any(-1).sum()))


@pytest.mark.parametrize("sub", ["4:2:0", "4:4:4", "4:0:0"])
def test_colr_edits_give_pillows_pixels(sub):
    """The colour item's nclx colr edited to every matrix 0-18 (and
    255), each range, primaries 1 and 4: the port gives Pillow's pixels,
    or raises ValueError where Pillow's conversion fails."""
    _pillow_avif()
    rng = np.random.RandomState(41)
    base = ic._pil(ic.seeded_image(rng, 21, 30), "AVIF", subsampling=sub)
    at = base.index(b"colrnclx") + 8
    checked = 0
    for matrix in list(range(19)) + [255]:
        for full in (0, 1):
            for primaries in (1, 4):
                e = bytearray(base)
                e[at:at + 2] = primaries.to_bytes(2, "big")
                e[at + 4:at + 6] = matrix.to_bytes(2, "big")
                e[at + 6] = 0x80 if full else 0
                data = bytes(e)
                want, got = _pillow(data), _port(data)
                if isinstance(want, np.ndarray):
                    assert isinstance(got, np.ndarray), (matrix, full, got)
                    assert np.array_equal(got, want), (matrix, full,
                                                       primaries)
                    checked += 1
                else:
                    assert isinstance(got, ValueError), (matrix, full, got)
    assert checked >= 20


def test_alpha_straight_and_premultiplied_give_pillows_pixels():
    """Seeded RGBA images through Pillow's writer, straight and
    premultiplied alpha, 4:2:0 and 4:4:4: Pillow's RGB after its
    unpremultiply (libyuv's ARGBUnattenuate), and RGBA read with `rgba`
    equals Pillow's RGBA."""
    _pillow_avif()
    rng = np.random.RandomState(42)
    for prem in (False, True):
        for sub in ("4:2:0", "4:4:4"):
            img = ic.seeded_image(rng, 19, 27, 4)
            img[..., 3] = rng.randint(0, 256, img.shape[:2])
            data = ic._pil(img, "AVIF", "RGBA", subsampling=sub,
                           alpha_premultiplied=prem)
            im = Image.open(io.BytesIO(data))
            assert np.array_equal(image_io.read_image(data),
                                  np.asarray(im.convert("RGB")))
            assert np.array_equal(native_image.decode_avif(data, rgba=True),
                                  np.asarray(im.convert("RGBA")))


# of the 300 seeded edits of a file, those that make an AV1 frame
# smaller than its ispe (test_avif_edits_give_pillows_outcome): the most
# any of its files gives at seed 7
ISPE_EDITS = 2


def _edits(data: bytes, rng, count: int):
    """Seeded edits: one to three bytes of the AV1 data, cuts, a byte
    anywhere; (kind, bytes)."""
    mdat = data.find(b"mdat") + 4
    for t in range(count):
        e = bytearray(data)
        kind = t % 3
        if kind == 0:
            for _ in range(rng.randint(1, 4)):
                k = rng.randint(mdat, len(e))
                e[k] = rng.randint(256)
        elif kind == 1:
            e = e[:rng.randint(mdat - 8, len(e))]
        else:
            k = rng.randint(0, len(e))
            e[k] = rng.randint(256)
        yield kind, bytes(e)


@pytest.mark.parametrize("name", ["avif_q50.avif", "avif_444.avif",
                                  "avif_rgba.avif", "avif_tool_palette.avif",
                                  "avif_tiles_2x2.avif"])
def test_avif_edits_give_pillows_outcome(name):
    """Seeded byte edits and cuts of corpus files: where Pillow decodes,
    the port gives the same pixels (or refuses a mode by name); where
    Pillow fails, the port raises ValueError. The known differences (the
    module's docstring): an AV1 frame smaller than its ispe, where the
    port's NotImplementedError names it (at most ISPE_EDITS of the 300
    edits a file), and AV1 data dav1d reads otherwise, at most 2 of the
    300 edits a file."""
    _pillow_avif()
    data = (ic.CORPUS / name).read_bytes()
    rng = np.random.RandomState(7)
    known = ispe = 0
    for kind, e in _edits(data, rng, 300):
        want, got = _pillow(e), _port(e)
        if isinstance(want, np.ndarray):
            if isinstance(got, NotImplementedError):
                ispe += "smaller than the image's ispe" in str(got)
                continue
            if isinstance(got, np.ndarray) and got.shape == want.shape \
                    and np.array_equal(got, want):
                continue
            known += 1
        elif not isinstance(got, ValueError):
            known += 1
    assert known <= 2, (name, known)
    assert ispe <= ISPE_EDITS, (name, ispe)


def test_sequence_and_libaom_files_read_their_first_frame():
    """Pillow's image sequence (avis: items and tracks) reads its primary
    item, the first frame; a libaom-encoded file (a full sequence header,
    not still) decodes to Pillow's pixels."""
    _pillow_avif()
    for name in ("avif_sequence.avif", "avif_libaom_good_quality.avif"):
        path = ic.CORPUS / name
        if not path.exists():
            continue
        data = path.read_bytes()
        assert np.array_equal(image_io.read_image(data),
                              _pillow(data)), name
