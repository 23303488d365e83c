"""The port's WebP, GIF and BMP readers (csrc/webp_decode.cpp and
csrc/image_decode.cpp through data/native_image.py, what
`image_io.read_image` runs) against Pillow 12.1.0 over libwebp 1.6.0:
every mode of the committed corpus at every size decodes to its digest
(the digests chip_smoke.py's phase 9a holds the card's host to); seeded
files made here equal Pillow's live decode (WebP qualities, methods,
lossless and exact, alpha, animation and the encoder options Pillow does
not reach; GIF and BMP of every mode); the JAX package's CocoDataset
reads a COCO directory of the scenes in these formats as the port's
does; byte-edited copies of the alpha files give Pillow's outcome (a
lossy frame's ALPH chunk decoded as libwebp decodes it); decoder threads
give one thread's arrays; the formats the reader does not take are
named."""

import hashlib
import io
import json
import re
import subprocess
import sys
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
SIZE = re.compile(r"_(\d+)x(\d+)\.(webp|gif|bmp)$")
# every WebP, GIF and BMP mode of the corpus: {mode: [files]}
MODES = {}
for _name in INDEX["files"]:
    if SIZE.search(_name):
        MODES.setdefault(SIZE.sub(r".\3", _name), []).append(_name)


def digest(img: np.ndarray) -> str:
    return hashlib.sha256(img.tobytes()).hexdigest()


def pillow(data: bytes) -> np.ndarray:
    from PIL import Image
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def assert_like_pillow(data: bytes, what: str = "") -> None:
    got = image_io.read_image(data)
    want = pillow(data)
    assert got.shape == want.shape, what
    assert np.array_equal(got, want), (
        f"{what}: {int((got != want).any(-1).sum())} pixels differ")


@pytest.mark.parametrize("mode", sorted(MODES))
def test_corpus_mode_at_every_size_equals_its_digest(mode):
    """Each mode's files (1x1, 5x3, 37x53 and 16x24; the deferred-clear GIF
    at the size that fills its code table) decode natively to their
    Pillow digests, without Pillow."""
    names = MODES[mode]
    sizes = {tuple(map(int, SIZE.search(n).groups()[:2])) for n in names}
    assert sizes == set(ic.SIZES) or mode == "gif_deferred_clear.gif", sizes
    for name in names:
        img = image_io.read_image(ic.CORPUS / name)
        entry = INDEX["files"][name]
        assert list(img.shape) == entry["shape"] + [3], name
        assert digest(img) == entry["sha256"], name


def test_corpus_covers_every_format_and_scene():
    """The corpus holds WebP, GIF and BMP modes, BMP files Pillow fails on
    (each a ValueError here, test_torch_image_native), and the scenes as
    lossy WebP (three) and lossless WebP (one, holding its JPEG scene's
    decode)."""
    exts = {m.rsplit(".", 1)[1] for m in MODES}
    assert exts == {"webp", "gif", "bmp"}
    assert sum(n.endswith(".bmp") for n in INDEX["errors"]) >= 5
    scenes = INDEX["format_scenes"]
    assert sorted(scenes.values()).count("scene_baseline_420.jpg") == 2
    assert set(scenes.values()) == set(INDEX["scenes"])
    for name, source in scenes.items():
        assert INDEX["files"][name]["shape"] == INDEX["files"][source][
            "shape"]
    lossless = [n for n in scenes if "lossless" in n]
    assert len(lossless) == 1
    assert (INDEX["files"][lossless[0]]["sha256"]
            == INDEX["files"][scenes[lossless[0]]]["sha256"])


# ------------------------------------------------------ live Pillow: WebP

def _seeded(seed, h, w, channels=3):
    return ic.seeded_image(np.random.RandomState(seed), h, w, channels)


@pytest.mark.parametrize("quality", [0, 50, 100])
@pytest.mark.parametrize("method", [0, 4, 6])
def test_webp_lossy_equals_pillow(quality, method):
    pytest.importorskip("PIL")
    for h, w in ic.SIZES + ((31, 70),):
        img = _seeded(quality + method, h, w)
        assert_like_pillow(ic.pil_bytes(img, "WEBP", quality=quality,
                                        method=method), f"{h}x{w}")


@pytest.mark.parametrize("kw", [dict(), dict(method=0, quality=0),
                                dict(method=6, quality=100),
                                dict(exact=True), dict(method=3)])
def test_webp_lossless_equals_pillow(kw):
    pytest.importorskip("PIL")
    rng = np.random.RandomState(len(kw))
    for h, w in ic.SIZES + ((45, 29),):
        rgba = ic.seeded_image(rng, h, w, 4)
        assert_like_pillow(ic.pil_bytes(rgba, "WEBP", lossless=True, **kw),
                           f"RGBA {h}x{w}")
        # 2, 3, 11 and 200 colours: colour indexing, pixels bundled 8, 4
        # and 2 to a byte, and none
        for n in (2, 3, 11, 200):
            palette = rng.randint(0, 256, (n, 3)).astype(np.uint8)
            img = palette[rng.randint(0, n, (h, w))]
            assert_like_pillow(ic.pil_bytes(img, "WEBP", lossless=True,
                                            **kw), f"{n} colours {h}x{w}")


def test_webp_alpha_and_animation_equal_pillow():
    """Partial alpha (lossy with ALPH, lossless), a two-frame animation
    (lossy and lossless; frame 0), and first frames at offsets on a
    larger canvas (the rest transparent black)."""
    pytest.importorskip("PIL")
    for h, w in ic.SIZES:
        rgba = _seeded(21, h, w, 4)
        rgba[..., 3] = np.where(rgba[..., 3] > 100, 255, rgba[..., 3])
        img = _seeded(22, h, w)
        assert_like_pillow(ic.pil_bytes(rgba, "WEBP", quality=85), "alpha")
        assert_like_pillow(ic.pil_bytes(rgba, "WEBP", lossless=True),
                           "lossless alpha")
        for kw in (dict(quality=60), dict(lossless=True)):
            assert_like_pillow(ic.pil_animation([img, 255 - img], **kw),
                               f"animation {kw}")
            frame = ic.frame_chunks(ic.pil_bytes(rgba, "WEBP", **kw))
            assert_like_pillow(iw.webp_container(
                (w + 9, h + 5), [(4, 2, w, h, frame)]), f"offset {kw}")


def _riff(chunks) -> bytes:
    body = b"WEBP" + b"".join(iw._riff_chunk(c, b) for c, b in chunks)
    return b"RIFF" + len(body).to_bytes(4, "little") + body


def _like_pillow_or_both_raise(data: bytes, what: str) -> str:
    """The native decode equals Pillow's, or both raise (the native one a
    ValueError); returns which."""
    try:
        want = pillow(data)
    except Exception:  # noqa: BLE001 - any error is Pillow's outcome
        with pytest.raises(ValueError):
            image_io.read_image(data)
        return "error"
    got = image_io.read_image(data)
    assert got.shape == want.shape and np.array_equal(got, want), what
    return "pixels"


ALPHA_FILES = sorted(n for n in INDEX["files"]
                     if n.startswith(("webp_lossy_alpha_",
                                      "webp_lossless_exact_alpha_")))


@pytest.mark.parametrize("name", ALPHA_FILES)
def test_webp_alpha_edits_give_pillows_outcome(name):
    """Byte-edited copies of the corpus's alpha files against live Pillow
    (libwebp decodes a lossy frame's ALPH chunk even though Pillow's RGB
    drops it, and fails where it does not decode): every value of the
    ALPH header byte (compression method, filter, pre-processing,
    reserved bits), the chunk truncated, a byte flipped anywhere in its
    VP8L stream, raw alpha of each filter at, below and past the frame's
    size, the ALPH chunk before a VP8L bitstream; for the lossless file,
    bytes flipped in its VP8L bitstream. Each gives Pillow's outcome,
    pixels or an error; the unedited file keeps its digest."""
    pytest.importorskip("PIL")
    data = (ic.CORPUS / name).read_bytes()
    assert digest(image_io.read_image(data)) == INDEX["files"][name]["sha256"]
    chunks = iw.webp_chunks(data)
    fourccs = [c for c, _ in chunks]
    seen = set()
    if b"ALPH" not in fourccs:
        k = fourccs.index(b"VP8L")
        body = chunks[k][1]
        for pos in range(5, len(body), 2):
            edited = bytearray(body)
            edited[pos] ^= 0xFF
            seen.add(_like_pillow_or_both_raise(_riff(
                chunks[:k] + [(b"VP8L", bytes(edited))] + chunks[k + 1:]),
                f"VP8L byte {pos}"))
        assert seen == {"pixels", "error"}
        return
    k = fourccs.index(b"ALPH")
    alph = chunks[k][1]

    def with_alpha(body):
        return _riff(chunks[:k] + [(b"ALPH", body)] + chunks[k + 1:])

    for header in range(256):
        seen.add(_like_pillow_or_both_raise(
            with_alpha(bytes([header]) + alph[1:]), f"header {header:#x}"))
    for cut in sorted({0, 1, 2, 3, len(alph) // 2, len(alph) - 1}):
        seen.add(_like_pillow_or_both_raise(with_alpha(alph[:cut]),
                                            f"cut at {cut}"))
    for pos in range(1, len(alph)):
        for x in (0x01, 0xFF):
            edited = bytearray(alph)
            edited[pos] ^= x
            seen.add(_like_pillow_or_both_raise(with_alpha(bytes(edited)),
                                                f"byte {pos} ^ {x}"))
    h, w = INDEX["files"][name]["shape"]
    values = np.random.RandomState(h * w).randint(0, 256, h * w)
    for filt in range(4):
        for extra in (-1, 0, 3):
            raw = values.astype(np.uint8).tobytes() + bytes(max(extra, 0))
            seen.add(_like_pillow_or_both_raise(with_alpha(
                bytes([filt << 2]) + raw[:h * w + min(extra, 0)]),
                f"raw filter {filt} {extra}"))
    lossless = (ic.CORPUS / name.replace("lossy_alpha",
                                         "lossless")).read_bytes()
    vp8l = [c for c in iw.webp_chunks(lossless) if c[0] == b"VP8L"]
    head = [c for c in chunks if c[0] == b"VP8X"]
    seen.add(_like_pillow_or_both_raise(_riff(head + [(b"ALPH", alph)]
                                              + vp8l), "ALPH before VP8L"))
    assert seen == {"pixels", "error"}


@pytest.mark.parametrize("kw", [
    dict(filter_type=0, filter_strength=50), dict(partitions=1, method=0),
    dict(partitions=2, method=1), dict(partitions=3, method=2),
    dict(segments=1), dict(segments=4, sns_strength=100),
    dict(filter_sharpness=7, filter_strength=90), dict(filter_strength=0),
    dict(method=2, quality=20)])
def test_webp_encoder_options_equal_pillow(kw):
    """What libwebp's encoder reaches and Pillow's writer does not: the
    simple loop filter, 2, 4 and 8 token partitions, one or four
    segments, sharpness, no filter, skipped macroblocks."""
    pytest.importorskip("PIL")
    if not iw.webp_available():
        pytest.skip("no libwebp encoder to write with")
    for h, w in ic.SIZES + ((70, 41),):
        img = _seeded(sum(kw.values()), h, w)
        img[: h // 2] = 128
        assert_like_pillow(iw.encode_webp(img, **{"quality": 60, **kw}),
                           f"{kw} {h}x{w}")


def test_webp_loop_filter_deltas_equal_pillow():
    """Loop-filter deltas (the intra reference's and the 4x4 mode's move
    every macroblock's filter level), written by re-encoding the first
    partition of Pillow's files; with zero deltas the rewrite decodes as
    its source does."""
    pytest.importorskip("PIL")
    for h, w in ic.SIZES + ((48, 80),):
        src = ic.pil_bytes(_seeded(31, h, w), "WEBP", quality=40)
        assert np.array_equal(pillow(iw.vp8_with_lf_deltas(
            src, (0,) * 4, (0,) * 4)), pillow(src))
        for ref, mode in (((5, -2, 0, 3), (-4, 0, 6, 0)),
                          ((-63, 0, 0, 0), (63, 0, 0, 0))):
            assert_like_pillow(iw.vp8_with_lf_deltas(src, ref, mode),
                               f"{ref} {mode} {h}x{w}")


def test_webp_scale_bits_are_ignored():
    pytest.importorskip("PIL")
    src = ic.pil_bytes(_seeded(41, 37, 53), "WEBP", quality=70)
    data = ic.with_scale_bits(src)
    assert data != src
    assert np.array_equal(image_io.read_image(data), pillow(src))
    assert_like_pillow(data)


# ------------------------------------------------- live Pillow: GIF, BMP

@pytest.mark.parametrize("interlace", [False, True])
def test_gif_equals_pillow(interlace):
    """Code sizes 2 to 8, global and local tables, clear codes, the
    deferred clear, offset and oversized frames, Pillow's own GIFs."""
    pytest.importorskip("PIL")
    rng = np.random.RandomState(int(interlace))
    for h, w in ic.SIZES + ((29, 64),):
        for bits in range(2, 9):
            idx = rng.randint(0, 1 << bits, (h, w)).astype(np.uint8)
            pal = rng.randint(0, 256, (1 << bits, 3)).astype(np.uint8)
            kw = dict(interlace=interlace, min_code_size=bits)
            assert_like_pillow(iw.encode_gif(idx, global_palette=pal, **kw))
            assert_like_pillow(iw.encode_gif(
                idx, global_palette=pal[::-1], local_palette=pal,
                clear_every=3, deferred=False, **kw))
            assert_like_pillow(iw.encode_gif(
                idx, (w + 4, h + 6), global_palette=pal, offset=(2, 5),
                transparency=int(rng.randint(0, 1 << bits)), **kw))
            assert_like_pillow(iw.encode_gif(
                idx, (max(1, w - 2), max(1, h - 1)), global_palette=pal,
                offset=(1, 1), **kw))
        assert_like_pillow(ic.pil_bytes(_seeded(h, h, w), "GIF",
                                        interlace=interlace))
    big = rng.randint(0, 256, (70, 90)).astype(np.uint8)
    pal = rng.randint(0, 256, (256, 3)).astype(np.uint8)
    assert_like_pillow(iw.encode_gif(big, global_palette=pal,
                                     interlace=interlace), "deferred clear")


def _bmp_cases(rng, h, w):
    img = ic.seeded_image(rng, h, w)
    pal = rng.randint(0, 256, (256, 3)).astype(np.uint8)
    for bits in (1, 4, 8):
        idx = rng.randint(0, 1 << bits, (h, w))
        for header in (12, 40, 52, 56, 64, 108, 124):
            for top_down in ((False, True) if header != 12 else (False,)):
                rows = iw.bmp_pixels(idx, bits)
                yield f"{bits}-bit {header} {top_down}", iw.encode_bmp(
                    w, h, bits, (rows if top_down else rows[::-1]).tobytes(),
                    header=header, palette=pal[:1 << bits],
                    top_down=top_down)
        n = max(1, (1 << bits) // 3)
        yield f"{bits}-bit short palette", iw.encode_bmp(
            w, h, bits, iw.bmp_pixels(idx, bits)[::-1].tobytes(),
            palette=pal[:n], colors=n)
    for bits, masks, header in (
            (16, None, 40), (16, (0xF800, 0x7E0, 0x1F), 40),
            (16, (0x7C00, 0x3E0, 0x1F), 124), (24, None, 12),
            (24, (0xFF0000, 0xFF00, 0xFF), 40), (32, None, 40),
            (32, (0xFF0000, 0xFF00, 0xFF, 0), 56),
            (32, (0xFF000000, 0xFF0000, 0xFF00, 0), 108),
            (32, (0xFF000000, 0xFF00, 0xFF, 0), 124),
            (32, (0xFF000000, 0xFF0000, 0xFF00, 0xFF), 108),
            (32, (0xFF, 0xFF00, 0xFF0000, 0xFF000000), 124),
            (32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000), 56),
            (32, (0xFF000000, 0xFF00, 0xFF, 0xFF0000), 108),
            (32, (0, 0, 0, 0), 56)):
        rows = iw.bmp_pixels(img, bits, masks)[::-1].tobytes()
        yield f"{bits}-bit {masks}", iw.encode_bmp(
            w, h, bits, rows, header=header,
            compression=3 if masks else 0, masks=masks)
    gray = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, 1)
    idx = rng.randint(0, 256, (h, w))
    yield "grayscale", iw.encode_bmp(
        w, h, 8, iw.bmp_pixels(idx, 8)[::-1].tobytes(), palette=gray[:200],
        colors=200)
    for rle4 in (False, True):
        bits = 4 if rle4 else 8
        idx = rng.randint(0, 4, (h, w))
        idx[h // 3:, : w // 2] = 0
        p = pal[:16] if rle4 else pal
        for top_down in (False, True):
            ops = iw.rle_ops(idx[::-1] if top_down else idx, rle4, rng)
            yield f"RLE{bits} {top_down}", iw.encode_bmp(
                w, h, bits, iw.rle_bytes(ops, rle4, 14 + 40 + 4 * len(p)),
                compression=2 if rle4 else 1, palette=p, top_down=top_down)
        yield f"RLE{bits} gray", iw.encode_bmp(
            w, h, bits, iw.rle_bytes(iw.rle_ops(idx, rle4, rng), rle4,
                                     14 + 40 + 4 * 256),
            compression=2 if rle4 else 1, palette=gray)


def test_bmp_equals_pillow():
    """Every header size, palette depth (short and grayscale palettes),
    16-bit 5-5-5 and 5-6-5, 24-bit, the 32-bit layouts, RLE8 and RLE4
    (bottom-up and top-down), and Pillow's own BMP files."""
    pytest.importorskip("PIL")
    rng = np.random.RandomState(5)
    for h, w in ic.SIZES + ((23, 70),):
        for what, data in _bmp_cases(rng, h, w):
            assert_like_pillow(data, f"{what} {h}x{w}")
        img = ic.seeded_image(rng, h, w)
        assert_like_pillow(ic.pil_bytes(img, "BMP"), "Pillow 24-bit")
        for mode in ("P", "L", "1"):
            from PIL import Image
            buf = io.BytesIO()
            Image.fromarray(img).convert(mode).save(buf, "BMP")
            assert_like_pillow(buf.getvalue(), f"Pillow {mode}")


def test_rle_ends_and_deltas_equal_pillow():
    """Pillow's RLE reader: a line end pads the row with index 0, a delta
    skips pixels (index 0) after two bytes it drops, runs past the row
    are cut, an absolute run crosses rows, and a bitmap that ends before
    the image is full is an error."""
    pytest.importorskip("PIL")
    pal = np.random.RandomState(6).randint(0, 256, (256, 3)).astype(np.uint8)
    start = 14 + 40 + 4 * 256
    ops = [("run", 3, 7), ("eol",), ("run", 20, 9), ("delta", 3, 1),
           ("absolute", [1, 2, 3, 4, 5, 6, 7]), ("run", 2, 4), ("eol",),
           ("run", 9, 5), ("eob",)]
    data = iw.encode_bmp(9, 5, 8, iw.rle_bytes(ops, False, start),
                         compression=1, palette=pal)
    assert_like_pillow(data)
    short = iw.encode_bmp(9, 5, 8, iw.rle_bytes(ops[:3] + [("eob",)], False,
                                                start),
                          compression=1, palette=pal)
    with pytest.raises(ValueError, match="not enough image data"):
        pillow(short)
    with pytest.raises(ValueError, match="not enough image data"):
        image_io.read_image(short)


# ------------------------------------------------------------ refusals

def test_other_formats_and_plain_route_are_named():
    """A PPM file and an XPM file are read as Pillow reads them; bytes no
    plugin of Pillow's takes raise ValueError, and a format Pillow reads
    that the port does not (EPS, through Ghostscript) a
    NotImplementedError naming it (a TIFF header alone is a corrupt
    TIFF); the plain route reads PNG and JPEG only and names the format
    it does not read; a corrupt file of each new format raises
    ValueError."""
    ppm = b"P6\n5 3\n255\n" + bytes(range(64))
    assert np.array_equal(image_io.read_image(ppm), pillow(ppm))
    with pytest.raises(ValueError, match="no plugin of Pillow's"):
        image_io.read_image(b"Q6\n5 3\n255\n" + bytes(64))
    xpm = b'/* XPM */\n"1 1 1 1",\n"a c #ff0000",\n"a"'
    assert np.array_equal(image_io.read_image(xpm), pillow(xpm))
    with pytest.raises(NotImplementedError, match="EPS: .*Ghostscript"):
        image_io.read_image(b"%!PS-Adobe-3.0\n%%BoundingBox: 0 0 5 3\n")
    with pytest.raises(ValueError, match="TIFF"):
        image_io.read_image(b"II*\x00" + bytes(64))
    for name in ("webp_lossless_5x3.webp", "gif_global_table_5x3.gif",
                 "bmp_24bit_5x3.bmp"):
        data = (ic.CORPUS / name).read_bytes()
        fmt = image_io.format_of(data)
        assert fmt and name.endswith("." + fmt.lower())
        with pytest.raises(NotImplementedError, match=f"{fmt}: the plain"):
            image_io.read_image(data, plain=True)
        with pytest.raises(ValueError):
            image_io.read_image(data[:len(data) // 3])
    # RIFF/WEBP with a chunk Pillow does not accept: not a WebP file
    riff = (ic.CORPUS / "webp_lossless_5x3.webp").read_bytes()
    assert image_io.format_of(riff[:12] + b"ALPH" + riff[16:]) is None


def test_size_past_pillows_limit_is_refused_before_decoding():
    """Pillow's decompression-bomb limit on the BMP's, the GIF screen's
    and the WebP canvas's size; a GIF screen of 0x0 grows to hold its
    frame, as Pillow's does."""
    bmp = bytearray((ic.CORPUS / "bmp_24bit_5x3.bmp").read_bytes())
    bmp[18:26] = (20000).to_bytes(4, "little") * 2
    gif = bytearray((ic.CORPUS / "gif_global_table_5x3.gif").read_bytes())
    gif[6:10] = (65535).to_bytes(2, "little") * 2
    webp = bytearray((ic.CORPUS / "webp_animation_lossy_5x3.webp")
                     .read_bytes())
    at = webp.index(b"VP8X") + 12
    webp[at:at + 6] = (19999).to_bytes(3, "little") * 2
    for data in (bmp, gif, webp):
        with pytest.raises(ValueError, match="image size"):
            image_io.read_image(bytes(data))
    gif[6:10] = bytes(4)
    assert image_io.read_image(bytes(gif)).shape == (5, 3, 3)
    pytest.importorskip("PIL")
    assert_like_pillow(bytes(gif))


# ---------------------------------------- the JAX package's CocoDataset

def _coco_dir(root: Path) -> Path:
    """A COCO directory of the three scenes as lossy WebP, one lossless
    WebP, and two each as GIF and BMP (the writers', from the scenes'
    JPEG files' decodes)."""
    images, files = [], []
    for name in INDEX["format_scenes"]:
        files.append((name, (ic.CORPUS / name).read_bytes()))
    for scene in list(INDEX["scenes"])[:2]:
        img = image_io.read_image(ic.CORPUS / scene)
        h, w = img.shape[:2]
        idx, palette = iw.quantize_332(img)
        files.append((scene + ".gif", iw.encode_gif(idx,
                                                    global_palette=palette)))
        files.append((scene + ".bmp", iw.encode_bmp(
            w, h, 24, iw.bmp_pixels(img, 24)[::-1].tobytes())))
    (root / "val2014").mkdir(parents=True)
    (root / "annotations").mkdir()
    anns = []
    for i, (name, data) in enumerate(files, 1):
        file_name = f"COCO_val2014_{i:012d}.{name.rsplit('.', 1)[1]}"
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


def test_jax_coco_dataset_reads_the_formats_as_the_port(tmp_path):
    """maskrcnn_tpu/data/coco.py's load_image and load (Pillow) against
    the port's (its native readers) on WebP, GIF and BMP files."""
    pytest.importorskip("PIL")
    from maskrcnn_tpu.config import TinyConfig
    from maskrcnn_tpu.data import coco as jax_coco
    from maskrcnn_tpu_torch import TinyConfig as PortTinyConfig
    from maskrcnn_tpu_torch.data import coco as port_coco
    root = str(_coco_dir(tmp_path / "coco"))
    ref = jax_coco.CocoDataset(root, "minival", 2014, TinyConfig())
    port = port_coco.CocoDataset(root, "minival", 2014, PortTinyConfig())
    assert port.ids == ref.ids and len(port.ids) == 8
    for i, image_id in enumerate(port.ids):
        np.testing.assert_array_equal(port.load_image(image_id),
                                      ref.load_image(image_id))
        for a, b in zip(port.load(i), ref.load(i)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ----------------------------------------------------- threads, builds

def test_four_threads_decode_webp_like_one():
    """Each decode is one ctypes call that releases the GIL: four threads
    over the WebP scenes give the one-thread arrays."""
    names = list(INDEX["format_scenes"]) + [
        n for files in MODES.values() for n in files
        if n.startswith("webp_") and "37x53" in n]
    files = [(ic.CORPUS / n).read_bytes() for n in names]
    want = [image_io.read_image(d) for d in files]
    with ThreadPoolExecutor(4) as pool:
        got = list(pool.map(image_io.read_image, files * 3))
    for k, img in enumerate(got):
        assert np.array_equal(img, want[k % len(files)])


FAILED_BUILD = """
import os
os.environ["CXX"] = "/nonexistent/g++-for-a-test"
from maskrcnn_tpu_torch.data import native_image
native_image.CXX_FLAGS = native_image.CXX_FLAGS + ("-DFAILED_BUILD_TEST",)
try:
    native_image.decode_webp(open("tests/data/image_io/"
                                  "webp_lossless_5x3.webp", "rb").read())
    print("DECODED")
except RuntimeError as e:
    print("RAISED", e)
"""


def test_failed_webp_build_raises_naming_the_compiler():
    proc = subprocess.run([sys.executable, "-c", FAILED_BUILD], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert "RAISED" in proc.stdout, proc.stdout + proc.stderr
    assert "webp_decode.cpp" in proc.stdout
    assert "/nonexistent/g++-for-a-test" in proc.stdout


NO_SYSTEM_CODECS = """
import re, sys
sys.path.insert(0, "tests")
from maskrcnn_tpu_torch.data import image_io
from tools import image_decode_bench_torch as bench
for name in sys.argv[1:]:
    image_io.read_image("tests/data/image_io/" + name)
for data in bench.format_scenes().values():
    image_io.read_image(data)
maps = open("/proc/self/maps").read().split()
bad = sorted({p for p in maps if re.match(r"lib(webp|gif|avif|aom|dav1d)[.-]",
                                          p.rsplit("/", 1)[-1])
              or "pillow.libs" in p or "opencv_python.libs" in p})
bad += sorted(m for m in sys.modules if m == "PIL" or m.startswith("PIL."))
print("BAD", bad)
"""


def test_decoders_load_no_system_codec_and_link_only_runtimes():
    """Decoding every format in a fresh interpreter (AVIF among them) loads
    no libwebp, giflib, libavif, libaom, dav1d or Pillow; the built
    libraries name only the C and C++ runtimes."""
    names = [MODES[m][0] for m in sorted(MODES)]
    proc = subprocess.run([sys.executable, "-c", NO_SYSTEM_CODECS, *names],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert "BAD []" in proc.stdout, proc.stdout + proc.stderr
    for path in (native_image.library_path(),
                 native_image.webp_library_path(),
                 native_image.avif_library_path()):
        if not path.exists():
            continue
        out = subprocess.run(["ldd", str(path)], capture_output=True,
                             text=True).stdout
        libs = {line.split()[0].rsplit("/", 1)[-1]
                for line in out.splitlines() if line.strip()}
        runtimes = ("linux-vdso", "libstdc++", "libgcc_s", "libc.", "libm.",
                    "ld-linux")
        assert libs and all(lib.startswith(runtimes) for lib in libs), libs
