"""The port's image reader and PNG writer (maskrcnn_tpu_torch/data/
image_io.py) against Pillow: the same RGB uint8 pixels, bit for bit,
through the native route (`read_image`) and the plain Python route
(`read_image(..., plain=True)`) alike, for every repository image, for
seeded JPEGs Pillow encodes (4:4:4, 4:2:2, 4:2:0, grayscale, quality 50
and 95, restart intervals, optimized Huffman tables, odd sizes) and for
seeded PNGs of each mode with rows of each of the five filters; the
modes each route refuses raise NotImplementedError naming them
(tests/test_torch_image_native.py holds the native route's other modes)."""

import hashlib
import io
import struct
import zlib
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

import chip_smoke
from maskrcnn_tpu_torch.data import image_io

REPO = Path(__file__).resolve().parent.parent
REPO_IMAGES = ["images/sample.jpg", "images/synthetic_scene.png"] + sorted(
    str(p.relative_to(REPO)) for p in (REPO / "output").glob("*.jpg"))

# Pillow 12.1.0's decode of the repository's images (rows, columns,
# SHA-256 of np.asarray(Image.open(f).convert("RGB"))); chip_smoke.py's
# phase 9a holds the port's reader to the same digests on the card.
IMAGE_DIGESTS = {
    "images/sample.jpg": (480, 640, "7d5e9dfd71f8d2cbcea7df1e163204957121598b1ef8c3630f7211ffc77a7add"),
    "images/synthetic_scene.png": (1024, 1024, "7a2be11f136780caf6ef39986a3d36b7ce82527dba9a75611111ba5566f4ae34"),
    "output/anchors.jpg": (463, 447, "62a4220713a429a820ac649ab3aff67fbb03299d61eb8810c06d1d0562ad4e72"),
    "output/custom_finetune.jpg": (504, 481, "dcbe34a8ff7fdd6ee22dc97e60d07b6721b75ebd75ff83970351b6e5eb158fce"),
    "output/detections.jpg": (1252, 1252, "3b26b0cfb2932801b77c617f2d5d9972ae49b1dc979f38ad9326ebd1f421f911"),
    "output/keypoints.jpg": (1274, 1252, "9518e5b0bf6f0d5e76390c4404e200bf534c47efad0895ac2481deb6b9e7cbc8"),
    "output/mask_head.jpg": (146, 1008, "c812e04daa25d88645a4697a19edbe3f9e3e27c025f3eea658cf456b0757a468"),
    "output/p2_features.jpg": (340, 729, "9c94ba9e546535e89a0304378f93e2a4999efe2397ecdcb47f3a1d1d5bfcf2ca"),
    "output/rpn_refine.jpg": (463, 447, "b75b7a0d999fed779ee7c7d2212e71bfcfa92631934e84d23db96ba8f07d6388"),
    "output/tpu_trained_int8_detections.jpg": (1274, 1252, "5b89d7e575d4542dc7323122fb8722140931ddf71d60ef5a9083ecaa71e3db3b"),
}


def pillow(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def read_both(data: bytes) -> np.ndarray:
    """The native route's pixels, held equal to the plain route's."""
    got = image_io.read_image(data)
    np.testing.assert_array_equal(got, image_io.read_image(data, plain=True))
    return got


def seeded_image(rng, h, w, channels=3):
    """Smooth gradients with noise and a hard edge: the IDCT, the
    upsampling and the range limit all see work."""
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([(yy * 7 + xx * 3) % 256, (xx * 11) % 256,
                     255 - (yy * 5) % 256], -1)[..., :channels]
    img = base + rng.randint(-40, 41, base.shape)
    img[: h // 2, : w // 3] = 255 if h > 1 else img[: h // 2, : w // 3]
    return np.clip(img, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("name", REPO_IMAGES)
def test_repository_image_equals_pillow(name):
    """Every repository image: the port's pixels are Pillow's, and their
    digest is the one committed here and in chip_smoke.py."""
    data = (REPO / name).read_bytes()
    got = read_both(data)
    np.testing.assert_array_equal(got, pillow(data))
    h, w, digest = IMAGE_DIGESTS[name]
    assert got.shape == (h, w, 3)
    assert hashlib.sha256(got.tobytes()).hexdigest() == digest
    assert chip_smoke.IMAGE_DIGESTS[name] == IMAGE_DIGESTS[name]


def test_digests_cover_the_repository_images():
    assert sorted(IMAGE_DIGESTS) == sorted(REPO_IMAGES)
    assert chip_smoke.IMAGE_DIGESTS == IMAGE_DIGESTS


def _jpeg(img, **kw):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", **kw)
    return buf.getvalue()


SIZES = [(1, 1), (8, 8), (17, 23), (33, 7)]


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("quality", [50, 95])
@pytest.mark.parametrize("sampling", ["4:4:4", "4:2:2", "4:2:0"])
def test_seeded_jpeg_equals_pillow(sampling, quality, size):
    rng = np.random.RandomState(quality + size[0] * 31 + size[1])
    data = _jpeg(seeded_image(rng, *size), quality=quality,
                 subsampling=sampling)
    np.testing.assert_array_equal(read_both(data), pillow(data))


@pytest.mark.parametrize("size", SIZES + [(40, 57)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_grayscale_jpeg_equals_pillow(size):
    rng = np.random.RandomState(size[0] * 7 + size[1])
    img = seeded_image(rng, *size, channels=1)[..., 0]
    for quality in (50, 95):
        data = _jpeg(img, quality=quality)
        np.testing.assert_array_equal(read_both(data), pillow(data))


@pytest.mark.parametrize("restart", [dict(restart_marker_blocks=1),
                                     dict(restart_marker_blocks=3),
                                     dict(restart_marker_rows=1)],
                         ids=["every_mcu", "every_3_mcus", "every_row"])
@pytest.mark.parametrize("sampling", ["4:4:4", "4:2:0"])
def test_restart_intervals_equal_pillow(sampling, restart):
    rng = np.random.RandomState(5)
    data = _jpeg(seeded_image(rng, 45, 61), quality=90,
                 subsampling=sampling, **restart)
    assert b"\xff\xdd" in data            # a DRI marker
    np.testing.assert_array_equal(read_both(data), pillow(data))


def test_optimized_huffman_tables_and_file_objects():
    """optimize=True writes per-image Huffman tables; a file object reads
    as its bytes do."""
    rng = np.random.RandomState(6)
    data = _jpeg(seeded_image(rng, 70, 90), quality=75, optimize=True)
    want = pillow(data)
    np.testing.assert_array_equal(read_both(data), want)
    np.testing.assert_array_equal(image_io.read_image(io.BytesIO(data)), want)


# ---------------------------------------------------------------- PNG

@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "P"])
def test_seeded_png_of_each_mode_equals_pillow(mode):
    rng = np.random.RandomState(len(mode))
    rgb = seeded_image(rng, 29, 37)
    img = Image.fromarray(rgb)
    if mode == "P":
        img = img.quantize(colors=50)
    else:
        img = img.convert(mode)
    for kw in ({}, {"optimize": True}):
        buf = io.BytesIO()
        img.save(buf, "PNG", **kw)
        data = buf.getvalue()
        np.testing.assert_array_equal(read_both(data), pillow(data))


def _filter_rows(rows: np.ndarray, bpp: int, kinds) -> bytes:
    """PNG rows [H, stride] filtered with the given filter a row."""
    out = bytearray()
    prior = np.zeros(rows.shape[1], np.int64)
    for row, kind in zip(rows.astype(np.int64), kinds):
        left = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])
        up_left = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])
        if kind == 0:
            pred = np.zeros_like(row)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = prior
        elif kind == 3:
            pred = (left + prior) // 2
        else:
            p = left + prior - up_left
            pa, pb, pc = (np.abs(p - left), np.abs(p - prior),
                          np.abs(p - up_left))
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prior, up_left))
        out.append(kind)
        out += ((row - pred) % 256).astype(np.uint8).tobytes()
        prior = row
    return bytes(out)


def _raw_png(rows: np.ndarray, width: int, color: int, kinds,
             bpp: int, interlace: int = 0, depth: int = 8) -> bytes:
    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))
    header = struct.pack(">IIBBBBB", width, rows.shape[0], depth, color, 0,
                         0, interlace)
    return (image_io.PNG_SIGNATURE + chunk(b"IHDR", header)
            + chunk(b"IDAT", zlib.compress(_filter_rows(rows, bpp, kinds)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4],
                         ids=["none", "sub", "up", "average", "paeth"])
@pytest.mark.parametrize("color,bpp", [(2, 3), (0, 1), (6, 4)],
                         ids=["rgb", "gray", "rgba"])
def test_hand_filtered_png_rows_equal_pillow(kind, color, bpp):
    """Rows built by hand with one filter each (and mixed with the
    others), so every filter's decode is held to Pillow's."""
    rng = np.random.RandomState(kind * 10 + color)
    width = 23
    rows = rng.randint(0, 256, (9, width * bpp)).astype(np.uint8)
    for kinds in ([kind] * 9, [kind, 0, 1, 2, 3, 4, kind, kind, 2]):
        data = _raw_png(rows, width, color, kinds, bpp)
        got = read_both(data)
        np.testing.assert_array_equal(got, pillow(data))


def test_write_png_round_trips_through_pillow(tmp_path):
    """write_png (filter 0, zlib) is read back exactly by Pillow and by the
    port, RGB and grayscale, to a path and to a file object."""
    rng = np.random.RandomState(8)
    rgb = rng.randint(0, 256, (31, 45, 3), dtype=np.uint8)
    gray = rng.randint(0, 256, (17, 9), dtype=np.uint8)
    image_io.write_png(tmp_path / "a.png", rgb)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "a.png")),
                                  rgb)
    np.testing.assert_array_equal(image_io.read_image(tmp_path / "a.png"), rgb)
    buf = io.BytesIO()
    image_io.write_png(buf, gray)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(
        buf.getvalue()))), gray)
    np.testing.assert_array_equal(image_io.read_image(buf.getvalue()),
                                  np.repeat(gray[..., None], 3, 2))
    with pytest.raises(ValueError):
        image_io.encode_png(rgb.astype(np.float32))


def _patched_sof(data: bytes, marker: int = None, precision: int = None):
    """The JPEG with its SOF marker or sample precision rewritten."""
    i = data.index(b"\xff\xc0")
    out = bytearray(data)
    if marker is not None:
        out[i + 1] = marker
    if precision is not None:
        out[i + 4] = precision
    return bytes(out)


def test_unsupported_modes_raise_naming_them():
    """Both routes fail on 12-bit JPEG, which no plugin of Pillow's opens
    (a ValueError), and the plain route refuses arithmetic
    coding and lossless frames, which the native route reads (a baseline
    file's Huffman data under either frame marker gives Pillow's outcome:
    the arithmetic decoder's pixels, libjpeg's refusal of the lossless
    scan's parameters); the plain route also refuses what only the native
    route reads (progressive, CMYK, Adobe transform 0, Adam7, 16-bit
    PNG)."""
    rng = np.random.RandomState(9)
    img = seeded_image(rng, 24, 24)
    base = _jpeg(img)
    arith = _patched_sof(base, marker=0xC9)
    lossless = _patched_sof(base, marker=0xC3)
    np.testing.assert_array_equal(
        image_io.read_image(arith),
        np.asarray(Image.open(io.BytesIO(arith)).convert("RGB")))
    with pytest.raises(OSError):
        Image.open(io.BytesIO(lossless)).convert("RGB")
    with pytest.raises(ValueError, match="lossless scan"):
        image_io.read_image(lossless)
    with pytest.raises(NotImplementedError, match="arithmetic"):
        image_io.read_image(arith, plain=True)
    with pytest.raises(NotImplementedError, match="lossless"):
        image_io.read_image(lossless, plain=True)
    for plain in (False, True):
        with pytest.raises(ValueError, match="no plugin of Pillow's"):
            image_io.read_image(_patched_sof(base, precision=12),
                                plain=plain)
    with pytest.raises(NotImplementedError, match="progressive"):
        image_io.read_image(_jpeg(img, progressive=True), plain=True)
    buf = io.BytesIO()
    Image.fromarray(img).convert("CMYK").save(buf, "JPEG")
    with pytest.raises(NotImplementedError, match="CMYK"):
        image_io.read_image(buf.getvalue(), plain=True)
    with pytest.raises(NotImplementedError, match="Adobe transform"):
        image_io.read_image(_jpeg(img, keep_rgb=True), plain=True)
    rows = rng.randint(0, 256, (5, 15)).astype(np.uint8)
    with pytest.raises(NotImplementedError, match="interlaced"):
        image_io.read_image(_raw_png(rows, 5, 2, [0] * 5, 3, interlace=1),
                            plain=True)
    with pytest.raises(NotImplementedError, match="bit depth 16"):
        image_io.read_image(_raw_png(rows, 5, 2, [0] * 5, 3, depth=16),
                            plain=True)
    # a PPM file: the native route reads it (Pillow's pixels), the plain
    # route names it
    ppm = b"P6\n5 3\n255\n" + bytes(range(45))
    assert np.array_equal(image_io.read_image(ppm),
                          np.arange(45, dtype=np.uint8).reshape(3, 5, 3))
    with pytest.raises(NotImplementedError, match="PPM: the plain route"):
        image_io.read_image(ppm, plain=True)
    # an IM header and 45 zero bytes: a black 5x3 RGB image to the native
    # route, a format the plain route does not read
    im = b"Image type: RGB image\nImage size (x*y): 5*3\n\x1a" + bytes(45)
    assert np.array_equal(image_io.read_image(im),
                          np.zeros((3, 5, 3), np.uint8))
    with pytest.raises(NotImplementedError, match="IM: the plain route"):
        image_io.read_image(im, plain=True)
    for plain in (False, True):
        # bytes no plugin of Pillow's takes, and an EPS header: a format
        # Pillow reads (through Ghostscript) that neither route reads
        with pytest.raises(ValueError, match="no plugin of Pillow's"):
            image_io.read_image(b"Q6\n5 3\n255\n" + bytes(45), plain=plain)
        with pytest.raises(NotImplementedError, match="EPS: .*Ghostscript"):
            image_io.read_image(b"%!PS-Adobe-3.0\n%%BoundingBox: 0 0 5 3\n"
                                b"%%EndComments\n", plain=plain)
        # a header claiming more pixels than Pillow's decompression-bomb
        # limit
        huge = bytearray(_raw_png(rows, 5, 2, [0] * 5, 3))
        huge[16:24] = struct.pack(">II", 20000, 20000)
        # the header's checksum follows it (Pillow passes on a PNG whose
        # header fails its checksum before its size is read)
        huge[29:33] = struct.pack(">I", zlib.crc32(bytes(huge[12:29])))
        with pytest.raises(ValueError, match="image size"):
            image_io.read_image(bytes(huge), plain=plain)
    # a TIFF header alone: a corrupt TIFF to the native route, a format
    # the plain route does not read
    with pytest.raises(ValueError, match="TIFF"):
        image_io.read_image(b"II*\x00" + bytes(12))
    with pytest.raises(NotImplementedError, match="TIFF: the plain route"):
        image_io.read_image(b"II*\x00" + bytes(12), plain=True)
    # a GIF signature alone: Pillow's GIF plugin passes it on (its screen
    # descriptor is cut short) and no other takes it, on both routes; a
    # GIF file is a format the plain route does not read
    for plain in (False, True):
        with pytest.raises(ValueError, match="no plugin of Pillow's"):
            image_io.read_image(b"GIF89a", plain=plain)
    buf = io.BytesIO()
    Image.new("P", (3, 2)).save(buf, "GIF")
    with pytest.raises(NotImplementedError, match="GIF: the plain route"):
        image_io.read_image(buf.getvalue(), plain=True)


@pytest.mark.parametrize("h,w", [(3, 3), (2, 5), (5, 2), (16, 16)])
def test_upsample_edges(h, w):
    """A 4:2:0 image whose chroma is 2 or fewer samples wide takes
    jdsample.c's replication, a wider one the triangle filter: both
    equal Pillow's."""
    rng = np.random.RandomState(h * 10 + w)
    data = _jpeg(seeded_image(rng, h, w), quality=90, subsampling="4:2:0")
    np.testing.assert_array_equal(read_both(data), pillow(data))
