"""The port's DDS reader (data/native_image.decode_dds over
csrc/bcn_decode.cpp) against Pillow 12.1.0's DdsImagePlugin: the
committed DDS, BLP and PSD files (tests/data/texture_io, written by
`python tests/image_corpus.py --textures`) to their digests and Pillow's
live decode, or to a ValueError where Pillow fails; seeded random blocks
of every BCn format (every 128-bit BC6H and BC7 block is input the
decoder takes, and every mode of both is forced), uncompressed RGB(A)
under random masks and bit counts, the raw routes cut at every header
boundary, and byte edits of the corpus's DDS files, each giving Pillow's
outcome; the BC6H/BC7 partition tables committed in csrc/bcn_tables.h
are the ones Pillow's decoder gives."""

import hashlib
import io
import json
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

INDEX = json.loads((ic.TEXTURES / "index.json").read_text())


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


def test_texture_corpus_is_whole_and_small():
    """The index names every file of tests/data/texture_io (each DDS, BLP
    and PSD route at the corpus's four sizes, and the files Pillow fails
    on), which hold at most 600 KB."""
    files = {p.name for p in ic.TEXTURES.iterdir()} - {"index.json"}
    assert files == set(INDEX["files"]) | set(INDEX["errors"])
    assert sum((ic.TEXTURES / n).stat().st_size for n in files) <= 600_000
    routes = {}
    for name in files:
        stem, ext = name.rsplit(".", 1)
        route, size = stem.rsplit("_", 1)
        if "x" in size and size.replace("x", "").isdigit():
            routes.setdefault(route, set()).add(size)
    assert len([r for r in routes if r.startswith("dds_")]) == 43
    assert len([r for r in routes if r.startswith("blp_")]) == 16
    assert len([r for r in routes if r.startswith("psd_")]) == 28
    assert all(len(s) == 4 for s in routes.values())


@pytest.mark.parametrize("name", sorted(INDEX["files"]))
def test_texture_file_equals_pillow_and_its_digest(name):
    data = (ic.TEXTURES / name).read_bytes()
    got = image_io.read_image(data)
    np.testing.assert_array_equal(got, pillow(data))
    entry = INDEX["files"][name]
    assert list(got.shape) == entry["shape"] + [3]
    assert hashlib.sha256(got.tobytes()).hexdigest() == entry["sha256"]


@pytest.mark.parametrize("name", sorted(INDEX["errors"]))
def test_texture_file_pillow_fails_on_raises(name):
    data = (ic.TEXTURES / name).read_bytes()
    assert isinstance(outcome(pillow, data), Exception)
    with pytest.raises(ValueError):
        image_io.read_image(data)


def test_partition_tables_are_pillows():
    """csrc/bcn_tables.h is what `image_corpus.bcn_tables()` reads off
    Pillow's decoder now."""
    assert ic.BCN_TABLES.read_text() == ic.bcn_tables()


# (key, block bytes) of every BCn format DdsImagePlugin reads
BCN = [("fourcc", b"DXT1", 8), ("fourcc", b"DXT3", 16), ("fourcc", b"DXT5", 16),
       ("fourcc", b"BC4U", 8), ("fourcc", b"ATI1", 8), ("fourcc", b"BC5U", 16),
       ("fourcc", b"ATI2", 16), ("fourcc", b"BC5S", 16), ("dxgi", "BC1", 8),
       ("dxgi", "BC2", 16), ("dxgi", "BC3", 16), ("dxgi", "BC4", 8),
       ("dxgi", "BC5", 16), ("dxgi", "BC5S", 16), ("dxgi", "BC6H", 16),
       ("dxgi", "BC6HS", 16), ("dxgi", "BC7", 16)]


def _dds(kind, fmt, w, h, payload):
    if kind == "fourcc":
        return iw.encode_dds(w, h, payload, fourcc=fmt)
    return iw.encode_dds(w, h, payload, dxgi=iw.DXGI[fmt])


@pytest.mark.parametrize("kind,fmt,size", BCN,
                         ids=[str(f) for _, f, _ in BCN])
def test_seeded_random_blocks_equal_pillow(kind, fmt, size):
    """Random blocks of one format, 1,024 of them on a 128x128 image and
    a ragged 37x23 one (partial blocks at the right and bottom), and the
    same file cut by a byte (Pillow's truncated file)."""
    rng = np.random.RandomState(sum(str(fmt).encode()))
    for h, w in ((128, 128), (37, 23)):
        n = ((w + 3) // 4) * ((h + 3) // 4)
        data = _dds(kind, fmt, w, h,
                    rng.randint(0, 256, n * size).astype(np.uint8).tobytes())
        assert same_outcome(data) == "", (fmt, h, w, same_outcome(data))
        assert same_outcome(data[:-1]) == ""


def test_every_bc6h_and_bc7_mode_equals_pillow():
    """Each of BC6H's 14 modes (and the reserved ones, black) and BC7's 8
    (and a zero first byte, opaque black), signed and unsigned BC6H: 256
    random blocks of each, its mode bits forced."""
    rng = np.random.RandomState(61)
    blocks = rng.randint(0, 256, (256, 16)).astype(np.uint8)
    modes6 = [0, 1] + [2 + 4 * k for k in range(8)] + [3 + 4 * k
                                                       for k in range(8)]
    for key in ("BC6H", "BC6HS"):
        for m in modes6:
            b = blocks.copy()
            mask = 3 if m < 2 else 31
            b[:, 0] = (b[:, 0] & (0xFF ^ mask)) | m
            data = iw.encode_dds(64, 64, b.tobytes(), dxgi=iw.DXGI[key])
            assert same_outcome(data) == "", (key, m)
    for m in range(9):
        b = blocks.copy()
        if m == 8:
            b[:, 0] = 0
        else:
            b[:, 0] = ((b[:, 0] >> (m + 1)) << (m + 1)) | (1 << m)
        data = iw.encode_dds(64, 64, b.tobytes(), dxgi=iw.DXGI["BC7"])
        assert same_outcome(data) == "", ("BC7", m)


def test_mask_layouts_equal_pillow():
    """DdsRgbDecoder over random masks (zero ones too) and bit counts
    (below 8, not a multiple of 8, above 32), 3 and 4 masks, the pixel
    data short or long."""
    rng = np.random.RandomState(62)
    for _ in range(80):
        h, w = rng.randint(1, 9, 2)
        bitcount = int(rng.choice([8, 16, 24, 32, 0, 4, 12, 40, 64]))
        count = int(rng.choice([3, 4]))
        masks = []
        for _ in range(4):
            if rng.rand() < 0.15:
                masks.append(0)
                continue
            lo = rng.randint(0, 31)
            masks.append(((1 << rng.randint(1, 33 - lo)) - 1) << lo)
        pf = iw.DDPF_RGB | (iw.DDPF_ALPHAPIXELS if count == 4 else 0)
        n = max(0, h * w * max(bitcount, 8) // 8 + rng.randint(-3, 3))
        data = iw.encode_dds(w, h, rng.randint(0, 256, n).astype(np.uint8)
                             .tobytes(), pfflags=pf, bitcount=bitcount,
                             masks=masks)
        assert same_outcome(data) == "", (bitcount, masks)


def test_raw_routes_cut_anywhere_equal_pillow():
    """L, LA, P (its RGBA palette) and R8G8B8A8 (DX10: its pixels start
    where _open's reads left the file, Pillow's load_seek doing nothing),
    and BCn behind a DX10 header, cut at every header boundary and in
    their data."""
    rng = np.random.RandomState(63)
    h, w = 5, 7
    cases = [
        iw.encode_dds(w, h, rng.randint(0, 256, h * w).astype(np.uint8)
                      .tobytes(), pfflags=iw.DDPF_LUMINANCE, bitcount=8),
        iw.encode_dds(w, h, rng.randint(0, 256, 2 * h * w).astype(np.uint8)
                      .tobytes(), pfflags=iw.DDPF_LUMINANCE | 1, bitcount=16),
        iw.encode_dds(w, h, rng.randint(0, 256, h * w).astype(np.uint8)
                      .tobytes(), pfflags=iw.DDPF_PALETTEINDEXED8,
                      bitcount=8, palette=rng.randint(0, 256, 1024)
                      .astype(np.uint8).tobytes()),
        iw.encode_dds(w, h, rng.randint(0, 256, 4 * h * w).astype(np.uint8)
                      .tobytes(), dxgi=iw.DXGI["RGBA"]),
        iw.encode_dds(w, h, rng.randint(0, 256, 4 * 16).astype(np.uint8)
                      .tobytes(), dxgi=iw.DXGI["BC7"]),
    ]
    for data in cases:
        for cut in sorted({127, 128, 129, 131, 132, 140, 147, 148, 149,
                           1151, 1152, len(data) - 1, len(data)}):
            if cut <= len(data):
                assert same_outcome(data[:cut]) == "", (data[84:88], cut)


def test_edited_dds_files_give_pillows_outcome():
    """Seeded byte edits of the corpus's DDS files (headers and data)."""
    rng = np.random.RandomState(64)
    names = sorted(n for n in INDEX["files"]
                   if n.startswith("dds_") and n.endswith("_16x24.dds"))
    for name in names:
        data = (ic.TEXTURES / name).read_bytes()
        for _ in range(6):
            e = bytearray(data)
            at = rng.randint(0, 160) if rng.rand() < 0.7 else \
                rng.randint(0, len(e))
            e[min(at, len(e) - 1)] = rng.randint(0, 256)
            assert same_outcome(bytes(e)) == "", (name, at)
