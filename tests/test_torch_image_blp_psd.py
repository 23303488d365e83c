"""The port's BLP and PSD readers (data/native_image.decode_blp and
decode_psd over csrc/bcn_decode.cpp) against Pillow 12.1.0's
BlpImagePlugin and PsdImagePlugin, and the probe's model of Image.open
on PSD headers and on AVIF files (libavif 1.3's parse): seeded files of
every BLP route (BLP1 JPEG of every colour space, palettes, BLP2's own
Python DXT decoders, the JPEG's size against the BLP's) and PSD mode (raw
and PackBits, layer sections, resources), PackBits streams of every edge
(runs and literals past a row's end, no-op bytes, byte counts that lie),
cut and byte-edited files, each giving Pillow's outcome; a PSD of a
(mode, bits) pair Pillow's MODES lacks is no PSD to the probe; every
AVIF edit that Image.open rejects raises ValueError, and the rest are
named AVIF and read as Pillow reads them."""

import io
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
from test_torch_image_dds import same_outcome  # noqa: E402


def _jpeg(img, mode, **kw):
    return ic._pil(img, "JPEG", mode, quality=85, **kw)


@pytest.mark.parametrize("seed,h,w", [(80, 7, 10), (81, 13, 5), (82, 4, 4)])
def test_seeded_blp_files_equal_pillow(seed, h, w):
    """Every BLP route at a size of its own (ic.blp_modes), and each cut
    and byte-edited at random."""
    rng = np.random.RandomState(seed)
    for route, data in ic.blp_modes(rng, h, w):
        assert same_outcome(data) == "", route
        for _ in range(4):
            cut = rng.randint(8, len(data))
            assert same_outcome(data[:cut]) == "", (route, cut)
            e = bytearray(data)
            at = rng.randint(4, min(len(e), 200))
            e[at] = rng.randint(0, 256)
            assert same_outcome(bytes(e)) == "", (route, at)


def test_blp1_jpeg_sizes_and_modes_equal_pillow():
    """BLP1's JPEG: its bytes read as BGR rows of the BLP's width (a JPEG
    larger than the BLP, or smaller: not enough image data), CMYK with
    jpegmode "CMYK" (YCCK components unconverted), the shared header
    split anywhere, bytes between it and the mip's offset, an offset
    before the header's end, and a stream that is not a JPEG."""
    rng = np.random.RandomState(83)
    img = ic.seeded_image(rng, 12, 9)
    for mode in ("RGB", "L", "CMYK"):
        jpeg = _jpeg(img, mode)
        if mode == "CMYK":
            variants = [jpeg, ic.with_transform(jpeg, 2),
                        ic.without_adobe(jpeg)]
        else:
            variants = [jpeg]
        for j in variants:
            for w, h in ((9, 12), (5, 7), (12, 12), (9, 13)):
                for split in (0, 2, 100, len(j) - 1):
                    data = iw.blp_jpeg_file(j, w, h, split=split,
                                            gap=b"\0" * (split % 3))
                    assert same_outcome(data) == "", (mode, w, h, split)
            data = iw.blp_jpeg_file(j, 9, 12, split=50)
            early = bytearray(data)
            early[28:32] = struct.pack("<I", 100)
            assert same_outcome(bytes(early)) == ""
    assert same_outcome(iw.blp_jpeg_file(b"GIF89a" + bytes(30), 2, 2)) == ""


def test_blp_palettes_and_dxt_edges_equal_pillow():
    """Palette indices shorter and longer than the image, BLP2's offset
    past the file, DXT of widths and heights that are not multiples of 4
    read back by the image's width (Pillow's sheared rows), DXT3/5 into
    an RGB image (4 bytes a texel read as 3), every BLP1 encoding and
    BLP2 alpha encoding byte."""
    rng = np.random.RandomState(84)
    pal = rng.randint(0, 256, (256, 4)).astype(np.uint8)
    for h, w in ((3, 5), (6, 6), (1, 9)):
        idx = rng.randint(0, 256, (h, w)).astype(np.uint8)
        for v in (1, 2):
            data = iw.blp_palette_file(idx, pal, version=v)
            lengths_at = (28 if v == 1 else 20) + 64
            for n in (0, h * w - 1, h * w + 3):
                e = bytearray(data)
                e[lengths_at:lengths_at + 4] = struct.pack("<I", n)
                assert same_outcome(bytes(e) + bytes(8)) == "", (v, n)
        for enc, size in ((0, 8), (1, 16), (7, 16)):
            blocks = rng.randint(0, 256, ((w + 3) // 4) * ((h + 3) // 4)
                                 * size).astype(np.uint8).tobytes()
            for alpha in (0, 1):
                data = iw.blp_dxt_file(blocks, w, h, alpha_encoding=enc,
                                       alpha=alpha)
                assert same_outcome(data) == "", (enc, alpha)
    data = iw.blp_palette_file(rng.randint(0, 256, (4, 4)).astype(np.uint8),
                               pal, version=1)
    for enc in range(8):
        e = bytearray(data)
        e[20:24] = struct.pack("<i", enc)
        assert same_outcome(bytes(e)) == "", enc
    for byte in (8, 10):
        for v in range(-3, 10):
            e = bytearray(iw.blp_dxt_file(bytes(16), 4, 4, alpha_encoding=7))
            e[byte] = v & 0xFF
            assert same_outcome(bytes(e)) == "", (byte, v)


@pytest.mark.parametrize("seed,h,w", [(85, 6, 11), (86, 17, 3), (87, 2, 2)])
def test_seeded_psd_files_equal_pillow(seed, h, w):
    """Every PSD mode raw and PackBits (ic.psd_modes) at a size of its
    own, each cut and byte-edited at random."""
    rng = np.random.RandomState(seed)
    for route, data in ic.psd_modes(rng, h, w):
        assert same_outcome(data) == "", route
        for _ in range(4):
            cut = rng.randint(26, len(data))
            assert same_outcome(data[:cut]) == "", (route, cut)
            e = bytearray(data)
            at = rng.randint(26, len(e))
            e[at] = rng.randint(0, 256)
            assert same_outcome(bytes(e)) == "", (route, at)


def _psd_rle(streams, counts, h, w, mode="L"):
    """A PSD of one or more channels given as raw PackBits streams and
    the byte-count table Pillow reads (only their sums matter to it)."""
    pmode, bits = iw.PSD_MODES[mode]
    c = len(streams)
    head = struct.pack(">4sH6xHIIHH", b"8BPS", 1, c, h, w, bits, pmode)
    head += struct.pack(">III", 0, 0, 0) + struct.pack(">H", 1)
    table = b"".join(struct.pack(">H", n) for n in counts)
    return head + table + b"".join(streams)


def test_packbits_edges_equal_pillow():
    """Pillow's PackDecode.c, not libtiff's: a run or literal past a row's
    end is cut there (the rest dropped), packets run on across rows, 0x80
    is a no-op, a channel's stream runs on past its byte counts into the
    next channel's, a stream cut inside a packet, counts that sum to more
    or less than the data."""
    h, w = 3, 5
    cases = [
        [bytes([0xFC, 7]) + bytes([0xFC, 8]) + bytes([0xFC, 9])],
        [bytes([0x08]) + bytes(range(9)) + bytes([0xF5, 3])],
        [bytes([0x80, 0x80, 0xFC, 1, 0x80, 0xFC, 2, 0xFC, 3])],
        [bytes([0x0E]) + bytes(range(15))],
        [bytes([0xF2, 5])],
        [bytes([0x04, 1, 2, 3])],
    ]
    for streams in cases:
        for counts in ([len(streams[0]), 0, 0], [1, 1, 1], [200, 0, 0]):
            data = _psd_rle(streams, counts, h, w)
            assert same_outcome(data) == "", (streams, counts)
            assert same_outcome(data + bytes([0xFC, 0]) * 4) == ""
    # two channels: the first short of its rows runs into the second's
    r = bytes([0xFC, 10, 0xFC, 20])
    g = bytes([0xFC, 30, 0xFC, 40, 0xFC, 50, 0xFC, 60])
    b = bytes([0xFC, 70]) * 3
    for counts in ([4, 0, 0, 8, 0, 0, 6, 0, 0], [2] * 9, [0] * 9):
        data = _psd_rle([r, g, b], counts, h, w, "RGB")
        assert same_outcome(data) == "", counts


def test_a_psd_mode_pillow_lacks_is_no_psd():
    """PsdImageFile._open looks (mode, bits) up in MODES: 16-bit RGB, and
    any other pair it lacks, is a KeyError that Image.open passes on, so
    no plugin takes the file: format_of gives None and read_image raises
    ValueError, as Image.open raises UnidentifiedImageError."""
    planes = np.zeros((3, 2, 2), np.uint8)
    for mode, bits in ((3, 16), (1, 16), (3, 32), (4, 16), (2, 1), (5, 8),
                       (9, 16), (0, 2)):
        data = iw.encode_psd(planes, "RGB", bits=bits, psd_mode=mode)
        with pytest.raises(Image.UnidentifiedImageError):
            Image.open(io.BytesIO(data))
        assert image_io.format_of(data) is None, (mode, bits)
        with pytest.raises(ValueError):
            image_io.read_image(data)


def _avif_open(data: bytes):
    """Image.open's outcome: "AVIF", None (UnidentifiedImageError) or
    "raise"."""
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


# of the 300 seeded edits of a file, those that make an AV1 frame
# smaller than its ispe (test_avif_edits_give_image_opens_outcome): the
# most any file gives at seeds 90 and 91
ISPE_EDITS = 4


def _avif_files():
    pytest.importorskip("PIL.AvifImagePlugin")
    from PIL import features
    if not features.check("avif"):
        pytest.skip("Pillow without AVIF")
    rng = np.random.RandomState(88)
    files = [(ic.CORPUS / "refused_avif.avif").read_bytes()]
    for mode, kw in (("RGBA", {}), ("L", {}), ("RGB", {"subsampling": "4:4:4"})):
        img = rng.randint(0, 256, (9, 13, 4), dtype=np.uint8)
        files.append(ic._pil(img, "AVIF", mode, **kw))
    return files


@pytest.mark.parametrize("seed", [90, 91])
def test_avif_edits_give_image_opens_outcome(seed):
    """Seeded byte edits (one to three bytes, cuts, bytes put in or taken
    out) of AVIF files (the corpus's and Pillow's RGBA, L and 4:4:4
    ones): where libavif's parse fails, Image.open passes the file on
    (format_of None) or raises (format_of and read_image a ValueError);
    where it opens, the port names it AVIF and read_image gives Pillow's
    decode (its pixels, or a NotImplementedError naming a mode the port
    does not read) or, where Pillow's load fails, a ValueError. The
    known differences of tests/test_torch_image_avif.py: an AV1 frame
    smaller than its item's ispe, where libavif reads past dav1d's
    picture and the port raises NotImplementedError naming it (edits of
    ispe or of the sequence header's size make them: at most ISPE_EDITS
    of the 300 edits a file), and AV1 data dav1d reads otherwise, at
    most 2 of the 300 edits a file."""
    files = _avif_files()
    rng = np.random.RandomState(seed)
    for f in files:
        known = ispe = 0
        for _ in range(300):
            e = bytearray(f)
            for _ in range(rng.randint(1, 4)):
                at = rng.randint(0, len(e))
                e[at] = rng.randint(0, 256) if rng.rand() < 0.5 else \
                    e[at] ^ (1 << rng.randint(8))
            if rng.rand() < 0.1:
                e = e[:rng.randint(12, len(e))]
            if rng.rand() < 0.1:
                at = rng.randint(12, len(e))
                e = e[:at] + bytes([rng.randint(256)]) * rng.randint(1, 5) \
                    + e[at:]
            data = bytes(e)
            want = _avif_open(data)
            got = _format_of(data)
            if want == "AVIF":
                assert got == "AVIF", (seed, data.hex())
                outcome = _avif_load_outcome(data)
                known += outcome == "differ"
                ispe += outcome == "ispe"
            elif want == "raise" or got == "raise":
                assert got == want, (seed, want, got, data.hex())
                with pytest.raises(ValueError):
                    image_io.read_image(data)
            else:
                assert got == want, (seed, want, got, data.hex())
        assert known <= 2, (seed, known)
        assert ispe <= ISPE_EDITS, (seed, ispe)


def _avif_load_outcome(data: bytes) -> str:
    """read_image against Pillow's load of a file Image.open opens:
    "same", "ispe" (Pillow decodes a frame smaller than its ispe, the
    port raises the NotImplementedError naming it) or "differ"."""
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    except Exception:  # noqa: BLE001 - Pillow's load fails
        want = None
    try:
        got = image_io.read_image(data)
    except NotImplementedError as e:
        if want is not None and "smaller than the image's ispe" in str(e):
            return "ispe"
        return "same" if want is not None else "differ"
    except ValueError:
        return "same" if want is None else "differ"
    return "same" if want is not None and np.array_equal(got, want) \
        else "differ"


def test_every_single_byte_avif_edit_gives_image_opens_outcome():
    """Every byte of the corpus's AVIF set to each of 16 values, and the
    file cut at every length: Image.open's outcome class each time."""
    _avif_files()
    data = (ic.CORPUS / "refused_avif.avif").read_bytes()
    for at in range(len(data)):
        for v in (0, 1, 2, 3, 7, 8, 16, 64, 127, 128, 129, 200, 255,
                  data[at] ^ 1, data[at] ^ 0x40, (data[at] + 1) & 255):
            e = bytearray(data)
            e[at] = v
            assert _format_of(bytes(e)) == _avif_open(bytes(e)), (at, v)
    for n in range(len(data)):
        assert _format_of(data[:n]) == _avif_open(data[:n]), n
