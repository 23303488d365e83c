"""The port's readers of Pillow's small lossless plugins (PPM/PGM/PBM/PFM,
TGA, QOI, ICO, CUR, DIB, PCX, DCX, SGI and Sun raster: csrc/
image_plugins.cpp, and csrc/image_decode.cpp's BMP decoder for the DIB
payloads, through data/native_image.py) against Pillow 12.1.0: every
mode of the committed corpus at every size decodes to its digest (the
digests chip_smoke.py's phase 9a holds the card's host to); seeded files
of every mode, and cut and byte-edited copies of them, give Pillow's
live outcome (its pixels, or an error where Pillow raises); random RLE
packet streams, QOI op streams and plain Netpbm tokens give Pillow's
outcome; files opened from a path read as Pillow reads a path; the JAX
package's CocoDataset reads a COCO directory of these formats as the
port's does; a header past Pillow's decompression-bomb limit raises
before any output is allocated; decoder threads give one thread's
arrays."""

import hashlib
import io
import json
import random
import re
import struct
import sys
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest

from maskrcnn_tpu_torch.data import image_io, native_image

TESTS = Path(__file__).resolve().parent
sys.path.insert(0, str(TESTS))

import image_corpus as ic  # noqa: E402
import image_writers as iw  # noqa: E402

pytest.importorskip("PIL")

INDEX = json.loads(ic.INDEX.read_text())
EXTS = "ppm|pgm|pbm|pfm|tga|qoi|ico|cur|dib|pcx|dcx|sgi|ras"
SIZE = re.compile(rf"_(\d+)x(\d+)\.({EXTS})$")
MODES = {}
for _name in INDEX["files"]:
    if SIZE.search(_name):
        MODES.setdefault(SIZE.sub(r".\3", _name), []).append(_name)


def digest(img: np.ndarray) -> str:
    return hashlib.sha256(img.tobytes()).hexdigest()


def pillow(source):
    """Pillow's `np.asarray(Image.open(f).convert("RGB"))` of bytes or a
    path, or None where it raises."""
    from PIL import Image
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            f = io.BytesIO(source) if isinstance(source, bytes) else source
            return np.asarray(Image.open(f).convert("RGB"))
    except Exception:  # noqa: BLE001 - any error is Pillow's outcome
        return None


def pillow_format(data: bytes):
    from PIL import Image
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return Image.open(io.BytesIO(data)).format
    except Exception:  # noqa: BLE001
        return None


def assert_pillows_outcome(source, what: str) -> None:
    """read_image gives Pillow's pixels, raises NotImplementedError naming
    the format Pillow opened it as where the port does not read that
    format, or ValueError where Pillow raises."""
    want = pillow(source)
    try:
        got = image_io.read_image(source)
    except NotImplementedError as e:
        data = source if isinstance(source, bytes) else source.read_bytes()
        fmt = pillow_format(data)
        assert fmt and fmt not in image_io.READ and fmt in str(e), (what, e)
        return
    except ValueError as e:
        assert want is None, (what, e)
        return
    assert want is not None, what
    assert got.shape == want.shape and np.array_equal(got, want), (
        f"{what}: {int((got != want).any(-1).sum())} pixels differ")


@pytest.mark.parametrize("mode", sorted(MODES))
def test_corpus_mode_at_every_size_equals_its_digest(mode):
    """Each mode's files at 1x1, 5x3, 37x53 and 16x24 decode natively,
    from their paths, to their Pillow digests, without Pillow."""
    names = MODES[mode]
    sizes = {tuple(map(int, SIZE.search(n).groups()[:2])) for n in names}
    assert sizes == set(ic.SIZES), sizes
    for name in names:
        img = image_io.read_image(ic.CORPUS / name)
        entry = INDEX["files"][name]
        assert list(img.shape) == entry["shape"] + [3], name
        assert digest(img) == entry["sha256"], name


def test_corpus_covers_the_plugins_and_their_refusals():
    """The corpus holds every format read here in modes of each (Netpbm's
    seven magics and Pillow's own four, TGA's types 1-3 and 9-11, both
    QOI channel counts, ICO's PNG and DIB payloads, CUR, DIB, PCX's four
    layouts, DCX, SGI raw and RLE of 1 and 2 bytes, Sun raster's types
    0-5), and a refused file of the formats Pillow reads that the port
    does not, each NotImplementedError naming its format or mode (EPS,
    and AVIF's 10-bit, 12-bit, superres, grid, film-grain and IntraBC
    files; ICNS, DDS, BLP, IM, SPIDER, MSP, XBM, XPM, FITS and AVIF, read
    since, to their digests; the PSD header and the 1x1 Sun raster
    Pillow's GBR plugin takes, read since, among the files Pillow fails
    on)."""
    exts = {m.rsplit(".", 1)[1] for m in MODES}
    assert exts == set(EXTS.split("|"))
    assert len(MODES) >= 86
    refused = {n: w for n, w in INDEX["refused"].items()
               if not n.startswith(("refused_bmp", "refused_tiff",
                                    "refused_jpeg", "refused_png",
                                    "refused_jp2_"))}
    assert set(refused.values()) == {"EPS", "10-bit", "12-bit", "superres",
                                     "grid", "film grain", "IntraBC"}
    assert {"refused_icns.icns", "refused_dds.dds", "refused_blp.blp",
            "refused_im.im", "refused_spi.spi", "refused_msp.msp",
            "refused_xbm.xbm", "refused_xpm.xpm", "refused_fits.fits",
            "refused_avif.avif"} <= set(INDEX["files"])
    assert {"refused_psd.psd", "refused_sun_gbr_1x1.ras"} \
        <= set(INDEX["errors"])
    for name, word in refused.items():
        with pytest.raises(NotImplementedError, match=word):
            image_io.read_image(ic.CORPUS / name)


@pytest.mark.parametrize("seed,h,w", [(30, 3, 7), (31, 2, 9), (32, 11, 4)])
def test_seeded_files_of_every_mode_equal_pillow(seed, h, w):
    """The corpus's modes at sizes of their own, from other seeds."""
    rng = np.random.RandomState(seed)
    for (ext, mode), data in ic.plugin_modes(rng, h, w).items():
        want = pillow(data)
        assert want is not None, (ext, mode)
        got = image_io.read_image(data)
        assert np.array_equal(got, want), (ext, mode)


def _edits(data: bytes, r: random.Random, n: int = 6):
    for _ in range(3):
        yield data[:r.randrange(len(data))]
    for _ in range(n):
        e = bytearray(data)
        i = (r.randrange(min(len(data), 80)) if r.random() < 0.6
             else r.randrange(len(data)))
        e[i] = r.getrandbits(8)
        yield bytes(e)


@pytest.mark.parametrize("ext", ["pbm", "pgm", "ppm", "pfm", "tga", "qoi",
                                 "ico", "cur", "dib", "pcx", "dcx", "sgi",
                                 "ras"])
def test_cut_and_edited_files_give_pillows_outcome(ext):
    """Every mode's seeded file at two sizes, cut short three times and
    byte-edited six (the header's first 80 bytes more often)."""
    r = random.Random(ext)
    for seed, (h, w) in enumerate(((5, 3), (2, 9))):
        modes = ic.plugin_modes(np.random.RandomState(40 + seed), h, w)
        for (e, mode), data in modes.items():
            if e != ext:
                continue
            for k, edited in enumerate(_edits(data, r)):
                assert_pillows_outcome(edited, f"{ext} {mode} {h}x{w} {k}")


def _streams(seed: int, n: int = 150):
    """Random packet streams behind valid headers: TGA RLE (types 9-11),
    PCX of each layout (with and without a VGA palette's 769 bytes),
    Sun RLE of every depth, QOI of 3 and 4 channels, SGI RLE with
    random offset and length tables, and plain Netpbm tokens (comments,
    signs, underscores, values past maxval, long tokens)."""
    r = random.Random(seed)
    for _ in range(n):
        w, h = r.randint(1, 9), r.randint(1, 5)
        body = bytes(r.choice([0, 0x80, 0x81, 0xC1, 0xFF, r.getrandbits(8),
                               r.getrandbits(8)])
                     for _ in range(r.randint(0, 60)))
        t = r.choice([9, 10, 11])
        depth = {9: 8, 10: r.choice([16, 24, 32]), 11: r.choice([8, 16])}[t]
        yield "tga", (bytes([0, 0, t]) + bytes(5)
                      + struct.pack("<HHHH", 0, 0, w, h)
                      + bytes([depth, r.choice([0, 0x20, 0x10, 0x30])]) + body)
        bits, planes = r.choice([(1, 1), (1, 2), (1, 4), (8, 1), (8, 3)])
        head = bytearray(128)
        struct.pack_into("<BBBBHHHH", head, 0, 10, 5, 1, bits, 0, 0, w - 1,
                         h - 1)
        head[65] = planes
        struct.pack_into("<H", head, 66, r.choice([0, 1, 2, 3, 4, 9]))
        yield "pcx", bytes(head) + body + bytes(r.choice([0, 769]))
        yield "sun", struct.pack(">8I", 0x59A66A95, w, h,
                                 r.choice([1, 4, 8, 24, 32]), len(body), 2,
                                 0, 0) + body
        yield "qoi", (b"qoif" + struct.pack(">IIBB", w, h, r.choice([3, 4, 0]),
                                            0) + body)
        z, bpc = r.choice([1, 3, 4]), r.choice([1, 2])
        sgi = bytearray(512)
        struct.pack_into(">hBBHHHH", sgi, 0, 474, 1, bpc, 3 if z > 1 else 2,
                         w, h, z)
        tab = ([512 + 8 * h * z + r.randint(0, max(len(body) - 1, 0))
                for _ in range(h * z)] + [r.randint(0, 20)
                                          for _ in range(h * z)])
        if r.random() < 0.2:
            tab[r.randrange(len(tab))] = r.getrandbits(32)
        yield "sgi", bytes(sgi) + struct.pack(f">{2 * h * z}I", *tab) + body
        tokens = [r.choice(["1", "0", "255", "7", "+3", "1_0", "-1", "#c\n",
                            "x", "  ", "\t", "65536", "9" * 11, "#", "\r"])
                  for _ in range(r.randint(0, 30))]
        yield "ppm", (r.choice([b"P1", b"P2", b"P3"])
                      + b" %d %d %d\n" % (w, h, r.choice([1, 255, 1000]))
                      + " ".join(tokens).encode())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_packet_streams_give_pillows_outcome(seed):
    """TgaRleDecode.c's runs (never across a row) and literals (across
    rows), PcxDecode.c's runs past a row, SunRleDecode.c's runs across
    rows, SgiRleDecode.c's bounds checks and short rows, QOI's ops and
    PpmPlainDecoder's tokens, each as Pillow gives them."""
    for kind, data in _streams(seed):
        assert_pillows_outcome(data, kind)


def test_files_opened_from_a_path_read_as_pillow_reads_a_path(tmp_path):
    """Pillow memory-maps some raw tiles it opens from a path (PPM, SGI,
    TGA) and seeks an 8-bit PCX's palette from the file's end, which
    raises before a short file's start: read_image given the path gives
    Pillow's outcome given the path."""
    r = random.Random(7)
    modes = ic.plugin_modes(np.random.RandomState(50), 4, 6)
    head = bytearray(128)
    struct.pack_into("<BBBBHHHH", head, 0, 10, 5, 1, 8, 0, 0, 5, 3)
    head[65] = 1
    files = list(modes.items()) + [(("pcx", "short"), bytes(head) + bytes(
        range(24)))]
    for k, ((ext, mode), data) in enumerate(files):
        for j, edited in enumerate([data, *_edits(data, r, 2)]):
            path = tmp_path / f"{k}_{j}.{ext}"
            path.write_bytes(edited)
            assert_pillows_outcome(path, f"{ext} {mode} {j}")


def test_sizes_past_pillows_limit_raise_before_decoding():
    """A PPM, a QOI and a Sun raster whose headers claim more pixels than
    Pillow's decompression-bomb limit raise ValueError naming the size
    (Pillow raises DecompressionBombError), the native size call's check
    too."""
    n = 40000
    huge = [b"P6\n%d %d\n255\n" % (n, n), b"qoif" + struct.pack(
        ">IIBB", n, n, 3, 0), struct.pack(">8I", 0x59A66A95, n, n, 8, 0, 1, 0,
                                          0)]
    for data in huge:
        with pytest.raises(ValueError, match="image size"):
            image_io.read_image(data + bytes(64))
        with pytest.raises(ValueError, match="image size"):
            getattr(native_image, "decode_" + {b"P6": "ppm", b"qo": "qoi",
                                               b"Y\xa6": "sun"}[data[:2]])(
                data + bytes(64))


def _coco_dir(root: Path) -> Path:
    """A COCO directory of one file in each format read here: a 96x72 crop
    of a corpus scene written as P6, plain P3, TGA RLE, QOI, PCX, DCX,
    SGI RLE, Sun RLE, ICO and CUR (DIB payloads) and DIB."""
    scene = image_io.read_image(ic.CORPUS / list(INDEX["scenes"])[0])
    img = np.ascontiguousarray(scene[200:272, 300:396])
    h, w = img.shape[:2]
    rng = np.random.RandomState(3)
    bmp = iw.encode_bmp(w, h, 24, iw.bmp_pixels(img, 24)[::-1].tobytes())
    files = [("ppm", iw.encode_ppm(img, b"P6")),
             ("ppm", iw.encode_ppm(img, b"P3", rng=rng)),
             ("tga", iw.encode_tga(img, 10, 24, rng=rng)),
             ("qoi", iw.encode_qoi(img)),
             ("pcx", iw.encode_pcx(img, 8, 3, rng=rng)),
             ("dcx", iw.encode_dcx([iw.encode_pcx(img, 8, 3)])),
             ("sgi", iw.encode_sgi(img, 1, True, rng=rng)),
             ("ras", iw.encode_sun(img, 24, 2, rng=rng)),
             ("ico", iw.encode_ico([(iw.ico_dib(img, 24), w, h, 24, 0)])),
             ("cur", iw.encode_ico([(iw.ico_dib(img, 24), w, h, 24, 0)],
                                   kind=2)),
             ("dib", bmp[14:])]
    (root / "val2014").mkdir(parents=True)
    (root / "annotations").mkdir()
    images, anns = [], []
    for i, (ext, data) in enumerate(files, 1):
        file_name = f"COCO_val2014_{i:012d}.{ext}"
        (root / "val2014" / file_name).write_bytes(data)
        images.append({"id": i, "height": h, "width": w,
                       "file_name": file_name})
        anns.append({"id": i, "image_id": i, "category_id": 1, "iscrowd": 0,
                     "bbox": [4.0 * i, 6.0, 30.0, 20.0], "area": 600.0,
                     "segmentation": [[4.0 * i, 6.0, 4.0 * i + 30, 6.0,
                                       4.0 * i + 30, 26.0, 4.0 * i, 26.0]]})
    with open(root / "annotations" / "instances_minival2014.json", "w") as f:
        json.dump({"images": images, "annotations": anns,
                   "categories": INDEX["categories"]}, f)
    return root


def test_jax_coco_dataset_reads_the_plugins_as_the_port(tmp_path):
    """maskrcnn_tpu/data/coco.py's load_image and load (Pillow) against
    the port's (its native readers) on one file of each format read
    here, each the same pixels."""
    from maskrcnn_tpu.config import TinyConfig
    from maskrcnn_tpu.data import coco as jax_coco
    from maskrcnn_tpu_torch import TinyConfig as PortTinyConfig
    from maskrcnn_tpu_torch.data import coco as port_coco
    root = str(_coco_dir(tmp_path / "coco"))
    ref = jax_coco.CocoDataset(root, "minival", 2014, TinyConfig())
    port = port_coco.CocoDataset(root, "minival", 2014, PortTinyConfig())
    assert port.ids == ref.ids and len(port.ids) == 11
    first = None
    for i, image_id in enumerate(port.ids):
        img = port.load_image(image_id)
        np.testing.assert_array_equal(img, ref.load_image(image_id))
        first = img if first is None else first
        np.testing.assert_array_equal(img, first)
        for a, b in zip(port.load(i), ref.load(i)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_scene_writers_give_the_scenes_pixels():
    """The numpy writers chip_smoke.py's sweep of these formats runs on
    the card (image_decode_bench_torch.scene_files: P6, TGA RLE, QOI in
    runs and RGB ops, PCX, SGI RLE, Sun RLE) hold a scene's pixels, as
    Pillow reads them."""
    from tools import image_decode_bench_torch as bench
    jpeg = image_io.read_image(ic.CORPUS / list(INDEX["scenes"])[0])
    for fmt in bench.PLUGIN_SCENES:
        (name, data), = bench.scene_files(fmt, 1)
        assert np.array_equal(pillow(data), jpeg), name
        assert np.array_equal(image_io.read_image(data), jpeg), name


def test_four_threads_decode_like_one():
    """Decodes of every format in four threads give one thread's arrays
    (each decode a ctypes call outside the GIL)."""
    modes = ic.plugin_modes(np.random.RandomState(60), 37, 53)
    files = list(modes.values()) * 3
    one = [image_io.read_image(d) for d in files]
    with ThreadPoolExecutor(4) as pool:
        four = list(pool.map(image_io.read_image, files))
    for a, b in zip(one, four):
        assert np.array_equal(a, b)


def test_raw_rows_need_no_padding_after_the_last():
    """Pillow's raw decoder reads a row's padding only before the next
    row: a BMP, a DIB and a Sun raster cut inside their last row's
    padding still decode (the BMP route once asked for the padding), one
    byte more cut raises."""
    img = ic.seeded_image(np.random.RandomState(70), 4, 3)
    bmp = iw.encode_bmp(3, 4, 24, iw.bmp_pixels(img, 24)[::-1].tobytes())
    sun = iw.encode_sun(img, 24)
    for data, pad in ((bmp, 3), (bmp[14:], 3), (sun, 1)):
        for cut in range(pad + 2):
            assert_pillows_outcome(data[:len(data) - cut], f"cut {cut}")
        assert pillow(data[:len(data) - pad]) is not None
        assert pillow(data[:len(data) - pad - 1]) is None
