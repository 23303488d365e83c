"""The port's JPEG 2000 reader (csrc/jpeg2000_decode.cpp through
data/native_image.decode_jpeg2000, the mode from data/image_probe.py)
against Pillow 12.1.0 over OpenJPEG 2.5.4: the corpus covers every layout
(tests/image_corpus.jpeg2000_modes; each file's digest is held by
tests/test_torch_image_native.py); seeded files of every layout at sizes
of their own, and cut and byte-edited copies of Pillow's and OpenJPEG's
files, give Pillow's live outcome (its pixels, or a ValueError where it
raises); the MQ coder's states are ISO 15444-1's Table C.2; Pillow's
YCbCr -> RGB for sYCC files holds over every (Cb, Cr); an HT code-block
style over Part-1 data raises as Pillow does (HTJ2K itself:
tests/test_torch_image_htj2k.py); Part-2 multi-component transforms (MCT,
MCC and MCO markers: OpenJPEG's own, of every element type, moved into
tile-part headers, byte-edited) give Pillow's outcome; the
scenes as JPEG 2000 (tests/data/jpeg2000_scenes, which chip_smoke.py's
phase 9d reads) hold their JPEG files' pixels."""

import ctypes
import hashlib
import io
import json
import random
import re
import struct
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest

from maskrcnn_tpu_torch.data import image_io, native_image

TESTS = Path(__file__).resolve().parent
sys.path.insert(0, str(TESTS))

import image_corpus as ic  # noqa: E402
import image_writers as iw  # noqa: E402

pytest.importorskip("PIL")
jw = ic.jpeg2000_writer()

INDEX = json.loads(ic.INDEX.read_text())
NAME = re.compile(r"^jp2_(.*)_(\d+)x(\d+)\.(jp2|j2k)$")


def pillow(data: bytes):
    """Pillow's `np.asarray(Image.open(f).convert("RGB"))`, or None where
    it raises."""
    from PIL import Image
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    except Exception:  # noqa: BLE001 - any error is Pillow's outcome
        return None


def outcome(data: bytes):
    """The port's outcome: its pixels, "error" for a ValueError, or the
    NotImplementedError's text."""
    try:
        return image_io.read_image(data)
    except ValueError:
        return "error"
    except NotImplementedError as e:
        return f"refused: {e}"


def test_corpus_covers_every_layout_at_every_size():
    """46 layouts, each at the corpus's four sizes (but TERMALL at 16x24,
    which OpenJPEG's encoder cannot write there: its output buffer is
    sized by the image), the file Pillow's writer made before the port
    read JPEG 2000, the refused part, named (an HT code-block), and a CAP
    and a CBD marker alone, which OpenJPEG decodes, to their digests; the
    Part-2 files to theirs, and a Part-2 transform OpenJPEG fails on
    among the errors."""
    layouts = {}
    for name in INDEX["files"]:
        m = NAME.match(name)
        if m:
            layouts.setdefault(m.group(1), set()).add(
                (int(m.group(2)), int(m.group(3))))
    assert len(layouts) == 46, sorted(layouts)
    for layout, sizes in layouts.items():
        want = set(ic.SIZES) - ({(16, 24)} if layout == "termall" else set())
        assert sizes == want, layout
    assert "refused_jp2.jp2" in INDEX["files"]
    refused = {n: w for n, w in INDEX["refused"].items()
               if n.startswith("refused_jp2")}
    # (HTJ2K is read: its stub over Part-1 data is one Pillow fails on)
    assert refused == {} and "refused_jp2_htj2k.j2k" in INDEX["errors"]
    assert len([n for n in INDEX["files"] if n.startswith("jp2_part2_")]) \
        == 10
    assert {"refused_jp2_part2_mct.j2k", "refused_jp2_part2_transform.j2k"} \
        <= set(INDEX["errors"])
    assert {"refused_jp2_cap.j2k", "refused_jp2_part2_cbd.j2k"} \
        <= set(INDEX["files"])
    for name, word in refused.items():
        with pytest.raises(NotImplementedError, match=word):
            image_io.read_image(ic.CORPUS / name)


@pytest.mark.parametrize("seed,h,w", [(40, 9, 13), (41, 23, 17),
                                      (42, 2, 30)])
def test_seeded_layouts_equal_pillow(seed, h, w):
    """Every layout of the corpus at a size of its own, from another seed,
    to Pillow's live decode."""
    rng = np.random.RandomState(seed)
    for (layout, ext), data in ic.jpeg2000_modes(rng, h, w).items():
        want = pillow(data)
        assert want is not None, layout
        got = image_io.read_image(data)
        assert got.shape == want.shape and np.array_equal(got, want), layout


def _writer_files(seed: int):
    """Small files of Pillow's writer and of OpenJPEG's encoder in the
    layouts whose headers and packets the edits reach."""
    rng = np.random.RandomState(seed)
    img = ic.seeded_image(rng, 11, 14)
    planes = [img[..., k].astype(np.int32) for k in range(3)]
    files = [(str(kw), ic._pil(img, "JPEG2000", **kw)) for kw in (
        {}, {"no_jp2": True}, {"irreversible": True, "quality_layers": [20, 5]},
        {"tile_size": (8, 8), "num_resolutions": 2},
        {"plt": True, "progression": "RPCL"})]
    files += [
        ("switches", jw.encode(planes, mode=63, layers=(20, 4, 1), mct=True)),
        ("sop eph", jw.encode(planes, sop=True, eph=True, layers=(20, 4, 1),
                              resolutions=3)),
        ("poc", jw.encode(planes, layers=(20, 4, 1), resolutions=3, pocs=[
            (0, 0, 2, 2, 3, "RLCP"), (0, 0, 3, 3, 3, "CPRL")])),
        ("tile-parts", jw.encode(planes, tile=(8, 8), tile_parts="L",
                                 layers=(20, 4, 1), resolutions=2,
                                 progression="PCRL")),
        ("rgn", jw.encode(planes, roi=(0, 6), resolutions=3)),
        ("ppm", jw.packed_headers(jw.encode(
            planes, sop=True, eph=True, layers=(20, 4, 1), resolutions=3),
            "ppm")),
        ("pclr", jw.jp2_file(jw.encode([planes[0] % 7], resolutions=3), 11, 14,
                             1, extra=jw.pclr_box(
                                 [(k, 2 * k, 255 - k) for k in range(7)],
                                 (7, 7, 7)) + jw.cmap_box(3)))]
    return files


def _siz_subsampling(data: bytes):
    """The offsets of the SIZ marker's XRsiz and YRsiz bytes."""
    i = data.find(b"\xff\x4f\xff\x51") + 2
    n = struct.unpack(">H", data[i + 38:i + 40])[0]
    return {i + 40 + 3 * k + d for k in range(n) for d in (1, 2)}


@pytest.mark.parametrize("seed", [0, 1])
def test_cut_and_edited_files_give_pillows_outcome(seed):
    """Cuts of every length class and single-byte edits (headers, packet
    headers, code-block data) give Pillow's outcome: its pixels, or a
    ValueError where it raises (strict mode: a cut stream raises), an
    edit that sets HTJ2K's style bit over Part-1 data too. Edits
    of a component's subsampling (XRsiz, YRsiz) are not drawn: where the
    subsampling leaves a component smaller than Pillow's unpacker
    indexes, Pillow reads past OpenJPEG's tile data (memory it never
    wrote), which no decoder can reproduce; subsampled layouts are held
    to Pillow by the corpus instead."""
    r = random.Random(seed)
    compared = 0
    for name, data in _writer_files(seed):
        cases = [data[:k] for k in sorted({r.randrange(len(data))
                                           for _ in range(12)})]
        skip = _siz_subsampling(data)
        for _ in range(60):
            e = bytearray(data)
            i = (r.randrange(min(len(data), 160)) if r.random() < 0.5
                 else r.randrange(len(data)))
            if i in skip:
                continue
            e[i] = (r.getrandbits(8) if r.random() < 0.5
                    else e[i] ^ (1 << r.randrange(8)))
            cases.append(bytes(e))
        for d in cases:
            want, got = pillow(d), outcome(d)
            assert not (isinstance(got, str) and got.startswith("refused")), \
                (name, got)
            compared += 1
            if want is None:
                assert isinstance(got, str) and got == "error", name
            else:
                assert not isinstance(got, str), (name, got)
                assert np.array_equal(got, want), name
    assert compared > 600


def test_a_cut_stream_raises_as_strict_mode_does():
    """Pillow's JP2 cut by 10 bytes or by half raises in Pillow (OpenJPEG's
    strict mode); so does the port, with a ValueError."""
    rng = np.random.RandomState(3)
    data = ic._pil(ic.seeded_image(rng, 37, 53), "JPEG2000")
    for cut in (data[:-10], data[:len(data) // 2], data[:-1]):
        assert pillow(cut) is None
        with pytest.raises(ValueError):
            image_io.read_image(cut)


# ISO 15444-1 Table C.2: Qe, NMPS, NLPS, SWITCH of the 47 states
TABLE_C2 = [
    (0x5601, 1, 1, 1), (0x3401, 2, 6, 0), (0x1801, 3, 9, 0),
    (0x0AC1, 4, 12, 0), (0x0521, 5, 29, 0), (0x0221, 38, 33, 0),
    (0x5601, 7, 6, 1), (0x5401, 8, 14, 0), (0x4801, 9, 14, 0),
    (0x3801, 10, 14, 0), (0x3001, 11, 17, 0), (0x2401, 12, 18, 0),
    (0x1C01, 13, 20, 0), (0x1601, 29, 21, 0), (0x5601, 15, 14, 1),
    (0x5401, 16, 14, 0), (0x5101, 17, 15, 0), (0x4801, 18, 16, 0),
    (0x3801, 19, 17, 0), (0x3401, 20, 18, 0), (0x3001, 21, 19, 0),
    (0x2801, 22, 19, 0), (0x2401, 23, 20, 0), (0x2201, 24, 21, 0),
    (0x1C01, 25, 22, 0), (0x1801, 26, 23, 0), (0x1601, 27, 24, 0),
    (0x1401, 28, 25, 0), (0x1201, 29, 26, 0), (0x1101, 30, 27, 0),
    (0x0AC1, 31, 28, 0), (0x09C1, 32, 29, 0), (0x08A1, 33, 30, 0),
    (0x0521, 34, 31, 0), (0x0441, 35, 32, 0), (0x02A1, 36, 33, 0),
    (0x0221, 37, 34, 0), (0x0141, 38, 35, 0), (0x0111, 39, 36, 0),
    (0x0085, 40, 37, 0), (0x0049, 41, 38, 0), (0x0025, 42, 39, 0),
    (0x0015, 43, 40, 0), (0x0009, 44, 41, 0), (0x0005, 45, 42, 0),
    (0x0001, 45, 43, 0), (0x5601, 46, 46, 0)]


def test_mq_states_are_table_c2():
    lib = native_image.library()
    qe = (ctypes.c_uint16 * 47)()
    nmps, nlps, sw = ((ctypes.c_uint8 * 47)() for _ in range(3))
    lib.mrt_jpeg2000_mq_table(qe, nmps, nlps, sw)
    got = [(qe[i], nmps[i], nlps[i], sw[i]) for i in range(47)]
    assert got == TABLE_C2


def test_sycc_colours_equal_pillows_ycbcr_conversion():
    """An sYCC JP2 holding every (Cb, Cr) pair under Y values of every
    kind decodes as Pillow's own YCbCr -> RGB does."""
    cb, cr = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    for y in ((cb * 7 + cr * 13) % 256, np.full_like(cb, 128)):
        data = jw.jp2_file(jw.encode([y, cb, cr], resolutions=1,
                                     cblk=(64, 64)), 256, 256, 3, enumcs=18)
        want = pillow(data)
        assert want is not None
        assert np.array_equal(image_io.read_image(data), want)


def test_refused_parts_are_named():
    """HTJ2K's code-block style (0x40) over Part-1 data, which OpenJPEG
    fails on (its HT decoder finds no cleanup segment there), raises a
    ValueError as Pillow does (HT code-blocks themselves are read:
    tests/test_torch_image_htj2k.py); a style byte with HT mixed mode
    (0x80), which OpenJPEG itself refuses, raises a ValueError as Pillow
    does, as do an MCT, MCC or MCO marker too short for OpenJPEG's reader
    and a CBD marker of the wrong length (opj_j2k_read_cbd's check)."""
    rng = np.random.RandomState(4)
    img = ic.seeded_image(rng, 7, 9)
    cs = jw.encode([img[..., k].astype(np.int32) for k in range(3)])
    cod = cs.index(b"\xff\x52")
    ht = bytearray(cs)
    ht[cod + 12] |= 0x40
    assert pillow(bytes(ht)) is None
    with pytest.raises(ValueError):
        image_io.read_image(bytes(ht))
    mixed = bytearray(cs)
    mixed[cod + 12] |= 0xC0
    assert pillow(bytes(mixed)) is None
    with pytest.raises(ValueError):
        image_io.read_image(bytes(mixed))
    for marker in (b"\xff\x74", b"\xff\x75", b"\xff\x77"):
        data = ic._insert_marker(cs, 0xFF52, marker + b"\x00\x05\x00\x00\x00")
        assert pillow(data) is None
        with pytest.raises(ValueError):
            image_io.read_image(data)
    data = ic._insert_marker(cs, 0xFF52, b"\xff\x78\x00\x05\x00\x00\x00")
    assert pillow(data) is None
    with pytest.raises(ValueError):
        image_io.read_image(data)


def test_jpeg2000_scenes_are_whole_and_small_and_their_pixels():
    """The scenes as JPEG 2000 (tests/data/jpeg2000_scenes) are the files
    their index names, hold at most 2 MB in all, decode to their Pillow
    digests, and those written from a scene's decode give its pixels."""
    scenes = json.loads((ic.JPEG2000_SCENES / "index.json").read_text())
    files = {p.name for p in ic.JPEG2000_SCENES.iterdir()} - {"index.json"}
    assert files == set(scenes)
    assert sum((ic.JPEG2000_SCENES / n).stat().st_size
               for n in files) <= 2_000_000
    layouts = set()
    for name, entry in scenes.items():
        img = image_io.read_image(ic.JPEG2000_SCENES / name)
        assert list(img.shape) == entry["shape"] + [3]
        assert hashlib.sha256(img.tobytes()).hexdigest() == entry["sha256"]
        if entry["pixels"] == "same":
            layouts.add(name.rsplit(".", 1)[1])
            assert np.array_equal(img, image_io.read_image(
                ic.CORPUS / entry["source"])), name
    assert layouts == {"jp2", "j2k"}


def test_decoder_threads_give_one_threads_arrays():
    """Decodes on threads (ctypes releases the GIL) give the arrays of one
    thread's decodes."""
    from concurrent.futures import ThreadPoolExecutor
    names = sorted(n for n in INDEX["files"]
                   if n.startswith("jp2_") and "37x53" in n)[:12]
    datas = [(ic.CORPUS / n).read_bytes() for n in names]
    want = [image_io.read_image(d) for d in datas]
    with ThreadPoolExecutor(4) as pool:
        got = list(pool.map(image_io.read_image, datas * 2))
    for k, img in enumerate(got):
        assert np.array_equal(img, want[k % len(datas)])


def test_a_bomb_raises_before_decoding():
    """A SIZ past Pillow's decompression-bomb limit raises ValueError
    from the header (Image.open's check), nothing allocated."""
    rng = np.random.RandomState(5)
    cs = bytearray(jw.encode([ic.seeded_image(rng, 5, 6)[..., 0].astype(
        np.int32)]))
    cs[8:16] = struct.pack(">II", 200_000, 100_000)
    with pytest.raises(ValueError, match="pixels"):
        image_io.read_image(bytes(cs))


def test_decode_loads_no_openjpeg():
    """Decoding JPEG 2000 in a fresh interpreter loads neither Pillow nor
    a libopenjp2, and the decoder library imports no OpenJPEG symbol."""
    import subprocess
    code = ("import sys\nfrom maskrcnn_tpu_torch.data import image_io\n"
            "for f in sys.argv[1:]:\n    image_io.read_image(f)\n"
            "maps = open('/proc/self/maps').read()\n"
            "print('BAD', [m for m in ('openjp2', 'PIL') if m in maps "
            "or m in sys.modules])\n")
    names = [str(ic.CORPUS / n) for n in ("jp2_rgb_37x53.jp2",
                                          "jp2_ppm_37x53.j2k")]
    proc = subprocess.run([sys.executable, "-c", code, *names],
                          cwd=TESTS.parent, capture_output=True, text=True,
                          timeout=120)
    assert "BAD []" in proc.stdout, proc.stdout + proc.stderr
    undefined = subprocess.run(
        ["nm", "-D", "--undefined-only", str(native_image.library_path())],
        capture_output=True, text=True).stdout
    assert undefined and not re.search(r"\bopj_\w*", undefined)


def _same(data: bytes) -> bool:
    """The port's outcome is Pillow's: its pixels, or a ValueError where
    it raises."""
    want, got = pillow(data), outcome(data)
    if want is None:
        return isinstance(got, str) and got == "error"
    return not isinstance(got, str) and np.array_equal(got, want)


def _segments(cs: bytes):
    """(marker, offset, length) of a raw codestream's main header."""
    out, at = [], 2
    while cs[at:at + 2] != b"\xff\x90":
        n = struct.unpack(">H", cs[at + 2:at + 4])[0]
        out.append((struct.unpack(">H", cs[at:at + 2])[0], at, n))
        at += 2 + n
    return out, at


@pytest.mark.parametrize("seed", [50, 51])
def test_part2_transforms_give_pillows_outcome(seed):
    """OpenJPEG's own Part-2 streams (opj_set_MCT: 3 and 4 components,
    reversible and irreversible, DC shifts, tiles) under COD's transform
    byte 0, 1 (the MCO's offsets become the DC level shifts) and 2 (which
    OpenJPEG fails on); their MCT, MCC and MCO segments edited byte by
    byte, moved after SIZ and into the first tile-part's header, and an
    MCO of no stage after them (every shift 0)."""
    rng = np.random.RandomState(seed)
    for case in range(6):
        nc = 3 + case % 2
        h, w = rng.randint(3, 20, 2)
        img = rng.randint(0, 256, (h, w, nc))
        matrix = rng.uniform(-1, 1, (nc, nc)).astype(np.float32)
        shift = rng.randint(-200, 200, nc)
        cs = bytearray(jw.encode([img[..., k].astype(np.int32)
                                  for k in range(nc)],
                                 custom_mct=(matrix, shift),
                                 irreversible=bool(case % 3 == 1),
                                 tile=(8, 8) if case % 3 == 2 else None))
        cod = cs.index(b"\xff\x52")
        for byte in (0, 1, 2):
            cs[cod + 8] = byte
            assert _same(bytes(cs)), (case, byte)
        cs[cod + 8] = case % 2
        cs = bytes(cs)
        segs, sot = _segments(cs)
        part2 = [s for s in segs if s[0] in (0xFF74, 0xFF75, 0xFF77)]
        for _ in range(16):
            _, at, n = part2[rng.randint(len(part2))]
            e = bytearray(cs)
            q = at + 4 + rng.randint(0, max(n - 2, 1))
            e[q] = rng.randint(0, 256) if rng.rand() < 0.7 else \
                e[q] ^ (1 << rng.randint(8))
            assert _same(bytes(e)), (case, q - at)
        moved = b"".join(cs[a:a + 2 + n] for _, a, n in part2)
        rest = b"".join(cs[a:a + 2 + n] for m, a, n in segs
                        if m not in (0xFF74, 0xFF75, 0xFF77))
        siz = cs[segs[0][1]:segs[0][1] + 2 + segs[0][2]]
        body = cs[sot:]
        assert _same(b"\xff\x4f" + siz + moved + rest[len(siz):] + body)
        psot = struct.unpack(">I", body[6:10])[0]
        for extra in (moved, moved + b"\xff\x77\x00\x03\x00"):
            sot_seg = body[:6] + struct.pack(">I", psot + len(extra)) \
                + body[10:12]
            assert _same(b"\xff\x4f" + rest + sot_seg + extra + body[12:])
        assert _same(cs[:sot] + b"\xff\x77\x00\x03\x00" + cs[sot:])


def test_part2_offsets_of_every_element_type_equal_pillow():
    """Offset arrays of 16-bit (read unsigned), int32, float32 and
    float64 elements (truncated; NaN, infinities and what no int32 holds
    give INT32_MIN, as x86's conversion does), a decorrelation array of
    the wrong size, collections OpenJPEG skips (more than one, other than
    array-based, components shuffled, a second part of a segment) or
    fails on (an array not read), an MCO of two stages (skipped) or of a
    collection of other components, records read again."""
    rng = np.random.RandomState(52)
    img = ic.seeded_image(rng, 10, 7)
    cs = jw.encode([img[..., k].astype(np.int32) for k in range(3)], mct=True)
    inf, nan = float("inf"), float("nan")
    cases = []
    for etype, offsets in ((0, [0, 65535, 128]), (1, [-2 ** 31, 2 ** 31 - 1,
                                                      -5]),
                           (2, [nan, inf, -3e9]), (3, [-inf, 2.5e9, -0.9]),
                           (2, [128.7, -128.7, 0.0])):
        cases.append(iw.part2_markers(3, offsets, np.eye(3),
                                      offset_type=etype, matrix_type=etype))
    good = iw.part2_markers(3, [10, 20, 30], np.eye(3))
    cases.append(iw.part2_markers(3, [1, 2, 3], np.eye(4)))  # 16 elements
    cases.append(iw.part2_markers(3, [1, 2, 3, 4]))         # 4 offsets
    mcc = good.index(b"\xff\x75")
    for at, value in ((8, 2), (9, 2), (4, 1), (13, 1), (15, 1), (21, 5),
                      (23, 9), (22, 7)):
        e = bytearray(good)
        e[mcc + at] = value
        cases.append(bytes(e))
    cases.append(good[:-6] + b"\xff\x77\x00\x05\x02\x01\x01")
    cases.append(good + good)
    cases.append(good.replace(b"\xff\x77\x00\x04\x01\x01",
                              b"\xff\x77\x00\x04\x01\x07"))
    for markers in cases:
        assert _same(iw.with_main_header_markers(cs, markers)), markers.hex()
