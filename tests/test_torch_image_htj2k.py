"""HTJ2K (ISO 15444-15: JPEG 2000's High-Throughput block coder) through
the port's JPEG 2000 reader (csrc/jpeg2000_ht.cpp under
csrc/jpeg2000_decode.cpp's tiers) against Pillow 12.1.0 over OpenJPEG
2.5.4: the VLC tables read off Pillow's libopenjp2 (csrc/htj2k_tables.h)
and their prefix-code structure; every HT layout of the corpus at every
size (tests/image_corpus.HTJ2K_LAYOUTS, raw codestreams and JPH files)
against Pillow's live outcome; the test writer's lossless files
(tests/htj2k_writer.py) decoding to the images they were written from;
cut and byte-edited HT files, malformed code-blocks of each check
OpenJPEG's ht_dec.c makes, its MEL reader's fault that depends on where
the block's bytes lie, and OpenJPEG's tier-2 segment rules, each giving
Pillow's outcome (its pixels, or a ValueError where it raises); the
scenes as HTJ2K (tests/data/htj2k_scenes, which chip_smoke.py's phase 9d
reads); decodes on several threads; the JAX package's CocoDataset on HT
files against the port's."""

import hashlib
import io
import json
import random
import struct
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest

from maskrcnn_tpu_torch.data import image_io

TESTS = Path(__file__).resolve().parent
sys.path.insert(0, str(TESTS))

import htj2k_writer as hw  # noqa: E402
import image_corpus as ic  # noqa: E402

INDEX = json.loads(ic.INDEX.read_text())


def pillow(data: bytes):
    """Pillow's `np.asarray(Image.open(f).convert("RGB"))`, or None where
    it raises."""
    Image = pytest.importorskip("PIL.Image")
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    except Exception:  # noqa: BLE001 - any error is Pillow's outcome
        return None


def port(data: bytes):
    """The port's pixels, or None for a ValueError."""
    try:
        return image_io.read_image(data)
    except ValueError:
        return None


def same(data: bytes) -> bool:
    """The port's outcome is Pillow's."""
    want, got = pillow(data), port(data)
    if want is None or got is None:
        return want is None and got is None
    return np.array_equal(want, got)


def test_vlc_tables_are_prefix_codes():
    """Both tables of csrc/htj2k_tables.h: 1,024 entries of 8 contexts,
    each context a prefix code over the stream's next 7 bits (codeword
    lengths 1-7, every index decoding as its codeword's own entry), e_k
    within rho and e_1 within e_k, no insignificant quad in context 0;
    and a codeword for every (context, rho, u_off, exponent pattern) an
    encoder needs."""
    for table in hw.vlc_tables():
        assert table.shape == (1024,)
        length = table & 7
        assert ((length >= 1) & (length <= 7)).all()
        idx = np.arange(1024)
        assert (table == table[(idx & ~127) | (idx & ((1 << length) - 1))]
                ).all()
        rho, e_1, e_k = ((table >> 4) & 15, (table >> 8) & 15,
                         (table >> 12) & 15)
        assert not (e_k & ~rho).any() and not (e_1 & ~e_k).any()
        assert (rho[:128] != 0).all()
        assert not (e_k[((table >> 3) & 1) == 0]).any()
    for initial in (True, False):
        for c_q in range(8):
            for rho in range(16):
                if rho == 0 and c_q == 0:
                    continue
                hw._codeword(initial, c_q, rho, 0, 0)
                for emb in range(1, 16):
                    if rho and not emb & ~rho:
                        hw._codeword(initial, c_q, rho, 1, emb)


def test_vlc_tables_equal_the_library():
    """csrc/htj2k_tables.h is what `python tests/image_corpus.py
    --htj2k-tables` reads off Pillow's bundled libopenjp2 2.5.4."""
    pytest.importorskip("PIL")
    assert ic.HTJ2K_TABLES.read_text() == ic.htj2k_tables()


def test_corpus_covers_every_ht_layout_at_every_size():
    """Every layout of HTJ2K_LAYOUTS at the corpus's four sizes as a raw
    codestream, those of HTJ2K_JPH also as JPH, each with Pillow's outcome
    in the index (a digest, or its error: the standard's refinement layer,
    which OpenJPEG misreads, fails at 37x53), and the generator would
    write the same bytes again."""
    names = set(INDEX["files"]) | set(INDEX["errors"])
    want = {f"htj2k_{layout}_{h}x{w}.{ext}" for h, w in ic.SIZES
            for layout in ic.HTJ2K_LAYOUTS
            for ext in (("j2c", "jph") if layout in ic.HTJ2K_JPH
                        else ("j2c",))}
    assert want == {n for n in names if n.startswith("htj2k_")}
    assert "htj2k_rgb_refinement_layer_37x53.j2c" in INDEX["errors"]
    rng = np.random.RandomState(24)
    for (layout, ext), data in ic.htj2k_modes(rng, *ic.SIZES[0]).items():
        name = f"htj2k_{layout}_{ic.SIZES[0][0]}x{ic.SIZES[0][1]}.{ext}"
        assert (ic.CORPUS / name).read_bytes() == data, name


@pytest.mark.parametrize("layout", sorted(ic.HTJ2K_LAYOUTS))
def test_ht_corpus_layout_equals_pillow(layout):
    """One layout at every size, raw and JPH: the port's outcome is
    Pillow's live one and the index's (its digest, or an error)."""
    for h, w in ic.SIZES:
        for ext in ("j2c", "jph"):
            name = f"htj2k_{layout}_{h}x{w}.{ext}"
            if not (ic.CORPUS / name).exists():
                continue
            data = (ic.CORPUS / name).read_bytes()
            want, got = pillow(data), port(data)
            if name in INDEX["errors"]:
                assert want is None and got is None, name
                continue
            entry = INDEX["files"][name]
            assert got is not None and np.array_equal(got, want), name
            assert list(got.shape) == entry["shape"] + [3]
            assert hashlib.sha256(got.tobytes()).hexdigest() == \
                entry["sha256"], name


# the writer's layouts that decode to their images: reversible, and every
# refinement pass where OpenJPEG reads it
LOSSLESS = {
    "cleanup": {}, "refined": dict(refine="lossless"),
    "vsc": dict(refine="lossless", style=hw.VSC),
    "cblk16": dict(cblk=(16, 16), refine="lossless"),
    "cblk128x16": dict(cblk=(128, 16), levels=2),
    "layers": dict(layers=3, layer_of="spread", refine="lossless"),
    "rpcl_precincts": dict(progression="RPCL", precincts=[(3, 3)] * 4,
                           levels=3, layers=2, layer_of="spread",
                           refine="lossless"),
    "tiles": dict(tile=(16, 24), levels=2, refine="lossless"),
    "termall_refinement_layer": dict(layers=2, layer_of="refinement",
                                     refine="lossless", style=hw.TERMALL),
    "opj_refinement_layer": dict(layers=2, layer_of="refinement",
                                 refine="lossless", opj_segments=True),
    "sop_eph_rlcp": dict(sop=True, eph=True, progression="RLCP", layers=2,
                         layer_of="spread")}


@pytest.mark.parametrize("seed", [0, 1])
def test_writer_lossless_layouts_give_their_images(seed):
    """The writer's lossless files (RGB and gray, raw and JPH) decode to
    the images they were written from under Pillow, and so under the
    port; noise images refine every block they can."""
    rng = np.random.RandomState(seed)
    refined = 0
    for name, kw in LOSSLESS.items():
        h, w = (int(rng.randint(1, 40)), int(rng.randint(1, 60)))
        img = (rng.randint(0, 256, (h, w, 3)) if seed else
               ic.seeded_image(rng, h, w)).astype(np.uint8)
        for planes in (img, img[..., 0]):
            cs = hw.encode(planes, **kw)
            want = img if planes.ndim == 3 else np.repeat(planes[..., None],
                                                          3, 2)
            for data in (cs, hw.jph_file(cs, h, w, 1 if planes.ndim == 2
                                         else 3)):
                assert np.array_equal(pillow(data), want), (name, h, w)
                assert np.array_equal(image_io.read_image(data), want), name
        refined += kw.get("refine") is not None
    assert refined >= 6


def _edit_files(seed: int):
    rng = np.random.RandomState(seed)
    files = []
    for kw in (dict(refine="lossless"), dict(refine="all", layers=2,
                                             layer_of="spread", cblk=(16, 16)),
               dict(refine="all", style=hw.VSC, levels=1),
               dict(irreversible=True, refine="all", step_exponent=2),
               dict(sop=True, eph=True, tile=(8, 8), levels=2),
               dict(layers=2, layer_of="refinement", refine="all")):
        h, w = int(rng.randint(8, 30)), int(rng.randint(8, 30))
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        cs = hw.encode(img, **kw)
        files += [cs, hw.jph_file(cs, h, w, 3)]
    return files


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cut_and_edited_ht_files_give_pillows_outcome(seed):
    """Cuts and single-byte edits of HT files (headers, packet headers,
    code-block bytes: MEL, VLC, MagSgn, SigProp, MagRef, Scup) give
    Pillow's outcome: its pixels, or a ValueError where it raises."""
    r = random.Random(seed)
    errors = decoded = 0
    for data in _edit_files(seed):
        cases = [data[:k] for k in sorted({r.randrange(len(data))
                                           for _ in range(6)})]
        for _ in range(50):
            e = bytearray(data)
            i = r.randrange(len(data))
            e[i] = (r.getrandbits(8) if r.random() < 0.5
                    else e[i] ^ (1 << r.randrange(8)))
            cases.append(bytes(e))
        for d in cases:
            want, got = pillow(d), port(d)
            if want is None:
                assert got is None
                errors += 1
            else:
                assert got is not None and np.array_equal(got, want)
                decoded += 1
    assert errors > 100 and decoded > 200


def _one_block(img: np.ndarray, **kw):
    """A one-component codestream of one code-block (no transform levels)
    and that block's segments: (codestream, cleanup offset, cleanup,
    refinement)."""
    cs = hw.encode(img, levels=0, **kw)
    coef = img.astype(np.int64) - 128
    blk = hw.encode_block(coef, kw.get("refine"), False)
    seg = b"".join(blk[0])
    start = len(cs) - 2 - len(seg)
    assert cs[start:len(cs) - 2] == seg
    return cs, start, blk[0][0], b"".join(blk[0][1:])


@pytest.mark.parametrize("refine", [None, "all"])
def test_mel_stuffing_fault_follows_where_the_bytes_lie(refine):
    """OpenJPEG's MEL reader checks for a byte above 0x8F after 0xFF only
    in its first bytes up to a 4-byte address boundary: a block of one
    chunk lies in the tile's data (where its offset puts it), one of two
    (cleanup and refinement) in a buffer of its own. Edits of those bytes
    give Pillow's outcome, an error in some and not in others."""
    rng = np.random.RandomState(7)
    outcomes = set()
    for trial in range(12):
        h = w = int(rng.choice([8, 16, 32]))
        img = rng.randint(0, 256, (h, w)).astype(np.uint8)
        cs, start, cl, ref = _one_block(img, refine=refine)
        if refine and not ref:
            continue
        scup = (cl[-1] << 4) | (cl[-2] & 15)
        mel = start + len(cl) - scup
        for k in range(5):
            e = bytearray(cs)
            e[mel + k], e[mel + k + 1] = 0xFF, 0x90 + 0x23 * (k % 3)
            want = pillow(bytes(e))
            assert same(bytes(e)), (trial, k)
            outcomes.add(want is None)
    assert outcomes == {True, False}


def test_malformed_blocks_give_pillows_outcome():
    """Each check of OpenJPEG's opj_t1_ht_decode_cblk, and what it does:
    a block whose band has no magnitude bit-plane (Mb 0) decodes to
    zeros; an RGN shift fails every HT block, included or not; more than
    three passes fail, but not where the refinement segment is empty
    (then the cleanup pass alone is decoded, a warning); as where the
    zero bit-planes equal the band's bit-planes ("only the cleanup pass
    will be decoded"); U_q above the zero bit-planes + 1 fails in the
    first row and in a later one; Scup out of [2, min(Lcup, 4079)] and a
    cleanup segment of 1 byte fail; significance outside a block of odd
    height fails ("VLC code produces significant samples outside")."""
    img = (np.arange(64).reshape(8, 8) * 3 % 256).astype(np.uint8)

    def cs_of(pixels, edit=None, **kw):
        return hw.encode(pixels, levels=0, edit=edit, **kw)

    outcomes = {}
    # Mb 0: QCD's guard bits 1 and exponent 0
    data = bytearray(cs_of(img, guard_bits=1))
    q = data.index(b"\xff\x5c")
    data[q + 4:q + 6] = bytes([1 << 5, 0])
    outcomes["mb0"] = bytes(data)
    cod = cs_of(img).index(b"\xff\x52")
    rgn = struct.pack(">HHBBB", 0xFF5E, 5, 0, 0, 3)
    flat = cs_of(np.full((8, 8), 128, np.uint8))
    outcomes["rgn_empty"] = flat[:cod] + rgn + flat[cod:]

    def passes(n, extra):
        def edit(b):
            cl = b.segments[0]
            b.layers = [(0, n, [len(cl), len(extra)], cl + extra)]
        return edit
    outcomes["four_passes_empty"] = cs_of(img, passes(4, b""))
    outcomes["four_passes"] = cs_of(img, passes(4, b"\x00"))
    noise = np.random.RandomState(3).randint(0, 256, (8, 8)).astype(np.uint8)

    def three_passes(b):
        # a cleanup-only block (its zero bit-planes are the band's) said
        # to carry refinement passes
        cl = b.segments[0]
        b.layers = [(0, 3, [len(cl), 1], cl + b"\0")]
    outcomes["zero_planes_equal"] = cs_of(noise, three_passes)
    for where, (r, v) in {"u_q_initial": (0, 20), "u_q_later": (4, 5),
                          "u_q_later_bound": (4, 3)}.items():
        coef = np.zeros((8, 8), np.int64)
        coef[0:2] = 1 if r else 0
        coef[r, 3] = v

        def low_p(b):
            b.plane = b.mb - 2
        outcomes[where] = cs_of((coef + 128).astype(np.uint8), low_p)
    cs, start, cl, _ = _one_block(noise)
    for name, scup in (("scup_1", 1), ("scup_over_lcup", len(cl) + 1),
                       ("scup_4080", 4080)):
        e = bytearray(cs)
        e[start + len(cl) - 1] = (scup >> 4) & 0xFF
        e[start + len(cl) - 2] = (e[start + len(cl) - 2] & 0xF0) | (scup & 15)
        outcomes[name] = bytes(e)

    def one_byte(b):
        b.layers = [(0, 1, [1], b.segments[0][:1])]
    outcomes["lcup_1"] = cs_of(noise, one_byte)
    # significance on the row a block of odd height leaves out: a cleanup
    # pass of 8 rows in a block of 7
    coef = noise.astype(np.int64) - 128
    coef[7] = 50
    seg = hw.cleanup_pass(np.abs(coef), (coef < 0).astype(np.int64))

    def taller(b):
        b.layers = [(0, 1, [len(seg)], seg)]
    outcomes["outside"] = cs_of(noise[:7], taller)
    want = {"mb0": True, "rgn_empty": False, "four_passes_empty": True,
            "four_passes": False, "zero_planes_equal": True,
            "u_q_initial": False, "u_q_later": False,
            "u_q_later_bound": True, "scup_1": False,
            "scup_over_lcup": False, "scup_4080": False, "lcup_1": False,
            "outside": False}
    for name, data in outcomes.items():
        assert same(data), name
        assert (pillow(data) is not None) == want[name], name
    assert (image_io.read_image(outcomes["mb0"]) == 128).all()
    assert np.array_equal(image_io.read_image(outcomes["zero_planes_equal"]),
                          np.repeat(noise[..., None], 3, 2))


def test_segment_rules_follow_openjpeg():
    """OpenJPEG 2.5.4 takes an HT block's first pass into segment 0 and
    every later pass of a packet into the next segment, over its Part-1
    segment limits (109 passes, or 1 under TERMALL): the standard's
    refinement passes in a later layer land in the cleanup's segment
    (other pixels or an error, as Pillow's), are read under TERMALL, and
    are read where signalled as OpenJPEG reads them."""
    rng = np.random.RandomState(9)
    img = rng.randint(0, 256, (24, 32, 3)).astype(np.uint8)
    kw = dict(layers=2, layer_of="refinement", refine="lossless", levels=2)
    standard = hw.encode(img, **kw)
    assert same(standard)
    assert not np.array_equal(pillow(standard), img)
    for extra in (dict(style=hw.TERMALL), dict(opj_segments=True)):
        data = hw.encode(img, **kw, **extra)
        assert np.array_equal(pillow(data), img), extra
        assert np.array_equal(image_io.read_image(data), img), extra
    # SigProp and MagRef in layers of their own under TERMALL: three
    # segments, of which OpenJPEG decodes two (MagRef is left out)
    split = hw.encode(img, layers=3, layer_of="split", refine="lossless",
                      levels=2, style=hw.TERMALL)
    assert same(split) and not np.array_equal(pillow(split), img)


@pytest.mark.parametrize("bits", [hw.BYPASS, hw.RESET, hw.TERMALL, hw.VSC,
                                  hw.PTERM, hw.SEGSYM, 63])
def test_style_bits_beside_ht_give_pillows_outcome(bits):
    """The Part-1 mode switches beside HT's style bit: VSC changes the
    SigProp pass's neighbourhood, TERMALL and BYPASS OpenJPEG's segment
    limits, the others nothing; each file gives Pillow's outcome."""
    rng = np.random.RandomState(bits)
    img = rng.randint(0, 256, (21, 27, 3)).astype(np.uint8)
    for kw in (dict(refine="all"), dict(refine="all", layers=2,
                                        layer_of="refinement")):
        data = hw.encode(img, style=bits, levels=2, **kw)
        assert same(data), kw


def test_htj2k_scenes_are_whole_and_small_and_their_pixels():
    """The scenes as HTJ2K (tests/data/htj2k_scenes) are the files their
    index names, a raw codestream and JPH files, hold at most 2 MB in all,
    decode to their Pillow digests and to their JPEG scenes' pixels."""
    scenes = json.loads((ic.HTJ2K_SCENES / "index.json").read_text())
    files = {p.name for p in ic.HTJ2K_SCENES.iterdir()} - {"index.json"}
    assert files == set(scenes)
    assert sum((ic.HTJ2K_SCENES / n).stat().st_size
               for n in files) <= 2_000_000
    assert {n.rsplit(".", 1)[1] for n in files} == {"j2c", "jph"}
    for name, entry in scenes.items():
        img = image_io.read_image(ic.HTJ2K_SCENES / name)
        assert list(img.shape) == entry["shape"] + [3]
        assert hashlib.sha256(img.tobytes()).hexdigest() == entry["sha256"]
        assert entry["pixels"] == "same"
        assert np.array_equal(img, image_io.read_image(
            ic.CORPUS / entry["source"])), name


def test_ht_decoder_threads_give_one_threads_arrays():
    """HT decodes on threads (ctypes releases the GIL) give the arrays of
    one thread's decodes."""
    from concurrent.futures import ThreadPoolExecutor
    names = sorted(n for n in INDEX["files"]
                   if n.startswith("htj2k_") and "37x53" in n)[:12]
    datas = [(ic.CORPUS / n).read_bytes() for n in names]
    want = [image_io.read_image(d) for d in datas]
    with ThreadPoolExecutor(4) as pool:
        got = list(pool.map(image_io.read_image, datas * 2))
    for k, img in enumerate(got):
        assert np.array_equal(img, want[k % len(datas)])


def test_jax_coco_dataset_reads_htj2k_as_the_port(tmp_path):
    """maskrcnn_tpu/data/coco.py's load_image and load (Pillow, from the
    file's path) against the port's (its native reader) on HT files, raw
    and JPH."""
    pytest.importorskip("PIL")
    from maskrcnn_tpu.config import TinyConfig
    from maskrcnn_tpu.data import coco as jax_coco
    from maskrcnn_tpu_torch import TinyConfig as PortTinyConfig
    from maskrcnn_tpu_torch.data import coco as port_coco
    root = tmp_path / "coco"
    (root / "val2014").mkdir(parents=True)
    (root / "annotations").mkdir()
    rng = np.random.RandomState(12)
    images, anns = [], []
    for i in range(1, 5):
        h, w = 60 + 7 * i, 80 + 5 * i
        img = ic.seeded_image(rng, h, w)
        cs = hw.encode(img, refine="lossless" if i % 2 else None)
        data = hw.jph_file(cs, h, w, 3) if i % 2 else cs
        name = f"COCO_val2014_{i:012d}.{'jph' if i % 2 else 'j2c'}"
        (root / "val2014" / name).write_bytes(data)
        images.append({"id": i, "height": h, "width": w, "file_name": name})
        anns.append({"id": i, "image_id": i, "category_id": 1, "iscrowd": 0,
                     "bbox": [4.0 * i, 6.0, 30.0, 20.0], "area": 600.0,
                     "segmentation": [[4.0 * i, 6.0, 4.0 * i + 30, 6.0,
                                       4.0 * i + 30, 26.0, 4.0 * i, 26.0]]})
    with open(root / "annotations" / "instances_minival2014.json", "w") as f:
        json.dump({"images": images, "annotations": anns,
                   "categories": INDEX["categories"]}, f)
    ref = jax_coco.CocoDataset(str(root), "minival", 2014, TinyConfig())
    mine = port_coco.CocoDataset(str(root), "minival", 2014, PortTinyConfig())
    assert mine.ids == ref.ids and len(mine.ids) == 4
    for i, image_id in enumerate(mine.ids):
        np.testing.assert_array_equal(mine.load_image(image_id),
                                      ref.load_image(image_id))
        for a, b in zip(mine.load(i), ref.load(i)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
