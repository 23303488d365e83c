#!/usr/bin/env python3
"""Mutation fuzzing of the port's native image decoders under AddressSanitizer
and UndefinedBehaviorSanitizer: the sources of data/native_image.py's
image library (JPEG, GIF, BMP, TIFF with its ZSTD, LZMA and CCITT data;
PPM/PGM/PBM/PFM, TGA, QOI, PCX, DCX, SGI and Sun raster; DIB, and the
DIB frames of ICO and CUR, whose entry is picked as
data/image_probe.py picks it, PNG frames left out; JPEG 2000) or of its WebP
library, built with its flags and
-fsanitize=address,undefined into build/maskrcnn_tpu_torch/, then each
worker process decodes mutated copies of the committed corpus's files
(tests/data/image_io) of one format through the size and decode calls,
as data/native_image.py makes them: bytes set, bits flipped, 2-, 4- and
8-byte integers near the type limits written, the file cut short. TIFF
files are read half the time as from their path (the memory-map route),
and the TIFF seeds add uncompressed files that route takes (`map_*`:
L, P, RGBA, CMYK, I;16 and I;16B at Orientation 5-8, in one strip or
in one tile wider than the image and narrower than it is tall) and,
where Pillow's libjpeg is at hand to write them (tests/jpeg_modes.py),
JPEG TIFF files whose strips are arithmetic-coded (`arith_*`); PCX and
DCX files are read from their path half the time too. An error the
decoder reports is the expected outcome; a sanitizer report stops the
worker and the run exits 1.

    python3 tools/fuzz_image_decode_torch.py --format tiff [--glob 'tiff_*']
        [--mutations 3000] [--workers 4] [--seed 1]

(formats: jpeg, gif, bmp, tiff, webp, ppm, tga, qoi, pcx, dcx, sgi, sun,
dib, ico, cur, jpeg2000, icns: its packed RGB entries; dds, blp, psd:
the files of tests/data/texture_io through data/native_image.py's
decode_dds, decode_blp and decode_psd, which read the header in Python
and make one call into csrc/bcn_decode.cpp, here into the sanitized
library; im, spider, fits, mcidas, imt, xvthumb, pixar, gbr, ftex, xbm,
xpm, msp, fli, iptc: the files of tests/data/legacy_io, and pcd: the
seeded Photo CD files (tests/image_writers.pcd_cases), through
data/image_io.read_image (the probe, native_image.py's decode_<format>,
csrc/image_legacy.cpp in the sanitized library), where an exception other
than ValueError or NotImplementedError also stops the worker; avif: the
AVIF files of tests/data/image_io and tests/data/avif_scenes through
data/image_io.read_image, the probe's model of libavif's parse, then
native_image.decode_avif over the sanitized AVIF library
(csrc/avif_decode.cpp, csrc/av1_decode.cpp), held to the same contract)

(`--glob '*zstd*'`, `'*lzma*'`, `'*bilevel_ccitt*'` and `'*group*'`,
`'map_*'` or `'arith_*'` mutate the ZSTD, LZMA, CCITT, memory-map or
arithmetic JPEG TIFF files alone; `'tiff_*lzw*'`, `'tiff_*deflate*'` and
`'tiff_*packbits*'` the files libtiff's directory checks see most;
with --format jpeg, `'jpeg_arith*'`, `'jpeg_lossless*'` and
`'jpeg_smooth*'` the arithmetic-coded, lossless and block-smoothed
modes; `'tiff_ycbcr_*'`, `'*ojpeg*'`, `'*lab*'`, `'*thunder*'`,
`'*cmyk16*'` and `'tiff_lzma_*'` libtiff's RGBA route, old-style JPEG,
LAB, ThunderScan, 16-bit CMYK and the xz filters; with --format jpeg2000, `'jp2_*'` the
layouts of tests/image_corpus.jpeg2000_modes (raw J2K and JP2: every
mode switch, SOP/EPH, POC, tile-parts, RGN, PPT and PPM, subsampling,
palettes), each decoded in a mode of Pillow's drawn at random;
`'jp2_part2_*'` the Part-2 transforms (MCT, MCC and MCO markers);
`'htj2k_*'` the HTJ2K layouts of tests/image_corpus.HTJ2K_LAYOUTS (raw
codestreams and JPH files; cleanup passes, SigProp and MagRef, VSC,
quality layers, tiles, precincts).)

Host only, no card; a worker holds at most a 4-megapixel output.
"""

from __future__ import annotations

import argparse
import ctypes
import fnmatch
import os
import random
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(1, str(REPO / "tests"))

from maskrcnn_tpu_torch.data import native_image  # noqa: E402
from maskrcnn_tpu_torch.utils import native_build  # noqa: E402

CORPUS = REPO / "tests" / "data" / "image_io"
TEXTURES = REPO / "tests" / "data" / "texture_io"
FLAGS = ("-O1", "-g", "-shared", "-fPIC", "-std=c++17", "-fwrapv",
         "-ffp-contract=off", "-fsanitize=address,undefined",
         "-fno-sanitize-recover=all")
SUFFIX = {"jpeg": (".jpg",), "gif": (".gif",), "bmp": (".bmp",),
          "tiff": (".tif",), "webp": (".webp",),
          "ppm": (".ppm", ".pgm", ".pbm", ".pfm"), "tga": (".tga",),
          "qoi": (".qoi",), "pcx": (".pcx",), "dcx": (".dcx",),
          "sgi": (".sgi",), "sun": (".ras",), "dib": (".dib",),
          "ico": (".ico",), "cur": (".cur",), "jpeg2000": (".jp2", ".j2k",
                                                         ".j2c", ".jph"),
          "icns": (".icns",), "dds": (".dds",), "blp": (".blp",),
          **{fmt: (f".{fmt}",) for fmt in (
              "im", "spider", "fits", "mcidas", "imt", "xvthumb", "pixar",
              "gbr", "ftex", "xbm", "xpm", "msp", "fli", "iptc", "pcd")},
          "avif": (".avif",),
          "psd": (".psd",)}
# the formats decoded through data/native_image.py's Python header reading
TEXTURE = ("dds", "blp", "psd")
LEGACY_DIR = REPO / "tests" / "data" / "legacy_io"
# the formats of tests/data/legacy_io, by their files' extension, and PCD
LEGACY = ("im", "spider", "fits", "mcidas", "imt", "xvthumb", "pixar",
          "gbr", "ftex", "xbm", "xpm", "msp", "fli", "iptc", "pcd")
# the formats whose calls take a path flag last
PATH_FLAG = ("tiff", "pcx", "dcx")
LIMITS = (0, 1, 2, 7, 8, 15, 16, 255, 256, 65535, 2 ** 31 - 1, 2 ** 31,
          2 ** 32 - 1, 2 ** 61, 2 ** 63, 2 ** 64 - 1)
MAX_PIXELS = 4_000_000


def build(fmt: str) -> Path:
    """The sanitized library of native_image's sources for `fmt`, named
    by their hash as native_build names every library."""
    stem, sources = (("webp_decode_asan", (native_image.WEBP_SOURCE,))
                     if fmt == "webp" else
                     ("avif_decode_asan", native_image.AVIF_SOURCES)
                     if fmt == "avif" else
                     ("image_decode_asan", native_image.SOURCES))
    lib = native_build.library_path(stem, sources, FLAGS)
    if not lib.exists():
        native_build.build(sources, lib, FLAGS)
    return lib


def map_seeds() -> dict:
    """Uncompressed TIFF files that a read from the path memory-maps:
    each mapped mode at Orientation 5-8, in one strip and in one tile
    wider and longer than the image (whose stride is shorter than a row
    of the turned view)."""
    import numpy as np

    import image_writers as iw
    rng = np.random.RandomState(0)
    modes = {"L": ((40, 5), dict(photometric=1)),
             "P": ((40, 5), dict(photometric=3,
                                colormap=rng.randint(0, 65536, (256, 3)))),
             "RGBA": ((40, 5, 4), dict(extra_samples=[2])),
             "CMYK": ((40, 5, 4), dict(photometric=5)),
             "I16": ((40, 5), dict(photometric=1, bits=16)),
             "I16B": ((40, 5), dict(photometric=1, bits=16, byteorder=">"))}
    seeds = {}
    for mode, (shape, kw) in modes.items():
        samples = rng.randint(0, 65536 if kw.get("bits") == 16 else 256,
                              shape)
        for orientation in range(5, 9):
            for layout, extra in (("strip", {}), ("tile", {"tile": (16, 48)})):
                seeds[f"map_{mode}_{orientation}_{layout}.tif"] = (
                    iw.encode_tiff(samples, orientation=orientation, **kw,
                                   **extra))
    return seeds


def arith_seeds() -> dict:
    """JPEG TIFF files (compression 7) whose strips are arithmetic-coded,
    sequential and progressive, RGB and gray; empty where Pillow's
    libjpeg, which writes them, is not at hand."""
    try:
        import numpy as np

        import image_writers as iw
        import jpeg_modes as jm
        rng = np.random.RandomState(1)
        seeds = {}
        for k, progressive in enumerate((False, True)):
            img = rng.randint(0, 256, (24, 40, 3)).astype(np.uint8)
            rgb = jm.write(img, space=jm.RGB, arith=True,
                           progressive=progressive, restart=3)
            seeds[f"arith_rgb_{k}.tif"] = iw.encode_tiff(
                img, compression=7, segments=[rgb])
            gray = jm.write(img[..., 0], arith=True, progressive=progressive)
            seeds[f"arith_gray_{k}.tif"] = iw.encode_tiff(
                img[..., 0], photometric=1, compression=7, segments=[gray])
        return seeds
    except Exception:  # noqa: BLE001 - no Pillow, no compiler: no seeds
        return {}


def mutate(rng: random.Random, data: bytes) -> bytes:
    d = bytearray(data)
    for _ in range(rng.randint(1, 8)):
        p = rng.randrange(len(d))
        r = rng.random()
        if r < 0.5:
            d[p] = rng.randrange(256)
        elif r < 0.7:
            d[p] ^= 1 << rng.randrange(8)
        elif r < 0.85:
            size = rng.choice((2, 4, 8))
            v = min(rng.choice(LIMITS), 256 ** size - 1)
            d[p:p + size] = v.to_bytes(size, rng.choice(("little", "big")))
        else:
            d = d[:max(p, 4)]
    return bytes(d)


def extra_args(fmt: str, data: bytes, rng: random.Random):
    """The size and decode calls' arguments after the message's length,
    as data/native_image.py passes them; None where the file is no ICO
    or CUR whose frame the probe can place, or an ICO's frame is a PNG."""
    if fmt in PATH_FLAG:
        return (ctypes.c_int32(rng.randrange(2)),)
    if fmt == "jpeg2000":
        # any of Pillow's modes, whatever the header says, and a palette
        return (ctypes.c_int32(rng.randrange(8)),
                bytes(rng.randrange(256) for _ in range(768)))
    if fmt not in ("dib", "ico", "cur"):
        return ()
    from maskrcnn_tpu_torch.data import image_probe
    at, kind, end, bpp32 = 0, 0, 0, 0
    try:
        if fmt == "ico":
            _, _, _, size, at, bpp = image_probe.ico_entry(data)
            if data[at:at + 8] == native_image.PNG_SIGNATURE:
                return None
            kind, end, bpp32 = 1, at + size, int(bpp == 32)
        elif fmt == "cur":
            at, kind = image_probe.cur_frame(data), 2
    except Exception:  # noqa: BLE001 - the probe refuses the directory
        return None
    return (ctypes.c_int64(at), ctypes.c_int32(kind), ctypes.c_int64(end),
            ctypes.c_int32(bpp32))


def icns_worker(lib, files, rng: random.Random, mutations: int) -> None:
    """ICNS: each packed RGB entry of the size IcnsImageFile loads
    (data/image_probe.icns_entries) through mrt_icns_rgb (its PNG and JPEG
    2000 entries are those decoders' files)."""
    from maskrcnn_tpu_torch.data import image_probe
    msg = ctypes.create_string_buffer(512)
    for _ in range(mutations):
        data = mutate(rng, rng.choice(files))
        try:
            dct, _, best = image_probe.icns_entries(data)
        except Exception:  # noqa: BLE001 - the walk refuses the file
            continue
        w, h, _ = best
        for code, kind in native_image.ICNS_READERS[best]:
            if code in dct and kind.startswith("rgb"):
                start, length = dct[code]
                out = ctypes.create_string_buffer(h * w * 3)
                lib.mrt_icns_rgb(data, len(data), ctypes.c_int64(start),
                                 ctypes.c_int64(length),
                                 ctypes.c_int32(kind == "rgb32t"), out,
                                 ctypes.c_int32(h), ctypes.c_int32(w), msg,
                                 512)


def texture_worker(lib_path: str, fmt: str, pattern: str, mutations: int,
                   seed: int) -> None:
    """DDS, BLP or PSD: mutated files through native_image's decode_dds,
    decode_blp or decode_psd, its library the sanitized one (loaded and
    declared by native_image.library) and its size limit a worker's."""
    native_image._build = lambda stem, sources: ctypes.CDLL(lib_path)
    native_image._LIB = None
    native_image.MAX_PIXELS = MAX_PIXELS
    decode = getattr(native_image, f"decode_{fmt}")
    files = [p.read_bytes() for p in sorted(TEXTURES.glob(pattern))
             if p.suffix in SUFFIX[fmt] and p.stat().st_size < 20000]
    if not files:
        raise SystemExit(f"no {fmt} texture file matches {pattern}")
    rng = random.Random(seed)
    for _ in range(mutations):
        try:
            decode(mutate(rng, rng.choice(files)))
        except Exception:  # noqa: BLE001 - a refusal is the outcome
            pass


def legacy_worker(lib_path: str, fmt: str, pattern: str, mutations: int,
                  seed: int) -> None:
    """The last plugins' files (PCD's seeded ones) through
    image_io.read_image over the sanitized library; an exception other
    than ValueError or NotImplementedError (the contract's) stops the
    worker. "avif": the AVIF files of the corpus and the scenes
    (tests/data/avif_scenes) through read_image over the sanitized AVIF
    library (the probe's parse in Python, one call into
    csrc/avif_decode.cpp with csrc/av1_decode.cpp)."""
    from maskrcnn_tpu_torch.data import image_io, image_probe
    native_image._build = lambda stem, sources: ctypes.CDLL(lib_path)
    native_image._LIB = None
    native_image._AVIF_LIB = None
    native_image.MAX_PIXELS = MAX_PIXELS
    image_probe.MAX_PIXELS = MAX_PIXELS
    if fmt == "pcd":
        import image_writers
        files = [d for name, d in image_writers.pcd_cases()
                 if fnmatch.fnmatch(name, pattern)]
    else:
        roots = ((CORPUS, REPO / "tests" / "data" / "avif_scenes")
                 if fmt == "avif" else (LEGACY_DIR,))
        files = [p.read_bytes() for root in roots
                 for p in sorted(root.glob(pattern))
                 if p.suffix in SUFFIX[fmt] and p.stat().st_size < 200000]
    if not files:
        raise SystemExit(f"no {fmt} file matches {pattern}")
    read = image_io.read_image
    rng = random.Random(seed)
    for _ in range(mutations):
        data = rng.choice(files)
        if fmt == "avif" and rng.random() < 0.7:
            # the AV1 data alone mutated (mdat's payload), the container
            # kept, so that most mutations reach the decoder
            at = data.find(b"mdat") + 4
            data = data[:at] + mutate(rng, data[at:])
        else:
            data = mutate(rng, data)
        try:
            read(data)
        except (ValueError, NotImplementedError):
            pass


def worker(lib_path: str, fmt: str, pattern: str, mutations: int,
           seed: int) -> None:
    if fmt in LEGACY or fmt == "avif":
        legacy_worker(lib_path, fmt, pattern, mutations, seed)
        return
    if fmt in TEXTURE:
        texture_worker(lib_path, fmt, pattern, mutations, seed)
        return
    lib = ctypes.CDLL(lib_path)
    if fmt == "icns":
        files = [p.read_bytes() for p in sorted(CORPUS.glob(pattern))
                 if p.suffix == ".icns" and p.stat().st_size < 20000]
        icns_worker(lib, files, random.Random(seed), mutations)
        return
    name = "dib" if fmt in ("ico", "cur") else fmt
    size_fn, decode_fn = (getattr(lib, f"mrt_{name}_{k}")
                          for k in ("size", "decode"))
    msg = ctypes.create_string_buffer(512)
    files = [p.read_bytes() for p in sorted(CORPUS.glob(pattern))
             if p.suffix in SUFFIX[fmt] and p.stat().st_size < 20000]
    if fmt == "tiff":
        seeds = dict(map_seeds(), **arith_seeds())
        files += [d for name, d in seeds.items()
                  if fnmatch.fnmatch(name, pattern)]
    if not files:
        raise SystemExit(f"no {fmt} corpus file matches {pattern}")
    rng = random.Random(seed)
    for _ in range(mutations):
        data = mutate(rng, rng.choice(files))
        extra = extra_args(fmt, data, rng)
        if extra is None:
            continue
        h, w = ctypes.c_int32(), ctypes.c_int32()
        if size_fn(data, len(data), ctypes.byref(h), ctypes.byref(w), msg,
                   512, *extra):
            continue
        if min(h.value, w.value) < 1 or h.value * w.value > MAX_PIXELS:
            continue
        out = ctypes.create_string_buffer(h.value * w.value * 3)
        decode_fn(data, len(data), out, h.value, w.value, msg, 512, *extra)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--format", choices=sorted(SUFFIX), required=True)
    ap.add_argument("--glob", default="*")
    ap.add_argument("--mutations", type=int, default=3000)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--worker-seed", type=int, default=None,
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker_seed is not None:
        worker(str(build(args.format)), args.format, args.glob,
               args.mutations, args.worker_seed)
        return 0
    build(args.format)
    runtimes = [subprocess.run(["g++", f"-print-file-name={name}"],
                               capture_output=True, text=True,
                               check=True).stdout.strip()
                for name in ("libasan.so", "libubsan.so")]
    env = dict(os.environ, LD_PRELOAD=":".join(runtimes),
               ASAN_OPTIONS="detect_leaks=0",
               UBSAN_OPTIONS="print_stacktrace=1")
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--format", args.format, "--glob",
         args.glob, "--mutations", str(args.mutations),
         "--worker-seed", str(args.seed + k)], env=env)
        for k in range(args.workers)]
    failed = [k for k, p in enumerate(procs) if p.wait() != 0]
    total = args.workers * args.mutations
    print(f"{args.format}: {total} mutations of {args.glob}, "
          f"{len(failed)} workers stopped by a sanitizer report "
          f"(seeds {[args.seed + k for k in failed]})", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
