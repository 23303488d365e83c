"""The image reader's committed corpus, `tests/data/image_io/`: small
seeded files of every JPEG and PNG mode the port reads, a few it
refuses, and three COCO-sized (640x480) synthetic scenes, one of them
progressive, with their annotations (chip_smoke.py's phase 9d reads them
as a COCO directory).

`index.json` beside the files gives each file's rows, columns and the
SHA-256 of Pillow 12.1.0's decode (np.asarray(Image.open(f).convert(
"RGB"))), the word each refused file's NotImplementedError names, and
the scenes' annotations. The card's machine has no Pillow: chip_smoke.py
holds the port's reader to these digests there.

Every file is made here from seeded numpy arrays: by Pillow where Pillow
writes the mode, by a byte edit of a Pillow file (an Adobe transform set
to 2 for YCCK, the Adobe marker removed, a frame marker or precision
rewritten), or by the test-only writers (tests/jpeg_writer.py; the PNG
writer below). Regenerate with `python tests/image_corpus.py` (needs
Pillow; the digests then change only if Pillow's decode does);
`--time-pillow` prints Pillow's decode times of the files
tools/image_decode_bench_torch.py times instead.
"""

from __future__ import annotations

import hashlib
import io
import json
import struct
import sys
import zlib
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(1, str(Path(__file__).resolve().parent.parent))

from jpeg_writer import encode_jpeg, scan_offsets  # noqa: E402

CORPUS = Path(__file__).resolve().parent / "data" / "image_io"
INDEX = CORPUS / "index.json"
PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
ADAM7 = [(0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2)]
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def seeded_image(rng, h, w, channels=3):
    """Smooth gradients with noise and a hard edge (the IDCT, the
    upsampling and the range limit all see work)."""
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([(yy * 7 + xx * 3) % 256, (xx * 11) % 256,
                     255 - (yy * 5) % 256, (yy * xx) % 256],
                    -1)[..., :channels]
    img = base + rng.randint(-40, 41, base.shape)
    img[: h // 2, : w // 3] = 255
    return np.clip(img, 0, 255).astype(np.uint8)


# ------------------------------------------------------------------ PNG

def _pack(samples: np.ndarray, depth: int) -> np.ndarray:
    """Rows of samples [h, n] as PNG row bytes of `depth`-bit samples."""
    h, n = samples.shape
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(h, -1)
    if depth == 8:
        return samples.astype(np.uint8)
    per = 8 // depth
    s = np.pad(samples, ((0, 0), (0, (-n) % per))).reshape(h, -1, per)
    out = np.zeros(s.shape[:2], np.int64)
    for i in range(per):
        out |= s[:, :, i].astype(np.int64) << (8 - depth * (i + 1))
    return out.astype(np.uint8)


def _filter(rows: np.ndarray, bpp: int, rng) -> bytes:
    """Each row filtered with a filter drawn from rng (all five)."""
    out = bytearray()
    prior = np.zeros(rows.shape[1], np.int64)
    zeros = np.zeros(bpp, np.int64)
    for row in rows.astype(np.int64):
        kind = int(rng.randint(5))
        left = np.concatenate([zeros, row])[:len(row)]
        up_left = np.concatenate([zeros, prior])[:len(row)]
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


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def png_bytes(samples: np.ndarray, width: int, depth: int, color: int,
              rng, interlace: int = 0, palette: bytes = None,
              trns: bytes = None) -> bytes:
    """A PNG of samples [H, W * channels] (ints below 2**depth): rows
    filtered with random filters, Adam7 passes when interlace is 1."""
    ch = CHANNELS[color]
    bpp = max(1, ch * depth // 8)
    h = samples.shape[0]
    if interlace:
        pixels = samples.reshape(h, width, ch)
        raw = b""
        for x0, y0, dx, dy in ADAM7:
            sub = pixels[y0::dy, x0::dx]
            if sub.size:
                raw += _filter(_pack(sub.reshape(sub.shape[0], -1), depth),
                               bpp, rng)
    else:
        raw = _filter(_pack(samples, depth), bpp, rng)
    out = PNG_SIGNATURE + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", width, h, depth, color, 0, 0, interlace))
    if palette is not None:
        out += _chunk(b"PLTE", palette)
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    # two IDAT chunks: the reader joins them
    data = zlib.compress(raw)
    half = len(data) // 2
    return (out + _chunk(b"IDAT", data[:half]) + _chunk(b"IDAT", data[half:])
            + _chunk(b"IEND", b""))


def seeded_png(seed: int, h: int, w: int, depth: int, color: int,
               interlace: int = 0, trns: bool = False) -> bytes:
    rng = np.random.RandomState(seed)
    top = (1 << depth) - 1
    palette = tr = None
    if color == 3:
        n = min(1 << depth, 200)
        palette = rng.randint(0, 256, 3 * n).astype(np.uint8).tobytes()
        samples = rng.randint(0, n, (h, w))
        if trns:
            tr = bytes(rng.randint(0, 256, min(n, 5)).astype(np.uint8))
    else:
        samples = rng.randint(0, top + 1, (h, w * CHANNELS[color]))
        if depth == 16:
            # around the clip of 16-bit grayscale ("I;16" -> 255)
            samples.flat[:3] = [255, 256, 1000]
        if trns and color in (0, 2):
            n = 1 if color == 0 else 3
            tr = struct.pack(">" + "H" * n, *rng.randint(0, top + 1, n))
    return png_bytes(samples, w, depth, color, rng, interlace, palette, tr)


# ----------------------------------------------------------------- JPEG

def pil_jpeg(img: np.ndarray, mode: str = None, **kw) -> bytes:
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(img, mode).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _adobe_at(data: bytes) -> int:
    return data.index(b"Adobe") - 4


def without_adobe(data: bytes) -> bytes:
    """The file with its Adobe APP14 segment removed."""
    i = _adobe_at(data)
    return data[:i] + data[i + 2 + struct.unpack(">H", data[i + 2:i + 4])[0]:]


def with_transform(data: bytes, transform: int) -> bytes:
    """The file with its Adobe transform byte rewritten."""
    out = bytearray(data)
    out[_adobe_at(data) + 4 + 11] = transform
    return bytes(out)


def patched_sof(data: bytes, marker: int = None,
                precision: int = None) -> bytes:
    """The file with its frame marker or sample precision rewritten."""
    i = next(i for i in range(len(data) - 1) if data[i] == 0xFF
             and data[i + 1] in (0xC0, 0xC1, 0xC2))
    out = bytearray(data)
    if marker is not None:
        out[i + 1] = marker
    if precision is not None:
        out[i + 4] = precision
    return bytes(out)


def drop_scan(data: bytes, k: int) -> bytes:
    """The file without its k-th scan (negative: from the end)."""
    s = scan_offsets(data)
    k %= len(s)
    end = s[k + 1] if k + 1 < len(s) else data.rindex(b"\xff\xd9")
    return data[:s[k]] + data[end:]


def jpeg_cases():
    """(name, bytes) of every read JPEG of the corpus, small and odd-sized."""
    rng = np.random.RandomState(14)
    img = seeded_image(rng, 37, 53)
    tall = seeded_image(rng, 53, 37)
    tiny = seeded_image(rng, 5, 3)
    gray = seeded_image(rng, 37, 53, 1)[..., 0]
    cmyk = seeded_image(rng, 37, 53, 4)
    planes = [img[..., k] for k in range(3)]
    cases = [
        ("baseline_444.jpg", pil_jpeg(img, quality=90, subsampling="4:4:4")),
        ("baseline_422_restart.jpg", pil_jpeg(img, quality=75,
                                              subsampling="4:2:2",
                                              restart_marker_blocks=2)),
        ("baseline_420_optimized.jpg", pil_jpeg(tall, quality=50,
                                                subsampling="4:2:0",
                                                optimize=True)),
        ("baseline_420_5x3.jpg", pil_jpeg(tiny, quality=95,
                                          subsampling="4:2:0")),
        ("gray.jpg", pil_jpeg(gray, quality=85)),
        ("progressive_420.jpg", pil_jpeg(img, quality=85, progressive=True,
                                         subsampling="4:2:0")),
        ("progressive_444_5x3.jpg", pil_jpeg(tiny, quality=90,
                                             progressive=True,
                                             subsampling="4:4:4")),
        ("progressive_422_restart.jpg", pil_jpeg(tall, quality=80,
                                                 progressive=True,
                                                 subsampling="4:2:2",
                                                 restart_marker_blocks=1)),
        ("progressive_gray_restart_rows.jpg", pil_jpeg(
            gray, quality=70, progressive=True, restart_marker_rows=1)),
        ("cmyk_adobe.jpg", pil_jpeg(cmyk, "CMYK", quality=90)),
        ("cmyk_adobe_uninverted.jpg", pil_jpeg(255 - cmyk, "CMYK",
                                               quality=90)),
        ("cmyk_no_adobe.jpg", without_adobe(pil_jpeg(cmyk, "CMYK",
                                                     quality=90))),
        ("cmyk_progressive.jpg", pil_jpeg(cmyk, "CMYK", quality=80,
                                          progressive=True)),
        ("ycck.jpg", with_transform(pil_jpeg(cmyk, "CMYK", quality=90), 2)),
        ("ycck_uninverted.jpg", with_transform(
            pil_jpeg(255 - cmyk, "CMYK", quality=90), 2)),
        ("adobe_rgb.jpg", pil_jpeg(img, quality=90, keep_rgb=True)),
        ("rgb_component_ids.jpg", without_adobe(pil_jpeg(img, quality=90,
                                                         keep_rgb=True))),
        ("writer_440.jpg", encode_jpeg(planes, [(1, 2), (1, 1), (1, 1)])),
        ("writer_411.jpg", encode_jpeg(planes, [(4, 1), (1, 1), (1, 1)])),
        ("writer_h3v1.jpg", encode_jpeg(planes, [(3, 1), (1, 1), (1, 1)],
                                        restart=3)),
        ("writer_h4v2_chroma_h2v1.jpg", encode_jpeg(
            planes, [(4, 2), (2, 1), (1, 1)], interleaved=False)),
        ("writer_h1v4.jpg", encode_jpeg(planes, [(1, 4), (1, 1), (1, 1)])),
        ("writer_420_scan_a_component.jpg", encode_jpeg(
            planes, [(2, 2), (1, 1), (1, 1)], interleaved=False, restart=4)),
        ("writer_gray_h2v2.jpg", encode_jpeg([gray], [(2, 2)])),
        ("writer_ycck_420.jpg", encode_jpeg(
            [cmyk[..., k] for k in range(4)], [(2, 2), (1, 1), (1, 1),
                                               (2, 2)], jfif=False,
            adobe=2)),
        ("writer_adobe_transform_5.jpg", encode_jpeg(
            planes, [(1, 1)] * 3, jfif=False, adobe=5)),
        ("writer_progressive_bands.jpg", encode_jpeg(
            planes, [(2, 2), (1, 1), (1, 1)], bands=[(1, 9), (10, 63)],
            restart=3)),
        # no scan of coefficients 10-63 of the first component:
        # coefficients 1-9 are whole, so libjpeg-turbo does not smooth
        ("writer_progressive_high_band_missing.jpg", drop_scan(encode_jpeg(
            planes, [(2, 2), (1, 1), (1, 1)], bands=[(1, 9), (10, 63)]),
            2)),
    ]
    return cases


def refused_cases():
    """(name, bytes, word the NotImplementedError names)."""
    rng = np.random.RandomState(15)
    img = seeded_image(rng, 24, 24)
    base = pil_jpeg(img, quality=90)
    planes = [img[..., k] for k in range(3)]
    return [
        ("refused_progressive_last_scan_missing.jpg",
         drop_scan(pil_jpeg(img, quality=90, progressive=True), -1),
         "block smoothing"),
        ("refused_arithmetic.jpg", patched_sof(base, marker=0xC9),
         "arithmetic"),
        ("refused_lossless.jpg", patched_sof(base, marker=0xC3), "lossless"),
        ("refused_hierarchical.jpg", patched_sof(base, marker=0xC5),
         "hierarchical"),
        ("refused_12bit.jpg", patched_sof(base, precision=12), "12-bit"),
        ("refused_2_components.jpg", encode_jpeg(planes[:2], [(1, 1)] * 2),
         "2 components"),
        ("refused_fractional_sampling.jpg", encode_jpeg(
            planes, [(3, 1), (2, 1), (1, 1)]), "fractional"),
        ("refused_mcu_of_11_blocks.jpg", encode_jpeg(
            planes, [(3, 3), (1, 1), (1, 1)]), "more than 10 blocks"),
    ]


def png_cases():
    """(name, bytes) of every PNG mode: bit depths, Adam7, tRNS."""
    cases = []
    seed = 100
    for color, depths in ((0, (1, 2, 4, 8, 16)), (2, (8, 16)),
                          (3, (1, 2, 4, 8)), (4, (8, 16)), (6, (8, 16))):
        for depth in depths:
            for interlace in (0, 1):
                seed += 1
                h, w = (19, 27) if interlace else (5, 3)
                trns = color in (0, 2, 3) and depth != 16 and not interlace
                name = (f"png_c{color}_d{depth}"
                        f"{'_adam7' if interlace else ''}"
                        f"{'_trns' if trns else ''}.png")
                cases.append((name, seeded_png(seed, h, w, depth, color,
                                               interlace, trns)))
    # Adam7 at sizes with empty passes
    for h, w in ((1, 1), (2, 3), (3, 2)):
        seed += 1
        cases.append((f"png_c2_d8_adam7_{h}x{w}.png",
                      seeded_png(seed, h, w, 8, 2, 1)))
    return cases


# --------------------------------------------------------------- scenes

SCENE_CATEGORIES = [{"id": 1, "name": "person"}, {"id": 3, "name": "car"},
                    {"id": 18, "name": "dog"}, {"id": 44, "name": "bottle"}]


def scene(seed: int, h: int = 480, w: int = 640):
    """A COCO-sized synthetic photo: a graded background with texture and
    a few filled rectangles and ellipses of COCO categories. Returns
    (RGB uint8 [h, w, 3], annotations without ids)."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    bg = np.stack([90 + 60 * np.sin(yy / 57 + seed), 120 + 50 * np.cos(
        xx / 83), 100 + 40 * np.sin((xx + yy) / 131)], -1)
    bg += rng.normal(0, 6, bg.shape)
    anns = []
    for k in range(6):
        bh, bw = rng.randint(60, 200), rng.randint(60, 220)
        y1, x1 = rng.randint(0, h - bh), rng.randint(0, w - bw)
        color = rng.randint(20, 236, 3)
        cat = SCENE_CATEGORIES[k % len(SCENE_CATEGORIES)]["id"]
        if k % 2:
            cy, cx = y1 + bh / 2, x1 + bw / 2
            inside = ((yy - cy) / (bh / 2)) ** 2 + ((xx - cx) / (bw / 2)) ** 2
            mask = inside <= 1
            t = np.linspace(0, 2 * np.pi, 24, endpoint=False)
            poly = np.stack([cx + bw / 2 * np.cos(t), cy + bh / 2 * np.sin(t)],
                            1).reshape(-1)
        else:
            mask = (yy >= y1) & (yy < y1 + bh) & (xx >= x1) & (xx < x1 + bw)
            poly = np.array([x1, y1, x1 + bw, y1, x1 + bw, y1 + bh, x1,
                             y1 + bh], np.float64)
        bg[mask] = color + rng.normal(0, 10, (int(mask.sum()), 3))
        anns.append({"category_id": cat, "iscrowd": 0,
                     "bbox": [float(x1), float(y1), float(bw), float(bh)],
                     "area": float(mask.sum()),
                     "segmentation": [[round(float(v), 2) for v in poly]]})
    return np.clip(bg, 0, 255).astype(np.uint8), anns


def scene_cases():
    """(name, bytes, annotations) of the three 640x480 scenes."""
    out = []
    for name, seed, kw in (
            ("scene_baseline_420.jpg", 1, dict(quality=85)),
            ("scene_baseline_444.jpg", 2, dict(quality=80,
                                                subsampling="4:4:4")),
            ("scene_progressive.jpg", 3, dict(quality=85,
                                               progressive=True))):
        img, anns = scene(seed)
        out.append((name, pil_jpeg(img, **kw), anns))
    return out


def pillow_digest(data: bytes):
    from PIL import Image
    img = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    return list(img.shape[:2]), hashlib.sha256(img.tobytes()).hexdigest()


def time_pillow(reps: int = 5) -> None:
    """Pillow's `np.asarray(Image.open(f).convert("RGB"))` of the files
    tools/image_decode_bench_torch.py times, host ms, median of reps."""
    from PIL import Image

    from tools import image_decode_bench_torch as bench
    for name in bench.TIMED:
        data = (bench.REPO / name).read_bytes()
        ms = bench.median_ms(lambda: np.asarray(Image.open(io.BytesIO(
            data)).convert("RGB")), reps)
        print(f"{name}: pillow_ms {ms:.2f}", flush=True)


def main() -> int:
    if "--time-pillow" in sys.argv[1:]:
        time_pillow()
        return 0
    CORPUS.mkdir(parents=True, exist_ok=True)
    index = {"files": {}, "refused": {}, "scenes": {}}
    for name, data in jpeg_cases() + png_cases():
        (CORPUS / name).write_bytes(data)
        shape, digest = pillow_digest(data)
        index["files"][name] = {"shape": shape, "sha256": digest}
    for name, data, word in refused_cases():
        (CORPUS / name).write_bytes(data)
        index["refused"][name] = word
    for name, data, anns in scene_cases():
        (CORPUS / name).write_bytes(data)
        shape, digest = pillow_digest(data)
        index["files"][name] = {"shape": shape, "sha256": digest}
        index["scenes"][name] = anns
    index["categories"] = SCENE_CATEGORIES
    INDEX.write_text(json.dumps(index, indent=1) + "\n")
    size = sum(p.stat().st_size for p in CORPUS.iterdir())
    print(f"{len(list(CORPUS.iterdir()))} files, {size} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
