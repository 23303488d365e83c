#!/usr/bin/env python3
"""Host image decode of the PyTorch/CUDA port, timed: the native decoder
(`read_image`, csrc/image_decode.cpp) beside the plain Python route
(`read_image(..., plain=True)`); decodes a second of the committed
corpus's two baseline 640x480 scenes (tests/data/image_io) on 1 and 4
threads, each route, which shows whether a decode leaves the GIL; and
`data/pipeline.BatchLoader` images a second with 1 and 4 worker threads
over a COCO directory of the corpus's three scenes (a whole training
sample: decode, resample, masks).

    python3 tools/image_decode_bench_torch.py [--reps 5] [--copies 8]
                                              [--json-out F]

Times are host milliseconds, median of `--reps` decodes of the file's
bytes (Pillow's, where it is installed: `python tests/image_corpus.py
--time-pillow`). chip_smoke.py's phase 9a runs the same functions on the
card's host.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

REPO = Path(__file__).resolve().parent.parent
CORPUS = REPO / "tests" / "data" / "image_io"
TIMED = ("images/sample.jpg", "output/detections.jpg",
         "tests/data/image_io/scene_progressive.jpg")


def corpus_index() -> dict:
    return json.loads((CORPUS / "index.json").read_text())


def coco_scene_dir(root: Path, copies: int) -> str:
    """A COCO directory (minival 2014 names) of the corpus's scenes, each
    `copies` times, with their annotations. Returns the directory."""
    index = corpus_index()
    root = Path(root) / "coco"
    (root / "annotations").mkdir(parents=True, exist_ok=True)
    (root / "val2014").mkdir(exist_ok=True)
    images, anns = [], []
    for k in range(copies):
        for name, scene_anns in index["scenes"].items():
            i = len(images) + 1
            h, w = index["files"][name]["shape"]
            file_name = f"COCO_val2014_{i:012d}{Path(name).suffix}"
            shutil.copyfile(CORPUS / name, root / "val2014" / file_name)
            images.append({"id": i, "height": h, "width": w,
                           "file_name": file_name, "source": name})
            for a in scene_anns:
                anns.append(dict(a, id=len(anns) + 1, image_id=i))
    with open(root / "annotations" / "instances_minival2014.json", "w") as f:
        json.dump({"images": images, "annotations": anns,
                   "categories": index["categories"]}, f)
    return str(root)


def median_ms(fn, reps: int) -> float:
    runs = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        runs.append((time.perf_counter() - t) * 1e3)
    return statistics.median(runs)


def decode_times(reps: int = 5) -> dict:
    """{file: {"native_ms", "plain_ms" (None where the plain route refuses
    the file)}}, medians of `reps`."""
    from maskrcnn_tpu_torch.data import image_io
    out = {}
    for name in TIMED:
        data = (REPO / name).read_bytes()
        image_io.read_image(data)                       # the build, once
        row = {"native_ms": median_ms(lambda: image_io.read_image(data),
                                      reps)}
        try:
            image_io.read_image(data, plain=True)
            row["plain_ms"] = median_ms(
                lambda: image_io.read_image(data, plain=True), reps)
        except NotImplementedError:
            row["plain_ms"] = None
        out[name] = row
    return out


def decode_rates(decodes: int = 48) -> dict:
    """{route: {threads: decodes a second}}: `decodes` decodes (a quarter
    of them on the plain route) of the two baseline scenes, spread over
    1 and 4 threads."""
    from concurrent.futures import ThreadPoolExecutor

    from maskrcnn_tpu_torch.data import image_io
    data = [(CORPUS / n).read_bytes()
            for n in ("scene_baseline_420.jpg", "scene_baseline_444.jpg")]
    out = {}
    for route in ("native", "plain"):
        n = decodes if route == "native" else decodes // 4

        def decode(i, plain=route == "plain"):
            return image_io.read_image(data[i % 2], plain=plain)

        out[route] = {}
        for threads in (1, 4):
            with ThreadPoolExecutor(threads) as pool:
                list(pool.map(decode, range(threads)))
                t = time.perf_counter()
                list(pool.map(decode, range(n)))
                out[route][threads] = n / (time.perf_counter() - t)
    return out


def loader_rate(root: str, workers: int, samples: int = 96,
                warmup: int = 8) -> float:
    """BatchLoader images a second over the COCO directory at `root`
    (CocoConfig: 1024² canvas, batch 4): samples pulled after `warmup`
    over the seconds they took."""
    from maskrcnn_tpu_torch.config import CocoConfig
    from maskrcnn_tpu_torch.data.coco import CocoDataset
    from maskrcnn_tpu_torch.data.pipeline import BatchLoader
    cfg = CocoConfig()
    ds = CocoDataset(root, "minival", 2014, cfg)
    batch = 4
    loader = BatchLoader(ds, batch, num_workers=workers, prefetch=2, seed=0)
    try:
        for _ in range(warmup // batch):
            next(loader)
        t = time.perf_counter()
        for _ in range(samples // batch):
            next(loader)
        return samples / (time.perf_counter() - t)
    finally:
        loader.close()


def loader_rates(copies: int = 8) -> dict:
    """{workers: images/s} for 1 and 4 workers."""
    with tempfile.TemporaryDirectory() as tmp:
        root = coco_scene_dir(Path(tmp), copies)
        return {w: loader_rate(root, w) for w in (1, 4)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--copies", type=int, default=8)
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)
    times = decode_times(args.reps)
    for name, row in times.items():
        print(f"{name}: " + ", ".join(
            f"{k} {v:.2f}" if v is not None else f"{k} refused"
            for k, v in row.items()), flush=True)
    threads = decode_rates()
    for route, row in threads.items():
        print(f"{route} decodes of the baseline scenes: 1 thread "
              f"{row[1]:.1f}/s, 4 threads {row[4]:.1f}/s "
              f"({row[4] / row[1]:.2f}x)", flush=True)
    rates = loader_rates(args.copies)
    print(f"BatchLoader over the corpus scenes: 1 worker {rates[1]:.1f} "
          f"img/s, 4 workers {rates[4]:.1f} img/s "
          f"({rates[4] / rates[1]:.2f}x)", flush=True)
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump({"decode_ms": times, "decode_threads": threads,
                       "loader_img_s": rates, "reps": args.reps}, f,
                      indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
