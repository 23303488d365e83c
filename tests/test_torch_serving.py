"""The port's serving layer (maskrcnn_tpu_torch/serving.py and
tools/serve_torch.py): tests/test_serving.py's five cases against the
port's Detector on the CPU, and the batcher's results against
`Detector.detect_batch` on the same images."""

import threading

import numpy as np
import pytest

from maskrcnn_tpu_torch.api import Detector
from maskrcnn_tpu_torch.config import TinyConfig
from maskrcnn_tpu_torch.serving import BatchingDetector, _pad_size

CFG = TinyConfig(DETECTION_MIN_CONFIDENCE=0.0)


@pytest.fixture(scope="module")
def batcher():
    b = BatchingDetector(Detector(CFG, "cpu"), max_batch=4,
                         max_delay_ms=30.0)
    yield b
    b.close()


def _same(a, b):
    """Two detect() results equal: class ids, scores, boxes and masks."""
    if a is None or a[0] is None:
        assert b is None or b[0] is None
        return
    assert a[0] == b[0]
    for x, y in zip(a[1:], b[1:]):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_pad_sizes_are_the_jax_packages():
    assert [_pad_size(n, 8) for n in range(1, 10)] == [1, 2, 4, 4, 8, 8, 8,
                                                        8, 8]


def test_concurrent_requests_are_batched(batcher, rng):
    imgs = [(rng.rand(96, 120, 3) * 255).astype(np.uint8) for _ in range(8)]
    futures = [batcher.submit(im) for im in imgs]
    results = [f.result(timeout=300) for f in futures]
    assert len(results) == 8
    assert all(isinstance(r, tuple) and len(r) == 4 for r in results)
    # 8 concurrent submits at max_batch=4 must not have run 8 batches
    assert batcher.batches_run <= 6
    assert batcher.images_run == 8
    direct = batcher.detector.detect(imgs[0])
    if direct[0] is None:
        assert results[0][0] is None
    else:
        assert results[0][0] == direct[0]
        np.testing.assert_allclose(results[0][1], direct[1], rtol=1e-5)


def test_batch_equals_detect_batch(rng):
    """Four requests that arrive together run as one batch of four, and
    each result equals detect_batch's on the same four images."""
    b = BatchingDetector(Detector(CFG, "cpu"), max_batch=4,
                         max_delay_ms=500.0)
    try:
        imgs = [(rng.rand(80 + 8 * i, 100, 3) * 255).astype(np.uint8)
                for i in range(4)]
        results = [f.result(timeout=300)
                   for f in [b.submit(im) for im in imgs]]
        assert b.batches_run == 1
        for got, want in zip(results, b.detector.detect_batch(imgs)):
            _same(want, got)
    finally:
        b.close()


def test_dispatch_fetch_split_matches_detect_batch(batcher, rng):
    """dispatch_batch + fetch (the pipelined path) equals detect_batch."""
    det = batcher.detector
    imgs = [(rng.rand(90, 110, 3) * 255).astype(np.uint8) for _ in range(2)]
    direct = det.detect_batch(imgs)
    split = det.fetch(det.dispatch_batch(imgs))
    for a, b in zip(direct, split):
        _same(a, b)


def test_pipeline_sustains_many_batches(batcher, rng):
    """More batches than the 2-deep pipeline holds at once: every future
    resolves, none deadlock."""
    imgs = [(rng.rand(64, 80, 3) * 255).astype(np.uint8) for _ in range(12)]
    results = [f.result(timeout=300) for f in [batcher.submit(im)
                                               for im in imgs]]
    assert all(isinstance(r, tuple) and len(r) == 4 for r in results)


def test_close_resolves_everything():
    b = BatchingDetector(Detector(CFG, "cpu"), max_batch=2,
                         max_delay_ms=1.0)
    img = np.zeros((64, 80, 3), np.uint8)
    futs = [b.submit(img) for _ in range(4)]
    b.close()
    assert not b._worker.is_alive() and not b._fetcher.is_alive()
    for f in futs:
        try:
            f.result(timeout=60)  # either a real result...
        except RuntimeError:      # ...or the explicit closed error
            pass
    with pytest.raises(RuntimeError):
        b.submit(img).result(timeout=10)


def test_http_server_roundtrip(rng):
    """tools/serve_torch.py's handler through a real socket."""
    import io
    import json
    import urllib.request
    from http.server import ThreadingHTTPServer

    from PIL import Image

    import tools.serve_torch as serve
    from maskrcnn_tpu_torch.data.coco import COCO_CLASS_NAMES
    from maskrcnn_tpu_torch.eval import rle

    det = serve.build_detector(serve.parse_args(["--tiny"]))
    assert det.device.type == "cpu"
    b = BatchingDetector(det, max_batch=2, max_delay_ms=5.0)
    server = ThreadingHTTPServer(
        ("127.0.0.1", 0), serve.make_handler(b, COCO_CLASS_NAMES))
    port = server.server_address[1]
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/healthz", timeout=30) as r:
            assert json.load(r)["ok"] is True
        img = (rng.rand(80, 100, 3) * 255).astype(np.uint8)
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, "PNG")
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/detect", data=buf.getvalue(),
            method="POST")
        with urllib.request.urlopen(req, timeout=600) as r:
            out = json.load(r)
        want = det.detect(img)
        assert len(out["detections"]) == len(want[0] or [])
        for i, d in enumerate(out["detections"]):
            assert set(d) == {"class_id", "class_name", "score", "box",
                              "mask_rle"}
            assert d["class_id"] == want[0][i]
            assert d["class_name"] == COCO_CLASS_NAMES[want[0][i]]
            m = rle.decode({"size": d["mask_rle"]["size"],
                            "counts": d["mask_rle"]["counts"].encode()})
            np.testing.assert_array_equal(m, np.asarray(want[3][i],
                                                        np.uint8))
    finally:
        server.shutdown()
        server.server_close()
        b.close()
    t.join(timeout=10)
    assert not t.is_alive()
