"""The port's COCO evaluation stack (maskrcnn_tpu_torch/eval) against the
JAX package's: every RLE function on seeded masks and polygons on both
routes (native library and numpy), the annotation index and `loadRes`,
COCOeval's 12 stats for bbox and segm, and `build_coco_results`."""

import numpy as np
import pytest

from maskrcnn_tpu.eval import native as jax_native
from maskrcnn_tpu.eval import rle as jax_rle
from maskrcnn_tpu.eval.coco_index import COCO as JaxCOCO
from maskrcnn_tpu.eval.cocoeval import COCOeval as JaxCOCOeval
from maskrcnn_tpu.eval.evaluate import build_coco_results as jax_results
from maskrcnn_tpu_torch.eval import native as port_native
from maskrcnn_tpu_torch.eval import rle as port_rle
from maskrcnn_tpu_torch.eval.coco_index import COCO as PortCOCO
from maskrcnn_tpu_torch.eval.cocoeval import COCOeval as PortCOCOeval
from maskrcnn_tpu_torch.eval.evaluate import build_coco_results


@pytest.fixture(params=["native", "numpy"])
def route(request, monkeypatch):
    """Both packages on the native library or both on numpy."""
    if request.param == "numpy":
        monkeypatch.setattr(port_native, "_load", lambda: None)
        monkeypatch.setattr(jax_native, "_load", lambda: None)
    assert port_native.available() == (request.param == "native")
    return request.param


def _masks(rng):
    """Blobs, noise, a full and an empty mask, of several shapes."""
    out = []
    for h, w in ((37, 23), (64, 64), (5, 80), (1, 1)):
        m = np.zeros((h, w), np.uint8)
        y, x = rng.randint(0, h), rng.randint(0, w)
        m[y:y + rng.randint(1, h + 1), x:x + rng.randint(1, w + 1)] = 1
        out += [m, (rng.rand(h, w) > 0.6).astype(np.uint8),
                np.ones((h, w), np.uint8), np.zeros((h, w), np.uint8)]
    return out


def _polygons(rng, h, w):
    """Random polygons, some reaching outside the canvas."""
    polys = []
    for k in (3, 4, 7, 12):
        ctr = rng.rand(2) * [w, h]
        ang = np.sort(rng.rand(k)) * 2 * np.pi
        rad = rng.rand(k) * max(h, w) * 0.6 + 1
        xy = np.stack([ctr[0] + rad * np.cos(ang),
                       ctr[1] + rad * np.sin(ang)], 1)
        polys.append([float(v) for v in xy.reshape(-1)])
    return polys


def test_rle_functions_equal_jax(route):
    """encode, decode, area, to_bbox, merge, the string codec, polygons,
    boxes, fr_py_objects and iou (masks with crowd, boxes): equal output,
    the native or the numpy route on both sides."""
    rng = np.random.RandomState(0)
    masks = _masks(rng)
    rles = []
    for m in masks:
        got, want = port_rle.encode(m), jax_rle.encode(m)
        assert got == want
        rles.append(got)
        np.testing.assert_array_equal(port_rle.decode(got), m)
        np.testing.assert_array_equal(port_rle.decode(got),
                                      jax_rle.decode(want))
        assert port_rle.area(got) == jax_rle.area(want) == m.sum()
        np.testing.assert_array_equal(port_rle.to_bbox(got),
                                      jax_rle.to_bbox(want))
        counts = port_rle._rle_counts(got)
        assert port_rle._counts_to_string(counts) == got["counts"]
    same = [r for r in rles if r["size"] == [64, 64]]
    for intersect in (False, True):
        assert (port_rle.merge(same, intersect)
                == jax_rle.merge(same, intersect))
    h, w = 48, 60
    for poly in _polygons(rng, h, w):
        assert port_rle.poly_to_rle(poly, h, w) == jax_rle.poly_to_rle(
            poly, h, w)
    bb = [3.5, 7.25, 20.0, 11.5]
    assert port_rle.bbox_to_rle(bb, h, w) == jax_rle.bbox_to_rle(bb, h, w)
    uncompressed = {"size": [h, w],
                    "counts": [int(v) for v in rng.randint(1, 40, 30)]}
    for obj in (_polygons(rng, h, w), uncompressed, bb,
                _polygons(rng, h, w)[0]):
        assert (port_rle.fr_py_objects(obj, h, w)
                == jax_rle.fr_py_objects(obj, h, w))
    crowd = [0, 1, 0, 0]
    np.testing.assert_array_equal(port_rle.iou(same, same, crowd),
                                  jax_rle.iou(same, same, crowd))
    dt = rng.rand(5, 4) * 40
    gt = rng.rand(3, 4) * 40
    np.testing.assert_array_equal(port_rle.iou(dt, gt, [0, 1, 0]),
                                  jax_rle.iou(dt, gt, [0, 1, 0]))


def _gt_dataset(rng, n_images=5):
    """Images of two categories: polygon, compressed-RLE and crowd
    annotations, small to large."""
    images, anns = [], []
    aid = 1
    for i in range(1, n_images + 1):
        h, w = 120 + 10 * i, 160
        images.append({"id": i, "height": h, "width": w,
                       "file_name": f"{i}.jpg"})
        for j in range(3):
            x, y = rng.randint(0, w - 60), rng.randint(0, h - 60)
            bw, bh = rng.randint(4, 60), rng.randint(4, 60)
            if j == 1:
                m = np.zeros((h, w), np.uint8)
                m[y:y + bh, x:x + bw] = 1
                seg = jax_rle.encode(m)
                seg["counts"] = seg["counts"].decode("ascii")
            else:
                seg = [[x, y, x + bw, y, x + bw, y + bh, x, y + bh]]
            anns.append({"id": aid, "image_id": i, "category_id": 1 + j % 2,
                         "bbox": [x, y, bw, bh], "area": bw * bh,
                         "iscrowd": int(j == 2 and i % 2 == 0),
                         "segmentation": seg})
            aid += 1
    return {"images": images, "annotations": anns,
            "categories": [{"id": 1, "name": "a"}, {"id": 2, "name": "b"}]}


def _results(rng, gt):
    """Jittered copies of most annotations, a few misses and false
    positives, random scores; masks as compressed RLE."""
    out = []
    for ann in gt["annotations"]:
        if rng.rand() < 0.2:
            continue
        img = next(i for i in gt["images"] if i["id"] == ann["image_id"])
        x, y, bw, bh = (np.asarray(ann["bbox"], float)
                        + rng.randn(4) * [2, 2, 3, 3])
        m = np.zeros((img["height"], img["width"]), np.uint8)
        m[max(int(y), 0):int(y + bh), max(int(x), 0):int(x + bw)] = 1
        seg = jax_rle.encode(m)
        seg["counts"] = seg["counts"].decode("ascii")
        out.append({"image_id": ann["image_id"],
                    "category_id": ann["category_id"],
                    "bbox": [float(x), float(y), float(bw), float(bh)],
                    "score": float(rng.rand()), "segmentation": seg})
    for i in (1, 3):
        m = np.zeros((120 + 10 * i, 160), np.uint8)
        m[5:25, 100:150] = 1
        seg = jax_rle.encode(m)
        seg["counts"] = seg["counts"].decode("ascii")
        out.append({"image_id": i, "category_id": 2,
                    "bbox": [100.0, 5.0, 50.0, 20.0], "score": 0.97,
                    "segmentation": seg})
    return out


def test_coco_index_and_load_res_equal_jax():
    """The index's queries, annToMask and loadRes's computed boxes and
    areas are those of the JAX package's COCO."""
    rng = np.random.RandomState(1)
    data = _gt_dataset(rng)
    port, ref = PortCOCO(data), JaxCOCO(data)
    assert port.getImgIds() == ref.getImgIds()
    assert port.getCatIds(catNms=["b"]) == ref.getCatIds(catNms=["b"])
    for kw in ({}, {"imgIds": [2, 3]}, {"catIds": [2]},
               {"areaRng": [0, 900]}, {"iscrowd": 0}):
        assert port.getAnnIds(**kw) == ref.getAnnIds(**kw), kw
    assert sorted(port.getImgIds(catIds=[1])) == sorted(
        ref.getImgIds(catIds=[1]))
    for ann in data["annotations"]:
        np.testing.assert_array_equal(port.annToMask(ann),
                                      ref.annToMask(ann))
    results = _results(rng, data)
    for r in results[:3]:  # box from the mask, and area from the mask
        del r["bbox"]
    got, want = port.loadRes(results), ref.loadRes(results)
    assert got.dataset["annotations"] == want.dataset["annotations"]
    assert got.getAnnIds(imgIds=[1]) == want.getAnnIds(imgIds=[1])


@pytest.mark.parametrize("iou_type", ["bbox", "segm"])
def test_cocoeval_stats_equal_jax(iou_type):
    """COCOeval's 12 stats on the same ground truth and results (jittered
    boxes and masks, misses, false positives, crowd regions, two
    categories) equal the JAX package's."""
    rng = np.random.RandomState(2)
    data = _gt_dataset(rng, 6)
    results = _results(rng, data)
    stats = []
    for coco_cls, eval_cls in ((PortCOCO, PortCOCOeval),
                               (JaxCOCO, JaxCOCOeval)):
        gt = coco_cls(data)
        e = eval_cls(gt, gt.loadRes(results), iou_type)
        e.evaluate()
        e.accumulate()
        e.summarize()
        stats.append(np.asarray(e.stats))
    assert stats[0].shape == (12,)
    assert 0.0 < stats[0][0] < 1.0
    np.testing.assert_array_equal(stats[0], stats[1])


class _Dataset:
    @staticmethod
    def class_id(label_id):
        return 10 + label_id


def test_build_coco_results_equal_jax():
    """Result dicts (xywh box rounded to 0.1, compressed RLE as text,
    category through the dataset) equal the JAX package's."""
    rng = np.random.RandomState(3)
    n = 4
    boxes = (rng.rand(n, 4) * 50).astype(np.float32)
    masks = (rng.rand(n, 30, 40) > 0.5).astype(np.uint8)
    args = (_Dataset(), 7, [1, 2, 3, 1], rng.rand(n).tolist(), boxes,
            masks)
    got = build_coco_results(*args)
    assert got == jax_results(*args)
    assert len(got) == n and isinstance(got[0]["segmentation"]["counts"],
                                        str)
