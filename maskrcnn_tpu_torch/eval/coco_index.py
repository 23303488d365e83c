"""Minimal COCO annotation index — pycocotools.coco.COCO surface.

A copy of maskrcnn_tpu/eval/coco_index.py, held equal to it by
tests/test_torch_eval.py.

The environment ships no pycocotools; this is a standalone numpy/json
implementation of the subset the framework uses (the reference vendors
the original at cocoapi/PythonAPI/pycocotools/coco.py; SURVEY.md
section 2.1 maps its API): index build, id queries, loadRes for result
dicts, and ann->RLE/mask conversion through our RLE codec.
"""

from __future__ import annotations

import copy
import json
import time
from collections import defaultdict
from typing import Dict, List, Optional, Union

import numpy as np

from maskrcnn_tpu_torch.eval import rle as rle_lib


class COCO:
    """Annotation database with the pycocotools query surface."""

    def __init__(self, annotation_file: Optional[Union[str, dict]] = None):
        self.dataset: Dict = {}
        self.anns: Dict[int, dict] = {}
        self.imgs: Dict[int, dict] = {}
        self.cats: Dict[int, dict] = {}
        self.imgToAnns: Dict[int, List[dict]] = defaultdict(list)
        self.catToImgs: Dict[int, List[int]] = defaultdict(list)
        if annotation_file is not None:
            if isinstance(annotation_file, str):
                t0 = time.time()
                with open(annotation_file) as f:
                    self.dataset = json.load(f)
                print(f"loaded annotations in {time.time() - t0:.2f}s")
            else:
                self.dataset = annotation_file
            self.createIndex()

    def createIndex(self):
        self.anns.clear()
        self.imgs.clear()
        self.cats.clear()
        self.imgToAnns = defaultdict(list)
        self.catToImgs = defaultdict(list)
        for ann in self.dataset.get("annotations", []):
            self.imgToAnns[ann["image_id"]].append(ann)
            self.anns[ann["id"]] = ann
        for img in self.dataset.get("images", []):
            self.imgs[img["id"]] = img
        for cat in self.dataset.get("categories", []):
            self.cats[cat["id"]] = cat
        for ann in self.dataset.get("annotations", []):
            if "category_id" in ann:
                self.catToImgs[ann["category_id"]].append(ann["image_id"])

    # -------------------------------------------------------- queries --
    def getAnnIds(self, imgIds=None, catIds=None, areaRng=None,
                  iscrowd=None) -> List[int]:
        imgIds = _as_list(imgIds)
        catIds = _as_list(catIds)
        if imgIds:
            anns: List[dict] = []
            for i in imgIds:
                anns.extend(self.imgToAnns.get(i, []))
        else:
            anns = list(self.dataset.get("annotations", []))
        if catIds:
            cat_set = set(catIds)
            anns = [a for a in anns if a["category_id"] in cat_set]
        if areaRng:
            anns = [a for a in anns
                    if areaRng[0] < a["area"] < areaRng[1]]
        if iscrowd is not None:
            anns = [a for a in anns if a.get("iscrowd", 0) == iscrowd]
        return [a["id"] for a in anns]

    def getCatIds(self, catNms=None, supNms=None, catIds=None) -> List[int]:
        cats = list(self.dataset.get("categories", []))
        for key, vals in (("name", _as_list(catNms)),
                          ("supercategory", _as_list(supNms)),
                          ("id", _as_list(catIds))):
            if vals:
                cats = [c for c in cats if c.get(key) in set(vals)]
        return [c["id"] for c in cats]

    def getImgIds(self, imgIds=None, catIds=None) -> List[int]:
        imgIds = _as_list(imgIds)
        catIds = _as_list(catIds)
        if not imgIds and not catIds:
            return list(self.imgs.keys())
        ids = set(imgIds) if imgIds else None
        for i, cat in enumerate(catIds):
            imgs_c = set(self.catToImgs.get(cat, []))
            ids = imgs_c if ids is None else (
                ids & imgs_c if i > 0 or imgIds else ids & imgs_c)
        return list(ids if ids is not None else self.imgs.keys())

    def loadAnns(self, ids=None) -> List[dict]:
        return [self.anns[i] for i in _as_list(ids)]

    def loadCats(self, ids=None) -> List[dict]:
        return [self.cats[i] for i in _as_list(ids)]

    def loadImgs(self, ids=None) -> List[dict]:
        return [self.imgs[i] for i in _as_list(ids)]

    # -------------------------------------------------------- results --
    def loadRes(self, resFile) -> "COCO":
        """Result list/file -> a new COCO with computed areas/boxes
        (pycocotools coco.py:297 semantics for box and segm results)."""
        res = COCO()
        res.dataset["images"] = [img for img in
                                 self.dataset.get("images", [])]
        if isinstance(resFile, str):
            with open(resFile) as f:
                anns = json.load(f)
        else:
            anns = copy.deepcopy(list(resFile))
        assert isinstance(anns, list)
        if len(anns):
            img_ids = set(self.getImgIds())
            assert set(a["image_id"] for a in anns) <= img_ids, \
                "results reference unknown images"
        res.dataset["categories"] = copy.deepcopy(
            self.dataset.get("categories", []))
        for aid, ann in enumerate(anns):
            if "keypoints" in ann and "bbox" not in ann:
                # keypoint results: bbox/area from the keypoint extent
                # (pycocotools coco.py loadRes keypoints branch)
                s = ann["keypoints"]
                x, y = s[0::3], s[1::3]
                x0, x1, y0, y1 = min(x), max(x), min(y), max(y)
                ann["bbox"] = [x0, y0, x1 - x0, y1 - y0]
                ann["area"] = (x1 - x0) * (y1 - y0)
            if "segmentation" in ann and "bbox" not in ann:
                ann["bbox"] = rle_lib.to_bbox(ann["segmentation"]).tolist()
            if "bbox" in ann and "area" not in ann:
                if "segmentation" in ann and isinstance(
                        ann["segmentation"], dict):
                    ann["area"] = rle_lib.area(ann["segmentation"])
                else:
                    bb = ann["bbox"]
                    ann["area"] = bb[2] * bb[3]
            ann["id"] = aid + 1
            ann.setdefault("iscrowd", 0)
        res.dataset["annotations"] = anns
        res.createIndex()
        return res

    # ----------------------------------------------------- mask utils --
    def annToRLE(self, ann) -> dict:
        """Polygon / uncompressed / compressed segmentation -> RLE
        (pycocotools coco.py:406)."""
        img = self.imgs[ann["image_id"]]
        h, w = img["height"], img["width"]
        segm = ann["segmentation"]
        if isinstance(segm, list):
            rles = [rle_lib.poly_to_rle(p, h, w) for p in segm]
            return rle_lib.merge(rles)
        if isinstance(segm["counts"], list):
            return rle_lib.fr_py_objects(segm, h, w)
        return segm

    def annToMask(self, ann) -> np.ndarray:
        return rle_lib.decode(self.annToRLE(ann))


def _as_list(x) -> list:
    if x is None:
        return []
    if isinstance(x, (list, tuple, set, np.ndarray)):
        return list(x)
    return [x]
