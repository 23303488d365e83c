"""COCO detection/segmentation evaluation — standalone implementation.

A copy of maskrcnn_tpu/eval/cocoeval.py, held equal to it by
tests/test_torch_eval.py.

Reimplements the published COCOeval protocol (the reference vendors the
original at cocoapi/PythonAPI/pycocotools/cocoeval.py; SURVEY.md section
2.1): greedy score-ordered matching per IoU threshold with crowd-aware
ignore handling, 101-point interpolated precision, and the 12-line
AP/AR summary. Numbers produced here are the regression gate for parity
with the reference's published mask AP 0.317 (README.md:38-55).
"""

from __future__ import annotations

import copy
import time
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np

from maskrcnn_tpu_torch.eval import rle as rle_lib


class Params:
    """Evaluation protocol constants (cocoeval.py:499-533 equivalents)."""

    # COCO per-keypoint OKS falloff constants (pycocotools
    # cocoeval.py kpt_oks_sigmas; the 17 person keypoints)
    KPT_OKS_SIGMAS = np.array([
        .26, .25, .25, .35, .35, .79, .79, .72, .72, .62, .62,
        1.07, 1.07, .87, .87, .89, .89]) / 10.0

    def __init__(self, iouType: str = "segm"):
        self.imgIds: List[int] = []
        self.catIds: List[int] = []
        self.iouThrs = np.linspace(0.5, 0.95, 10)
        self.recThrs = np.linspace(0.0, 1.0, 101)
        self.useCats = 1
        self.iouType = iouType
        if iouType == "keypoints":
            # keypoint protocol (pycocotools setKpParams): 20 dets,
            # no "small" bucket, per-keypoint OKS sigmas
            self.maxDets = [20]
            self.areaRng = [[0.0, 1e10], [32.0 ** 2, 96.0 ** 2],
                            [96.0 ** 2, 1e10]]
            self.areaRngLbl = ["all", "medium", "large"]
            self.kpt_oks_sigmas = self.KPT_OKS_SIGMAS.copy()
        else:
            self.maxDets = [1, 10, 100]
            self.areaRng = [[0.0, 1e10], [0.0, 32.0 ** 2],
                            [32.0 ** 2, 96.0 ** 2], [96.0 ** 2, 1e10]]
            self.areaRngLbl = ["all", "small", "medium", "large"]


class COCOeval:
    """Evaluate detection results against a COCO ground-truth index."""

    def __init__(self, cocoGt=None, cocoDt=None, iouType: str = "segm"):
        self.cocoGt = cocoGt
        self.cocoDt = cocoDt
        self.params = Params(iouType)
        self.evalImgs: Dict = {}
        self.eval: Dict = {}
        self.stats = np.zeros(12)
        self.ious: Dict = {}
        self._gts = defaultdict(list)
        self._dts = defaultdict(list)
        if cocoGt is not None:
            self.params.imgIds = sorted(cocoGt.getImgIds())
            self.params.catIds = sorted(cocoGt.getCatIds())

    # ------------------------------------------------------- prepare --
    def _prepare(self):
        p = self.params
        gts = self.cocoGt.loadAnns(self.cocoGt.getAnnIds(
            imgIds=p.imgIds, catIds=p.catIds if p.useCats else None))
        dts = self.cocoDt.loadAnns(self.cocoDt.getAnnIds(
            imgIds=p.imgIds, catIds=p.catIds if p.useCats else None))
        gts = copy.deepcopy(gts)
        self._gts = defaultdict(list)
        self._dts = defaultdict(list)
        for gt in gts:
            gt["ignore"] = gt.get("ignore", 0) or gt.get("iscrowd", 0)
            if p.iouType == "keypoints":
                # gts with no labeled keypoints are ignore regions
                # (pycocotools cocoeval.py:111-112)
                gt["ignore"] = (gt.get("num_keypoints", 0) == 0) \
                    or gt["ignore"]
            self._gts[gt["image_id"], gt["category_id"]].append(gt)
        for dt in dts:
            self._dts[dt["image_id"], dt["category_id"]].append(dt)

    # ---------------------------------------------------------- IoU --
    def computeIoU(self, imgId, catId) -> np.ndarray:
        p = self.params
        if p.iouType == "keypoints":
            return self.computeOks(imgId, catId)
        gt = self._gts[imgId, catId]
        dt = self._dts[imgId, catId]
        if len(gt) == 0 or len(dt) == 0:
            return np.zeros((0, 0))
        dt = sorted(dt, key=lambda d: -d["score"])[:p.maxDets[-1]]
        if p.iouType == "segm":
            g = [self.cocoGt.annToRLE(o) for o in gt]
            d = [o["segmentation"] for o in dt]
        else:
            g = [o["bbox"] for o in gt]
            d = [o["bbox"] for o in dt]
        iscrowd = [int(o.get("iscrowd", 0)) for o in gt]
        return rle_lib.iou(d, g, iscrowd)  # [D, G]

    def computeOks(self, imgId, catId) -> np.ndarray:
        """Object Keypoint Similarity matrix [D, G] (pycocotools
        cocoeval.py computeOks): per-keypoint gaussians with the COCO
        falloff sigmas, normalised by sqrt(gt area); gts with no
        labeled keypoints score dts by distance outside the 2x-expanded
        gt box instead."""
        p = self.params
        gts = self._gts[imgId, catId]
        dts = sorted(self._dts[imgId, catId],
                     key=lambda d: -d["score"])[:p.maxDets[-1]]
        if len(gts) == 0 or len(dts) == 0:
            return np.zeros((0, 0))
        sigmas = p.kpt_oks_sigmas
        var = (sigmas * 2.0) ** 2
        k = len(sigmas)
        ious = np.zeros((len(dts), len(gts)))
        for j, gt in enumerate(gts):
            g = np.array(gt["keypoints"], np.float64)
            xg, yg, vg = g[0::3], g[1::3], g[2::3]
            k1 = np.count_nonzero(vg > 0)
            bb = gt["bbox"]
            x0, x1 = bb[0] - bb[2], bb[0] + bb[2] * 2
            y0, y1 = bb[1] - bb[3], bb[1] + bb[3] * 2
            for i, dt in enumerate(dts):
                d = np.array(dt["keypoints"], np.float64)
                xd, yd = d[0::3], d[1::3]
                if k1 > 0:
                    dx, dy = xd - xg, yd - yg
                else:
                    # dt keypoints vs the expanded gt box
                    z = np.zeros((k,))
                    dx = np.maximum(z, x0 - xd) + np.maximum(z, xd - x1)
                    dy = np.maximum(z, y0 - yd) + np.maximum(z, yd - y1)
                e = ((dx ** 2 + dy ** 2) / var
                     / (gt["area"] + np.spacing(1)) / 2.0)
                if k1 > 0:
                    e = e[vg > 0]
                ious[i, j] = np.sum(np.exp(-e)) / e.shape[0]
        return ious

    # ------------------------------------------------------ matching --
    def evaluateImg(self, imgId, catId, aRng, maxDet) -> Optional[dict]:
        gt = self._gts[imgId, catId]
        dt = self._dts[imgId, catId]
        if len(gt) == 0 and len(dt) == 0:
            return None
        p = self.params
        for g in gt:
            g["_ignore"] = 1 if (g["ignore"] or g["area"] < aRng[0]
                                 or g["area"] > aRng[1]) else 0
        gtind = np.argsort([g["_ignore"] for g in gt], kind="mergesort")
        gt = [gt[i] for i in gtind]
        dtind = np.argsort([-d["score"] for d in dt], kind="mergesort")
        dt = [dt[i] for i in dtind[:maxDet]]
        iscrowd = [int(g.get("iscrowd", 0)) for g in gt]
        ious = (self.ious[imgId, catId][:, gtind]
                if len(self.ious[imgId, catId]) > 0
                else self.ious[imgId, catId])

        T = len(p.iouThrs)
        G = len(gt)
        D = len(dt)
        gtm = np.zeros((T, G))
        dtm = np.zeros((T, D))
        gtIg = np.array([g["_ignore"] for g in gt])
        dtIg = np.zeros((T, D))
        if len(ious) > 0:
            for tind, t in enumerate(p.iouThrs):
                for dind, d in enumerate(dt):
                    best_iou = min([t, 1.0 - 1e-10])
                    m = -1
                    for gind in range(G):
                        # gt already matched (crowd may match many)
                        if gtm[tind, gind] > 0 and not iscrowd[gind]:
                            continue
                        # past non-ignored gts and into ignored: stop if
                        # we already have a real match
                        if m > -1 and gtIg[m] == 0 and gtIg[gind] == 1:
                            break
                        if ious[dind, gind] < best_iou:
                            continue
                        best_iou = ious[dind, gind]
                        m = gind
                    if m == -1:
                        continue
                    dtIg[tind, dind] = gtIg[m]
                    dtm[tind, dind] = gt[m]["id"]
                    gtm[tind, m] = d["id"]
        # unmatched dts outside the area range are ignored
        a = np.array([d["area"] < aRng[0] or d["area"] > aRng[1]
                      for d in dt]).reshape(1, D)
        dtIg = np.logical_or(dtIg, np.logical_and(
            dtm == 0, np.repeat(a, T, 0)))
        return {
            "image_id": imgId, "category_id": catId, "aRng": aRng,
            "maxDet": maxDet,
            "dtIds": [d["id"] for d in dt],
            "gtIds": [g["id"] for g in gt],
            "dtMatches": dtm, "gtMatches": gtm,
            "dtScores": [d["score"] for d in dt],
            "gtIgnore": gtIg, "dtIgnore": dtIg,
        }

    def evaluate(self):
        tic = time.time()
        p = self.params
        p.imgIds = list(np.unique(p.imgIds))
        if p.useCats:
            p.catIds = list(np.unique(p.catIds))
        self._prepare()
        catIds = p.catIds if p.useCats else [-1]
        self.ious = {
            (imgId, catId): self.computeIoU(imgId, catId)
            for imgId in p.imgIds for catId in catIds}
        maxDet = p.maxDets[-1]
        self.evalImgs = [
            self.evaluateImg(imgId, catId, aRng, maxDet)
            for catId in catIds
            for aRng in p.areaRng
            for imgId in p.imgIds]
        self._paramsEval = copy.deepcopy(self.params)
        print(f"DONE (t={time.time() - tic:0.2f}s).")

    # ---------------------------------------------------- accumulate --
    def accumulate(self, p=None):
        tic = time.time()
        if p is None:
            p = self.params
        T = len(p.iouThrs)
        R = len(p.recThrs)
        K = len(p.catIds) if p.useCats else 1
        A = len(p.areaRng)
        M = len(p.maxDets)
        precision = -np.ones((T, R, K, A, M))
        recall = -np.ones((T, K, A, M))
        scores = -np.ones((T, R, K, A, M))

        n_imgs = len(p.imgIds)
        for k in range(K):
            for a in range(A):
                for m, maxDet in enumerate(p.maxDets):
                    base = k * A * n_imgs + a * n_imgs
                    E = [self.evalImgs[base + i] for i in range(n_imgs)]
                    E = [e for e in E if e is not None]
                    if len(E) == 0:
                        continue
                    dtScores = np.concatenate(
                        [e["dtScores"][:maxDet] for e in E])
                    inds = np.argsort(-dtScores, kind="mergesort")
                    dtScoresSorted = dtScores[inds]
                    dtm = np.concatenate(
                        [e["dtMatches"][:, :maxDet] for e in E],
                        axis=1)[:, inds]
                    dtIg = np.concatenate(
                        [e["dtIgnore"][:, :maxDet] for e in E],
                        axis=1)[:, inds]
                    gtIg = np.concatenate([e["gtIgnore"] for e in E])
                    npig = np.count_nonzero(gtIg == 0)
                    if npig == 0:
                        continue
                    tps = np.logical_and(dtm, np.logical_not(dtIg))
                    fps = np.logical_and(
                        np.logical_not(dtm), np.logical_not(dtIg))
                    tp_sum = np.cumsum(tps, axis=1).astype(np.float64)
                    fp_sum = np.cumsum(fps, axis=1).astype(np.float64)
                    for t in range(T):
                        tp = tp_sum[t]
                        fp = fp_sum[t]
                        nd = len(tp)
                        rc = tp / npig
                        pr = tp / (fp + tp + np.spacing(1))
                        q = np.zeros(R)
                        ss = np.zeros(R)
                        recall[t, k, a, m] = rc[-1] if nd else 0
                        # make precision monotonically decreasing
                        pr = pr.tolist()
                        for i in range(nd - 1, 0, -1):
                            if pr[i] > pr[i - 1]:
                                pr[i - 1] = pr[i]
                        inds_r = np.searchsorted(rc, p.recThrs, side="left")
                        for ri, pi in enumerate(inds_r):
                            if pi < nd:
                                q[ri] = pr[pi]
                                ss[ri] = dtScoresSorted[pi]
                        precision[t, :, k, a, m] = q
                        scores[t, :, k, a, m] = ss
        self.eval = {
            "params": p,
            "counts": [T, R, K, A, M],
            "precision": precision,
            "recall": recall,
            "scores": scores,
        }
        print(f"DONE (t={time.time() - tic:0.2f}s).")

    # ----------------------------------------------------- summarize --
    def _summarize(self, ap=1, iouThr=None, areaRng="all", maxDets=100):
        p = self.params
        fmt = (" {:<18} {} @[ IoU={:<9} | area={:>6s} | maxDets={:>3d} ]"
               " = {:0.3f}")
        title = "Average Precision" if ap == 1 else "Average Recall"
        abbr = "(AP)" if ap == 1 else "(AR)"
        iouStr = ("{:0.2f}:{:0.2f}".format(p.iouThrs[0], p.iouThrs[-1])
                  if iouThr is None else f"{iouThr:0.2f}")
        aind = [i for i, l in enumerate(p.areaRngLbl) if l == areaRng]
        mind = [i for i, d in enumerate(p.maxDets) if d == maxDets]
        if ap == 1:
            s = self.eval["precision"]
            if iouThr is not None:
                s = s[[np.where(np.isclose(p.iouThrs, iouThr))[0][0]]]
            s = s[:, :, :, aind, mind]
        else:
            s = self.eval["recall"]
            if iouThr is not None:
                s = s[[np.where(np.isclose(p.iouThrs, iouThr))[0][0]]]
            s = s[:, :, aind, mind]
        mean_s = -1.0 if len(s[s > -1]) == 0 else np.mean(s[s > -1])
        print(fmt.format(title, abbr, iouStr, areaRng, maxDets, mean_s))
        return mean_s

    def summarize(self):
        if not self.eval:
            raise Exception("Please run accumulate() first")
        if self.params.iouType == "keypoints":
            return self._summarize_kps()
        md = self.params.maxDets
        stats = np.zeros(12)
        stats[0] = self._summarize(1, maxDets=md[-1])
        stats[1] = self._summarize(1, iouThr=0.5, maxDets=md[-1])
        stats[2] = self._summarize(1, iouThr=0.75, maxDets=md[-1])
        stats[3] = self._summarize(1, areaRng="small", maxDets=md[-1])
        stats[4] = self._summarize(1, areaRng="medium", maxDets=md[-1])
        stats[5] = self._summarize(1, areaRng="large", maxDets=md[-1])
        stats[6] = self._summarize(0, maxDets=md[0])
        stats[7] = self._summarize(0, maxDets=md[1])
        stats[8] = self._summarize(0, maxDets=md[2])
        stats[9] = self._summarize(0, areaRng="small", maxDets=md[-1])
        stats[10] = self._summarize(0, areaRng="medium", maxDets=md[-1])
        stats[11] = self._summarize(0, areaRng="large", maxDets=md[-1])
        self.stats = stats

    def _summarize_kps(self):
        """Keypoint 10-line summary (pycocotools _summarizeKps)."""
        md = self.params.maxDets[-1]
        stats = np.zeros(10)
        stats[0] = self._summarize(1, maxDets=md)
        stats[1] = self._summarize(1, maxDets=md, iouThr=0.5)
        stats[2] = self._summarize(1, maxDets=md, iouThr=0.75)
        stats[3] = self._summarize(1, maxDets=md, areaRng="medium")
        stats[4] = self._summarize(1, maxDets=md, areaRng="large")
        stats[5] = self._summarize(0, maxDets=md)
        stats[6] = self._summarize(0, maxDets=md, iouThr=0.5)
        stats[7] = self._summarize(0, maxDets=md, iouThr=0.75)
        stats[8] = self._summarize(0, maxDets=md, areaRng="medium")
        stats[9] = self._summarize(0, maxDets=md, areaRng="large")
        self.stats = stats

    def __str__(self):
        self.summarize()
        return ""
