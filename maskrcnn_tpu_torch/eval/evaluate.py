"""COCO evaluation driver (counterpart of maskrcnn_tpu/eval/evaluate.py;
reference: coco.py:40-135).

Builds result dicts in the official format (xywh box + compressed-RLE
mask per detection) and runs our standalone COCOeval. Unlike the
reference's one-image-at-a-time `model.detect` loop, inference goes
through `Detector.dispatch_batch`/`fetch` in a 2-deep pipeline: the
device processes several images per dispatch, and each batch's host
decode + RLE encode overlaps the next batch's device compute.
"""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np

from maskrcnn_tpu_torch.eval import rle as rle_lib
from maskrcnn_tpu_torch.eval.cocoeval import COCOeval


def build_coco_results(dataset, image_id, class_ids, scores, boxes,
                       masks, keypoints=None) -> List[dict]:
    """Result dicts for one image (reference: coco.py:40-75).

    boxes: [N, 4] (y1, x1, y2, x2) original coords; masks: [N, H, W]
    uint8; keypoints: optional [N, K, 3] (y, x, score) original coords
    (the Detector's keypoint output), written in COCO's (x, y, v) order
    with v = 1 for the OKS evaluation.
    """
    results = []
    for i in range(len(class_ids)):
        box = np.around(np.asarray(boxes[i], np.float64), 1)
        rle = rle_lib.encode(np.asfortranarray(masks[i]))
        rle["counts"] = rle["counts"].decode("ascii")
        r = {
            "image_id": image_id,
            "category_id": dataset.class_id(int(class_ids[i])),
            "bbox": [float(box[1]), float(box[0]),
                     float(box[3] - box[1]), float(box[2] - box[0])],
            "score": float(scores[i]),
            "segmentation": rle,
        }
        if keypoints is not None:
            r["keypoints"] = [v for y, x, _ in np.asarray(keypoints[i],
                                                          np.float64)
                              for v in (float(x), float(y), 1)]
        results.append(r)
    return results


def evaluate_coco(detector, dataset, coco, eval_type: str = "bbox",
                  limit: int = 0, image_ids: Optional[List[int]] = None,
                  batch_size: int = 8):
    """Official COCO evaluation (reference: coco.py:78-135).

    Returns the 12 COCOeval stats; prints the same timing lines the
    reference publishes its perf numbers with (coco.py:133-135).
    """
    image_ids = image_ids or dataset.ids
    if limit:
        image_ids = image_ids[:limit]

    t_prediction = 0.0
    t_start = time.time()
    results = []
    from maskrcnn_tpu_torch.utils.progress import progress

    # 2-deep pipeline: batch N's fetch + host decode + RLE encode
    # overlaps batch N+1's image loading + device compute.
    pending = None  # (chunk, handle)
    done = 0

    def drain(pending):
        nonlocal t_prediction, done
        chunk, handle = pending
        t = time.time()
        outs = detector.fetch(handle)
        t_prediction += time.time() - t
        for image_id, out in zip(chunk, outs):
            if out is None:
                continue
            class_ids, scores, boxes, masks = out[:4]
            boxes = np.asarray(boxes)
            results.extend(build_coco_results(
                dataset, image_id, class_ids, scores,
                boxes.astype(np.int32), np.asarray(masks, np.uint8),
                keypoints=out[4] if len(out) > 4 else None))
        done += len(chunk)
        progress(done, len(image_ids),
                 prefix=f"Evaluating {eval_type}",
                 suffix=f"{done}/{len(image_ids)}")

    for start in range(0, len(image_ids), batch_size):
        chunk = image_ids[start:start + batch_size]
        images = [dataset.load_image(i) for i in chunk]
        t = time.time()
        handle = detector.dispatch_batch(images)
        t_prediction += time.time() - t
        if pending is not None:
            drain(pending)
        pending = (chunk, handle)
    if pending is not None:
        drain(pending)

    coco_results = coco.loadRes(results)
    coco_eval = COCOeval(coco, coco_results, eval_type)
    coco_eval.params.imgIds = list(image_ids)
    coco_eval.evaluate()
    coco_eval.accumulate()
    coco_eval.summarize()

    print("Prediction time: {}. Average {}/image".format(
        t_prediction, t_prediction / max(len(image_ids), 1)))
    print("Total time: ", time.time() - t_start)
    return coco_eval.stats
