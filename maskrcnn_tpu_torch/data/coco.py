"""COCO reader for evaluation: label tables and image files (counterpart
of maskrcnn_tpu/data/coco.py; reference data.py:594-884 CocoLabel and
CocoMaskRCNNDataset, coco_annfile/coco_root at data.py:681-692 with the
minival -> val images rule).

Annotations come through the port's own COCO index (eval/coco_index.py).
`CocoDataset.load_image` and `load` decode an image file with the port's
own reader of the image files Pillow reads (data/image_io.py: JPEG, PNG,
WebP, GIF, BMP, TIFF, Netpbm, TGA, QOI, ICO, CUR, DIB, PCX, DCX, SGI and
Sun raster; Pillow's pixels, no Pillow; tests/test_torch_image_tiff.py
and test_torch_image_plugins.py hold directories of them to the JAX
package's CocoDataset).
`load` gives a training
image's instances in original coordinates (crowds negated, mask-extent
boxes, the empty-image fallback) and `sample`, from DetectionDataset, puts
them on the canvas.
"""

from __future__ import annotations

import os
import random
from typing import List, Optional

import numpy as np

from maskrcnn_tpu_torch.data.dataset import DetectionDataset
from maskrcnn_tpu_torch.data.image_io import read_image
from maskrcnn_tpu_torch.eval.coco_index import COCO

# The 80 COCO categories in contiguous label order (label 0 = background).
# Public COCO metadata (reference mirrors it at data.py:600-614).
COCO_CLASS_NAMES = [
    "BG", "person", "bicycle", "car", "motorcycle", "airplane", "bus",
    "train", "truck", "boat", "traffic light", "fire hydrant", "stop sign",
    "parking meter", "bench", "bird", "cat", "dog", "horse", "sheep",
    "cow", "elephant", "bear", "zebra", "giraffe", "backpack", "umbrella",
    "handbag", "tie", "suitcase", "frisbee", "skis", "snowboard",
    "sports ball", "kite", "baseball bat", "baseball glove", "skateboard",
    "surfboard", "tennis racket", "bottle", "wine glass", "cup", "fork",
    "knife", "spoon", "bowl", "banana", "apple", "sandwich", "orange",
    "broccoli", "carrot", "hot dog", "pizza", "donut", "cake", "chair",
    "couch", "potted plant", "bed", "dining table", "toilet", "tv",
    "laptop", "mouse", "remote", "keyboard", "cell phone", "microwave",
    "oven", "toaster", "sink", "refrigerator", "book", "clock", "vase",
    "scissors", "teddy bear", "hair drier", "toothbrush",
]

# Chinese display names, contiguous label order (reference surface:
# data.py:618-637 zh_name; predict.py prints them).
COCO_CLASS_NAMES_ZH = [
    "背景", "人", "自行车", "汽车", "摩托车", "飞机", "公共汽车", "火车",
    "卡车", "船", "红绿灯", "消防栓", "停车标志", "停车计时器", "长凳",
    "鸟", "猫", "狗", "马", "羊", "牛", "大象", "熊", "斑马", "长颈鹿",
    "背包", "伞", "手提包", "领带", "手提箱", "飞盘", "滑雪", "滑雪板",
    "运动球", "风筝", "棒球棒", "棒球手套", "滑板", "冲浪板", "网球拍",
    "瓶子", "酒杯", "杯子", "叉子", "刀", "勺子", "碗", "香蕉", "苹果",
    "三明治", "橙子", "花椰菜", "胡萝卜", "热狗", "比萨饼", "甜甜圈",
    "蛋糕", "椅子", "沙发", "盆栽植物", "床", "餐桌", "厕所", "电视",
    "笔记本电脑", "鼠标", "遥控器", "键盘", "手机", "微波炉", "烤箱",
    "烤面包机", "水槽", "冰箱", "书", "钟", "花瓶", "剪刀", "泰迪熊",
    "吹风机", "牙刷",
]

# Sparse COCO category ids in contiguous label order (data.py:667-678).
COCO_CLASS_IDS = [
    0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 14, 15, 16, 17, 18, 19, 20,
    21, 22, 23, 24, 25, 27, 28, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40,
    41, 42, 43, 44, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 67, 70, 72, 73, 74, 75, 76, 77, 78, 79,
    80, 81, 82, 84, 85, 86, 87, 88, 89, 90,
]

_CLASS_TO_LABEL = {c: i for i, c in enumerate(COCO_CLASS_IDS)}

# COCO person keypoints' left/right swap under a horizontal flip (nose
# stays; eyes, ears, shoulders, elbows, wrists, hips, knees, ankles swap)
COCO_KP_HFLIP_PERM = [0, 2, 1, 4, 3, 6, 5, 8, 7, 10, 9,
                      12, 11, 14, 13, 16, 15]

class CocoLabel:
    """Contiguous label <-> sparse COCO class id (data.py:594-678)."""

    @classmethod
    def name(cls, label_id: int) -> str:
        return (COCO_CLASS_NAMES[label_id]
                if label_id < len(COCO_CLASS_NAMES) else "BG")

    @classmethod
    def zh_name(cls, label_id: int) -> str:
        return (COCO_CLASS_NAMES_ZH[label_id]
                if label_id < len(COCO_CLASS_NAMES_ZH) else "背景")

    @classmethod
    def from_class(cls, class_id: int) -> int:
        return _CLASS_TO_LABEL[class_id]

    @classmethod
    def to_class(cls, label_id: int) -> int:
        return (COCO_CLASS_IDS[label_id]
                if label_id < len(COCO_CLASS_IDS) else 0)


def coco_annfile(root: str, subset: str, year: int = 2014) -> str:
    """Annotation path rule (data.py:681-684)."""
    return os.path.join(root, "annotations",
                        f"instances_{subset}{year}.json")


def coco_image_dir(root: str, subset: str, year: int = 2014) -> str:
    """Image dir rule incl. minival->val (data.py:687-692)."""
    if subset in ("minival", "valminusminival"):
        subset = "val"
    return os.path.join(root, f"{subset}{year}")


class CocoDataset(DetectionDataset):
    """COCO images and annotations of one subset, for training and
    evaluation (reference CocoMaskRCNNDataset, data.py:695-884)."""

    def __init__(self, root: str, subset: str, year: int, config,
                 annfile: Optional[str] = None,
                 image_dir: Optional[str] = None):
        self.config = config
        self.root = root
        self.image_dir = image_dir or coco_image_dir(root, subset, year)
        self.coco = COCO(annfile or coco_annfile(root, subset, year))
        self.ids: List[int] = sorted(self.coco.imgs.keys())

    def __len__(self) -> int:
        return len(self.ids)

    def set_filter(self, image_ids: List[int]):
        """Restrict the dataset (reference data.py:739-741)."""
        self.ids = list(image_ids)

    def image_id(self, index: int) -> int:
        return self.ids[index]

    def image_index(self, image_id: int) -> int:
        return self.ids.index(image_id)

    def image_path(self, index: int) -> str:
        info = self.coco.loadImgs([self.ids[index]])[0]
        return os.path.join(self.image_dir, info["file_name"])

    def class_id(self, label_id: int) -> int:
        return CocoLabel.to_class(label_id)

    def load_image(self, image_id: int) -> np.ndarray:
        """RGB uint8 array (reference data.py:761-768)."""
        return read_image(self.image_path(self.image_index(image_id)))

    def load(self, index: int, hflip: bool = False):
        """(image, label_ids, boxes, masks[, keypoints]) in original
        coordinates (reference data.py:797-876: crowds negated,
        mask-extent boxes, the empty-image fallback); hflip flips half
        the time."""
        image_id = self.ids[index]
        image = read_image(self.image_path(index))
        anns = self.coco.loadAnns(self.coco.getAnnIds(imgIds=[image_id]))

        flip = hflip and random.randint(0, 1)
        if flip:
            image = image[:, ::-1]

        nk = getattr(self.config, "NUM_KEYPOINTS", 0)
        label_ids: List[int] = []
        boxes: List[List[float]] = []
        masks: List[np.ndarray] = []
        kps: List[np.ndarray] = []
        h, w = image.shape[:2]
        for ann in anns:
            label_id = CocoLabel.from_class(ann["category_id"])
            if not label_id:
                continue
            m = self.coco.annToMask(ann)
            if m.max() < 1:
                continue
            if ann.get("iscrowd"):
                label_id = -label_id  # crowd marker (data.py:829-833)
                if m.shape[0] != h or m.shape[1] != w:
                    m = np.ones((h, w), np.uint8)
            if nk:
                # COCO's flat (x, y, v) to (y, x, v), the box layout's order
                kp = np.zeros((nk, 3), np.float32)
                raw = ann.get("keypoints")
                if raw is not None:
                    arr = np.asarray(raw, np.float32).reshape(-1, 3)[:nk]
                    kp[:len(arr), 0] = arr[:, 1]
                    kp[:len(arr), 1] = arr[:, 0]
                    kp[:len(arr), 2] = arr[:, 2]
                if flip:
                    kp[:, 1] = np.where(kp[:, 2] > 0,
                                        w - 1 - kp[:, 1], kp[:, 1])
                    if nk == len(COCO_KP_HFLIP_PERM):
                        kp = kp[COCO_KP_HFLIP_PERM]
                kps.append(kp)
            if flip:
                m = m[:, ::-1]
            cols = np.any(m, axis=0)
            rows = np.any(m, axis=1)
            if cols.any():
                y1, y2 = np.where(rows)[0][[0, -1]]
                x1, x2 = np.where(cols)[0][[0, -1]]
                box = [float(y1), float(x1), float(y2) + 1.0,
                       float(x2) + 1.0]
            else:
                box = [0.0, 0.0, 0.0, 0.0]
            label_ids.append(label_id)
            boxes.append(box)
            masks.append(m.astype(np.uint8))

        if not label_ids:
            # empty-image fallback (data.py:859-867)
            label_ids = [0]
            boxes = [[0.0, 0.0, float(h), float(w)]]
            masks = [np.ones((h, w), np.uint8)]
            kps = [np.zeros((nk, 3), np.float32)] if nk else []

        g = self.config.MAX_GT_INSTANCES
        # the reference's truncation is a no-op ([:m] with m the current
        # count, data.py:869-874); this one truncates
        out = (image, np.asarray(label_ids[:g], np.int32),
               np.asarray(boxes[:g], np.float32), np.stack(masks[:g]))
        if nk:
            out = out + (np.stack(kps[:g]),)
        return out
