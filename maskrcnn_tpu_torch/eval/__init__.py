"""Standalone COCO evaluation stack (counterpart of maskrcnn_tpu/eval):
RLE codec, annotation index, COCOeval and the evaluation driver; numpy
and a host C++ library, no pycocotools."""

from maskrcnn_tpu_torch.eval.coco_index import COCO
from maskrcnn_tpu_torch.eval.cocoeval import COCOeval, Params
from maskrcnn_tpu_torch.eval.evaluate import build_coco_results, evaluate_coco

__all__ = ["COCO", "COCOeval", "Params", "build_coco_results",
           "evaluate_coco"]
