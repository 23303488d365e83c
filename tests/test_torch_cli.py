"""The port's CLIs run in-process on the CPU (`--device cpu`) with the
config class swapped for TinyConfig: predict_torch.py on
images/sample.jpg with a `.pth` the port wrote, with and without the
inference protocols' flags; coco_torch.py evaluate on the synthetic COCO
directory, with the protocols' flags too; `train` raises."""

import json
from pathlib import Path

import pytest
import torch

import coco_torch
import predict_torch
from maskrcnn_tpu_torch import TinyConfig
from maskrcnn_tpu_torch.api import Detector
from tests.torch_port import synthetic_coco_dir

REPO = Path(__file__).resolve().parent.parent


def tiny_config(**kw):
    """TinyConfig with every detection kept, as CocoInferenceConfig."""
    return TinyConfig(DETECTION_MIN_CONFIDENCE=0.0, **kw)


def test_predict_torch_cli(monkeypatch, tmp_path, capsys):
    """Loads the .pth, prints one line a detection (label id, Chinese
    name, box, score) and saves the overlay; -tta, -soft-nms and
    -cascade run (the two-head .pth leaves the cascade heads at their
    initialization, and says so)."""
    monkeypatch.setattr(predict_torch, "CocoInferenceConfig", tiny_config)
    weights = tmp_path / "tiny.pth"
    torch.save(Detector(tiny_config(), "cpu").model.state_dict(), weights)
    out = tmp_path / "overlay.png"
    predict_torch.main(["--device", "cpu", "-model", str(weights),
                        "-output", str(out), str(REPO / "images/sample.jpg")])
    lines = capsys.readouterr().out.splitlines()
    assert "Weight file not found ..." not in lines
    detections = [ln for ln in lines if ln.split(" ", 1)[0].isdigit()]
    assert detections and out.stat().st_size > 0
    predict_torch.main(["--device", "cpu", "-model", str(weights), "-tta",
                        "-soft-nms", "0.5", "-cascade", "0.5,0.6,0.7",
                        "-output", str(out), str(REPO / "images/sample.jpg")])
    lines = capsys.readouterr().out.splitlines()
    assert any("checkpoint lacks ['classifier2', 'classifier3']" in ln
               for ln in lines)
    assert [ln for ln in lines if ln.split(" ", 1)[0].isdigit()]


def test_coco_torch_cli(monkeypatch, tmp_path, capsys):
    """evaluate prints the RLE route and the bbox and segm summaries; under
    --tta --soft-nms --cascade --keypoints 17 (a two-conv keypoint head)
    the keypoint summary follows, on ground truth with 17 keypoints an
    annotation; train on more than one device raises NotImplementedError
    naming the field (training itself: tests/test_torch_train_data.py)."""
    monkeypatch.setattr(coco_torch, "CocoInferenceConfig", tiny_config)
    root = synthetic_coco_dir(tmp_path)
    coco_torch.main(["evaluate", "--dataset", root, "--limit", "3",
                     "--device", "cpu", "--model", str(tmp_path / "none")])
    out = capsys.readouterr().out
    assert "RLE route: native" in out
    assert out.count("Average Precision  (AP) @[ IoU=0.50:0.95 | area=   "
                     "all | maxDets=100 ]") == 2
    ann_path = Path(root) / "annotations" / "instances_minival2014.json"
    gt = json.loads(ann_path.read_text())
    for ann in gt["annotations"]:
        x, y, w, h = ann["bbox"]
        ann["keypoints"] = [v for k in range(17)
                            for v in (x + w * k / 16, y + h / 2, 2)]
        ann["num_keypoints"] = 17
    ann_path.write_text(json.dumps(gt))
    monkeypatch.setattr(coco_torch, "CocoInferenceConfig", lambda **kw:
                        tiny_config(KEYPOINT_HEAD_CONVS=2,
                                    KEYPOINT_HEAD_DIM=32, **kw))
    coco_torch.main(["evaluate", "--dataset", root, "--limit", "3",
                     "--device", "cpu", "--model", str(tmp_path / "none"),
                     "--tta", "--soft-nms", "0.5", "--cascade", "0.5,0.6",
                     "--keypoints", "17"])
    out = capsys.readouterr().out
    assert out.count("Average Precision  (AP) @[ IoU=0.50:0.95 | area=   "
                     "all | maxDets=100 ]") == 2
    assert out.count("Average Precision  (AP) @[ IoU=0.50:0.95 | area=   "
                     "all | maxDets= 20 ]") == 1
    with pytest.raises(NotImplementedError, match="NUM_DEVICES"):
        coco_torch.main(["train", "--dataset", root, "--device", "cpu",
                         "--devices", "2"])
