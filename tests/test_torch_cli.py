"""The port's CLIs run in-process on the CPU (`--device cpu`) with the
config class swapped for TinyConfig: predict_torch.py on
images/sample.jpg with a `.pth` the port wrote, coco_torch.py evaluate on
the synthetic COCO directory; the unported paths raise."""

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
    name, box, score) and saves the overlay; -tta reaches the config,
    which raises NotImplementedError."""
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
    with pytest.raises(NotImplementedError, match="TTA_HFLIP"):
        predict_torch.main(["--device", "cpu", "-tta",
                            str(REPO / "images/sample.jpg")])


def test_coco_torch_cli(monkeypatch, tmp_path, capsys):
    """evaluate prints the RLE route and the bbox and segm summaries;
    train raises NotImplementedError naming the ROADMAP item."""
    monkeypatch.setattr(coco_torch, "CocoInferenceConfig", tiny_config)
    root = synthetic_coco_dir(tmp_path)
    coco_torch.main(["evaluate", "--dataset", root, "--limit", "3",
                     "--device", "cpu", "--model", str(tmp_path / "none")])
    out = capsys.readouterr().out
    assert "RLE route: native" in out
    assert out.count("Average Precision  (AP) @[ IoU=0.50:0.95 | area=   "
                     "all | maxDets=100 ]") == 2
    with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
        coco_torch.main(["train", "--dataset", root, "--device", "cpu"])
