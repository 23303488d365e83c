"""The port's debug and tutorial surface on the CPU: explore_torch.py,
tools/finetune_custom_torch.py, tools/export_model_torch.py and the
train_torch.sh / eval_torch.sh entries.

* explore_torch's stage functions against the JAX package's calls of
  explore.py (backbone, anchors, rpn_detect + rpn_refine, multilevel
  RoIAlign + classify + mrn_refine) on the same TinyConfig weights and
  canvas: the canvas and anchors equal, P2-P6 within 1e-5 of each
  level's range, proposal validity, class ids and boxes equal, proposals
  and scores within 1e-5; then its CLI at each stage, and without
  matplotlib (the stages print, the picture is not drawn).
* The tutorial: the ArrayDataset, `to_coco()` and the first
  BatchLoader batch equal to tools/finetune_custom.py's on the JAX
  package, and the record of its full run on the card (chip_smoke phase
  10c runs it for 10 steps on the card every time).
* The export CLI: its argv, the `--platforms` refusal naming the flag,
  the weights it traces and writes beside the program.
"""

import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import explore_torch
from maskrcnn_tpu.config import TinyConfig as JaxTiny
from maskrcnn_tpu.data.codecs import resize_image as jax_resize
from maskrcnn_tpu.detection.pipeline import mrn_refine, rpn_refine
from maskrcnn_tpu.models.mask_rcnn import MaskRCNN as JaxMaskRCNN
from maskrcnn_tpu.ops.image import normalize_image
from maskrcnn_tpu.ops.roi_align import multilevel_roi_align
from maskrcnn_tpu_torch import export as ex
from maskrcnn_tpu_torch.config import TinyConfig
from maskrcnn_tpu_torch.data.image_io import read_image
from tests.torch_port import jax_params, port_config, torch_model

REPO = Path(__file__).resolve().parent.parent
CFG = JaxTiny(DETECTION_MIN_CONFIDENCE=0.0)
IMAGE = REPO / "images" / "sample.jpg"


def _tiny(**kw):
    return TinyConfig(DETECTION_MIN_CONFIDENCE=0.0, **kw)


def _np(t):
    return t.detach().cpu().numpy()


def _jax_explore(params, canvas, window):
    """explore.py's calls, from the canvas to the detections (jitted as
    one function: op by op they take 17 s on the CPU)."""
    jmodel = JaxMaskRCNN(CFG)
    feats = jmodel.backbone(params, normalize_image(canvas[None],
                                                    CFG.MEAN_PIXEL))
    anchors = jnp.asarray(jmodel.anchors())
    _, probs, bbox = jmodel.rpn_detect(params, feats)
    props, valid = rpn_refine(CFG, anchors, probs[0], bbox[0])
    pooled = multilevel_roi_align([f[0] for f in feats[:4]], props,
                                  CFG.POOL_SIZE, CFG.IMAGE_SHAPE)
    _, cprobs, deltas = jmodel.classify(params, pooled)
    return feats, anchors, props, valid, mrn_refine(
        CFG, props, valid, cprobs, deltas, window)


@pytest.fixture(scope="module")
def stages():
    """explore.py's calls on the JAX package and explore_torch's stage
    functions on the port, the same weights and image."""
    params = jax_params(CFG)
    model = torch_model(CFG, params)
    img = read_image(IMAGE)
    canvas, window, _ = explore_torch.canvas_of(model.config, img)
    jcanvas, jwindow, _ = jax_resize(img, CFG.IMAGE_MIN_DIM,
                                     CFG.IMAGE_MAX_DIM)
    jout = jax.jit(_jax_explore)(params, jnp.asarray(jcanvas),
                                 jnp.asarray(jwindow, jnp.float32))
    feats = explore_torch.features(model, canvas)
    props, valid = explore_torch.proposals(model, feats)
    det = explore_torch.detections(model, feats, props, valid, window)
    return dict(
        port=(canvas, window, feats, explore_torch.anchors(model), props,
              valid, det),
        jax=(jcanvas, jwindow) + jax.device_get(jout))


def test_explore_canvas_and_features_equal_jax(stages):
    canvas, window, feats = stages["port"][:3]
    jcanvas, jwindow, jfeats = stages["jax"][:3]
    np.testing.assert_array_equal(canvas, jcanvas)
    assert tuple(window) == tuple(jwindow)
    for lvl, (a, b) in enumerate(zip(feats, jfeats), start=2):
        b = np.asarray(b)
        tol = 1e-5 * float(b.max() - b.min())
        np.testing.assert_allclose(_np(a), b, rtol=0, atol=tol,
                                   err_msg=f"P{lvl}")


def test_explore_anchors_and_proposals_equal_jax(stages):
    anchors, props, valid = stages["port"][3:6]
    janchors, jprops, jvalid = stages["jax"][3:6]
    np.testing.assert_array_equal(_np(anchors), np.asarray(janchors))
    np.testing.assert_array_equal(_np(valid[0]), np.asarray(jvalid))
    assert int(_np(valid).sum()) > 0
    np.testing.assert_allclose(_np(props[0]), np.asarray(jprops), rtol=0,
                               atol=1e-5)


def test_explore_detections_equal_jax(stages):
    det, jdet = stages["port"][6], stages["jax"][6]
    v = np.asarray(jdet.valid)
    np.testing.assert_array_equal(_np(det.valid[0]), v)
    assert v.sum() > 0
    np.testing.assert_array_equal(_np(det.class_ids[0]),
                                  np.asarray(jdet.class_ids))
    np.testing.assert_array_equal(_np(det.boxes[0]), np.asarray(jdet.boxes))
    np.testing.assert_allclose(_np(det.scores[0]), np.asarray(jdet.scores),
                               rtol=0, atol=1e-5)


EXPECT = {"p2": "P2 features", "anchors": "anchors; first center",
          "rpn": "proposals after NMS", "detect": "detections"}


@pytest.mark.parametrize("stage", explore_torch.STAGES)
def test_explore_cli_stage(monkeypatch, tmp_path, capsys, stage):
    """Each stage prints its numbers and writes its picture."""
    monkeypatch.setattr(explore_torch, "CocoInferenceConfig", _tiny)
    out = tmp_path / f"{stage}.png"
    explore_torch.main(["--device", "cpu", "-model", str(tmp_path / "none"),
                        "-stage", stage, "-output", str(out), str(IMAGE)])
    text = capsys.readouterr().out
    assert EXPECT[stage] in text
    assert out.stat().st_size > 0


def test_explore_cli_without_matplotlib(monkeypatch, tmp_path, capsys):
    """Without matplotlib the stage runs and says the picture is not
    drawn."""
    monkeypatch.setattr(explore_torch, "CocoInferenceConfig", _tiny)
    for name in [m for m in sys.modules if m.startswith("matplotlib")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    out = tmp_path / "detect.png"
    explore_torch.main(["--device", "cpu", "-model", str(tmp_path / "none"),
                        "-output", str(out), str(IMAGE)])
    text = capsys.readouterr().out
    assert "detections" in text and "cannot draw the picture" in text
    assert not out.exists()


def _jax_finetune():
    sys.path.insert(0, str(REPO / "tools"))
    try:
        import finetune_custom
    finally:
        sys.path.remove(str(REPO / "tools"))
    return finetune_custom


def test_tutorial_dataset_and_first_batch_equal_jax():
    """The tutorial's ArrayDataset (images, masks, class ids), its
    `to_coco()` dict and the first BatchLoader batch (no shuffle, no
    flip) equal the JAX tool's."""
    from maskrcnn_tpu.data.pipeline import BatchLoader as JaxLoader
    from maskrcnn_tpu_torch.data.pipeline import BatchLoader
    from tools import finetune_custom_torch as ft
    jft = _jax_finetune()
    cfg = ft.config()
    jcfg = JaxTiny(NUM_CLASSES=4, IMAGE_MIN_DIM=64, IMAGE_MAX_DIM=64,
                   RPN_ANCHOR_SCALES=(4, 8, 16, 32, 64),
                   DETECTION_MIN_CONFIDENCE=0.5)
    assert port_config(jcfg) == cfg
    ds = ft.make_dataset(cfg, 6, seed=1)
    jds = jft.make_dataset(jcfg, 6, seed=1)
    for a, b in zip(ds.images + ds.masks + ds.class_ids,
                    jds.images + jds.masks + jds.class_ids):
        np.testing.assert_array_equal(a, b)

    def dump(coco):
        # RLE counts are bytes
        return json.dumps(coco, sort_keys=True, default=bytes.decode)

    assert dump(ds.to_coco()) == dump(jds.to_coco())
    # the flips are unseeded draws on both sides: off, as
    # tests/test_torch_train_data.py compares the loaders
    loaders = [BatchLoader(ds, 2, shuffle=False, num_workers=1, hflip=False),
               JaxLoader(jds, 2, shuffle=False, num_workers=1, hflip=False)]
    try:
        got, want = (next(it) for it in loaders)
    finally:
        for it in loaders:
            it.close()
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_tutorial_record_from_the_card():
    """records_torch/finetune_custom.json, the tutorial's full run
    (tools/chip_phases.py f): taken on an H100 with its power limit, the
    JAX tool's schedule, both AP50s in range."""
    rec = json.loads((REPO / "records_torch" /
                      "finetune_custom.json").read_text())
    assert "H100" in rec["device"] and rec["card"].endswith(" W")
    assert rec["args"].startswith("3 epochs x 100 steps, batch 4")
    assert 0.0 <= rec["bbox_ap50"] <= 1.0 and 0.0 <= rec["segm_ap50"] <= 1.0


def test_export_cli_refuses_platforms(capsys):
    from tools import export_model_torch as em
    with pytest.raises(SystemExit):
        em.main(["--out", "p.pt2", "--platforms", "tpu,cpu"])
    assert "--platforms" in capsys.readouterr().err


def test_export_cli_argv():
    from tools import export_model_torch as em
    args = em.build_parser().parse_args(
        ["--out", "p.pt2", "--weights", "w.npz", "--model", "m.pth",
         "--batch", "2", "--canvas", "128,192", "--int8", "--calib-stats",
         "s.json"])
    assert (args.out, args.weights, args.model, args.batch, args.canvas,
            args.int8, args.calib_stats, args.device) == (
        "p.pt2", "w.npz", "m.pth", 2, "128,192", True, "s.json", "cuda")


def test_export_cli_writes_program_and_sidecar(monkeypatch, tmp_path):
    """--model (a .pth the port wrote), --weights, --batch and --canvas on
    the CPU: the program is traced from a Detector holding the .pth's
    weights at the canvas asked for, and the sidecar holds those weights'
    values (the trace itself round-trips bit for bit in
    tests/test_torch_export.py and on the card in chip_smoke phase
    10c)."""
    from maskrcnn_tpu_torch import config as config_module
    from maskrcnn_tpu_torch.api import Detector
    from tools import export_model_torch as em
    monkeypatch.setattr(config_module, "CocoInferenceConfig", _tiny)
    live = Detector(_tiny(), "cpu", generator=torch.Generator().manual_seed(4))
    weights = tmp_path / "w.pth"
    torch.save(live.model.state_dict(), weights)
    traced = []

    def save(model, batch, path):
        traced.append((model, batch))
        Path(path).write_bytes(b"program")
        return path

    monkeypatch.setattr(ex, "save_exported", save)
    out = str(tmp_path / "p.pt2")
    assert em.main(["--out", out, "--model", str(weights), "--weights",
                    str(tmp_path / "w.npz"), "--batch", "2", "--canvas",
                    "128,192", "--device", "cpu"]) == out
    (model, batch), = traced
    assert batch == 2 and tuple(model.config.IMAGE_SHAPE[:2]) == (128, 192)
    params = ex.model_params(model)
    side = ex.params_from_npz(str(tmp_path / "w.npz"))
    assert sorted(side) == sorted(params)
    for k, v in ex.model_params(live.model).items():
        if k != "anchor_boxes":  # the canvas's anchors
            assert torch.equal(params[k], v), k
    for k, v in params.items():
        assert torch.equal(side[k], v), k


@pytest.mark.parametrize("script,command", [("train_torch.sh", "train"),
                                            ("eval_torch.sh", "evaluate")])
def test_shell_entries_call_coco_torch(script, command):
    text = (REPO / script).read_text()
    assert f'python coco_torch.py {command} --dataset data "$@"' in text
