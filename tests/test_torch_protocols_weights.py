"""The weights of the port's new heads against the JAX package, on
test_torch_protocols_pipeline's seeded tree with every optional head: the
state-dict names of the cascade and keypoint heads and what they compute,
a two-head `.pth` into a model with a new branch, the fold of the
cascade heads, and the new heads kept float under int8."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maskrcnn_tpu.checkpoint.fold import fold_bn_params
from maskrcnn_tpu.models.mask_rcnn import MaskRCNN as JaxMaskRCNN
from maskrcnn_tpu_torch.api import Detector
from maskrcnn_tpu_torch.checkpoint.convert import (from_jax_params,
                                                  state_branches)
from maskrcnn_tpu_torch.checkpoint.fold import fold_state_dict
from maskrcnn_tpu_torch.detection import pipeline as port_pipe
from maskrcnn_tpu_torch.models.resnet import FrozenBatchNorm
from tests.test_torch_pipeline import CFG
from tests.test_torch_protocols_pipeline import (CASCADE, FULL, KP, _tree,
                                                 _canvases, _port_detector)
from tests.torch_port import jax_params, port_config


@pytest.fixture(scope="module")
def params():
    """Seeded JAX weights with every optional head and jittered BN."""
    return jax_params(FULL)


def test_from_jax_params_carries_optional_heads(params):
    """from_jax_params names the cascade heads classifier2/3 and the
    keypoint head keypoint.*, in the layouts of the base heads; the port's
    stage heads and keypoint head then compute what the JAX package's
    classify_stage and predict_keypoints compute (float32, within 1e-5
    of the range)."""
    state = from_jax_params(params, FULL.BACKBONE)
    for stage in (2, 3):
        for name in ("conv1", "bn1", "conv2", "bn2", "linear_class",
                     "linear_bbox"):
            assert f"classifier{stage}.{name}.weight" in state
    assert {k for k in state if k.startswith("keypoint.")} == {
        f"keypoint.{m}.{f}" for m in ("conv1", "conv2", "deconv", "score")
        for f in ("weight", "bias")}
    np.testing.assert_array_equal(
        state["classifier2.linear_class.weight"],
        np.asarray(params["box_head2"]["linear_class"]["kernel"]).T)
    det = _port_detector(FULL, params)
    jmodel = JaxMaskRCNN(FULL)
    rng = np.random.RandomState(17)
    box_in = rng.randn(6, 7, 7, 256).astype(np.float32)
    mask_in = rng.randn(3, 14, 14, 256).astype(np.float32)
    with torch.inference_mode():
        for stage in range(3):
            want = jmodel.classify_stage(params, jnp.asarray(box_in), stage)
            got = det.model.classify_stage(torch.from_numpy(box_in), stage)
            for g, w in zip(got, want):
                w = np.asarray(w)
                np.testing.assert_allclose(
                    g.numpy(), w, rtol=0,
                    atol=1e-5 * float(np.abs(w).max()))
        want = np.asarray(jmodel.predict_keypoints(params,
                                                   jnp.asarray(mask_in)))
        got = det.model.predict_keypoints(torch.from_numpy(mask_in)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * float(np.ptp(want)))


@pytest.mark.parametrize("branch,fold", [("cascade", False),
                                         ("keypoints", False),
                                         ("cascade", True)],
                         ids=["cascade", "keypoints", "cascade-FOLD_BN"])
def test_two_head_pth_keeps_new_branch_at_init(params, tmp_path, capsys,
                                               branch, fold):
    """A two-head .pth (what the reference checkpoint holds) loads into a
    cascade or keypoint Detector: the shared weights equal the file's
    (folded under FOLD_BN, as load_weights folds them), the new
    branch keeps its initialization, and the branches are printed, as the
    JAX store.load_params does. A branch the file holds in part raises
    KeyError."""
    two = CFG.replace(FOLD_BN=fold)
    extra = (dict(CASCADE_STAGES=CASCADE) if branch == "cascade" else KP)
    cfg = two.replace(**extra)
    path = str(tmp_path / "two_head.pth")
    state = from_jax_params(_tree(params, CFG), CFG.BACKBONE)
    torch.save({k: torch.tensor(v) for k, v in state.items()}, path)
    if fold:
        state = fold_state_dict(state, CFG.BACKBONE)
    det = Detector(port_config(cfg), "cpu")
    init = {k: v.clone() for k, v in det.model.state_dict().items()}
    capsys.readouterr()
    det.load_weights(path)
    printed = capsys.readouterr().out
    new = ["classifier2", "classifier3"] if branch == "cascade" else \
        ["keypoint"]
    assert f"checkpoint lacks {new}" in printed
    for k, v in det.model.state_dict().items():
        want = (init[k] if k.split(".", 1)[0] in new
                else torch.tensor(state[k]))
        assert torch.equal(v, want), k
    state = torch.load(path, weights_only=True)
    state[f"{new[0]}.conv1.weight"] = init[f"{new[0]}.conv1.weight"]
    torch.save(state, path)
    with pytest.raises(KeyError, match=f"{new[0]}.conv1.bias"):
        det.load_weights(path)


def test_fold_folds_cascade_heads_like_jax(params):
    """Under FOLD_BN the cascade heads' BN folds into their convs: the
    port's fold of the torch-layout state equals the JAX fold_bn_params
    (which walks the whole tree) array for array, and the folded model's
    stage heads apply no BN."""
    state = from_jax_params(params, FULL.BACKBONE)
    assert state_branches(state) == {"box_heads": 3, "keypoint_convs": 2}
    got = fold_state_dict(state, FULL.BACKBONE)
    want = from_jax_params(fold_bn_params(params), FULL.BACKBONE)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), want[k],
                                      err_msg=k)
    assert not np.array_equal(got["classifier3.conv1.weight"],
                              from_jax_params(params, FULL.BACKBONE)[
                                  "classifier3.conv1.weight"])
    det = _port_detector(FULL.replace(FOLD_BN=True), params)
    for name in ("classifier2", "classifier3"):
        bns = [m for m in getattr(det.model, name).modules()
               if isinstance(m, FrozenBatchNorm)]
        assert len(bns) == 2 and all(m.folded for m in bns)


def test_int8_keeps_new_heads_float(params):
    """Under QUANT_INT8 the cascade heads and the keypoint head stay float,
    as maskrcnn_tpu/quant.py carries them: no int8 entry for them in the
    prepared state, their modules unchanged by the preparation, and the
    int8 step runs with them (keypoints included)."""
    cfg = FULL.replace(QUANT_INT8=True, QUANT_CALIB="amax")
    det = _port_detector(cfg, params, calib_images=np.zeros(
        (1,) + cfg.IMAGE_SHAPE, np.uint8))
    before = {k: v.clone() for k, v in det.model.state_dict().items()
              if k.startswith(("classifier", "keypoint"))}
    det.prepare()
    q = det.model.quant
    assert not any(p.startswith(("box_head", "kp_head", "classifier",
                                 "keypoint"))
                   for p in list(q["convs"]) + list(q["convs_fp"]))
    for k, v in det.model.state_dict().items():
        if k in before:
            assert torch.equal(v, before[k]) and v.dtype == torch.float32
    images, windows = _canvases(cfg, np.random.RandomState(9))
    out = port_pipe.predict_step(det.model, torch.from_numpy(images),
                                 torch.from_numpy(windows))
    assert tuple(out["keypoints"].shape) == (2, 8, 4, 3)
    assert bool(torch.isfinite(out["keypoints"]).all())
