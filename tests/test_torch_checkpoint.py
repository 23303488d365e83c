"""Weights from a reference `.pth` into the port (`Detector.load_weights`),
held against the JAX package: the same state as `load_jax_params`, the
same tensors reinitialized as the JAX `store.load_params` under
`reinit_mismatched`, and a `.pth` written by the port read by the JAX
Detector with the same detections."""

import jax
import numpy as np
import pytest
import torch

from maskrcnn_tpu.api import Detector as JaxDetector
from maskrcnn_tpu.checkpoint.store import load_params
from maskrcnn_tpu.checkpoint.torch_convert import to_torch_state_dict
from maskrcnn_tpu.config import TinyConfig
from maskrcnn_tpu.models.mask_rcnn import MaskRCNN as JaxMaskRCNN
from maskrcnn_tpu_torch.api import Detector
from tests.torch_port import jax_params, port_config

CFG = TinyConfig().replace(DETECTION_MIN_CONFIDENCE=0.0)


def _save(state, path):
    torch.save({k: torch.tensor(np.asarray(v)) for k, v in state.items()},
               path)


@pytest.fixture(scope="module")
def params81():
    return jax_params(CFG)


@pytest.fixture(scope="module")
def pth81(params81, tmp_path_factory):
    """The seeded JAX weights as a reference-layout .pth, with the
    `num_batches_tracked` entries a torch BatchNorm state carries."""
    state = to_torch_state_dict(params81, CFG.BACKBONE)
    state.update({k.rsplit(".", 1)[0] + ".num_batches_tracked":
                  np.array(0, np.int64)
                  for k in list(state) if k.endswith("running_mean")})
    path = str(tmp_path_factory.mktemp("pth") / "w81.pth")
    _save(state, path)
    return path


@pytest.mark.parametrize("option", ["plain", "FOLD_BN", "QUANT_INT8"])
def test_load_weights_equals_load_jax_params(option, params81, pth81):
    """The .pth through load_weights gives a state (and under QUANT_INT8
    the kept float32 state) bit-equal to load_jax_params on the tree."""
    cfg = port_config(CFG)
    if option != "plain":
        cfg = cfg.replace(**{option: True})
    det = Detector(cfg, "cpu")
    det.load_weights(pth81)
    a = {k: v.clone() for k, v in det.model.state_dict().items()}
    fa = det.model.float_state
    det.load_jax_params(params81)
    b = det.model.state_dict()
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        assert torch.equal(a[k], b[k]), k
    if option == "QUANT_INT8":
        assert det.model.quant is None
        fb = det.model.float_state
        assert list(fa) == list(fb)
        for k in fa:
            np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def test_reinit_mismatched_matches_jax_load_params(params81, pth81, capsys):
    """An 81-class .pth into a 5-class model: the port reinitializes the
    same tensors as the JAX load_params (box head linear_class and
    linear_bbox, the mask head's conv5), keeping its own init there, and
    every other tensor transfers bit-exact; without the flag it raises
    ValueError naming it."""
    cfg5 = CFG.replace(NUM_CLASSES=5)
    # the 5-class tree: the 81-class values where the shapes agree, seeded
    # draws elsewhere (what an init would give them; load_params only
    # reads the template's shapes and its values at mismatched leaves)
    shapes = jax.eval_shape(
        lambda: JaxMaskRCNN(cfg5).init(jax.random.PRNGKey(3)))
    rng = np.random.RandomState(3)
    template = jax.tree_util.tree_map(
        lambda s, p: (np.asarray(p) if s.shape == np.shape(p)
                      else rng.randn(*s.shape).astype(np.float32)),
        shapes, params81)
    merged = load_params(pth81, template, cfg5.BACKBONE,
                         reinit_mismatched=True)
    merged_sd = to_torch_state_dict(jax.device_get(merged), cfg5.BACKBONE)
    template_sd = to_torch_state_dict(jax.device_get(template),
                                      cfg5.BACKBONE)
    state81 = to_torch_state_dict(params81, CFG.BACKBONE)
    jax_reinit = {k for k in merged_sd
                  if merged_sd[k].shape != state81[k].shape}
    for k in jax_reinit:
        np.testing.assert_array_equal(merged_sd[k], template_sd[k])
    assert jax_reinit and len(jax_reinit) == 6

    det = Detector(port_config(cfg5), "cpu")
    with pytest.raises(ValueError, match="reinit_mismatched"):
        det.load_weights(pth81)
    init = {k: v.clone() for k, v in det.model.state_dict().items()}
    capsys.readouterr()
    det.load_weights(pth81, reinit_mismatched=True)
    printed = capsys.readouterr().out
    port_reinit = {k for k in init
                   if tuple(init[k].shape) != state81[k].shape}
    assert port_reinit == jax_reinit
    assert all(k in printed for k in port_reinit)
    for k, v in det.model.state_dict().items():
        want = init[k] if k in port_reinit else torch.tensor(state81[k])
        assert torch.equal(v, want), k


def test_missing_key_and_orbax_dir_raise(params81, tmp_path):
    """A .pth that lacks a weight raises KeyError naming it; a directory
    (an orbax checkpoint) raises ValueError naming orbax."""
    state = to_torch_state_dict(params81, CFG.BACKBONE)
    del state["mask.conv5.bias"]
    path = str(tmp_path / "partial.pth")
    _save(state, path)
    det = Detector(port_config(CFG), "cpu")
    with pytest.raises(KeyError, match="mask.conv5.bias"):
        det.load_weights(path)
    with pytest.raises(ValueError, match="orbax"):
        det.load_weights(str(tmp_path))


def test_port_written_pth_loads_into_jax_detector(params81, tmp_path):
    """The port's seeded float32 state saved with torch.save loads into
    the JAX Detector (Detector.load_weights), which finds the same
    detections as the port on the same images: (class, box) hits >= 0.9
    and mask pixels apart <= 1e-3 (the bars of
    test_torch_pipeline.test_detector_detect_batch_matches_jax)."""
    det = Detector(port_config(CFG), "cpu",
                   generator=torch.Generator().manual_seed(9))
    path = str(tmp_path / "port.pth")
    torch.save(det.model.state_dict(), path)
    # the JAX tree only sets the template's shapes (no JAX init)
    jdet = JaxDetector(CFG, params=params81)
    jdet.load_weights(path)
    rng = np.random.RandomState(11)
    images = [rng.randint(0, 256, (128, 128, 3), np.uint8),
              rng.randint(0, 256, (96, 128, 3), np.uint8)]
    got = det.detect_batch(images)
    want = jdet.detect_batch(images)
    hits = total = apart = pixels = 0
    for g, w in zip(got, want):
        assert g is not None and w is not None
        jax_slot = {(c, tuple(np.round(b, 3))): i
                    for i, (c, b) in enumerate(zip(w[0], w[2]))}
        for c, b, m in zip(g[0], g[2], g[3]):
            i = jax_slot.get((c, tuple(np.round(b, 3))))
            if i is not None:
                hits += 1
                apart += int((m != w[3][i]).sum())
                pixels += m.size
        total += len(w[0])
    assert total > 0
    assert hits >= 0.9 * total
    assert apart <= 1e-3 * pixels
