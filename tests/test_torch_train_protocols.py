"""The port's training losses against the JAX package's (jitted forward,
no JAX gradient) at TinyConfig on JAX weights, for the branches the
float32 step test leaves out, and in bf16:

* Cascade R-CNN (0.5, 0.6, 0.7) with CASCADE_MASK_LAST and a keypoint
  head (3 keypoints, two conv32 layers), float32: the six losses within
  1e-5 relative, 1e-6 absolute (measured: within 4.5e-6 relative,
  mrn_box; the others within 7.6e-7);
* the plain config in bf16 (float32 master weights, bf16 compute): each
  loss within 2e-2 relative plus 1e-2 absolute. The packages round at
  other places: the port's RoIAlign blends in float32 and rounds once
  where the JAX package's XLA route blends in bf16 (ROADMAP Queue 3),
  and the convolutions sum in other orders; the box loss averages
  smooth-L1 over bf16 deltas near 1, whose last bit is 2^-7 = 7.8e-3.
  Measured: mrn_box 5.6e-3 apart (0.1127 against 0.1184), every other
  loss within 7.6e-4 relative.
Both scenes are in the samplers' deterministic regime
(tests/torch_port.train_config, train_batch)."""

import jax
import numpy as np
import pytest
import torch

from maskrcnn_tpu.config import TinyConfig as JaxTiny
from maskrcnn_tpu.models.mask_rcnn import MaskRCNN as JaxMaskRCNN
from maskrcnn_tpu.train import step as jstep
from maskrcnn_tpu_torch.checkpoint.convert import load_jax_params
from maskrcnn_tpu_torch.models.mask_rcnn import MaskRCNN
from maskrcnn_tpu_torch.train import step as pstep
from maskrcnn_tpu_torch.train.trainer import to_device
from tests.torch_port import jax_params, port_config, train_batch, train_config

CASCADE = train_config(JaxTiny(), CASCADE_STAGES=(0.5, 0.6, 0.7),
                       CASCADE_MASK_LAST=True, NUM_KEYPOINTS=3,
                       KEYPOINT_HEAD_CONVS=2, KEYPOINT_HEAD_DIM=32)
BF16 = train_config(JaxTiny(), COMPUTE_DTYPE="bfloat16")
BASE_BRANCHES = ("fpn", "rpn", "box_head", "mask_head")


@pytest.fixture(scope="module")
def params():
    return jax_params(CASCADE)


def losses_of(cfg, params, keypoints=0):
    """(port losses, JAX losses) of one batch made from the port model's
    proposals."""
    model = MaskRCNN(port_config(cfg), "cpu", train=True)
    load_jax_params(model, params)
    batch = train_batch(cfg, model, keypoints=keypoints)
    with torch.no_grad():
        got = pstep.compute_losses(model, torch.Generator().manual_seed(0),
                                   to_device(batch, "cpu"))
    jmodel = JaxMaskRCNN(cfg)
    want = jax.jit(lambda p: jstep.compute_losses(
        jmodel, p, jax.random.PRNGKey(0), batch))(params)
    return ({k: float(v) for k, v in got.as_dict().items()},
            {k: float(v) for k, v in want.as_dict().items()})


def test_cascade_mask_last_keypoints_losses_equal_jax(params):
    got, want = losses_of(CASCADE, params, keypoints=3)
    assert want["mrn_kp"] > 0 and want["mrn_mask"] > 0
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_bf16_losses_near_jax(params):
    base = {k: v for k, v in params.items() if k in BASE_BRANCHES}
    got, want = losses_of(BF16, base)
    assert want["mrn_class"] > 0
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=2e-2, atol=1e-2,
                                   err_msg=k)
