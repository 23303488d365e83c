"""K1's int8-table mode: the port's plain blend (the CUDA kernel's plain
version) against the Pallas kernel with `level_scales` in interpret
mode, the pipeline's `_pool_rois(quant_scales=...)` glue against the JAX
package's, and the kernel wrapper's checks on the CPU."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import maskrcnn_tpu.ops.roi_align_pallas as rap
from maskrcnn_tpu.detection import pipeline as jax_pipe
from maskrcnn_tpu_torch import kernels
from maskrcnn_tpu_torch.detection import pipeline as port_pipe
from maskrcnn_tpu_torch.ops import roi_align as port_roi
from maskrcnn_tpu_torch.quant import Scale
from tests.torch_port import edge_boxes

CANVAS = (1024, 1024, 3)
LEVELS = (256, 128, 64, 32)
SCALES = [np.float32(s) for s in (0.021, 0.017, 0.032, 0.009)]


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(
        rap.pl, "pallas_call",
        functools.partial(rap.pl.pallas_call, interpret=True))


def _case(pool):
    """int8 tables at the 1024² level sizes, B=2, C=128, 24 boxes an image
    with the edge boxes (tests/test_roi_align_pallas.py:56)."""
    rng = np.random.RandomState(pool)
    feats = [rng.randint(-127, 128, (2, s, s, 128)).astype(np.int8)
             for s in LEVELS]
    boxes = np.stack([edge_boxes(rng, 24), edge_boxes(rng, 24)[::-1]])
    return feats, boxes


def _bf16_ulp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bfloat16 spacing at the larger magnitude of a and b."""
    big = torch.maximum(a.float().abs(), b.float().abs())
    _, exp = torch.frexp(big)
    return torch.ldexp(torch.ones_like(big), exp - 8)


@pytest.mark.parametrize("pool", [7, 14])
def test_int8_blend_matches_pallas(pool):
    """float32 out within 1e-5 relative and 1e-6 absolute (the Pallas
    kernel folds the scale into its y-blend and contracts x by a matmul:
    another order); bf16 out within 1 bf16 ulp of the Pallas kernel's."""
    feats, boxes = _case(pool)
    want = np.asarray(rap.batched_multilevel_roi_align_pallas(
        [jnp.asarray(f) for f in feats], jnp.asarray(boxes), pool, CANVAS,
        level_scales=SCALES, out_dtype=jnp.float32))
    levels = [torch.from_numpy(f) for f in feats]
    got = port_roi.multilevel_roi_align(
        levels, torch.from_numpy(boxes), pool, CANVAS,
        level_scales=[float(s) for s in SCALES], out_dtype=torch.float32)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    got16 = port_roi.multilevel_roi_align_impl(
        levels, torch.from_numpy(boxes), pool, CANVAS,
        level_scales=[float(s) for s in SCALES], out_dtype=torch.bfloat16)
    assert got16.dtype == torch.bfloat16
    # one rounding of the float32 blend
    assert torch.equal(got16, got.to(torch.bfloat16))
    # the Pallas kernel's bf16 out is its float32 result rounded once: at
    # most 1 bf16 ulp apart, except where the two float32 results, within
    # 1e-6 of each other, straddle a rounding boundary of a value near 0
    pallas16 = torch.from_numpy(want.copy()).to(torch.bfloat16).float()
    apart = (got16.float() - pallas16).abs()
    assert bool((apart <= torch.maximum(_bf16_ulp(got16, pallas16),
                                        torch.tensor(2e-6))).all())
    assert kernels.roi_align.launches == 0


def test_int8_blend_is_the_scaled_float_blend():
    """Same inputs, same order: the int8 blend equals the float32 blend of
    the int8 values, times the level's scale, bit for bit."""
    feats, boxes = _case(7)
    levels = [torch.from_numpy(f) for f in feats]
    b = torch.from_numpy(boxes)
    lvl, in_y, in_x = port_roi.level_geometry(levels, b, 7, CANVAS)
    got = port_roi.roi_align_levels(levels, lvl, in_y, in_x, 24,
                                    [float(s) for s in SCALES],
                                    torch.float32)
    plain = port_roi.roi_align_levels([f.float() for f in levels], lvl,
                                      in_y, in_x, 24)
    scale = torch.tensor(np.array(SCALES))[lvl.long()]
    assert torch.equal(got, plain * scale[:, None, None, None])


def test_pool_rois_quant_glue_matches_jax():
    """The port's `_pool_rois(quant_scales)` (quantize with the RPN's
    scales, int8 tables, out in the maps' dtype) against JAX
    `_pool_rois(impl="pallas", quant_scales=...)`, P2..P6 maps given."""
    rng = np.random.RandomState(3)
    feats = [(rng.rand(1, s, s, 128) * 2 - 1).astype(np.float32)
             for s in LEVELS + (16,)]
    boxes = edge_boxes(rng, 24)[None]
    scales = [np.float32(1.0 / 127.0), np.float32(0.011),
              np.float32(0.0093), np.float32(0.02)]
    want = np.asarray(jax_pipe._pool_rois(
        [jnp.asarray(f) for f in feats], jnp.asarray(boxes), 7, CANVAS,
        impl="pallas", quant_scales=[jnp.float32(s) for s in scales]))
    got = port_pipe._pool_rois(
        [torch.from_numpy(f) for f in feats], torch.from_numpy(boxes), 7,
        CANVAS, quant_scales=[Scale(float(s), torch.tensor(s))
                              for s in scales])
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_int8_wrapper_checks_before_the_build():
    """CPU tensors, and int8 tables without scales or out dtype, raise
    before nvcc is needed."""
    levels = [torch.zeros(2, s, s, 16, dtype=torch.int8) for s in (16, 8,
                                                                   4, 2)]
    lvl = torch.zeros(6, dtype=torch.int32)
    coords = torch.zeros(6, 7)
    boxes = torch.zeros(6, 4)
    canvas = (64, 64, 3)
    with pytest.raises(ValueError, match="level_scales"):
        kernels.roi_align(levels, boxes, 7, canvas)
    with pytest.raises(TypeError, match="out_dtype"):
        kernels.roi_align(levels, boxes, 7, canvas, [1.0] * 4)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.roi_align(levels, boxes, 7, canvas, [1.0] * 4,
                          torch.bfloat16)
    with pytest.raises(ValueError, match="int8 levels only"):
        kernels.roi_align([f.float() for f in levels], boxes, 7, canvas,
                          [1.0] * 4)
    with pytest.raises(ValueError, match="level_scales"):
        port_roi.roi_align_levels(levels, lvl, coords, coords, 3)
    assert kernels.roi_align.launches == kernels.roi_align.int8_launches == 0
