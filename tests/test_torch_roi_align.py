"""The port's plain RoIAlign against the JAX package: level routing and
sample points bit for bit, the batched blend against the XLA path and
the Pallas kernel in interpret mode."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import maskrcnn_tpu.ops.roi_align_pallas as rap
from maskrcnn_tpu.ops import roi_align as jax_roi
from maskrcnn_tpu_torch.ops import roi_align as port_roi
from tests.torch_port import edge_boxes

CANVAS = (1024, 1024, 3)
LEVELS = (256, 128, 64, 32)


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(
        rap.pl, "pallas_call",
        functools.partial(rap.pl.pallas_call, interpret=True))


@pytest.mark.parametrize("canvas", [CANVAS, (128, 128, 3)],
                         ids=["1024", "128"])
def test_roi_levels_equal(canvas):
    rng = np.random.RandomState(0)
    boxes = np.concatenate([edge_boxes(rng, 400),
                            rng.rand(400, 4).astype(np.float32) * 0.05])
    boxes[400:, 2:] += boxes[400:, :2]
    got = port_roi.roi_levels(torch.from_numpy(boxes), canvas).numpy()
    want = np.asarray(jax_roi.roi_levels(jnp.asarray(boxes), canvas))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert set(np.unique(got)) <= {0, 1, 2, 3}


@pytest.mark.parametrize("pool", [7, 14])
def test_sample_points_bit_equal(pool):
    """Clipped boxes reaching 1.0 put samples exactly on the last row or
    column; one ulp decides between read and extrapolated."""
    rng = np.random.RandomState(pool)
    n = 20000
    lo = rng.rand(n, 2).astype(np.float32)
    hi = np.maximum(lo, np.where(rng.rand(n, 2) < 0.5, np.float32(1.0),
                                 rng.rand(n, 2).astype(np.float32)))
    boxes = np.concatenate([lo, hi], 1).astype(np.float32)
    hm = rng.choice([255.0, 127.0, 63.0, 31.0], n).astype(np.float32)
    wm = rng.choice([255.0, 127.0, 63.0, 31.0], n).astype(np.float32)
    got = port_roi.sample_points(torch.from_numpy(boxes),
                                 torch.from_numpy(hm), torch.from_numpy(wm),
                                 pool)
    want = jax_roi.sample_points(jnp.asarray(boxes), jnp.asarray(hm),
                                 jnp.asarray(wm), pool)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().view(np.uint32),
                                      np.asarray(w).view(np.uint32))


@pytest.mark.parametrize("pool", [7, 14])
def test_multilevel_roi_align_matches_jax(pool):
    """f32, B=2, edge boxes; tolerance covers the 4-tap sum taken in a
    different order."""
    rng = np.random.RandomState(pool)
    feats = [rng.rand(2, s, s, 128).astype(np.float32) for s in LEVELS]
    boxes = np.stack([edge_boxes(rng, 40), edge_boxes(rng, 40)[::-1]])
    got = port_roi.multilevel_roi_align(
        [torch.from_numpy(f) for f in feats], torch.from_numpy(boxes), pool,
        CANVAS).numpy()
    assert got.shape == (2, 40, pool, pool, 128)
    pallas = np.asarray(rap.batched_multilevel_roi_align_pallas(
        [jnp.asarray(f) for f in feats], jnp.asarray(boxes), pool, CANVAS))
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-5)
    for i in range(2):
        want = np.asarray(jax_roi.multilevel_roi_align(
            [jnp.asarray(f[i]) for f in feats], jnp.asarray(boxes[i]), pool,
            CANVAS))
        np.testing.assert_allclose(got[i], want, rtol=1e-5, atol=1e-5,
                                   err_msg=f"image {i}")


def test_multilevel_roi_align_small_levels():
    """The 128-px config's levels (32..4 px), below the Pallas patch
    window: the port makes no assumption about level sizes."""
    rng = np.random.RandomState(1)
    feats = [rng.randn(2, s, s, 64).astype(np.float32) for s in (32, 16, 8, 4)]
    boxes = np.stack([edge_boxes(rng, 24), edge_boxes(rng, 24)])
    got = port_roi.multilevel_roi_align_impl(
        [torch.from_numpy(f) for f in feats], torch.from_numpy(boxes), 7,
        (128, 128, 3)).numpy()
    for i in range(2):
        want = np.asarray(jax_roi.multilevel_roi_align(
            [jnp.asarray(f[i]) for f in feats], jnp.asarray(boxes[i]), 7,
            (128, 128, 3)))
        np.testing.assert_allclose(got[i], want, rtol=1e-5, atol=1e-5)


def test_bf16_blends_in_f32():
    """bf16 levels: the result is the f32 blend of the same values,
    rounded once (the contract the CUDA kernel meets)."""
    rng = np.random.RandomState(2)
    feats = [torch.from_numpy(rng.randn(1, s, s, 32).astype(np.float32))
             .to(torch.bfloat16) for s in LEVELS]
    boxes = torch.from_numpy(edge_boxes(rng, 30)[None])
    got = port_roi.multilevel_roi_align(feats, boxes, 7, CANVAS)
    want = port_roi.multilevel_roi_align([f.float() for f in feats], boxes,
                                         7, CANVAS)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, want.to(torch.bfloat16), rtol=0, atol=0)


@pytest.mark.parametrize("pool", [7, 14])
@pytest.mark.parametrize("tables", ["float32", "int8"])
def test_impl_on_the_cpu_is_the_plain_version(pool, tables):
    """On the CPU the dispatch is the plain version with its PyTorch
    coordinate prologue, bit for bit, at both heads' pool sizes and in
    int8-table mode."""
    rng = np.random.RandomState(pool)
    if tables == "int8":
        feats = [torch.from_numpy(rng.randint(-127, 128, (2, s, s, 32))
                                  .astype(np.int8)) for s in LEVELS]
        extra = ([0.021, 0.017, 0.032, 0.009], torch.bfloat16)
    else:
        feats = [torch.from_numpy(rng.randn(2, s, s, 32).astype(np.float32))
                 for s in LEVELS]
        extra = ()
    boxes = torch.from_numpy(np.stack([edge_boxes(rng, 30),
                                       edge_boxes(rng, 30)[::-1]]))
    got = port_roi.multilevel_roi_align_impl(feats, boxes, pool, CANVAS,
                                             *extra)
    want = port_roi.multilevel_roi_align(feats, boxes, pool, CANVAS, *extra)
    assert got.shape == (2, 30, pool, pool, 32) and got.dtype == want.dtype
    assert torch.equal(got, want)


@pytest.mark.parametrize("canvas", [CANVAS, (128, 128, 3), (800, 1333, 3)],
                         ids=["1024", "128", "800x1333"])
def test_level_divisor_is_the_jax_float32(canvas):
    """The kernel takes the level rule's divisor as a float argument: the
    float32 of 224 / sqrt(area), the value the JAX package divides by."""
    area = float(canvas[0]) * float(canvas[1])
    got = port_roi.level_divisor(canvas)
    assert got == float(np.float32(224.0 / np.sqrt(area)))
    assert np.float32(got) == got


@pytest.mark.parametrize("pool", [7, 14])
def test_kernel_prologue_order_is_level_geometry(pool):
    """csrc/roi_align.cu computes the prologue per box and cell in this
    order, one float32 rounding an operation: level = rint(4 + log2(
    sqrt(h*w) / divisor)) clamped to [2, 5], minus 2; in_y = (y1*(H-1)) +
    r * (((y2-y1)*(H-1)) / (P-1)). In numpy float32 that order gives
    level_geometry's levels and sample points bit for bit, edge boxes and
    boxes reaching 1.0 included."""
    rng = np.random.RandomState(pool)
    lo = rng.rand(3000, 2).astype(np.float32)
    hi = np.maximum(lo, np.where(rng.rand(3000, 2) < 0.3, np.float32(1.0),
                                 rng.rand(3000, 2).astype(np.float32)))
    boxes = np.concatenate([edge_boxes(rng, 40),
                            np.concatenate([lo, hi], 1)]).astype(np.float32)
    feats = [torch.zeros(1, s, s, 8) for s in LEVELS]
    lvl, in_y, in_x = port_roi.level_geometry(
        feats, torch.from_numpy(boxes[None]), pool, CANVAS)

    f32 = np.float32
    y1, x1, y2, x2 = boxes.T
    div = f32(port_roi.level_divisor(CANVAS))
    with np.errstate(divide="ignore"):
        raw = f32(4.0) + np.log2(np.sqrt((y2 - y1) * (x2 - x1)) / div)
    level = (np.clip(np.rint(raw), f32(2.0), f32(5.0)) - f32(2.0)).astype(
        np.int32)
    np.testing.assert_array_equal(lvl.numpy(), level)
    extent = np.array([s - 1.0 for s in LEVELS], np.float32)[level]
    steps = np.arange(pool, dtype=np.float32)
    pm1 = f32(pool - 1)
    hs = ((y2 - y1) * extent) / pm1
    ws = ((x2 - x1) * extent) / pm1
    want_y = (y1 * extent)[:, None] + steps * hs[:, None]
    want_x = (x1 * extent)[:, None] + steps * ws[:, None]
    for got, want in ((in_y, want_y), (in_x, want_x)):
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      want.astype(np.float32).view(np.uint32))

