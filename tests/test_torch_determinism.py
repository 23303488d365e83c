"""Reproducible training in the port: the order of K1-bwd's sums, the
keypoint head's deterministic 2x upsample, train_step's strict
deterministic mode, and two runs of a CPU step from the same seeds."""

import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F
import torch.utils.deterministic

from maskrcnn_tpu_torch.models.heads import upsample_2x
from maskrcnn_tpu_torch.ops import roi_align as roi
from maskrcnn_tpu_torch.train import losses as L
from maskrcnn_tpu_torch.train import step as train_step_module
from tests.torch_port import edge_boxes

# the 64 px gate's levels (B=2, C=16) and its canvas
SHAPES = [(2, 16, 16, 16), (2, 8, 8, 16), (2, 4, 4, 16), (2, 2, 2, 16)]
CANVAS = (64, 64)


def _sequential(grad, boxes, pool, order):
    """The level gradients [rows, C] of a float32 loop over (corner,
    sample) entries in `order` (a list of (k, sample) pairs): row +=
    g * w, each product and each sum rounded to float32; a sample
    outside its level adds nothing."""
    n = boxes.shape[1]
    lvl, in_y, in_x = roi.level_geometry(SHAPES, boxes, pool, CANVAS)
    corners, inside = roi._corners(SHAPES, lvl, in_y, in_x, n)
    c = grad.shape[-1]
    g = grad.reshape(-1, c).numpy()
    rows = [r.reshape(-1).numpy() for r, _ in corners]
    weights = [w.reshape(-1).numpy() for _, w in corners]
    live = inside.reshape(-1).numpy()
    table = np.zeros((sum(s[0] * s[1] * s[2] for s in SHAPES), c), np.float32)
    for k, i in order:
        if live[i]:
            table[rows[k][i]] = table[rows[k][i]] + g[i] * weights[k][i]
    return table


@pytest.mark.parametrize("pool", [7, 14])
def test_plain_backward_sums_corner_major(pool):
    """The plain K1-bwd (roi_align_backward_levels: one index_add_ a
    corner) equals a sequential float32 accumulation over the entries in
    K1-bwd v3's order, corners 00, 01, 10, 11 in turn and within a corner
    (box, cell row, cell col), bit for bit (compared with ==: the plain
    version adds +0.0 for a sample outside its level). Zero boxes put
    hundreds of entries on one row; the reversed order gives other bits,
    so the test pins the order."""
    rng = np.random.RandomState(pool)
    b = np.stack([edge_boxes(rng, 12) for _ in range(2)])
    b[:, -4:] = 0.0
    boxes = torch.from_numpy(b)
    grad = torch.from_numpy(rng.standard_normal(
        (2, 12, pool, pool, 16)).astype(np.float32))
    levels = roi.multilevel_roi_align_backward(grad, SHAPES, torch.float32,
                                               boxes, pool, CANVAS)
    got = torch.cat([t.reshape(-1, 16) for t in levels]).numpy()
    entries = [(k, i) for k in range(4) for i in range(24 * pool * pool)]
    assert np.array_equal(got, _sequential(grad, boxes, pool, entries))
    assert not np.array_equal(got, _sequential(grad, boxes, pool,
                                               entries[::-1]))


@pytest.mark.parametrize("shape",
                         [(5, 17, 14, 14), (3, 4, 1, 1), (2, 3, 2, 5)],
                         ids=["keypoint_head", "one_pixel", "ragged"])
def test_upsample_2x_matches_interpolate(shape):
    """upsample_2x against F.interpolate(scale_factor=2, bilinear,
    align_corners=False) in float32 on the CPU, values and gradients, on
    contiguous and channels-last inputs. Not bit-equal: the CPU's
    F.interpolate contracts each blend into a fused multiply-add, the
    port rounds the products and the sum; within 5e-7 of the inputs'
    largest |x| (4 float32 ulps), and the gradients within 1e-6 of their
    largest |g|."""
    rng = np.random.RandomState(sum(shape))
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * 10)
    g = torch.from_numpy(rng.standard_normal(
        (shape[0], shape[1], 2 * shape[2], 2 * shape[3])).astype(np.float32))
    for fmt in (torch.contiguous_format, torch.channels_last):
        a = x.clone(memory_format=fmt).requires_grad_()
        b = x.clone(memory_format=fmt).requires_grad_()
        want = F.interpolate(a, scale_factor=2, mode="bilinear",
                             align_corners=False)
        got = upsample_2x(b)
        assert got.shape == want.shape
        span = float(x.abs().max())
        assert float((got - want).abs().max()) <= 5e-7 * span
        want.backward(g)
        got.backward(g)
        gspan = float(a.grad.abs().max())
        assert float((b.grad - a.grad).abs().max()) <= 1e-6 * gspan


@pytest.mark.parametrize("caller", [(False, False), (True, True)],
                         ids=["off", "warn_only"])
def test_train_step_strict_mode_inside(monkeypatch, caller):
    """train_step runs its gradient and its update with
    torch.use_deterministic_algorithms(True), strict (not warn_only), its
    fill of uninitialized memory off, and gives the caller's settings back
    after, also when the step raises."""
    seen = []
    fill = torch.utils.deterministic.fill_uninitialized_memory

    def fake_grads(model, optimizer, batch, generator):
        seen.append((torch.are_deterministic_algorithms_enabled(),
                     torch.is_deterministic_algorithms_warn_only_enabled(),
                     torch.utils.deterministic.fill_uninitialized_memory))
        if batch.get("raise"):
            raise RuntimeError("no deterministic form")
        one = torch.ones(())
        return [torch.zeros(2)], L.Losses(*[one] * len(L.Losses._fields))

    monkeypatch.setattr(train_step_module, "_step_grads", fake_grads)
    param = torch.nn.Parameter(torch.ones(2))
    cfg = type("Cfg", (), dict(LEARNING_MOMENTUM=0.9, WEIGHT_DECAY=1e-4,
                               OPT_MOMENTUM_DTYPE="float32"))()
    opt = train_step_module.SGD(cfg, 0.1, [param], [False])
    def mode():
        return (torch.are_deterministic_algorithms_enabled(),
                torch.is_deterministic_algorithms_warn_only_enabled())

    before = mode()
    try:
        torch.use_deterministic_algorithms(caller[0], warn_only=caller[1])
        train_step_module.train_step(object(), opt, {}, None)
        assert seen == [(True, False, False)]
        assert mode() == caller
        assert torch.utils.deterministic.fill_uninitialized_memory == fill
        with pytest.raises(RuntimeError):
            train_step_module.train_step(object(), opt, {"raise": True}, None)
        assert mode() == caller
        assert torch.utils.deterministic.fill_uninitialized_memory == fill
    finally:
        torch.use_deterministic_algorithms(before[0], warn_only=before[1])
    assert int(opt.step) == 1


def test_cublas_workspace_config_set():
    """Importing maskrcnn_tpu_torch.train leaves CUBLAS_WORKSPACE_CONFIG
    at a value cuBLAS runs deterministically with (the strict mode refuses
    cuBLAS otherwise)."""
    import maskrcnn_tpu_torch.train  # noqa: F401
    assert os.environ.get("CUBLAS_WORKSPACE_CONFIG") in (":4096:8", ":16:8")


def test_two_cpu_runs_equal():
    """Two runs of the 64 px gate's TinyConfig, a step each on the CPU
    from the same seeds (tools/learning_torch.train: seeded init, batches
    from numpy seed 3, the samplers' generator seed 1): the float32
    states' SHA-256 and every step's losses equal."""
    from tools import learning_torch as lt
    cfg = lt.gate_config()
    runs = []
    for _ in range(2):
        trace = []
        _, info = lt.train(cfg, lt.batches(lt.train_batch,
                                           np.random.RandomState(3), cfg, 4),
                           1, "cpu", log_every=0, trace=trace)
        runs.append((info["state_sha256"],
                     torch.stack([torch.stack(list(m.values()))
                                  for m in trace])))
    assert runs[0][0] == runs[1][0]
    assert torch.equal(runs[0][1], runs[1][1])
