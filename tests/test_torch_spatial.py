"""The spatial axis of the port (maskrcnn_tpu_torch/parallel/spatial.py,
Config.SP_DEVICES) on the CPU.

* The halo plan, op by op, at sp = 2 and 4 through the in-process
  transport (every shard on the CPU): each H op of the backbone on row
  shards, gathered, against the op on the whole map: bit-equal.
* P2-P6 of the TinyConfig backbone on two row shards against the
  unsharded backbone: bit-equal in float32; under FOLD_BN (K3's plain
  version on halo-extended slabs) within 1e-5 of each level's range,
  since the plain version's products at another row count may sum in
  another blocking (measured 1.1e-6 at four shards).
* The autograd Functions of the exchange and the gather, gradcheck'd in
  float64.
* The Detector: Detector(NUM_DEVICES=4, SP_DEVICES=2) on three images
  pads to the data width 2 and matches the JAX package's Detector on the
  same weights with tests/test_spatial.py's metrics (the JAX package
  holds its sp mesh equal to its unpartitioned step there).
* Training: four gloo ranks, dp = 2 x sp = 2 (tests/torch_sp_worker.py),
  one step with REMAT_BACKBONE on and off, against the port's one-process
  step on the global batch and the JAX package's train_step, within
  1e-5 of each tensor's largest value, as tests/test_torch_parallel.py.
* coco_torch.py --sp: evaluate in process, train (Trainer.fit) under
  torch.distributed.run with two gloo ranks.
* The config checks: BATCH_SIZE under sp, the canvas height's ValueError.
* QUANT_INT8 on row shards: bit-equal to the unsharded int8 port on the
  inputs where tests/test_torch_pipeline_quant.py holds that to the JAX
  package's int8 predict_step.
"""

import copy
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from maskrcnn_tpu.api import Detector as JaxDetector
from maskrcnn_tpu.config import TinyConfig as JaxTiny
from maskrcnn_tpu_torch import api
from maskrcnn_tpu_torch.api import Detector
from maskrcnn_tpu_torch.checkpoint.convert import from_jax_params
from maskrcnn_tpu_torch.config import TinyConfig
from maskrcnn_tpu_torch.models.fpn import nearest_upsample_2x
from maskrcnn_tpu_torch.models.layers import Conv2d
from maskrcnn_tpu_torch.models.mask_rcnn import MaskRCNN
from maskrcnn_tpu_torch.models.resnet import stem_pool
from maskrcnn_tpu_torch.parallel import spatial
from tests.test_torch_parallel import (CFG, LR, LOSS_RTOL, ROOT, _anchor_gt,
                                       _close, _free_port, _jax_step,
                                       _one_process_step, _port_model)
from tests.torch_port import jax_params, train_batch

CL = torch.channels_last


def _shards(x, sp):
    h = x.shape[2] // sp
    return [x[:, :, i * h:(i + 1) * h].contiguous(memory_format=CL)
            for i in range(sp)]


def _conv(cin, cout, k, stride=1, padding=0):
    conv = Conv2d(cin, cout, k, stride=stride, padding=padding)
    with torch.no_grad():
        conv.bias.normal_(generator=torch.Generator().manual_seed(3))
    return conv.to(memory_format=CL)


# op -> (input channels, the op on the whole map, the op on the shards of
# transport t); the convs carry seeded weights
def _ops():
    torch.manual_seed(0)
    stem = _conv(3, 8, 7, 2, 3)
    c3 = _conv(8, 8, 3, 1, 1)
    c1 = _conv(8, 16, 1, 2)
    inf = float("-inf")
    return {
        "stem_conv": (3, stem, lambda t, xs: [
            spatial.conv_rows(stem, s)
            for s in spatial.exchange(t, xs, 3, 2, 0.0)]),
        "stem_pool": (8, stem_pool, lambda t, xs: [
            spatial.pool_rows(s)
            for s in spatial.exchange(t, xs, 0, 1, inf)]),
        "conv3x3": (8, c3, lambda t, xs: [
            spatial.conv_rows(c3, s)
            for s in spatial.exchange(t, xs, 1, 1, 0.0)]),
        "conv1x1_stride2": (8, c1, lambda t, xs: [c1(x) for x in xs]),
        "upsample": (8, nearest_upsample_2x,
                     lambda t, xs: [nearest_upsample_2x(x) for x in xs]),
        "p6": (8, lambda x: x[:, :, ::2, ::2],
               lambda t, xs: [x[:, :, ::2, ::2] for x in xs]),
    }


@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("op", list(_ops()))
def test_halo_plan_op_equals_unsharded(op, sp):
    """Each H op of the halo plan on `sp` row shards (interior shards read
    their neighbours' rows, the edge shards the edge value) equals the op
    on the whole map, bit for bit."""
    cin, whole, sharded = _ops()[op]
    rng = np.random.RandomState(sp)
    x = torch.from_numpy(rng.randn(2, cin, 16 * sp, 12).astype(np.float32)
                         ).contiguous(memory_format=CL)
    # the transport places the shards by its models' device: any module
    t = spatial.InProcess([_conv(1, 1, 1)] * sp)
    with torch.no_grad():
        want = whole(x)
        got = spatial.gather(t, sharded(t, _shards(x, sp)))
    assert got.shape == want.shape
    assert torch.equal(got, want), float((got - want).abs().max())


@pytest.mark.parametrize("fold", [False, True])
def test_fpn_levels_equal_unsharded(fold):
    """P2-P6 of the TinyConfig backbone on two row shards (each shard on
    its own weight replica) against the whole canvas: float32 bit-equal;
    FOLD_BN's identity blocks as K3's plain version on slabs extended by a
    neighbour row, within 1e-5 of each level's range (four shards: the op
    tests above and chip_smoke phase 10a)."""
    sp, h = 2, 128
    cfg = TinyConfig(FOLD_BN=fold)
    model = MaskRCNN(cfg, "cpu").init(torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.RandomState(1).randn(2, h, h, 3)
                         .astype(np.float32))
    with torch.no_grad():
        want = model.backbone(x)
        model.spatial = spatial.InProcess(
            [model] + [copy.deepcopy(model) for _ in range(sp - 1)])
        got = model.backbone(x)
    for lvl, (a, b) in enumerate(zip(want, got), start=2):
        # the same NHWC layout (P6 a strided view of P5 on both)
        assert a.shape == b.shape and a.stride() == b.stride(), f"P{lvl}"
        if fold:
            tol = 1e-5 * float(a.max() - a.min())
            assert float((a - b).abs().max()) <= tol, f"P{lvl}"
        else:
            assert torch.equal(a, b), f"P{lvl}"


@pytest.mark.parametrize("fill", [0.0, float("-inf"), None])
def test_exchange_gradcheck(fill):
    """The exchange's backward (each halo's gradient sent back to the
    shard owning its rows and added there), float64, three shards; fill
    None extends only where a neighbour is (FOLD_BN's K3 slabs)."""
    rng = np.random.RandomState(0)
    xs = [torch.from_numpy(rng.randn(1, 2, 4, 3)).requires_grad_()
          for _ in range(3)]
    t = spatial.InProcess([_conv(1, 1, 1)] * 3)
    above, below = (0, 1) if fill == float("-inf") else (3, 2)
    if fill is None:
        above = below = 1

    def fn(*xs):
        # -inf rows carry no gradient; keep the checked outputs finite
        return tuple(torch.nan_to_num(s, neginf=0.0)
                     for s in spatial.exchange(t, xs, above, below, fill))

    assert torch.autograd.gradcheck(fn, xs)


def test_gather_gradcheck():
    """The gather's backward is the local slice of the incoming gradient,
    float64, four shards."""
    rng = np.random.RandomState(1)
    xs = [torch.from_numpy(rng.randn(2, 3, 2, 5)).requires_grad_()
          for _ in range(4)]
    t = spatial.InProcess([_conv(1, 1, 1)] * 4)
    assert torch.autograd.gradcheck(lambda *xs: spatial.gather(t, xs), xs)


def test_detector_pads_to_data_width_and_matches_jax(monkeypatch):
    """Detector(NUM_DEVICES=4, SP_DEVICES=2) on three images: two groups
    of two CPU replicas, the batch padded to the data width 2 (two
    images a group), against the JAX Detector on the same weights with
    tests/test_spatial.py's metrics: class ids equal, scores within 1e-3,
    boxes within 0.5 px, mask pixels apart under 1%."""
    cfg = JaxTiny(DETECTION_MIN_CONFIDENCE=0.0)
    params = jax_params(cfg)
    rng = np.random.RandomState(7)
    images = [rng.randint(0, 256, (96, 128, 3), np.uint8)
              for _ in range(3)]
    det = Detector(TinyConfig(NUM_DEVICES=4, SP_DEVICES=2,
                              DETECTION_MIN_CONFIDENCE=0.0), "cpu")
    det.load_jax_params(params)
    batches = []
    step = api.predict_step

    def recording(model, images, windows):
        batches.append((model.spatial.size, images.shape[0]))
        return step(model, images, windows)

    monkeypatch.setattr(api, "predict_step", recording)
    got = det.detect_batch(images)
    assert batches == [(2, 2), (2, 2)]
    assert len(det._replicas) == 4
    want = JaxDetector(cfg, params=params).detect_batch(images)
    assert len(got) == 3
    found = 0
    for r, o in zip(want, got):
        assert (r is None) == (o is None)
        if r is None:
            continue
        found += len(r[0])
        np.testing.assert_array_equal(r[0], o[0])
        np.testing.assert_allclose(r[1], o[1], atol=1e-3)
        np.testing.assert_allclose(np.asarray(r[2]), np.asarray(o[2]),
                                   atol=0.5)
        assert np.mean(np.asarray(r[3]) != np.asarray(o[3])) < 0.01
    assert found > 0


@pytest.fixture(scope="module")
def sp_runs(tmp_path_factory):
    """Four gloo ranks (dp = 2 x sp = 2) on the two-image batch, their
    results for REMAT_BACKBONE on and off, and, computed while they run,
    the port's one-process step and the JAX package's train_step on the
    global batch."""
    params = jax_params(CFG)
    model = _port_model(params)
    # tests/test_torch_parallel.py's scene: the two images' RPN positive
    # counts differ, so averaging per rank or per group would show
    batch = _anchor_gt(model, train_batch(CFG, model, b=2), 0)
    tmp = tmp_path_factory.mktemp("sp")
    fields = {f.name: getattr(CFG, f.name)
              for f in dataclasses.fields(CFG)}
    data = {"config": np.asarray(json.dumps(fields)), "lr": np.float64(LR)}
    data.update({f"state.{k}": v for k, v in
                 from_jax_params(params, CFG.BACKBONE).items()})
    data.update({f"batch.{k}": v for k, v in batch.items()})
    np.savez(tmp / "in.npz", **data)
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tests.torch_sp_worker", str(r), "4", "2",
         str(port), str(tmp / "in.npz"), str(tmp / "out.npz")],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(4)]
    try:
        one = {"port": _one_process_step(params, batch),
               "jax": _jax_step(params, batch)}
    finally:
        logs = [p.communicate(timeout=600) for p in procs]
    for p, (_, err) in zip(procs, logs):
        assert p.returncode == 0, err[-3000:]
    with np.load(tmp / "out.npz") as z:
        out = {k: z[k] for k in z.files}
    return params, out, one


@pytest.mark.parametrize("run", ["remat", "plain"])
def test_sp_step_equals_one_process_step(sp_runs, run):
    """The dp x sp step (REMAT_BACKBONE on: the stages' exchanges recomputed
    in the backward pass; off) against the port's one-process step."""
    params, out, one = sp_runs
    losses, weights = one["port"]
    before = from_jax_params(params, CFG.BACKBONE)
    for k, v in losses.items():
        np.testing.assert_allclose(out[f"{run}.loss.{k}"], v,
                                   rtol=LOSS_RTOL, atol=1e-7, err_msg=k)
    for n, w in weights.items():
        _close(out[f"{run}.param.{n}"], w, n, before[n])


@pytest.mark.parametrize("run", ["remat", "plain"])
def test_sp_step_equals_jax_train_step(sp_runs, run):
    """The dp x sp step against one step of the JAX package's train_step
    on the global batch (tests/test_spatial.py holds the JAX sp mesh's
    step equal to it)."""
    params, out, one = sp_runs
    losses, after = one["jax"]
    before = from_jax_params(params, CFG.BACKBONE)
    for k in ("total", "rpn_class", "rpn_box", "mrn_class", "mrn_box",
              "mrn_mask"):
        np.testing.assert_allclose(out[f"{run}.loss.{k}"],
                                   float(getattr(losses, k)),
                                   rtol=LOSS_RTOL, atol=1e-6, err_msg=k)
    for n in (k[len(f"{run}.param."):] for k in out
              if k.startswith(f"{run}.param.")):
        _close(out[f"{run}.param.{n}"], after[n], n, before[n])


def test_coco_torch_cli_with_sp(monkeypatch, tmp_path, capsys):
    """coco_torch.py --sp at TinyConfig on the CPU: `evaluate --devices 2
    --sp 2` runs one group of two replicas and prints both summaries;
    `train --devices 2 --sp 2` under torch.distributed.run (two gloo
    ranks, tests/torch_sp_worker.py coco) trains a step, validates and
    writes the epoch's checkpoint, the two ranks of the sp group given
    the same batches (the loader flips at random and its worker threads
    finish in any order: the group's first rank reads and broadcasts)."""
    import shutil
    import coco_torch
    from tests.torch_port import synthetic_coco_dir
    root = Path(synthetic_coco_dir(tmp_path))
    monkeypatch.setattr(coco_torch, "CocoInferenceConfig", lambda **kw:
                        TinyConfig(DETECTION_MIN_CONFIDENCE=0.0, **kw))
    coco_torch.main(["evaluate", "--dataset", str(root), "--limit", "3",
                     "--device", "cpu", "--devices", "2", "--sp", "2",
                     "--model", str(tmp_path / "none")])
    assert capsys.readouterr().out.count(
        "Average Precision  (AP) @[ IoU=0.50:0.95 | area=   all | "
        "maxDets=100 ]") == 2
    shutil.copytree(root / "val2014", root / "train2014")
    shutil.copy(root / "annotations" / "instances_minival2014.json",
                root / "annotations" / "instances_train2014.json")
    logs = tmp_path / "logs"
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "tests.torch_sp_worker", "coco",
         "train", "--dataset", str(root), "--device", "cpu", "--devices",
         "2", "--sp", "2", "--epochs", "1", "--steps-per-epoch", "1",
         "--logs", str(logs), "--model", str(tmp_path / "none.pth")],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT,
                           SP_BATCH_LOG=str(tmp_path / "batches")),
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "Data-parallel: 2 ranks" in proc.stdout
    assert "epoch 1 step 1/1 total=" in proc.stdout
    assert (logs / "epoch_0001" / "checkpoint.pth").exists()
    seen = [json.loads((tmp_path / f"batches.{r}").read_text())
            for r in range(2)]
    # the training step's batch and the validation step's
    assert len(seen[0]) == 2 and seen[0] == seen[1], seen


def test_batch_size_under_sp():
    """The global batch is IMAGES_PER_DEVICE x the data width."""
    cfg = TinyConfig(NUM_DEVICES=8, IMAGES_PER_DEVICE=2, SP_DEVICES=2)
    assert cfg.BATCH_SIZE == 8
    assert cfg.BATCH_SIZE == JaxTiny(NUM_DEVICES=8, IMAGES_PER_DEVICE=2,
                                     SP_DEVICES=2).BATCH_SIZE


@pytest.mark.parametrize("overrides", [
    dict(SP_DEVICES=4, NUM_DEVICES=4),            # 128 % 256
    dict(SP_DEVICES=2, NUM_DEVICES=2, IMAGE_CANVAS=(192, 128)),
    dict(SP_DEVICES=2, NUM_DEVICES=3)])
def test_unsplittable_layout_raises(overrides):
    """A canvas height that is not a multiple of 64 * SP_DEVICES, or an
    SP_DEVICES that does not divide NUM_DEVICES, raises ValueError naming
    SP_DEVICES."""
    with pytest.raises(ValueError, match="SP_DEVICES"):
        MaskRCNN(TinyConfig(**overrides), "cpu")


def test_int8_sharded_predict_step_matches_jax():
    """QUANT_INT8 on two row shards, on the inputs of
    tests/test_torch_pipeline_quant.py's int8-head case (its config, the
    JAX package's prepared int8 tree from the same seeded weights and
    calibration, its canvases): the sharded int8 traversal (halos moved
    as int8, so every accumulator is the unsharded conv's) gives the
    unsharded port's outputs bit for bit, which that test holds to the
    JAX package's int8 predict_step (run there op by op: 38 s on the
    CPU)."""
    from maskrcnn_tpu import quant as jq
    from maskrcnn_tpu.models.mask_rcnn import MaskRCNN as JaxMaskRCNN
    from maskrcnn_tpu_torch import quant as pq
    from maskrcnn_tpu_torch.checkpoint.convert import from_jax_quant_params
    from maskrcnn_tpu_torch.detection.pipeline import predict_step
    from tests.test_torch_pipeline import _images
    from tests.test_torch_pipeline_quant import PORT, QCFG
    from tests.torch_port import torch_model
    params = jax_params(QCFG)
    model = torch_model(PORT, params)
    stats = pq.calibrate(model, model.float_state,
                         pq.default_calib_canvases(QCFG.IMAGE_SHAPE, n=2))
    tree = jq.prepare_quant_params(JaxMaskRCNN(QCFG), params,
                                   act_stats=stats)
    model.set_quant(from_jax_quant_params(tree))
    images, windows = _images(np.random.RandomState(7), 2)
    x, win = torch.from_numpy(images), torch.from_numpy(windows)
    whole = predict_step(model, x, win)
    assert whole["valid"].any()
    model.spatial = spatial.InProcess([model, copy.deepcopy(model)])
    got = predict_step(model, x, win)
    for k, v in whole.items():
        assert torch.equal(got[k], v), k
