"""The port's training data path against the JAX package's, on the same
numpy-seeded inputs (both sides numpy and, in the JAX package, Pillow):
`encode_boxes`/`encode_masks`, `DetectionDataset.sample` (ArrayDataset
and CocoDataset), the `Augmenter` under one `random` seed,
`SyntheticLoader` and `BatchLoader` batches: all equal, bit for bit.
Then the port's checkpoint store (save, resume, pruning, BEST),
`coco_torch.py train` for one tiny epoch on a synthetic COCO directory,
whose checkpoint `Trainer.try_resume` reads back, and a two-stage canvas
curriculum."""

import json
import random
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from maskrcnn_tpu.config import TinyConfig as JaxTiny
from maskrcnn_tpu.data import augment as j_augment
from maskrcnn_tpu.data import codecs as j_codecs
from maskrcnn_tpu.data import coco as j_coco
from maskrcnn_tpu.data import dataset as j_dataset
from maskrcnn_tpu.data import pipeline as j_pipeline
from maskrcnn_tpu_torch import TinyConfig
from maskrcnn_tpu_torch.checkpoint import store
from maskrcnn_tpu_torch.data import augment as p_augment
from maskrcnn_tpu_torch.data import codecs as p_codecs
from maskrcnn_tpu_torch.data import coco as p_coco
from maskrcnn_tpu_torch.data import dataset as p_dataset
from maskrcnn_tpu_torch.data import pipeline as p_pipeline
from maskrcnn_tpu_torch.models.mask_rcnn import MaskRCNN
from maskrcnn_tpu_torch.train.trainer import Trainer
from tests.torch_port import synthetic_coco_dir


def equal_dicts(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=k)


def arrays(n=3, seed=0, keypoints=0):
    """Images of three sizes with 1-3 rectangle and disk instances."""
    rng = np.random.RandomState(seed)
    images, masks, classes, kps = [], [], [], []
    for i in range(n):
        h, w = 70 + 13 * i, 96 - 9 * i
        img = rng.randint(0, 256, (h, w, 3), np.uint8)
        ms = []
        for _ in range(rng.randint(1, 4)):
            m = np.zeros((h, w), np.uint8)
            y, x = rng.randint(0, h // 2), rng.randint(0, w // 2)
            m[y:y + rng.randint(6, h // 2), x:x + rng.randint(6, w // 2)] = 1
            ms.append(m)
        images.append(img)
        masks.append(np.stack(ms))
        classes.append(rng.randint(1, 5, len(ms)))
        kp = rng.uniform(0, min(h, w), (len(ms), keypoints, 3))
        kp[..., 2] = rng.randint(0, 3, kp.shape[:-1])
        kps.append(kp.astype(np.float32))
    return images, masks, classes, (kps if keypoints else None)


def test_encode_boxes_and_masks_equal_jax():
    """Canvas boxes and masks at upscales and downscales, square and
    rectangular canvases (the port resamples without Pillow)."""
    images, masks, _, _ = arrays()
    for img, m in zip(images, masks):
        for max_dim, canvas in ((128, None), (160, (96, 160)), (64, None)):
            _, window, scale = j_codecs.resize_image(img, 64, max_dim,
                                                     canvas_shape=canvas)
            boxes = np.asarray([p_dataset.mask_extent_box(x) for x in m],
                               np.float32)
            np.testing.assert_array_equal(
                p_codecs.encode_boxes(boxes.copy(), scale, window),
                j_codecs.encode_boxes(boxes.copy(), scale, window))
            np.testing.assert_array_equal(
                p_codecs.encode_masks(m, scale, window, max_dim, canvas),
                j_codecs.encode_masks(m, scale, window, max_dim, canvas))


@pytest.mark.parametrize("keypoints", [0, 4])
def test_array_dataset_sample_and_augmenter_equal_jax(keypoints):
    """ArrayDataset.sample without and with the Augmenter (crop, scale
    and colour jitter), the module `random` seeded alike on both sides;
    keypoints follow the transform."""
    data = arrays(keypoints=keypoints)
    jcfg = JaxTiny(NUM_KEYPOINTS=keypoints)
    pcfg = TinyConfig(NUM_KEYPOINTS=keypoints)
    jds = j_dataset.ArrayDataset(jcfg, *data[:3], keypoints=data[3])
    pds = p_dataset.ArrayDataset(pcfg, *data[:3], keypoints=data[3])
    spec = "scale=0.7:1.3,crop=0.6:1.0,color=0.3,min_visible=4"
    jaug, paug = j_augment.Augmenter.parse(spec), p_augment.Augmenter.parse(
        spec)
    assert jaug == j_augment.Augmenter(**vars(paug))
    for i in range(len(jds)):
        for seed in (0, 1):
            random.seed(seed)
            want = jds.sample(i, hflip=True, augment=jaug)
            random.seed(seed)
            got = pds.sample(i, hflip=True, augment=paug)
            equal_dicts(got, want)
        equal_dicts(pds.sample(i, hflip=False), jds.sample(i, hflip=False))
    assert pds.to_coco() == jds.to_coco()


def test_loaders_equal_jax():
    """SyntheticLoader's batch; BatchLoader's first two batches (one
    worker, shuffled by its seed, masks bit-packed)."""
    equal_dicts(next(p_pipeline.SyntheticLoader(TinyConfig(NUM_KEYPOINTS=3),
                                                2, seed=4)),
                next(j_pipeline.SyntheticLoader(JaxTiny(NUM_KEYPOINTS=3),
                                                2, seed=4)))
    data = arrays(n=4, seed=1)
    loaders = [mod.BatchLoader(mod_ds.ArrayDataset(cfg, *data[:3]), 2,
                               num_workers=1, seed=3, hflip=False)
               for mod, mod_ds, cfg in (
                   (p_pipeline, p_dataset, TinyConfig()),
                   (j_pipeline, j_dataset, JaxTiny()))]
    try:
        for _ in range(2):
            got, want = (next(it) for it in loaders)
            assert "gt_masks_packed" in got
            equal_dicts(got, want)
    finally:
        for it in loaders:
            it.close()


@pytest.fixture(scope="module")
def coco_dir(tmp_path_factory):
    """tests/torch_port's synthetic COCO directory, its minival images
    and annotations also as the train subset."""
    root = Path(synthetic_coco_dir(tmp_path_factory.mktemp("coco")))
    shutil.copytree(root / "val2014", root / "train2014")
    shutil.copy(root / "annotations" / "instances_minival2014.json",
                root / "annotations" / "instances_train2014.json")
    return root


def test_coco_dataset_sample_equal_jax(coco_dir):
    """CocoDataset.load and sample (Pillow reads the JPEG on both
    sides), a crowd annotation included."""
    ann_path = coco_dir / "annotations" / "instances_minival2014.json"
    gt = json.loads(ann_path.read_text())
    crowd = dict(gt["annotations"][0], id=99, iscrowd=1)
    gt["annotations"].append(crowd)
    tmp = coco_dir / "annotations" / "crowd.json"
    tmp.write_text(json.dumps(gt))
    jds = j_coco.CocoDataset(str(coco_dir), "minival", 2014, JaxTiny(),
                             annfile=str(tmp))
    pds = p_coco.CocoDataset(str(coco_dir), "minival", 2014, TinyConfig(),
                             annfile=str(tmp))
    for i in range(len(jds)):
        for a, b in zip(pds.load(i), jds.load(i)):
            np.testing.assert_array_equal(a, b)
        equal_dicts(pds.sample(i, hflip=False), jds.sample(i, hflip=False))
    assert (pds.load(0)[1] < 0).any()


def test_checkpoint_store_round_trip(tmp_path):
    """Three epochs saved, the first marked best, keep_last 1: epochs 1
    and 3 remain; the newest loads into a fresh model bit for bit, and an
    inference model of the same config loads it too."""
    cfg = TinyConfig()
    model = MaskRCNN(cfg, "cpu", train=True).init(
        torch.Generator().manual_seed(0))
    run = str(tmp_path / "run")
    assert store.latest_epoch(run) is None
    for e in (1, 2, 3):
        with torch.no_grad():
            model.rpn.conv_shared.bias.fill_(float(e))
        store.save_checkpoint(run, model, e, cfg)
    store.mark_best(run, 1)
    store.prune_checkpoints(run, keep_last=1)
    assert sorted(p.name for p in Path(run).glob("epoch_*")) == [
        "epoch_0001", "epoch_0003"]
    assert store.latest_epoch(run) == 3 and store.best_epoch(run) == 1
    fresh = MaskRCNN(cfg, "cpu", train=True)
    assert store.load_checkpoint(run, fresh) == 3
    for (k, a), b in zip(model.state_dict().items(),
                         fresh.state_dict().values()):
        assert torch.equal(a, b), k
    assert store.load_checkpoint(store.checkpoint_path(run, 1), fresh) == 1
    assert float(fresh.rpn.conv_shared.bias[0]) == 1.0
    served = MaskRCNN(cfg, "cpu")
    store.load_checkpoint(run, served)
    assert float(served.rpn.conv_shared.bias[0]) == 3.0


def test_coco_torch_train_cli(monkeypatch, coco_dir, tmp_path, capsys):
    """`coco_torch.py train --epochs 1 --steps-per-epoch 1 --device cpu`
    at TinyConfig (one validation step) on the synthetic COCO directory:
    loss lines, a torch.save checkpoint and the loss plots under --logs;
    a second run resumes from it (epoch 1 done, nothing left to train),
    and Trainer.try_resume reads it back."""
    import coco_torch
    monkeypatch.setattr(coco_torch, "CocoConfig", lambda **kw: TinyConfig(
        VALIDATION_STEPS=1, **kw))
    logs = tmp_path / "logs"
    argv = ["train", "--dataset", str(coco_dir), "--device", "cpu",
            "--epochs", "1", "--steps-per-epoch", "1", "--logs", str(logs),
            "--model", str(tmp_path / "none.pth"),
            "--augment", "scale=0.9:1.1"]
    coco_torch.main(argv)
    out = capsys.readouterr().out
    assert "epoch 1 step 1/1 total=" in out and "epoch 1 done" in out
    assert (logs / "epoch_0001" / "checkpoint.pth").exists()
    assert (logs / "total.png").exists()
    coco_torch.main(argv)
    out = capsys.readouterr().out
    assert "Resuming from epoch 1" in out and "epoch 1 step" not in out
    trainer = Trainer(MaskRCNN(TinyConfig(), "cpu", train=True),
                      checkpoint_dir=str(logs))
    assert trainer.try_resume() and trainer.epoch == 1


def test_canvas_curriculum(tmp_path):
    """fit_canvas_curriculum: a 64-px stage to epoch 1, then the 128-px
    canvas to epoch 2, a model a canvas carrying the weights across, one
    checkpoint directory with a continuing epoch count."""
    from maskrcnn_tpu_torch.data.pipeline import SyntheticLoader
    from maskrcnn_tpu_torch.train.trainer import fit_canvas_curriculum
    cfg = TinyConfig()
    model = MaskRCNN(cfg, "cpu", train=True).init(
        torch.Generator().manual_seed(0))
    canvases = []

    def make_iters(c):
        canvases.append(c.IMAGE_SHAPE[:2])
        return SyntheticLoader(c, 1), None

    last, trainers = fit_canvas_curriculum(
        cfg, model, make_iters, [{"canvas": 64, "epochs": 1},
                                 {"canvas": 128, "epochs": 2, "lr": 1e-4}],
        torch.Generator().manual_seed(1), checkpoint_dir=str(tmp_path),
        steps_per_epoch=1)
    assert canvases == [(64, 64), (128, 128)]
    assert [t.epoch for t in trainers] == [1, 2]
    assert last.config.IMAGE_SHAPE[:2] == (128, 128)
    assert store.latest_epoch(str(tmp_path)) == 2
    moved = [k for k, v in model.state_dict().items()
             if not torch.equal(v, last.state_dict()[k])]
    assert moved
