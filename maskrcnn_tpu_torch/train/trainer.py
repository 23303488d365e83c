"""Training: layer presets, the stage schedule and the epoch loop
(counterpart of maskrcnn_tpu/train/trainer.py; reference
model.py:1490-1747 train_model / train_epoch / valid_epoch, coco.py:217-241
for the three-stage schedule).

A step is `step.train_step` on the device; this module picks the
trainable parameters, makes the optimizer, moves batches to the device,
logs, validates and writes checkpoints. Per-step losses stay on the
device until a log point; the host runs at most two steps ahead of the
card. Config.NUM_DEVICES > 1 trains data-parallel (`parallel`, one
process a device under torchrun): each rank's `train_iter` yields its
slice of the global batch, the steps and the validation losses reduce
over the ranks, and rank 0 alone logs and writes checkpoints.
"""

from __future__ import annotations

import dataclasses
import re
import time
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

from maskrcnn_tpu_torch.models.mask_rcnn import MaskRCNN
from maskrcnn_tpu_torch import parallel
from maskrcnn_tpu_torch.train.step import (compute_losses_dp, make_optimizer,
                                           split_accum, train_step)

# Layer presets (reference model.py:1509-1523) over the port's parameter
# names, which are the reference checkpoint's: the FPN's P layers, the RPN,
# the box head (`classifier`) and the mask head (`mask`) always; the ResNet
# stages C3-C5 (fpn.C3..) from "3+" on. The cascade's extra box heads and
# the keypoint head train under "all" only, as in the JAX package.
_HEADS = r"(fpn\.P[2-5]_.*)|(rpn\..*)|(classifier\..*)|(mask\..*)"
LAYER_REGEX = {
    "heads": _HEADS,
    "3+": r"(fpn\.C[3-5]\..*)|" + _HEADS,
    "4+": r"(fpn\.C[4-5]\..*)|" + _HEADS,
    "5+": r"(fpn\.C5\..*)|" + _HEADS,
    "all": r".*",
}


def _is_bn(name: str) -> bool:
    """BatchNorm tensors are never trainable (the reference freezes them
    at build, model.py:1010-1016); the port keeps them as buffers."""
    return "bn" in name.lower()


def trainable_mask(model: torch.nn.Module, layer_regex: str
                   ) -> Dict[str, bool]:
    """{parameter name: trains} for a regex over the parameter names."""
    pattern = re.compile(layer_regex)
    return {name: bool(pattern.fullmatch(name)) and not _is_bn(name)
            for name, _ in model.named_parameters()}


def decay_mask(model: torch.nn.Module, layer_regex: str) -> Dict[str, bool]:
    """Weight decay applies to the trainable parameters (non-BN,
    model.py:1542-1553)."""
    return trainable_mask(model, layer_regex)


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A host batch on the device: pinned and copied without blocking
    when the device is the card."""
    cuda = torch.device(device).type == "cuda"
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(np.ascontiguousarray(v))
        out[k] = (t.pin_memory().to(device, non_blocking=True) if cuda
                  else t.to(device))
    return out


def _fetch(rows: List[Dict[str, torch.Tensor]]) -> List[Dict[str, float]]:
    """Per-step loss dicts from the device, in one copy."""
    if not rows:
        return []
    keys = list(rows[0])
    vals = torch.stack([torch.stack([r[k] for k in keys]) for r in rows])
    return [dict(zip(keys, map(float, v))) for v in vals.cpu().numpy()]


def _mean(rows: List[Dict[str, float]], count: int) -> Dict[str, float]:
    """The per-key sum over the rows whose total is finite, / count."""
    if not rows:
        return {}
    ok = [r for r in rows if np.isfinite(r["total"])]
    return {k: sum(r[k] for r in ok) / count for k in rows[0]}


@dataclasses.dataclass
class Trainer:
    """Stage-wise trainer (reference model.py:1490-1577 train_model) on
    one device; `model` is a training construction
    (MaskRCNN(config, device, train=True))."""

    model: MaskRCNN
    checkpoint_dir: Optional[str] = None
    log_every: int = 10
    # the newest N epoch checkpoints are kept (and one marked best); 0 keeps
    # every one (the reference's behaviour)
    keep_last: int = 5

    def __post_init__(self):
        self.loss_history: List[Dict[str, float]] = []
        self.val_loss_history: List[Dict[str, float]] = []
        # the last epoch's losses, a dict a step
        self.step_history: List[Dict[str, float]] = []
        self.epoch = 0

    @property
    def device(self) -> torch.device:
        return self.model.anchor_boxes.device

    def try_resume(self) -> bool:
        """Load the newest epoch checkpoint of checkpoint_dir into the
        model (the reference's filename-regex resume, model.py:1045-1093)
        and continue from its epoch. Returns whether one was found."""
        if not self.checkpoint_dir:
            return False
        from maskrcnn_tpu_torch.checkpoint.store import (latest_epoch,
                                                         load_checkpoint)
        if latest_epoch(self.checkpoint_dir) is None:
            return False
        self.epoch = load_checkpoint(self.checkpoint_dir, self.model)
        print(f"Resuming from epoch {self.epoch} checkpoint in "
              f"{self.checkpoint_dir}")
        return True

    def _plot_losses(self):
        """Loss curves, a PNG each, into the checkpoint directory (the
        reference's per-epoch plots, model.py:1568-1572)."""
        if not self.checkpoint_dir or not self.loss_history:
            return
        try:
            from maskrcnn_tpu_torch.utils.visualize import plot_loss
            plot_loss(self.loss_history, self.val_loss_history,
                      log_dir=self.checkpoint_dir)
        except Exception as e:  # plotting must never stop training
            print(f"  WARNING: loss plot failed: {e}")

    def _batch(self, batch):
        cfg = self.model.config
        batch = to_device(batch, self.device)
        return split_accum(batch, cfg.GRAD_ACCUM_STEPS)

    def fit(self, train_iter: Iterable, learning_rate: float, epochs: int,
            layers: str, generator: Optional[torch.Generator] = None,
            val_iter: Optional[Iterable] = None,
            steps_per_epoch: Optional[int] = None,
            validation_steps: Optional[int] = None,
            on_epoch_end: Optional[Callable] = None) -> MaskRCNN:
        """Train until `epochs` epochs in all (the reference's cumulative
        epochs, model.py:1494-1497, 1559), the parameters that `layers` (a
        LAYER_REGEX preset or a regex) names trainable and the rest frozen;
        a fresh optimizer each call. `generator` draws the samplers'
        random subsets (on the model's device). Returns the model, trained
        in place."""
        cfg = self.model.config
        layer_regex = LAYER_REGEX.get(layers, layers)
        steps_per_epoch = steps_per_epoch or cfg.STEPS_PER_EPOCH
        validation_steps = validation_steps or cfg.VALIDATION_STEPS

        tmask = trainable_mask(self.model, layer_regex)
        dmask = decay_mask(self.model, layer_regex)
        params = []
        for name, p in self.model.named_parameters():
            p.requires_grad_(tmask[name])
            if tmask[name]:
                params.append((name, p))
        optimizer = make_optimizer(cfg, learning_rate,
                                   [p for _, p in params],
                                   [dmask[n] for n, _ in params])
        self.optimizer = optimizer
        dp = parallel.for_config(cfg)
        lead = parallel.rank() == 0
        if dp is not None and lead:
            print(f"Data-parallel: {dp.size} ranks (global batch "
                  f"{cfg.BATCH_SIZE})")

        for epoch in range(self.epoch + 1, epochs + 1):
            t0 = time.time()
            pending, done = [], []
            for step in range(steps_per_epoch):
                metrics = train_step(self.model, optimizer,
                                     self._batch(next(train_iter)), generator,
                                     dp)
                pending.append(metrics)
                if self.device.type == "cuda":
                    event = torch.cuda.Event()
                    event.record()
                    done.append(event)
                    # at most two steps in flight: enough to overlap the
                    # host's batch work with the card, without queueing
                    # batch buffers ahead of it
                    if step >= 2:
                        done[step - 2].synchronize()
                if lead and ((step + 1) % self.log_every == 0 or step == 0):
                    m = {k: float(v) for k, v in metrics.items()}
                    if not np.isfinite(m["total"]):
                        print(f"  WARNING: non-finite loss at epoch {epoch} "
                              f"step {step + 1}; the step was skipped")
                    print(f"  epoch {epoch} step {step + 1}/{steps_per_epoch} "
                          + " ".join(f"{k}={v:.4f}" for k, v in m.items()))
            self.step_history = _fetch(pending)
            sums = _mean(self.step_history, steps_per_epoch)
            skipped = sum(not np.isfinite(r["total"])
                          for r in self.step_history)
            if skipped and lead:
                print(f"  WARNING: {skipped} non-finite step(s) in epoch "
                      f"{epoch} were skipped")
            self.loss_history.append(sums)

            if val_iter is not None:
                vpending = []
                with torch.no_grad():
                    for _ in range(validation_steps):
                        batch = to_device(next(val_iter), self.device)
                        vpending.append(compute_losses_dp(
                            self.model, generator, batch, dp).as_dict())
                self.val_loss_history.append(
                    _mean(_fetch(vpending), validation_steps))

            self.epoch = epoch
            if lead:
                print(f"epoch {epoch} done in {time.time() - t0:.1f}s: "
                      + " ".join(f"{k}={v:.4f}"
                                 for k, v in self.loss_history[-1].items()))
            if self.checkpoint_dir and lead:
                from maskrcnn_tpu_torch.checkpoint.store import (
                    prune_checkpoints, save_checkpoint)
                save_checkpoint(self.checkpoint_dir, self.model, epoch, cfg)
                prune_checkpoints(self.checkpoint_dir, self.keep_last)
            if lead:
                self._plot_losses()
            if on_epoch_end is not None:
                on_epoch_end(self, self.model)
        return self.model

    def fit_coco_schedule(self, train_iter, generator=None, val_iter=None,
                          **kw) -> MaskRCNN:
        """The reference's three stages (coco.py:217-241): heads to epoch
        40, 4+ to 120, all to 160 at LR / 10."""
        lr = self.model.config.LEARNING_RATE
        self.fit(train_iter, lr, 40, "heads", generator, val_iter=val_iter,
                 **kw)
        self.fit(train_iter, lr, 120, "4+", generator, val_iter=val_iter,
                 **kw)
        return self.fit(train_iter, lr / 10.0, 160, "all", generator,
                        val_iter=val_iter, **kw)


def fit_canvas_curriculum(base_config, model: MaskRCNN, make_iters, stages,
                          generator=None, layers: str = "all",
                          checkpoint_dir: Optional[str] = None, **fit_kw):
    """A multi-scale canvas curriculum over `Trainer.fit` stages (the JAX
    package's opt-in departure from the reference's square 1024 canvas):
    early epochs on a smaller canvas, the last at full size. The weights
    do not depend on the canvas, so each stage's model (built for its
    canvas) starts from the previous stage's state.

    stages: dicts {"canvas": int or (H, W), "epochs": E (cumulative),
    "lr": float (default LEARNING_RATE), any Config field override}.
    make_iters(cfg) -> (train_iter, val_iter or None) for a stage.
    Returns (the last stage's model, the trainers), checkpoints in one
    directory with a continuing epoch count."""
    trainers = []
    epoch = 0
    device = model.anchor_boxes.device
    for stage in stages:
        stage = dict(stage)
        canvas = stage.pop("canvas")
        epochs = stage.pop("epochs")
        lr = stage.pop("lr", base_config.LEARNING_RATE)
        if isinstance(canvas, int):
            canvas = (canvas, canvas)
        side = max(canvas)
        overrides = dict(
            IMAGE_CANVAS=tuple(canvas), IMAGE_MAX_DIM=side,
            # the reference's min/max ratio, so the resize policy scales
            IMAGE_MIN_DIM=max(1, round(base_config.IMAGE_MIN_DIM * side
                                       / base_config.IMAGE_MAX_DIM)))
        overrides.update(stage)
        cfg = base_config.replace(**overrides)
        nxt = MaskRCNN(cfg, device, train=True)
        nxt.load_state_dict(model.state_dict())
        model = nxt
        trainer = Trainer(model, checkpoint_dir=checkpoint_dir)
        trainer.epoch = epoch
        train_iter, val_iter = make_iters(cfg)
        print(f"curriculum stage: canvas {cfg.IMAGE_SHAPE[:2]} to epoch "
              f"{epochs} (batch {cfg.BATCH_SIZE}, lr {lr})")
        trainer.fit(train_iter, lr, epochs, layers, generator,
                    val_iter=val_iter, **fit_kw)
        epoch = trainer.epoch
        trainers.append(trainer)
    return model, trainers
