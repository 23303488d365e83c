"""Epoch checkpoints with resume discovery (counterpart of
maskrcnn_tpu/checkpoint/store.py, written with torch.save).

The layout is the JAX package's: a directory `epoch_<nnnn>` an epoch
under the run directory, the newest found by its number, a `BEST` file
naming the best epoch, which pruning keeps. Each epoch directory holds
`checkpoint.pth`: the model's state dict in float32 on the CPU (the
reference's state-dict names, BN buffers included), the epoch and the
config's fields. A checkpoint is written into a temporary directory and
renamed, so a half-written one is never found. The JAX package's orbax
checkpoints are not readable here (orbax is a JAX library); a checkpoint
written here loads into any MaskRCNN of the port, training or inference,
through `checkpoint.convert.load_state`.
"""

from __future__ import annotations

import dataclasses
import os
import re
import shutil
import tempfile
from typing import Optional

CHECKPOINT_FILE = "checkpoint.pth"


def checkpoint_path(run_dir: str, epoch: int) -> str:
    return os.path.join(os.path.abspath(run_dir), f"epoch_{epoch:04d}")


def save_checkpoint(run_dir: str, model, epoch: int, config=None) -> str:
    """Write the model's state as `run_dir/epoch_<n>` and return the
    directory; an existing checkpoint of that epoch is replaced."""
    import torch
    path = checkpoint_path(run_dir, epoch)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    state = {k: v.detach().to("cpu", torch.float32)
             for k, v in model.state_dict().items()}
    meta = (dataclasses.asdict(config) if dataclasses.is_dataclass(config)
            else None)
    tmp = tempfile.mkdtemp(prefix=f".epoch_{epoch:04d}.",
                           dir=os.path.dirname(path))
    try:
        torch.save({"state": state, "epoch": int(epoch), "config": meta},
                   os.path.join(tmp, CHECKPOINT_FILE))
        if os.path.isdir(path):
            shutil.rmtree(path)
        os.replace(tmp, path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return path


def _epochs(run_dir: str):
    if not os.path.isdir(run_dir):
        return []
    return sorted(int(m.group(1)) for m in
                  (re.fullmatch(r"epoch_(\d{4})", n)
                   for n in os.listdir(run_dir)) if m)


def prune_checkpoints(run_dir: str, keep_last: int = 5) -> None:
    """Keep the newest `keep_last` epoch checkpoints (and the one marked
    best); delete the rest. 0 keeps all."""
    best = best_epoch(run_dir)
    for e in _epochs(run_dir)[:-keep_last] if keep_last > 0 else []:
        if e != best:
            shutil.rmtree(checkpoint_path(run_dir, e), ignore_errors=True)


def mark_best(run_dir: str, epoch: int) -> None:
    """Record the best epoch (e.g. by validation AP); pruning keeps it."""
    with open(os.path.join(os.path.abspath(run_dir), "BEST"), "w") as f:
        f.write(str(int(epoch)))


def best_epoch(run_dir: str) -> Optional[int]:
    path = os.path.join(os.path.abspath(run_dir), "BEST")
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            return int(f.read().strip())
    except ValueError:
        return None


def latest_epoch(run_dir: str) -> Optional[int]:
    """The newest epoch checkpoint under run_dir, or None."""
    epochs = _epochs(run_dir)
    return epochs[-1] if epochs else None


def load_checkpoint(run_dir_or_path: str, model,
                    epoch: Optional[int] = None) -> int:
    """Load a checkpoint into `model` (checkpoint.convert.load_state: a
    strict load, optional heads the checkpoint lacks whole kept at the
    model's values) and return its epoch. `run_dir_or_path` is a run
    directory (the given or the newest epoch) or an `epoch_<n>`
    directory."""
    import torch
    from maskrcnn_tpu_torch.checkpoint.convert import load_state
    path = run_dir_or_path
    if not os.path.basename(os.path.normpath(path)).startswith("epoch_"):
        e = epoch if epoch is not None else latest_epoch(path)
        if e is None:
            raise FileNotFoundError(f"no checkpoints under {path}")
        path = checkpoint_path(path, e)
    data = torch.load(os.path.join(path, CHECKPOINT_FILE), map_location="cpu",
                      weights_only=True)
    load_state(model, {k: v.numpy() for k, v in data["state"].items()})
    return int(data["epoch"])
