"""Data parallelism over torch.distributed (counterpart of
maskrcnn_tpu/parallel/mesh.py).

One process a device, launched by torchrun (`init_from_env`, env://):
Config.NUM_DEVICES must equal the world size (`check_world`), and each
rank's loader yields its IMAGES_PER_DEVICE slice of the global batch,
rank-major (`rank_slice`; data.pipeline.BatchLoader's shard_index and
num_shards), the counterpart of the JAX `shard_batch` on process-local
data. The step's gradients are taken with torch.autograd.grad
(train/step.py), which DDP's reducer does not see, so `DataParallel`
reduces explicitly:

* every loss is a masked mean over the GLOBAL batch, as the JAX losses
  under a sharded jit: inside `DataParallel.global_means()` each loss's
  denominator is all-reduced (SUM) before the division, and each rank
  divides its own numerator by it (train/losses.global_denominators);
* the gradients (in flattened buckets) and the reported losses are then
  all-reduced with SUM, so the non-finite guard and the global-norm clip
  see the same global gradient on every rank. Under GRAD_ACCUM_STEPS the
  global micro-batch i is every rank's micro-batch i, as the JAX
  package's multi-process shard_batch of split_accum'd local batches.

`dcn` has nothing to map (NCCL picks its collectives); MESH_AXIS_DP is
accepted and unused. The spatial axis (SP_DEVICES) is not ported. Each
rank's samplers draw from a generator seeded from (seed, rank)
(`rank_generator`), so their draws differ from a one-process run's; the
tests hold the equivalence where no subsample binds.
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from maskrcnn_tpu_torch.train import losses as L


def world_size() -> int:
    """The default process group's size, 1 without one."""
    return (dist.get_world_size() if dist.is_available()
            and dist.is_initialized() else 1)


def rank() -> int:
    return dist.get_rank() if world_size() > 1 else 0


def check_world(config) -> None:
    """Raise ValueError unless Config.NUM_DEVICES equals the world size
    (a one-process run has world size 1)."""
    n, ws = config.NUM_DEVICES, world_size()
    if n != ws:
        raise ValueError(
            f"Config.NUM_DEVICES={n} but the torch.distributed world size is "
            f"{ws}: data parallelism runs one process a device (torchrun "
            f"--nproc_per_node {n}, then parallel.init_from_env)")


def init_from_env(device_type: str = "cuda") -> torch.device:
    """Join the process group torchrun describes (env://: MASTER_ADDR,
    MASTER_PORT, RANK, WORLD_SIZE, LOCAL_RANK): NCCL on the card, gloo on
    the CPU. Returns this rank's device (cuda:LOCAL_RANK)."""
    local = int(os.environ.get("LOCAL_RANK", "0"))
    if device_type == "cuda":
        device = torch.device("cuda", local)
        torch.cuda.set_device(device)
        backend = "nccl"
    else:
        device, backend = torch.device("cpu"), "gloo"
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method="env://")
    return device


def rank_slice(batch: Dict, rank_index: int, per_rank: int) -> Dict:
    """Rank `rank_index`'s rows [r * per_rank, (r + 1) * per_rank) of a
    global batch (numpy arrays or tensors)."""
    lo = rank_index * per_rank
    return {k: v[lo:lo + per_rank] for k, v in batch.items()}


def rank_generator(seed: int, rank_index: int, device="cpu"
                   ) -> torch.Generator:
    """The samplers' generator of one rank, seeded from (seed, rank); rank
    0's is seed's own."""
    return torch.Generator(device=device).manual_seed(
        seed + 1_000_003 * rank_index)


class DataParallel:
    """The reductions of a data-parallel step over a process group (the
    default one when `group` is None). `bucket_bytes` bounds each
    flattened gradient all-reduce."""

    def __init__(self, group=None, bucket_bytes: int = 25 << 20):
        self.group = group
        self.size = dist.get_world_size(group)
        self.bucket_bytes = bucket_bytes

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """All-reduce `t` in place (SUM); returns it."""
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return t

    @contextlib.contextmanager
    def global_means(self):
        """Losses computed inside divide by their global denominators."""
        with L.global_denominators(self.sum):
            yield

    def sum_grads(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """All-reduce a gradient list (SUM) in flattened buckets of one
        dtype; returns new tensors shaped as the inputs."""
        out: List[Optional[torch.Tensor]] = [None] * len(grads)
        order = sorted(range(len(grads)), key=lambda i: str(grads[i].dtype))
        bucket: List[int] = []
        size = 0

        def flush():
            if not bucket:
                return
            flat = torch.cat([grads[i].reshape(-1) for i in bucket])
            self.sum(flat)
            for i, part in zip(bucket, torch.split(
                    flat, [grads[i].numel() for i in bucket])):
                out[i] = part.view(grads[i].shape)
            bucket.clear()

        for i in order:
            g = grads[i]
            nbytes = g.numel() * g.element_size()
            if bucket and (size + nbytes > self.bucket_bytes
                           or grads[bucket[0]].dtype != g.dtype):
                flush()
                size = 0
            bucket.append(i)
            size += nbytes
        flush()
        return out

    def sum_losses(self, losses: L.Losses) -> L.Losses:
        """All-reduce the reported losses (SUM: the global means, each
        rank holding its numerator over the global denominator)."""
        stacked = torch.stack([v.detach() for v in losses])
        self.sum(stacked)
        return L.Losses(*stacked.unbind())


def for_config(config) -> Optional[DataParallel]:
    """A DataParallel over the default process group when there is one
    (its size checked against Config.NUM_DEVICES; a one-rank group runs
    the same reductions), else None."""
    check_world(config)
    initialized = dist.is_available() and dist.is_initialized()
    return DataParallel() if initialized else None
