"""Data parallelism and the spatial axis over torch.distributed
(counterpart of maskrcnn_tpu/parallel/mesh.py).

One process a device, launched by torchrun (`init_from_env`, env://):
Config.NUM_DEVICES must equal the world size (`check_world`). Under
Config.SP_DEVICES = sp the ranks form groups of sp: ranks
[g * sp, (g + 1) * sp) are sp group g, which shares each of its images'
rows (`spatial`: the backbone and FPN on row shards, the levels gathered
after the FPN, everything after alike on the group's ranks). A rank's
data-parallel index is rank // sp (`dp_index`) and the data-parallel
width NUM_DEVICES // sp. Each rank's loader yields its dp index's
IMAGES_PER_DEVICE slice of the global batch, dp-major (`rank_slice`;
data.pipeline.BatchLoader's shard_index and num_shards are the dp index
and width), the counterpart of the JAX `shard_batch` on process-local
data. The sp ranks of a group must see the same batches, flips and
order included, and draw the same samples: `group_loader` reads a
group's batches on its first rank and broadcasts them within the group
(a loader's worker threads and its flips differ from rank to rank), and
`rank_generator` is keyed by the dp index. The step's gradients
are taken with torch.autograd.grad (train/step.py), which DDP's reducer
does not see, so `DataParallel` reduces explicitly:

* every loss is a masked mean over the GLOBAL batch, as the JAX losses
  under a sharded jit: inside `DataParallel.global_means()` each loss's
  denominator is all-reduced before the division, and each rank divides
  its own numerator by it (train/losses.global_denominators);
* the gradients (in flattened buckets) and the reported losses are then
  all-reduced, so the non-finite guard and the global-norm clip see the
  same global gradient on every rank. Under GRAD_ACCUM_STEPS the global
  micro-batch i is every rank's micro-batch i, as the JAX package's
  multi-process shard_batch of split_accum'd local batches.
* Under sp every image's terms arrive once from each rank of its group:
  the denominators and the reported losses are the world sum divided by
  sp. The backbone's and FPN's gradients are per-shard partial sums, and
  the world sum adds them; the other parameters' gradients are alike on
  the group's ranks and are divided by sp before the sum.

`dcn` has nothing to map (NCCL picks its collectives); MESH_AXIS_DP is
accepted and unused. Each dp index's samplers draw from a generator
seeded from (seed, dp index) (`rank_generator`), so their draws differ
from a one-process run's; the tests hold the equivalence where no
subsample binds.
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


def dp_index(config) -> int:
    """This rank's data-parallel index, rank // SP_DEVICES."""
    return rank() // config.SP_DEVICES


def rank_slice(batch: Dict, rank_index: int, per_rank: int) -> Dict:
    """Data-parallel index `rank_index`'s rows [r * per_rank, (r + 1) *
    per_rank) of a global batch (numpy arrays or tensors)."""
    lo = rank_index * per_rank
    return {k: v[lo:lo + per_rank] for k, v in batch.items()}


def rank_generator(seed: int, rank_index: int, device="cpu"
                   ) -> torch.Generator:
    """The samplers' generator of one data-parallel index (`dp_index`),
    seeded from (seed, index); index 0's is seed's own."""
    return torch.Generator(device=device).manual_seed(
        seed + 1_000_003 * rank_index)


class GroupBatches:
    """The batches of an sp group: its first rank reads `loader` (None on
    the other ranks) and broadcasts each batch within `group` from global
    rank `src`, so every rank of the group gets the same batch."""

    def __init__(self, loader, group, src: int):
        self.loader, self.group, self.src = loader, group, src

    def __iter__(self):
        return self

    def __next__(self) -> Dict:
        box = [None]
        if self.loader is not None:
            # None tells the group the loader is spent
            box[0] = next(self.loader, None)
        dist.broadcast_object_list(box, src=self.src, group=self.group)
        if box[0] is None:
            raise StopIteration
        return box[0]

    def close(self) -> None:
        if self.loader is not None:
            self.loader.close()


def group_loader(make, config):
    """make() -> this rank's batch iterator (its dp index's shard). Under
    SP_DEVICES > 1 in a process group, made on the first rank of each sp
    group only and broadcast to the group's ranks (`GroupBatches`)."""
    if config.SP_DEVICES == 1 or world_size() == 1:
        return make()
    from maskrcnn_tpu_torch.parallel import spatial
    group, index = spatial.group_of(config.SP_DEVICES)
    return GroupBatches(make() if index == 0 else None, group,
                        rank() - index)


class DataParallel:
    """The reductions of a data-parallel step over a process group (the
    default one when `group` is None) whose ranks form groups of `sp`
    (Config.SP_DEVICES). `bucket_bytes` bounds each flattened gradient
    all-reduce."""

    def __init__(self, group=None, bucket_bytes: int = 25 << 20,
                 sp: int = 1):
        self.group = group
        self.size = dist.get_world_size(group)
        self.bucket_bytes = bucket_bytes
        self.sp = sp

    def _all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return t

    def _per_group(self, t: torch.Tensor) -> torch.Tensor:
        """`t` divided in place by sp, a float tensor (on CUDA a Python
        divisor is a reciprocal multiply)."""
        return t.div_(torch.full((), float(self.sp), dtype=t.dtype,
                                 device=t.device))

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """All-reduce a per-image quantity in place: the world sum, over
        sp (each sp group's ranks hold the same images); returns it."""
        self._all_reduce(t)
        return self._per_group(t) if self.sp > 1 else t

    @contextlib.contextmanager
    def global_means(self):
        """Losses computed inside divide by their global denominators."""
        with L.global_denominators(self.sum):
            yield

    def sum_grads(self, grads: List[torch.Tensor],
                  shared: Optional[List[bool]] = None) -> List[torch.Tensor]:
        """All-reduce a gradient list (SUM) in flattened buckets of one
        dtype; returns new tensors shaped as the inputs. `shared` marks
        the gradients the ranks of an sp group hold alike (the parameters
        after the spatial gather): they are divided by sp first."""
        if self.sp > 1 and shared is not None:
            grads = [self._per_group(g.clone()) if s else g
                     for g, s in zip(grads, shared)]
        out: List[Optional[torch.Tensor]] = [None] * len(grads)
        order = sorted(range(len(grads)), key=lambda i: str(grads[i].dtype))
        bucket: List[int] = []
        size = 0

        def flush():
            if not bucket:
                return
            flat = torch.cat([grads[i].reshape(-1) for i in bucket])
            self._all_reduce(flat)
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
        """All-reduce the reported losses (`sum`: the global means, each
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
    return DataParallel(sp=config.SP_DEVICES) if initialized else None
