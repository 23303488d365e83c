"""The spatial axis (Config.SP_DEVICES, counterpart of the `sp` mesh axis of
maskrcnn_tpu/parallel/mesh.py).

A group of SP_DEVICES devices shares each canvas's rows: shard i holds
rows [i * H / sp, (i + 1) * H / sp) of the backbone's input and of every
ResNet and FPN map after it. Where the JAX package lets GSPMD partition
the convs, the port runs the backbone and the FPN on its row shards
with explicit halo exchanges, then gathers P2-P5 along H within the
group (P6 is the gathered P5's stride-2 view, as unsharded). The RPN,
the proposals, RoIAlign, the heads, the targets and the losses then run
on the gathered levels, unchanged.

The halo plan, rows above / below each H op needs from its neighbours
and the value past the canvas's edge:

    stem conv 7x7, stride 2, pad 3                   3 / 2   zero
    stem pool 3x3, stride 2, pad (0, 1)              0 / 1   -inf
    every 3x3 conv, pad 1 (bottleneck conv2, P*_conv2) 1 / 1 zero
    1x1 convs (strided too), nearest 2x upsample, P6   local

A halo'd op runs on the slab [halo above, shard, halo below] with
padding 0 in H and its own padding in W. The local ops need each shard
to start on an even row at every stride, so the canvas height must be
a multiple of 64 * SP_DEVICES (`check_config`). Under FOLD_BN an
identity block stays one fused op (K3): its input is extended by one
neighbour row on each side that has a neighbour, K3 runs on that slab
and the extra rows are cropped from its output. conv1 is 1x1, so h1 of
a borrowed row is exact; at the canvas's edges there is no extension,
since K3's 3x3 reads zeros outside its input as the unsharded block's
padding does.

Two transports share the autograd Functions (`exchange`, `gather`):

* `InProcess`: the group's shards live in one process, each on its own
  device with its own replica of the weights (api.Detector); halos move
  by device-to-device copies. A device may repeat (the CPU tests, one
  card).
* `Distributed`: one process a rank (training under torchrun). Ranks
  [g * sp, (g + 1) * sp) form sp group g; a rank's shard is rank % sp and
  its data-parallel index rank // sp. Each exchange is one all_gather of
  every rank's boundary rows within the group.

An exchange's backward sends each halo's gradient back to the shard that
owns those rows and adds it there. The gather's backward is the local
slice of the incoming gradient: everything after the gather runs alike
on the group's ranks, so each holds the whole gradient already (a
reduce-scatter would scale the backbone's gradient by SP_DEVICES).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from maskrcnn_tpu_torch.models.fpn import nearest_upsample_2x
from maskrcnn_tpu_torch.ops.bottleneck import fused_identity_bottleneck

# every stride of the backbone and P6's: a shard starts on an even row of
# every map down to P6
ROW_ALIGN = 64

_CL = torch.channels_last


def check_config(config) -> None:
    """Raise ValueError unless SP_DEVICES divides NUM_DEVICES and the
    canvas height is a multiple of 64 * SP_DEVICES."""
    sp = config.SP_DEVICES
    if sp < 1 or config.NUM_DEVICES % sp:
        raise ValueError(f"Config.SP_DEVICES={sp} must divide "
                         f"NUM_DEVICES={config.NUM_DEVICES}")
    h = int(config.IMAGE_SHAPE[0])
    if sp > 1 and h % (ROW_ALIGN * sp):
        raise ValueError(
            f"Config.SP_DEVICES={sp}: the canvas height {h} (canvas "
            f"{tuple(config.IMAGE_SHAPE[:2])}) must be a multiple of "
            f"{ROW_ALIGN} * SP_DEVICES = {ROW_ALIGN * sp}")


# sp -> (the default process group, this rank's sp group) of `group_of`
_GROUPS = {}


def group_of(sp: int):
    """This rank's sp group under the default process group (ranks
    [g * sp, (g + 1) * sp) for g = rank // sp) and its shard index,
    rank % sp. The groups are made once a default group: new_group is a
    collective call, so every rank makes them at the same point (its
    first model's construction, or its first loader's)."""
    world = dist.group.WORLD
    cached = _GROUPS.get(sp)
    if cached is None or cached[0] is not world:
        rank, mine = dist.get_rank(), None
        for g in range(dist.get_world_size() // sp):
            group = dist.new_group(list(range(g * sp, (g + 1) * sp)))
            if rank // sp == g:
                mine = group
        cached = _GROUPS[sp] = (world, mine)
    return cached[1], dist.get_rank() % sp


def _device(model) -> torch.device:
    return next(model.parameters()).device


class InProcess:
    """The shards of one group in this process: `models` one MaskRCNN a
    shard, each on its shard's device (the group's weight replicas; a
    model may repeat)."""

    def __init__(self, models: Sequence[torch.nn.Module]):
        self.models = list(models)
        self.size = len(self.models)
        self.indices = list(range(self.size))
        self.devices = [_device(m) for m in self.models]

    def neighbors(self, sends: Sequence[torch.Tensor]):
        """Each shard's (previous shard's send, next shard's send), None
        past the group's ends, on the shard's device."""
        n = self.size
        return [(sends[i - 1].to(d) if i > 0 else None,
                 sends[i + 1].to(d) if i < n - 1 else None)
                for i, d in enumerate(self.devices)]

    def gather_rows(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        """NHWC shards -> the whole map on the first shard's device."""
        return torch.cat([x.to(self.devices[0]) for x in xs], dim=1)


class Distributed:
    """This rank's shard of its sp group over torch.distributed: `model`
    the rank's MaskRCNN, `group` the sp group's process group (its ranks
    in shard order), `index` this rank's shard."""

    def __init__(self, model: torch.nn.Module, group, index: int,
                 size: int):
        self.models = [model]
        self.devices = [_device(model)]
        self.group = group
        self.size = size
        self.indices = [index]

    @classmethod
    def for_config(cls, config, model) -> "Distributed":
        """The transport of this rank under the default process group."""
        group, index = group_of(config.SP_DEVICES)
        return cls(model, group, index, config.SP_DEVICES)

    def _all_gather(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = x.contiguous()
        out = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(out, x, group=self.group)
        return out

    def neighbors(self, sends: Sequence[torch.Tensor]):
        every = self._all_gather(sends[0])
        i = self.indices[0]
        return [(every[i - 1] if i > 0 else None,
                 every[i + 1] if i < self.size - 1 else None)]

    def gather_rows(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        return torch.cat(self._all_gather(xs[0]), dim=1)


def _edge(x: torch.Tensor, rows: int, fill: float) -> torch.Tensor:
    return x.new_full((x.shape[0], x.shape[1], rows, x.shape[3]), fill)


class _Exchange(torch.autograd.Function):
    """NCHW shards -> slabs [rows above, shard, rows below]; see
    `exchange`."""

    @staticmethod
    def forward(ctx, t, above: int, below: int, fill: Optional[float],
                *xs):
        # each shard sends its last `above` rows down and its first
        # `below` rows up, in one slab
        sends = [torch.cat([x[:, :, x.shape[2] - above:], x[:, :, :below]],
                           dim=2) for x in xs]
        slabs, tops = [], []
        for x, (prev, nxt) in zip(xs, t.neighbors(sends)):
            parts = []
            if prev is not None:
                parts.append(prev[:, :, :above])
            elif fill is not None and above:
                parts.append(_edge(x, above, fill))
            tops.append(sum(p.shape[2] for p in parts))
            parts.append(x)
            if nxt is not None:
                parts.append(nxt[:, :, above:])
            elif fill is not None and below:
                parts.append(_edge(x, below, fill))
            slabs.append(torch.cat(parts, dim=2).contiguous(
                memory_format=_CL))
        ctx.t, ctx.above, ctx.below = t, above, below
        ctx.tops = tops
        ctx.heights = [x.shape[2] for x in xs]
        return tuple(slabs)

    @staticmethod
    def backward(ctx, *grads):
        t, above, below = ctx.t, ctx.above, ctx.below
        n = t.size
        own, sends = [], []
        for g, top, h, i in zip(grads, ctx.tops, ctx.heights, t.indices):
            own.append(g[:, :, top:top + h].clone())
            # rows that came from the previous shard go back up, rows from
            # the next shard go back down; zeros where none came
            up = (g[:, :, :above] if i > 0
                  else g.new_zeros(g.shape[0], g.shape[1], above, g.shape[3]))
            down = (g[:, :, top + h:top + h + below] if i < n - 1
                    else g.new_zeros(g.shape[0], g.shape[1], below,
                                     g.shape[3]))
            sends.append(torch.cat([up, down], dim=2))
        for d, h, (prev, nxt) in zip(own, ctx.heights, t.neighbors(sends)):
            if prev is not None and below:
                # the previous shard's bottom halo: this shard's first rows
                d[:, :, :below] += prev[:, :, above:]
            if nxt is not None and above:
                # the next shard's top halo: this shard's last rows
                d[:, :, h - above:] += nxt[:, :, :above]
        return (None, None, None, None, *own)


def exchange(t, xs: Sequence[torch.Tensor], above: int, below: int,
             fill: Optional[float]) -> List[torch.Tensor]:
    """NCHW (channels_last) shards -> one slab each: the previous shard's
    last `above` rows, the shard, the next shard's first `below` rows. Past
    the canvas's edge, `fill` rows (None: no rows). Slabs are contiguous
    channels_last."""
    return list(_Exchange.apply(t, above, below, fill, *xs))


class _Gather(torch.autograd.Function):
    """NHWC row shards -> the whole map; backward: the local slices."""

    @staticmethod
    def forward(ctx, t, *xs):
        ctx.t = t
        ctx.heights = [x.shape[1] for x in xs]
        ctx.devices = [x.device for x in xs]
        return t.gather_rows(xs)

    @staticmethod
    def backward(ctx, g):
        out = []
        for i, h, dev in zip(ctx.t.indices, ctx.heights, ctx.devices):
            out.append(g[:, i * h:(i + 1) * h].to(dev))
        return (None, *out)


def gather(t, xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """NCHW (channels_last) row shards -> the whole map, NCHW channels_last
    (its NHWC view contiguous, as the unsharded FPN's)."""
    full = _Gather.apply(t, *[x.permute(0, 2, 3, 1).contiguous()
                              for x in xs])
    return full.permute(0, 3, 1, 2)


def conv_rows(conv, x: torch.Tensor) -> torch.Tensor:
    """models.layers.Conv2d on a slab that carries its H padding: padding 0
    in H, the conv's own in W, the bias added after the product."""
    w, b = conv._weights()
    y = F.conv2d(x, w, None, conv.stride, (0, conv.padding[1]))
    return y if b is None else y.add_(b[:, None, None])


def pool_rows(x: torch.Tensor) -> torch.Tensor:
    """models.resnet.stem_pool on a slab whose bottom -inf row (canvas
    edge) or halo row is already there: -inf pads the right column only."""
    x = F.pad(x, (0, 1, 0, 0), value=float("-inf"))
    return F.max_pool2d(x, 3, 2).contiguous(memory_format=_CL)


def stem(t, xs):
    """The stem (models.resnet.make_stem) on every shard."""
    c1 = [m.fpn.C1 for m in t.models]
    slabs = exchange(t, xs, 3, 2, 0.0)
    ys = [F.relu(m[1](conv_rows(m[0], s))) for m, s in zip(c1, slabs)]
    return [pool_rows(s) for s in exchange(t, ys, 0, 1, float("-inf"))]


def bottleneck(t, blocks, xs):
    """One bottleneck (models.resnet.Bottleneck) on every shard."""
    if blocks[0].fused:
        slabs = exchange(t, xs, 1, 1, None)
        out = []
        for b, s, x, i in zip(blocks, slabs, xs, t.indices):
            y = fused_identity_bottleneck(s.permute(0, 2, 3, 1), *b.packed)
            top = 1 if i > 0 else 0
            out.append(y[:, top:top + x.shape[2]].permute(0, 3, 1, 2)
                       .contiguous(memory_format=_CL))
        return out
    res = [x if b.downsample is None else b.downsample(x)
           for b, x in zip(blocks, xs)]
    hs = [F.relu(b.bn1(b.conv1(x))) for b, x in zip(blocks, xs)]
    hs = [F.relu(b.bn2(conv_rows(b.conv2, s)))
          for b, s in zip(blocks, exchange(t, hs, 1, 1, 0.0))]
    return [F.relu(b.bn3(b.conv3(h)) + r)
            for b, h, r in zip(blocks, hs, res)]


def stage(t, name: str, xs):
    """ResNet stage `name` (C2..C5) on every shard, recomputed in the
    backward pass under the FPN's remat."""
    stages = [getattr(m.fpn, name) for m in t.models]

    def run(*xs):
        xs = list(xs)
        for i in range(len(stages[0])):
            xs = bottleneck(t, [s[i] for s in stages], xs)
        return tuple(xs)

    if t.models[0].fpn.remat and torch.is_grad_enabled():
        # every rank recomputes the stage, its exchanges included, at the
        # same point of the backward pass
        return list(checkpoint(run, *xs, use_reentrant=False,
                               preserve_rng_state=False))
    return list(run(*xs))


def smooth(t, name: str, xs):
    """The 3x3 smoothing conv `name` (P2_conv2..P5_conv2) on every
    shard."""
    convs = [getattr(m.fpn, name)[1] for m in t.models]
    return [conv_rows(c, s) for c, s in zip(convs, exchange(t, xs, 1, 1,
                                                            0.0))]


def fpn_forward(t, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """models.fpn.FPN.forward on the row shards of one group: NCHW
    (channels_last) shards of the input, in shard order -> [P2..P6], each
    gathered whole (NCHW, channels_last) on the first local shard's
    device."""
    fpns = [m.fpn for m in t.models]
    c2 = stage(t, "C2", stem(t, xs))
    c3 = stage(t, "C3", c2)
    c4 = stage(t, "C4", c3)
    c5 = stage(t, "C5", c4)
    p5 = [f.P5_conv1(c) for f, c in zip(fpns, c5)]
    up = nearest_upsample_2x
    p4 = [f.P4_conv1(c) + up(p) for f, c, p in zip(fpns, c4, p5)]
    p3 = [f.P3_conv1(c) + up(p) for f, c, p in zip(fpns, c3, p4)]
    p2 = [f.P2_conv1(c) + up(p) for f, c, p in zip(fpns, c2, p3)]
    levels = [gather(t, smooth(t, f"P{lvl}_conv2", p))
              for lvl, p in ((2, p2), (3, p3), (4, p4), (5, p5))]
    return levels + [levels[3][:, :, ::2, ::2]]


def shards(t, x: torch.Tensor) -> List[torch.Tensor]:
    """The whole NCHW map -> the local shards' rows, each on its device,
    contiguous channels_last."""
    h = x.shape[2] // t.size
    return [x[:, :, i * h:(i + 1) * h].to(d).contiguous(memory_format=_CL)
            for i, d in zip(t.indices, t.devices)]


def backbone(t, x: torch.Tensor) -> List[torch.Tensor]:
    """The whole NCHW (channels_last) input -> [P2..P6] through `t`."""
    return fpn_forward(t, shards(t, x))
