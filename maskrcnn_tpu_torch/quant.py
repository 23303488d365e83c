"""Post-training int8 quantization of the inference path (counterpart of
maskrcnn_tpu/quant.py, Config.QUANT_INT8), for Mask R-CNN and for
RetinaNet (the section at the end).

Scheme, as the JAX package's: per-output-channel weight scales
`sw = max|W| / 127` on BN-folded kernels; per-tensor activation scales
`sx = clip / 127` from calibration (amax, percentile or mse clips);
int8 x int8 -> int32 convs with the float32 epilogue
`y = float32(y32) * (sx * sw) + bias` (ops/int8_conv). Quantized: ResNet
stages C2-C5, the FPN neck, the RPN shared 3x3 and the mask head's conv1-4.
Float in the compute dtype: the stem, residual and top-down adds, the
RPN's 18-channel 1x1, the box head (and the cascade's stage heads), the
mask deconv and conv5, and the keypoint head, as in the JAX package.
Config.QUANT_SKIP keeps whole stage groups float.

One traversal serves both modes (as quant.py:25-31): "calib" runs the
float folded convs and records activation stats, "int8" runs the
quantized state; under SP_DEVICES the int8 mode runs the backbone and
neck on row shards (`fpn_forward` with a spatial transport), and
calibration stays whole. Activations are NHWC throughout, so a
calibration subsample ravels NHWC, as the JAX package's does.

Host side (numpy): `_conv_paths`, `_group_of`, `_search_clip`,
`_quantize_kernel`, `default_calib_canvases`, `params_fingerprint`, and
`prepare_quant_params`, which returns the quantized tree in the port's
layouts (int8 kernels [O, kh, kw, I]). Quantization and folding start
from the float32 state (`MaskRCNN.float_state`), never from the modules'
compute-dtype weights. `MaskRCNN.set_quant` puts a tree on the device;
`checkpoint.convert.from_jax_quant_params` reads a JAX tree.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from maskrcnn_tpu_torch.config import Config
from maskrcnn_tpu_torch.checkpoint.convert import name_map
from maskrcnn_tpu_torch.checkpoint.fold import fold_state_dict
from maskrcnn_tpu_torch.models.fpn import nearest_upsample_2x
from maskrcnn_tpu_torch.models.resnet import BLOCKS, stem_pool
from maskrcnn_tpu_torch.ops.image import normalize_image
from maskrcnn_tpu_torch.ops.int8_conv import (dequantize, int8_conv,
                                              quantize_tensor)

Tree = Dict[str, Dict]

SKIP_GROUPS = ("C2", "C3", "C4", "C5", "FPN", "RPN", "MASK")
_MASK_HEAD_ACTS = tuple(f"mask_head/a{i}" for i in range(4))


class QT(NamedTuple):
    """A quantized activation: int8 values and its 0-d float32 scale."""

    q: torch.Tensor
    scale: torch.Tensor


class Scale(NamedTuple):
    """An activation scale on the device, with its value on the host (the
    RoIAlign kernel takes its level scales by value)."""

    value: float
    tensor: torch.Tensor


# ---------------------------------------------------------------------
# host side (numpy)
# ---------------------------------------------------------------------

def _conv_paths(config: Config):
    """Every quantized backbone and neck conv path, in traversal order."""
    paths = []
    for stage, n in zip(("C2", "C3", "C4", "C5"), BLOCKS[config.BACKBONE]):
        for b in range(n):
            base = f"resnet/{stage}/block{b}"
            paths += [f"{base}/conv1", f"{base}/conv2", f"{base}/conv3"]
            if b == 0:
                paths.append(f"{base}/downsample_conv")
    paths += [f"P{i}_conv{j}" for i in (2, 3, 4, 5) for j in (1, 2)]
    return paths


def _group_of(name: str) -> str:
    """The Config.QUANT_SKIP group of a conv path or an activation name.
    Activations group by the conv that reads them: C{i}_out and P{i}_pre
    feed the FPN's lateral and smoothing convs."""
    if name.startswith("resnet/"):
        return name.split("/")[1]
    if name.startswith("rpn/"):
        return "RPN"
    if name.startswith("mask_head/"):
        return "MASK"
    return "FPN"


def _search_clip(amax: float, sample: np.ndarray, method: str,
                 percentile: float) -> float:
    """The activation clip of one tensor from its pooled |x| subsample.

    "percentile": the percentile of |x|, floored at amax / 50.
    "mse": the candidate among 32 log-spaced clips in [amax / 50, amax]
    with the least quantization MSE on the subsample (at most 65,536 of
    its values)."""
    amax = max(float(amax), 1e-6)
    if method == "percentile":
        return max(float(np.percentile(sample, percentile)),
                   amax / 50.0, 1e-6)
    if method != "mse":
        raise ValueError(f"QUANT_CALIB {method!r}: amax, percentile or mse")
    if sample.size > 65536:
        sample = sample[:: sample.size // 65536 + 1]
    cands = np.geomspace(amax / 50.0, amax, 32).astype(np.float32)
    s = cands / 127.0
    q = np.clip(np.round(sample[None, :] / s[:, None]), 0, 127) * s[:, None]
    mse = np.mean((sample[None, :] - q) ** 2, axis=1)
    return max(float(cands[int(np.argmin(mse))]), 1e-6)


def sample_stride(numel: int, channels: int, size: int) -> int:
    """The stride of a calibration subsample of about `size` values of an
    NHWC tensor: numel // size, as the JAX package strides, but one more
    where that is a multiple of the channel count. Such a stride reads
    channel 0 alone (at 1024² it does for every tensor from the stem to
    C4 and the FPN), and the clip fitted to one channel cuts the others;
    one more visits every channel. Elsewhere the subsample is the JAX
    package's."""
    stride = max(1, numel // size)
    return stride + 1 if stride % channels == 0 else stride


def _quantize_kernel(weight: np.ndarray, bias: np.ndarray) -> Dict:
    """A float32 conv weight [O, I, kh, kw] -> {kernel int8 [O, kh, kw, I],
    kscale [O], bias [O]} float32: per-output-channel symmetric scales."""
    k = np.asarray(weight, np.float32)
    amax = np.maximum(np.max(np.abs(k), axis=(1, 2, 3)), 1e-8)
    sw = (amax / 127.0).astype(np.float32)
    q = np.clip(np.round(k / sw[:, None, None, None]), -127, 127)
    return {"kernel": np.ascontiguousarray(
                q.astype(np.int8).transpose(0, 2, 3, 1)),
            "kscale": sw, "bias": np.asarray(bias, np.float32)}


def _calib_sample_size(config: Config) -> int:
    """|x| subsample size per tensor per calibration step (0: amax only)."""
    return 0 if config.QUANT_CALIB == "amax" else 16384


def default_calib_canvases(image_shape, n: int = 4,
                           seed: int = 0) -> np.ndarray:
    """Synthetic gradient-and-noise uint8 canvases [n, H, W, 3], the
    fallback calibration set (the JAX package's, value for value)."""
    ch, cw = int(image_shape[0]), int(image_shape[1])
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:ch, 0:cw]
    base = ((yy[..., None] * 255 // max(ch - 1, 1))
            + (xx[..., None] * 255 // max(cw - 1, 1))) // 2
    imgs = [np.clip(base + rng.randint(-60, 60, (ch, cw, 3)), 0, 255)
            for _ in range(n)]
    return np.asarray(imgs, np.uint8)


_FINGERPRINT = ("fpn.C1.0", "fpn.C2.0.conv1", "fpn.C5.2.conv3",
                "fpn.P2_conv2.1", "rpn.conv_shared")


def params_fingerprint(state: Dict[str, np.ndarray]) -> str:
    """The JAX package's calibration-cache key for the same weights: per
    sampled kernel, (sum, sum |x|) in float64 over the flax HWIO layout,
    so the sums run in the same order and the key matches."""
    parts = []
    for name in _FINGERPRINT:
        w = np.asarray(state[f"{name}.weight"]).transpose(2, 3, 1, 0)
        a = np.ascontiguousarray(w, dtype=np.float64)
        parts.append(f"{a.sum():.6e}:{np.abs(a).sum():.6e}")
    return "|".join(parts)


def stats_key(config: Config, state: Dict[str, np.ndarray]) -> str:
    """The calibration-stats file key (maskrcnn_tpu/api.py:143-146): the
    fingerprint, then the clip rule."""
    return (params_fingerprint(state) + f"|{config.QUANT_CALIB}"
            + (f":{config.QUANT_PERCENTILE}"
               if config.QUANT_CALIB == "percentile" else ""))


def _torch_names(architecture: str) -> Dict[str, str]:
    """Quant path (the JAX tree's, below "fpn/") -> torch module name."""
    return {fpath[len("fpn/"):] if fpath.startswith("fpn/") else fpath: t
            for t, fpath, _ in name_map(architecture)}


def _entry(state: Dict[str, np.ndarray], name: str) -> Dict:
    return {"weight": np.asarray(state[f"{name}.weight"], np.float32),
            "bias": np.asarray(state[f"{name}.bias"], np.float32)}


def prepare_quant_params(model, state: Dict[str, np.ndarray],
                         calib_images: Optional[np.ndarray] = None,
                         batch_size: int = 4,
                         act_stats: Optional[Dict[str, float]] = None
                         ) -> Tree:
    """Calibrate (unless `act_stats`, the dict `calibrate` returns, is
    given) and quantize. state: the float32 torch-layout state dict
    (`MaskRCNN.float_state`, or checkpoint.convert.from_jax_params).

    Returns {"convs": {path: int8 entry}, "convs_fp": {path: float32
    entry of a QUANT_SKIP group}, "acts": {name: float32 scale},
    "stem": float32 entry, "mask_head_fp": {deconv, conv5}}, numpy, the
    JAX tree's content in torch layouts. The mask head is quantized only
    when the stats have its four activations."""
    cfg = model.config
    if act_stats is None:
        if calib_images is None:
            raise ValueError("pass calib_images or act_stats")
        act_stats = calibrate(model, state, calib_images, batch_size)
    skip = set(cfg.QUANT_SKIP)
    if not skip <= set(SKIP_GROUPS):
        raise ValueError(f"QUANT_SKIP {sorted(skip)}: groups are "
                         f"{SKIP_GROUPS}")
    folded = fold_state_dict(state, cfg.BACKBONE)
    names = _torch_names(cfg.BACKBONE)
    acts = {k: np.float32(max(v, 1e-6) / 127.0)
            for k, v in act_stats.items() if _group_of(k) not in skip}
    convs, convs_fp = {}, {}
    for p in _conv_paths(cfg):
        e = _entry(folded, names[p])
        if _group_of(p) in skip:
            convs_fp[p] = e
        else:
            convs[p] = _quantize_kernel(e["weight"], e["bias"])
    if "RPN" not in skip:
        e = _entry(state, "rpn.conv_shared")
        convs["rpn/conv_shared"] = _quantize_kernel(e["weight"], e["bias"])
    tree = {"convs": convs, "convs_fp": convs_fp, "acts": acts,
            "stem": _entry(folded, names["resnet/C1_conv"])}
    if all(k in act_stats for k in _MASK_HEAD_ACTS) and "MASK" not in skip:
        for i in (1, 2, 3, 4):
            e = _entry(folded, f"mask.conv{i}")
            convs[f"mask_head/conv{i}"] = _quantize_kernel(e["weight"],
                                                           e["bias"])
        tree["mask_head_fp"] = {k: _entry(folded, f"mask.{k}")
                                for k in ("deconv", "conv5")}
    return tree


def _float_entry(e: Dict, dtype: torch.dtype, device) -> Dict:
    w = torch.from_numpy(np.array(e["weight"], np.float32))
    return {"weight": w.to(device=device, dtype=dtype).contiguous(
                memory_format=torch.channels_last),
            "bias": torch.from_numpy(np.array(e["bias"], np.float32)).to(
                device=device, dtype=dtype)}


def to_device(tree: Tree, dtype: torch.dtype, device) -> Tree:
    """A `prepare_quant_params` tree as tensors on `device`: int8 kernels,
    float32 kscale, bias and act scales (`Scale`s), float entries in the
    compute dtype."""
    def f32(a):
        return torch.from_numpy(np.array(a, np.float32)).to(device)

    out = {
        "convs": {p: {"kernel": torch.from_numpy(
                          np.array(e["kernel"], np.int8)).to(device),
                      "kscale": f32(e["kscale"]), "bias": f32(e["bias"])}
                  for p, e in tree["convs"].items()},
        "convs_fp": {p: _float_entry(e, dtype, device)
                     for p, e in tree["convs_fp"].items()},
        "acts": {k: Scale(float(np.float32(v)), f32(v))
                 for k, v in tree["acts"].items()},
        "stem": _float_entry(tree["stem"], dtype, device)}
    if "mask_head_fp" in tree:
        out["mask_head_fp"] = {k: _float_entry(e, dtype, device)
                               for k, e in tree["mask_head_fp"].items()}
    return out


# ---------------------------------------------------------------------
# the traversal (torch, NHWC)
# ---------------------------------------------------------------------

def float_conv(entry: Dict, x: torch.Tensor, stride: int, padding: int,
               dtype: torch.dtype) -> torch.Tensor:
    """conv(x, W) + b in the compute dtype, bias added after the conv as
    the JAX package adds it. x NHWC -> NHWC."""
    y = F.conv2d(x.to(dtype).permute(0, 3, 1, 2), entry["weight"],
                 stride=stride, padding=padding)
    return (y + entry["bias"][:, None, None]).permute(0, 2, 3, 1)


@dataclasses.dataclass
class _Ctx:
    """Traversal state of the calib (float) and int8 modes."""

    mode: str                       # "calib" | "int8"
    dtype: torch.dtype              # compute dtype of float tensors
    fp: Optional[Dict] = None       # calib: folded float convs by path
    tree: Optional[Tree] = None     # int8: `to_device` state
    stats: Dict = dataclasses.field(default_factory=dict)
    # calib: also keep a strided |x| subsample of about this many values
    calib_sample: int = 0

    def qt(self, name: str, x: torch.Tensor):
        """int8 mode: quantize x with its activation scale (x passes
        through float when the scale is absent: a QUANT_SKIP group).
        calib mode: record max |x| (and the subsample, in NHWC order)."""
        if self.mode == "calib":
            ax = x.to(torch.float32).abs()
            amax = ax.max()
            if self.calib_sample > 0:
                flat = ax.reshape(-1)
                stride = sample_stride(flat.shape[0], x.shape[-1],
                                       self.calib_sample)
                self.stats[name] = {"amax": amax,
                                    "sample": flat[::stride].clone()}
            else:
                self.stats[name] = amax
            return x
        s = self.tree["acts"].get(name)
        if s is None:
            return x
        return QT(quantize_tensor(x, s.tensor), s.tensor)

    def conv(self, path: str, x, stride: int = 1, padding: int = 0,
             relu: bool = False, fp_override: Optional[Dict] = None):
        """One conv + bias (+ ReLU): int8 for a QT input, float otherwise.
        `fp_override` gives float weights kept outside the backbone tree
        (the RPN shared conv, the calib mask head). A float input to a
        conv whose kernel was quantized raises: its activation scale is
        missing."""
        if self.mode == "int8" and isinstance(x, QT):
            e = self.tree["convs"][path]
            return dequantize(int8_conv(x.q, e["kernel"], stride, padding),
                              x.scale, e["kscale"], e["bias"], self.dtype,
                              relu)
        if self.mode == "calib":
            p = fp_override if fp_override is not None else self.fp[path]
        elif path in self.tree["convs"]:
            raise KeyError(f"{path}: the kernel is int8 but the input has "
                           "no activation scale")
        else:
            p = self.tree["convs_fp"].get(path, fp_override)
            if p is None:
                raise KeyError(f"{path}: no float weights")
        y = float_conv(p, x, stride, padding, self.dtype)
        return torch.relu(y) if relu else y


def _up2(x: torch.Tensor) -> torch.Tensor:
    return nearest_upsample_2x(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def _halo(t, vals, above: int, below: int, fill: float, pad_w: int):
    """NHWC row shards of spatial transport `t` (QTs or float tensors) ->
    slabs [rows above, shard, rows below] (parallel.spatial.exchange; fill
    past the canvas's edge), `pad_w` zero columns on each side. A QT's
    rows move as int8: the same integers, so each int32 accumulator of a
    conv on the slab is the unsharded conv's."""
    from maskrcnn_tpu_torch.parallel import spatial
    quantized = isinstance(vals[0], QT)
    raw = [v.q if quantized else v for v in vals]
    slabs = [F.pad(s.permute(0, 2, 3, 1), (0, 0, pad_w, pad_w))
             for s in spatial.exchange(t, [r.permute(0, 3, 1, 2)
                                           for r in raw], above, below, fill)]
    return ([QT(s, v.scale) for s, v in zip(slabs, vals)] if quantized
            else slabs)


def fpn_forward(config: Config, ctx, x, t=None):
    """ResNet + FPN neck in either mode: normalized images [B, H, W, 3]
    float32 -> [P2..P6] NHWC. The stem stays float.

    With a spatial transport `t` (parallel.spatial, int8 mode), `ctx` and
    `x` are lists, one a shard of t: the shard's ctx (its replica's int8
    state) and the images' NHWC rows. The stem and each 3x3 conv then run
    on slabs that carry their neighbours' rows (`_halo`, the halo plan of
    parallel.spatial) with padding 0 in H, and the levels are gathered
    whole on the first shard's device."""
    from maskrcnn_tpu_torch.parallel import spatial
    ctxs, xs = (ctx, x) if t is not None else ([ctx], [x])

    def qt(name, vals):
        return [c.qt(name, v) for c, v in zip(ctxs, vals)]

    def conv(path, vals, stride=1, padding=0, relu=False):
        if t is not None and padding:
            vals, padding = _halo(t, vals, padding, padding, 0.0,
                                  padding), 0
        return [c.conv(path, v, stride, padding, relu)
                for c, v in zip(ctxs, vals)]

    def block(path, vals, stride, downsample):
        """Bottleneck with folded BN (models/resnet.Bottleneck)."""
        xq = qt(f"{path}/in", vals)
        o = conv(f"{path}/conv1", xq, stride=stride, relu=True)
        o = conv(f"{path}/conv2", qt(f"{path}/a1", o), padding=1, relu=True)
        o = conv(f"{path}/conv3", qt(f"{path}/a2", o))
        res = (conv(f"{path}/downsample_conv", xq, stride=stride)
               if downsample else vals)
        return [torch.relu(a + r) for a, r in zip(o, res)]

    def stage(path, vals, blocks, stride):
        vals = block(f"{path}/block0", vals, stride, True)
        for i in range(1, blocks):
            vals = block(f"{path}/block{i}", vals, 1, False)
        return vals

    pad = 3
    if t is not None:
        xs, pad = _halo(t, xs, 3, 2, 0.0, 3), 0
    ys = [torch.relu(float_conv(
        c.fp["resnet/C1_conv"] if c.mode == "calib" else c.tree["stem"],
        v, 2, pad, c.dtype)) for c, v in zip(ctxs, xs)]
    ys = [y.permute(0, 3, 1, 2) for y in ys]
    if t is None:
        c1 = [stem_pool(ys[0])]
    else:
        c1 = [spatial.pool_rows(s) for s in spatial.exchange(
            t, ys, 0, 1, float("-inf"))]
    blocks = BLOCKS[config.BACKBONE]
    c2 = stage("resnet/C2", [c.permute(0, 2, 3, 1) for c in c1], blocks[0],
               1)
    c3 = stage("resnet/C3", c2, blocks[1], 2)
    c4 = stage("resnet/C4", c3, blocks[2], 2)
    c5 = stage("resnet/C5", c4, blocks[3], 2)

    p5 = conv("P5_conv1", qt("C5_out", c5))
    p4 = [a + _up2(b) for a, b in zip(conv("P4_conv1", qt("C4_out", c4)),
                                      p5)]
    p3 = [a + _up2(b) for a, b in zip(conv("P3_conv1", qt("C3_out", c3)),
                                      p4)]
    p2 = [a + _up2(b) for a, b in zip(conv("P2_conv1", qt("C2_out", c2)),
                                      p3)]
    levels = []
    for lvl, p in ((5, p5), (4, p4), (3, p3), (2, p2)):
        ys = conv(f"P{lvl}_conv2", qt(f"P{lvl}_pre", p), padding=1)
        levels.append(ys[0] if t is None else spatial.gather(
            t, [y.permute(0, 3, 1, 2) for y in ys]).permute(0, 2, 3, 1))
    p5s, p4s, p3s, p2s = levels
    return [p2s, p3s, p4s, p5s, p5s[:, ::2, ::2]]


def rpn_scores_forward(model, ctx: _Ctx,
                       feature_maps: Sequence[torch.Tensor]):
    """MaskRCNN.rpn_scores with the shared 3x3 through `ctx`: NHWC maps ->
    (scores [B, A] float32, deltas [B, A, 4]). The activation of level i
    is "rpn/P{i}" (P2 is 0). The fused 18-channel 1x1 stays float."""
    rpn = model.rpn
    fp = {"weight": rpn.conv_shared.weight, "bias": rpn.conv_shared.bias}
    s = model.config.RPN_ANCHOR_STRIDE
    return rpn.outputs(
        ctx.conv("rpn/conv_shared", ctx.qt(f"rpn/P{i}", f), stride=s,
                 padding=1, relu=True, fp_override=fp).permute(0, 3, 1, 2)
        for i, f in enumerate(feature_maps))


def mask_head_forward(config: Config, ctx: _Ctx, pooled: torch.Tensor,
                      fp_mh: Optional[Dict] = None) -> torch.Tensor:
    """MaskHead with conv1-4 through `ctx`; the deconv and conv5 stay float.
    pooled [N, 14, 14, C] -> sigmoid masks [N, 28, 28, K] float32.
    fp_mh: the folded float head by name (calib mode only)."""
    x = pooled.to(ctx.dtype)
    for i in range(1, 5):
        xq = ctx.qt(f"mask_head/a{i - 1}", x)
        ov = fp_mh[f"conv{i}"] if ctx.mode == "calib" else None
        x = ctx.conv(f"mask_head/conv{i}", xq, padding=1, relu=True,
                     fp_override=ov)
    fp = fp_mh if ctx.mode == "calib" else ctx.tree["mask_head_fp"]
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2), fp["deconv"]["weight"],
                           stride=2)
    y = torch.relu(y + fp["deconv"]["bias"][:, None, None])
    y = F.conv2d(y, fp["conv5"]["weight"]) + fp["conv5"]["bias"][:, None,
                                                                 None]
    return torch.sigmoid(y.to(torch.float32)).permute(0, 2, 3, 1)


def _int8_ctx(model) -> _Ctx:
    return _Ctx(mode="int8", dtype=model.dtype, tree=model.quant)


def quant_backbone(model, x: torch.Tensor):
    """The int8 backbone and neck of a prepared model (MaskRCNN.backbone),
    on row shards through the model's spatial transport when it has
    one."""
    t = model.spatial
    if t is None:
        return fpn_forward(model.config, _int8_ctx(model), x)
    from maskrcnn_tpu_torch.parallel import spatial
    xs = [s.permute(0, 2, 3, 1)
          for s in spatial.shards(t, x.permute(0, 3, 1, 2))]
    return fpn_forward(model.config, [_int8_ctx(m) for m in t.models], xs, t)


def quant_rpn_scores(model, feature_maps: Sequence[torch.Tensor]):
    return rpn_scores_forward(model, _int8_ctx(model), feature_maps)


def quant_mask_head(model, pooled: torch.Tensor) -> torch.Tensor:
    return mask_head_forward(model.config, _int8_ctx(model), pooled)


def roi_scales(model) -> Optional[Sequence[Scale]]:
    """The int8 RoIAlign tables' scales, P2..P5 (the RPN input scales
    "rpn/P0".."rpn/P3"), when Config.QUANT_INT8_ROI is set and the
    prepared state has all four; else None (bf16 tables)."""
    cfg = model.config
    if not (cfg.QUANT_INT8 and cfg.QUANT_INT8_ROI and model.quant):
        return None
    acts = model.quant["acts"]
    if not all(f"rpn/P{i}" in acts for i in range(4)):
        return None
    return [acts[f"rpn/P{i}"] for i in range(4)]


# ---------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------

def _to_host(stats: Dict) -> Dict:
    """Device stats -> python floats / numpy, keys sorted (the order a
    jitted JAX function returns a dict in)."""
    out = {}
    for k in sorted(stats):
        v = stats[k]
        if isinstance(v, dict):
            out[k] = {"amax": float(v["amax"]),
                      "sample": v["sample"].cpu().numpy()}
        else:
            out[k] = float(v)
    return out


def calibrate(model, state: Dict[str, np.ndarray], calib_images: np.ndarray,
              batch_size: int = 4) -> Dict[str, float]:
    """Run the float model over calibration canvases [N, H, W, 3] uint8
    (IMAGE_SHAPE canvases) on the model's device; return per-tensor
    activation clips {name: float} (scale = clip / 127), JSON-ready.

    Backbone, neck and RPN in calib mode from the folded float32 `state`,
    then the float pipeline to the mask RoIAlign (detect_and_pool_masks)
    and the mask head in calib mode.
    Config.QUANT_CALIB picks the clip: the running max |x| ("amax"), or a
    search over the pooled subsamples ("percentile", "mse")."""
    from maskrcnn_tpu_torch.detection.pipeline import detect_and_pool_masks

    cfg = model.config
    calib_images = np.asarray(calib_images)
    want = tuple(cfg.IMAGE_SHAPE[:2])
    if calib_images.ndim != 4 or calib_images.shape[0] < 1 or \
            calib_images.shape[1:3] != want:
        raise ValueError(f"calib canvases {calib_images.shape}: want "
                         f"[N, {want[0]}, {want[1]}, 3], placed as inference "
                         "inputs are")
    device, dtype = model.anchor_boxes.device, model.dtype
    names = _torch_names(cfg.BACKBONE)
    folded = fold_state_dict(state, cfg.BACKBONE)
    fp = {p: _float_entry(_entry(folded, names[p]), dtype, device)
          for p in _conv_paths(cfg) + ["resnet/C1_conv"]}
    fp_mh = {k: _float_entry(_entry(folded, f"mask.{k}"), dtype, device)
             for k in ("conv1", "conv2", "conv3", "conv4", "deconv",
                       "conv5")}
    sample = _calib_sample_size(cfg)
    ch, cw = want
    amaxes: Dict[str, float] = {}
    samples: Dict[str, list] = {}
    with torch.inference_mode(), model.float_path():
        for i in range(0, calib_images.shape[0], batch_size):
            batch = torch.from_numpy(calib_images[i:i + batch_size]).to(device)
            ctx = _Ctx(mode="calib", dtype=dtype, fp=fp, calib_sample=sample)
            feats = fpn_forward(cfg, ctx, normalize_image(batch,
                                                          cfg.MEAN_PIXEL))
            rpn_scores_forward(model, ctx, feats)
            del feats
            win = torch.tensor([[0.0, 0.0, ch, cw]] * batch.shape[0],
                               dtype=torch.float32).to(device)
            _, pooled = detect_and_pool_masks(model, batch, win)
            hctx = _Ctx(mode="calib", dtype=dtype, calib_sample=sample)
            mask_head_forward(cfg, hctx, pooled.reshape(-1, *pooled.shape[2:]),
                              fp_mh=fp_mh)
            out = dict(_to_host(ctx.stats), **_to_host(hctx.stats))
            for k, v in out.items():
                if sample:
                    amaxes[k] = max(amaxes.get(k, 0.0), v["amax"])
                    samples.setdefault(k, []).append(v["sample"])
                else:
                    amaxes[k] = max(amaxes.get(k, 0.0), v)
    if not sample:
        return amaxes
    stats: Dict[str, float] = {}
    rng = np.random.RandomState(0)
    for k, amax in amaxes.items():
        pool = np.concatenate(samples[k])
        if pool.size > 262144:
            pool = pool[rng.choice(pool.size, 262144, replace=False)]
        stats[k] = _search_clip(amax, pool, cfg.QUANT_CALIB,
                                cfg.QUANT_PERCENTILE)
    return stats


# ---------------------------------------------------------------------
# RetinaNet (models/retina_fpn.py; maskrcnn_tpu/quant.py:600-801)
# ---------------------------------------------------------------------
#
# Quantized: every ResNet and pyramid conv but the stem, and the head's
# eight tower convs (per-(conv, level) input scales). Float in the
# compute dtype: the stem, the residual and top-down adds, cls_out and
# box_out. Calibration is amax, as the JAX package's.

_RETINA_LAYERS = ("layer2", "layer3", "layer4", "layer5")
_RETINA_NECK = ("conv6", "conv7", "toplayer", "latlayer1", "latlayer2",
                "smooth1", "smooth2")


def _fold_retina_state(state: Dict[str, np.ndarray], num_blocks
                       ) -> Dict[str, Dict]:
    """RetinaFPN's float32 torch-layout state -> {quant path: float32
    {weight, bias}}: each frozen BN folded into its bias-free conv in
    float64 (the bias is the BN offset), as the JAX `_fold_retina_tree`;
    the neck's biased convs pass through."""
    def fold(conv: str, bn: str) -> Dict:
        scale = (np.asarray(state[f"{bn}.weight"], np.float64)
                 / np.sqrt(np.asarray(state[f"{bn}.running_var"],
                                      np.float64) + 1e-3))
        offset = (np.asarray(state[f"{bn}.bias"], np.float64)
                  - np.asarray(state[f"{bn}.running_mean"], np.float64)
                  * scale)
        k = np.asarray(state[f"{conv}.weight"], np.float64) * scale[
            :, None, None, None]
        return {"weight": k.astype(np.float32),
                "bias": offset.astype(np.float32)}

    out = {"conv1": fold("fpn.conv1", "fpn.bn1")}
    for layer, n in zip(_RETINA_LAYERS, num_blocks):
        for b in range(n):
            path = f"{layer}_block{b}"
            t = f"fpn.{path}"
            for j in (1, 2, 3):
                out[f"{path}/conv{j}"] = fold(f"{t}.conv{j}", f"{t}.bn{j}")
            if f"{t}.shortcut_conv.weight" in state:
                out[f"{path}/shortcut_conv"] = fold(f"{t}.shortcut_conv",
                                                    f"{t}.shortcut_bn")
    for name in _RETINA_NECK:
        out[name] = _entry(state, f"fpn.{name}")
    return out


def _retina_conv_paths(num_blocks):
    """The quantized RetinaFPN conv paths, in traversal order."""
    paths = []
    for layer, n in zip(_RETINA_LAYERS, num_blocks):
        for b in range(n):
            base = f"{layer}_block{b}"
            paths += [f"{base}/conv{j}" for j in (1, 2, 3)]
            if b == 0:
                paths.append(f"{base}/shortcut_conv")
    return paths + list(_RETINA_NECK)


def _retina_block(ctx: _Ctx, path: str, x, stride: int):
    """RetinaBottleneck with folded BN (the stride on conv2)."""
    src = ctx.fp if ctx.mode == "calib" else ctx.tree["convs"]
    xq = ctx.qt(f"{path}/in", x)
    o = ctx.conv(f"{path}/conv1", xq, relu=True)
    o = ctx.conv(f"{path}/conv2", ctx.qt(f"{path}/a1", o), stride=stride,
                 padding=1, relu=True)
    o = ctx.conv(f"{path}/conv3", ctx.qt(f"{path}/a2", o))
    residual = (ctx.conv(f"{path}/shortcut_conv", xq, stride=stride)
                if f"{path}/shortcut_conv" in src else x)
    return torch.relu(o + residual)


def _resize_nhwc(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    from maskrcnn_tpu_torch.models.retina_fpn import bilinear_resize
    return bilinear_resize(x.permute(0, 3, 1, 2), h, w).permute(0, 2, 3, 1)


def retina_fpn_forward(ctx: _Ctx, x: torch.Tensor, num_blocks):
    """RetinaFPN P3..P7 in either mode: images [B, H, W, 3] -> five NHWC
    maps. The stem stays float."""
    stem = ctx.fp["conv1"] if ctx.mode == "calib" else ctx.tree["stem"]
    x = torch.relu(float_conv(stem, x, 2, 3, ctx.dtype))
    c = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, padding=1).permute(
        0, 2, 3, 1)
    outs = []
    for li, (layer, n) in enumerate(zip(_RETINA_LAYERS, num_blocks)):
        for b in range(n):
            c = _retina_block(ctx, f"{layer}_block{b}", c,
                              2 if b == 0 and li > 0 else 1)
        outs.append(c)
    c3, c4, c5 = outs[1:]
    p6 = ctx.conv("conv6", ctx.qt("c5_for_p6", c5), stride=2, padding=1)
    p7 = ctx.conv("conv7", ctx.qt("p6_relu", torch.relu(p6)), stride=2,
                  padding=1)
    p5 = ctx.conv("toplayer", ctx.qt("c5_top", c5))
    lat4 = ctx.conv("latlayer1", ctx.qt("c4_lat", c4))
    p4 = _resize_nhwc(p5, lat4.shape[1], lat4.shape[2]) + lat4
    lat3 = ctx.conv("latlayer2", ctx.qt("c3_lat", c3))
    p3 = _resize_nhwc(p4, lat3.shape[1], lat3.shape[2]) + lat3
    p4 = ctx.conv("smooth1", ctx.qt("p4_pre", p4), padding=1)
    p3 = ctx.conv("smooth2", ctx.qt("p3_pre", p3), padding=1)
    return [p3, p4, p5, p6, p7]


def _module_entry(conv) -> Dict:
    return {"weight": conv.weight, "bias": conv.bias}


def retina_head_forward(config: Config, ctx: _Ctx, head, feats):
    """RetinaHead over NHWC maps through `ctx`: the tower convs with the
    activation "head/{cls,box}{i}/P{level}"; cls_out and box_out float
    (the module's weights). -> (logits [B, A, K], deltas [B, A, 4])
    float32."""
    k = config.NUM_CLASSES
    cls_l, box_l = [], []
    for lvl, f in enumerate(feats):
        cls = box = f
        for i in range(4):
            cls = ctx.conv(f"head/cls{i}", ctx.qt(f"head/cls{i}/P{lvl}", cls),
                           padding=1, relu=True,
                           fp_override=_module_entry(getattr(head, f"cls{i}")))
            box = ctx.conv(f"head/box{i}", ctx.qt(f"head/box{i}/P{lvl}", box),
                           padding=1, relu=True,
                           fp_override=_module_entry(getattr(head, f"box{i}")))
        cls = float_conv(_module_entry(head.cls_out), cls, 1, 1, ctx.dtype)
        box = float_conv(_module_entry(head.box_out), box, 1, 1, ctx.dtype)
        b = f.shape[0]
        cls_l.append(cls.reshape(b, -1, k).to(torch.float32))
        box_l.append(box.reshape(b, -1, 4).to(torch.float32))
    return torch.cat(cls_l, dim=1), torch.cat(box_l, dim=1)


def calibrate_retina(net, folded: Dict[str, Dict], calib_images: np.ndarray,
                     batch_size: int = 4) -> Dict[str, float]:
    """Run the folded float RetinaNet over uint8 canvases [N, H, W, 3]
    (normalized here, as the JAX `_retina_calib_step`) -> {name: amax}."""
    cfg = net.config
    calib_images = np.asarray(calib_images)
    want = tuple(cfg.IMAGE_SHAPE[:2])
    if calib_images.ndim != 4 or calib_images.shape[1:3] != want:
        raise ValueError(f"calib canvases {calib_images.shape}: want "
                         f"[N, {want[0]}, {want[1]}, 3]")
    fp = {p: _float_entry(e, net.dtype, net.device)
          for p, e in folded.items()}
    stats: Dict[str, float] = {}
    with torch.inference_mode():
        for i in range(0, calib_images.shape[0], batch_size):
            batch = torch.from_numpy(calib_images[i:i + batch_size]).to(
                net.device)
            ctx = _Ctx(mode="calib", dtype=net.dtype, fp=fp)
            feats = retina_fpn_forward(
                ctx, normalize_image(batch, cfg.MEAN_PIXEL),
                net.fpn.num_blocks)
            retina_head_forward(cfg, ctx, net.head, feats)
            for k, v in _to_host(ctx.stats).items():
                stats[k] = max(stats.get(k, 0.0), v)
    return stats


def prepare_retina_quant_params(net, state: Dict[str, np.ndarray],
                                calib_images: Optional[np.ndarray] = None,
                                batch_size: int = 4,
                                act_stats: Optional[Dict[str, float]] = None
                                ) -> Tree:
    """RetinaNet's `prepare_quant_params`: `net` a models.retina_fpn
    .RetinaNet, `state` its float32 torch-layout state (`float_state`).
    Returns {"convs", "convs_fp": {}, "acts", "stem"} (numpy) for
    `RetinaNet.set_quant`; the head's cls_out and box_out stay the
    module's."""
    nb = net.fpn.num_blocks
    folded = _fold_retina_state(state, nb)
    if act_stats is None:
        if calib_images is None:
            raise ValueError("pass calib_images or act_stats")
        act_stats = calibrate_retina(net, folded, calib_images, batch_size)
    acts = {k: np.float32(max(v, 1e-6) / 127.0) for k, v in act_stats.items()}
    convs = {p: _quantize_kernel(folded[p]["weight"], folded[p]["bias"])
             for p in _retina_conv_paths(nb)}
    for i in range(4):
        for tower in ("cls", "box"):
            e = _entry(state, f"head.{tower}{i}")
            convs[f"head/{tower}{i}"] = _quantize_kernel(e["weight"],
                                                         e["bias"])
    return {"convs": convs, "convs_fp": {}, "acts": acts,
            "stem": folded["conv1"]}


def retina_quant_forward(net, images: torch.Tensor):
    """int8 (logits, deltas): RetinaNet.forward's quantized twin."""
    ctx = _Ctx(mode="int8", dtype=net.dtype, tree=net.quant)
    feats = retina_fpn_forward(ctx, images, net.fpn.num_blocks)
    return retina_head_forward(net.config, ctx, net.head, feats)
