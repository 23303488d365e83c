"""Weights into the port: a JAX parameter tree or the reference `.pth`
(counterpart of maskrcnn_tpu/checkpoint/torch_convert.py and the `.pth`
branch of maskrcnn_tpu/checkpoint/store.load_params).

The port's state-dict names are the reference checkpoint's, so a `.pth`
loads by name (`read_pth`); a JAX tree goes through a numpy port of
`name_map` and `to_torch_state_dict` (`from_jax_params`). Both end in
`load_state`: the FOLD_BN fold, a strict load, and the float32 state
kept for QUANT_INT8. Layouts of a JAX tree:
* flax conv kernel [kh, kw, I, O]    -> Conv2d weight [O, I, kh, kw]
* flax deconv kernel [kh, kw, O, I]  -> ConvTranspose2d [I, O, kh, kw]
* flax dense kernel [I, O]           -> Linear weight [O, I]
* BN weight/bias/running_mean/running_var copy through.

The optional heads, which the reference `.pth` does not have, take these
state-dict names (the JAX tree's names beside them):
* cascade box head i >= 2: `classifier{i}.` + the box head's names
  (`box_head{i}/...`), one a stage of Config.CASCADE_STAGES past the first;
* keypoint head: `keypoint.conv1` .. `keypoint.conv{KEYPOINT_HEAD_CONVS}`,
  `keypoint.deconv`, `keypoint.score` (`kp_head/conv{j}`, `kp_head/deconv`,
  `kp_head/score`).
A checkpoint that lacks one of these branches whole loads with the branch
kept at the model's own values (`load_state`), as the JAX
`store.load_params` keeps a branch at its initialization.
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np

# bottlenecks per stage (models/resnet.BLOCKS; repeated to stay torch-free)
_BLOCKS = {"resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3)}
_BN_FIELDS = ("weight", "bias", "running_mean", "running_var")


def _box_head(t: str, f: str) -> List[Tuple[str, str, str]]:
    return [(f"{t}.conv1", f"{f}/conv1", "conv"),
            (f"{t}.bn1", f"{f}/bn1", "bn"),
            (f"{t}.conv2", f"{f}/conv2", "conv"),
            (f"{t}.bn2", f"{f}/bn2", "bn"),
            (f"{t}.linear_class", f"{f}/linear_class", "linear"),
            (f"{t}.linear_bbox", f"{f}/linear_bbox", "linear")]


def name_map(architecture: str = "resnet101", box_heads: int = 1,
             keypoint_convs: int = 0) -> List[Tuple[str, str, str]]:
    """[(torch prefix, flax path prefix, kind)] for every weighted module;
    kind is conv | convT | linear | bn. box_heads > 1 adds the cascade's
    heads 2.., keypoint_convs > 0 the keypoint head (`tree_branches` and
    `state_branches` read them off a tree or a state dict)."""
    out: List[Tuple[str, str, str]] = [
        ("fpn.C1.0", "fpn/resnet/C1_conv", "conv"),
        ("fpn.C1.1", "fpn/resnet/C1_bn", "bn")]
    for stage, blocks in zip((2, 3, 4, 5), _BLOCKS[architecture]):
        for i in range(blocks):
            t = f"fpn.C{stage}.{i}"
            f = f"fpn/resnet/C{stage}/block{i}"
            for j in (1, 2, 3):
                out.append((f"{t}.conv{j}", f"{f}/conv{j}", "conv"))
                out.append((f"{t}.bn{j}", f"{f}/bn{j}", "bn"))
            if i == 0:
                out.append((f"{t}.downsample.0", f"{f}/downsample_conv",
                            "conv"))
                out.append((f"{t}.downsample.1", f"{f}/downsample_bn", "bn"))
    for lvl in (2, 3, 4, 5):
        out.append((f"fpn.P{lvl}_conv1", f"fpn/P{lvl}_conv1", "conv"))
        out.append((f"fpn.P{lvl}_conv2.1", f"fpn/P{lvl}_conv2", "conv"))
    out += [("rpn.conv_shared", "rpn/conv_shared", "conv"),
            ("rpn.conv_class", "rpn/conv_class", "conv"),
            ("rpn.conv_bbox", "rpn/conv_bbox", "conv")]
    out += _box_head("classifier", "box_head")
    for j in range(1, 5):
        out.append((f"mask.conv{j}", f"mask_head/conv{j}", "conv"))
        out.append((f"mask.bn{j}", f"mask_head/bn{j}", "bn"))
    out += [("mask.deconv", "mask_head/deconv", "convT"),
            ("mask.conv5", "mask_head/conv5", "conv")]
    for i in range(2, box_heads + 1):
        out += _box_head(f"classifier{i}", f"box_head{i}")
    if keypoint_convs:
        out += [(f"keypoint.conv{j}", f"kp_head/conv{j}", "conv")
                for j in range(1, keypoint_convs + 1)]
        out += [("keypoint.deconv", "kp_head/deconv", "convT"),
                ("keypoint.score", "kp_head/score", "conv")]
    return out


def branch_of(key: str):
    """The optional branch a state key belongs to ("classifier2", ...,
    "keypoint"), or None for the two-head model's keys."""
    head = key.split(".", 1)[0]
    if head == "keypoint" or (head.startswith("classifier")
                              and head != "classifier"):
        return head
    return None


def _count(names, pattern: str, start: int) -> int:
    n = start
    while pattern.format(n + 1) in names:
        n += 1
    return n


def tree_branches(params: Dict) -> Dict[str, int]:
    """`name_map`'s optional heads of a JAX tree, read from its keys."""
    return {"box_heads": _count(params, "box_head{}", 1),
            "keypoint_convs": _count(params.get("kp_head", {}), "conv{}", 0)}


def state_branches(keys) -> Dict[str, int]:
    """`name_map`'s optional heads of a torch-layout state, read from its
    keys."""
    keys = set(keys)
    return {"box_heads": _count(keys, "classifier{}.conv1.weight", 1),
            "keypoint_convs": _count(keys, "keypoint.conv{}.weight", 0)}


def _get(tree: Dict, path: str) -> np.ndarray:
    node = tree
    for k in path.split("/"):
        node = node[k]
    return np.asarray(node)


def from_jax_params(params: Dict, architecture: str = "resnet101"
                    ) -> Dict[str, np.ndarray]:
    """JAX parameter tree (nested dicts of arrays) -> torch-layout state
    dict of numpy arrays, with whichever optional heads the tree has
    (cascade `box_head{i}`, `kp_head`)."""
    out: Dict[str, np.ndarray] = {}
    names = name_map(architecture, **tree_branches(params))
    for tname, fpath, kind in names:
        if kind in ("conv", "convT"):
            out[f"{tname}.weight"] = _get(
                params, f"{fpath}/kernel").transpose(3, 2, 0, 1)
            out[f"{tname}.bias"] = _get(params, f"{fpath}/bias")
        elif kind == "linear":
            out[f"{tname}.weight"] = _get(params, f"{fpath}/kernel").T
            out[f"{tname}.bias"] = _get(params, f"{fpath}/bias")
        elif kind == "bn":
            for field in _BN_FIELDS:
                out[f"{tname}.{field}"] = _get(params, f"{fpath}/{field}")
    return out


def read_pth(path: str, keys) -> Dict[str, np.ndarray]:
    """The entries of a reference `.pth` state dict that `keys` (the
    model's state-dict keys) name, as float32 numpy arrays
    (`num_batches_tracked` and any other key is dropped, as
    torch_convert.from_torch_state_dict ignores them); `load_state`
    decides what a missing key means. A directory (an orbax checkpoint of
    the JAX package) raises ValueError."""
    import torch
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory, an orbax checkpoint of the JAX "
            "package: reading it needs orbax, a JAX library the port does "
            "not use. Write it as a .pth with the JAX package "
            "(checkpoint.torch_convert.to_torch_state_dict, then "
            "torch.save) and load that")
    state = torch.load(path, map_location="cpu", weights_only=True)
    return {k: state[k].detach().to(torch.float32).numpy()
            for k in keys if k in state}


def load_state(model, state: Dict[str, np.ndarray],
               reinit_mismatched: bool = False) -> None:
    """Load a float32 torch-layout state (unfolded or folded) into a
    MaskRCNN: strict, every key of the model present (but for a whole
    optional head, below) and nothing else.
    Under Config.FOLD_BN the float32 state is folded first
    (checkpoint.fold; folding twice is a no-op). Under Config.QUANT_INT8
    the model keeps the float32 state for quantization and drops its
    prepared int8 state.

    A tensor whose shape differs from the model's raises ValueError,
    unless reinit_mismatched=True: then each such tensor keeps the
    model's own value (its float32 state under QUANT_INT8, else its
    weights in float32: the init, unless weights were loaded since) and
    the list is printed, as the JAX `store.load_params` does (the
    fine-tune flow for another NUM_CLASSES).

    An optional head (cascade stage, keypoint head) that `state` lacks
    whole keeps the model's own values in the same way, and the list is
    printed (the JAX `store.load_params` keeps such a branch at its
    initialization); any other missing key raises KeyError."""
    import torch
    own = model.state_dict()
    absent = sorted({branch_of(k) for k in own if k not in state},
                    key=str)
    if None in absent or any(k in state for k in own
                             if branch_of(k) in absent):
        missing = [k for k in own if k not in state]
        raise KeyError(f"the state lacks {len(missing)} of the model's "
                       f"weights: {', '.join(missing)}")
    if absent:
        state = dict(state)
        for k in own:
            if branch_of(k) in absent:
                state[k] = _own_float32(model, own, k)
        print(f"checkpoint lacks {absent}: these branches keep the "
              "model's values (its initialization unless weights were "
              "loaded since)")
    if model.config.FOLD_BN:
        from maskrcnn_tpu_torch.checkpoint.fold import fold_state_dict
        state = fold_state_dict(state, model.config.BACKBONE)
    mismatched = [k for k in own if k in state
                  and tuple(np.shape(state[k])) != tuple(own[k].shape)]
    if mismatched:
        if not reinit_mismatched:
            raise ValueError(
                "checkpoint shapes do not match the model: "
                f"{', '.join(mismatched)} (pass reinit_mismatched=True to "
                "keep the model's own values for incompatible tensors, "
                "e.g. when fine-tuning to a different NUM_CLASSES)")
        state = dict(state)
        for k in mismatched:
            state[k] = _own_float32(model, own, k)
        print(f"reinitialized {len(mismatched)} shape-mismatched tensors: "
              + ", ".join(mismatched))
    model.load_state_dict({k: torch.tensor(v) for k, v in state.items()},
                          strict=True)
    model.keep_float_state(state)


def _own_float32(model, own: Dict, key: str) -> np.ndarray:
    """The model's own value of `key` in float32: its float32 state under
    QUANT_INT8, else its weight cast up from the compute dtype."""
    import torch
    kept = model.float_state or {}
    if key in kept:
        return np.asarray(kept[key], np.float32)
    return own[key].to(torch.float32).cpu().numpy()


def load_jax_params(model, params: Dict) -> None:
    """Load a JAX parameter tree into a MaskRCNN through `load_state`
    (the tree may be unfolded or already folded)."""
    load_state(model, from_jax_params(params, model.config.BACKBONE))


def _float_conv(entry: Dict) -> Dict[str, np.ndarray]:
    return {"weight": np.asarray(entry["kernel"], np.float32)
            .transpose(3, 2, 0, 1),
            "bias": np.asarray(entry["bias"], np.float32)}


def from_jax_quant_params(params: Dict) -> Dict:
    """A JAX `quant.prepare_quant_params` tree (the whole tree or its
    "quant" subtree) -> the port's quantized tree, as the port's
    `quant.prepare_quant_params` returns it: int8 kernels HWIO -> [O, kh,
    kw, I] (the GEMM layout), float kernels -> torch layouts (the
    deconv's [kh, kw, O, I] -> [I, O, kh, kw]), scales float32."""
    q = params.get("quant", params)
    out = {
        "convs": {p: {"kernel": np.ascontiguousarray(
                          np.asarray(e["kernel"], np.int8)
                          .transpose(3, 0, 1, 2)),
                      "kscale": np.asarray(e["kscale"], np.float32),
                      "bias": np.asarray(e["bias"], np.float32)}
                  for p, e in q["convs"].items()},
        "convs_fp": {p: _float_conv(e) for p, e in q["convs_fp"].items()},
        "acts": {k: np.float32(v) for k, v in q["acts"].items()},
        "stem": _float_conv(q["stem"])}
    if "mask_head_fp" in q:
        out["mask_head_fp"] = {k: _float_conv(e)
                               for k, e in q["mask_head_fp"].items()}
    return out
