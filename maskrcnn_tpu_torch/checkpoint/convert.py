"""JAX parameter tree -> PyTorch state dict (counterpart of
maskrcnn_tpu/checkpoint/torch_convert.py).

A torch-free numpy port of `name_map` and `to_torch_state_dict`: the JAX
package's copy cannot be imported without JAX, because
`maskrcnn_tpu/checkpoint/__init__.py` imports the orbax store. Layouts:
* flax conv kernel [kh, kw, I, O]    -> Conv2d weight [O, I, kh, kw]
* flax deconv kernel [kh, kw, O, I]  -> ConvTranspose2d [I, O, kh, kw]
* flax dense kernel [I, O]           -> Linear weight [O, I]
* BN weight/bias/running_mean/running_var copy through.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

# bottlenecks per stage (models/resnet.BLOCKS; repeated to stay torch-free)
_BLOCKS = {"resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3)}
_BN_FIELDS = ("weight", "bias", "running_mean", "running_var")


def name_map(architecture: str = "resnet101") -> List[Tuple[str, str, str]]:
    """[(torch prefix, flax path prefix, kind)] for every weighted module;
    kind is conv | convT | linear | bn."""
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
            ("rpn.conv_bbox", "rpn/conv_bbox", "conv"),
            ("classifier.conv1", "box_head/conv1", "conv"),
            ("classifier.bn1", "box_head/bn1", "bn"),
            ("classifier.conv2", "box_head/conv2", "conv"),
            ("classifier.bn2", "box_head/bn2", "bn"),
            ("classifier.linear_class", "box_head/linear_class", "linear"),
            ("classifier.linear_bbox", "box_head/linear_bbox", "linear")]
    for j in range(1, 5):
        out.append((f"mask.conv{j}", f"mask_head/conv{j}", "conv"))
        out.append((f"mask.bn{j}", f"mask_head/bn{j}", "bn"))
    out += [("mask.deconv", "mask_head/deconv", "convT"),
            ("mask.conv5", "mask_head/conv5", "conv")]
    return out


def _get(tree: Dict, path: str) -> np.ndarray:
    node = tree
    for k in path.split("/"):
        node = node[k]
    return np.asarray(node)


def from_jax_params(params: Dict, architecture: str = "resnet101"
                    ) -> Dict[str, np.ndarray]:
    """JAX parameter tree (nested dicts of arrays) -> torch-layout state
    dict of numpy arrays."""
    out: Dict[str, np.ndarray] = {}
    for tname, fpath, kind in name_map(architecture):
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


def load_jax_params(model, params: Dict) -> None:
    """Load a JAX parameter tree into a MaskRCNN (strict: every key of the
    model must be present and nothing else). Under Config.FOLD_BN the
    float32 weights are folded first (checkpoint.fold), so the tree may
    be unfolded or already folded: folding twice is a no-op. Under
    Config.QUANT_INT8 the model keeps the float32 state for quantization
    and drops its prepared int8 state."""
    import torch
    state = from_jax_params(params, model.config.BACKBONE)
    if model.config.FOLD_BN:
        from maskrcnn_tpu_torch.checkpoint.fold import fold_state_dict
        state = fold_state_dict(state, model.config.BACKBONE)
    model.load_state_dict({k: torch.tensor(v) for k, v in state.items()},
                          strict=True)
    model.keep_float_state(state)


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
