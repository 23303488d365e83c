"""Fold frozen BatchNorm into the adjacent conv (counterpart of
maskrcnn_tpu/checkpoint/fold.py).

BN is a constant per-channel affine y = conv(x) * s + o with
s = w / sqrt(var + eps) and o = b - mean * s, so folding gives
kernel' = kernel * s (per output channel) and bias' = bias * s + o. The
BN entries are reset to the identity (1, 0, 0, 1 - eps): the key set is
unchanged, `load_state_dict(strict=True)` still holds, and folding twice
is a no-op. Inference only: never train folded weights.

Torch-free numpy, like convert.py. Fold float32 weights, before any cast
to the compute dtype: folding bf16 weights would round twice.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from maskrcnn_tpu_torch.checkpoint.convert import name_map

# nn.BatchNorm2d(..., eps=0.001) in the reference (model.py:180)
BN_EPS = 1e-3

# conv module name -> its BN partner within the same parent
_SPECIAL = {"downsample_conv": "downsample_bn", "C1_conv": "C1_bn"}


def _bn_partner(name: str):
    if name in _SPECIAL:
        return _SPECIAL[name]
    if name.startswith("conv") and name[4:].isdigit():
        return "bn" + name[4:]
    return None


def _identity_bn(features) -> Dict[str, np.ndarray]:
    return {"weight": np.ones(features, np.float32),
            "bias": np.zeros(features, np.float32),
            "running_mean": np.zeros(features, np.float32),
            "running_var": np.full(features, 1.0 - BN_EPS, np.float32)}


def fold_state_dict(state: Dict[str, np.ndarray],
                    architecture: str = "resnet101") -> Dict[str, np.ndarray]:
    """A new torch-layout state dict of float32 numpy arrays (conv weights
    [O, I, kh, kw]) with every conv/BN pair folded, as
    maskrcnn_tpu.checkpoint.fold.fold_bn_params folds a JAX tree. Pairs
    are found through the flax paths of `convert.name_map`."""
    torch_name = {fpath: tname for tname, fpath, _ in name_map(architecture)}
    out = dict(state)
    for tname, fpath, kind in name_map(architecture):
        parent, _, leaf = fpath.rpartition("/")
        bn_leaf = _bn_partner(leaf)
        if kind != "conv" or bn_leaf is None:
            continue
        bn_t = torch_name.get(f"{parent}/{bn_leaf}")
        if bn_t is None:
            continue
        bn = {f: np.asarray(out[f"{bn_t}.{f}"]) for f in _identity_bn(0)}
        scale = bn["weight"] / np.sqrt(bn["running_var"] + BN_EPS)
        offset = bn["bias"] - bn["running_mean"] * scale
        out[f"{tname}.weight"] = (np.asarray(out[f"{tname}.weight"])
                                  * scale[:, None, None, None])
        out[f"{tname}.bias"] = np.asarray(out[f"{tname}.bias"]) * scale + offset
        for f, v in _identity_bn(scale.shape).items():
            out[f"{bn_t}.{f}"] = v
    return out
