"""Export of the detection pipeline as a program without weights
(counterpart of maskrcnn_tpu/export.py).

`export_predict` traces `fn(params, images, windows)`, `predict_step`
through `torch.func.functional_call`, with `torch.export`: the weights
are an input of the program, not part of it, so the program stays small
and the weights travel as a state dict or an .npz (`params_to_npz`).
`save_exported` / `load_exported` write and read the program
(`torch.export.save` / `load`). A program traced on the card calls the
kernels K1, K2 and K4 (K3 under FOLD_BN) as the custom ops of
`maskrcnn_tpu_torch.kernels.torch_ops`: loading it needs torch and that
module, no model code. A program traced on the CPU holds aten ops only
(the CPU runs the kernels' plain versions) and loads with torch alone.

The program is specialised to the model's config (canvas, dtype,
protocols) and to `batch_size`, like any ahead-of-time trace. Tensors
that are neither parameters nor buffers (FOLD_BN's packed bottleneck
weights, the QUANT_INT8 tree) enter the program as constants. The JAX
package's mesh variant has no counterpart: each rank loads the
one-device program.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

# npz keys of bfloat16 tensors (numpy has no bfloat16): their bits as int16
_BF16 = "@bfloat16"


def model_params(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The program's `params`: every parameter and buffer of the model by
    its state name, the non-persistent anchors included."""
    out = dict(model.named_parameters())
    out.update(model.named_buffers())
    return {k: v.detach() for k, v in out.items()}


class _Step(torch.nn.Module):
    """predict_step over the model it owns."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, images, windows):
        from maskrcnn_tpu_torch.detection.pipeline import predict_step
        return predict_step(self.model, images, windows)


class _Program(torch.nn.Module):
    """fn(params, images, windows): the step with `params` swapped in.
    The step sits outside this module's tree, so the trace captures none
    of its weights."""

    def __init__(self, model):
        super().__init__()
        self.__dict__["step"] = _Step(model)

    def forward(self, params, images, windows):
        return torch.func.functional_call(
            self.step, {f"model.{k}": v for k, v in params.items()},
            (images, windows), strict=True)


def export_predict(model, batch_size: int) -> torch.export.ExportedProgram:
    """Trace the predict pipeline of `model` (a MaskRCNN on its device) for
    `batch_size` canvases: the program of fn(params, images [B, H, W, 3]
    uint8, windows [B, 4] float32) -> predict_step's dict, `params` as
    `model_params` gives it."""
    h, w = model.config.IMAGE_SHAPE[:2]
    dev = model.anchor_boxes.device
    images = torch.zeros((batch_size, h, w, 3), dtype=torch.uint8,
                         device=dev)
    windows = torch.tensor([[0.0, 0.0, float(h), float(w)]] * batch_size,
                           dtype=torch.float32).to(dev)
    with torch.no_grad():
        return torch.export.export(
            _Program(model), (model_params(model), images, windows),
            strict=False)


def save_exported(model, batch_size: int, path: str) -> str:
    torch.export.save(export_predict(model, batch_size), path)
    return path


def load_exported(path):
    """A saved program -> callable(params, images, windows) -> the
    predict_step dict. Needs torch (and, for a program traced on the
    card, maskrcnn_tpu_torch.kernels.torch_ops imported first). The
    ExportedProgram is the callable's `program`."""
    exported = torch.export.load(path)
    module = exported.module()

    def call(params, images, windows):
        with torch.no_grad():
            return module(params, images, windows)

    call.program = exported
    return call


def params_to_npz(params, path: str) -> str:
    """A parameter tree (nested dicts, '/'-joined into keys as the JAX
    package's params_to_npz does) or a flat state dict, of tensors or
    arrays, into an .npz; bfloat16 tensors as their int16 bits under
    `key@bfloat16`."""
    flat = {}

    def walk(tree, prefix):
        for k in sorted(tree):
            v = tree[k]
            key = prefix + (str(k),)
            if isinstance(v, dict):
                walk(v, key)
                continue
            name = "/".join(key)
            if torch.is_tensor(v):
                v = v.detach().cpu()
                if v.dtype == torch.bfloat16:
                    flat[name + _BF16] = v.view(torch.int16).numpy()
                    continue
                v = v.numpy()
            flat[name] = np.asarray(v)

    walk(params, ())
    np.savez(path, **flat)
    return path


def params_from_npz(path: str, device="cpu") -> dict:
    """Inverse of params_to_npz: tensors on `device`, nested where the
    keys hold '/'."""
    out: dict = {}
    with np.load(path) as z:
        for key in z.files:
            arr = torch.from_numpy(np.array(z[key]))
            if key.endswith(_BF16):
                key = key[:-len(_BF16)]
                arr = arr.view(torch.bfloat16)
            node = out
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = arr.to(device)
    return out
