"""Convolution and linear layers that add their bias after the product.

The JAX package's flax layers (nn.Conv, nn.Dense and its DeconvK2S2)
compute the product in the compute dtype and add the bias as a second
operation, so in bfloat16 a layer's output is rounded twice. PyTorch
fuses the bias where it can (MKLDNN on the CPU, cuBLAS's epilogue for a
linear on the card) and rounds once, which moves about a quarter of a
bf16 layer's outputs by an ulp (tests/test_torch_pipeline_bf16.py). These
subclasses keep the weights, names and state dict of torch.nn's and add
the bias in place after the product, in the output's dtype, on every
device (the quantized path's `quant.float_conv` does the same).

Training keeps float32 master weights, as flax keeps float32 params: a
layer whose `compute_dtype` is set (`set_compute_dtype`) casts its weight
and bias to that dtype in `forward`, so the product runs in the compute
dtype and the gradients land in float32.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


class _Cast:
    """Weight and bias in the compute dtype (`compute_dtype`, or the
    weights' own dtype when it is None)."""

    compute_dtype: Optional[torch.dtype] = None

    @property
    def act_dtype(self) -> torch.dtype:
        """The dtype the layer computes in."""
        return self.compute_dtype or self.weight.dtype

    def _weights(self):
        w, b = self.weight, self.bias
        if self.compute_dtype is not None:
            w = w.to(self.compute_dtype)
            b = None if b is None else b.to(self.compute_dtype)
        return w, b


def _add_bias(y: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
    # in place: no product saves its output for the backward pass
    return y if bias is None else y.add_(bias)


class Conv2d(_Cast, nn.Conv2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, b = self._weights()
        y = self._conv_forward(x, w, None)
        return _add_bias(y, None if b is None else b[:, None, None])


class ConvTranspose2d(_Cast, nn.ConvTranspose2d):
    """Only the default output size (no `output_size` argument)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, b = self._weights()
        y = F.conv_transpose2d(x, w, None, self.stride, self.padding,
                               self.output_padding, self.groups,
                               self.dilation)
        return _add_bias(y, None if b is None else b[:, None, None])


class Linear(_Cast, nn.Linear):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, b = self._weights()
        return _add_bias(F.linear(x, w), b)


def set_compute_dtype(module: nn.Module, dtype: torch.dtype) -> None:
    """Make every layer of `module` compute in `dtype` whatever its
    weights' dtype (the training construction's float32 master
    weights)."""
    for mod in module.modules():
        if isinstance(mod, _Cast):
            mod.compute_dtype = dtype


def conv2d(x: torch.Tensor, weight: torch.Tensor,
           bias: torch.Tensor) -> torch.Tensor:
    """F.conv2d with the bias added after the product, as Conv2d."""
    return _add_bias(F.conv2d(x, weight), bias[:, None, None])
