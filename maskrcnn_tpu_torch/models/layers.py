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
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


class Conv2d(nn.Conv2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self._conv_forward(x, self.weight, None)
        return y if self.bias is None else y.add_(self.bias[:, None, None])


class ConvTranspose2d(nn.ConvTranspose2d):
    """Only the default output size (no `output_size` argument)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv_transpose2d(x, self.weight, None, self.stride,
                               self.padding, self.output_padding,
                               self.groups, self.dilation)
        return y if self.bias is None else y.add_(self.bias[:, None, None])


class Linear(nn.Linear):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.linear(x, self.weight)
        return y if self.bias is None else y.add_(self.bias)


def conv2d(x: torch.Tensor, weight: torch.Tensor,
           bias: torch.Tensor) -> torch.Tensor:
    """F.conv2d with the bias added after the product, as Conv2d."""
    return F.conv2d(x, weight).add_(bias[:, None, None])
