"""int8 convolution with its float32 dequantization epilogue (counterpart
of the int8 branch of maskrcnn_tpu.quant._Ctx.conv and of
`quantize_tensor`).

    xq = clip(round(float32(x) * (1 / sx)), -127, 127)      int8
    y32 = conv(xq, wq)                                      int32, exact
    y = (float32(y32) * (sx * sw) + bias).to(dtype)        then ReLU

NHWC activations as in the JAX package; kernels in the GEMM layout
[O, kh, kw, I] int8 (reshaped to [O, kh*kw*I] for free), per-output-
channel scales `sw` [O] and biases float32.

The integer product runs where the JAX package leaves it to XLA
(`lax.conv_general_dilated(..., preferred_element_type=int32)`), so on
CUDA it is a library integer GEMM, `torch._int_mm`:
* a 1x1 is a GEMM on [B*H*W, C]; a strided 1x1 slices [:, ::s, ::s] first;
* a 3x3 is an explicit int8 im2col (the nine shifted windows side by
  side, tap-major as the kernel's (kh, kw, I) order) and one GEMM.
`_int_mm` takes M > 16 and K, N multiples of 8. K or N off that grid
raises; M <= 16 (a 2x2 map at a small batch) gets zero rows appended,
which leaves the product's other rows as they are. Never a float conv.

On the CPU the plain version convolves in float64 and casts to int32:
exact, since |sum| <= 2304 * 127^2 < 2^53.

The epilogue computes `sx * sw` first, one float32 product of a scalar
and the [O] vector, then multiplies and adds as separate steps, so no
fused multiply-add changes the rounding.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# torch._int_mm: rows > 16, depth and columns multiples of 8
_MIN_ROWS = 17
_ALIGN = 8


def quantize_tensor(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Symmetric per-tensor int8: clip(round(float32(x) * (1 / scale)),
    -127, 127), `1 / scale` a float32 division on the tensor's device and
    `round` half to even. scale: 0-d float32 tensor."""
    y = x.to(torch.float32) * torch.reciprocal(scale)
    return torch.round_(y).clamp_(-127.0, 127.0).to(torch.int8)


def _out_size(n: int, k: int, stride: int, pad: int) -> int:
    return (n + 2 * pad - k) // stride + 1


def int8_conv_plain(xq: torch.Tensor, wq: torch.Tensor, stride: int = 1,
                    padding: int = 0) -> torch.Tensor:
    """Plain version: xq [B, H, W, I] int8, wq [O, kh, kw, I] int8 ->
    int32 [B, Ho, Wo, O], by a float64 convolution (exact)."""
    y = F.conv2d(xq.permute(0, 3, 1, 2).to(torch.float64),
                 wq.permute(0, 3, 1, 2).to(torch.float64), stride=stride,
                 padding=padding)
    return y.to(torch.int32).permute(0, 2, 3, 1).contiguous()


def _im2col(xq: torch.Tensor, kh: int, kw: int, stride: int,
            padding: int) -> torch.Tensor:
    """[B, H, W, I] int8 -> [B*Ho*Wo, kh*kw*I], columns in (ky, kx, i)
    order."""
    b, h, w, c = xq.shape
    ho = _out_size(h, kh, stride, padding)
    wo = _out_size(w, kw, stride, padding)
    if kh == kw == 1 and padding == 0:
        x = xq[:, ::stride, ::stride] if stride > 1 else xq
        return x.contiguous().reshape(b * ho * wo, c)
    xp = F.pad(xq, (0, 0, padding, padding, padding, padding))
    cols = [xp[:, ky:ky + stride * (ho - 1) + 1:stride,
               kx:kx + stride * (wo - 1) + 1:stride]
            for ky in range(kh) for kx in range(kw)]
    return torch.cat(cols, dim=-1).reshape(b * ho * wo, kh * kw * c)


def int8_conv_gemm(xq: torch.Tensor, wq: torch.Tensor, stride: int = 1,
                   padding: int = 0) -> torch.Tensor:
    """The CUDA route: im2col and torch._int_mm. Shapes as
    `int8_conv_plain`; `calls` counts the GEMMs."""
    b, h, w, _ = xq.shape
    o, kh, kw, _ = wq.shape
    a = _im2col(xq, kh, kw, stride, padding)
    m, k = a.shape
    if k % _ALIGN or o % _ALIGN:
        raise ValueError(f"int8_conv: depth {k} and {o} output channels "
                         f"must be multiples of {_ALIGN} for torch._int_mm")
    if m < _MIN_ROWS:
        a = torch.cat([a, a.new_zeros(_MIN_ROWS - m, k)])
    y = torch._int_mm(a, wq.reshape(o, k).t())[:m]
    int8_conv_gemm.calls += 1
    return y.reshape(b, _out_size(h, kh, stride, padding),
                     _out_size(w, kw, stride, padding), o)


int8_conv_gemm.calls = 0


def int8_conv(xq: torch.Tensor, wq: torch.Tensor, stride: int = 1,
              padding: int = 0) -> torch.Tensor:
    """Device dispatch: the integer GEMM for CUDA tensors, the plain
    float64 convolution for CPU tensors."""
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise TypeError(f"int8_conv: int8 operands expected, got {xq.dtype} "
                        f"and {wq.dtype}")
    if xq.is_cuda:
        return int8_conv_gemm(xq, wq, stride, padding)
    if xq.device.type == "cpu":
        return int8_conv_plain(xq, wq, stride, padding)
    raise ValueError(f"int8_conv: no implementation for device {xq.device}")


def dequantize(y32: torch.Tensor, x_scale: torch.Tensor,
               w_scale: torch.Tensor, bias: torch.Tensor,
               dtype: torch.dtype, relu: bool = False) -> torch.Tensor:
    """The epilogue: (float32(y32) * (x_scale * w_scale) + bias) in the
    compute dtype, then ReLU. x_scale 0-d, w_scale and bias [O], all
    float32."""
    y = y32.to(torch.float32) * (x_scale * w_scale)
    y = (y + bias).to(dtype)
    return torch.relu_(y) if relu else y
