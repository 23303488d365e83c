"""Geometry and image ops of the port (counterpart of maskrcnn_tpu.ops).

Each module holds the plain PyTorch version of its op; `nms`,
`roi_align`, `bottleneck` and `mask_paste` also dispatch CUDA tensors to
their kernels, and `int8_conv` to the integer GEMM.
"""

import contextlib

import torch


def device_tensor(values, dtype: torch.dtype, device) -> torch.Tensor:
    """A small constant on `device` without a host sync: made on the CPU,
    then copied asynchronously. `torch.tensor(..., device="cuda")` copies
    synchronously, so the host would wait for every kernel queued before
    it and the card would idle while the host catches up."""
    return torch.tensor(values, dtype=dtype).to(device, non_blocking=True)


@contextlib.contextmanager
def ieee_float32():
    """float32 matmuls in IEEE float32 inside the block, whatever the
    caller's precision setting (TF32 on the card, bf16 passes on a CPU
    with AMX), restored after. For products whose result is rounded to
    an integer (the device resample's uint8, the TTA fusion's boxes):
    TF32's 10-bit mantissa would move those roundings."""
    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(saved)
