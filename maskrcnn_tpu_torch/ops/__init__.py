"""Geometry and image ops of the port (counterpart of maskrcnn_tpu.ops).

Each module holds the plain PyTorch version of its op; `nms`,
`roi_align`, `bottleneck` and `mask_paste` also dispatch CUDA tensors to
their kernels, and `int8_conv` to the integer GEMM.
"""

import torch


def device_tensor(values, dtype: torch.dtype, device) -> torch.Tensor:
    """A small constant on `device` without a host sync: made on the CPU,
    then copied asynchronously. `torch.tensor(..., device="cuda")` copies
    synchronously, so the host would wait for every kernel queued before
    it and the card would idle while the host catches up."""
    return torch.tensor(values, dtype=dtype).to(device, non_blocking=True)
