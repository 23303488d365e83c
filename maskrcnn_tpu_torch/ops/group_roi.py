"""Grouped (K=4) RoIAlign compute skeleton (counterpart of the Pallas gate
benchmarks/gates/group_roi_gate.py, `kernel` and `kernel3d`).

A cost study on no serving path: the gate asked whether RoIAlign done
as two dense matrix products over a group of K=4 boxes beats a per-box
kernel. For each group i of `n_groups`:

    Wy [28, 128]: 0.25 at column base, 0.75 at base+1,
                  base = (r // 7) * 32 + (r % 7) * 2 + i % 3
    Wx [28, 40]:  0.5 at columns xb and xb+1, xb = (q % 7) * 2 + i % 5
    T = Wy @ patches               [28, 40, C], float32 sums
    out[k, a, b, c] = sum_x Wx[7k+a, x] * T[7k+b, x, c]

(out[k] is the diagonal 7x7 block k of the gate's `cell`). The gate
overwrites its output every group, so the result is group n-1's.

patches: [K*PATCH, PX, C] = [128, 40, 256], or [128, 40*256] (the gate's
2-D layout, the same bytes), float32 or bfloat16; bfloat16 is cast to
float32 first, as the gate's `cast_from_bf16` variant does. The output is
[4, 7, 7, C] float32.
"""

from __future__ import annotations

import torch

K, POOL, PATCH, PX, CHANNELS = 4, 7, 32, 40, 256
# the gate's GROUPS * ITERS: 125 groups of 4 boxes, 20 times
N_GROUPS = 125 * 20


def group_weights(i: int, device=None):
    """The gate's dense weights of group i: (Wy [28, 128], Wx [28, 40])
    float32."""
    kq, kr = K * POOL, K * PATCH
    r = torch.arange(kq, device=device)[:, None]
    y = torch.arange(kr, device=device)[None, :]
    base = (r // POOL) * PATCH + (r % POOL) * 2 + i % 3
    wy = ((y == base).float() * 0.25 + (y == base + 1).float() * 0.75)
    x = torch.arange(PX, device=device)[None, :]
    xb = (r % POOL) * 2 + i % 5
    wx = (x == xb).float() * 0.5 + (x == xb + 1).float() * 0.5
    return wy, wx


def _patches3d(patches: torch.Tensor) -> torch.Tensor:
    if patches.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"group_roi: float32 or bfloat16 patches, got "
                        f"{patches.dtype}")
    if tuple(patches.shape) not in ((K * PATCH, PX, CHANNELS),
                                    (K * PATCH, PX * CHANNELS)):
        raise ValueError(f"group_roi: patches [128, 40, 256] or [128, "
                         f"10240] expected, got {tuple(patches.shape)}")
    return patches.reshape(K * PATCH, PX, CHANNELS)


def group_roi_plain(patches: torch.Tensor,
                    n_groups: int = N_GROUPS) -> torch.Tensor:
    """Plain PyTorch version: the gate's two dense products for every
    group, the last group's diagonal blocks returned."""
    if n_groups < 1:
        raise ValueError(f"group_roi: n_groups {n_groups} < 1")
    p = _patches3d(patches).to(torch.float32)
    p2d = p.reshape(K * PATCH, PX * CHANNELS)
    out = None
    for i in range(n_groups):
        wy, wx = group_weights(i, p.device)
        t = (wy @ p2d).reshape(K * POOL, PX, CHANNELS)
        out = torch.stack([
            torch.einsum("ax,bxc->abc", wx[k * POOL:(k + 1) * POOL],
                         t[k * POOL:(k + 1) * POOL]) for k in range(K)])
    return out


def group_roi_einsum(patches: torch.Tensor,
                     n_groups: int = N_GROUPS) -> torch.Tensor:
    """The yardstick: one torch.einsum over every group's weights (in the
    patches' dtype, whose values hold 0.25, 0.5 and 0.75 exactly), the
    last group's [4, 7, 7, C] as float32. It computes what the gate's two
    dense products compute; chip_smoke.py times it beside the kernel,
    and nothing else calls it."""
    p = _patches3d(patches)
    # row 7k+a of group i's Wy and Wx as [i, k, a]
    wy, wx = (torch.stack(w).reshape(n_groups, K, POOL, -1).to(p.dtype)
              for w in zip(*(group_weights(i, p.device)
                             for i in range(n_groups))))
    out = torch.einsum("gkax,gkby,yxc->gkabc", wx, wy, p)
    return out[-1].to(torch.float32)


def group_roi(patches: torch.Tensor, n_groups: int = N_GROUPS
              ) -> torch.Tensor:
    """Device dispatch: the CUDA kernel (csrc/group_roi.cu) for CUDA
    tensors, the plain version for CPU tensors."""
    if patches.is_cuda:
        from maskrcnn_tpu_torch import kernels
        return kernels.group_roi(patches.contiguous(), n_groups)
    if patches.device.type == "cpu":
        return group_roi_plain(patches, n_groups)
    raise ValueError(f"group_roi: no implementation for device "
                     f"{patches.device}")
