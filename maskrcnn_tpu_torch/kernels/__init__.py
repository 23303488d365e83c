"""Build, load and launch the port's CUDA kernels (csrc/*.cu).

    roi_align.cu   multilevel RoIAlign, float  (Pallas ops/roi_align_pallas.py)
                   and int8 tables; and its
                   backward for the levels     (XLA scatter-add,
                   (K1-bwd)                     ops/roi_align.py:176)
    nms.cu         greedy NMS keep masks, any  (Pallas ops/nms_pallas.py)
                   N, one launch a call
    bottleneck.cu  fused identity bottleneck   (Pallas ops/bottleneck_pallas.py)
    paste_pack.cu  mask paste + threshold +    (Pallas benchmarks/gates/
                   valid + bit-pack             paste_pack_kernel.py)
    group_roi.cu   grouped RoIAlign skeleton,  (Pallas benchmarks/gates/
                   a cost study on no path;     group_roi_gate.py)
                   tensor-core products

The sources are compiled by `nvcc` on first use, one process a source,
all started together, and linked into one shared library with a plain C
interface, loaded with ctypes (no PyTorch headers, so a build takes
seconds). The library lives in `build/maskrcnn_tpu_torch/` at the
repository root, named by a hash of the sources and the flags, so a
changed source rebuilds and a checkout with no build directory builds
everything on its first kernel call.

Flags: sm_90a, -O3, and -fmad=false. Without the last, nvcc contracts
the IoU's `a_i + a_j - w*h`, the bilinear blends and the paste's
operator math into FMAs, which round differently from the plain PyTorch
versions and flip boundary decisions (suppressed or not, sampled or
extrapolated, a mask bit set or not). Never --use_fast_math.

Each wrapper checks its inputs, launches on PyTorch's current stream,
raises if the launch returned a CUDA error, and counts its launches in
its `launches` attribute. There is no fallback: a failed build or launch
raises. `torch_ops` registers K1-K4 as torch.library ops over these
wrappers, the route the port's CUDA path takes. This module imports
torch, ctypes and the standard library only.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Sequence

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
SOURCES = ("roi_align.cu", "nms.cu", "bottleneck.cu", "paste_pack.cu",
           "group_roi.cu")
BUILD_DIR = _PKG.parent / "build" / "maskrcnn_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-fmad=false", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the CUDA kernels cannot build")


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        digest.update(name.encode())
        digest.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libmaskrcnn_kernels_{digest.hexdigest()[:16]}.so"


def _run(procs) -> None:
    """Wait for every (command, process); raise on the first failure."""
    failed = []
    for cmd, proc in procs:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{stdout}{stderr}")
    if failed:
        raise RuntimeError("\n".join(failed))


def build() -> Path:
    """Compile the kernels unless the library for these sources exists:
    one nvcc process a source, started together, then one link. Writes
    into a temporary directory and renames, so concurrent builds never
    load a half-written file."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, name + ".o") for name in SOURCES]
        compiles = []
        for name, obj in zip(SOURCES, objs):
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(CSRC / name)]
            compiles.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        _run(compiles)
        lib = os.path.join(tmp, out.name)
        # -ldl: bottleneck.cu finds cuTensorMapEncodeTiled with dlsym
        cmd = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", lib, *objs, "-ldl"]
        _run([(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True))])
        os.replace(lib, out)
    return out


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    lib = ctypes.CDLL(str(build()))
    lib.mrt_roi_align.argtypes = [
        ctypes.POINTER(_P), ctypes.POINTER(_I), ctypes.POINTER(_I),
        ctypes.POINTER(ctypes.c_float), _P, _P, _I, _I, _I, _I, _I, _I,
        ctypes.c_float, ctypes.c_float, _P]
    lib.mrt_roi_align.restype = _I
    lib.mrt_roi_align_backward.argtypes = [
        ctypes.POINTER(_P), ctypes.POINTER(_I), ctypes.POINTER(_I), _P, _P,
        _I, _I, _I, _I, _I, ctypes.c_float, ctypes.c_float, _P,
        ctypes.c_longlong, _P, _P]
    lib.mrt_roi_align_backward.restype = _I
    lib.mrt_nms.argtypes = [_P, _P, _I, _I, ctypes.c_float, _P, _P, _P]
    lib.mrt_nms.restype = _I
    lib.mrt_nms_scratch_words.argtypes = [_I]
    lib.mrt_nms_scratch_words.restype = ctypes.c_longlong
    lib.mrt_nms_chain_probe.argtypes = [_P, _I, _P, _P, _P]
    lib.mrt_nms_chain_probe.restype = _I
    lib.mrt_bottleneck.argtypes = [_P] * 8 + [_I] * 6 + [_P]
    lib.mrt_bottleneck.restype = _I
    lib.mrt_paste_pack.argtypes = [_P] * 4 + [_I] * 4 + [_P]
    lib.mrt_paste_pack.restype = _I
    lib.mrt_group_roi.argtypes = [_P, _I, _I, _P, _P]
    lib.mrt_group_roi.restype = _I
    lib.mrt_error_string.argtypes = [_I]
    lib.mrt_error_string.restype = ctypes.c_char_p
    return lib


def _check_launch(lib: ctypes.CDLL, name: str, err: int) -> None:
    if err != 0:
        msg = lib.mrt_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error "
                           f"{err} ({msg})")


def _stream(device: torch.device) -> _P:
    return _P(torch.cuda.current_stream(device).cuda_stream)


_DTYPES = {torch.float32: (0, 4), torch.bfloat16: (1, 8)}
# RoIAlign tables: type code and channels a 16-byte load carries
_TABLES = {**_DTYPES, torch.int8: (2, 16)}


def level_divisor(image_shape) -> float:
    """224 / sqrt(image area) as the float32 the JAX package divides by (a
    numpy scalar canonicalised to float32 there): the FPN level rule's
    divisor, rounded to float32 by ctypes as numpy would."""
    area = float(image_shape[0]) * float(image_shape[1])
    return ctypes.c_float(224.0 / math.sqrt(area)).value


_BOXES = ("roi_align: boxes must be a contiguous [B*N, 4] float32 tensor on "
          "the levels' device")


def roi_align(levels: Sequence[torch.Tensor], boxes: torch.Tensor,
              pool_size: int, image_shape,
              level_scales: Sequence[float] = None,
              out_dtype: torch.dtype = None) -> torch.Tensor:
    """Multilevel RoIAlign kernel (csrc/roi_align.cu), its coordinate
    prologue (ops.roi_align.level_geometry) computed in the kernel.

    levels: P2..P5 as contiguous NHWC [B, H_l, W_l, C] CUDA tensors of
    one dtype (float32, bfloat16, or int8 with `level_scales`); boxes
    [B*N, 4] float32 contiguous on the levels' device, normalized (y1, x1,
    y2, x2), image-major; image_shape: the canvas (H, W, ...) that sets the
    FPN level rule. Returns [B*N, P, P, C] in the levels' dtype, or for
    int8 levels in `out_dtype` (float32 or bfloat16), each value the blend
    times its level's scale (four host floats). Allocates only the output.
    `launches` counts every launch, `int8_launches` those of the
    int8-table mode."""
    if (boxes.dtype != torch.float32 or boxes.dim() != 2
            or boxes.shape[1] != 4):
        raise ValueError(_BOXES)
    if pool_size < 1:
        raise ValueError(f"roi_align: pool size {pool_size} < 1")
    if len(levels) != 4:
        raise ValueError(f"roi_align takes 4 levels, got {len(levels)}")
    dtype = levels[0].dtype
    if dtype not in _TABLES:
        raise TypeError(f"roi_align: unsupported dtype {dtype}")
    code, vec = _TABLES[dtype]
    int8 = dtype == torch.int8
    if int8:
        if level_scales is None or len(level_scales) != 4:
            raise ValueError("roi_align: int8 levels need 4 level_scales")
        if out_dtype not in _DTYPES:
            raise TypeError("roi_align: int8 levels need out_dtype float32 "
                            f"or bfloat16, got {out_dtype}")
        scales = (ctypes.c_float * 4)(*[float(s) for s in level_scales])
    else:
        if level_scales is not None:
            raise ValueError("roi_align: level_scales apply to int8 levels "
                             "only")
        if out_dtype not in (None, dtype):
            raise TypeError(f"roi_align: {dtype} levels write {dtype}, not "
                            f"{out_dtype}")
        out_dtype, scales = dtype, None
    device = levels[0].device
    b, _, _, c = levels[0].shape
    for f in levels:
        if (not f.is_cuda or f.device != device or f.dtype != dtype
                or f.dim() != 4 or f.shape[0] != b or f.shape[3] != c
                or not f.is_contiguous() or f.data_ptr() % 16):
            raise ValueError("roi_align: levels must be contiguous, "
                             "16-byte aligned NHWC CUDA tensors of one "
                             "dtype, batch and channel count")
        if f.shape[1] * f.shape[2] * c >= 2 ** 31:
            raise ValueError(f"roi_align: a level image of {f.shape[1]}x"
                             f"{f.shape[2]}x{c} exceeds 32-bit offsets")
    if c % vec:
        raise ValueError(f"roi_align: channels {c} not a multiple of {vec}")
    m = boxes.shape[0]
    if (m != b * (m // max(b, 1)) or boxes.device != device
            or not boxes.is_contiguous()):
        raise ValueError(_BOXES)
    out = torch.empty((m, pool_size, pool_size, c), dtype=out_dtype,
                      device=device)
    if m == 0:
        return out
    lib = library()
    with torch.cuda.device(device):
        err = lib.mrt_roi_align(
            (_P * 4)(*[f.data_ptr() for f in levels]),
            (_I * 4)(*[f.shape[1] for f in levels]),
            (_I * 4)(*[f.shape[2] for f in levels]), scales,
            boxes.data_ptr(), out.data_ptr(), m, m // b, pool_size, c, code,
            _DTYPES[out_dtype][0], level_divisor(image_shape),
            float(pool_size - 1), _stream(device))
    _check_launch(lib, "roi_align", err)
    roi_align.launches += 1
    roi_align.int8_launches += int8
    return out


roi_align.launches = 0
roi_align.int8_launches = 0


def roi_align_backward(grad_out: torch.Tensor, boxes: torch.Tensor,
                       shapes: Sequence[tuple], dtype: torch.dtype,
                       pool_size: int, image_shape):
    """K1-bwd: the four level gradients, views of one buffer
    (`roi_align_backward_flat`'s), shaped as `shapes`."""
    flat = roi_align_backward_flat(grad_out, boxes, shapes, dtype, pool_size,
                                   image_shape)
    sizes = [s[0] * s[1] * s[2] * s[3] for s in shapes]
    return [t.view(s) for t, s in zip(torch.split(flat, sizes), shapes)]


def roi_align_backward_flat(grad_out: torch.Tensor, boxes: torch.Tensor,
                            shapes: Sequence[tuple], dtype: torch.dtype,
                            pool_size: int, image_shape) -> torch.Tensor:
    """K1-bwd (csrc/roi_align.cu), the gradient of `roi_align` for the
    levels, its prologue computed in the kernel as the forward's.

    grad_out [B*N, P, P, C] contiguous, 16-byte aligned CUDA tensor,
    float32 or bfloat16; boxes [B*N, 4] float32 contiguous on its device,
    as `roi_align` took them; shapes: the four levels' [B, H_l, W_l, C];
    dtype: the levels' dtype (float32 or bfloat16). Returns the four
    level gradients [B, H_l, W_l, C] in `dtype` flattened into one
    buffer, level after level: float32 sums of atomic adds in a scratch
    the wrapper allocates, rounded once to bf16 for bf16 levels.
    `roi_align_backward.launches` counts the calls (a call is a memset,
    the scatter and, for bf16, the rounding pass)."""
    if (boxes.dtype != torch.float32 or boxes.dim() != 2
            or boxes.shape[1] != 4 or not boxes.is_cuda
            or not boxes.is_contiguous()):
        raise ValueError("roi_align_backward: boxes must be a contiguous "
                         "[B*N, 4] float32 CUDA tensor")
    if grad_out.dtype not in _DTYPES or dtype not in _DTYPES:
        raise TypeError(f"roi_align_backward: unsupported dtypes "
                        f"{grad_out.dtype} -> {dtype}")
    if len(shapes) != 4:
        raise ValueError(f"roi_align_backward takes 4 levels, got "
                         f"{len(shapes)}")
    m = boxes.shape[0]
    b, _, _, c = shapes[0]
    if (tuple(grad_out.shape) != (m, pool_size, pool_size, c)
            or grad_out.device != boxes.device
            or not grad_out.is_contiguous() or grad_out.data_ptr() % 16):
        raise ValueError("roi_align_backward: grad_out must be a contiguous, "
                         "16-byte aligned [B*N, P, P, C] tensor on the "
                         "boxes' device")
    if any(len(s) != 4 or s[0] != b or s[3] != c for s in shapes):
        raise ValueError("roi_align_backward: levels of one batch and "
                         "channel count expected")
    if (b < 1 or c % 8 or m % b
            or any(s[1] * s[2] * c >= 2 ** 31 for s in shapes)):
        raise ValueError("roi_align_backward: B >= 1, C a multiple of 8, "
                         "boxes a whole number per image and a level image "
                         "within 32-bit offsets expected")
    device = boxes.device
    sizes = [s[0] * s[1] * s[2] * s[3] for s in shapes]
    scratch = torch.empty(sum(sizes), dtype=torch.float32, device=device)
    f32 = torch.split(scratch, sizes)
    out = (None if dtype == torch.float32 else
           torch.empty(sum(sizes), dtype=dtype, device=device))
    lib = library()
    with torch.cuda.device(device):
        err = lib.mrt_roi_align_backward(
            (_P * 4)(*[t.data_ptr() for t in f32]),
            (_I * 4)(*[s[1] for s in shapes]),
            (_I * 4)(*[s[2] for s in shapes]), boxes.data_ptr(),
            grad_out.data_ptr(), m, m // b, pool_size, c,
            _DTYPES[grad_out.dtype][0], level_divisor(image_shape),
            float(pool_size - 1), scratch.data_ptr(), scratch.numel(),
            None if out is None else out.data_ptr(), _stream(device))
    _check_launch(lib, "roi_align_backward", err)
    roi_align_backward.launches += 1
    return scratch if out is None else out


roi_align_backward.launches = 0


def nms(boxes: torch.Tensor, valid: torch.Tensor,
        iou_threshold: float) -> torch.Tensor:
    """Greedy NMS kernel (csrc/nms.cu), one launch for the batch, any N.

    boxes [B, N, 4] float32 score-descending, 16-byte aligned, valid
    [B, N] bool, both contiguous CUDA tensors. Returns keep [B, N] bool on
    the device. Above N = 1,320 an image's bitmask no longer fits the
    kernel's shared memory and goes through a device scratch of
    B * N * ceil(N/64) 64-bit words, allocated here."""
    if (not boxes.is_cuda or boxes.dtype != torch.float32 or boxes.dim() != 3
            or boxes.shape[2] != 4 or not boxes.is_contiguous()
            or boxes.data_ptr() % 16):
        raise ValueError("nms: boxes must be a contiguous, 16-byte aligned "
                         "[B, N, 4] float32 CUDA tensor")
    b, n = boxes.shape[:2]
    if (valid.dtype != torch.bool or valid.shape != (b, n)
            or valid.device != boxes.device or not valid.is_contiguous()):
        raise ValueError("nms: valid must be a contiguous [B, N] bool "
                         "tensor on the boxes' device")
    keep = torch.empty((b, n), dtype=torch.bool, device=boxes.device)
    if b == 0 or n == 0:
        return keep
    lib = library()
    per_image = lib.mrt_nms_scratch_words(n)
    scratch = (torch.empty(b * per_image, dtype=torch.int64,
                           device=boxes.device) if per_image else None)
    with torch.cuda.device(boxes.device):
        err = lib.mrt_nms(boxes.data_ptr(), valid.data_ptr(), b, n,
                          float(iou_threshold),
                          None if scratch is None else scratch.data_ptr(),
                          keep.data_ptr(), _stream(boxes.device))
    _check_launch(lib, "nms", err)
    nms.launches += 1
    return keep


nms.launches = 0


def _nms_chain_probe(blocks: int, device="cuda") -> float:
    """Cycles of one dependent step of K2's greedy chain (a 64-bit
    bit-test-and-OR), from one thread running `blocks` x 64 steps of the
    kernel's resolve loop (csrc/nms.cu). A measurement helper for
    chip_smoke's chain bound, not part of the port's API: it times the
    loop alone, not the kernel's step in place; waits for the card."""
    gen = torch.Generator().manual_seed(blocks)
    words = torch.randint(-2 ** 62, 2 ** 62, (65,), generator=gen,
                          dtype=torch.int64).to(device)
    out = torch.empty(2, dtype=torch.int64, device=device)
    lib = library()
    with torch.cuda.device(words.device):
        err = lib.mrt_nms_chain_probe(words.data_ptr(), int(blocks),
                                      out.data_ptr(), out[1:].data_ptr(),
                                      _stream(words.device))
    _check_launch(lib, "nms_chain_probe", err)
    return float(out[1].item()) / (blocks * 64)


def bottleneck(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
               w2: torch.Tensor, b2: torch.Tensor, w3: torch.Tensor,
               b3: torch.Tensor) -> torch.Tensor:
    """Fused identity bottleneck kernel (csrc/bottleneck.cu).

    x [B, H, W, C] contiguous NHWC CUDA tensor, float32 or bfloat16 (any
    H, W; bf16 needs P a multiple of 64 up to 256, or 384 or 512, the
    tiles that fit shared memory; others fail at the launch); w1
    [P, C], w2 [P, 9, P], w3 [C, P] contiguous in x's dtype; b1/b2 [P],
    b3 [C] float32 (as ops.bottleneck.pack_weights makes them). Returns y
    like x."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"bottleneck: unsupported dtype {x.dtype}")
    if (not x.is_cuda or x.dim() != 4 or not x.is_contiguous()
            or x.data_ptr() % 16):
        raise ValueError("bottleneck: x must be a contiguous, 16-byte "
                         "aligned NHWC CUDA tensor")
    b, h, w, c = x.shape
    p = w1.shape[0]
    if c != 4 * p:
        raise ValueError(f"bottleneck: C={c} is not 4P (P={p})")
    shapes = ((w1, (p, c), x.dtype), (b1, (p,), torch.float32),
              (w2, (p, 9, p), x.dtype), (b2, (p,), torch.float32),
              (w3, (c, p), x.dtype), (b3, (c,), torch.float32))
    for t, shape, dtype in shapes:
        if (tuple(t.shape) != shape or t.dtype != dtype
                or t.device != x.device or not t.is_contiguous()):
            raise ValueError("bottleneck: weights must be contiguous w1 "
                             "[P, C], w2 [P, 9, P], w3 [C, P] in x's dtype "
                             "and float32 biases on x's device")
    if x.dtype == torch.bfloat16 and p % 64:
        raise ValueError(f"bottleneck: bf16 needs P a multiple of 64, got "
                         f"P={p}")
    y = torch.empty_like(x)
    lib = library()
    with torch.cuda.device(x.device):
        err = lib.mrt_bottleneck(
            x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            b2.data_ptr(), w3.data_ptr(), b3.data_ptr(), y.data_ptr(), b, h,
            w, c, p, _DTYPES[x.dtype][0], _stream(x.device))
    _check_launch(lib, "bottleneck", err)
    bottleneck.launches += 1
    return y


bottleneck.launches = 0


# q, the quantised mask, is staged in the kernel's shared memory
_MAX_MASK_SIDE = 64


def paste_pack(masks: torch.Tensor, boxes: torch.Tensor, valid: torch.Tensor,
               height: int, width: int) -> torch.Tensor:
    """Fused paste + threshold + valid + bit-pack kernel
    (csrc/paste_pack.cu), one launch for all N detections.

    masks [N, m, m] float32, boxes [N, 4] float32 integral pixel coords,
    valid [N] bool, all contiguous on one CUDA device. Returns
    [N, height, ceil(width/8)] uint8 (np.unpackbits order)."""
    if (not masks.is_cuda or masks.dtype != torch.float32 or masks.dim() != 3
            or masks.shape[1] != masks.shape[2] or not masks.is_contiguous()):
        raise ValueError("paste_pack: masks must be a contiguous [N, m, m] "
                         "float32 CUDA tensor")
    n, m = masks.shape[:2]
    if not 1 <= m <= _MAX_MASK_SIDE:
        raise ValueError(f"paste_pack: mask side {m} outside "
                         f"[1, {_MAX_MASK_SIDE}]")
    if (boxes.dtype != torch.float32 or tuple(boxes.shape) != (n, 4)
            or valid.dtype != torch.bool or tuple(valid.shape) != (n,)
            or boxes.device != masks.device or valid.device != masks.device
            or not boxes.is_contiguous() or not valid.is_contiguous()):
        raise ValueError("paste_pack: boxes [N, 4] float32 and valid [N] "
                         "bool expected, contiguous on the masks' device")
    if height < 1 or width < 1:
        raise ValueError(f"paste_pack: canvas {height}x{width}")
    out = torch.empty((n, height, -(-width // 8)), dtype=torch.uint8,
                      device=masks.device)
    lib = library()
    with torch.cuda.device(masks.device):
        err = lib.mrt_paste_pack(masks.data_ptr(), boxes.data_ptr(),
                                 valid.data_ptr(), out.data_ptr(), n, m,
                                 height, width, _stream(masks.device))
    _check_launch(lib, "paste_pack", err)
    paste_pack.launches += 1
    return out


paste_pack.launches = 0


def group_roi(patches: torch.Tensor, n_groups: int) -> torch.Tensor:
    """Grouped RoIAlign skeleton kernel (csrc/group_roi.cu), the gate
    study of ops.group_roi: the first product on the tensor cores (bf16,
    or two TF32 products of a high and a low part for float32).

    patches [128, 40, 256] or [128, 10240] contiguous, 16-byte aligned
    CUDA tensor, float32 or bfloat16; n_groups >= 1. Returns the last
    group's [4, 7, 7, 256] float32 result."""
    from maskrcnn_tpu_torch.ops.group_roi import CHANNELS, K, POOL
    if patches.dtype not in _DTYPES:
        raise TypeError(f"group_roi: unsupported dtype {patches.dtype}")
    if (not patches.is_cuda or not patches.is_contiguous()
            or patches.data_ptr() % 16
            or tuple(patches.shape) not in ((128, 40, 256), (128, 10240))):
        raise ValueError("group_roi: patches must be a contiguous, 16-byte "
                         "aligned [128, 40, 256] or [128, 10240] CUDA "
                         "tensor")
    if n_groups < 1:
        raise ValueError(f"group_roi: n_groups {n_groups} < 1")
    out = torch.empty((K, POOL, POOL, CHANNELS), dtype=torch.float32,
                      device=patches.device)
    lib = library()
    with torch.cuda.device(patches.device):
        err = lib.mrt_group_roi(patches.data_ptr(),
                                _DTYPES[patches.dtype][0], int(n_groups),
                                out.data_ptr(), _stream(patches.device))
    _check_launch(lib, "group_roi", err)
    group_roi.launches += 1
    return out


group_roi.launches = 0
