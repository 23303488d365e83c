"""Profiling and throughput instrumentation (counterpart of
maskrcnn_tpu/utils/profiler.py).

`trace` records a torch.profiler trace (host ops and, on the card, CUDA
kernels through CUPTI) and writes it as a Chrome trace; `StageTimer` and
`Throughput` are the JAX package's host-clock meters, with the same
reports. The JAX module's `enable_compile_cache` has no counterpart:
eager PyTorch compiles nothing, and the kernel library is already cached
on disk by `kernels.library_path()`.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict


@contextlib.contextmanager
def trace(log_dir: str, name: str = "trace"):
    """Profile the block; write `log_dir/<name>.json` (a Chrome trace,
    viewable in chrome://tracing or Perfetto). Yields the profiler, so a
    caller can read `key_averages()` after the block. CUDA activity is
    recorded when a card is present."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.__enter__()
    try:
        yield prof
    finally:
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(log_dir, f"{name}.json"))


class StageTimer:
    """Accumulating per-stage wall-clock timer."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=lambda n: -self.totals[n]):
            t = self.totals[name]
            c = self.counts[name]
            lines.append(f"{name:24s} total {t:8.3f}s  calls {c:5d}"
                         f"  avg {1e3 * t / c:8.2f}ms")
        return "\n".join(lines)


class Throughput:
    """images/sec meter (the reference's published metric,
    coco.py:133-135)."""

    def __init__(self):
        self.images = 0
        self.seconds = 0.0

    @contextlib.contextmanager
    def measure(self, n_images: int):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds += time.perf_counter() - t0
            self.images += n_images

    @property
    def images_per_sec(self) -> float:
        return self.images / self.seconds if self.seconds else 0.0
