#!/usr/bin/env python3
"""Run chosen phases of chip_smoke.py on one NVIDIA GPU, for a short
check after a change (the full script is the port's gate):

    python3 tools/chip_phases.py [3] [7] [a] [b] [c] [d] [e] [m]

3: K1 against its plain version (the op check); 7: K1-bwd and the tiny
training step against the CPU; a-e: phase 8's server, RetinaNet, data
parallelism, export and profiler over the phase-5 Detector; m, on a
machine with more than one card: one nccl rank a card against one
process, and the multi-card Detector against the one-card one. No
arguments runs 3, 7 and a-e.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main(which) -> int:
    if not torch.cuda.is_available():
        print("chip_phases: no CUDA device", file=sys.stderr)
        return 1
    from maskrcnn_tpu_torch import kernels
    from maskrcnn_tpu_torch.ops import nms, roi_align as roi
    card = cs.card_info()
    print(card, flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    kernels.library()
    print(f"kernels ready in {time.perf_counter() - t0:.1f} s", flush=True)
    which = which or ["3", "7", "a", "b", "c", "d", "e"]
    if "3" in which:
        cs.roi_align_phase(kernels, roi)
    if "7" in which:
        cs.roi_backward_phase(kernels, roi)
        cs.train_parity_phase()
    det, images, _ = cs.slice_phase(kernels, cs.slice_config())
    if "a" in which:
        cs.reset_counts(kernels)
        cs.server_phase(det, kernels, card)
    if "b" in which:
        cs.reset_counts(kernels)
        cs.retina_phase(kernels, nms, card)
    if "c" in which:
        cs.dp_phase(card)
    if "d" in which:
        cs.reset_counts(kernels)
        cs.export_phase(det, kernels, card)
    if "e" in which:
        cs.profiler_phase(det, images)
    if "m" in which:
        cs.multi_gpu_phase(det, card)
    print("chip_phases: done", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
