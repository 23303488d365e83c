#!/usr/bin/env python3
"""Run chosen phases of chip_smoke.py on one NVIDIA GPU, for a short
check after a change (the full script is the port's gate):

    python3 tools/chip_phases.py [3] [7] [a] [b] [c] [d] [e] [m] [l] [s] [f]
        [k] [w] [r] [i] [--gates-json FILE]

3: K1 against its plain version (the op check); 7: K1-bwd against the
CPU's plain version, the tiny training step against the CPU, and phase
7d's repeated runs (the same seeds give the same weights); a-e: phase
8's server, RetinaNet, data
parallelism, export and profiler over the phase-5 Detector; m, on a
machine with more than one card: one nccl rank a card against one
process, and the multi-card Detector against the one-card one; l: phase
9 (the image reader, the one-class, overfit and keypoint gates, the
full-width training and evaluation, the sweep from files), then the
learning gates phase 9 leaves out (multiclass and cascade: tools/learning_torch.py), their
record written to records_torch/learning_gates.json (or --gates-json);
r: l twice, each in a fresh process, both runs' AP and state digests
written to records_torch/learning_gates_deterministic.json; s: phase 10 (the
spatial axis on row shards of the one card, two gloo ranks sharing an
image's rows in phase 8c's ranks, the debug and tutorial scripts), with
m also the spatial axis on four cards (Detector groups, a dp=2 x sp=2
nccl step, B=1 latency, and each rank's training memory at sp = 1, 2
and 4 with REMAT_BACKBONE on and off and what holds its peak); f: the
tutorial's full run (tools/finetune_custom_torch.py, 3 epochs x 100
steps at B=4), its AP written to records_torch/finetune_custom.json; k:
the keypoint demo's full run (tools/keypoint_demo_torch.py, 240 steps,
output/keypoints_torch.png); w: the synthetic checkpoint's full run
(tools/train_synthetic_ckpt_torch.py, 240 steps at B=8, 1024²), then
explore_torch.py -model on it and explore_torch.ipynb's cells with it;
i: the image files alone, phases 9a (the native decoder against the
corpus's digests, its times beside the plain route's, the loader's
rates) and 9d (evaluate_coco from files at B=8, the serve POST). No
arguments runs 3, 7 and a-e.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


GATES_JSON = cs.REPO / "records_torch" / "learning_gates.json"


def main(argv) -> int:
    which = [a for a in argv if not a.startswith("--")]
    gates_json = GATES_JSON
    if "--gates-json" in argv:
        gates_json = argv[argv.index("--gates-json") + 1]
        which.remove(gates_json)
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
        cs.repeat_phase(card)
    if "i" in which:
        cs.decode_phase(card)
        cs.files_phase(kernels, card)
    if "l" in which:
        cs.decode_phase(card)
        cs.learning_phase(kernels, roi, card)
        cs.learning_full_phase(kernels, card)
        cs.files_phase(kernels, card)
        from tools import learning_torch
        if learning_torch.main(["multiclass", "cascade", "--json-out",
                                str(gates_json)]):
            return 1
    if "r" in which and not repeat_record(card):
        return 1
    if "f" in which:
        finetune_record(card)
    if "k" in which:
        from tools import keypoint_demo_torch
        if keypoint_demo_torch.main(["--device", "cuda"]):
            return 1
    if "w" in which:
        synthetic_weights()
    if not set(which) & set("abcdems"):
        print("chip_phases: done", flush=True)
        return 0
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
    if "s" in which:
        fdet = cs.slice_phase(kernels, cs.slice_config().replace(
            FOLD_BN=True), tag="5d")[0]
        qdet = cs.slice_phase(kernels, cs.slice_config().replace(
            QUANT_INT8=True), tag="5f")[0]
        f32, _ = cs.sp_inference_phase(kernels, det, fdet, qdet, card)
        del fdet, qdet
        if "c" not in which:
            # 10b runs in 8c's ranks
            cs.dp_phase(card)
        cs.surface_phase(kernels, f32, card)
        del f32
    if "m" in which:
        cs.multi_gpu_phase(det, card)
        cs.sp_multi_gpu_phase(det, card)
    print("chip_phases: done", flush=True)
    return 0


def repeat_record(card) -> bool:
    """`l` twice, each run in a fresh process (its gates' record to a file
    under build/), then both runs' multiclass and cascade AP and state
    digests, the card's name and power limit written to
    records_torch/learning_gates_deterministic.json, with whether the two
    runs are equal and which floors each missed (a missed floor is a
    result here, not a stop). Returns whether they are equal."""
    import json
    import subprocess
    runs = []
    for i in range(2):
        path = cs.REPO / "build" / f"learning_gates_run{i + 1}.json"
        path.unlink(missing_ok=True)
        subprocess.run([sys.executable, __file__, "l", "--gates-json",
                        str(path)])
        runs.append(json.loads(path.read_text()))
    record = {"tool": "tools/chip_phases.py l, twice, each in a fresh "
                      "process",
              "card": runs[0]["card"], "steps": runs[0]["steps"],
              "floors": runs[0]["floors"],
              "runs": [r["runs"][0] for r in runs]}
    record["equal"] = results(record["runs"][0]) == results(record["runs"][1])
    record["missed_floors"] = [r["missed_floors"][0] for r in runs]
    path = cs.REPO / "records_torch" / "learning_gates_deterministic.json"
    path.write_text(json.dumps(record, indent=1) + "\n")
    print(f"[r] two runs of l: AP and state digests equal "
          f"{record['equal']}; missed floors {record['missed_floors']}; "
          f"{card}", flush=True)
    return record["equal"]


def results(run) -> dict:
    """A gates run's results: each gate's AP and its trained state's
    digest (not its times)."""
    return {g: ({k: v for k, v in rec.items() if k != "train"},
                rec["train"]["state_sha256"]) for g, rec in run.items()}


def synthetic_weights() -> None:
    """tools/train_synthetic_ckpt_torch.py's full run on the card, then
    explore_torch.py -model on its weights (the detect stage of the demo
    scene) and explore_torch.ipynb's code cells with them."""
    from tools import train_synthetic_ckpt_torch as ts
    import explore_torch
    out = "models/synthetic_trained_torch.pth"
    t0 = time.perf_counter()
    if ts.main(["--device", "cuda", "--out", out]):
        raise RuntimeError("train_synthetic_ckpt_torch failed")
    print(f"[w] train_synthetic_ckpt_torch.py in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    explore_torch.main(["-model", out, "-stage", "detect", "-output",
                        "build/explore_synthetic.png", "--device", "cuda",
                        str(cs.REPO / "images" / "synthetic_scene.png")])
    seconds = cs.run_notebook(cs.REPO / "explore_torch.ipynb",
                              "[w] explore_torch.ipynb")
    print(f"[w] explore_torch.ipynb's code cells with the trained weights "
          f"in {seconds:.1f} s", flush=True)


def finetune_record(card) -> None:
    """The tutorial's full run on the card, its AP and the card written to
    records_torch/finetune_custom.json."""
    import json
    from tools import finetune_custom_torch as ft
    t0 = time.perf_counter()
    bbox, segm = ft.main(["--device", "cuda",
                          "--out", "build/finetune_custom.jpg"])
    record = {"tool": "tools/finetune_custom_torch.py",
              "args": "3 epochs x 100 steps, batch 4, lr 3e-3, 64 train "
                      "and 16 held-out images",
              "bbox_ap50": bbox, "segm_ap50": segm, "card": card,
              "device": torch.cuda.get_device_name(0),
              "seconds": time.perf_counter() - t0}
    path = cs.REPO / "records_torch" / "finetune_custom.json"
    path.write_text(json.dumps(record, indent=1) + "\n")
    print(f"[f] {json.dumps(record)}", flush=True)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
