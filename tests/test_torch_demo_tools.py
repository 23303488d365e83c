"""The port's demo scripts: tools/keypoint_demo_torch.py and its numpy
drawing, tools/train_synthetic_ckpt_torch.py's demo-scene check, and
tools/build_notebook_torch.py's notebook (explore_torch.ipynb)."""

import json
from pathlib import Path

import numpy as np

from maskrcnn_tpu_torch.data.image_io import read_image, write_png
from maskrcnn_tpu_torch.utils.visualize import render_instances
from tools import build_notebook_torch, keypoint_demo_torch
from tools import train_synthetic_ckpt_torch

REPO = Path(__file__).resolve().parent.parent


def test_render_draws_box_and_dot():
    """render_instances outlines a box on its inside edge in its colour,
    draws a keypoint dot ringed in white, blends a mask, and leaves the
    rest of the image and the input untouched."""
    image = np.full((24, 32, 3), 30, np.uint8)
    mask = np.zeros((1, 24, 32), np.uint8)
    mask[0, 4:8, 5:9] = 1
    out = render_instances(image, [[2, 3, 12, 14]], mask, [[[18, 24, 1.0]]],
                           colors=[(1.0, 0.0, 0.0)])
    red = [255, 0, 0]
    assert (out[2, 3:14] == red).all() and (out[11, 3:14] == red).all()
    assert (out[2:12, 3] == red).all() and (out[2:12, 13] == red).all()
    assert (out[18, 24] == red).all() and (out[18, 23] == red).all()
    assert (out[18, 22] == 255).all() and (out[16, 24] == 255).all()
    assert (out[5, 6] == [142, 15, 15]).all()        # 30 * 0.5 + 255 * 0.5
    assert (out[12:, :20] == 30).all() and (out[:, 16:20] == 30).all()
    assert (image == 30).all()


def test_keypoint_demo_writes_png(tmp_path):
    """keypoint_demo_torch on the CPU, one step: it detects on the
    held-out scene, prints its counts and writes a PNG that read_image
    decodes to the 64 px canvas."""
    out = tmp_path / "keypoints.png"
    assert keypoint_demo_torch.main(["--steps", "1", "--device", "cpu",
                                     "--out", str(out)]) == 0
    assert read_image(out).shape == (64, 64, 3)


def test_synthetic_scene_check(tmp_path):
    """images/synthetic_scene.png is multiclass_scene(RandomState(501),
    1024) pixel for pixel (train_synthetic_ckpt_torch checks it in place
    of rewriting the JAX tool's file); one pixel changed fails."""
    assert train_synthetic_ckpt_torch.scene_matches()
    img = read_image(REPO / "images" / "synthetic_scene.png")
    img[0, 0] ^= 1
    write_png(tmp_path / "scene.png", img)
    assert not train_synthetic_ckpt_torch.scene_matches(tmp_path / "scene.png")


def test_notebook_is_v4_json_that_compiles():
    """build_notebook_torch writes nbformat 4 JSON with the JAX
    notebook's sections, no outputs, code cells that compile; the
    committed explore_torch.ipynb is what it builds."""
    nb = build_notebook_torch.notebook()
    assert nb["nbformat"] == 4 and nb["nbformat_minor"] >= 4
    assert json.loads(json.dumps(nb)) == nb
    jax_nb = json.loads((REPO / "explore.ipynb").read_text())
    assert len(nb["cells"]) == len(jax_nb["cells"])
    assert [c["cell_type"] for c in nb["cells"]] == [
        c["cell_type"] for c in jax_nb["cells"]]
    code = [c for c in nb["cells"] if c["cell_type"] == "code"]
    assert all(c["outputs"] == [] and c["execution_count"] is None
               for c in code)
    for i, src in enumerate(build_notebook_torch.code_cells()):
        compile(src, f"explore_torch.ipynb cell {i}", "exec")
    committed = json.loads((REPO / "explore_torch.ipynb").read_text())
    assert committed == nb
