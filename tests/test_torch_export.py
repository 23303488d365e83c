"""The port's export (maskrcnn_tpu_torch/export.py) and the kernels'
custom ops (kernels/torch_ops.py) on the CPU: a program traced at
TinyConfig round-trips bit-identically, carries no weights, runs in a
process that imports torch and numpy only, and the .npz sidecar keeps
the JAX package's keys."""

import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from maskrcnn_tpu import export as jax_export
from maskrcnn_tpu.config import TinyConfig as JaxTinyConfig
from maskrcnn_tpu.models.mask_rcnn import MaskRCNN as JaxMaskRCNN
from maskrcnn_tpu_torch import export as ex
from maskrcnn_tpu_torch.config import TinyConfig
from maskrcnn_tpu_torch.detection.pipeline import predict_step
from maskrcnn_tpu_torch.kernels import torch_ops  # noqa: F401 (registers)
from maskrcnn_tpu_torch.models.mask_rcnn import MaskRCNN

# 16 proposals: the CPU's plain NMS unrolls a step a box into the
# program, and fewer steps trace, save and load faster
CFG = TinyConfig(DETECTION_MIN_CONFIDENCE=0.0, RPN_NMS_MAX_ROIS_NUM=16)
B = 2


@pytest.fixture(scope="module")
def program(tmp_path_factory):
    """A program traced on seed-0 weights, saved and loaded once, and the
    live outputs of other (seed-5) weights on two canvases."""
    traced = MaskRCNN(CFG, "cpu").init(torch.Generator().manual_seed(0))
    path = str(tmp_path_factory.mktemp("export") / "predict.pt2")
    ex.save_exported(traced, B, path)
    model = MaskRCNN(CFG, "cpu").init(torch.Generator().manual_seed(5))
    gen = torch.Generator().manual_seed(1)
    images = torch.randint(0, 256, (B, 128, 128, 3), generator=gen,
                           dtype=torch.uint8)
    windows = torch.tensor([[0.0, 0.0, 128.0, 128.0],
                            [16.0, 0.0, 112.0, 128.0]])
    with torch.no_grad():
        want = predict_step(model, images, windows)
    return model, path, images, windows, want, ex.load_exported(path)


def test_roundtrip_bit_identical(program):
    """The saved and loaded program fed weights other than the ones it
    was traced with gives the live model's outputs on them, bit for
    bit."""
    model, path, images, windows, want, call = program
    got = call(ex.model_params(model), images, windows)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        assert torch.equal(got[k], want[k]), k
    assert want["valid"].any()


def test_program_holds_no_weights(program):
    """The weights are the program's input: its state dict is empty and
    its constants (small tensors the trace lifted) are under 1% of the
    weights' bytes. A CPU trace holds no custom op."""
    model, ep = program[0], program[-1].program
    assert not ep.state_dict
    weights = sum(v.numel() * v.element_size()
                  for v in ex.model_params(model).values())
    consts = sum(v.numel() * v.element_size() for v in ep.constants.values())
    assert consts < 0.01 * weights
    targets = {str(n.target) for n in ep.graph.nodes
               if n.op == "call_function"}
    assert not any("mrt." in t for t in targets)


def test_npz_keys_are_the_jax_packages(tmp_path):
    """A JAX parameter tree through the port's params_to_npz: the JAX
    package's keys, values bit-equal, back to the same nested tree."""
    params = jax.eval_shape(JaxMaskRCNN(JaxTinyConfig()).init,
                            jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)
    tree = jax.tree_util.tree_map(
        lambda s: rng.randn(*s.shape).astype(np.float32), params)
    jax_export.params_to_npz(tree, str(tmp_path / "jax.npz"))
    ex.params_to_npz(tree, str(tmp_path / "port.npz"))
    with np.load(tmp_path / "jax.npz") as a, \
            np.load(tmp_path / "port.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
    back = ex.params_from_npz(str(tmp_path / "port.npz"))
    flat_back = jax.tree_util.tree_leaves_with_path(back)
    flat_tree = jax.tree_util.tree_leaves_with_path(tree)
    assert [p for p, _ in flat_back] == [p for p, _ in flat_tree]
    for (_, x), (_, y) in zip(flat_back, flat_tree):
        np.testing.assert_array_equal(x.numpy(), y)


def test_npz_roundtrip_state_dict_with_bf16(tmp_path):
    model = MaskRCNN(TinyConfig(COMPUTE_DTYPE="bfloat16"), "cpu").init(
        torch.Generator().manual_seed(0))
    state = ex.model_params(model)
    assert any(v.dtype == torch.bfloat16 for v in state.values())
    back = ex.params_from_npz(ex.params_to_npz(state,
                                               str(tmp_path / "w.npz")))
    assert sorted(back) == sorted(state)
    for k, v in state.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v), k


def test_clean_subprocess_runs_the_program(program, tmp_path):
    """A process that imports torch and numpy only (the port and the JAX
    package blocked from import) loads the program and the .npz weights
    and reproduces the live outputs bit for bit."""
    model, path, images, windows, want, _ = program
    params = ex.model_params(model)
    weights = ex.params_to_npz(params, str(tmp_path / "w.npz"))
    strides = {k: v.stride() for k, v in params.items()}
    np.savez(tmp_path / "inputs.npz", images=images.numpy(),
             windows=windows.numpy())
    script = textwrap.dedent(f"""
        import sys
        for blocked in ("maskrcnn_tpu", "maskrcnn_tpu_torch", "jax"):
            sys.modules[blocked] = None
        import numpy as np
        import torch
        # few threads: the process runs beside the other test workers
        torch.set_num_threads(2)
        with np.load({weights!r}) as z:
            params = {{k: torch.from_numpy(np.array(z[k])) for k in z.files}}
        # the port keeps conv weights channels_last, and the CPU conv's
        # sums follow the weights' strides: the live ones
        strides = {strides!r}
        params = {{k: torch.empty_strided(v.shape, strides[k],
                                         dtype=v.dtype).copy_(v)
                  for k, v in params.items()}}
        with np.load({str(tmp_path / "inputs.npz")!r}) as z:
            images = torch.from_numpy(z["images"])
            windows = torch.from_numpy(z["windows"])
        program = torch.export.load({path!r}).module()
        with torch.no_grad():
            out = program(params, images, windows)
        np.savez({str(tmp_path / "out.npz")!r},
                 **{{k: v.numpy() for k, v in out.items()}})
        loaded = sorted(m for m in sys.modules
                        if m.startswith("maskrcnn") and sys.modules[m])
        assert not loaded, loaded
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", script], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with np.load(tmp_path / "out.npz") as z:
        for k in want:
            np.testing.assert_array_equal(z[k], want[k].numpy())


def _meta_levels(dtype=torch.float32, requires_grad=False):
    return [torch.empty(2, s, s, 16, device="meta", dtype=dtype,
                        requires_grad=requires_grad) for s in (16, 8, 4, 2)]


def test_custom_op_shapes_on_meta():
    """Each op's fake implementation gives its kernel's output shape and
    dtype (what torch.export records for the card)."""
    boxes = torch.empty(6, 4, device="meta")
    out = torch.ops.mrt.roi_align(_meta_levels(), boxes, 7, 64, 64, [],
                                  torch.float32)
    assert out.shape == (6, 7, 7, 16) and out.dtype == torch.float32
    out = torch.ops.mrt.roi_align(_meta_levels(torch.int8), boxes, 14, 64,
                                  64, [0.1] * 4, torch.bfloat16)
    assert out.shape == (6, 14, 14, 16) and out.dtype == torch.bfloat16
    keep = torch.ops.mrt.nms(torch.empty(2, 9, 4, device="meta"),
                             torch.empty(2, 9, dtype=torch.bool,
                                         device="meta"), 0.5)
    assert keep.shape == (2, 9) and keep.dtype == torch.bool
    packed = torch.ops.mrt.paste_pack(
        torch.empty(5, 28, 28, device="meta"), torch.empty(5, 4,
                                                           device="meta"),
        torch.empty(5, dtype=torch.bool, device="meta"), 30, 41)
    assert packed.shape == (5, 30, 6) and packed.dtype == torch.uint8
    x = torch.empty(1, 5, 7, 64, device="meta", dtype=torch.bfloat16)
    y = torch.ops.mrt.bottleneck(x, *[torch.empty(1, device="meta")] * 6)
    assert y.shape == x.shape and y.dtype == x.dtype


def test_roi_align_op_gradient_is_the_backward_op():
    """register_autograd: the op's gradient for the levels comes from
    mrt::roi_align_backward, one a level, shaped as the levels; none for
    the boxes."""
    levels = _meta_levels(torch.bfloat16, requires_grad=True)
    boxes = torch.empty(6, 4, device="meta")
    out = torch.ops.mrt.roi_align(levels, boxes, 7, 64, 64, [],
                                  torch.bfloat16)
    grads = torch.autograd.grad(out, levels, torch.empty_like(out))
    assert [tuple(g.shape) for g in grads] == [tuple(f.shape)
                                               for f in levels]
    assert all(g.dtype == torch.bfloat16 for g in grads)


def test_torch_ops_module_imports_no_model_code():
    """The module a process running a card program imports pulls in torch
    and the ctypes bindings only."""
    script = ("import sys; import maskrcnn_tpu_torch.kernels.torch_ops; "
              "print(sorted(m for m in sys.modules "
              "if m.startswith('maskrcnn')))")
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=120, check=True).stdout
    assert eval(out) == ["maskrcnn_tpu_torch", "maskrcnn_tpu_torch.kernels",
                         "maskrcnn_tpu_torch.kernels.torch_ops"]
