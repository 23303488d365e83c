"""The port's grouped-RoIAlign skeleton (plain version of csrc/group_roi.cu)
against the Pallas gate benchmarks/gates/group_roi_gate.py, both of its
kernels (`kernel`, 2-D patches and a reshape; `kernel3d`, 3-D patches)
run through pl.pallas_call in interpret mode as the gate's `run` builds
them.

Importing the gate runs its four timed `run(...)` calls and sets JAX's
compilation cache, so its source is read with ast, those top-level
statements are dropped, and the rest is executed into a namespace whose
GROUPS and ITERS the test sets. The file itself is untouched."""

import ast
import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maskrcnn_tpu_torch import kernels
from maskrcnn_tpu_torch.ops import group_roi as port_gr

GATE = (Path(__file__).resolve().parent.parent / "benchmarks" / "gates"
        / "group_roi_gate.py")


def _is_dropped(node: ast.stmt) -> bool:
    """A top-level `run(...)` or `jax.config.update(...)` call."""
    if not (isinstance(node, ast.Expr) and isinstance(node.value, ast.Call)):
        return False
    fn = node.value.func
    return ((isinstance(fn, ast.Name) and fn.id == "run")
            or (isinstance(fn, ast.Attribute) and fn.attr == "update"))


@functools.lru_cache(maxsize=None)
def _gate_source():
    tree = ast.parse(GATE.read_text())
    kept = [n for n in tree.body if not _is_dropped(n)]
    assert len(kept) == len(tree.body) - 6  # four runs, two config updates
    tree.body = kept
    return compile(tree, str(GATE), "exec")


def _gate(n_groups: int):
    """The gate's namespace with GROUPS = n_groups, ITERS = 1."""
    ns = {"__name__": "group_roi_gate"}
    exec(_gate_source(), ns)
    ns["GROUPS"], ns["ITERS"] = n_groups, 1
    return ns


def _gate_out(ns, kern, patches: np.ndarray, dtype, cast: bool):
    """pl.pallas_call as the gate's `run` builds it, in interpret mode."""
    pl, pltpu = ns["pl"], ns["pltpu"]
    k, pool, c = ns["K"], ns["POOL"], ns["C"]
    shape = patches.shape
    f = pl.pallas_call(
        functools.partial(kern, cast_from_bf16=cast),
        in_specs=[pl.BlockSpec(shape, lambda: (0,) * len(shape))],
        out_specs=pl.BlockSpec((k, pool, pool, c), lambda: (0, 0, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((k, pool, pool, c), jnp.float32),
        scratch_shapes=[pltpu.VMEM((8, 128), jnp.float32)],
        interpret=True)
    return np.asarray(f(jnp.asarray(patches).astype(dtype)))


@pytest.mark.parametrize("n_groups", [1, 2, 3, 7])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["2d", "3d"])
def test_plain_matches_gate(layout, dtype, n_groups):
    """n_groups 1, 2, 3 and 7 move both i % 3 and i % 5. The products are
    of exact weights (0.25, 0.75, 0.5) against the same float32 values,
    summed with zeros in another order: equal to 1e-6."""
    ns = _gate(n_groups)
    rng = np.random.RandomState(n_groups)
    shape = ((128, 40 * 256) if layout == "2d" else (128, 40, 256))
    patches = rng.randn(*shape).astype(np.float32)
    kern = ns["kernel"] if layout == "2d" else ns["kernel3d"]
    want = _gate_out(ns, kern, patches, jnp.dtype(dtype),
                     dtype == "bfloat16")
    tp = torch.from_numpy(patches).to(getattr(torch, dtype))
    got = port_gr.group_roi(tp, n_groups).numpy()
    assert got.shape == want.shape == (4, 7, 7, 256)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert kernels.group_roi.launches == 0


def test_weights_match_the_gate_formula():
    """Each Wy row holds 0.25 then 0.75, each Wx row 0.5 twice, at the
    gate's columns."""
    for i in range(15):
        wy, wx = port_gr.group_weights(i)
        assert wy.shape == (28, 128) and wx.shape == (28, 40)
        assert torch.equal(wy.sum(1), torch.ones(28))
        assert torch.equal(wx.sum(1), torch.ones(28))
        for r in range(28):
            base = (r // 7) * 32 + (r % 7) * 2 + i % 3
            assert wy[r, base] == 0.25 and wy[r, base + 1] == 0.75
            xb = (r % 7) * 2 + i % 5
            assert wx[r, xb] == 0.5 and wx[r, xb + 1] == 0.5


def test_group_roi_rejects_bad_inputs():
    with pytest.raises(ValueError, match="128, 40, 256"):
        port_gr.group_roi(torch.zeros(128, 40, 128), 1)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        port_gr.group_roi(torch.zeros(128, 40, 256, dtype=torch.float16), 1)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.group_roi(torch.zeros(128, 40, 256), 1)
    with pytest.raises(ValueError, match="no implementation"):
        port_gr.group_roi(torch.zeros(128, 40, 256, device="meta"), 1)
    assert kernels.group_roi.launches == 0


@pytest.mark.parametrize("n_groups", [1, 3, 7])
@pytest.mark.parametrize("layout", ["2d", "3d"])
def test_einsum_yardstick_matches_plain(layout, n_groups):
    """chip_smoke.py times one torch.einsum over every group as K5's
    library time; it computes the plain version's result (exact weights,
    float32 sums of two nonzero terms in another order: 1e-6)."""
    rng = np.random.RandomState(30 + n_groups)
    shape = (128, 40 * 256) if layout == "2d" else (128, 40, 256)
    patches = torch.from_numpy(rng.randn(*shape).astype(np.float32))
    want = port_gr.group_roi_plain(patches, n_groups)
    got = port_gr.group_roi_einsum(patches, n_groups)
    assert got.shape == want.shape == (4, 7, 7, 256)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def _tf32(x: torch.Tensor, rounding: str) -> torch.Tensor:
    """float32 to TF32 (10 mantissa bits): clear the low 13 bits, or round
    them half away from zero as the kernel's cvt.rna.tf32.f32 does."""
    bits = x.view(torch.int32)
    if rounding == "nearest":
        bits = bits + 0x1000
    return (bits & ~0x1FFF).view(torch.float32)


@pytest.mark.parametrize("rounding", ["truncate", "nearest"])
def test_tf32_split_holds_the_bar(rounding):
    """The precision argument of K5's float32 path, in plain PyTorch: the
    first product as two TF32 products, of hi = tf32(p) and lo = tf32(p -
    hi) (Wy's 0.25 and 0.75 are exact in TF32), lands within 1e-5 of the
    output's range of the plain version; hi alone (one TF32 product)
    does not."""
    rng = np.random.RandomState(40)
    p = torch.from_numpy(rng.randn(128, 40 * 256).astype(np.float32))
    hi = _tf32(p, rounding)
    lo = _tf32(p - hi, rounding)
    assert torch.equal(_tf32(hi, rounding), hi)
    for n_groups in (1, 3):
        want = port_gr.group_roi_plain(p, n_groups)
        scale = float(want.abs().max())
        wy, wx = port_gr.group_weights(n_groups - 1)
        assert torch.equal(_tf32(wy, rounding), wy)
        outs = []
        for parts in ((hi, lo), (hi,)):
            t = sum(wy @ part for part in parts).reshape(28, 40, 256)
            outs.append(torch.stack([
                torch.einsum("ax,bxc->abc", wx[7 * k:7 * k + 7],
                             t[7 * k:7 * k + 7]) for k in range(4)]))
        split_err = float((outs[0] - want).abs().max())
        hi_err = float((outs[1] - want).abs().max())
        assert split_err <= 1e-5 * scale, split_err
        assert hi_err > 1e-5 * scale, hi_err
