"""The port's fused identity bottleneck (plain version of csrc/bottleneck.cu)
against the JAX package: the Pallas kernel run in interpret mode, the
flax Bottleneck(fold_bn=True), and the port's folded Bottleneck module."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import maskrcnn_tpu.ops.bottleneck_pallas as bp
from maskrcnn_tpu.models.resnet import Bottleneck as JaxBottleneck
from maskrcnn_tpu_torch.models.resnet import Bottleneck
from maskrcnn_tpu_torch.ops import bottleneck as port_bn


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(
        bp.pl, "pallas_call",
        functools.partial(bp.pl.pallas_call, interpret=True))


def _case(rng, b, h, w, c, p):
    """x and JAX-layout folded weights; biases nonzero so the halo trap
    (relu(b1) instead of zero outside the image) would show."""
    x = rng.randn(b, h, w, c).astype(np.float32)
    w1 = (rng.randn(c, p) / np.sqrt(c)).astype(np.float32)
    w2 = (rng.randn(3, 3, p, p) / np.sqrt(9 * p)).astype(np.float32)
    w3 = (rng.randn(p, c) / np.sqrt(p)).astype(np.float32)
    b1, b2 = (rng.randn(2, p) * 0.5).astype(np.float32)
    b3 = (rng.randn(c) * 0.5).astype(np.float32)
    return x, (w1, b1, w2, b2, w3, b3)


def _port(x, weights, dtype):
    """The plain version on torch tensors, JAX-layout weights repacked
    K-major as ops.bottleneck.pack_weights does: w1 [P, C], w2 [P, 9, P]
    (out, tap, in), w3 [C, P] in x's dtype, biases float32."""
    w1, b1, w2, b2, w3, b3 = (np.asarray(a) for a in weights)
    p = w1.shape[1]
    t = [torch.tensor(np.ascontiguousarray(a))
         for a in (w1.T, b1, w2.reshape(9, p, p).transpose(2, 0, 1), b2,
                   w3.T, b3)]
    t = [a.to(dtype) if i % 2 == 0 else a for i, a in enumerate(t)]
    return port_bn.fused_identity_bottleneck(
        torch.from_numpy(x).to(dtype), *t).to(torch.float32).numpy()


def _bf16_ulps(got, want):
    """|got - want| in units of the bf16 spacing at the larger of the two
    magnitudes (0 where both are 0)."""
    big = np.maximum(np.abs(got), np.abs(want)).astype(np.float32)
    _, exp = np.frexp(big)
    ulp = np.ldexp(np.float32(1.0), exp - 8)
    return np.where(big == 0, 0.0, np.abs(got - want) / ulp)


SHAPES = [(2, 24, 16, 64, 16), (1, 16, 24, 128, 32)]


@pytest.mark.parametrize("shape", SHAPES, ids=["C64P16", "C128P32"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_interpret(shape, dtype):
    """float32: both accumulate in float32 in another order, so 1e-5.
    bfloat16: the same rounding points (h1, h2, output); a float32 sum in
    another order can still land an intermediate on the other side of a
    bf16 rounding boundary and carry one bf16 ulp into the output, so at
    most 2 bf16 ulp except a share of 0.5% of the outputs (measured on
    the CPU: 0 ulp everywhere)."""
    rng = np.random.RandomState(sum(shape))
    x, weights = _case(rng, *shape)
    jdtype = jnp.dtype(dtype)
    want = np.asarray(bp.fused_identity_bottleneck(
        jnp.asarray(x).astype(jdtype), *map(jnp.asarray, weights),
        th=8)).astype(np.float32)
    got = _port(x, weights, getattr(torch, dtype))
    assert got.shape == want.shape == x.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        ulps = _bf16_ulps(got, want)
        assert (ulps > 2).mean() <= 5e-3, (ulps > 2).mean()


def test_halo_is_zero_not_relu_b1():
    """A zero image with a large positive b1: inside the image h1 is
    relu(b1) everywhere, but the 3x3 must see zeros beyond the border,
    so border outputs differ from interior ones (as in the Pallas
    kernel)."""
    rng = np.random.RandomState(3)
    x, (w1, b1, w2, b2, w3, b3) = _case(rng, 1, 8, 8, 64, 16)
    x[:] = 0.0
    b1 = np.abs(b1) + 1.0
    weights = (w1, b1, w2, b2, w3, b3)
    want = np.asarray(bp.fused_identity_bottleneck(
        jnp.asarray(x), *map(jnp.asarray, weights), th=8))
    got = _port(x, weights, torch.float32)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert not np.allclose(got[0, 0, 0], got[0, 4, 4])
    np.testing.assert_allclose(got[0, 3, 3], got[0, 4, 4], rtol=1e-6)


def _flax_block(rng, b, h, w, p):
    """flax Bottleneck(fold_bn=True) params with nonzero biases, and x."""
    c = 4 * p
    x = rng.randn(b, h, w, c).astype(np.float32)
    block = JaxBottleneck(p, fold_bn=True)
    params = jax.device_get(block.init(jax.random.PRNGKey(0),
                                       jnp.asarray(x))["params"])
    for i in (1, 2, 3):
        params[f"conv{i}"]["bias"] = (rng.randn(*params[f"conv{i}"]["bias"]
                                                .shape) * 0.3).astype(
                                                    np.float32)
    return block, params, x


@pytest.mark.parametrize("hw", [(4, 4), (7, 5)], ids=["4x4", "7x5"])
def test_plain_matches_flax_folded_block(hw):
    """At sizes the Pallas entry point cannot take (H % th != 0). float32
    throughout: the flax block rounds nothing either, so 1e-5."""
    rng = np.random.RandomState(hw[0] * 10 + hw[1])
    block, params, x = _flax_block(rng, 2, *hw, 16)
    want = np.asarray(block.apply({"params": params}, jnp.asarray(x)))
    p = 16
    weights = (params["conv1"]["kernel"].reshape(4 * p, p),
               params["conv1"]["bias"], params["conv2"]["kernel"],
               params["conv2"]["bias"],
               params["conv3"]["kernel"].reshape(p, 4 * p),
               params["conv3"]["bias"])
    got = _port(x, weights, torch.float32)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_port_folded_module_matches_flax():
    """The port's folded identity Bottleneck (weights packed once from
    the loaded state) against flax Bottleneck(fold_bn=True)."""
    rng = np.random.RandomState(11)
    block, params, x = _flax_block(rng, 2, 9, 6, 16)
    want = np.asarray(block.apply({"params": params}, jnp.asarray(x)))
    state = {}
    for i in (1, 2, 3):
        state[f"conv{i}.weight"] = torch.from_numpy(
            np.asarray(params[f"conv{i}"]["kernel"]).transpose(3, 2, 0, 1)
            .copy())
        state[f"conv{i}.bias"] = torch.from_numpy(
            np.asarray(params[f"conv{i}"]["bias"]))
        for f in ("weight", "bias", "running_mean", "running_var"):
            state[f"bn{i}.{f}"] = torch.from_numpy(
                np.asarray(params[f"bn{i}"][f]))
    module = Bottleneck(64, 16, fold_bn=True)
    module.load_state_dict(state)
    module.pack(state, "")
    assert module.fused and len(module.packed) == 6
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)
    with torch.inference_mode():
        got = module(xt).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
