"""The port's paste-and-pack (plain version of csrc/paste_pack.cu) against
the Pallas kernel benchmarks/gates/paste_pack_kernel.py in interpret mode,
imported by path (the gate is not a package)."""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maskrcnn_tpu_torch.ops import mask_paste as port_paste

GATE = (Path(__file__).resolve().parent.parent / "benchmarks" / "gates"
        / "paste_pack_kernel.py")

# A pasted pixel is a sum of float32 products compared with 127.5; sums
# in another order (or with a fused multiply-add) may put a pixel whose
# exact value lies within an ulp of the threshold on either side
# (ROADMAP Queue 3). Every other bit must agree.
TIE = 2 * float(np.spacing(np.float32(127.5)))


@pytest.fixture(scope="module")
def gate():
    spec = importlib.util.spec_from_file_location("paste_pack_kernel", GATE)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _case(rng, n, h, w):
    """Random boxes plus the edge cases: the full canvas, zero-size, one
    pixel, a box past the bottom-right corner, a box touching the right
    edge; about 30% invalid."""
    masks = rng.rand(n, 28, 28).astype(np.float32)
    y1 = rng.randint(0, h - 4, n)
    x1 = rng.randint(0, w - 4, n)
    boxes = np.stack([y1, x1, np.minimum(h, y1 + rng.randint(1, h // 2, n)),
                      np.minimum(w, x1 + rng.randint(1, w // 2, n))], 1)
    boxes = boxes.astype(np.float32)
    boxes[0] = [0, 0, h, w]
    boxes[1] = [10, 12, 10, 12]
    boxes[2] = [5, 7, 6, 8]
    boxes[3] = [h - 9, w - 13, h + 20, w + 20]
    boxes[5] = [h // 3, w - 17, h // 3 + 20, w]
    valid = rng.rand(n) > 0.3
    valid[:4] = True
    valid[4] = False
    valid[5] = True
    return masks, boxes, valid


def _exact(masks, boxes, h, w):
    """The pasted values in float64 from the (bit-equal) operators."""
    t = torch.from_numpy
    ops = [port_paste._interp_operator(t(boxes[:, a]),
                                       t(boxes[:, b] - boxes[:, a]), dim,
                                       28).numpy().astype(np.float64)
           for a, b, dim in ((0, 2, h), (1, 3, w))]
    q = np.floor(np.clip(masks * np.float32(255.0), 0, 255)).astype(
        np.float64)
    return np.einsum("nym,nmj,nxj->nyx", ops[0], q, ops[1])


@pytest.mark.parametrize("hw", [(64, 128), (96, 256)], ids=["W128", "W256"])
def test_paste_pack_matches_pallas_interpret(gate, hw):
    h, w = hw
    rng = np.random.RandomState(w)
    masks, boxes, valid = _case(rng, 16, h, w)
    want = np.asarray(gate.paste_masks_packed_pallas(
        jnp.asarray(masks), jnp.asarray(boxes), jnp.asarray(valid), h, w,
        True))
    got = port_paste.paste_masks_packed(torch.from_numpy(masks),
                                        torch.from_numpy(boxes),
                                        torch.from_numpy(valid), h, w)
    assert got.dtype == torch.uint8 and tuple(got.shape) == want.shape
    got_bits = np.unpackbits(got.numpy(), axis=-1)
    want_bits = np.unpackbits(want, axis=-1)
    diff = got_bits != want_bits
    exact = _exact(masks, boxes, h, w)
    np.testing.assert_array_less(np.abs(exact[diff] - 127.5), TIE)
    assert diff.mean() <= 1e-4, diff.mean()
    # invalid rows are empty; a zero-size box is clamped to one pixel,
    # as a one-pixel box is; the full-canvas box sets bits
    assert not got_bits[~valid].any()
    assert got_bits[1].sum() <= 1 and got_bits[2].sum() <= 1
    assert got_bits[0].any()
    # the box touching the right edge sets bits in the last column
    assert got_bits[5].any() and got_bits[5][..., w - 1].any()


def test_paste_pack_ragged_width():
    """Widths that are not a multiple of 8 get zero padding bits, as
    ops.bits.pack_masks_device pads (the Pallas kernel needs W % 128)."""
    rng = np.random.RandomState(1)
    h, w = 40, 45
    masks, boxes, valid = _case(rng, 9, h, w)
    t = torch.from_numpy
    got = port_paste.paste_masks_packed(t(masks), t(boxes), t(valid), h, w)
    assert tuple(got.shape) == (9, h, 6)
    bits = np.unpackbits(got.numpy(), axis=-1)
    assert not bits[..., w:].any()
    full = port_paste.paste_masks(t(masks), t(boxes), h, w).numpy()
    np.testing.assert_array_equal(bits[..., :w], full & valid[:, None, None])


@pytest.mark.parametrize("hw", [(33, 997), (70, 61), (9, 3)],
                         ids=["33x997", "70x61", "9x3"])
def test_paste_pack_ragged_canvas_is_the_plain_version(hw):
    """On the CPU the dispatch is the plain version at widths whose row
    pitch is not a multiple of 16 bytes (the kernel's stores are then
    narrower at a band's edges): same bytes, zero padding bits."""
    h, w = hw
    rng = np.random.RandomState(h * w)
    masks, boxes, valid = _case(rng, 12, max(h, 12), max(w, 12))
    boxes = np.minimum(boxes, [h, w, h, w]).astype(np.float32)
    t = torch.from_numpy
    got = port_paste.paste_masks_packed(t(masks), t(boxes), t(valid), h, w)
    want = port_paste.paste_masks_packed_plain(t(masks), t(boxes), t(valid),
                                               h, w)
    assert tuple(got.shape) == (12, h, -(-w // 8))
    assert torch.equal(got, want)
    assert not np.unpackbits(got.numpy(), axis=-1)[..., w:].any()

