"""The kernels' Python side on the CPU: dispatch by device, input checks,
and the build's naming. The kernels themselves run only on the card
(chip_smoke.py compares them with the plain versions there)."""

import shutil

import pytest
import torch

from maskrcnn_tpu_torch import kernels
from maskrcnn_tpu_torch.ops import bottleneck as port_bn
from maskrcnn_tpu_torch.ops import mask_paste as port_paste
from maskrcnn_tpu_torch.ops import nms as port_nms
from maskrcnn_tpu_torch.ops import roi_align as port_roi


def _levels(device, dtype=torch.float32):
    return [torch.zeros(2, s, s, 16, dtype=dtype, device=device)
            for s in (16, 8, 4, 2)]


def test_wrappers_reject_tensors_off_the_card():
    """Checks run before the build, so they raise here without nvcc."""
    levels = _levels("cpu")
    with pytest.raises(ValueError, match="CUDA"):
        kernels.roi_align(levels, torch.zeros(6, 4), 7, (64, 64, 3))
    with pytest.raises(ValueError, match="CUDA"):
        kernels.nms(torch.zeros(2, 5, 4), torch.ones(2, 5, dtype=torch.bool),
                    0.5)
    assert kernels.roi_align.launches == 0 and kernels.nms.launches == 0


def _bottleneck_args(device, dtype=torch.float32, p=16, h=5, w=7):
    """x [2, H, W, 4P] and packed weights on `device`."""
    gen = torch.Generator().manual_seed(p)
    c = 4 * p
    x = torch.randn(2, h, w, c, generator=gen)
    ws = [torch.randn(*s, generator=gen) * 0.2
          for s in ((p, c), (p,), (p, 9, p), (p,), (c, p), (c,))]
    ws = [t.to(dtype) if i % 2 == 0 else t for i, t in enumerate(ws)]
    return [t.to(device) for t in [x.to(dtype)] + ws]


def _paste_args(device, n=6, h=20, w=29):
    gen = torch.Generator().manual_seed(n)
    masks = torch.rand(n, 28, 28, generator=gen)
    start = torch.randint(0, 10, (n, 2), generator=gen).float()
    boxes = torch.cat([start, start + torch.randint(
        0, 12, (n, 2), generator=gen).float()], -1)
    valid = torch.rand(n, generator=gen) > 0.3
    return [t.to(device) for t in (masks, boxes, valid)] + [h, w]


def test_new_wrappers_reject_tensors_off_the_card():
    """The bottleneck and paste-pack wrappers check their inputs before
    the build, so CPU tensors raise here without nvcc."""
    with pytest.raises(ValueError, match="CUDA"):
        kernels.bottleneck(*_bottleneck_args("cpu"))
    with pytest.raises(ValueError, match="CUDA"):
        kernels.paste_pack(*_paste_args("cpu"))
    assert kernels.bottleneck.launches == 0
    assert kernels.paste_pack.launches == 0


@pytest.mark.parametrize("boxes", [
    torch.zeros(2, 3, 4), torch.zeros(6, 5), torch.zeros(6),
    torch.zeros(6, 4, dtype=torch.float64), torch.zeros(6, 4).half(),
    torch.zeros(6, 4, dtype=torch.int32)],
    ids=["batched", "width5", "flat", "float64", "float16", "int32"])
def test_roi_align_rejects_box_shapes_and_dtypes(boxes):
    """The kernel takes boxes [B*N, 4] float32 alone (it computes their
    levels and sample points itself); anything else raises before the
    build and counts no launch."""
    with pytest.raises(ValueError, match=r"boxes must be .*\[B\*N, 4\] "
                                         "float32"):
        kernels.roi_align(_levels("cpu"), boxes, 7, (64, 64, 3))
    assert kernels.roi_align.launches == 0


def test_roi_align_rejects_a_pool_below_one():
    with pytest.raises(ValueError, match="pool size 0"):
        kernels.roi_align(_levels("cpu"), torch.zeros(6, 4), 0, (64, 64, 3))
    assert kernels.roi_align.launches == 0


@pytest.mark.parametrize("op", ["nms", "roi_align", "bottleneck", "paste"])
def test_dispatch_raises_on_devices_without_an_implementation(op):
    """Neither the kernel nor the plain version takes a tensor that is on
    neither the CPU nor a CUDA device."""
    with pytest.raises(ValueError, match="no implementation"):
        if op == "nms":
            port_nms.nms_mask_impl(torch.zeros(2, 5, 4, device="meta"),
                                   torch.ones(2, 5, dtype=torch.bool,
                                              device="meta"), 0.5)
        elif op == "bottleneck":
            port_bn.fused_identity_bottleneck(*_bottleneck_args("meta"))
        elif op == "paste":
            port_paste.paste_masks_packed(*_paste_args("meta"))
        else:
            port_roi.multilevel_roi_align_impl(
                _levels("meta"), torch.zeros(2, 3, 4, device="meta"), 7,
                (64, 64, 3))


def test_cpu_dispatch_is_the_plain_version():
    rng = torch.Generator().manual_seed(0)
    levels = [torch.randn(2, s, s, 16, generator=rng) for s in (16, 8, 4, 2)]
    corner = torch.rand(2, 9, 2, generator=rng) * 0.5
    boxes = torch.cat([corner, corner + torch.rand(2, 9, 2, generator=rng)
                       * 0.5], -1)
    got = port_roi.multilevel_roi_align_impl(levels, boxes, 7, (64, 64, 3))
    want = port_roi.multilevel_roi_align(levels, boxes, 7, (64, 64, 3))
    assert torch.equal(got, want)
    b = torch.rand(2, 30, 4, generator=rng) * 50
    b = torch.cat([b[..., :2], b[..., :2] + b[..., 2:]], -1)
    v = torch.rand(2, 30, generator=rng) > 0.2
    assert torch.equal(port_nms.nms_mask_impl(b, v, 0.5),
                       port_nms.nms_mask(b, v, 0.5))
    assert kernels.roi_align.launches == 0 and kernels.nms.launches == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_dispatch_is_the_plain_bottleneck(dtype):
    args = _bottleneck_args("cpu", dtype)
    got = port_bn.fused_identity_bottleneck(*args)
    assert got.dtype == dtype and got.shape == args[0].shape
    assert torch.equal(got, port_bn.fused_identity_bottleneck_plain(*args))
    assert kernels.bottleneck.launches == 0


def test_cpu_dispatch_is_the_plain_paste():
    args = _paste_args("cpu")
    got = port_paste.paste_masks_packed(*args)
    assert got.shape == (6, 20, 4) and got.dtype == torch.uint8
    assert torch.equal(got, port_paste.paste_masks_packed_plain(*args))
    assert kernels.paste_pack.launches == 0


def test_library_named_by_sources_inside_the_checkout():
    path = kernels.library_path()
    assert path.parent == kernels.BUILD_DIR
    assert kernels.BUILD_DIR.parts[-2:] == ("build", "maskrcnn_tpu_torch")
    assert all((kernels.CSRC / name).is_file() for name in kernels.SOURCES)
    assert "-fmad=false" in kernels.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in kernels.NVCC_FLAGS
    assert path == kernels.library_path()


@pytest.mark.parametrize("source", ["bottleneck.cu", "paste_pack.cu",
                                    "group_roi.cu"])
def test_library_path_follows_the_new_sources(source, tmp_path, monkeypatch):
    """Editing any of these kernels' sources names a new library, so a stale
    build is never loaded."""
    csrc = tmp_path / "csrc"
    shutil.copytree(kernels.CSRC, csrc)
    monkeypatch.setattr(kernels, "CSRC", csrc)
    before = kernels.library_path()
    with open(csrc / source, "a") as f:
        f.write("\n// edited\n")
    assert source in kernels.SOURCES
    assert kernels.library_path() != before


def test_bottleneck_plain_takes_the_packed_layout():
    """pack_weights' K-major layout (w1 [P, C], w2 [P, 9, P], w3 [C, P])
    in the plain version gives the folded block of three float32 convs."""
    import torch.nn.functional as F
    gen = torch.Generator().manual_seed(1)
    p, c = 16, 64
    convs = [torch.randn(*s, generator=gen) / s[1] ** 0.5
             for s in ((p, c, 1, 1), (p, p, 3, 3), (c, p, 1, 1))]
    biases = [torch.randn(n, generator=gen) for n in (p, p, c)]
    x = torch.randn(2, 5, 7, c, generator=gen)
    packed = port_bn.pack_weights(convs[0], biases[0], convs[1], biases[1],
                                  convs[2], biases[2], torch.float32, "cpu")
    assert [tuple(t.shape) for t in packed[::2]] == [(p, c), (p, 9, p),
                                                      (c, p)]
    got = port_bn.fused_identity_bottleneck_plain(x, *packed)
    xc = x.permute(0, 3, 1, 2)
    h = F.relu(F.conv2d(xc, convs[0], biases[0]))
    h = F.relu(F.conv2d(h, convs[1], biases[1], padding=1))
    want = F.relu(F.conv2d(h, convs[2], biases[2]) + xc).permute(0, 2, 3, 1)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)

