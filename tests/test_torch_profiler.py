"""The port's instrumentation (maskrcnn_tpu_torch/utils/profiler.py) and
canvas renders (utils/canvas.py) against the JAX package's."""

import json
import os

import numpy as np
import pytest
import torch

from maskrcnn_tpu.utils import canvas as jax_canvas
from maskrcnn_tpu.utils import profiler as jax_profiler
from maskrcnn_tpu_torch.utils import canvas, profiler


@pytest.mark.parametrize("shape,nrow", [((5, 6, 7), 2), ((9, 4, 5, 3), 4),
                                        ((3, 8, 8, 1), 8)])
def test_make_grid_equals_jax(shape, nrow):
    x = np.random.RandomState(0).randn(*shape).astype(np.float32)
    want = jax_canvas.make_grid(x, nrow=nrow)
    np.testing.assert_array_equal(canvas.make_grid(x, nrow=nrow), want)
    np.testing.assert_array_equal(
        canvas.make_grid(torch.from_numpy(x), nrow=nrow), want)


def test_canvas_writes_a_png(tmp_path):
    pytest.importorskip("matplotlib")
    path = canvas.Canvas("feat", str(tmp_path)).draw_tensor(
        torch.rand(4, 3, 8, 8))
    assert path.endswith("feat_tensor.png") and os.path.getsize(path) > 0


def test_stage_timer_and_throughput_report_as_jax():
    """Same accumulation and the same report lines as the JAX meters, on
    the same recorded times."""
    port, ref = profiler.StageTimer(), jax_profiler.StageTimer()
    for t in (port, ref):
        for name, n in (("decode", 3), ("device", 1)):
            for _ in range(n):
                with t.stage(name):
                    pass
        t.totals = {"decode": 0.25, "device": 1.5}
    assert port.counts == ref.counts == {"decode": 3, "device": 1}
    assert port.report() == ref.report()
    assert port.report().splitlines()[0].startswith("device")
    meter = profiler.Throughput()
    assert meter.images_per_sec == 0.0
    with meter.measure(8):
        pass
    assert meter.images == 8 and meter.seconds > 0
    meter.seconds = 2.0
    assert meter.images_per_sec == 4.0


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiler.trace(str(tmp_path), "step") as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    path = tmp_path / "step.json"
    events = json.loads(path.read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert prof.key_averages()
