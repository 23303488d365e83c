"""The multiclass learning gate (tests/test_learning_ap_multiclass.py
test_trained_multiclass_ap50: the 64 px TinyConfig, 240 steps at B=4 on
the multiclass scenes, bbox AP50 >= 0.70, segm AP50 >= 0.60) run by both
packages from the same start: the port starts from the JAX package's
initial weights (MaskRCNN(cfg).init(PRNGKey(0)) through
checkpoint/convert.from_jax_params), and a shim here feeds the port's
samplers (`train/targets._random_keep`) the JAX step's own uniform
priorities, drawn from the key JAX's loop hands its step, so both pick
the same anchors and RoIs. The per-step losses and the final AP50 of
both are compared; `python tests/test_torch_learning_jax_init.py`
writes records_torch/multiclass_jax_init.json.

The port's own runs (its seeded init and torch generator) gave bbox AP50
0.675 on the card and 0.656 on the CPU, below the 0.70 floor the JAX
package clears (0.752 on the CPU): this says whether the port or the
draw is at fault. From the same start the losses agree to 3e-5 for four
steps, then part: at step 4 the head sampler's RoIs differ, the weights
having drifted by float32 differences. `step_from_jax_weights` gives the
port JAX's own weights at a step, with that step's batch and draws: the
port's losses equal JAX's there (the tier-1 test at step 4, where the
head sampler binds), so the port computes the JAX step and the floor's
miss is the draw.
"""

import json
import sys
import tempfile
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

TESTS = Path(__file__).resolve().parent
REPO = TESTS.parent
sys.path.insert(0, str(TESTS))
sys.path.insert(0, str(REPO))

RECORD = REPO / "records_torch" / "multiclass_jax_init.json"


class JaxDraws:
    """The port's `_random_keep`, its priorities JAX's: each step's key
    (`key, k = jax.random.split(key)`, as the JAX gate's loop) is split
    into 2B image keys (compute_losses: the RPN's B, then the heads' B),
    each into (k_pos, k_neg); the port's four sampler calls a step (RPN
    positives, RPN negatives, head positives, head negatives) take
    `jax.random.uniform` of those keys over their rows."""

    def __init__(self, seed: int = 1):
        self.key = jax.random.PRNGKey(seed)
        self.calls = 0
        self.step_keys = None

    def next_step(self):
        self.key, k = jax.random.split(self.key)
        self.step_keys = k
        self.calls = 0

    def __call__(self, generator, eligible, limit):
        b, n = eligible.shape
        keys = jax.random.split(self.step_keys, 2 * b)
        half = keys[:b] if self.calls < 2 else keys[b:]
        which = self.calls % 2                        # 0: pos, 1: neg
        pri = np.stack([np.asarray(jax.random.uniform(
            jax.random.split(half[i])[which], (n,))) for i in range(b)])
        self.calls += 1
        priority = torch.from_numpy(pri).to(eligible.device)
        priority = torch.where(eligible, priority, 2.0)
        order = torch.sort(priority, dim=-1, stable=True).indices
        rank = torch.empty_like(order).scatter_(
            -1, order, torch.arange(n, device=order.device).expand_as(order))
        if torch.is_tensor(limit):
            limit = limit[:, None]
        return eligible & (rank < limit)


def jax_run(cfg, steps: int, keep_at: int = None):
    """The JAX gate's training loop (test_learning_ap_multiclass._train),
    each step's losses kept. Returns (params, [{loss: value}]), the
    params as they were before step `keep_at` when it is given."""
    from synthetic_scenes import multiclass_train_batch

    from maskrcnn_tpu.models.mask_rcnn import MaskRCNN
    from maskrcnn_tpu.train.step import (TrainState, make_optimizer,
                                         train_step)
    from maskrcnn_tpu.train.trainer import (LAYER_REGEX, decay_mask,
                                            trainable_mask)
    model = MaskRCNN(cfg)
    params = model.init(jax.random.PRNGKey(0))
    regex = LAYER_REGEX["all"]
    tmask = trainable_mask(params, regex)
    opt = make_optimizer(cfg, 3e-3, decay_mask(params, regex))
    oam = (opt, lambda p, _m=tmask: _m)
    state = TrainState(step=np.int32(0), params=params,
                       opt_state=opt.init(params))
    rng = np.random.RandomState(3)
    key = jax.random.PRNGKey(1)
    losses = []
    kept = None
    for step in range(steps):
        if step == keep_at:
            kept = jax.device_get(state.params)
        key, k = jax.random.split(key)
        state, metrics = train_step(model, oam, state,
                                    multiclass_train_batch(rng, cfg, 4), k)
        losses.append({n: float(v) for n, v in metrics.items()})
    return (kept if keep_at is not None else
            jax.device_get(state.params)), losses


def step_from_jax_weights(k: int):
    """Step k of the gate in both packages from JAX's weights before it
    (the port given them through from_jax_params), the same batch and
    the same draws: ({loss: value} of JAX, of the port)."""
    from synthetic_scenes import multiclass_train_batch
    from test_learning_ap_multiclass import _config

    from maskrcnn_tpu_torch.checkpoint.convert import from_jax_params
    from maskrcnn_tpu_torch.train import targets
    from tools import learning_torch as lt

    cfg, pcfg = _config(), lt.gate_config()
    params, jlosses = jax_run(cfg, k + 1, keep_at=k)
    draws = JaxDraws()
    for _ in range(k):
        draws.next_step()
    rng = np.random.RandomState(3)
    for _ in range(k):
        multiclass_train_batch(rng, pcfg, 4)

    def batches():
        while True:
            draws.next_step()
            yield multiclass_train_batch(rng, pcfg, 4)

    trace = []
    keep = targets._random_keep
    targets._random_keep = draws
    try:
        lt.train(pcfg, batches(), 1, "cpu", log_every=0, trace=trace,
                 init_state=from_jax_params(params, pcfg.BACKBONE))
    finally:
        targets._random_keep = keep
    return jlosses[k], {n: float(v) for n, v in trace[0].items()}


def test_step_with_binding_samplers_equals_jax():
    """Step 4 of the multiclass gate from JAX's weights, batch and draws
    (the head sampler holds positives, so all four samplers bind): every
    loss of the port equals JAX's within 1e-5 of its size."""
    want, got = step_from_jax_weights(4)
    assert want["mrn_class"] > 0 and want["mrn_mask"] > 0
    for name, value in want.items():
        assert abs(got[name] - value) <= 1e-5 * max(1.0, abs(value)), name


def compare(steps: int):
    """Both packages' multiclass gate from JAX's initial weights and
    draws: the record (per-step total losses, AP of both, the floors)."""
    from test_learning_ap_multiclass import _config, _evaluate

    from maskrcnn_tpu.models.mask_rcnn import MaskRCNN as JaxMaskRCNN
    from maskrcnn_tpu_torch.checkpoint.convert import from_jax_params
    from maskrcnn_tpu_torch.train import targets
    from tests.torch_port import port_config
    from tools import learning_torch as lt

    cfg = _config()
    pcfg = lt.gate_config()
    assert port_config(cfg) == pcfg
    t0 = time.perf_counter()
    jparams, jlosses = jax_run(cfg, steps)
    jax_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        _, jstats = _evaluate(cfg, jparams, Path(tmp) / "jax", limit=8)
    init = from_jax_params(JaxMaskRCNN(cfg).init(jax.random.PRNGKey(0)),
                           pcfg.BACKBONE)
    draws = JaxDraws()
    trace = []
    keep = targets._random_keep
    targets._random_keep = draws
    try:
        from synthetic_scenes import multiclass_train_batch
        rng = np.random.RandomState(3)

        def batches():
            while True:
                draws.next_step()
                yield multiclass_train_batch(rng, pcfg, 4)

        t0 = time.perf_counter()
        model, info = lt.train(pcfg, batches(), steps, "cpu", log_every=0,
                               tag="jax-init", trace=trace,
                               init_state=init)
        port_s = time.perf_counter() - t0
    finally:
        targets._random_keep = keep
    with tempfile.TemporaryDirectory() as tmp:
        root = lt.make_multiclass_coco_dir(Path(tmp) / "port", pcfg,
                                           n_images=8)
        pstats = lt.evaluate(lt.detector(pcfg, lt.float_state(model), "cpu"),
                             root)
    plosses = [{n: float(v) for n, v in m.items()} for m in trace]
    jt = np.array([m["total"] for m in jlosses])
    pt = np.array([m["total"] for m in plosses])
    return {
        "test": "tests/test_torch_learning_jax_init.py (CPU, both "
                "packages)",
        "config": "tests/test_learning_ap_multiclass._config(): TinyConfig "
                  "64 px, B=4, lr 3e-3, multiclass scenes seed 3",
        "steps": steps,
        "start": "the JAX package's MaskRCNN(cfg).init(PRNGKey(0)), into "
                 "the port through checkpoint/convert.from_jax_params",
        "draws": "the port's samplers fed JAX's uniform priorities of each "
                 "step's key (PRNGKey(1) split a step)",
        "floors": {"bbox_AP50": 0.70, "segm_AP50": 0.60},
        "jax": {"bbox": _summary(jstats["bbox"]),
                "segm": _summary(jstats["segm"]),
                "seconds": jax_s, "last_losses": jlosses[-1]},
        "port": {"bbox": pstats["bbox"], "segm": pstats["segm"],
                 "seconds": port_s, "last_losses": plosses[-1]},
        "total_loss": {"jax": jt.tolist(), "port": pt.tolist(),
                       "max_abs_diff_first_10": float(np.abs(
                           jt[:10] - pt[:10]).max()),
                       "max_abs_diff": float(np.abs(jt - pt).max()),
                       "mean_last_60_jax": float(jt[-60:].mean()),
                       "mean_last_60_port": float(pt[-60:].mean())},
    }


def _summary(stats):
    s = [float(v) for v in stats]
    return {"AP": s[0], "AP50": s[1], "AP75": s[2]}


@pytest.mark.slow
def test_both_packages_train_the_multiclass_gate_from_one_start():
    """240 steps of the gate in both packages from JAX's initial weights
    and draws: the first four steps' losses agree, the JAX package
    clears its floor, and the port trains (its AP is its trajectory's:
    recorded, not held to the floor)."""
    rec = compare(240)
    print(json.dumps({k: v for k, v in rec.items() if k != "total_loss"}))
    jt = np.array(rec["total_loss"]["jax"][:4])
    pt = np.array(rec["total_loss"]["port"][:4])
    assert np.abs(jt - pt).max() <= 1e-5 * np.abs(jt).max()
    assert rec["jax"]["bbox"]["AP50"] >= 0.70
    assert np.isfinite(rec["port"]["last_losses"]["total"])


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu python tests/test_torch_learning_jax_init.py [STEPS]
    record = compare(int(sys.argv[1]) if len(sys.argv) > 1 else 240)
    record["same_weights"] = {}
    for k in (4, 9):
        want, got = step_from_jax_weights(k)
        record["same_weights"][f"step {k}"] = {"jax": want, "port": got}
    RECORD.write_text(json.dumps(record, indent=1) + "\n")
    print(json.dumps({k: v for k, v in record.items()
                      if k != "total_loss"}, indent=1))
    print({k: v for k, v in record["total_loss"].items()
           if not isinstance(v, list)})
