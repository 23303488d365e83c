"""One rank of tests/test_torch_parallel.py's data-parallel runs: joins a
gloo group over localhost, takes its rank-major slice of the global
batch, runs the port's data-parallel training step (and the validation
losses), and rank 0 writes the results. Imports torch and the port only.

    python -m tests.torch_dp_worker RANK WORLD PORT IN.npz OUT.npz
"""

import json
import sys

import numpy as np
import torch
import torch.distributed as dist


def main(rank: int, world: int, port: int, in_path: str, out_path: str):
    from maskrcnn_tpu_torch import config as port_config
    from maskrcnn_tpu_torch import parallel
    from maskrcnn_tpu_torch.checkpoint.convert import load_state
    from maskrcnn_tpu_torch.models.mask_rcnn import MaskRCNN
    from maskrcnn_tpu_torch.train import step as pstep
    from maskrcnn_tpu_torch.train.trainer import split_accum, to_device

    # two threads a rank: the ranks run beside the other test workers
    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        with np.load(in_path) as z:
            data = {k: z[k] for k in z.files}
        fields = {k: tuple(v) if isinstance(v, list) else v
                  for k, v in json.loads(str(data.pop("config"))).items()}
        state = {k[6:]: v for k, v in data.items() if k.startswith("state.")}
        lr = float(data.pop("lr"))
        out = {}
        for run in ("step", "accum"):
            accum = 2 if run == "accum" else 1
            batch = {k[len(run) + 1:]: v for k, v in data.items()
                     if k.startswith(run + ".")}
            per = batch["images"].shape[0] // world
            cfg = port_config.TinyConfig(**fields).replace(
                NUM_DEVICES=world, IMAGES_PER_DEVICE=per,
                GRAD_ACCUM_STEPS=accum)
            model = MaskRCNN(cfg, "cpu", train=True)
            load_state(model, state)
            params = [p for _, p in model.named_parameters()]
            opt = pstep.make_optimizer(cfg, lr, params, [True] * len(params))
            dp = parallel.for_config(cfg)
            local = to_device(parallel.rank_slice(batch, rank, per), "cpu")
            gen = parallel.rank_generator(0, rank)
            if run == "step":
                val = pstep.compute_losses_dp(model, gen, local, dp)
                out.update({f"val.{k}": v.numpy()
                            for k, v in val.as_dict().items()})
            losses = pstep.train_step(model, opt, split_accum(local, accum),
                                      gen, dp)
            out.update({f"{run}.loss.{k}": v.numpy()
                        for k, v in losses.items()})
            out.update({f"{run}.param.{n}": p.detach().numpy()
                        for n, p in model.named_parameters()})
        if rank == 0:
            np.savez(out_path, **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
         sys.argv[5])
