"""One rank of tests/test_torch_spatial.py's spatial training runs: joins a
gloo group over localhost whose ranks form groups of SP_DEVICES (ranks
[g * sp, (g + 1) * sp) share each image's rows), takes its dp index's
slice of the global batch, runs one step of the port's training with
REMAT_BACKBONE on and off, and rank 0 writes the results. Imports torch
and the port only.

    python -m tests.torch_sp_worker RANK WORLD SP PORT IN.npz OUT.npz

With `coco` first, under torch.distributed.run, it is `coco_torch.py`
with its CocoConfig swapped for TinyConfig (one validation step); with
SP_BATCH_LOG set, each rank writes the SHA-256 of every batch the
Trainer moves to its device, in order, to SP_BATCH_LOG.RANK:

    python -m torch.distributed.run --standalone --nproc_per_node 2 \
        -m tests.torch_sp_worker coco train --devices 2 --sp 2 ...
"""

import json
import sys

import numpy as np
import torch
import torch.distributed as dist


def main(rank: int, world: int, sp: int, port: int, in_path: str,
         out_path: str):
    from maskrcnn_tpu_torch import config as port_config
    from maskrcnn_tpu_torch import parallel
    from maskrcnn_tpu_torch.checkpoint.convert import load_state
    from maskrcnn_tpu_torch.models.mask_rcnn import MaskRCNN
    from maskrcnn_tpu_torch.train import step as pstep
    from maskrcnn_tpu_torch.train.trainer import to_device

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
        batch = {k[6:]: v for k, v in data.items() if k.startswith("batch.")}
        lr = float(data.pop("lr"))
        out = {}
        for remat in (True, False):
            cfg = port_config.TinyConfig(**fields).replace(
                NUM_DEVICES=world, SP_DEVICES=sp, IMAGES_PER_DEVICE=1,
                REMAT_BACKBONE=remat)
            model = MaskRCNN(cfg, "cpu", train=True)
            assert model.spatial is not None
            load_state(model, state)
            params = [p for _, p in model.named_parameters()]
            opt = pstep.make_optimizer(cfg, lr, params, [True] * len(params))
            dp = parallel.for_config(cfg)
            index = parallel.dp_index(cfg)
            local = to_device(parallel.rank_slice(batch, index, 1), "cpu")
            losses = pstep.train_step(model, opt, local,
                                      parallel.rank_generator(0, index), dp)
            run = "remat" if remat else "plain"
            out.update({f"{run}.loss.{k}": v.numpy()
                        for k, v in losses.items()})
            out.update({f"{run}.param.{n}": p.detach().numpy()
                        for n, p in model.named_parameters()})
        if rank == 0:
            np.savez(out_path, **out)
    finally:
        dist.destroy_process_group()


def coco(argv) -> None:
    import hashlib
    import os
    import coco_torch
    from maskrcnn_tpu_torch.config import TinyConfig
    from maskrcnn_tpu_torch.train import trainer
    torch.set_num_threads(2)
    coco_torch.CocoConfig = lambda **kw: TinyConfig(VALIDATION_STEPS=1, **kw)
    digests = []
    to_device = trainer.to_device

    def logged(batch, device):
        h = hashlib.sha256()
        for k in sorted(batch):
            h.update(k.encode())
            h.update(np.ascontiguousarray(batch[k]).tobytes())
        digests.append(h.hexdigest())
        return to_device(batch, device)

    trainer.to_device = logged
    coco_torch.main(argv)
    path = os.environ.get("SP_BATCH_LOG")
    if path:
        with open(f"{path}.{os.environ['RANK']}", "w") as f:
            json.dump(digests, f)


if __name__ == "__main__":
    if sys.argv[1] == "coco":
        coco(sys.argv[2:])
    else:
        main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
             int(sys.argv[4]), sys.argv[5], sys.argv[6])
