"""Training: target samplers on the device, the multitask loss, the SGD
step and the trainer (counterpart of maskrcnn_tpu.train).

The step runs under torch's deterministic mode (`step.deterministic`),
where cuBLAS refuses to run unless CUBLAS_WORKSPACE_CONFIG is ":4096:8"
or ":16:8", read before the process's first cuBLAS call. Importing this
package sets ":4096:8" (32 MiB, torch's own default size on Hopper)
unless the variable is set, so a process that imports it before its
first product on the card trains deterministically.
"""

import os

from maskrcnn_tpu_torch.train.losses import (Losses, keypoint_loss, mask_loss,
                                             mrn_box_loss, mrn_class_loss,
                                             rpn_box_loss, rpn_class_loss,
                                             smooth_l1)
from maskrcnn_tpu_torch.train.step import (SGD, compute_losses,
                                           deterministic, make_optimizer,
                                           split_accum, train_step)
from maskrcnn_tpu_torch.train.targets import (CascadeTargets, MRNTargets,
                                              RPNTargets, cascade_targets,
                                              keypoint_targets, mrn_targets,
                                              rpn_targets)
from maskrcnn_tpu_torch.train.trainer import (LAYER_REGEX, Trainer,
                                              decay_mask,
                                              fit_canvas_curriculum,
                                              trainable_mask)

# before the process's first cuBLAS call: importing torch makes none
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

__all__ = [
    "Losses", "keypoint_loss", "mask_loss", "mrn_box_loss", "mrn_class_loss",
    "rpn_box_loss", "rpn_class_loss", "smooth_l1", "SGD", "compute_losses",
    "make_optimizer", "split_accum", "train_step", "deterministic",
    "CascadeTargets", "MRNTargets", "RPNTargets", "cascade_targets",
    "keypoint_targets",
    "mrn_targets", "rpn_targets", "LAYER_REGEX", "Trainer", "decay_mask",
    "fit_canvas_curriculum", "trainable_mask",
]
