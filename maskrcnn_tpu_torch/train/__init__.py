"""Training: target samplers on the device, the multitask loss, the SGD
step and the trainer (counterpart of maskrcnn_tpu.train)."""

from maskrcnn_tpu_torch.train.losses import (Losses, keypoint_loss, mask_loss,
                                             mrn_box_loss, mrn_class_loss,
                                             rpn_box_loss, rpn_class_loss,
                                             smooth_l1)
from maskrcnn_tpu_torch.train.step import (SGD, compute_losses,
                                           make_optimizer, split_accum,
                                           train_step)
from maskrcnn_tpu_torch.train.targets import (CascadeTargets, MRNTargets,
                                              RPNTargets, cascade_targets,
                                              keypoint_targets, mrn_targets,
                                              rpn_targets)
from maskrcnn_tpu_torch.train.trainer import (LAYER_REGEX, Trainer,
                                              decay_mask,
                                              fit_canvas_curriculum,
                                              trainable_mask)

__all__ = [
    "Losses", "keypoint_loss", "mask_loss", "mrn_box_loss", "mrn_class_loss",
    "rpn_box_loss", "rpn_class_loss", "smooth_l1", "SGD", "compute_losses",
    "make_optimizer", "split_accum", "train_step", "CascadeTargets",
    "MRNTargets", "RPNTargets", "cascade_targets", "keypoint_targets",
    "mrn_targets", "rpn_targets", "LAYER_REGEX", "Trainer", "decay_mask",
    "fit_canvas_curriculum", "trainable_mask",
]
