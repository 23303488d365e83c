"""maskrcnn_tpu_torch — the PyTorch/CUDA port of maskrcnn_tpu for Hopper.

A second package beside the JAX one, held against it module by module.
Plain tensor code is PyTorch; the kernels of the batched inference
path (multilevel RoIAlign with float or int8 tables, greedy NMS, mask
paste-and-pack, and the fused identity bottleneck of the FOLD_BN
configuration) are hand-written CUDA C++ for sm_90a (`csrc/`, built on
first use by `kernels/`), as is the grouped-RoIAlign gate study
(`ops/group_roi.py`, on no serving path). The int8 serving path
(QUANT_INT8, `quant.py`) runs its integer convolutions as
`torch._int_mm` GEMMs, where the JAX package leaves them to XLA.
Training (`train/`, `MaskRCNN(..., train=True)`) takes the RoIAlign's
gradient for the levels from a hand-written kernel too (K1-bwd).

Dispatch is by the tensor's device: a CUDA tensor runs the kernel (or
raises), a CPU tensor runs the plain PyTorch version in the same `ops/`
module. The entry points (`api.Detector`, `models.mask_rcnn.MaskRCNN`)
run on the card unless given `device="cpu"`. The package carries its own
copy of the configs (`config.py`), of the host codecs (`data/codecs.py`:
Pillow's bilinear resample in torch int32 ops, no Pillow) and of the
COCO evaluation stack (`eval/`, `data/coco.py`), and imports nothing of
the JAX package. Pillow is imported only to read an image file, and
matplotlib only to draw (`utils/visualize.py`).
"""

__all__ = ["Config", "CocoConfig", "CocoInferenceConfig", "TinyConfig"]


def __getattr__(name):
    # the configs on first use, so that importing a submodule (the
    # kernels' op registrations that a loaded program needs) imports
    # nothing else of the package
    if name in __all__:
        from maskrcnn_tpu_torch import config
        return getattr(config, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
