"""maskrcnn_tpu_torch — the PyTorch/CUDA port of maskrcnn_tpu for Hopper.

A second package beside the JAX one, held against it module by module.
Plain tensor code is PyTorch; the kernels of the batched inference
path (multilevel RoIAlign with float or int8 tables, greedy NMS, mask
paste-and-pack, and the fused identity bottleneck of the FOLD_BN
configuration) are hand-written CUDA C++ for sm_90a (`csrc/`, built on
first use by `kernels/`). The int8 serving path (QUANT_INT8, `quant.py`)
runs its integer convolutions as `torch._int_mm` GEMMs, where the JAX
package leaves them to XLA.

Dispatch is by the tensor's device: a CUDA tensor runs the kernel (or
raises), a CPU tensor runs the plain PyTorch version in the same `ops/`
module. The configs are the JAX package's own: `maskrcnn_tpu.config`
imports nothing of JAX.
"""

from maskrcnn_tpu.config import (CocoConfig, CocoInferenceConfig, Config,
                                 TinyConfig)

__all__ = ["Config", "CocoConfig", "CocoInferenceConfig", "TinyConfig"]
