#!/bin/bash
# Evaluation entry of the PyTorch/CUDA port (the counterpart of eval.sh)
python coco_torch.py evaluate --dataset data "$@"
