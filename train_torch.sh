#!/bin/bash
# Training entry of the PyTorch/CUDA port (the counterpart of train.sh)
python coco_torch.py train --dataset data "$@"
