#!/bin/bash
# Stage 2: prediction, warm-started from stage 1 minus decoder heads, on the port
# usage: ./stp3_tpu_torch/scripts/train_prediction.sh <config> <dataroot> <pretrained_ckpt>
python -m stp3_tpu_torch.train --config-file "${1:-stp3_tpu/configs/nuscenes/Prediction.yml}" \
    DATASET.DATAROOT "${2:-/data/nuscenes}" DATASET.MAP_FOLDER "${2:-/data/nuscenes}" \
    PRETRAINED.LOAD_WEIGHTS True PRETRAINED.PATH "$3"
