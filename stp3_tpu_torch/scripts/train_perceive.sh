#!/bin/bash
# Stage 1: perception (reference scripts/train_perceive.sh), on the port
# usage: ./stp3_tpu_torch/scripts/train_perceive.sh <config> <dataroot>
python -m stp3_tpu_torch.train --config-file "${1:-stp3_tpu/configs/nuscenes/Perception.yml}" \
    DATASET.DATAROOT "${2:-/data/nuscenes}" DATASET.MAP_FOLDER "${2:-/data/nuscenes}"
