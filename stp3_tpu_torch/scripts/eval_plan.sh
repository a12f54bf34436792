#!/bin/bash
# Open-loop evaluation (reference scripts/eval_plan.sh), on the port
# usage: ./stp3_tpu_torch/scripts/eval_plan.sh <checkpoint> <dataroot>
python -m stp3_tpu_torch.evaluate --checkpoint "$1" --dataroot "$2"
