#!/usr/bin/env python3
"""Drive the PyTorch port (stp3_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py              # every phase below
    python3 chip_smoke.py --profile    # ... and where each path's time goes

Phases, each printing one line (or a few) before the last:
  1. device: card name and power limit, torch / CUDA versions, TF32 flags;
  2. build: nvcc-build the BEV splat kernels (K1 and K3), the fused
     lift + splat (K4) and the fused ConvNeXt MLP (K2) from csrc/, one
     nvcc per source, all three at once; each kernel's registers, shared
     memory and spills as ptxas reports them;
  [image_io]: the host C codec of the datasets (csrc/image_codec.c, built
     with cc): the committed 1600x900 camera JPEG
     (tests/data/camera_1600x900.jpg) decoded to the SHA-256 of Pillow's
     decode stored beside it, its nuScenes resize + crop to Pillow's;
     PNGs of every mode with all five row filters read back exactly; the
     resampler against its plain version; the host's ms a decode and a
     resize + crop;
  3. K1 vs its plain version at the serving (F=3) and training (F=6)
     splat shapes, ranks from the flagship rig's real geometry, and at the
     agent's single-frame splat (F=1, the CARLA rig); times of both and of
     index_add_, the share of the bound, K1's atomic rows per landed
     point; at the serving shape also the zeroing and the cast alone;
  4. K2 (fused ConvNeXt MLP, CUDA C++) vs its plain version at the serving
     and training row counts; times of both and the share of the bound;
  5. K3 (the splat's backward row gather) vs its plain version at the
     training shape (6, 483,840, 64), bf16 and fp32, bit for bit; times of
     both and of torch.gather;
  6. backward: K1's autograd Function (K3 backward) vs the plain splat's
     autograd at the training shape, bit for bit;
  [K1 v1] / [K1 v2]: K1's per-frame entries at one flagship frame against
     the plain version, index_add_ and their bound; then the serving splat
     with method 'pallas' / 'pallas2' (3 launches, one per frame) against
     method 'auto' (one launch for all frames);
  [K4]: the fused lift + splat at the flagship fused shape (F=3) against
     its plain version, beside the path it replaces (the lift, then K1):
     device time, one event-timed call and the time with the L2 evicted,
     the share of the bound, K4's atomic rows per landed point and its
     ptxas report; its backward against autograd through the plain version;
  7. CPU-vs-CUDA parity of the tiny model in fp32 (same seeded weights),
     every head, the planner costs on a shared occupancy, and the refined
     trajectory;
  8. CPU-vs-CUDA parity of one tiny fp32 train step (same seeded weights,
     one batch, dropout off, fixed noise, TF32 off): loss terms and every
     gradient;
  9. serving: the full-width flagship (EfficientNet-b4, 6 cameras at
     224x480, 200x200 BEV, 6 future frames, 1,800 candidates) from a
     seeded init under the bf16 policy: forward + occupancy + plan as
     bench.py times it, its launch counts and its p50 latency;
 10. training: the Planning stage at full width and batch 2 (bf16 policy,
     fp32 masters, REMAT 'encoder', seeded init, synthetic batches): one
     counted step, then 2 warm-up and 10 timed steps; loss terms finite,
     parameters changed, step p50, samples/s and peak memory;
     [remat]: the same stage under each MODEL.REMAT tag of REMAT_TAGS
     ('encoder', each other stage with it, and encoder+temporal+decoder+
     cells), from one seeded init and batch: each step's loss terms and
     gradients against the 'encoder' step's, within REMAT_MULTIPLE of the
     distance between two 'encoder' reruns (the bf16 backward's order);
     launches (K1 and K3 once, K2 twice, 4 times under 'future' and
     'gates', whose recomputation runs the future stage's K2 again); peak
     memory, and step p50 in 4 turns with a resident 'encoder' trainer;
 11. [fused]: the flagship with fused_lift_splat: fp32 BEV features of the
     fused and materialised paths of the same weights, then forward + plan
     under the bf16 policy (K4 once, K2 twice, K1 never) and its p50; then
     [fused turns]: the fused and the materialised step of the same
     weights in turns, 4 each, alternating (p50 of 20 steps a turn);
 12. [agent]: the CARLA Planning stage at full width (4 cameras at
     256x256, 200x200 BEV at 0.2 m, 2,400 candidates, seeded fp32 weights):
     AgentCore in its three tick modes over recorded ticks (seeded uint8
     300x400 frames, GPS 2 m further each tick): controls in range, static
     vs dynamic single-frame splat, incremental vs full heads at zero
     ego-motion; each mode's plan_step p50 over 20 ticks, launches per
     tick and peak memory;
 13. the stage train steps, each at full width from a seeded init on
     synthetic batches under its YAML's bf16 policy and REMAT 'encoder'
     (configured as code: PERCEPTION_STAGE, CARLA_PERCEPTION,
     PREDICTION_BER), timed like phase 10, launches, loss terms finite,
     parameters changed, p50, spread, samples/s, peak memory (K1 and K3
     at each stage's splat shape and K2 at Prediction_Ber's rows are held
     against their plain versions with the kernel phases above):
     [perception] nuScenes Perception at batch 3 (K1 and K3 once, K2
     never); [perception carla] CARLA Perception at batch 6 (6 timed
     steps); [prediction_ber] Prediction_Ber at batch 2 (K1, K3 once, K2
     twice);
 14. [perception bn]: Perception under MODEL.NORM 'bn' (BN_MOMENTUM 0.05):
     one step of one seeded init and batch, dropout off, under REMAT
     'encoder' and 'none' must leave the same running statistics (a
     second update in the recomputation would not); then the step's p50
     and peak memory, and an eval forward on the running statistics;
 15. [bn_frozen]: the flagship forward + plan under MODEL.NORM
     'bn_frozen', bf16: launches and p50 of 20 steps;
 16. [train_cli]: stp3_tpu_torch.train.run on the full-width Planning
     stage (batch 2, bf16, REMAT 'encoder') over synthetic 'mini' data,
     with PROFILE.ENABLED (2 steps) and VIS_INTERVAL 2: one epoch (5 train
     steps, validation on 4 samples, a checkpoint), then a resume for a
     second epoch whose step, Adam step and best IoU continue from the
     saved ones; which of tensorboard, moviepy and matplotlib the machine
     has; launches per epoch (K1 and K3 once a train step, K1 once a val
     forward, K2 twice each, and a panel forward every 2 steps where
     tensorboard is present), train and val step p50, checkpoint bytes,
     save and load ms; the profiler trace holds exactly steps 2 and 3 and
     K1's, K3's and K2's kernels; visualise_output of a full-width val
     forward is (T, 1400, 400, 3) uint8; DEBUG.NAN_CHECK on a NaN camera
     image raises FloatingPointError with the parameters, Adam and the
     step unchanged bit for bit;
 17. [evaluate_planning]: stp3_tpu_torch.evaluate.evaluate on that
     checkpoint at batch 1 (4 samples: K1 once, K2 twice a sample): every
     result key finite and in its range, samples/s;
 18. [evaluate_prediction]: the same on a checkpoint of the
     Prediction.yml stage at full width (GAUSSIAN, instance and flow
     heads, 4 future frames), the panoptic metrics through the device
     decode; K2 at its rows is held against its plain version with the
     kernel phases above;
 19. [decode]: that stage's validation output at full width: the device
     decode (utils/instance_jit.py) equal to the host loop id for id;
     both timed, and the Hungarian linking;
 20. [labels as prediction]: the labels fed back as the prediction, at
     full width: IoU = PQ = SQ = RQ = 1 for every present class, L2 = 0,
     no collision;
 21. [reference_import]: a reference-format Lightning .ckpt of the
     nuScenes Planning stage at full width (seeded; BN statistics and every
     constant vector redrawn; the config as plain hyper_parameters)
     through stp3_tpu_torch.scripts.import_torch_checkpoint (an ok()
     report, only the bookkeeping ignored), evaluated on the card as
     [evaluate_planning] is (K1 once and K2 twice a sample), exported back
     with export_torch_checkpoint and held to the input bit for bit (the
     planner GRU's r / z biases to their fold); tensors, bytes, import and
     export seconds, samples/s;
 22. [carla_agent]: the same for the CARLA Planning stage at full width
     (CAM_FRONT_PARITY set and printed), then the harness
     stp3_tpu_torch.carla_agent.STP3Agent on the card over the recorded
     ticks as 300x400 BGRA sensor data with gps, speed and imu: warm-up
     ticks zero, planned ticks equal (1e-5, under deterministic
     algorithms; the spread without them, from the order of fp32 atomic
     adds, printed) to an AgentCore on the same model fed the RGB frames,
     launches per tick as [agent]'s default (static) mode, the tick p50
     beside [agent]'s plan_step p50; then the
     harness with the model cast to bf16: its tick p50 and how many of 20
     planned ticks select another candidate than fp32;
 23. [nuscenes_data]: the nuScenes Planning stage with LIFT.GT_DEPTH at
     full width (6 cameras at 1600x900 -> 224x480, 3 past and 6 future
     frames, the 200x200 BEV) on the PIL-free stand-in tree of
     tests/torch_fake_datasets.py through prepare_dataloaders: ms a
     __getitem__, the loader's samples/s with N_WORKERS (8) process
     workers, then 10 train steps on its batches (K1 and K3 once a step,
     K2 twice; every loss term finite, 'depths' among them) and the step
     p50 beside the loader's rate;
 24. [carla_data]: the same for CARLA's Planning stage on stand-in routes
     (4 cameras at 400x300 -> 256, the topdown labels at scale 1.1, the
     hdmap PNGs), with K1, K3 and K2 also held against their plain
     versions at its shapes;
 25. [dp nccl]: the Planning stage (batch 2, bf16) through the
     data-parallel Trainer over NCCL at world 1 beside the plain Trainer:
     the all-reduce over one rank and the division by 1 leave the
     gradients and the loss terms bit for bit, and clip + Adam on them the
     parameters; one distributed step's launches (K1, K3, K2 twice); both
     trainers' step p50 in turns and the 42 MB gradient all-reduce alone
     (K3 at batch 1 and K1 at one rank's cameras are held against their
     plain versions with the kernel phases);
 26. [dp 2 ranks] / [dp bn]: two ranks of this script (``--rank dp``)
     share the card over gloo (NCCL refuses two ranks on one device):
     the full-width Planning stage in fp32 (TF32 off, dropout off, a fixed
     draw) at batch 1 a rank against one process at batch 2 and against
     that step with its samples swapped (the loss terms, every gradient
     after the all-reduce, the parameters' updates; under MODEL.NORM 'bn'
     the running statistics), both ranks bit for bit equal; then 3 bf16
     steps a rank, each launching K1, K3 and K2 twice;
     [dp batch split]: in one process (fp32, TF32 off, deterministic
     algorithms where torch has them), the mean of two batch-1 steps of the
     Planning stage against the batch-2 step, beside the batch-2 step with
     its samples swapped, held to DP_LIMITS as [dp 2 ranks] is;
 27. [cam parallel]: three ranks (``--rank cam``) on the card over gloo
     split the flagship's 6 cameras over groups of 2 and 3, in bf16 and
     in fp32: forward + plan, serve_step and serve_step_static against the
     one-process port (occupancy, the selected candidate, the refined
     trajectory), each rank's launches (K1 once a forward, never the plain
     splat), the plan step's p50 per rank beside one process's (ranks
     sharing one card: not a latency).
Every multi-rank group runs under a deadline (RANKS_TIMEOUT_S): a rank that
fails or outlives it ends the group and fails the script.
With --profile, torch.profiler windows of 3 calls (device events, summed
device time against the wall time, the kernels that take the most) of the
serving and fused forward + plan, of a train step and of each agent tick
mode; after phase 10 also the train step split by CUDA events into loss
(labels + forward + losses), backward and clip + Adam, and the host's
time to issue a step; in [fused turns] per turn the host's issue time,
the SM clock and power, the device's events, time and idle gaps, then the
kernels and the host ops of each variant.
Then one JSON line with every kernel's numbers (the numbers of the path
each kernel was measured on at the top level, each path's launches and
times under "paths"), and last {"ok": true, "device": {...}}. Any failure
exits non-zero before that.
Without a CUDA device, or without the repository beside it, it fails.
"""
from __future__ import annotations

import copy
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

SEED = 0

# The flagship: the nuScenes Planning stack at full width (EfficientNet-b4,
# 6 cameras at 224x480, 200x200 BEV, 6 future frames, 1,800 candidates)
FLAGSHIP = {
    'N_FUTURE_FRAMES': 6, 'FUTURE_DISCOUNT': 0.95, 'PROBABILISTIC': {'ENABLED': True},
    'PLANNING': {'ENABLED': True, 'SAMPLE_NUM': 1800},
    'INSTANCE_SEG': {'ENABLED': False}, 'INSTANCE_FLOW': {'ENABLED': False},
}
# stp3_tpu/configs/nuscenes/Planning.yml, as code (PyYAML is not needed)
PLANNING_STAGE = {
    'TAG': 'Planning', 'BATCHSIZE': 2, 'PRECISION': 16, 'EPOCHS': 20, 'N_WORKERS': 8,
    'TIME_RECEPTIVE_FIELD': 3, 'N_FUTURE_FRAMES': 6, 'FUTURE_DISCOUNT': 0.95,
    'DATASET': {'VERSION': 'trainval'}, 'LIFT': {'GT_DEPTH': False},
    'MODEL': {'REMAT': 'encoder', 'BN_MOMENTUM': 0.05,
              'ENCODER': {'NAME': 'efficientnet-b4', 'USE_DEPTH_DISTRIBUTION': True},
              'TEMPORAL_MODEL': {'NAME': 'temporal_block', 'INPUT_EGOPOSE': True}},
    'SEMANTIC_SEG': {'PEDESTRIAN': {'ENABLED': True}, 'HDMAP': {'ENABLED': True}},
    'INSTANCE_SEG': {'ENABLED': False}, 'INSTANCE_FLOW': {'ENABLED': False},
    'PROBABILISTIC': {'ENABLED': True, 'METHOD': 'GAUSSIAN'},
    'PLANNING': {'ENABLED': True, 'SAMPLE_NUM': 1800}, 'OPTIMIZER': {'LR': 2e-4},
    'COST_FUNCTION': {'SAFETY': 1.0, 'HEADWAY': 1.0, 'LRDIVIDER': 10.0, 'COMFORT': 0.1,
                      'PROGRESS': 0.5, 'VOLUME': 100.0},
    'PRETRAINED': {'LOAD_WEIGHTS': True},
}
# the tiny model of the parity phases: b0, 2 cameras at 32x64, 16x16 BEV
TINY = {
    'TIME_RECEPTIVE_FIELD': 2, 'N_FUTURE_FRAMES': 2,
    'IMAGE': {'FINAL_DIM': (32, 64), 'NAMES': ['CAM_L', 'CAM_R']},
    'LIFT': {'X_BOUND': [-8.0, 8.0, 1.0], 'Y_BOUND': [-8.0, 8.0, 1.0],
             'D_BOUND': [2.0, 10.0, 1.0]},
    'MODEL': {'ENCODER': {'NAME': 'efficientnet-b0', 'OUT_CHANNELS': 16},
              'TEMPORAL_MODEL': {'START_OUT_CHANNELS': 16},
              'DISTRIBUTION': {'LATENT_DIM': 4}},
    'PLANNING': {'SAMPLE_NUM': 12, 'GRU_STATE_SIZE': 2},
}


# stp3_tpu/configs/carla/Planning.yml, as code: the agent's configuration
CARLA_PLANNING = {
    'TAG': 'CARLA_planning', 'BATCHSIZE': 2, 'PRECISION': 16, 'EPOCHS': 20, 'N_WORKERS': 8,
    'DATASET': {'NAME': 'carla'}, 'TIME_RECEPTIVE_FIELD': 3, 'N_FUTURE_FRAMES': 4,
    'IMAGE': {'FINAL_DIM': (256, 256), 'NAMES': ['front', 'left', 'right', 'rear'],
              'ORIGINAL_HEIGHT': 300, 'ORIGINAL_WIDTH': 400},
    'LIFT': {'X_BOUND': [-20.0, 20.0, 0.2], 'Y_BOUND': [-20.0, 20.0, 0.2], 'GT_DEPTH': False},
    'EGO': {'WIDTH': 2.12, 'HEIGHT': 4.90},
    'MODEL': {'REMAT': 'encoder', 'BN_MOMENTUM': 0.05,
              'ENCODER': {'NAME': 'efficientnet-b4', 'USE_DEPTH_DISTRIBUTION': True},
              'TEMPORAL_MODEL': {'NAME': 'temporal_block', 'INPUT_EGOPOSE': True}},
    'SEMANTIC_SEG': {'PEDESTRIAN': {'ENABLED': True}, 'HDMAP': {'ENABLED': True}},
    'INSTANCE_SEG': {'ENABLED': False}, 'INSTANCE_FLOW': {'ENABLED': False},
    'PROBABILISTIC': {'ENABLED': True, 'METHOD': 'GAUSSIAN'},
    'PLANNING': {'ENABLED': True, 'GRU_STATE_SIZE': 128, 'SAMPLE_NUM': 2400},
    'FUTURE_DISCOUNT': 0.95, 'OPTIMIZER': {'LR': 2e-4},
    'COST_FUNCTION': {'SAFETY': 1.0, 'HEADWAY': 1.0, 'LRDIVIDER': 10.0, 'COMFORT': 1.0,
                      'PROGRESS': 1.0, 'VOLUME': 100.0},
    'PRETRAINED': {'LOAD_WEIGHTS': True},
}


# stp3_tpu/configs/nuscenes/Perception.yml, as code: stage 1 (no future
# prediction, no present distribution, no planner)
PERCEPTION_STAGE = {
    'TAG': 'Perception', 'BATCHSIZE': 3, 'PRECISION': 16, 'EPOCHS': 20, 'N_WORKERS': 8,
    'DATASET': {'VERSION': 'trainval'}, 'TIME_RECEPTIVE_FIELD': 3, 'N_FUTURE_FRAMES': 0,
    'LIFT': {'GT_DEPTH': False},
    'MODEL': {'REMAT': 'encoder', 'BN_MOMENTUM': 0.05,
              'ENCODER': {'NAME': 'efficientnet-b4', 'USE_DEPTH_DISTRIBUTION': True},
              'TEMPORAL_MODEL': {'NAME': 'temporal_block', 'INPUT_EGOPOSE': True}},
    'SEMANTIC_SEG': {'PEDESTRIAN': {'ENABLED': True}, 'HDMAP': {'ENABLED': True}},
    'INSTANCE_SEG': {'ENABLED': False}, 'INSTANCE_FLOW': {'ENABLED': False},
    'PROBABILISTIC': {'ENABLED': False}, 'PLANNING': {'ENABLED': False},
    'OPTIMIZER': {'LR': 1e-3},
}
# stp3_tpu/configs/carla/Perception.yml, as code: 4 cameras at 256x256,
# a +-20 m BEV grid at 0.2 m
CARLA_PERCEPTION = {
    **PERCEPTION_STAGE, 'TAG': 'CARLA_perception', 'BATCHSIZE': 6, 'DATASET': {'NAME': 'carla'},
    'IMAGE': {'FINAL_DIM': (256, 256), 'NAMES': ['front', 'left', 'right', 'rear'],
              'ORIGINAL_HEIGHT': 300, 'ORIGINAL_WIDTH': 400},
    'LIFT': {'X_BOUND': [-20.0, 20.0, 0.2], 'Y_BOUND': [-20.0, 20.0, 0.2], 'GT_DEPTH': False},
}
# stp3_tpu/configs/nuscenes/Prediction_Ber.yml, as code: stage 2 with a
# Bernoulli spatial latent
PREDICTION_BER = {
    'TAG': 'Prediction_Ber', 'BATCHSIZE': 2, 'PRECISION': 16, 'EPOCHS': 20, 'N_WORKERS': 8,
    'DATASET': {'VERSION': 'trainval'}, 'TIME_RECEPTIVE_FIELD': 3, 'N_FUTURE_FRAMES': 4,
    'LIFT': {'GT_DEPTH': False},
    'MODEL': {'REMAT': 'encoder', 'BN_MOMENTUM': 0.05,
              'ENCODER': {'NAME': 'efficientnet-b4', 'USE_DEPTH_DISTRIBUTION': True},
              'TEMPORAL_MODEL': {'NAME': 'temporal_block', 'INPUT_EGOPOSE': True}},
    'SEMANTIC_SEG': {'PEDESTRIAN': {'ENABLED': False}, 'HDMAP': {'ENABLED': False}},
    'INSTANCE_FLOW': {'ENABLED': True},
    'PROBABILISTIC': {'ENABLED': True, 'METHOD': 'BERNOULLI'},
    'PLANNING': {'ENABLED': False}, 'FUTURE_DISCOUNT': 0.95, 'OPTIMIZER': {'LR': 2e-4},
    'PRETRAINED': {'LOAD_WEIGHTS': True},
}
# stp3_tpu/configs/nuscenes/Prediction.yml, as code: stage 2 (GAUSSIAN latent,
# instance and flow heads, no planner)
PREDICTION_STAGE = {**PREDICTION_BER, 'TAG': 'Prediction',
                    'PROBABILISTIC': {'ENABLED': True, 'METHOD': 'GAUSSIAN'}}
# the synthetic data of the train / evaluate CLI paths: 10 training samples
# (5 steps at batch 2) and 4 validation samples, one epoch a run
CLI_DATA = {'DATASET': {'NAME': 'synthetic', 'VERSION': 'mini', 'VAL_SAMPLES': 4},
            'EPOCHS': 1, 'LOGGING_INTERVAL': 1}
# the tiny widths over a stage's own depth (its receptive field, future
# frames and switches), fp32
TINY_WIDTHS = {k: v for k, v in TINY.items()
               if k not in ('TIME_RECEPTIVE_FIELD', 'N_FUTURE_FRAMES')}
STAGES = {'perception': PERCEPTION_STAGE, 'carla_perception': CARLA_PERCEPTION,
          'prediction_ber': PREDICTION_BER, 'prediction': PREDICTION_STAGE}


def make_cfg(*overrides):
    """The port's default config with the nested overrides merged in order."""
    from stp3_tpu_torch.config import CfgNode, get_cfg
    cfg = get_cfg()
    for override in overrides:
        cfg.merge_from_other_cfg(CfgNode(override))
    return cfg


def flagship_cfg(tiny: bool = False):
    return make_cfg(FLAGSHIP, TINY) if tiny else make_cfg(FLAGSHIP)


def planning_cfg(tiny: bool = False):
    """The Planning stage's training config; ``tiny`` in fp32."""
    return make_cfg(PLANNING_STAGE, TINY, {'PRECISION': 32}) if tiny else make_cfg(
        PLANNING_STAGE)


def carla_planning_cfg():
    return make_cfg(CARLA_PLANNING)


def stage_cfg(stage: str, tiny: bool = False, *overrides):
    """The training config of a stage of ``STAGES``, then ``overrides``;
    ``tiny``: at TINY's widths in fp32 (CARLA's four cameras kept, at
    32x32)."""
    if not tiny:
        return make_cfg(STAGES[stage], *overrides)
    cams = ({'IMAGE': {'FINAL_DIM': (32, 32), 'NAMES': CARLA_PERCEPTION['IMAGE']['NAMES']}}
            if stage == 'carla_perception' else {})
    return make_cfg(STAGES[stage], TINY_WIDTHS, cams, {'PRECISION': 32}, *overrides)


# the kernels: name, route, source, the TPU kernel each replaces, and the
# path whose numbers stand at the top level of the kernels line
KERNELS = (
    ('bev_splat', 'cuda', 'stp3_tpu_torch/csrc/bev_pool.cu',
     'stp3_tpu/ops/pallas/bev_pool_kernel.py:262', 'train'),
    ('bev_pool_v1', 'cuda', 'stp3_tpu_torch/csrc/bev_pool.cu',
     'stp3_tpu/ops/pallas/bev_pool_kernel.py:62', 'per_frame'),
    ('bev_pool_v2', 'cuda', 'stp3_tpu_torch/csrc/bev_pool.cu',
     'stp3_tpu/ops/pallas/bev_pool_kernel.py:169', 'per_frame'),
    ('convnext_mlp', 'cuda', 'stp3_tpu_torch/csrc/convnext_mlp.cu',
     'stp3_tpu/ops/pallas/convnext_mlp_kernel.py:124', 'train'),
    ('gather_rows', 'cuda', 'stp3_tpu_torch/csrc/bev_pool.cu',
     'stp3_tpu/ops/pallas/bev_pool_kernel.py:319', 'train'),
    ('lift_splat', 'cuda', 'stp3_tpu_torch/csrc/lift_splat.cu',
     'stp3_tpu/ops/pallas/bev_pool_kernel.py:418', 'fused'),
)
PATHS = ('serving', 'train', 'per_frame', 'fused', 'agent', 'perception', 'perception_carla',
         'perception_bn', 'prediction_ber', 'bn_frozen', 'train_cli', 'evaluate_planning',
         'evaluate_prediction', 'reference_import', 'carla_agent', 'nuscenes_data', 'carla_data',
         'dp_nccl', 'dp_ranks', 'cam_parallel', 'remat')


def counters():
    """Each kernel's launch counter: the wrapper that launches it."""
    from stp3_tpu_torch.ops.kernels import bev_splat as K1
    from stp3_tpu_torch.ops.kernels import convnext_mlp as K2
    from stp3_tpu_torch.ops.kernels import lift_splat as K4
    return {'bev_splat': K1.bev_splat_accumulate, 'bev_pool_v1': K1.bev_pool_v1,
            'bev_pool_v2': K1.bev_pool_v2, 'convnext_mlp': K2.convnext_mlp,
            'gather_rows': K1.gather_rows, 'lift_splat': K4.lift_splat_accumulate}


def reset_launches() -> None:
    for fn in counters().values():
        fn.launches = 0


def read_launches() -> dict:
    import torch
    torch.cuda.synchronize()
    return {name: fn.launches for name, fn in counters().items()}


def expect_launches(what: str, launches: dict, **want) -> None:
    """Fail unless the kernels in ``want`` launched that often and no other
    kernel launched."""
    full = {name: want.get(name, 0) for name in launches}
    if launches != full:
        fail(f'{what}: launches {launches}, expected {full}')


# the kernels' mangled template arguments; a substitution (S_, S0_, ...)
# repeats an earlier argument, in these kernels the one before it
_MANGLED = {'13__nv_bfloat16': 'bf16', 'f': 'float', 't': 'uint16_t', 'j': 'uint32_t',
            '5uint4': 'uint4'}


def ptxas_summary(log: str) -> list:
    """One 'kernel: registers, shared memory, spills' entry per entry
    function of an nvcc '-Xptxas -v' log."""
    import re
    out, name, spills = [], '?', ''
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            # the kernel's name and its mangled template arguments
            base = re.search(r'([a-z][a-z_]*_kernel)I(\w*?)EE', m.group(1))
            name = m.group(1)
            if base:
                args = []
                for tok in re.findall(r'13__nv_bfloat16|5uint4|S\d*_|[a-z]', base.group(2)):
                    args.append(args[-1] if tok.startswith('S') else _MANGLED.get(tok, tok))
                name = f'{base.group(1)}<{", ".join(args)}>'
        m = re.search(r'(\d+) bytes spill stores, (\d+) bytes spill loads', line)
        if m:
            spills = f'spills {m.group(1)}/{m.group(2)} B'
        m = re.search(r'Used (\d+) registers', line)
        if m:
            smem = re.search(r'(\d+) bytes smem', line)
            out.append(f'{name}: {m.group(1)} registers, {smem.group(1) if smem else 0} B static '
                       f'smem, {spills}')
    return out


def build_kernels(repo: str) -> None:
    """nvcc-build K1+K3 (bev_pool.cu), K4 (lift_splat.cu) and K2
    (convnext_mlp.cu) at once, one nvcc per source."""
    from concurrent.futures import ThreadPoolExecutor
    import torch
    from stp3_tpu_torch.ops.kernels import bev_splat as K1
    from stp3_tpu_torch.ops.kernels import convnext_mlp as K2
    from stp3_tpu_torch.ops.kernels import lift_splat as K4
    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:
        infos = list(pool.map(lambda build: build(), (K1.build, K4.build, K2.build)))
    for name, info in zip(('K1+K3', 'K4', 'K2'), infos):
        say(f"[build] {name} {'built' if info['built'] else 'reused'} in {info['seconds']:.2f} s "
            f"-> {os.path.relpath(info['path'], repo)}; ptxas: "
            + ' | '.join(ptxas_summary(info['log'])))
    say(f'[build] K2 dynamic shared memory a CTA: {K2.shared_memory_bytes(torch.bfloat16)} B '
        f'(bf16 rows), {K2.shared_memory_bytes(torch.float32)} B (fp32 rows)')
    say(f'[build] all three builds done in {time.perf_counter() - t0:.2f} s of wall time')


def fail(msg: str) -> None:
    print(f'chip_smoke FAILED: {msg}', flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def example_inputs(cfg, seed: int = SEED, b: int = 1):
    """numpy twin of __graft_entry__._example_inputs + _planning_extras
    (the rig and the ego-motion repeat over a batch of ``b``)."""
    rng = np.random.RandomState(seed)
    rf, n = cfg.TIME_RECEPTIVE_FIELD, len(cfg.IMAGE.NAMES)
    h, w = cfg.IMAGE.FINAL_DIM
    image = rng.rand(b, rf, n, h, w, 3).astype(np.float32)
    k = np.tile(np.array([[0.3 * w, 0, w / 2], [0, 0.3 * w, h / 2], [0, 0, 1]],
                         np.float32), (b, rf, n, 1, 1))
    e = np.tile(np.eye(4, dtype=np.float32), (b, rf, n, 1, 1))
    for i in range(n):
        yaw = 2 * np.pi * i / n
        rot = np.array([[0, 0, 1], [-1, 0, 0], [0, -1, 0]], np.float32)
        yawm = np.array([[np.cos(yaw), -np.sin(yaw), 0],
                         [np.sin(yaw), np.cos(yaw), 0], [0, 0, 1]], np.float32)
        e[:, :, i, :3, :3] = yawm @ rot
        e[:, :, i, :3, 3] = [1.5 * np.cos(yaw), 1.5 * np.sin(yaw), 1.6]
    ego = np.tile(np.array([2.0, 0, 0, 0, 0, 0.01], np.float32), (b, rf, 1))
    rng = np.random.RandomState(seed)
    nf = cfg.N_FUTURE_FRAMES
    extras = {
        'trajs': rng.randn(1, cfg.PLANNING.SAMPLE_NUM, nf, 3).astype(np.float32),
        'gt_trajs': rng.randn(1, nf, 3).astype(np.float32),
        'commands': np.zeros((1,), np.int64),
        'target_points': np.zeros((1, 2), np.float32),
    }
    return (image, k, e, ego), extras


def time_ms(fn, warmup: int = 3, iters: int = 20) -> float:
    """Median of per-call CUDA-event times after warm-up."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def device_ms(fn, calls: int = 10, reps: int = 7) -> float:
    """Device time of one call of ``fn``: ``calls`` calls captured in one
    CUDA graph, replayed ``reps`` times, the median replay (CUDA events)
    over ``calls``. Unlike ``time_ms`` it leaves out the host's time to
    issue the call (Python, the wrapper, the launches)."""
    import torch
    for _ in range(3):
        fn()                                  # warm-up: builds, caches, the allocator
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return time_ms(graph.replay, warmup=1, iters=reps) / calls


# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {'bf16': 989e12, 'fp32': 67e12}


def bound(n_bytes: float, n_ops: float, kind: str):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the operations over the peak rate of their type."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / PEAK_OPS_PER_S[kind]
    return max(t_bytes, t_ops) * 1e3, 'bytes' if t_bytes >= t_ops else 'operations'


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def rig_geometry(cfg, device, b: int = 1, carla: bool = False):
    """(geometry (B, rf, N, D, Hf, Wf, 3), ego (B, rf, 6), (res, start,
    dim)) of the example rig and ego-motion, or of the fixed CARLA rig at
    zero ego-motion."""
    import torch
    from stp3_tpu_torch.datas.carla_data import carla_cam_rig
    from stp3_tpu_torch.ops.geometry import (calculate_birds_eye_view_parameters,
                                             create_frustum, get_geometry)
    mc = model_cfg(cfg)
    (_, k, e, ego), _ = example_inputs(cfg, b=b)
    if carla:
        extr, intr = carla_cam_rig(mc.final_dim)
        k, e = (np.tile(a, (b, mc.receptive_field, 1, 1, 1)) for a in (intr, extr))
        ego = np.zeros_like(ego)
    grid = calculate_birds_eye_view_parameters(mc.x_bound, mc.y_bound, mc.z_bound)
    fr = torch.as_tensor(create_frustum(mc.final_dim, mc.encoder_downsample, mc.d_bound),
                         device=device)
    k, e, ego = to_torch((k, e, ego), device)
    return get_geometry(fr, k, e), ego, grid


def splat_ranks(cfg, device, b: int = 1):
    """(F = b * rf, P) int32 ranks of the flagship rig's real frustum
    geometry, pre-warped by the example ego-motion, as the model splats."""
    from stp3_tpu_torch.ops.bev_pool import prewarped_ranks
    geometry, ego, (res, start, dim) = rig_geometry(cfg, device, b)
    return prewarped_ranks(geometry, ego, res, start, dim), int(np.prod(dim))


def phase_k1(cfg, device, path: str, b: int = 1, ranks=None):
    """K1 vs its plain version at the splat of a batch of ``b`` (F = b * rf
    frames), or at the given (F, P) ``ranks``; returns its numbers for the
    ``path`` it serves."""
    import torch
    from stp3_tpu_torch.ops.kernels import bev_splat as K1
    ncells = int(np.prod(model_cfg(cfg).bev_dimension))
    if ranks is None:
        ranks, ncells = splat_ranks(cfg, device, b=b)
    f, p = ranks.shape
    c = cfg.MODEL.ENCODER.OUT_CHANNELS
    gen = torch.Generator(device='cpu').manual_seed(SEED)
    feats = torch.randn(f, p, c, generator=gen).to(device=device, dtype=torch.bfloat16)
    acc_k = K1.bev_splat_accumulate(feats, ranks, ncells)
    acc_p = K1.bev_splat_accumulate_plain(feats, ranks, ncells)
    torch.cuda.synchronize()
    err = (acc_k - acc_p).abs().max().item()
    # fp32 on both sides; only the (atomic) summation order differs
    ok = torch.allclose(acc_k, acc_p, rtol=1e-4, atol=1e-3)
    valid = (ranks < ncells).sum().item()
    # the timed window: zeroing the (F, ncells, C) fp32 accumulator, the
    # kernel and the cast of the sums to bf16
    ms = device_ms(lambda: K1.bev_splat(feats, ranks, ncells))
    call_ms = time_ms(lambda: K1.bev_splat(feats, ranks, ncells))
    plain_ms = device_ms(lambda: K1.bev_splat_plain(feats, ranks, ncells))
    # one PyTorch call of the same scatter-add: index_add_ onto a flat buffer
    flat_idx = (ranks.long() + torch.arange(f, device=device)[:, None] * (ncells + 1)).reshape(-1)
    buf = torch.zeros(f * (ncells + 1), c, dtype=feats.dtype, device=device)
    flat_feats = feats.reshape(-1, c)
    library_ms = device_ms(lambda: buf.index_add_(0, flat_idx, flat_feats))
    # every rank and the rows of the points that land in the grid read once
    # (a dropped point's row is never needed), the (F, ncells, C) result
    # written once; one add per channel of each point that lands
    n_bytes = valid * c * feats.element_size() + nbytes(ranks) + (
        f * ncells * c * feats.element_size())
    bound_ms, bound_by = bound(n_bytes, valid * c, 'fp32')
    rows = K1.atomic_rows_per_landed_point(ranks, ncells)
    say(f'[K1 {path}] bev_splat F={f} P={p} C={c} ncells={ncells} bf16, invalid share '
        f'{1 - valid / (f * p):.4f}: max_abs_err {err:.3e} (rtol 1e-4, atol 1e-3) '
        f'{"OK" if ok else "MISMATCH"}; kernel {ms:.4f} ms (zeroing the fp32 sums, the kernel, '
        f'the cast to bf16; {call_ms:.4f} ms a call with the host\'s issue time), plain '
        f'{plain_ms:.3f} ms, index_add_ {library_ms:.3f} ms, bound '
        f'{bound_ms:.4f} ms ({bound_by}, {n_bytes / 1e6:.1f} MB), bound_share '
        f'{bound_ms / ms:.3f}; atomic rows per landed point {rows:.4f} (tile {K1.TILE})')
    if not ok:
        fail(f'K1 disagrees with its plain version at F={f}')
    if path == 'serving':
        zero_ms = device_ms(lambda: torch.zeros(f, ncells, c, device=device))
        sums = K1.bev_splat_accumulate(feats, ranks, ncells)
        cast_ms = device_ms(lambda: sums.to(feats.dtype))
        say(f'[K1 {path}] of the kernel\'s {ms:.4f} ms: zeroing the fp32 sums alone '
            f'{zero_ms:.4f} ms, the cast to bf16 alone {cast_ms:.4f} ms')
    return dict(shape=f'F={f} P={p} C={c} ncells={ncells} bf16', max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
                bound_share=bound_ms / ms, atomic_rows_per_landed_point=rows)


def phase_k2(cfg, device, path: str, b: int = 1):
    """K2 vs its plain version at the two ConvNeXt row counts of a batch of
    ``b``; returns its numbers (summed over both calls) for ``path``."""
    import torch
    from stp3_tpu_torch.ops.kernels import convnext_mlp as K2
    c = cfg.MODEL.TEMPORAL_MODEL.START_OUT_CHANNELS
    nx = int((cfg.LIFT.X_BOUND[1] - cfg.LIFT.X_BOUND[0]) / cfg.LIFT.X_BOUND[2])
    ny = int((cfg.LIFT.Y_BOUND[1] - cfg.LIFT.Y_BOUND[0]) / cfg.LIFT.Y_BOUND[2])
    rf, nf = cfg.TIME_RECEPTIVE_FIELD, cfg.N_FUTURE_FRAMES
    gen = torch.Generator(device='cpu').manual_seed(SEED)

    def rnd(*shape, scale=1.0, shift=0.0):
        return (torch.randn(*shape, generator=gen) * scale + shift).to(device)

    weights = (rnd(c, scale=0.1, shift=1.0), rnd(c, scale=0.1),
               rnd(c, 4 * c, scale=c ** -0.5), rnd(4 * c, scale=0.1),
               rnd(4 * c, c, scale=(4 * c) ** -0.5), rnd(c, scale=0.1),
               rnd(c, scale=0.5))
    per_shape, errs, ms, plain_ms, bound_ms, bound_by = [], [], 0.0, 0.0, 0.0, set()
    for frames in (nf, rf + nf):          # after the DualGRU; after SpatialGRU 1
        n = b * frames * nx * ny
        h = rnd(n, c).to(torch.bfloat16)
        x = rnd(n, c).to(torch.bfloat16)
        got = K2.convnext_mlp(h, x, *weights)
        want = K2.convnext_mlp_plain(h, x, *weights)
        err = (got.float() - want.float()).abs().max().item()
        ok = torch.allclose(got.float(), want.float(), rtol=1e-2, atol=1e-2)
        t_k = device_ms(lambda: K2.convnext_mlp(h, x, *weights))
        t_call = time_ms(lambda: K2.convnext_mlp(h, x, *weights))
        t_p = device_ms(lambda: K2.convnext_mlp_plain(h, x, *weights))
        # h, x and the weights read once, y written once; two (N, C) x (C, 4C)
        # products of 2 operations per multiply-add, on the bf16 tensor cores
        t_b, by = bound(nbytes(h, x, h) + nbytes(*weights),
                        2 * 2 * n * c * 4 * c, 'bf16')
        say(f'[K2 {path}] convnext_mlp N={n} C={c} bf16: max_abs_err {err:.3e} (rtol=atol=1e-2) '
            f'{"OK" if ok else "MISMATCH"}; kernel {t_k:.4f} ms ({t_call:.4f} ms a call with the '
            f'host\'s issue time), plain {t_p:.3f} ms, bound '
            f'{t_b:.4f} ms ({by}), bound_share {t_b / t_k:.3f}; no single PyTorch call computes '
            f'this function')
        if not ok:
            fail(f'K2 disagrees with its plain version at N={n}')
        per_shape.append(dict(n=n, max_abs_err=err, ms=t_k, plain_ms=t_p, bound_ms=t_b,
                              bound_share=t_b / t_k))
        errs.append(err)
        ms += t_k
        plain_ms += t_p
        bound_ms += t_b
        bound_by.add(by)
    return dict(shape=f'N={" and ".join(str(s["n"]) for s in per_shape)} C={c} bf16',
                max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by='/'.join(sorted(bound_by)), library_ms=None, bound_share=bound_ms / ms,
                per_shape=per_shape)


def phase_k3(cfg, device, path: str = 'train'):
    """K3 at a training shape: the splat's cotangent (F, ncells, C) and the
    ranks of the config's rig at batch B = cfg.BATCHSIZE; returns its
    numbers for ``path``."""
    import torch
    from stp3_tpu_torch.ops.kernels import bev_splat as K
    ranks, ncells = splat_ranks(cfg, device, b=int(cfg.BATCHSIZE))
    f, p = ranks.shape
    c = cfg.MODEL.ENCODER.OUT_CHANNELS
    gen = torch.Generator(device='cpu').manual_seed(SEED)
    table32 = torch.randn(f, ncells, c, generator=gen).to(device)
    parts = []
    for table in (table32, table32.to(torch.bfloat16)):
        got = K.gather_rows(table, ranks)
        want = K.gather_rows_plain(table, ranks)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f'K3 differs from its plain version ({table.dtype}): max_abs_err '
                 f'{(got.float() - want.float()).abs().max().item():.3e}')
        parts.append(str(table.dtype).replace('torch.', ''))
    table = table32.to(torch.bfloat16)                      # the bf16 policy's cotangent
    ms = device_ms(lambda: K.gather_rows(table, ranks))
    plain_ms = device_ms(lambda: K.gather_rows_plain(table, ranks))
    # one PyTorch call of the same gather: torch.gather from the padded table
    padded = torch.cat([table, table.new_zeros(f, 1, c)], 1)
    idx = ranks.long().clamp(0, ncells)[..., None].expand(-1, -1, c)
    library_ms = device_ms(lambda: torch.gather(padded, 1, idx))
    # every rank and the table rows that some rank names read once (a row
    # no point lands on is never needed), the (F, P, C) rows written once
    referenced = sum(torch.unique(r[(r >= 0) & (r < ncells)]).numel() for r in ranks)
    n_bytes = (referenced * c + f * p * c) * table.element_size() + nbytes(ranks)
    bound_ms, bound_by = bound(n_bytes, 0, 'bf16')
    say(f'[K3 {path}] gather_rows F={f} P={p} C={c} ncells={ncells} ({referenced / (f * ncells):.4f} '
        f'of the rows referenced): equal to its plain version bit for bit in '
        f'{" and ".join(parts)}; bf16 kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, '
        f'torch.gather {library_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}, '
        f'{n_bytes / 1e6:.1f} MB)')
    return dict(shape=f'F={f} P={p} C={c} ncells={ncells} bf16', max_abs_err=0.0, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)


def phase_backward(cfg, device):
    """K1's autograd Function (K3 backward) against autograd through the
    plain splat at the training shape, bf16, bit for bit. (K2's Function
    differentiates its plain version, so a comparison with the plain
    version's autograd cannot differ; tests/test_torch_cuda.py checks its
    wiring at a small shape.)"""
    import torch
    from stp3_tpu_torch.ops.kernels import bev_splat as K1
    gen = torch.Generator(device='cpu').manual_seed(SEED + 1)
    ranks, ncells = splat_ranks(cfg, device, b=int(cfg.BATCHSIZE))
    f, p = ranks.shape
    c = cfg.MODEL.ENCODER.OUT_CHANNELS
    feats = torch.randn(f, p, c, generator=gen).to(device, torch.bfloat16)
    g = torch.randn(f, ncells, c, generator=gen).to(device, torch.bfloat16)
    grads = []
    for splat in (K1.bev_splat, K1.bev_splat_plain):
        x = feats.clone().requires_grad_(True)
        splat(x, ranks, ncells).backward(g)
        grads.append(x.grad)
    torch.cuda.synchronize()
    # both gather the same bf16 cotangent rows: no arithmetic
    if not torch.equal(*grads):
        fail('K1 backward (K3) differs from the plain splat\'s autograd')
    say(f'[backward] K1 d feats ({f}, {p}, {c}) bf16 equal bit for bit to the plain '
        f'splat\'s autograd')


def model_cfg(cfg):
    from stp3_tpu_torch.models.stp3 import STP3Config
    return STP3Config.from_cfg(cfg)


def phase_per_frame(cfg, device):
    """[K1 v1] / [K1 v2]: K1's per-frame entries at one flagship frame (the
    present frame's ranks) against the plain version, then the serving
    splat with method 'pallas' / 'pallas2' against 'auto'. Returns (numbers
    by entry, launches of the per-frame path)."""
    import torch
    from stp3_tpu_torch.ops.bev_pool import prewarped_ranks, project_to_birds_eye_view
    from stp3_tpu_torch.ops.kernels import bev_splat as K1
    geometry, ego, (res, start, dim) = rig_geometry(cfg, device)
    ranks = prewarped_ranks(geometry, ego, res, start, dim)[-1].contiguous()
    ncells = int(np.prod(dim))
    p = ranks.shape[0]
    c = cfg.MODEL.ENCODER.OUT_CHANNELS
    gen = torch.Generator(device='cpu').manual_seed(SEED)
    feats32 = torch.randn(p, c, generator=gen).to(device)
    feats = feats32.to(torch.bfloat16)
    valid = (ranks < ncells).sum().item()
    rows = K1.atomic_rows_per_landed_point(ranks[None], ncells)
    numbers = {}
    for name, version in (('bev_pool_v1', 'v1'), ('bev_pool_v2', 'v2')):
        entry = getattr(K1, name)
        got32 = entry(feats32, ranks, ncells)
        want32 = K1.bev_splat_accumulate_plain(feats32[None], ranks[None], ncells)[0]
        got16 = entry(feats, ranks, ncells)
        want16 = K1.bev_splat_plain(feats[None], ranks[None], ncells)[0]
        torch.cuda.synchronize()
        err = (got32 - want32).abs().max().item()
        # fp32 rows: the fp32 sums at K1's tolerance; bf16 rows: both round
        # the same sums (reordered), so at most one bf16 rounding (2^-8) apart
        ok = (torch.allclose(got32, want32, rtol=1e-4, atol=1e-3)
              and torch.allclose(got16.float(), want16.float(), rtol=2 ** -7, atol=1e-3))
        ms = device_ms(lambda: entry(feats, ranks, ncells))
        plain_ms = device_ms(lambda: K1.bev_splat_plain(feats[None], ranks[None], ncells))
        buf = torch.zeros(ncells + 1, c, dtype=feats.dtype, device=device)
        idx = ranks.long()
        library_ms = device_ms(lambda: buf.index_add_(0, idx, feats))
        n_bytes = valid * c * feats.element_size() + nbytes(ranks) + ncells * c * 2
        bound_ms, bound_by = bound(n_bytes, valid * c, 'fp32')
        say(f'[K1 {version}] {name} P={p} C={c} ncells={ncells} bf16 (one flagship frame, '
            f'invalid share {1 - valid / p:.4f}): max_abs_err {err:.3e} on fp32 rows (rtol '
            f'1e-4, atol 1e-3), bf16 rows within one rounding, {"OK" if ok else "MISMATCH"}; '
            f'kernel {ms:.3f} ms (zeroing, kernel, cast), plain {plain_ms:.3f} ms, index_add_ '
            f'{library_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}, {n_bytes / 1e6:.1f} MB), '
            f'bound_share {bound_ms / ms:.3f}; atomic rows per landed point {rows:.4f} (tile '
            f'{K1.TILE})')
        if not ok:
            fail(f'K1 {version} disagrees with its plain version')
        numbers[name] = dict(shape=f'P={p} C={c} ncells={ncells} bf16', max_abs_err=err, ms=ms,
                             plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                             library_ms=library_ms, bound_share=bound_ms / ms,
                             atomic_rows_per_landed_point=rows)

    # the per-frame path: the serving splat with one launch per frame, fp32
    # lifted rows so that the methods compare at K1's tolerance
    mc = model_cfg(cfg)
    n = len(cfg.IMAGE.NAMES)
    hf, wf = (v // mc.encoder_downsample for v in mc.final_dim)
    lifted = torch.randn(1, mc.receptive_field, n, mc.depth_channels, hf, wf, c,
                         generator=torch.Generator(device=device).manual_seed(SEED),
                         device=device)
    args = (lifted, geometry, ego, res, start, dim, mc.discount)
    reset_launches()
    want = project_to_birds_eye_view(*args, method='auto')
    expect_launches("method 'auto'", read_launches(), bev_splat=1)
    path_launches = dict.fromkeys(counters(), 0)
    for method, name in (('pallas', 'bev_pool_v1'), ('pallas2', 'bev_pool_v2')):
        reset_launches()
        got = project_to_birds_eye_view(*args, method=method)
        launches = read_launches()
        expect_launches(f'method {method!r}', launches, **{name: mc.receptive_field})
        path_launches[name] += launches[name]
        err = (got - want).abs().max().item()
        if not torch.allclose(got, want, rtol=1e-4, atol=1e-3):
            fail(f'project_to_birds_eye_view method {method!r} differs from \'auto\': '
                 f'max_abs_err {err:.3e}')
        say(f'[K1 per_frame] project_to_birds_eye_view {tuple(lifted.shape)} fp32, method '
            f'{method!r}: {launches[name]} launches of {name} (one per frame), equal to '
            f"method 'auto' (one K1 launch) within rtol 1e-4, atol 1e-3: max_abs_err {err:.3e}")
    return numbers, path_launches


def cold_ms(fn, flush) -> float:
    """``device_ms`` of ``fn`` with ``flush`` (a buffer larger than the
    card's 50 MB L2) zeroed before each call, less the zeroing's own time:
    the time of a call that finds its inputs out of the L2."""
    return device_ms(lambda: (flush.zero_(), fn())) - device_ms(flush.zero_)


def k4_inputs(cfg, device):
    """The fused splat's inputs at the flagship rig: (F, N, Hf, Wf, C) bf16
    context and (F, N, Hf, Wf, D) bf16 depth logits, seeded, of F = rf
    frames; the (F, P) pre-warped ranks of the rig's real geometry; the
    (P,) ray ids; ncells."""
    import torch
    from stp3_tpu_torch.ops.bev_pool import lift_ray_ids
    ranks, ncells = splat_ranks(cfg, device)
    mc = model_cfg(cfg)
    f = ranks.shape[0]
    n, d, c = len(cfg.IMAGE.NAMES), mc.depth_channels, cfg.MODEL.ENCODER.OUT_CHANNELS
    hf, wf = (v // mc.encoder_downsample for v in mc.final_dim)
    gen = torch.Generator(device=device).manual_seed(SEED)
    feat = torch.randn(f, n, hf, wf, c, generator=gen, device=device).to(torch.bfloat16)
    logits = torch.randn(f, n, hf, wf, d, generator=gen, device=device).to(torch.bfloat16)
    return feat, logits, ranks, lift_ray_ids(n, d, hf, wf, device), ncells


def depth_probs(logits):
    """(F, N, Hf, Wf, D) depth logits -> (F, P) probabilities in K4's point
    order (camera, depth bin, pixel row, pixel column)."""
    import torch
    return torch.softmax(logits, -1).movedim(-1, 2).reshape(logits.shape[0], -1).contiguous()


def k4_bound(ctx, dp, ranks, rays, ncells):
    """(bound_ms, bound_by, bytes) of K4: every rank read once; the ray id
    and dp of each point that lands; the ctx table once; the (F, ncells,
    C) result written once in ctx's dtype; a multiply and an add per
    channel of each point that lands."""
    f, _, c = ctx.shape
    valid = (ranks < ncells).sum().item()
    n_bytes = (nbytes(ranks) + valid * (rays.element_size() + dp.element_size()) + nbytes(ctx)
               + f * ncells * c * ctx.element_size())
    return bound(n_bytes, 2 * valid * c, 'fp32') + (n_bytes,)


def phase_k4(cfg, device):
    """[K4]: the fused lift + splat at the flagship fused shape (F = rf
    frames, bf16 ctx and depth probabilities, the rig's real ranks) against
    its plain version and the path it replaces; its backward (fp32) against
    autograd through the plain version."""
    import torch
    from stp3_tpu_torch.models.stp3 import lift_depth_context
    from stp3_tpu_torch.ops.kernels import bev_splat as K1
    from stp3_tpu_torch.ops.kernels import lift_splat as K4
    feat, logits, ranks, rays, ncells = k4_inputs(cfg, device)
    f, p = ranks.shape
    c = feat.shape[-1]
    ctx, dp = feat.reshape(f, -1, c), depth_probs(logits)
    acc_k = K4.lift_splat_accumulate(ctx, dp, ranks, rays, ncells)
    acc_p = K4.lift_splat_accumulate_plain(ctx, dp, ranks, rays, ncells)
    torch.cuda.synchronize()
    err = (acc_k - acc_p).abs().max().item()
    ok = torch.allclose(acc_k, acc_p, rtol=1e-4, atol=1e-3)
    # the timed window: zeroing the (F, ncells, C) fp32 sums, the kernel and
    # the cast of the sums to bf16
    ms = device_ms(lambda: K4.lift_splat_frames(ctx, dp, ranks, rays, ncells))
    call_ms = time_ms(lambda: K4.lift_splat_frames(ctx, dp, ranks, rays, ncells))
    flush = torch.empty(32 * 2 ** 20, device=device)          # 128 MB of fp32
    cold = cold_ms(lambda: K4.lift_splat_frames(ctx, dp, ranks, rays, ncells), flush)
    del flush
    plain_ms = device_ms(lambda: K4.lift_splat_plain(ctx, dp, ranks, rays, ncells))
    # from the same encoder outputs: softmax + K4, against the lift + K1
    fused_ms = device_ms(lambda: K4.lift_splat_frames(ctx, depth_probs(logits), ranks, rays,
                                                      ncells))
    materialised_ms = device_ms(lambda: K1.bev_splat(
        lift_depth_context(feat, logits).reshape(f, -1, c), ranks, ncells))
    valid = (ranks < ncells).sum().item()
    bound_ms, bound_by, n_bytes = k4_bound(ctx, dp, ranks, rays, ncells)
    rows = K1.atomic_rows_per_landed_point(ranks, ncells, K4.TILE)
    ptxas = ' | '.join(ptxas_summary(K4.build()['log']))
    say(f'[K4] lift_splat F={f} R={ctx.shape[1]} P={p} C={c} ncells={ncells} bf16, invalid share '
        f'{1 - valid / (f * p):.4f}: max_abs_err {err:.3e} (rtol 1e-4, atol 1e-3) '
        f'{"OK" if ok else "MISMATCH"}; kernel {ms:.4f} ms (zeroing the fp32 sums, the kernel, '
        f'the cast to bf16; {call_ms:.4f} ms a call with the host\'s issue time, {cold:.4f} ms '
        f'with the L2 evicted), plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}, '
        f'{n_bytes / 1e6:.1f} MB), bound_share {bound_ms / ms:.3f}; atomic rows per landed '
        f'point {rows:.4f} (tile {K4.TILE}); from the encoder outputs: softmax + K4 '
        f'{fused_ms:.4f} ms, lift + K1 (materialised) {materialised_ms:.4f} ms; no single '
        f'PyTorch call computes this function; ptxas: {ptxas}')
    if not ok:
        fail('K4 disagrees with its plain version')

    g = torch.randn(f, ncells, c, generator=torch.Generator(device=device).manual_seed(SEED + 1),
                    device=device)
    grads = []
    for fn in (K4.lift_splat_frames, K4.lift_splat_plain):
        a = ctx.float().requires_grad_(True)
        b = dp.float().requires_grad_(True)
        reset_launches()
        fn(a, b, ranks, rays, ncells).backward(g)
        grads.append((a.grad, b.grad, read_launches()))
    (ga, gb, lk), (wa, wb, lp) = grads
    expect_launches('K4 forward + backward', lk, lift_splat=1, gather_rows=1)
    expect_launches('plain lift + splat forward + backward', lp)
    errs = [(x - y).abs().max().item() for x, y in ((ga, wa), (gb, wb))]
    # fp32 on both sides; index_add_ over ray ids and the atomics reorder sums
    if not (torch.allclose(ga, wa, rtol=1e-4, atol=1e-4)
            and torch.allclose(gb, wb, rtol=1e-4, atol=1e-4)):
        fail(f'K4 backward differs from the plain autograd: d ctx {errs[0]:.3e}, d dp '
             f'{errs[1]:.3e} (rtol 1e-4, atol 1e-4)')
    say(f'[K4] backward (fp32, K3 row gather + index_add_ over ray ids) vs autograd through the '
        f'plain version within rtol 1e-4, atol 1e-4: d ctx max_abs_err {errs[0]:.3e}, d dp '
        f'{errs[1]:.3e}')
    return dict(shape=f'F={f} R={ctx.shape[1]} P={p} C={c} ncells={ncells} bf16',
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None, bound_share=bound_ms / ms, call_ms=call_ms,
                cold_ms=cold, atomic_rows_per_landed_point=rows,
                materialised_ms=materialised_ms, fused_path_ms=fused_ms)


def to_torch(arrays, device, dtype=None):
    import torch
    return [torch.as_tensor(a, device=device) if dtype is None or not np.issubdtype(
        a.dtype, np.floating) else torch.as_tensor(a, device=device).to(dtype) for a in arrays]


def build_model(cfg, fused: bool = False):
    import torch
    from stp3_tpu_torch.layers.base import init_parameters
    from stp3_tpu_torch.models.stp3 import STP3
    model = STP3(dataclasses.replace(model_cfg(cfg), fused_lift_splat=fused))
    init_parameters(model, torch.Generator().manual_seed(SEED))
    return model.eval()


def plan_step(model, image, k, e, ego, trajs, gt, commands, target):
    """bench.py's timed step: forward, occupancy, plan."""
    import torch
    rf = model.cfg.receptive_field
    out = model(image, k, e, ego)
    seg = out['segmentation'].argmax(-1)
    ped = out['pedestrian'].argmax(-1)
    occupancy = torch.logical_or(seg, ped).float()
    _, traj = model.plan(out['cam_front'], trajs, gt, out['costvolume'][:, rf:],
                         occupancy[:, rf:], out['hdmap'], commands, target)
    return out, traj


def close(name, got, want, atol=2e-3, rtol=1e-3):
    import torch
    got, want = got.float().cpu(), want.float().cpu()
    err = (got - want).abs().max().item()
    if not torch.allclose(got, want, atol=atol, rtol=rtol):
        fail(f'device parity: {name} max_abs_err {err:.3e} (atol {atol}, rtol {rtol})')
    return err


def planner_costs(model, plan_args):
    """The planner's (cost_fc, cost_fo) for plan()'s arguments."""
    _, trajs, _, cost_volume, occupancy, hd_map, commands, target = plan_args
    cur = model.planner.select_trajs_by_command(trajs, commands)
    lane_divider, drivable = model.planner.split_hdmap(hd_map)
    return model.planner.cost_fn(cost_volume, cur[..., :2], occupancy, lane_divider,
                                 drivable, target)


def phase_parity(tiny_cfg, device):
    """The tiny model in fp32, CPU (plain versions) vs CUDA (kernels)."""
    import torch
    from stp3_tpu_torch.utils.precision import pin_fp32_math
    pin_fp32_math()
    cpu_model = build_model(tiny_cfg)
    gpu_model = copy.deepcopy(cpu_model).to(device)
    (image, k, e, ego), ex = example_inputs(tiny_cfg)
    rf = tiny_cfg.TIME_RECEPTIVE_FIELD
    errs = {}
    with torch.inference_mode():
        out_c = cpu_model(*to_torch((image, k, e, ego), 'cpu'))
        out_g = gpu_model(*to_torch((image, k, e, ego), device))
        for key, v in out_c.items():
            if v is None:
                if out_g[key] is not None:
                    fail(f'device parity: {key} is None on CPU only')
                continue
            errs[key] = close(key, out_g[key], v)
        seg_c, ped_c = out_c['segmentation'].argmax(-1), out_c['pedestrian'].argmax(-1)
        occ = torch.logical_or(seg_c, ped_c).float()[:, rf:]
        traj_in = to_torch((ex['trajs'], ex['gt_trajs'], ex['commands'],
                            ex['target_points']), 'cpu')
        for code in (1, 2):                   # FORWARD, RIGHT
            cmd = torch.tensor([code])
            args_c = (out_c['cam_front'], traj_in[0], traj_in[1],
                      out_c['costvolume'][:, rf:], occ, out_c['hdmap'], cmd, traj_in[3])
            args_g = tuple(a.to(device) for a in args_c)
            # the same inputs on both sides: costs first, then the selection
            fc_c, fo_c = planner_costs(cpu_model, args_c)
            fc, fo = planner_costs(gpu_model, args_g)
            errs[f'cost_fc[{code}]'] = close(f'cost_fc cmd {code}', fc, fc_c)
            errs[f'cost_fo[{code}]'] = close(f'cost_fo cmd {code}', fo, fo_c)
            _, traj_c = cpu_model.plan(*args_c)
            _, traj_g = gpu_model.plan(*args_g)
            errs[f'traj[{code}]'] = close(f'refined traj cmd {code}', traj_g, traj_c)
    worst = max(errs, key=errs.get)
    say(f'[parity] tiny model fp32, CPU vs CUDA (TF32 off: matmul '
        f'{torch.backends.cuda.matmul.allow_tf32}, cudnn {torch.backends.cudnn.allow_tf32}): '
        f'{len(errs)} outputs within atol 2e-3 rtol 1e-3; worst {worst} {errs[worst]:.3e}')


def phase_flagship(cfg, device, card, fused: bool = False, tag: str = ''):
    """The serving forward + plan at full width under the bf16 policy;
    ``fused``: with the fused lift + splat (K4 in place of the lift and
    K1). Returns the launches of one step."""
    import torch
    from stp3_tpu_torch.utils.precision import policy_dtype
    tag = f'[{tag}]' if tag else '[fused]' if fused else '[flagship]'
    t0 = time.perf_counter()
    dt = policy_dtype(cfg)
    model = build_model(cfg, fused).to(device=device, dtype=dt)
    n_params = sum(p.numel() for p in model.parameters())
    (image, k, e, ego), ex = example_inputs(cfg)
    image, = to_torch((image,), device, dt)
    k, e, ego = to_torch((k, e, ego), device)                    # geometry stays fp32
    trajs, gt, target = to_torch((ex['trajs'], ex['gt_trajs'], ex['target_points']),
                                 device, dt)
    commands, = to_torch((ex['commands'],), device)
    say(f'{tag} {n_params} params, {dt}, built in {time.perf_counter() - t0:.1f} s')
    with torch.inference_mode():
        reset_launches()
        out, traj = plan_step(model, image, k, e, ego, trajs, gt, commands, target)
        launches = read_launches()
        if fused:
            expect_launches('fused forward + plan', launches, lift_splat=1, convnext_mlp=2)
        else:
            expect_launches('forward + plan', launches, bev_splat=1, convnext_mlp=2)
        for key, v in out.items():
            if v is not None and not torch.isfinite(v.float()).all():
                fail(f'flagship output {key} is not finite')
        if tuple(traj.shape) != (1, cfg.N_FUTURE_FRAMES, 3) or not torch.isfinite(
                traj.float()).all():
            fail(f'refined trajectory {tuple(traj.shape)} not finite of shape (1, 6, 3)')
        shapes = {key: tuple(v.shape) for key, v in out.items() if v is not None}
        say(f'{tag} outputs finite: {shapes}; traj {tuple(traj.shape)} '
            f'{traj[0, :, :2].float().cpu().numpy().round(3).tolist()}')
        say(f'{tag} launches per forward: {launches}')
        torch.cuda.reset_peak_memory_stats()

        def step():
            return plan_step(model, image, k, e, ego, trajs, gt, commands, target)

        p50 = time_ms(step, warmup=3, iters=20)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        say(f'{tag} forward+plan p50 {p50:.2f} ms (median of 20, CUDA events), '
            f'peak memory {peak:.2f} GiB, on {card}')
        if '--profile' in sys.argv[1:]:
            profile_window(lambda i: step(), f'{tag} forward+plan', card)
        if fused:
            fused_vs_materialised(model, step, card)
    return launches


TURNS = (False, True, True, False, False, True, True, False)   # fused_lift_splat, in turns


def fused_vs_materialised(model, step, card) -> None:
    """[fused turns]: the serving step with the fused and the materialised
    splat of the same weights, in ``TURNS`` (4 turns each, alternating),
    p50 of 20 steps a turn. With --profile also, per turn: the host's time
    to issue a step (from a drained device: the call's own time, then the
    wait for the device), the card's SM clock and power while the p50 ran,
    and a torch.profiler window of 3 steps (device events and time a step,
    the device's busy share and largest idle gaps); then per variant the
    kernels that take the most and the host ops whose time a step differs
    most between the two."""
    import torch
    profiling = '--profile' in sys.argv[1:]
    names = {False: 'materialised', True: 'fused'}
    p50s = {False: [], True: []}
    windows = {False: [], True: []}
    for turn in TURNS:
        model.cfg = dataclasses.replace(model.cfg, fused_lift_splat=turn)
        if not profiling:
            p50s[turn].append(time_ms(step, warmup=3, iters=20))
            continue
        sampler = smi_sampler()
        try:
            p50s[turn].append(time_ms(step, warmup=3, iters=20))
        finally:
            clock, power = smi_stop(sampler)
        issue, tail = [], []
        for _ in range(20):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            issue.append((t1 - t0) * 1e3)
            tail.append((time.perf_counter() - t1) * 1e3)
        window = profile_steps(lambda i: step())
        windows[turn].append(window)
        say(f'[fused turns] {names[turn]}: p50 {p50s[turn][-1]:.2f} ms; host issue p50 '
            f'{np.median(issue):.2f} ms, then the device {np.median(tail):.2f} ms; SM clock '
            f'{clock} MHz, power {power} W (medians while the p50 ran); profiled: '
            f'{window["events"]:.0f} device events, {window["busy_ms"]:.2f} ms device time and '
            f'{window["wall_ms"]:.2f} ms wall a step (busy '
            f'{window["busy_ms"] / window["wall_ms"]:.3f}), '
            f'largest idle gaps {", ".join(f"{g:.2f}" for g in window["gaps"])} ms')
    say(f'[fused turns] in turns ({", ".join(names[t] for t in TURNS)}; p50 of 20 steps each): '
        f'materialised {" / ".join(f"{t:.2f}" for t in p50s[False])} ms (median '
        f'{np.median(p50s[False]):.2f}), fused {" / ".join(f"{t:.2f}" for t in p50s[True])} ms '
        f'(median {np.median(p50s[True]):.2f}), on {card}')
    if not profiling:
        return
    per_step = {}
    for turn in (False, True):
        kernels, host = {}, {}
        for w in windows[turn]:
            for table, part in ((kernels, w['kernels']), (host, w['host'])):
                for name, (ms, k) in part.items():
                    t, n = table.get(name, (0.0, 0.0))
                    table[name] = (t + ms / len(windows[turn]), n + k / len(windows[turn]))
        per_step[turn] = host
        top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]
        say(f'[fused turns] {names[turn]}, device kernels a step (mean of the turns): '
            + '; '.join(f'{ms:.3f} ms x{k:.0f} {name[:70]}' for name, (ms, k) in top))
    ops = set(per_step[False]) | set(per_step[True])

    def diff(name):
        return per_step[True].get(name, (0.0, 0))[0] - per_step[False].get(name, (0.0, 0))[0]

    say('[fused turns] host ops whose self time a step differs most (fused - materialised; '
        'ms a step, calls a step): ' + '; '.join(
            f'{name[:50]} {diff(name):+.3f} ms ({per_step[False].get(name, (0, 0))[1]:.0f} -> '
            f'{per_step[True].get(name, (0, 0))[1]:.0f} calls)'
            for name in sorted(ops, key=lambda n: -abs(diff(n)))[:12]))


def smi_sampler():
    """nvidia-smi sampling the SM clock and power draw every 100 ms."""
    return subprocess.Popen(['nvidia-smi', '--query-gpu=clocks.sm,power.draw',
                             '--format=csv,noheader,nounits', '-lms', '100'],
                            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)


def smi_stop(proc):
    """Stop an ``smi_sampler``; (median SM clock, median power) of its samples."""
    proc.terminate()
    out, _ = proc.communicate(timeout=30)
    rows = [line.split(',') for line in out.splitlines() if line.count(',') == 1]
    try:
        vals = np.array([[float(a), float(b)] for a, b in rows])
    except ValueError:
        return 'unread', 'unread'
    if not len(vals):
        return 'unread', 'unread'
    clock, power = np.median(vals, 0)
    return f'{clock:.0f}', f'{power:.1f}'


def phase_fused(cfg, device, card):
    """[fused]: the fp32 BEV features of the fused (K4) and materialised
    (lift, then K1) paths of one seeded full-width model, then the fused
    forward + plan under the bf16 policy. Returns the launches of one step."""
    import torch
    model = build_model(cfg).to(device)
    (image, k, e, ego), _ = example_inputs(cfg)
    image, k, e, ego = to_torch((image, k, e, ego), device)
    with torch.inference_mode():
        want, _, _ = model.calculate_birds_eye_view_features(image, k, e, ego)
        model.cfg = dataclasses.replace(model.cfg, fused_lift_splat=True)
        reset_launches()
        got, _, _ = model.calculate_birds_eye_view_features(image, k, e, ego)
        expect_launches('fp32 fused BEV features', read_launches(), lift_splat=1)
        err = (got - want).abs().max().item()
        ok = torch.allclose(got, want, rtol=1e-4, atol=1e-3)
    say(f'[fused] fp32 BEV features {tuple(got.shape)} of the fused path (K4) vs the '
        f'materialised one (lift, then K1), same weights: max_abs_err {err:.3e} of max '
        f'{want.abs().max().item():.3e} (rtol 1e-4, atol 1e-3) {"OK" if ok else "MISMATCH"}')
    if not ok:
        fail('fused and materialised BEV features differ')
    del model, got, want
    torch.cuda.empty_cache()
    return phase_flagship(cfg, device, card, fused=True)


CAMS = ('rgb', 'rgb_left', 'rgb_right', 'rgb_rear')
AGENT_MODES = (('full', dict(incremental=False)),
               ('incremental', dict(incremental=True, static_geometry=False)),
               ('static', dict(incremental=True, static_geometry=True)))
HEADS = ('segmentation', 'pedestrian', 'hdmap', 'costvolume')


def recorded_ticks(n: int):
    """n seeded CARLA sensor ticks: uint8 300x400 frames of the four
    cameras, the GPS 2 m further each tick, heading 0."""
    rng = np.random.RandomState(SEED)
    for t in range(n):
        yield ({key: rng.randint(0, 256, (300, 400, 3), np.uint8) for key in CAMS},
               np.array([2.0 * t, 0.0]), 0.0)


def selected(model, plan_args):
    """Index of the candidate the planner selects before refinement."""
    import torch
    fc, fo = planner_costs(model, plan_args)
    return torch.argmin(fc + fo.sum(-1), -1).tolist()


def serve_plan_args(model, out, trajs, commands, target):
    import torch
    rf = model.cfg.receptive_field
    occ = torch.logical_or(out['segmentation'].argmax(-1), out['pedestrian'].argmax(-1)).float()
    return (out['cam_front'], trajs, torch.zeros(1, model.cfg.n_future, 3, device=trajs.device),
            out['costvolume'][:, rf:], occ[:, rf:], out['hdmap'], commands, target)


def phase_agent(device, card):
    """[agent]: the CARLA Planning stage at full width, seeded fp32 weights:
    the serving methods against the full forward, then AgentCore's three
    tick modes. Returns (K1's numbers at the agent's splat, the launches of
    one steady tick of each mode, each mode's plan_step p50 in ms)."""
    import torch
    from stp3_tpu_torch.datas.carla_data import carla_cam_rig, scale_and_crop_image
    from stp3_tpu_torch.deploy.agent_core import AgentCore
    from stp3_tpu_torch.models.stp3 import context_depth_rays, lift_depth_context
    from stp3_tpu_torch.ops.bev_pool import prewarped_ranks, project_to_birds_eye_view
    from stp3_tpu_torch.ops.static_splat import build_column_splat_plan, column_splat
    from stp3_tpu_torch.utils import sampler
    from stp3_tpu_torch.utils.network import prepare_image
    cfg = carla_planning_cfg()
    t0 = time.perf_counter()
    model = build_model(cfg).to(device)
    mc, rf = model.cfg, cfg.TIME_RECEPTIVE_FIELD
    say(f'[agent] CARLA Planning stage: {sum(p.numel() for p in model.parameters())} fp32 '
        f'params, {len(cfg.IMAGE.NAMES)} cameras at {tuple(mc.final_dim)}, BEV {mc.bev_size} at '
        f'{mc.x_bound[2]} m, D={mc.depth_channels}, rf {rf}, {mc.n_future} future frames, '
        f'{mc.sample_num} candidates, GRU {mc.gru_state_size}; built in '
        f'{time.perf_counter() - t0:.1f} s')

    # K1 at the agent's dynamic single-frame splat: the CARLA rig, F=1
    geometry, ego, (res, start, dim) = rig_geometry(cfg, device, carla=True)
    k1 = phase_k1(cfg, device, 'agent',
                  ranks=prewarped_ranks(geometry[:, -1:], ego[:, -1:], res, start, dim))

    # the serving methods against the full forward at zero ego-motion
    extr, intr = carla_cam_rig(mc.final_dim)
    t0 = time.perf_counter()
    arrays = build_column_splat_plan(model.frustum, intr, extr, model.bev_resolution,
                                     model.bev_start_position,
                                     model.bev_dimension).device_arrays(device)
    plan_s = time.perf_counter() - t0
    crop = mc.final_dim[0]
    frames = np.stack([np.stack([scale_and_crop_image(fr[key], 1.0, crop) for key in CAMS])
                       for fr, _, _ in recorded_ticks(rf)])[None]        # (1, rf, 4, H, W, 3)
    images = prepare_image(torch.as_tensor(frames, device=device), torch.float32)
    k, e = (torch.as_tensor(np.tile(a, (1, rf, 1, 1, 1)), device=device) for a in (intr, extr))
    ego0 = torch.zeros(1, rf, 6, device=device)
    trajs = torch.as_tensor(sampler.sample_trajectories(
        3.0, 0.0, mc.n_future, mc.sample_num, rng=np.random.RandomState(SEED))[None, :, 1:],
        dtype=torch.float32, device=device)
    commands = torch.tensor([1], device=device)
    target = torch.tensor([[0.0, 5.0]], device=device)
    with torch.inference_mode():
        bev_d, _ = model.splat_single_frame(images[:, -1], k[:, -1], e[:, -1])
        bev_s, _ = model.splat_single_frame_static(images[:, -1], arrays)
        err = (bev_s - bev_d).abs().max().item()
        if not torch.allclose(bev_s, bev_d, rtol=1e-4, atol=1e-3):
            fail(f'static and dynamic single-frame splats differ: max_abs_err {err:.3e}')
        say(f'[agent] single-frame splat {tuple(bev_d.shape)} fp32, static (column plan, built '
            f'in {plan_s:.2f} s, mask {tuple(arrays["mask"].shape)}) vs dynamic (K1): max_abs_err '
            f'{err:.3e} of max {bev_d.abs().max().item():.3e} (rtol 1e-4, atol 1e-3) OK')
        out_f = model(images, k, e, ego0)
        args_f = serve_plan_args(model, out_f, trajs, commands, target)
        _, traj_f = model.plan(*args_f)
        pick_f = selected(model, args_f)
        cache = {name: torch.stack([split(t) for t in range(rf - 1)], 1) for name, split in (
            ('incremental', lambda t: model.splat_single_frame(images[:, t], k[:, t], e[:, t])[0]),
            ('static', lambda t: model.splat_single_frame_static(images[:, t], arrays)[0]))}
        served = {'incremental': model.serve_step(images[:, -1], k[:, -1], e[:, -1], ego0,
                                                  cache['incremental'], trajs, commands, target),
                  'static': model.serve_step_static(images[:, -1], ego0, cache['static'], trajs,
                                                    commands, target, arrays)}
        for name, (traj, out, _) in served.items():
            errs = {key: (out[key] - out_f[key]).abs().max().item() for key in HEADS}
            # tests/test_serving.py:69-73's tolerance (rtol = atol = 1e-4), atol
            # doubled: the full forward splats its frames in one K1 launch, the
            # tick each frame alone, so the fp32 atomics sum in other orders
            # (which change from run to run), and the identity warp of the
            # cached frames is exact only to the rounding of its sampling
            # coordinates; through the 200x200 fp32 BEV stack that moves the
            # heads by up to ~1e-4 (9.6e-5 and 1.02e-4 in two runs)
            share = max(((out[key] - out_f[key]).abs() / (2e-4 + 1e-4 * out_f[key].abs()))
                        .max().item() for key in HEADS)
            ok = share <= 1.0
            pick = selected(model, serve_plan_args(model, out, trajs, commands, target))
            d_traj = (traj - traj_f).abs().max().item()
            say(f'[agent] {name} tick vs full forward at zero ego-motion: heads max_abs_err '
                f'{ {key: float(f"{v:.3e}") for key, v in errs.items()} } (rtol 1e-4, atol 2e-4; '
                f'{share:.2f} of the tolerance used) {"OK" if ok else "MISMATCH"}; selected '
                f'candidate {pick} vs {pick_f}; refined trajectory max_abs_err {d_traj:.3e}')
            if not ok:
                fail(f'{name} tick heads differ from the full forward at zero ego-motion')
            if pick == pick_f and not torch.allclose(traj, traj_f, rtol=1e-4, atol=1e-4):
                fail(f'{name} tick trajectory differs from the full forward\'s with the same '
                     f'selected candidate')
        # the single-frame splat alone, from the encoder's outputs: the lift
        # and K1 (dynamic) against the column plan (static)
        feat, depth = model.encode(images[:, -1].reshape(-1, *images.shape[3:]))
        feat = feat.reshape(1, -1, *feat.shape[1:])
        depth5 = depth.reshape(1, -1, *depth.shape[1:])
        zero = torch.zeros(1, 1, 6, device=device)
        ctx, dp = context_depth_rays(mc, feat, depth)
        dyn_ms = time_ms(lambda: project_to_birds_eye_view(
            lift_depth_context(feat, depth5)[:, None], geometry[:, -1:], zero, res, start, dim))
        sta_ms = time_ms(lambda: column_splat(ctx, dp, arrays, (
            feat.shape[1], feat.shape[2], feat.shape[3], mc.depth_channels, mc.bev_dimension)))
        say(f'[agent] single-frame splat from the encoder outputs, fp32: lift + K1 {dyn_ms:.3f} '
            f'ms, column plan (mask product, context product, sorted index_add_) {sta_ms:.3f} ms '
            f'(CUDA events, median of 20)')
    del out_f, served, cache

    # the three tick modes through AgentCore: 2 checked ticks, then 20 timed
    per_tick, plan_p50, n_timed = {}, {}, 20
    for mode, kw in AGENT_MODES:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        core = AgentCore(cfg, model, device=device, **kw)
        setup_s = time.perf_counter() - t0
        controls, push_ms, plan_ms, sample_ms = [], [], [], []
        for t, (frame, gps, theta) in enumerate(recorded_ticks(rf + 3 + n_timed)):
            t0 = time.perf_counter()
            core.push_frame(frame, gps, theta)
            push_ms.append((time.perf_counter() - t0) * 1e3)
            if not core.warmed_up:
                continue
            np.random.seed(SEED + t)              # the sampler draws from the module RNG
            if len(controls) == 2:
                reset_launches()
            t0 = time.perf_counter()
            controls.append(core.plan_step(3.0, 4, np.array([0.0, 5.0])))
            plan_ms.append((time.perf_counter() - t0) * 1e3)
        launches = read_launches()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        for _ in range(n_timed):                  # the sampler alone: host work of a tick
            t0 = time.perf_counter()
            sampler.sample_trajectories(3.0, 0.0, mc.n_future, mc.sample_num)
            sample_ms.append((time.perf_counter() - t0) * 1e3)
        if len(plan_ms) != 2 + n_timed:
            fail(f'agent {mode}: {len(plan_ms)} planned ticks, expected {2 + n_timed}')
        for steer, throttle, brake, _ in controls:
            if not (np.isfinite([steer, throttle]).all() and -1.0 <= steer <= 1.0
                    and 0.0 <= throttle <= 0.75 and isinstance(brake, bool)):
                fail(f'agent {mode}: control out of range: {(steer, throttle, brake)}')
        per = {name: n / n_timed for name, n in launches.items()}
        expect_launches(f'agent {mode} tick', per, **({} if mode == 'static' else {'bev_splat': 1}))
        per_tick[mode] = {name: int(n) for name, n in per.items()}
        plan_p50[mode] = float(np.median(plan_ms[2:]))
        first = [tuple(round(float(v), 4) for v in c[:3]) for c in controls[:2]]
        say(f'[agent] {mode}: set-up (incl. warm-up{", column plan" if mode == "static" else ""}) '
            f'{setup_s:.2f} s; first two planned ticks (steer, throttle, brake) {first}; '
            f'plan_step p50 {float(np.median(plan_ms[2:])):.2f} ms (median of {n_timed} ticks, '
            f'wall clock, host included; spread {min(plan_ms[2:]):.2f}-{max(plan_ms[2:]):.2f}), '
            f'push_frame (crop) p50 {float(np.median(push_ms)):.3f} ms, of which host work: '
            f'trajectory sampling p50 {float(np.median(sample_ms)):.2f} ms; launches per tick '
            f'{ {n: v for n, v in per_tick[mode].items() if v} }; peak memory {peak:.2f} GiB; '
            f'on {card}')
        if '--profile' in sys.argv[1:]:
            profile_ticks(core, mode, card)
    return k1, per_tick, plan_p50


def profile_steps(run, n: int = 3, n_gaps: int = 3) -> dict:
    """torch.profiler over ``n`` calls of ``run(i)``, a call at a time:
    wall time, device events and summed device time, the device's
    ``n_gaps`` largest idle gaps (ms), and by name the device kernels' and
    the host ops' self time (ms) and counts."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            run(i)
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / n
    kernels = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
    gaps, end = [], None
    for e in kernels:
        if end is not None and e.time_range.start > end:
            gaps.append((e.time_range.start - end) / 1e3)
        end = e.time_range.end if end is None else max(end, e.time_range.end)
    by_name = {}
    for e in kernels:
        t, k = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us() / 1e3 / n, k + 1 / n)
    host = {a.key: (a.self_cpu_time_total / 1e3 / n, a.count / n) for a in prof.key_averages()
            if a.device_type == torch.autograd.DeviceType.CPU}
    return dict(wall_ms=wall, events=len(kernels) / n,
                busy_ms=sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / n,
                gaps=sorted(gaps, reverse=True)[:n_gaps], kernels=by_name, host=host)


def profile_window(run, what: str, card, n: int = 3, top: int = 6) -> None:
    """Where the time of ``n`` calls of ``run(i)`` goes (--profile):
    torch.profiler's device events and summed device time per call beside
    the wall time per call, and the kernels that take the most."""
    w = profile_steps(run, n)
    say(f'[profile] {what}: {n} under torch.profiler, {w["wall_ms"]:.2f} ms of wall time, '
        f'{w["events"]:.0f} device events and {w["busy_ms"]:.2f} ms of summed device time each '
        f'(device busy {w["busy_ms"] / w["wall_ms"]:.2f} of the wall time); on {card}')
    for name, (ms, k) in sorted(w['kernels'].items(), key=lambda kv: -kv[1][0])[:top]:
        say(f'[profile]   {ms:8.2f} ms each {k:6.0f} calls each  {name[:110]}')


def profile_ticks(core, mode: str, card, ticks: int = 3):
    """Where an agent tick's time goes (--profile): ``ticks`` planned ticks."""
    frames = list(recorded_ticks(ticks))

    def tick(i):
        core.push_frame(*frames[i])
        core.plan_step(3.0, 4, np.array([0.0, 5.0]))

    profile_window(tick, f'agent {mode} tick', card, ticks)


def synthetic_batches(cfg, n_batches: int, device):
    """``n_batches`` batches of cfg.BATCHSIZE synthetic samples, on the device."""
    from stp3_tpu_torch.datas.synthetic import SyntheticDataset, collate
    from stp3_tpu_torch.training.trainer import batch_to_device
    b = int(cfg.BATCHSIZE)
    ds = SyntheticDataset(cfg, n_samples=b * n_batches, seed=SEED)
    return [batch_to_device(collate([ds[j] for j in range(i * b, (i + 1) * b)]), device)
            for i in range(n_batches)]


def step_grads(trainer, batch, noise, outputs=None):
    """(loss dict, {name: gradient}) of one step without the optimizer;
    ``outputs``, a list, receives every module's output of the forward."""
    import torch
    keep = (lambda m, i, o: outputs.append(o.detach().double().cpu())
            if isinstance(o, torch.Tensor) else None)
    hooks = [m.register_forward_hook(keep) for m in trainer.model.modules()] if (
        outputs is not None) else []
    trainer.optimizer.zero_grad(set_to_none=True)
    total, loss = trainer.loss_fn(batch, noise=noise, dropout=False)
    n_forward = len(outputs or ())
    total.backward()
    for hook in hooks:
        hook.remove()
    if outputs is not None:
        del outputs[n_forward:]           # REMAT's recomputation in the backward
    return ({k: v.item() for k, v in loss.items()},
            {n: p.grad.double().cpu() for n, p in trainer.model.named_parameters()})


def phase_train_parity(tiny_cfg, device):
    """One tiny fp32 train step on CUDA (kernels) and on the CPU (plain
    versions), each against the same step in float64 on the CPU (PRECISION
    64): the same seeded weights, one batch, dropout off, one fixed noise
    draw, TF32 off. The CUDA step's loss terms at rtol 1e-4; its gradients
    at a relative L2 error below 1e-2 each and below 1e-3 in the median
    over the parameters. Why not 1e-3 each: in fp32 an element whose
    pre-activation lies within rounding of zero can take the other side of
    a ReLU, and on this tiny model one such element moves every gradient
    upstream of it by up to a few 1e-3, on either device. The line prints
    both fp32 steps' distances from the float64 one and their sign flips
    (module-output elements whose sign differs from the float64 forward)."""
    import torch
    from stp3_tpu_torch.training.trainer import Trainer
    from stp3_tpu_torch.utils.precision import pin_fp32_math
    pin_fp32_math()
    cpu = Trainer(tiny_cfg, device='cpu', seed=SEED)
    ref_cfg = tiny_cfg.clone()
    ref_cfg.PRECISION = 64
    batch, = synthetic_batches(tiny_cfg, 1, 'cpu')
    noise = torch.from_numpy(np.random.RandomState(SEED).randn(
        int(tiny_cfg.BATCHSIZE), 1, tiny_cfg.MODEL.DISTRIBUTION.LATENT_DIM).astype(np.float32))
    steps = {}
    for name, trainer in (
            ('float64', Trainer(ref_cfg, device='cpu', model=copy.deepcopy(cpu.model))),
            ('CUDA', Trainer(tiny_cfg, device=device, model=copy.deepcopy(cpu.model))),
            ('CPU', cpu)):
        outputs = []
        dev = trainer.device
        steps[name] = step_grads(trainer, {k: v.to(dev) for k, v in batch.items()},
                                 noise.to(dev), outputs) + (outputs,)
    loss_r, grads_r, outputs_r = steps.pop('float64')
    parts = []
    for name, (loss, grads, outputs) in steps.items():
        errs = {n: ((grads[n] - g).norm() / g.norm().clamp_min(1e-300)).item()
                for n, g in grads_r.items()}
        worst = max(errs, key=errs.get)
        median = float(np.median(list(errs.values())))
        flips = sum(int(((o > 0) != (r > 0)).sum()) for o, r in zip(outputs, outputs_r))
        parts.append(f'{name} fp32: median {median:.2e}, {sum(e >= 1e-3 for e in errs.values())} '
                     f'above 1e-3, worst {errs[worst]:.2e} ({worst}), {flips} sign flips')
        if name != 'CUDA':
            continue
        for key, want in loss_r.items():
            if not np.isclose(loss[key], want, rtol=1e-4, atol=1e-7):
                fail(f'train parity: loss {key} {loss[key]} on CUDA vs {want} in float64')
        if errs[worst] >= 1e-2 or median >= 1e-3:
            fail(f'train parity: CUDA gradients vs the float64 step: worst {worst} '
                 f'{errs[worst]:.3e} (limit 1e-2), median {median:.3e} (limit 1e-3)')
    say(f'[train parity] tiny step, {len(grads_r)} gradients against the float64 step on the '
        f'CPU (TF32 off); CUDA loss terms within rtol 1e-4, gradients within relative L2 1e-2 '
        f'and 1e-3 in the median. ' + '; '.join(parts))


def phase_train(cfg, device, card, tag: str = 'train', timed: int = 10, **want):
    """A stage's training at full width and batch cfg.BATCHSIZE from a
    seeded init on synthetic batches: one counted step (the launches in
    ``want``, by default K1, K3 and K2 twice), 2 warm-up and ``timed``
    timed steps; loss terms finite, most parameter tensors changed; the
    step p50, spread, samples/s and peak memory."""
    import torch
    from stp3_tpu_torch.training.trainer import Trainer
    want = want or dict(bev_splat=1, gather_rows=1, convnext_mlp=2)
    t0 = time.perf_counter()
    trainer = Trainer(cfg, device=device, seed=SEED)
    n_params = sum(p.numel() for p in trainer.model.parameters())
    batches = synthetic_batches(cfg, 2, device)
    b = int(cfg.BATCHSIZE)
    say(f'[{tag}] {cfg.TAG}: {n_params} fp32 master params, compute {trainer.compute_dtype}, '
        f'MODEL.NORM {cfg.MODEL.NORM!r}, REMAT {cfg.MODEL.REMAT!r}, batch {b}; built with 2 '
        f'synthetic batches in {time.perf_counter() - t0:.1f} s')
    before = [p.detach().clone() for p in trainer.model.parameters()]

    reset_launches()
    losses = [trainer.train_step(batches[0])]
    launches = read_launches()
    expect_launches(f'{tag}: one train step', launches, **want)
    say(f'[{tag}] launches in one train step: {launches}')

    for i in range(2):                                           # warm-up
        losses.append(trainer.train_step(batches[i % 2]))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(timed):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        losses.append(trainer.train_step(batches[i % 2]))
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for step, loss in enumerate(losses):
        bad = [k for k, v in loss.items() if not torch.isfinite(v).all()]
        if bad:
            fail(f'{tag} step {step}: loss terms {bad} are not finite')
    changed = sum(not torch.equal(a, p) for a, p in zip(before, trainer.model.parameters()))
    if changed < len(before) // 2:
        fail(f'{tag}: only {changed} of {len(before)} parameter tensors changed in '
             f'{len(losses)} steps')
    p50 = float(np.median(times))
    first, last = losses[0], losses[-1]
    say(f'[{tag}] {len(losses)} steps finite; {changed} of {len(before)} parameter tensors '
        f'changed; total loss {first["total"].item():.4f} -> {last["total"].item():.4f}; terms '
        f'of the last step {({k: round(v.item(), 4) for k, v in last.items()})}')
    say(f'[{tag}] step p50 {p50:.2f} ms (median of {timed}, CUDA events; spread '
        f'{min(times):.2f}-{max(times):.2f} ms), {b / p50 * 1e3:.3f} samples/s, peak memory '
        f'{peak:.2f} GiB, on {card}')
    return trainer, batches, launches


def running_stats(model) -> dict:
    """{name: copy} of every 'bn' site's running statistics."""
    from stp3_tpu_torch.layers.base import batch_norms
    return {f'{i}.{stat}': getattr(m, stat).detach().clone()
            for i, m in enumerate(batch_norms(model)) for stat in ('mean', 'var')}


def phase_perception_bn(cfg, device, card):
    """[perception bn]: the Perception stage under MODEL.NORM 'bn' (the
    reference's own stage-1 recipe, BN_MOMENTUM 0.05) at full width and
    batch 3, bf16 policy. From one seeded init and one batch, dropout off:
    the step under REMAT 'encoder' (whose backward recomputes the encoder)
    and under REMAT 'none' must leave the same running statistics: a
    second update in the recomputation would take a second momentum step,
    about as large as the step's own change, so the two may differ by at
    most 1e-2 of that change. Then the train step's p50 and peak memory,
    and an eval forward on the running statistics with finite heads.
    Returns the launches of one step."""
    import torch
    from stp3_tpu_torch.training.trainer import Trainer
    batches = synthetic_batches(cfg, 1, device)
    stats = {}
    for remat in ('encoder', 'none'):
        run_cfg = cfg.clone()
        run_cfg.MODEL.REMAT = remat
        trainer = Trainer(run_cfg, device=device, seed=SEED)
        start = running_stats(trainer.model)
        reset_launches()
        loss = trainer.train_step(batches[0], dropout=False)
        launches = read_launches()
        expect_launches(f'[perception bn] REMAT {remat!r} step', launches, bev_splat=1,
                        gather_rows=1)
        if not all(torch.isfinite(v).all() for v in loss.values()):
            fail(f'[perception bn] REMAT {remat!r}: a loss term is not finite')
        stats[remat] = running_stats(trainer.model)
        del trainer
        torch.cuda.empty_cache()
    change = max((stats['none'][k] - start[k]).abs().max().item() for k in start)
    diff = max((stats['encoder'][k] - stats['none'][k]).abs().max().item() for k in start)
    moved = sum(not torch.equal(stats['none'][k], start[k]) for k in start)
    say(f'[perception bn] {len(start) // 2} bn sites, {moved} of {len(start)} running '
        f'statistics moved in one step (dropout off); REMAT encoder vs none: max difference '
        f'{diff:.3e} against the step\'s own max change {change:.3e} (limit 1e-2 of it)')
    if not diff <= 1e-2 * change or moved < len(start) // 2:
        fail('[perception bn] the running statistics under REMAT encoder differ from REMAT '
             'none: the recomputation updated them again')
    trainer, batches, launches = phase_train(cfg, device, card, 'perception bn',
                                             bev_splat=1, gather_rows=1)
    if '--profile' in sys.argv[1:]:
        profile_train(trainer, batches, card, tag='perception bn')
    out, _ = trainer.val_forward(batches[0])
    for key in ('segmentation', 'pedestrian', 'hdmap'):
        if not torch.isfinite(out[key].float()).all():
            fail(f'[perception bn] eval forward on running statistics: {key} not finite')
    say(f'[perception bn] eval forward on the running statistics: heads finite, '
        f'{ {k: tuple(v.shape) for k, v in out.items() if v is not None} }')
    return launches


# the MODEL.REMAT tags of [remat]: 'encoder' (every shipped YAML's) first,
# then each other stage with it, and one composition
REMAT_TAGS = ('encoder', 'encoder+temporal', 'encoder+future', 'encoder+decoder',
              'encoder+cells', 'encoder+gates', 'encoder+temporal+decoder+cells')
# a tag's distance from the 'encoder' step may reach this multiple of the
# distance between 'encoder' steps themselves, or 1e-6, the larger: two runs
# of one bf16 step give bit-equal loss terms but gradients ~2% apart in the
# median on the card (the backward's atomic adds land in another order)
REMAT_MULTIPLE = 4.0
REMAT_FLOOR = 1e-6


def remat_trainer(cfg, remat: str, weights: dict, device):
    """A Trainer of ``cfg`` under MODEL.REMAT ``remat`` with ``weights``
    and the seeded generator."""
    from stp3_tpu_torch.models.stp3 import STP3, STP3Config
    from stp3_tpu_torch.training.trainer import Trainer
    run_cfg = cfg.clone()
    run_cfg.MODEL.REMAT = remat
    model = STP3(STP3Config.from_cfg(run_cfg))
    model.load_state_dict(weights)
    return Trainer(run_cfg, device=device, seed=SEED, model=model)


def remat_numbers(trainer, batch):
    """(loss terms, gradients) of one step without the update: dropout on,
    the latent drawn from the trainer's generator."""
    loss = trainer.compute_gradients(batch)
    return ({k: v.item() for k, v in loss.items()},
            {n: p.grad.detach().clone() for n, p in trainer.model.named_parameters()})


def remat_distance(got, want) -> dict:
    """The loss terms' largest relative difference; the gradients' median
    and worst relative L2 error (``grad_errors``)."""
    errs = grad_errors(got[1], want[1])
    return {'loss': max(abs(got[0][k] - v) / max(abs(v), 1e-12) for k, v in want[0].items()),
            'median': float(np.median(list(errs.values()))), 'worst': max(errs.values())}


def step_ms(trainer, batch):
    """(ms of one train step by CUDA events, its loss terms)."""
    import torch
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    loss = trainer.train_step(batch)
    end.record()
    end.synchronize()
    return start.elapsed_time(end), loss


def phase_remat(cfg, device, card, turns: int = 4) -> dict:
    """[remat]: the full-width Planning stage (batch 2, bf16 policy over fp32
    masters, seeded init, a synthetic batch) under each of ``REMAT_TAGS``.
    Each tag's step (dropout on, the latent from the seeded generator) from
    the same weights and batch: its loss terms and gradients against the
    'encoder' step's, within ``REMAT_MULTIPLE`` of the distance between
    'encoder' steps (the larger of two reruns); its launches (K1 and K3
    once, K2 twice, and twice more where 'future' or 'gates' recomputes
    the future stage: K2 is a ctypes launch, which no checkpoint policy
    sees, so it runs again in the recomputation). Then, after a warm-up,
    one train step's peak ``max_memory_allocated`` and ``turns`` pairs of
    train steps in turns with a resident 'encoder' trainer (CUDA events;
    the tag first in every other pair): each tag's p50 beside 'encoder''s
    of the same turns. Returns the launches of the counted steps, summed
    over the tags."""
    import torch
    from stp3_tpu_torch.training.trainer import Trainer
    weights = {k: v.detach().clone()
               for k, v in Trainer(cfg, device=device, seed=SEED).model.state_dict().items()}
    torch.cuda.empty_cache()
    batch, = synthetic_batches(cfg, 1, device)
    ref = remat_numbers(remat_trainer(cfg, 'encoder', weights, device), batch)
    reruns = []
    for _ in range(2):
        base = remat_trainer(cfg, 'encoder', weights, device)
        reruns.append(remat_distance(remat_numbers(base, batch), ref))
    yard = {m: max(r[m] for r in reruns) for m in reruns[0]}
    limit = {m: max(REMAT_MULTIPLE * v, REMAT_FLOOR) for m, v in yard.items()}
    base.train_step(batch)                            # the resident 'encoder' trainer
    say(f'[remat] {cfg.TAG}, batch {cfg.BATCHSIZE}, PRECISION {cfg.PRECISION} over fp32 '
        f'masters: {len(ref[1])} gradients; two \'encoder\' reruns against the first: loss '
        f'terms rel {yard["loss"]:.2e}, gradients median {yard["median"]:.2e}, worst '
        f'{yard["worst"]:.2e} (the yardstick); each tag may reach {REMAT_MULTIPLE:g}x it, or '
        f'{REMAT_FLOOR:g}')
    total = {name: 0 for name in counters()}
    rows = []
    for tag in REMAT_TAGS:
        trainer = remat_trainer(cfg, tag, weights, device)
        reset_launches()
        numbers = remat_numbers(trainer, batch)
        launches = read_launches()
        k2 = 4 if {'future', 'gates'} & set(tag.split('+')) else 2
        expect_launches(f'[remat] {tag!r} step', launches, bev_splat=1, gather_rows=1,
                        convnext_mlp=k2)
        for name, n in launches.items():
            total[name] += n
        if not all(np.isfinite(v) for v in numbers[0].values()):
            fail(f'[remat] {tag!r}: a loss term is not finite')
        dist = remat_distance(numbers, ref)
        del numbers
        over = [m for m in dist if dist[m] > limit[m]]
        if over:
            fail(f'[remat] {tag!r}: {over} beyond the limit: {dist} against {limit}')
        trainer.train_step(batch)                                    # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step_ms(trainer, batch)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        times = {'tag': [], 'encoder': []}
        for i in range(turns):
            order = (('tag', trainer), ('encoder', base))
            for name, tr in (order if i % 2 == 0 else order[::-1]):
                ms, loss = step_ms(tr, batch)
                times[name].append(ms)
                if not all(torch.isfinite(v).all() for v in loss.values()):
                    fail(f'[remat] {tag!r}: a loss term of a timed step is not finite')
        p50 = {k: float(np.median(v)) for k, v in times.items()}
        rows.append((tag, p50['tag'], p50['encoder'], peak))
        say(f'[remat] {tag}: step p50 {p50["tag"]:.2f} ms against the resident \'encoder\' '
            f'trainer\'s {p50["encoder"]:.2f} in the same {turns} turns (CUDA events; spread '
            f'{min(times["tag"]):.2f}-{max(times["tag"]):.2f} and '
            f'{min(times["encoder"]):.2f}-{max(times["encoder"]):.2f}), ratio '
            f'{p50["tag"] / p50["encoder"]:.3f}; peak memory {peak:.2f} GiB; launches '
            f'{launches}; against \'encoder\': loss rel {dist["loss"]:.2e}, gradients median '
            f'{dist["median"]:.2e}, worst {dist["worst"]:.2e}; on {card}')
        del trainer
        torch.cuda.empty_cache()
    base_peak = rows[0][3]
    say('[remat] against \'encoder\' (p50 ratio in turns, peak GiB difference): ' + '; '.join(
        f'{tag} {ms / enc:.3f}x, {peak - base_peak:+.2f} GiB' for tag, ms, enc, peak in rows)
        + '; the resident \'encoder\' trainer, the weights, the batch and the reference '
        f'gradients are in every peak; on {card}')
    del base
    torch.cuda.empty_cache()
    return total


def profile_train(trainer, batches, card, steps: int = 3, tag: str = 'train'):
    """Where a train step's time goes (--profile)."""
    import torch

    def timed(fn):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        return out, (start, end)

    parts = {'loss (labels, forward, losses)': [], 'backward': [], 'clip + Adam': [],
             'host issue of one step': []}
    for i in range(6):
        batch = batches[i % 2]
        trainer.optimizer.zero_grad(set_to_none=True)
        (total, _), ev_loss = timed(lambda: trainer.loss_fn(batch))
        _, ev_bwd = timed(total.backward)
        _, ev_opt = timed(lambda: (torch.nn.utils.clip_grad_norm_(
            trainer.model.parameters(), float(trainer.cfg.GRAD_NORM_CLIP)),
            trainer.optimizer.step()))
        torch.cuda.synchronize()
        for key, (a, b) in zip(parts, (ev_loss, ev_bwd, ev_opt)):
            parts[key].append(a.elapsed_time(b))
        t0 = time.perf_counter()
        trainer.train_step(batch)
        parts['host issue of one step'].append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    say(f'[profile] {tag} step, median of 6 (ms): ' + ', '.join(
        f'{k} {float(np.median(v)):.2f}' for k, v in parts.items()) + f'; on {card}')

    profile_window(lambda i: trainer.train_step(batches[i % 2]), f'{tag} step', card, steps,
                   top=15)


def finite_dict(d) -> bool:
    """Every value of a (nested) dict of arrays, tensors or numbers finite."""
    import torch
    for v in d.values():
        if isinstance(v, dict):
            if not finite_dict(v):
                return False
        elif isinstance(v, torch.Tensor):
            if not torch.isfinite(v.float()).all():
                return False
        elif not np.isfinite(np.asarray(v, np.float64)).all():
            return False
    return True


CLI_VIS_INTERVAL = 2


def phase_train_cli(device, card, repo: str):
    """[train_cli]: ``stp3_tpu_torch.train.run`` on the full-width Planning
    stage (batch 2, bf16 policy, REMAT 'encoder') over synthetic 'mini'
    data, with PROFILE.ENABLED (PROFILE.STEPS 2) and VIS_INTERVAL 2: one
    epoch of 5 train steps, validation on 4 samples (2 val forwards) and a
    checkpoint; then a resume from that checkpoint for a second epoch,
    whose step, Adam step and best IoU must continue from the saved ones.
    Launches per epoch: K1 once a train step and once a val forward, K3
    once a train step, K2 twice each; with the tensorboard package also a
    panel forward every VIS_INTERVAL steps (without it the CLI writes
    nothing and runs none). The profiler trace must hold exactly steps 2
    and 3 and name K1's, K3's and K2's kernels. Then ``cli_panels_and_nan_check``.
    Returns (the last checkpoint, the launches of the first epoch)."""
    import glob
    import importlib.util
    import shutil
    import torch
    from stp3_tpu_torch.train import run
    from stp3_tpu_torch.training import checkpoint as ckpt_lib
    cfg = make_cfg(PLANNING_STAGE, CLI_DATA, {'PROFILE': {'ENABLED': True, 'STEPS': 2},
                                              'VIS_INTERVAL': CLI_VIS_INTERVAL})
    save_dir = os.path.join(repo, 'build', 'chip_smoke', 'train_cli')
    shutil.rmtree(save_dir, ignore_errors=True)
    have = {m: importlib.util.find_spec(m) is not None
            for m in ('tensorboard', 'moviepy', 'matplotlib')}
    say('[train_cli] on this machine: ' + ', '.join(
        f'{m} {"present" if v else "absent"}' for m, v in have.items())
        + ' (without tensorboard the CLI writes no scalars or panels and runs no panel '
        'forward; add_video needs moviepy; the evaluation figures need matplotlib)')
    b = int(cfg.BATCHSIZE)
    steps, vals = 10 // b, -(-int(cfg.DATASET.VAL_SAMPLES) // b)

    def want(first_step):
        vis = sum(s % CLI_VIS_INTERVAL == 0 for s in range(first_step, first_step + steps)
                  ) if have['tensorboard'] else 0
        return dict(bev_splat=steps + vals + vis, gather_rows=steps,
                    convnext_mlp=2 * (steps + vals + vis))

    def log(msg):
        say(f'[train_cli] {msg}')

    reset_launches()
    first = run(cfg, device, save_dir, log=log)
    launches = read_launches()
    expect_launches(f'[train_cli] epoch 1 ({steps} train steps, {vals} val forwards)',
                    launches, **want(1))
    say(f'[train_cli] launches in epoch 1: {launches}')
    check_cli_trace(glob.glob(os.path.join(save_dir, 'profile', '*.pt.trace.json')), card)
    resume = cfg.clone()
    resume.EPOCHS = 2
    resume.CHECKPOINT.RESUME = first['last']
    reset_launches()
    second = run(resume, device, save_dir, log=log)
    expect_launches('[train_cli] the resumed epoch 2', read_launches(), **want(steps + 1))
    state = ckpt_lib.load_checkpoint(second['last'])
    adam = {int(s['step']) for s in state['optimizer']['state'].values()}
    meta = ckpt_lib.load_meta(second['last'])
    if (first['step'] != steps or second['start_step'] != steps or second['step'] != 2 * steps
            or state['step'] != 2 * steps or adam != {2 * steps}):
        fail(f'[train_cli] resume: steps {first["step"]} -> {second["start_step"]} -> '
             f'{second["step"]}, checkpoint step {state["step"]}, Adam steps {adam}')
    if (second['start_best_iou'] != first['best_iou'] or second['best_iou'] < first['best_iou']
            or meta['metrics']['best_iou'] != second['best_iou']):
        fail(f'[train_cli] resume: best IoU {first["best_iou"]} -> {second["start_best_iou"]} '
             f'-> {second["best_iou"]} (meta {meta["metrics"]})')
    for rec in (first, second):
        if not finite_dict(rec['loss']) or not finite_dict(rec['metrics']):
            fail('[train_cli] a loss term or a validation metric is not finite')
    say(f'[train_cli] resumed at step {second["start_step"]} with best IoU '
        f'{second["start_best_iou"]:.4f}; ended at step {second["step"]} (Adam step {adam}), '
        f'best IoU {second["best_iou"]:.4f}; format_version {meta["format_version"]}')

    path = os.path.join(second['last'], 'state.pt')
    t0 = time.perf_counter()
    loaded = ckpt_lib.load_checkpoint(second['last'], map_location=device)
    torch.cuda.synchronize()
    load_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    probe = ckpt_lib.save_checkpoint(os.path.join(save_dir, 'save_probe'), loaded['step'],
                                     loaded['model'], loaded['optimizer'], None,
                                     loaded['generator'])
    save_ms = (time.perf_counter() - t0) * 1e3
    same = all(torch.equal(a, loaded['model'][k].cpu()) for k, a in
               ckpt_lib.load_checkpoint(probe)['model'].items())
    if not same:
        fail('[train_cli] a checkpoint saved from the card does not read back bit for bit')
    train_ms, val_ms = first['train_ms'] + second['train_ms'], first['val_ms'] + second['val_ms']
    say(f'[train_cli] train step p50 {np.median(train_ms):.2f} ms (median of {len(train_ms)}, '
        f'CUDA events; spread {min(train_ms):.2f}-{max(train_ms):.2f}), '
        f'{b / np.median(train_ms) * 1e3:.3f} samples/s; val step (batch {b}) p50 '
        f'{np.median(val_ms):.2f} ms (median of {len(val_ms)}; spread {min(val_ms):.2f}-'
        f'{max(val_ms):.2f}); checkpoint {os.path.getsize(path)} B, load {load_ms:.1f} ms '
        f'(to the card), save {save_ms:.1f} ms (from the card); steps 2-3 ran under the '
        f'profiler; on {card}')
    cli_panels_and_nan_check(cfg, device, card)
    return second['last'], launches


# K1's, K3's and K2's CUDA kernels, by the names the trace gives them
TRACE_KERNELS = {'bev_splat': 'splat_tile_kernel', 'gather_rows': 'gather_rows_kernel',
                 'convnext_mlp': 'convnext_mlp_kernel'}


def check_cli_trace(paths: list, card: str) -> None:
    """PROFILE.ENABLED's trace: one file, whose train_step_<n> ranges are
    exactly steps 2 and 3 (the JAX CLI's window at PROFILE.STEPS 2), with
    K1's, K3's and K2's kernels among its device events."""
    import re
    if len(paths) != 1:
        fail(f'[train_cli] PROFILE.ENABLED: {len(paths)} trace files, expected one')
    with open(paths[0]) as f:
        events = json.load(f)['traceEvents']
    steps = sorted({int(m.group(1)) for e in events
                    for m in [re.fullmatch(r'train_step_(\d+)', str(e.get('name', '')))] if m})
    kernels = [e['name'] for e in events if e.get('cat') == 'kernel']
    counts = {name: sum(k in n for n in kernels) for name, k in TRACE_KERNELS.items()}
    if steps != [2, 3] or not all(counts.values()):
        fail(f'[train_cli] the profiler trace holds steps {steps} (expected [2, 3]) and our '
             f'kernels {counts}')
    say(f'[train_cli] PROFILE.ENABLED: {os.path.basename(paths[0])}, '
        f'{os.path.getsize(paths[0])} B, {len(events)} events, train steps {steps}, '
        f'{len(kernels)} device kernels, of them {counts} ours; on {card}')


def cli_panels_and_nan_check(cfg, device, card: str) -> None:
    """The train panels of the card's outputs, outside the CLI's guard:
    ``visualise_output`` of a full-width val forward is (T, 7*200, 2*200,
    3) uint8 of more than a few colours. Then DEBUG.NAN_CHECK: after a
    clean step, a batch with one camera image of NaNs raises
    FloatingPointError and leaves the parameters, Adam's state and the
    step count bit for bit as they were."""
    import torch
    from stp3_tpu_torch.training.trainer import Trainer
    from stp3_tpu_torch.utils.network import prepare_image
    from stp3_tpu_torch.utils.visualisation import visualise_output
    run_cfg = cfg.clone()
    run_cfg.DEBUG.NAN_CHECK = True
    trainer = Trainer(run_cfg, device=device, seed=SEED)
    batch, = synthetic_batches(run_cfg, 1, device)
    output, labels = trainer.val_forward(batch)
    t0 = time.perf_counter()
    panel = visualise_output(labels, output, run_cfg)
    vis_ms = (time.perf_counter() - t0) * 1e3
    t, (h, w) = labels['segmentation'].shape[1], labels['segmentation'].shape[2:]
    colours = len(np.unique(panel.reshape(-1, 3), axis=0))
    if panel.shape != (t, 7 * h, 2 * w, 3) or panel.dtype != np.uint8 or colours < 4:
        fail(f'[train_cli] panels {panel.shape} {panel.dtype}, {colours} colours')
    trainer.train_step(batch)
    params = [p.detach().clone() for p in trainer.model.parameters()]
    adam = {i: {k: v.clone() for k, v in st.items()}
            for i, st in trainer.optimizer.state_dict()['state'].items()}
    step = trainer.step
    bad = dict(batch)
    bad['image'] = prepare_image(batch['image'], torch.float32).clone()
    bad['image'][0, 0, 0] = float('nan')
    try:
        trainer.train_step(bad)
    except FloatingPointError as exc:
        message = str(exc)
    else:
        fail('[train_cli] DEBUG.NAN_CHECK: a NaN image did not raise FloatingPointError')
    after = trainer.optimizer.state_dict()['state']
    same = (trainer.step == step
            and all(torch.equal(a, p) for a, p in zip(params, trainer.model.parameters()))
            and all(torch.equal(after[i][k], v) for i, st in adam.items() for k, v in st.items()))
    if not same:
        fail('[train_cli] DEBUG.NAN_CHECK raised, but the parameters, Adam or the step moved')
    say(f'[train_cli] panels of the card\'s val forward: {panel.shape} uint8, {colours} '
        f'colours, {vis_ms:.0f} ms on the host; DEBUG.NAN_CHECK on a NaN camera image: '
        f'FloatingPointError ({message}); parameters, Adam state and step {step} unchanged bit '
        f'for bit; on {card}')
    del trainer
    torch.cuda.empty_cache()


def prediction_checkpoint(device, repo: str) -> str:
    """A checkpoint of the Prediction stage's seeded init (step 0) with the
    CLI data config, for [evaluate_prediction]."""
    import shutil
    from stp3_tpu_torch.training import checkpoint as ckpt_lib
    from stp3_tpu_torch.training.trainer import Trainer
    cfg = make_cfg(PREDICTION_STAGE, CLI_DATA)
    ckpt_dir = os.path.join(repo, 'build', 'chip_smoke', 'prediction', 'checkpoints')
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    os.makedirs(ckpt_dir)
    trainer = Trainer(cfg, device=device, seed=SEED)
    say(f'[evaluate_prediction] {cfg.TAG}: {sum(p.numel() for p in trainer.model.parameters())} '
        f'parameters, seeded init saved as step 0')
    return ckpt_lib.save_checkpoint(ckpt_dir, 0, trainer.model.state_dict(),
                                    cfg_dict=cfg.convert_to_dict())


def result_in_range(key: str, value: float) -> bool:
    if key.startswith('plan_L2'):
        return value >= 0
    return 0.0 <= value <= 1.0          # IoU, PQ / SQ / RQ, collision rates


def phase_evaluate(path: str, ckpt: str, device, card, keys) -> dict:
    """[evaluate_*]: ``stp3_tpu_torch.evaluate.evaluate`` on a checkpoint at
    batch 1 over the 4 validation samples: K1 once and K2 twice a sample;
    the result ``keys`` exactly, each finite and in its range. Returns the
    launches."""
    from stp3_tpu_torch.evaluate import evaluate
    stats = {}
    reset_launches()
    results = evaluate(ckpt, device, log=lambda msg: say(f'[{path}] {msg}'), stats=stats)
    launches = read_launches()
    n = stats['samples']
    expect_launches(f'[{path}] {n} samples', launches, bev_splat=n, convnext_mlp=2 * n)
    if sorted(results) != sorted(keys):
        fail(f'[{path}] result keys {sorted(results)}, expected {sorted(keys)}')
    bad = {k: v for k, v in results.items() if not (np.isfinite(v) and result_in_range(k, v))}
    if bad:
        fail(f'[{path}] results not finite or out of range: {bad}')
    say(f'[{path}] launches {launches}; {n} samples at batch 1 in {stats["seconds"]:.2f} s: '
        f'{n / stats["seconds"]:.3f} samples/s (metrics and host work included), forward to '
        f'the first result p50 {np.median(stats["forward_ms"]):.2f} ms; on {card}')
    return launches


def planning_result_keys(cfg) -> list:
    keys = ['vehicle_iou', 'pedestrian_iou'] + [
        f'{e}_iou' for e in cfg.SEMANTIC_SEG.HDMAP.ELEMENTS]
    return keys + [f'plan_{m}_{s + 1}s' for m in ('L2', 'obj_col', 'obj_box_col')
                   for s in range(cfg.N_FUTURE_FRAMES // 2)]


def wall_ms(fn, reps: int) -> float:
    import torch
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def eval_split(trainer, batch, tag: str, card) -> None:
    """Where a batch-1 evaluation forward's time goes with no loader
    threads beside it: ``val_forward`` (labels, the parameters' cast to
    the compute dtype, the forward and plan, the fp32 cast), its labels
    alone and the cast alone; wall clock, median of 5 (--profile: a
    torch.profiler window of 3 ``val_forward``)."""
    import torch
    from stp3_tpu_torch.utils.precision import cast_parameters
    full = wall_ms(lambda: trainer.val_forward(batch), 5)
    with torch.no_grad():
        labels = wall_ms(lambda: trainer.prepare_future_labels(batch), 5)
        cast = wall_ms(lambda: cast_parameters(trainer.model, trainer.compute_dtype), 5)
    say(f'[{tag}] val_forward at batch 1 alone {full:.2f} ms, of which labels {labels:.2f} ms '
        f'and the parameters\' cast to {trainer.compute_dtype} {cast:.2f} ms (wall clock, '
        f'median of 5); on {card}')
    if '--profile' in sys.argv[1:]:
        profile_window(lambda i: trainer.val_forward(batch), f'{tag} val_forward', card)


def phase_decode(ckpt: str, device, card):
    """[decode]: the Prediction stage's validation output at full width and
    batch 1 (the checkpoint's weights): the device decode
    (utils/instance_jit.py) against the host loop, id for id; both timed,
    and the Hungarian linking. Returns (trainer, its synthetic batch)."""
    from stp3_tpu_torch.evaluate import eval_cfg
    from stp3_tpu_torch.training import checkpoint as ckpt_lib
    from stp3_tpu_torch.training.trainer import Trainer
    from stp3_tpu_torch.utils.instance import predict_instance_segmentation_and_trajectories
    cfg = eval_cfg(ckpt)
    trainer = Trainer(cfg, device=device)
    trainer.model.load_state_dict(ckpt_lib.load_checkpoint(ckpt, map_location=device)['model'])
    batch, = synthetic_batches(cfg, 1, device)
    output, _ = trainer.val_forward(batch)

    def decode(jit_decode, consistent=False):
        return predict_instance_segmentation_and_trajectories(
            output, make_consistent=consistent, jit_decode=jit_decode)

    on_device, on_host = decode(True), decode(False)
    if on_device.shape != on_host.shape or not np.array_equal(on_device, on_host):
        fail(f'[decode] device decode differs from the host loop at '
             f'{np.count_nonzero(on_device != on_host)} of {on_host.size} pixels')
    per_frame = [int(f.max()) for f in on_device.reshape(-1, *on_device.shape[-2:])]
    dev_ms, host_ms = wall_ms(lambda: decode(True), 5), wall_ms(lambda: decode(False), 3)
    linked_ms = wall_ms(lambda: decode(True, True), 3)
    say(f'[decode] Prediction stage, {tuple(output["instance_center"].shape)} centers: the device '
        f'decode equals the host loop id for id (instances per frame {per_frame}); device '
        f'decode {dev_ms:.2f} ms (ids to the host included), host loop {host_ms:.2f} ms, device '
        f'decode + Hungarian linking {linked_ms:.2f} ms (wall clock, median); on {card}')
    eval_split(trainer, batch, 'decode', card)
    return trainer, batch


def phase_labels_as_prediction(pred_trainer, pred_batch, device, card):
    """[labels as prediction]: the metrics at full width on the labels fed
    back as the prediction, which needs no trained weights: the Planning
    stage's label classes into IoUMetric (vehicle, pedestrian, each HD-map
    element), its GT trajectory into PlanningMetric per second of
    horizon, and the Prediction stage's label instance ids into
    PanopticMetric. Every present class's IoU, PQ, SQ and RQ must be 1,
    with no false positive or negative; L2 0 and no collision. First the
    Planning stage's ``eval_split``."""
    import torch
    from stp3_tpu_torch.metrics import IoUMetric, PanopticMetric, PlanningMetric
    from stp3_tpu_torch.training.trainer import Trainer
    cfg = make_cfg(PLANNING_STAGE, CLI_DATA)
    trainer = Trainer(cfg, device=device, seed=SEED)
    batch, = synthetic_batches(cfg, 1, device)
    eval_split(trainer, batch, 'labels as prediction', card)
    labels = trainer.prepare_future_labels(batch)
    rf = cfg.TIME_RECEPTIVE_FIELD
    ious = {}
    for name, lab in (('vehicle', labels['segmentation'][:, rf - 1:]),
                      ('pedestrian', labels['pedestrian'][:, rf - 1:]),
                      *((e, labels['hdmap'][..., i])
                        for i, e in enumerate(cfg.SEMANTIC_SEG.HDMAP.ELEMENTS))):
        metric = IoUMetric(2)
        metric.update(lab, lab)
        score, st = metric.compute(), metric.state
        present = st['support'] > 0
        if st['fp'].any() or st['fn'].any() or not (score[present] == 1.0).all():
            fail(f'[labels as prediction] IoU {name}: {score}, state {st}')
        ious[name] = score.tolist()
    occupancy = torch.logical_or(labels['segmentation'][:, rf:], labels['pedestrian'][:, rf:])
    gt = labels['gt_trajectory']
    plan = {}
    for i in range(cfg.N_FUTURE_FRAMES // 2):
        t = 2 * (i + 1)
        metric = PlanningMetric(cfg, t)
        metric.update(gt[:, 1:t + 1], gt[:, 1:t + 1], occupancy[:, :t])
        res = metric.compute()
        if res['L2'].any() or res['obj_col'].any() or res['obj_box_col'].any():
            fail(f'[labels as prediction] planning {t} frames: {res}')
        plan[f'{i + 1}s'] = {k: float(v.mean()) for k, v in res.items()}
    inst = pred_trainer.prepare_future_labels(pred_batch)['instance'][:, pred_trainer.rf - 1:]
    pan = PanopticMetric(2)
    pan.update(inst, inst)
    res = pan.compute()
    if (pan.state['false_positive'].any() or pan.state['false_negative'].any()
            or not all(res[k][1] == 1.0 for k in ('pq', 'sq', 'rq'))):
        fail(f'[labels as prediction] panoptic {res}, state {pan.state}')
    say(f'[labels as prediction] IoU {ious}; planning {plan}; panoptic '
        f'{ {k: v.tolist() for k, v in res.items()} } over '
        f'{int(pan.state["true_positive"][1])} vehicle instances; no false positive or negative')


def reference_state_dict(mcfg, seed: int = SEED) -> dict:
    """A reference-format state_dict of ``mcfg`` (a models.stp3.STP3Config)
    from ``seed``: the port's ``synthesize_state_dict``, then every BN
    running variance drawn from [0.5, 1.5] and every other vector or scalar
    the init leaves constant (biases, BN scales, running means, layer
    scales, the GRU biases, the uncertainty weights) moved off its constant,
    so that a swapped mean and variance, a transposed kernel or a bias in
    the wrong place changes the outputs."""
    from stp3_tpu_torch.utils import torch_import as ti
    sd = ti.synthesize_state_dict(mcfg, seed)
    rng = np.random.RandomState(seed)
    for key, value in sd.items():
        if key.endswith('.running_var'):
            sd[key] = rng.uniform(0.5, 1.5, value.shape).astype(np.float32)
        elif value.ndim <= 1 and np.all(value == value.flat[0]):
            sd[key] = (value + 0.1 * rng.randn(*value.shape)).astype(np.float32)
    return sd


def grid_constants(mcfg) -> dict:
    """The grid buffers a reference checkpoint carries (``model.frustum``,
    ``model.bev_*``), from the port's geometry."""
    from stp3_tpu_torch.ops.geometry import calculate_birds_eye_view_parameters, create_frustum
    res, start, dim = calculate_birds_eye_view_parameters(mcfg.x_bound, mcfg.y_bound,
                                                          mcfg.z_bound)
    return {'model.bev_resolution': res, 'model.bev_start_position': start,
            'model.bev_dimension': dim,
            'model.frustum': create_frustum(mcfg.final_dim, mcfg.encoder_downsample,
                                            mcfg.d_bound).astype(np.float32)}


def write_reference_checkpoint(cfg, path: str, seed: int = SEED):
    """Write a Lightning-style .ckpt of ``cfg`` to ``path``: {'state_dict':
    {'model.*': tensor}, 'hyper_parameters': the config as a plain dict,
    ...}, with the bookkeeping entries a reference file carries
    (``num_batches_tracked`` beside every BN, ``model.frustum``,
    ``model.bev_*``). Returns (the model's state_dict as numpy, the
    bookkeeping keys)."""
    import torch
    from stp3_tpu_torch.models.stp3 import STP3Config
    mcfg = STP3Config.from_cfg(cfg)
    sd = reference_state_dict(mcfg, seed)
    extra = grid_constants(mcfg)
    extra.update({k[:-len('running_mean')] + 'num_batches_tracked': np.asarray(7, np.int64)
                  for k in sd if k.endswith('.running_mean')})
    state_dict = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in {**sd, **extra}.items()}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({'state_dict': state_dict, 'hyper_parameters': cfg.convert_to_dict(),
                'epoch': 19, 'global_step': 1000}, path)
    return sd, sorted(extra)


def gru_fold(sd: dict, key: str):
    """The planner GRU's (bias_ih, bias_hh) as export writes them after an
    import: the r / z parts of bias_hh folded into bias_ih, zeros left."""
    bih, bhh = sd[f'{key}.bias_ih'], sd[f'{key}.bias_hh']
    h = bhh.shape[0] // 3
    return (np.concatenate([bih[:2 * h] + bhh[:2 * h], bih[2 * h:]]),
            np.concatenate([np.zeros(2 * h, np.float32), bhh[2 * h:]]))


def check_export(sd: dict, bookkeeping, exported: dict, cfg) -> int:
    """Fail unless ``exported`` (the state_dict of an exported .ckpt) holds
    every tensor of ``sd`` bit for bit, the planner GRU's biases as their
    fold, and the bookkeeping entries rebuilt. Returns the tensors checked."""
    import torch
    from stp3_tpu_torch.models.stp3 import STP3Config
    if sorted(exported) != sorted(set(sd) | set(bookkeeping)):
        fail(f'export: keys differ: {sorted(set(exported) ^ set(sd) ^ set(bookkeeping))[:6]}')
    want = dict(sd)
    gru = 'model.planning.GRU'
    if f'{gru}.bias_ih' in sd:
        want[f'{gru}.bias_ih'], want[f'{gru}.bias_hh'] = gru_fold(sd, gru)
    want.update(grid_constants(STP3Config.from_cfg(cfg)))
    want.update({k: np.zeros((), np.int64) for k in bookkeeping if 'num_batches_tracked' in k})
    bad = [k for k, v in want.items()
           if not torch.equal(exported[k], torch.from_numpy(np.ascontiguousarray(v)))]
    if bad:
        fail(f'export: {len(bad)} tensors do not come back bit for bit, e.g. {bad[:4]}')
    return len(want)


def phase_reference_import(device, card, repo: str, cfg=None) -> dict:
    """[reference_import]: a reference-format Lightning .ckpt of the
    nuScenes Planning stage at full width (seeded, the config as plain
    hyper_parameters), imported with ``import_torch_checkpoint`` (an ok()
    report, only the bookkeeping ignored), evaluated with
    ``stp3_tpu_torch.evaluate.evaluate`` on the card at batch 1 as
    [evaluate_planning] is (K1 once and K2 twice a sample), then exported
    with ``export_torch_checkpoint`` and held to the input bit for bit (the
    planner GRU's r / z biases to their fold). Returns the evaluation's
    launches."""
    import shutil
    import torch
    from stp3_tpu_torch.scripts.export_torch_checkpoint import export_checkpoint
    from stp3_tpu_torch.scripts.import_torch_checkpoint import import_checkpoint
    cfg = cfg if cfg is not None else make_cfg(PLANNING_STAGE, CLI_DATA)
    root = os.path.join(repo, 'build', 'chip_smoke', 'reference_import')
    shutil.rmtree(root, ignore_errors=True)
    ckpt = os.path.join(root, 'reference.ckpt')
    sd, bookkeeping = write_reference_checkpoint(cfg, ckpt)
    n_bytes = sum(v.nbytes for v in sd.values())

    def log(msg):
        say(f'[reference_import] {msg}')

    t0 = time.perf_counter()
    path, report = import_checkpoint(ckpt, os.path.join(root, 'imported'), log=log)
    import_s = time.perf_counter() - t0
    if not report.ok() or report.ignored != bookkeeping:
        fail(f'[reference_import] report: missing {report.missing[:4]}, unexpected '
             f'{report.unexpected[:4]}, ignored beyond the bookkeeping '
             f'{sorted(set(report.ignored) ^ set(bookkeeping))[:4]}')
    launches = phase_evaluate('reference_import', path, device, card, planning_result_keys(cfg))
    t0 = time.perf_counter()
    export_checkpoint(path, os.path.join(root, 'exported.ckpt'), log=log)
    export_s = time.perf_counter() - t0
    exported = torch.load(os.path.join(root, 'exported.ckpt'), map_location='cpu',
                          weights_only=True)['state_dict']
    n = check_export(sd, bookkeeping, exported, cfg)
    say(f'[reference_import] {cfg.TAG}: {len(sd)} model tensors, {n_bytes} B '
        f'({sum(v.size for v in sd.values())} values) + {len(bookkeeping)} bookkeeping entries; '
        f'import {import_s:.2f} s, export {export_s:.2f} s (wall clock, host); report ok, '
        f'{report.converted} leaves, only the bookkeeping ignored; the export gives back all '
        f'{n} tensors bit for bit (the planner GRU\'s r / z biases as their fold); on {card}')
    return launches


def bgra_tick(t: int, frame: dict, theta: float) -> dict:
    """One leaderboard sensor tick of a recorded frame: 300x400 BGRA
    cameras, gps (lat, lon, alt) 2 m further north each tick, speed 3 m/s,
    the compass last in the imu."""
    from stp3_tpu_torch.deploy.control import RoutePlanner
    data = {key: (t, np.concatenate([img[..., ::-1], np.full(img.shape[:2] + (1,), 255,
                                                             np.uint8)], -1))
            for key, img in frame.items()}
    data['gps'] = (t, np.array([2.0 * t / RoutePlanner.SCALE[0], 0.0, 0.0]))
    data['speed'] = (t, {'speed': 3.0})
    data['imu'] = (t, np.array([0.0] * 6 + [theta]))
    return data


# the harness's route: north along the ticks' gps, then a turn
AGENT_ROUTE = [({'lat': 0.0, 'lon': 0.0}, 4), ({'lat': 2e-4, 'lon': 0.0}, 4),
               ({'lat': 6e-4, 'lon': 1e-4}, 1)]


def record_selection(model, sink: dict) -> None:
    """Wrap ``model.planner.select`` to append the index of the candidate it
    selects (B,) to ``sink['picks']`` (a measurement; nothing else changes)."""
    select = model.planner.select

    def recording(trajs, *args):
        final = select(trajs, *args)
        sink['picks'].append((trajs == final[:, None]).flatten(2).all(-1).int().argmax(-1))
        return final
    model.planner.select = recording


def drive_harness(agent, n_ticks: int):
    """``run_step`` over ``n_ticks`` recorded ticks (the sampler's module RNG
    seeded before each): the controls, each planned tick's wall ms, and
    the launches of the planned ticks after the first two."""
    controls, tick_ms = [], []
    for t, (frame, _, theta) in enumerate(recorded_ticks(n_ticks)):
        data = bgra_tick(t, frame, theta)
        if len(tick_ms) == 2:
            reset_launches()
        np.random.seed(SEED + t)
        t0 = time.perf_counter()
        controls.append(agent.run_step(data, t))
        if agent.core.warmed_up:
            tick_ms.append((time.perf_counter() - t0) * 1e3)
    return controls, tick_ms, read_launches()


def drive_core(core, n_ticks: int):
    """The same ticks into an ``AgentCore`` directly: RGB frames, the
    position, command and local target computed here as the leaderboard
    glue does (reference carla_agent.py), zero control while warming up."""
    from stp3_tpu_torch.deploy.control import RoutePlanner
    route = RoutePlanner(1.0, 50.0)
    route.set_route(AGENT_ROUTE, True)
    controls = []
    for t, (frame, _, theta) in enumerate(recorded_ticks(n_ticks)):
        gps = np.array([2.0 * t / RoutePlanner.SCALE[0], 0.0])
        pos = (gps - route.mean) * route.scale
        wp, cmd = route.run_step(pos)
        c, s_ = np.cos(theta + np.pi / 2), np.sin(theta + np.pi / 2)
        local = np.array([[c, -s_], [s_, c]]).T @ (wp - pos) * [1.0, -1.0]
        core.push_frame(frame, pos, theta)
        np.random.seed(SEED + t)
        if not core.warmed_up:
            controls.append((0.0, 0.0, 0.0))
            continue
        steer, throttle, brake, _ = core.plan_step(3.0, cmd, local)
        brake = float(brake)
        controls.append((steer, throttle, 0.0 if brake < 0.05 or throttle > brake else brake))
    return controls


def phase_carla_agent(device, card, repo: str, agent_per_tick: dict, agent_p50: dict,
                      cfg=None) -> dict:
    """[carla_agent]: a reference-format .ckpt of the CARLA Planning stage
    at full width, imported (PLANNING.CAM_FRONT_PARITY set: the rig's front
    camera is at index 0), driven through the harness ``STP3Agent`` on the
    card over the recorded ticks as BGRA sensor data: warm-up ticks zero,
    planned ticks equal (1e-5, deterministic algorithms) to an
    ``AgentCore`` on the same loaded model fed the RGB frames, launches
    per tick as [agent]'s default (static)
    mode; the harness tick p50 beside [agent]'s plan_step p50. Then the
    harness with the model cast to bf16: its tick p50 and how many planned
    ticks select another candidate than fp32 (a measurement). Returns the
    launches of the 20 timed fp32 ticks."""
    import shutil
    import torch
    from stp3_tpu_torch.carla_agent import STP3Agent
    from stp3_tpu_torch.deploy.agent_core import AgentCore
    from stp3_tpu_torch.scripts.import_torch_checkpoint import CAM_FRONT_NOTE, import_checkpoint
    from stp3_tpu_torch.training import checkpoint as ckpt_lib
    cfg = cfg if cfg is not None else carla_planning_cfg()
    root = os.path.join(repo, 'build', 'chip_smoke', 'carla_agent')
    shutil.rmtree(root, ignore_errors=True)
    ckpt = os.path.join(root, 'reference.ckpt')
    write_reference_checkpoint(cfg, ckpt)
    notes = []

    def log(msg):
        notes.append(msg)
        say(f'[carla_agent] {msg}')

    path, report = import_checkpoint(ckpt, os.path.join(root, 'imported'), log=log)
    if not report.ok() or CAM_FRONT_NOTE not in notes or not ckpt_lib.load_config_dict(
            path)['PLANNING']['CAM_FRONT_PARITY']:
        fail(f'[carla_agent] import: report ok {report.ok()}, CAM_FRONT_PARITY not set and '
             f'printed for the rig {list(cfg.IMAGE.NAMES)}')

    rf, n_timed = cfg.TIME_RECEPTIVE_FIELD, 20
    n_ticks = rf + 3 + n_timed
    agent = STP3Agent()
    agent.setup(path)
    if agent.core.device.type != device.type or agent.core.model.cfg.cam_front_index != 1:
        fail(f'[carla_agent] the harness runs on {agent.core.device}, planner camera '
             f'{agent.core.model.cfg.cam_front_index}')
    agent.set_global_plan(AGENT_ROUTE)
    sink = {'picks': []}
    record_selection(agent.core.model, sink)
    controls, tick_ms, launches = drive_harness(agent, n_ticks)
    picks = {'fp32': list(sink['picks'])}
    per = {name: n / n_timed for name, n in launches.items()}
    expect_launches('[carla_agent] harness tick', per,
                    **{k: v for k, v in agent_per_tick['static'].items() if v})
    n_warm = len(controls) - len(tick_ms)
    zero = {'steer': 0.0, 'throttle': 0.0, 'brake': 0.0}
    if len(tick_ms) != 2 + n_timed or n_warm != rf + 1 or any(c != zero for c in controls[:n_warm]):
        fail(f'[carla_agent] {len(controls)} ticks, {len(tick_ms)} planned, warm-up controls '
             f'{controls[:n_warm]}')
    core = AgentCore(agent.cfg, agent.core.model, device=device)
    sink['picks'] = []                        # (after the core's warm-up plan)
    direct = drive_core(core, n_ticks)
    got = np.array([[c['steer'], c['throttle'], c['brake']] for c in controls], np.float64)
    spread = float(np.abs(got - np.array(direct, np.float64)).max())
    flips_nd = sum(a != b for a, b in zip(torch.cat(picks['fp32']).tolist(),
                                          torch.cat(sink['picks']).tolist()))
    # the comparison itself with deterministic algorithms: two runs of the same
    # ticks on the card differ by the order of their fp32 atomic adds (the
    # column splat's index_add_), which the line above shows
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        agent_d = STP3Agent()
        agent_d.setup(path)
        agent_d.set_global_plan(AGENT_ROUTE)
        controls_d, _, _ = drive_harness(agent_d, n_ticks)
        direct_d = drive_core(AgentCore(agent_d.cfg, agent_d.core.model, device=device), n_ticks)
    finally:
        torch.use_deterministic_algorithms(False)
    got_d = np.array([[c['steer'], c['throttle'], c['brake']] for c in controls_d], np.float64)
    err = float(np.abs(got_d - np.array(direct_d, np.float64)).max())
    if err > 1e-5 or controls_d[:n_warm] != controls[:n_warm]:
        fail(f'[carla_agent] harness controls differ from a direct AgentCore by {err:.3e} '
             f'(deterministic algorithms)')
    say(f'[carla_agent] harness: {n_warm} warm-up ticks of zero control, {len(tick_ms)} planned '
        f'ticks equal to a direct AgentCore on the same model within {err:.3e} (tolerance '
        f'1e-5, deterministic algorithms; without them the two runs differ by {spread:.3e}, '
        f'{flips_nd} of {len(tick_ms)} ticks selecting another candidate: the atomics\' '
        f'order); launches per tick {({k: v for k, v in per.items() if v})} as [agent] '
        f'static; harness tick p50 {np.median(tick_ms[2:]):.2f} ms (median of {n_timed}, wall '
        f'clock: push_frame with the BGRA flip, the route planner and plan_step; spread '
        f'{min(tick_ms[2:]):.2f}-{max(tick_ms[2:]):.2f}) beside [agent] static plan_step p50 '
        f'{agent_p50["static"]:.2f} ms; on {card}')

    # the same harness with the imported model cast to bf16 (AgentCore runs in
    # its weights' dtype): a measurement, no option of the harness
    agent16 = STP3Agent()
    agent16.setup(path)
    agent16.core = AgentCore(agent16.cfg, agent16.core.model.to(torch.bfloat16), device=device)
    agent16.set_global_plan(AGENT_ROUTE)
    sink = {'picks': []}
    record_selection(agent16.core.model, sink)
    controls16, tick16_ms, launches16 = drive_harness(agent16, n_ticks)
    picks['bf16'] = sink['picks']
    if len(tick16_ms) != 2 + n_timed or not all(
            np.isfinite([c['steer'], c['throttle']]).all() for c in controls16):
        fail(f'[carla_agent] bf16 harness: {len(tick16_ms)} planned ticks, controls {controls16}')
    sel = {k: torch.cat(v).tolist()[2:] for k, v in picks.items()}
    flips = sum(a != b for a, b in zip(sel['fp32'], sel['bf16']))
    d_steer = float(np.abs(np.array([c['steer'] for c in controls16[-n_timed:]])
                           - got[-n_timed:, 0]).max())
    say(f'[carla_agent] bf16 harness: tick p50 {np.median(tick16_ms[2:]):.2f} ms (median of '
        f'{n_timed}; spread {min(tick16_ms[2:]):.2f}-{max(tick16_ms[2:]):.2f}) against fp32\'s '
        f'{np.median(tick_ms[2:]):.2f} ms; {flips} of {n_timed} planned ticks select another '
        f'candidate than fp32 (indices fp32 {sel["fp32"]}, bf16 {sel["bf16"]}); steer differs '
        f'by up to {d_steer:.3e}; launches per tick '
        f'{ {k: v / n_timed for k, v in launches16.items() if v} }; on {card}')
    return launches


# the real-data paths: nuScenes' Planning stage with the depth label, and
# CARLA's, each over its PIL-free stand-in tree (tests/torch_fake_datasets.py)
NUSCENES_DATA = {'DATASET': {'NAME': 'nuscenes', 'VERSION': 'mini'},
                 'LIFT': {'GT_DEPTH': True}, 'WORKER_KIND': 'process'}
CARLA_DATA = {'DATASET': {'NAME': 'carla'}, 'WORKER_KIND': 'process'}


def fake_datasets(repo: str):
    """tests/torch_fake_datasets.py (no PIL, no cv2, no JAX), importable by
    this process and by the loaders' spawned workers."""
    tests = os.path.join(repo, 'tests')
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import torch_fake_datasets
    return torch_fake_datasets


def phase_image_io(repo: str, card: str) -> None:
    """[image_io]: the host C codec (csrc/image_codec.c, built with cc):
    the committed 1600x900 camera fixture decoded to the SHA-256 of
    Pillow's decode stored beside it, and its nuScenes resize (bilinear,
    0.3) + crop to the SHA-256 of Pillow's; PNGs of every mode written with
    every row filter read back exactly; the resampler against its numpy
    plain version; the host's wall-clock ms of a decode and of a resize +
    crop."""
    import hashlib
    from stp3_tpu_torch.datas.nuscenes_data import resize_and_crop_image
    from stp3_tpu_torch.utils import image_io
    fake = fake_datasets(repo)
    info = image_io.load()
    say(f"[image_io] image_codec.c {'built' if info['built'] else 'reused'} in "
        f"{info['seconds']:.2f} s -> {os.path.relpath(info['path'], repo)}")
    meta = fake.camera_meta()
    img = image_io.read_jpeg(fake.CAMERA_JPEG)
    digest = hashlib.sha256(img.tobytes()).hexdigest()
    if list(img.shape) != meta['decode']['shape'] or digest != meta['decode']['sha256']:
        fail(f'[image_io] the fixture decodes to {img.shape} {digest}, Pillow to '
             f"{meta['decode']}")
    key = 'resize_bilinear_480x270_crop_0_46_480_270'
    crop = resize_and_crop_image(img, (480, 270), (0, 46, 480, 270))
    if hashlib.sha256(crop.tobytes()).hexdigest() != meta[key]['sha256']:
        fail('[image_io] the resize + crop of the fixture differs from Pillow\'s')
    rng = np.random.RandomState(SEED)
    shapes = {'L': (300, 400), 'P': (300, 400), 'LA': (300, 400, 2), 'RGB': (300, 400, 3),
              'RGBA': (300, 400, 4)}
    for mode, shape in shapes.items():
        arr = rng.randint(0, 256, shape, np.uint8)
        got, got_mode = image_io.decode_png(fake.png_bytes(arr, mode))
        if got_mode != mode or not np.array_equal(got, arr):
            fail(f'[image_io] a {mode} PNG does not read back exactly')
    for size, filt in (((480, 270), 'bilinear'), ((232, 232), 'nearest'), ((363, 272), 'bicubic')):
        src = img if filt != 'nearest' else img[:256, :256, 0]
        if not np.array_equal(image_io.resample(src, size, filt),
                              image_io.resample_plain(src, size, filt)):
            fail(f'[image_io] {filt} resample to {size} differs from its plain version')
    data = image_io.read_bytes(fake.CAMERA_JPEG)
    decode_ms = wall_ms(lambda: image_io.decode_jpeg(data), 10)
    resize_ms = wall_ms(lambda: resize_and_crop_image(img, (480, 270), (0, 46, 480, 270)),
                               10)
    say(f'[image_io] the 1600x900 fixture decodes to Pillow\'s SHA-256 and its resize + crop to '
        f'Pillow\'s; PNGs L / P / LA / RGB / RGBA with all five row filters read back exactly; '
        f'bilinear, nearest and bicubic equal their plain versions. Host wall clock (median of '
        f'10): {decode_ms:.2f} ms a 1600x900 decode, {resize_ms:.2f} ms a resize to 480x270 + '
        f'crop, on {os.cpu_count()} host cores beside {card}')


def phase_dataset(tag: str, cfg, device, card: str, epochs: int = 2) -> dict:
    """[nuscenes_data] / [carla_data]: a stage's training on its dataset
    class through ``prepare_dataloaders``: ms per ``__getitem__`` (median
    of 4, in this process), the loader's samples/s with cfg.N_WORKERS
    process workers (an epoch without training, after one that starts the
    pool), then ``epochs`` epochs of train steps on the loader's batches
    (launches counted over them; every loss term finite), the step p50
    beside the loader's rate. Returns the launches."""
    import torch
    from stp3_tpu_torch.datas.dataloaders import prepare_dataloaders
    from stp3_tpu_torch.training.trainer import Trainer, batch_to_device
    t0 = time.perf_counter()
    trainloader, valloader, traindata, _ = prepare_dataloaders(cfg, return_dataset=True)
    try:
        n, b, workers = len(traindata), int(cfg.BATCHSIZE), int(cfg.N_WORKERS)
        if len(trainloader) < 3:
            fail(f'[{tag}] {n} training samples: too few for the train steps')
        get_ms = wall_ms(lambda: traindata[0], 4)
        sample = traindata[0]
        say(f'[{tag}] {type(traindata).__name__}: {n} training samples, built in '
            f'{time.perf_counter() - t0:.2f} s; a sample: ' + ', '.join(
                f'{k} {tuple(v.shape)} {v.dtype}' for k, v in sample.items()
                if k in ('image', 'depths', 'segmentation', 'hdmap', 'sample_trajectory')))
        t0 = time.perf_counter()
        for _ in trainloader:                                       # starts the pool
            pass
        first_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        count = sum(int(batch['image'].shape[0]) for batch in trainloader)
        loader_s = time.perf_counter() - t0
        rate = count / loader_s
        say(f'[{tag}] __getitem__ {get_ms:.1f} ms (median of 4, one process); the loader with '
            f'{workers} process workers: {rate:.2f} samples/s ({count} samples in '
            f'{loader_s:.2f} s, its first epoch with the pool\'s start {first_s:.2f} s), on '
            f'{os.cpu_count()} host cores')

        trainer = Trainer(cfg, device=device, seed=SEED)
        times, losses = [], []
        t0 = time.perf_counter()
        reset_launches()
        for _ in range(epochs):
            for batch in trainloader:
                batch = batch_to_device(batch, device)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                losses.append(trainer.train_step(batch))
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
        launches = read_launches()
        loop_s = time.perf_counter() - t0
        steps = len(times)
        expect_launches(f'[{tag}] {steps} train steps', launches, bev_splat=steps,
                        gather_rows=steps, convnext_mlp=2 * steps)
        for i, loss in enumerate(losses):
            bad = [k for k, v in loss.items() if not torch.isfinite(v).all()]
            if bad:
                fail(f'[{tag}] step {i}: loss terms {bad} are not finite')
        if cfg.LIFT.GT_DEPTH and 'depths' not in losses[-1]:
            fail(f'[{tag}] GT_DEPTH is on but the step has no depth loss')
        p50 = float(np.median(times[1:]))
        feeds = rate >= b / p50 * 1e3
        say(f'[{tag}] {steps} train steps on the loader\'s batches, every loss term finite '
            f'({", ".join(sorted(losses[-1]))}); launches {launches}; step p50 {p50:.2f} ms '
            f'(median of the {steps - 1} after the first, CUDA events; spread '
            f'{min(times):.2f}-{max(times):.2f}), {b / p50 * 1e3:.3f} samples/s against the '
            f'loader\'s {rate:.2f}: the loader {"can" if feeds else "cannot"} feed the card; the '
            f'loop (loader, copies, steps) {steps * b / loop_s:.3f} samples/s; on {card}')
        del trainer
        torch.cuda.empty_cache()
        return launches
    finally:
        trainloader.close()
        valloader.close()


def phase_real_data(repo: str, device, card: str) -> dict:
    """The stand-in trees under build/chip_smoke/, then [nuscenes_data]
    (the Planning stage with LIFT.GT_DEPTH: 6 cameras at 1600x900 -> 224x480,
    3 past and 6 future frames, the 200x200 BEV; 'mini': 10 windows) and
    [carla_data] (CARLA's Planning stage: 4 cameras at 400x300 -> 256, the
    topdown labels at scale 1.1, the hdmap PNGs; 10 training windows).
    Returns their launches."""
    import shutil
    fake = fake_datasets(repo)
    root = os.path.join(repo, 'build', 'chip_smoke', 'data')
    shutil.rmtree(root, ignore_errors=True)
    nusc_root, carla_root = os.path.join(root, 'nuscenes'), os.path.join(root, 'carla')
    t0 = time.perf_counter()
    fake.install(n_samples=18)                     # 18 samples: 10 windows of 3 + 6
    fake.write_carla_route(carla_root, n_frames=17, town='Town01_tiny')
    fake.write_carla_route(carla_root, n_frames=9, town='Town05_short')
    say(f'[real data] stand-in trees written in {time.perf_counter() - t0:.2f} s')
    launches = {}
    cfg = make_cfg(PLANNING_STAGE, NUSCENES_DATA,
                   {'DATASET': {'DATAROOT': nusc_root, 'MAP_FOLDER': nusc_root}})
    launches['nuscenes_data'] = phase_dataset('nuscenes_data', cfg, device, card)
    cfg = make_cfg(CARLA_PLANNING, CARLA_DATA, {'DATASET': {'DATAROOT': carla_root}})
    launches['carla_data'] = phase_dataset('carla_data', cfg, device, card)
    return launches


# ------------------------------------------------- data and camera parallel
# the multi-rank phases share the one card over gloo (NCCL refuses two
# ranks on one device); [dp nccl] runs NCCL at world 1 in this process
RANKS_TIMEOUT_S = 420
DP_WORLD = 2
CAM_WORLD = 3


def grad_errors(grads: dict, want: dict) -> dict:
    """Each gradient's L2 error against ``want``'s, relative to its norm or
    to 1e-4 of the largest gradient's norm, the larger: a gradient that is
    zero but for rounding (a 'bn' bias whose output feeds another 'bn')
    is held to that floor, not to its own rounding."""
    floor = 1e-4 * max(g.double().norm().item() for g in want.values())
    return {n: ((grads[n].double() - g.double()).norm().item()
                / max(g.double().norm().item(), floor)) for n, g in want.items()}


def stats_error(stats: dict, want: dict) -> float:
    """The largest difference of the 'bn' running statistics, over the
    largest running variance: a running mean near zero (a 'bn' after a
    bias-free linear map of a normalised input) has no relative error."""
    if not want:
        return 0.0
    scale = max(v.abs().max().item() for k, v in want.items() if k.endswith('var'))
    return max((stats[k] - v).abs().max().item() for k, v in want.items()) / scale


def phase_dp_nccl(cfg, device, card) -> dict:
    """[dp nccl]: the Planning stage at full width and batch 2 (bf16
    policy) through the data-parallel Trainer over NCCL at world 1 beside
    the plain Trainer, from one seeded init. The reduce is an identity:
    the plain step's gradients all-reduced over the one rank and divided
    by 1, and the loss terms averaged, equal themselves bit for bit, and
    both trainers' clip + Adam on them leave parameters equal bit for bit.
    One distributed step launches K1, K3 and K2 twice. Then the p50 of
    both trainers' steps in turns, and the all-reduce of the ~42 MB of
    fp32 gradients (one flat call) alone. Returns one step's launches."""
    import torch
    import torch.distributed as dist
    from stp3_tpu_torch.parallel import mesh
    from stp3_tpu_torch.parallel.launch import free_port
    from stp3_tpu_torch.training.trainer import Trainer
    env = {'RANK': '0', 'WORLD_SIZE': '1', 'LOCAL_RANK': '0', 'MASTER_ADDR': '127.0.0.1',
           'MASTER_PORT': str(free_port())}          # torchrun's environment, one rank
    os.environ.update(env)
    try:
        if mesh.maybe_initialize_multihost(device) != device or (
                device.type == 'cuda' and dist.get_backend() != 'nccl'):
            fail('[dp nccl] the process group did not start on NCCL on the card')
        group = mesh.data_group()
        plain = Trainer(cfg, device=device, seed=SEED)
        dp = Trainer(cfg, device=device, seed=SEED, group=group)
        for (n, p), q in zip(plain.model.named_parameters(), dp.model.parameters()):
            if not torch.equal(p, q):
                fail(f'[dp nccl] broadcast over one rank changed {n}')
        batches = synthetic_batches(cfg, 2, device)
        loss = plain.compute_gradients(batches[0])
        for p, q in zip(plain.model.parameters(), dp.model.parameters()):
            q.grad = p.grad.clone()
        mesh.allreduce_gradients(dp.model.parameters(), group)
        averaged = mesh.allreduce_mean(loss, group)
        for (n, p), q in zip(plain.model.named_parameters(), dp.model.parameters()):
            if not torch.equal(p.grad, q.grad):
                fail(f'[dp nccl] all-reduce / 1 changed the gradient of {n}')
        if any(not torch.equal(averaged[k], v) for k, v in loss.items()):
            fail('[dp nccl] the loss terms averaged over one rank changed')
        plain.apply_gradients()
        dp.apply_gradients()
        same = all(torch.equal(p, q) for p, q in zip(plain.model.parameters(),
                                                      dp.model.parameters()))
        if not same:
            fail('[dp nccl] clip + Adam on equal gradients left different parameters')
        reset_launches()
        dp.train_step(batches[1])
        launches = read_launches()
        expect_launches('[dp nccl] one distributed step', launches, bev_splat=1,
                        gather_rows=1, convnext_mlp=2)
        times = {'plain': [], 'dp': []}
        for turn in ('plain', 'dp', 'dp', 'plain') * 2:
            trainer = plain if turn == 'plain' else dp
            for i in range(2):
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                trainer.train_step(batches[i])
                end.record()
                end.synchronize()
                times[turn].append(start.elapsed_time(end))
        n_bytes = sum(p.grad.numel() * p.grad.element_size() for p in dp.model.parameters())
        reduce_ms = time_ms(lambda: mesh.allreduce_gradients(dp.model.parameters(), group),
                            warmup=2, iters=10)
        say(f'[dp nccl] world 1 over NCCL: the gradients of {sum(1 for _ in dp.model.parameters())} '
            f'tensors all-reduced and divided by 1, the loss terms averaged, and clip + Adam '
            f'on them: bit for bit the plain Trainer\'s; launches of one distributed step '
            f'{launches}')
        say(f'[dp nccl] step p50 plain {np.median(times["plain"]):.2f} ms, distributed '
            f'{np.median(times["dp"]):.2f} ms (8 each, in turns, CUDA events); the gradient '
            f'all-reduce alone ({n_bytes / 1e6:.1f} MB fp32, one flat call + the copies in and '
            f'out) p50 {reduce_ms:.3f} ms; on {card}')
        del plain, dp, batches
        torch.cuda.empty_cache()
        return launches
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k in env:
            os.environ.pop(k, None)


def spawn_ranks(scenario: str, world: int, repo: str) -> list:
    """``world`` ranks of this script (``--rank scenario``) sharing card 0
    over gloo, under a deadline; returns each rank's JSON result. A rank
    that fails fails the phase."""
    import torch
    from stp3_tpu_torch.parallel.launch import run_ranks
    out = os.path.join(repo, 'build', 'chip_smoke', f'ranks_{scenario}')
    os.makedirs(out, exist_ok=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    try:
        outputs = run_ranks([sys.executable, os.path.abspath(__file__), '--rank', scenario,
                             out], world, RANKS_TIMEOUT_S, cwd=repo, share_device=True)
    except (RuntimeError, TimeoutError) as exc:
        fail(f'[{scenario}] {exc}')
    results = []
    for r in range(world):
        with open(os.path.join(out, f'rank{r}.json')) as f:
            results.append(json.load(f))
    for line in outputs[0].splitlines():
        if line.startswith('['):
            say(line)
    say(f'[{scenario}] {world} ranks on one card over gloo finished in '
        f'{time.perf_counter() - t0:.1f} s of wall time')
    return results


def dp_global(cfg, device):
    """A global batch of 2 synthetic samples (host numpy) and a fixed draw."""
    from stp3_tpu_torch.datas.synthetic import SyntheticDataset, collate
    ds = SyntheticDataset(cfg, n_samples=2, seed=SEED)
    batch = collate([ds[i] for i in range(2)])
    batch['noise'] = np.random.RandomState(SEED).randn(
        2, 1, cfg.MODEL.DISTRIBUTION.LATENT_DIM).astype(np.float32)
    return batch


def dp_step_numbers(trainer, batch, noise) -> dict:
    """One step (dropout off, the draw ``noise``): the loss terms, the
    gradients (after any all-reduce), the parameters' update and the 'bn'
    running statistics."""
    start = [p.detach().clone() for p in trainer.model.parameters()]
    loss = trainer.compute_gradients(batch, noise, dropout=False)
    grads = {n: p.grad.clone() for n, p in trainer.model.named_parameters()}
    trainer.apply_gradients()
    return {'loss': {k: v.item() for k, v in loss.items()}, 'grads': grads,
            'update': [p.detach() - s for p, s in zip(trainer.model.parameters(), start)],
            'stats': running_stats(trainer.model)}


def dp_distance(got: dict, want: dict) -> dict:
    """How far one step's numbers are from another's."""
    errs = grad_errors(got['grads'], want['grads'])
    worst = max(errs, key=errs.get)
    return {'loss': max(abs(got['loss'][k] - v) / max(abs(v), 1e-12)
                        for k, v in want['loss'].items()),
            'median': float(np.median(list(errs.values()))), 'worst': errs[worst],
            'worst_name': worst,
            'update': float(np.median([((u - w).norm() / w.norm().clamp_min(1e-30)).item()
                                       for u, w in zip(got['update'], want['update'])])),
            'stats': stats_error(got['stats'], want['stats'])}


def dp_compare(tag, cfg, device, group, rank) -> dict:
    """One step (dropout off, a fixed draw) of a seeded init on this rank's
    row of a global batch of 2. Rank 0 also takes the one-process step on
    the global batch, and on it with its two samples swapped (the same
    step summed in another order: the floor of fp32 reassociation), and
    measures the 2-rank step's distance from the first, beside the
    swapped step's; every rank holds its parameters and statistics to
    rank 0's, bit for bit."""
    import torch
    from stp3_tpu_torch.parallel import mesh
    from stp3_tpu_torch.training.trainer import Trainer, batch_to_device
    glob_np = dp_global(cfg, device)
    ref = []
    if rank == 0:
        for order in ([0, 1], [1, 0]):
            batch = batch_to_device({k: v[order] for k, v in glob_np.items()}, device)
            noise = batch.pop('noise')
            ref.append(dp_step_numbers(Trainer(cfg, device=device, seed=SEED), batch, noise))
            torch.cuda.empty_cache()
    trainer = Trainer(cfg, device=device, seed=SEED, group=group)
    rows = mesh.shard_batch(glob_np, device, group)
    noise = rows.pop('noise')
    mine_numbers = dp_step_numbers(trainer, rows, noise)
    # every rank against rank 0, bit for bit
    mine = torch.cat([p.detach().reshape(-1) for p in trainer.model.parameters()]
                     + [v.reshape(-1) for v in mine_numbers['stats'].values()])
    theirs = mine.clone()
    torch.distributed.broadcast(theirs, src=0, group=group)
    if not torch.equal(mine, theirs):
        fail(f'[{tag}] rank {rank} parameters or statistics differ from rank 0\'s')
    out = {'equal_to_rank0': True}
    if rank == 0:
        out.update(split=dp_distance(mine_numbers, ref[0]), swapped=dp_distance(ref[1], ref[0]),
                   n_grads=len(ref[0]['grads']), n_stats=len(ref[0]['stats']))
    del trainer
    torch.cuda.empty_cache()
    return out


def rank_dp(out_dir: str) -> dict:
    """One rank of [dp 2 ranks] and [dp bn] (``--rank dp``)."""
    import torch
    from stp3_tpu_torch.parallel import mesh
    from stp3_tpu_torch.training.trainer import Trainer
    device = mesh.maybe_initialize_multihost(backend='gloo')
    group = mesh.data_group()
    rank = mesh.process_index(group)
    fp32 = make_cfg(PLANNING_STAGE, {'PRECISION': 32})
    result = {'dp': dp_compare('dp 2 ranks', fp32, device, group, rank)}
    # 3 bf16 steps through the kernels, each rank on its own batch of 1
    trainer = Trainer(planning_cfg(), device=device, seed=SEED, group=group)
    batch = mesh.shard_batch(dp_global(fp32, device), device, group)
    batch.pop('noise')
    reset_launches()
    times = []
    for _ in range(3):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        loss = trainer.train_step(batch)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    result['launches'] = read_launches()
    expect_launches(f'[dp 2 ranks] rank {rank}: 3 bf16 steps', result['launches'],
                    bev_splat=3, gather_rows=3, convnext_mlp=6)
    if not all(torch.isfinite(v).all() for v in loss.values()):
        fail(f'[dp 2 ranks] rank {rank}: a bf16 loss term is not finite')
    result['bf16_ms'] = times
    del trainer
    torch.cuda.empty_cache()
    result['bn'] = dp_compare('dp bn', make_cfg(PLANNING_STAGE, {'PRECISION': 32,
                                                                 'MODEL': {'NORM': 'bn'}}),
                              device, group, rank)
    return result


def phase_dp_batch_split(device, card) -> None:
    """[dp batch split]: whether the 2-rank fp32 distance of [dp 2 ranks]
    comes from the all-reduce or from the batch size. In one process, no
    group, fp32 with TF32 off and deterministic algorithms where torch has
    them (K1's fp32 atomics and the bilinear upsample's backward have none:
    warn only): the Planning stage at full width from one seeded init,
    dropout off, a fixed draw; the mean of the two batch-1 gradients (as
    the all-reduce averages them) against the batch-2 gradient, beside the
    batch-2 step with its samples swapped. Held to ``DP_LIMITS`` as the
    2-rank step is."""
    import torch
    from stp3_tpu_torch.training.trainer import Trainer, batch_to_device
    cfg = make_cfg(PLANNING_STAGE, {'PRECISION': 32})
    glob_np = dp_global(cfg, device)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        steps = {}
        for name, rows in (('global', [0, 1]), ('swapped', [1, 0]), ('row0', [0]),
                           ('row1', [1])):
            batch = batch_to_device({k: v[rows] for k, v in glob_np.items()}, device)
            noise = batch.pop('noise')
            steps[name] = dp_step_numbers(Trainer(cfg, device=device, seed=SEED), batch, noise)
            torch.cuda.empty_cache()
    finally:
        torch.use_deterministic_algorithms(False)
    split = {'loss': {k: (steps['row0']['loss'][k] + steps['row1']['loss'][k]) / 2
                      for k in steps['global']['loss']},
             'grads': {n: (steps['row0']['grads'][n] + steps['row1']['grads'][n]) / 2
                       for n in steps['global']['grads']},
             'update': steps['global']['update'], 'stats': {}}
    got, floor = dp_distance(split, steps['global']), dp_distance(steps['swapped'],
                                                                  steps['global'])
    limits = {m: max(lim, 10 * floor[m]) for m, lim in DP_LIMITS.items() if m != 'update'}
    say(f'[dp batch split] one process, fp32, TF32 off, deterministic algorithms where torch '
        f'has them: the mean of two batch-1 steps vs the batch-2 step (the batch-2 step with '
        f'its samples swapped in brackets): loss terms rel {got["loss"]:.2e} '
        f'[{floor["loss"]:.2e}]; {len(split["grads"])} gradients, median {got["median"]:.2e} '
        f'[{floor["median"]:.2e}], worst {got["worst"]:.2e} ({got["worst_name"]}) '
        f'[{floor["worst"]:.2e}]; on {card}')
    over = [m for m in limits if got[m] > limits[m]]
    if over:
        fail(f'[dp batch split] the batch-1 steps do not average to the batch-2 step: {over}')


# each measure of the 2-rank step's distance from the one-process step
# may reach the larger of its limit and 10 times the swapped step's distance
DP_LIMITS = {'loss': 1e-4, 'median': 1e-3, 'worst': 1e-2, 'update': 1e-2, 'stats': 1e-3}


def report_dp(results: list, card: str) -> dict:
    """Gate and print [dp 2 ranks] and [dp bn] from the ranks' results.
    fp32, TF32 off: the loss terms' relative error; each gradient's L2
    error over its norm, or over 1e-4 of the largest gradient's norm where
    its own is smaller (``grad_errors``), in the median and the worst; the
    median relative error of the parameters' updates; the running
    statistics' largest difference over the largest running variance
    (``stats_error``). Each may reach the larger of ``DP_LIMITS`` (the
    limits of [train parity], where an fp32 ReLU sign flip moves every
    gradient upstream of it) and 10 times the distance of the
    one-process step with its two samples swapped: 'bn' in fp32 forms
    E[x^2] - E[x]^2, which reassociation moves by far more than its
    rounding where the variance is small against the mean."""
    for tag, key in (('dp 2 ranks', 'dp'), ('dp bn', 'bn')):
        split, floor = results[0][key]['split'], results[0][key]['swapped']
        limits = {m: max(lim, 10 * floor[m]) for m, lim in DP_LIMITS.items()}
        say(f'[{tag}] 2 ranks at batch 1 over gloo vs one process at batch 2 (fp32, TF32 '
            f'off, dropout off, a fixed draw; the one-process step with its samples swapped '
            f'in brackets): loss terms rel {split["loss"]:.2e} [{floor["loss"]:.2e}]; '
            f'{results[0][key]["n_grads"]} gradients after the all-reduce, median '
            f'{split["median"]:.2e} [{floor["median"]:.2e}], worst {split["worst"]:.2e} '
            f'({split["worst_name"]}) [{floor["worst"]:.2e}]; parameter updates median rel '
            f'{split["update"]:.2e} [{floor["update"]:.2e}]; {results[0][key]["n_stats"]} '
            f'running statistics {split["stats"]:.2e} [{floor["stats"]:.2e}]; limits '
            f'{ {m: float(f"{v:.2e}") for m, v in limits.items()} }; both ranks\' parameters '
            f'and statistics equal bit for bit')
        over = [m for m in DP_LIMITS if split[m] > limits[m]]
        if over:
            fail(f'[{tag}] the 2-rank step is not the one-process global-batch step: {over}')
    for rank, r in enumerate(results):
        say(f'[dp 2 ranks] rank {rank}: 3 bf16 steps at batch 1, launches {r["launches"]}, '
            f'step times {[round(t, 2) for t in r["bf16_ms"]]} ms (2 ranks sharing one '
            f'card, not a speed), on {card}')
    return {name: sum(r['launches'][name] for r in results) for name in results[0]['launches']}


def occupancy(out):
    import torch
    return torch.logical_or(out['segmentation'].argmax(-1), out['pedestrian'].argmax(-1))


def cam_compare(ref, got, model, trajs, commands, target, truth=None) -> dict:
    """Occupancy agreement, the selected candidate and the refined
    trajectory of a camera-parallel call against the one-process one;
    with ``truth`` (the one-process fp32 occupancy) also both calls'
    agreement with it."""
    import torch
    (traj_r, out_r), (traj_g, out_g) = ref, got
    agree = (occupancy(out_r) == occupancy(out_g)).float().mean().item()
    extra = {} if truth is None else {
        'split_vs_fp32': (occupancy(out_g) == truth).float().mean().item(),
        'one_vs_fp32': (occupancy(out_r) == truth).float().mean().item()}
    sel_r = selected(model, serve_plan_args(model, out_r, trajs, commands, target))
    sel_g = selected(model, serve_plan_args(model, out_g, trajs, commands, target))
    finite = all(torch.isfinite(v.float()).all() for v in out_g.values()
                 if isinstance(v, torch.Tensor)) and bool(torch.isfinite(traj_g.float()).all())
    return {'occupancy': agree, 'same_candidate': sel_r == sel_g,
            'traj_err': (traj_g.float() - traj_r.float()).abs().max().item(),
            'finite': finite, **extra}


def cam_inputs(cfg, device, dt):
    """The flagship's forward inputs (image in ``dt``, geometry fp32), the
    planner's, a seeded past-frame BEV cache and the fixed rig (host)."""
    import torch
    (image, k, e, ego), ex = example_inputs(cfg)
    image, = to_torch((image,), device, dt)
    k, e, ego = to_torch((k, e, ego), device)
    trajs, gt, target = to_torch((ex['trajs'], ex['gt_trajs'], ex['target_points']), device, dt)
    commands, = to_torch((ex['commands'],), device)
    mc = model_cfg(cfg)
    cache = torch.from_numpy(np.random.RandomState(SEED + 1).randn(
        1, mc.receptive_field - 1, *mc.bev_size, mc.encoder_out_channels)
        .astype(np.float32)).to(device, dt)
    rig = (k[0, -1].cpu().numpy(), e[0, -1].cpu().numpy())
    return (image, k, e, ego), (trajs, gt, commands, target), cache, rig


def rank_cam(out_dir: str) -> dict:
    """One rank of [cam parallel] (``--rank cam``): the flagship at full
    width, in fp32 (TF32 off) and in bf16 (the serving policy), split
    over 2 and over 3 ranks; rank 0 also runs the one-process port on the
    same inputs, and keeps the fp32 occupancy to hold the bf16 calls to.
    Each rank counts its launches of each call."""
    import torch
    from stp3_tpu_torch.ops.static_splat import build_column_splat_plan
    from stp3_tpu_torch.parallel import mesh, serving
    device = mesh.maybe_initialize_multihost(backend='gloo')
    rank = mesh.process_index(mesh.data_group())
    cfg = flagship_cfg()
    groups = {n: serving.cam_mesh(n) for n in (2, CAM_WORLD)}
    result, truth = {}, {}
    for dt in (torch.float32, torch.bfloat16):
        model = build_model(cfg).to(device=device, dtype=dt)
        (image, k, e, ego), (trajs, gt, commands, target), cache, rig = cam_inputs(
            cfg, device, dt)
        present = (image[:, -1], k[:, -1], e[:, -1])
        numbers = {}
        with torch.inference_mode():
            if rank == 0:
                arrays = build_column_splat_plan(model.frustum, *rig, model.bev_resolution,
                                                 model.bev_start_position,
                                                 model.bev_dimension).device_arrays(device)
                ref = {'plan': plan_step(model, image, k, e, ego, trajs, gt, commands,
                                         target)[::-1],
                       'serve': model.serve_step(*present, ego, cache, trajs, commands,
                                                 target)[:2],
                       'static': model.serve_step_static(image[:, -1], ego, cache, trajs,
                                                         commands, target, arrays)[:2]}
                if dt == torch.float32:
                    truth = {name: occupancy(out) for name, (_, out) in ref.items()}
                else:
                    numbers['one_ms'] = time_ms(lambda: plan_step(
                        model, image, k, e, ego, trajs, gt, commands, target), 2, 5)
        k2 = 2 if dt == torch.bfloat16 else 0              # fp32 takes the unfused MLP
        for n_shards, group in groups.items():
            if rank >= n_shards:
                continue
            fwd = serving.make_cam_parallel_forward(model, group)
            step = serving.make_cam_parallel_plan_step(model, group)
            serve = serving.make_cam_parallel_serve_step(model, group)
            static = serving.make_cam_parallel_serve_step_static(model, group, *rig)
            calls = {  # plan: the plan step (for the trajectory), the forward (the heads)
                'plan': (lambda: (step(image, k, e, ego, trajs, gt, commands, target),
                                  fwd(image, k, e, ego)), dict(bev_splat=2, convnext_mlp=2 * k2)),
                'serve': (lambda: serve(*present, ego, cache, trajs, commands, target)[:2],
                          dict(bev_splat=1, convnext_mlp=k2)),
                'static': (lambda: static(image[:, -1], ego, cache, trajs, commands,
                                          target)[:2], dict(convnext_mlp=k2))}
            split = {}
            with torch.inference_mode():
                for name, (call, want) in calls.items():
                    reset_launches()
                    got = call()
                    launches = read_launches()
                    expect_launches(f'[cam parallel] rank {rank} of {n_shards}, {dt}: {name}',
                                    launches, **want)
                    split[name] = {'launches': launches}
                    if rank == 0:
                        split[name].update(cam_compare(
                            ref[name], got, model, trajs, commands, target,
                            truth[name] if dt == torch.bfloat16 else None))
                if dt == torch.bfloat16:
                    split['plan_ms'] = time_ms(lambda: step(image, k, e, ego, trajs, gt,
                                                            commands, target), 2, 5)
            numbers[str(n_shards)] = split
        result[str(dt).replace('torch.', '')] = numbers
        del model
        torch.cuda.empty_cache()
    mesh.coordination_barrier()
    return result


def cam_shard_ranks(cfg, device, n_shards: int):
    """(F = rf, P) ranks of one rank's cameras (the first N / n_shards of
    the flagship rig), pre-warped as the model splats them."""
    from stp3_tpu_torch.ops.bev_pool import prewarped_ranks
    geometry, ego, (res, start, dim) = rig_geometry(cfg, device)
    nl = geometry.shape[2] // n_shards
    return prewarped_ranks(geometry[:, :, :nl].contiguous(), ego, res, start, dim)


# [cam parallel]'s limits in fp32: the share of occupancy cells that must
# agree with one process and the refined trajectory's largest difference
CAM_OCCUPANCY = 0.9999
CAM_TRAJ_M = 1e-3


def report_cam(results: list, card: str) -> dict:
    """Gate and print [cam parallel]. In fp32 the split sums the same
    partial grids in another order: occupancy agrees with one process on
    99.99% of the cells, the same candidate is selected and the refined
    trajectory is within 1e-3 m. Under bf16 each rank's partial grid is
    rounded to bf16 before the sum, a rounding the one-process step does
    not take, and a random-weight model's logits are near ties in many
    cells: the split's occupancy may disagree with the fp32 one-process
    occupancy on at most twice as many cells as the bf16 one-process step
    does, plus 0.1% of the cells; every output finite; the agreement with
    the bf16 one-process step, the candidate and the trajectory printed."""
    launches = {}
    for dt, numbers in results[0].items():
        for n_shards in ('2', str(CAM_WORLD)):
            for name in ('plan', 'serve', 'static'):
                r = numbers[n_shards][name]
                if dt == 'float32':
                    gate = (f'(limit {CAM_OCCUPANCY}); refined trajectory max |diff| '
                            f'{r["traj_err"]:.3e} m (limit {CAM_TRAJ_M})')
                    bad = (r['occupancy'] < CAM_OCCUPANCY or not r['same_candidate']
                           or r['traj_err'] > CAM_TRAJ_M)
                else:
                    limit = 1 - 2 * (1 - r['one_vs_fp32']) - 1e-3
                    gate = (f'against one bf16 process; with the fp32 one-process occupancy '
                            f'{r["split_vs_fp32"]:.6f} (limit {limit:.6f}; one bf16 process '
                            f'{r["one_vs_fp32"]:.6f}); refined trajectory max |diff| '
                            f'{r["traj_err"]:.3e} m')
                    bad = r['split_vs_fp32'] < limit
                say(f'[cam parallel] {dt}, {n_shards} ranks, {name}: occupancy agreement '
                    f'{r["occupancy"]:.6f} {gate}; same candidate {r["same_candidate"]}; '
                    f'finite {r["finite"]}')
                if bad or not r['finite']:
                    fail(f'[cam parallel] {dt}, {n_shards} ranks, {name}: not the one-process '
                         f'result')
    for n_shards in ('2', str(CAM_WORLD)):
        ranks = [res['bfloat16'][n_shards] for res in results if n_shards in res['bfloat16']]
        say(f'[cam parallel] bf16, {n_shards} ranks: K1 launches per rank (plan step + '
            f'forward, serve_step, serve_step_static) '
            f'{[[r[m]["launches"]["bev_splat"] for m in ("plan", "serve", "static")] for r in ranks]}'
            f'; plan step p50 per rank {[round(r["plan_ms"], 2) for r in ranks]} ms against '
            f'one process\'s {results[0]["bfloat16"]["one_ms"]:.2f} ms (ranks sharing one card '
            f'over gloo: not a latency), on {card}')
    for res in results:
        for numbers in res.values():
            for split in numbers.values():
                if not isinstance(split, dict):
                    continue
                for name in ('plan', 'serve', 'static'):
                    for kname, v in split[name]['launches'].items():
                        launches[kname] = launches.get(kname, 0) + v
    return launches


def rank_main(scenario: str, out_dir: str) -> None:
    """A rank of a multi-rank phase (``--rank dp|cam OUT_DIR``), started by
    ``spawn_ranks`` with torchrun's environment."""
    import torch
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if not torch.cuda.is_available():
        fail('torch.cuda.is_available() is false: this script needs an NVIDIA GPU')
    result = {'dp': rank_dp, 'cam': rank_cam}[scenario](out_dir)
    with open(os.path.join(out_dir, f'rank{os.environ["RANK"]}.json'), 'w') as f:
        json.dump(result, f)


def main() -> None:
    import torch
    if sys.argv[1:2] == ['--rank']:
        rank_main(sys.argv[2], sys.argv[3])
        return
    if not torch.cuda.is_available():
        fail('torch.cuda.is_available() is false: this script needs an NVIDIA GPU')
    repo = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, repo)

    device = torch.device('cuda', 0)
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True, text=True,
                         timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else 'nvidia-smi failed'
    say(card)
    say(f'[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__}, CUDA '
        f'{torch.version.cuda}; TF32 matmul {torch.backends.cuda.matmul.allow_tf32}, '
        f'cudnn {torch.backends.cudnn.allow_tf32}')

    build_kernels(repo)
    phase_image_io(repo, card)

    cfg, train_cfg = flagship_cfg(), planning_cfg()
    b = int(train_cfg.BATCHSIZE)
    stages = {'perception': stage_cfg('perception'),
              'perception_carla': stage_cfg('carla_perception'),
              'prediction_ber': stage_cfg('prediction_ber')}
    # each kernel's numbers at the shapes of each path that launches it
    report = {
        'bev_splat': {'serving': phase_k1(cfg, device, 'serving'),
                      'train': phase_k1(train_cfg, device, 'train', b)},
        'convnext_mlp': {'serving': phase_k2(cfg, device, 'serving'),
                         'train': phase_k2(train_cfg, device, 'train', b)},
        'gather_rows': {'train': phase_k3(train_cfg, device)},
        'lift_splat': {'fused': phase_k4(cfg, device)},
    }
    # the stage train steps' splats (K1) and their backward (K3); K2 at
    # Prediction_Ber's rows (Perception has no future prediction)
    for path, stage in stages.items():
        sb = int(stage.BATCHSIZE)
        report['bev_splat'][path] = phase_k1(stage, device, path, sb)
        report['gather_rows'][path] = phase_k3(stage, device, path)
    report['convnext_mlp']['prediction_ber'] = phase_k2(
        stages['prediction_ber'], device, 'prediction_ber', int(stages['prediction_ber'].BATCHSIZE))
    # the CLI paths: training and its val forwards at the training shapes, the
    # evaluations at batch 1 (K1 at the serving splat of the same rig; K2 at
    # the Prediction stage's own rows)
    # the nuScenes dataset path trains the Planning stage at the training
    # shapes; CARLA's Planning stage at batch 2 splats 4 cameras of 256x256
    carla_cfg = carla_planning_cfg()
    for name in ('bev_splat', 'convnext_mlp', 'gather_rows'):
        report[name]['train_cli'] = report[name]['train']
        report[name]['nuscenes_data'] = report[name]['train']
        report[name]['remat'] = report[name]['train']
    report['bev_splat']['carla_data'] = phase_k1(carla_cfg, device, 'carla_data', b)
    report['gather_rows']['carla_data'] = phase_k3(carla_cfg, device, 'carla_data')
    report['convnext_mlp']['carla_data'] = phase_k2(carla_cfg, device, 'carla_data', b)
    for name in ('bev_splat', 'convnext_mlp'):
        report[name]['evaluate_planning'] = report[name]['serving']
        report[name]['reference_import'] = report[name]['serving']
    report['bev_splat']['evaluate_prediction'] = report['bev_splat']['serving']
    report['convnext_mlp']['evaluate_prediction'] = phase_k2(
        stage_cfg('prediction'), device, 'evaluate_prediction', 1)
    phase_backward(train_cfg, device)
    per_frame, launches = phase_per_frame(cfg, device)
    launches = {'per_frame': launches}
    for name, numbers in per_frame.items():
        report[name] = {'per_frame': numbers}
    phase_parity(flagship_cfg(tiny=True), device)
    phase_train_parity(planning_cfg(tiny=True), device)
    launches['serving'] = phase_flagship(cfg, device, card)
    trainer, batches, launches['train'] = phase_train(train_cfg, device, card)
    if '--profile' in sys.argv[1:]:
        profile_train(trainer, batches, card)
    del trainer, batches
    torch.cuda.empty_cache()
    launches['remat'] = phase_remat(train_cfg, device, card)
    torch.cuda.empty_cache()
    launches['fused'] = phase_fused(cfg, device, card)
    report['bev_splat']['agent'], per_tick, agent_p50 = phase_agent(device, card)
    # the agent path: one steady tick of each of its three modes
    launches['agent'] = {name: sum(tick[name] for tick in per_tick.values())
                         for name in counters()}
    for path, tag, steps in (('perception', 'perception', 10),
                             ('perception_carla', 'perception carla', 6),
                             ('prediction_ber', 'prediction_ber', 10)):
        want = dict(bev_splat=1, gather_rows=1, convnext_mlp=2 if path == 'prediction_ber' else 0)
        trainer, batches, launches[path] = phase_train(stages[path], device, card, tag, steps,
                                                       **want)
        if '--profile' in sys.argv[1:]:
            profile_train(trainer, batches, card, tag=tag)
        del trainer, batches
        torch.cuda.empty_cache()
    launches['perception_bn'] = phase_perception_bn(
        stage_cfg('perception', False, {'MODEL': {'NORM': 'bn'}}), device, card)
    torch.cuda.empty_cache()
    launches['bn_frozen'] = phase_flagship(make_cfg(FLAGSHIP, {'MODEL': {'NORM': 'bn_frozen'}}),
                                           device, card, tag='bn_frozen')
    ckpt, launches['train_cli'] = phase_train_cli(device, card, repo)
    launches['evaluate_planning'] = phase_evaluate('evaluate_planning', ckpt, device, card,
                                                   planning_result_keys(train_cfg))
    pred_ckpt = prediction_checkpoint(device, repo)
    launches['evaluate_prediction'] = phase_evaluate(
        'evaluate_prediction', pred_ckpt, device, card,
        ['vehicle_iou', 'vehicle_pq', 'vehicle_sq', 'vehicle_rq'])
    phase_labels_as_prediction(*phase_decode(pred_ckpt, device, card), device, card)
    launches['reference_import'] = phase_reference_import(device, card, repo)
    launches['carla_agent'] = phase_carla_agent(device, card, repo, per_tick, agent_p50)
    launches.update(phase_real_data(repo, device, card))
    # data parallel and camera parallel: K1, K3 and K2 at the training shapes
    # of batch 2 ([dp nccl]) and of batch 1 (each rank of [dp 2 ranks]); K1 at
    # one rank's cameras of the 2-way split and K2 at the serving rows
    for name in ('bev_splat', 'convnext_mlp', 'gather_rows'):
        report[name]['dp_nccl'] = report[name]['train']
    report['bev_splat']['dp_ranks'] = report['bev_splat']['serving']
    report['convnext_mlp']['dp_ranks'] = report['convnext_mlp']['serving']
    report['gather_rows']['dp_ranks'] = phase_k3(make_cfg(PLANNING_STAGE, {'BATCHSIZE': 1}),
                                                 device, 'dp_ranks')
    report['bev_splat']['cam_parallel'] = phase_k1(cfg, device, 'cam_parallel',
                                                   ranks=cam_shard_ranks(cfg, device, 2))
    report['convnext_mlp']['cam_parallel'] = report['convnext_mlp']['serving']
    launches['dp_nccl'] = phase_dp_nccl(train_cfg, device, card)
    launches['dp_ranks'] = report_dp(spawn_ranks('dp', DP_WORLD, repo), card)
    phase_dp_batch_split(device, card)
    launches['cam_parallel'] = report_cam(spawn_ranks('cam', CAM_WORLD, repo), card)
    say('[launches] ' + '; '.join(f'{path} {launches[path]}' for path in PATHS)
        + f'; agent per tick {per_tick}')
    for name, *_, main_path in KERNELS:
        if not launches[main_path][name]:
            fail(f'{name} was never launched on its path {main_path!r}')

    kernels = []
    for name, route, source, replaces, main_path in KERNELS:
        paths = {path: dict(launches=launches[path][name], **report[name].get(path, {}))
                 for path in PATHS}
        paths['agent']['per_tick'] = {mode: tick[name] for mode, tick in per_tick.items()}
        top = {k: paths[main_path][k] for k in ('launches', 'max_abs_err', 'ms', 'plain_ms',
                                                'bound_ms', 'bound_by', 'library_ms')}
        kernels.append(dict(name=name, route=route, source=source, replaces=replaces, **top,
                            main_path=main_path, paths=paths))
    say(json.dumps({'kernels': kernels}))
    say(json.dumps({'ok': True, 'device': {'platform': 'gpu',
                                           'kind': torch.cuda.get_device_name(0),
                                           'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
