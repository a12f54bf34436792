"""Tiny copies of the benchmark's cells for the CPU tests: the repository's
``BENCHMARK.json`` and ``cardbench/`` copied into a temporary root, the
cell's configuration cut to tiny widths (EfficientNet-b0, 2 cameras at
32x64 or CARLA's 4 at 32x32, a 16x16 BEV grid) and small pools, so that a
run's set-up, window and comparison take seconds on the CPU."""
from __future__ import annotations

import dataclasses
import json
import os
import shutil

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

TINY = {
    'TIME_RECEPTIVE_FIELD': 2, 'N_FUTURE_FRAMES': 2,
    'IMAGE': {'FINAL_DIM': [32, 64], 'NAMES': ['CAM_L', 'CAM_R']},
    'LIFT': {'X_BOUND': [-8.0, 8.0, 1.0], 'Y_BOUND': [-8.0, 8.0, 1.0],
             'D_BOUND': [2.0, 10.0, 1.0]},
    'MODEL': {'ENCODER': {'NAME': 'efficientnet-b0', 'OUT_CHANNELS': 16},
              'TEMPORAL_MODEL': {'START_OUT_CHANNELS': 16},
              'DISTRIBUTION': {'LATENT_DIM': 4}},
    'PLANNING': {'SAMPLE_NUM': 12, 'GRU_STATE_SIZE': 2},
    'PRECISION': 32,
}
CARLA_IMAGE = {'FINAL_DIM': [32, 32], 'NAMES': ['front', 'left', 'right', 'rear']}


def merge(into: dict, other: dict) -> dict:
    for k, v in other.items():
        if isinstance(v, dict) and isinstance(into.get(k), dict):
            merge(into[k], v)
        else:
            into[k] = v
    return into


def model_fields(stage: dict) -> dict:
    """The port's model configuration of a stage, as the config files hold it."""
    from stp3_tpu_torch.models.stp3 import STP3Config
    from cardbench.entries.serve import port_config
    fields = dataclasses.asdict(STP3Config.from_cfg(port_config({'stage': stage})))
    fields.pop('fused_lift_splat')
    return json.loads(json.dumps(fields))


def tiny_root(tmp: str, cell: str, precision: str = 'fp32') -> str:
    """A root under ``tmp`` whose cell ``cell`` runs at tiny widths in
    ``precision``; returns the root."""
    root = os.path.join(tmp, 'root')
    shutil.copytree(HERE, os.path.join(root, 'cardbench'),
                    ignore=shutil.ignore_patterns('__pycache__'))
    shutil.copy(os.path.join(ROOT, 'BENCHMARK.json'), root)
    bench = json.load(open(os.path.join(root, 'BENCHMARK.json')))
    w = {x['name']: x for x in bench['workloads']}[cell]
    path = os.path.join(root, 'cardbench', 'configs', w['config'] + '.json')
    config = json.load(open(path))
    tiny = json.loads(json.dumps(TINY))
    if 'carla' in w['config']:
        tiny['IMAGE'] = CARLA_IMAGE
    tiny['PRECISION'] = {'fp32': 32, 'bf16': 16}[precision]
    merge(config['stage'], tiny)
    config['model'] = model_fields(config['stage'])
    config['precision'] = precision
    json.dump(config, open(path, 'w'))
    path = os.path.join(root, 'cardbench', 'traffic', w['traffic'] + '.json')
    traffic = json.load(open(path))
    if 'pool' in traffic and traffic['kind'] != 'carla_route':
        traffic.update(cameras=2, pool=4)
    json.dump(traffic, open(path, 'w'))
    path = os.path.join(root, 'cardbench', 'workloads', cell + '.json')
    workload = json.load(open(path))
    workload['sample'] = min(int(workload['sample']), 2)
    json.dump(workload, open(path, 'w'))
    return root
