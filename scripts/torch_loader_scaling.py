#!/usr/bin/env python3
"""The port's data loader over its dataset classes, against the number of
worker processes, on the host of whatever machine runs it.

    python3 scripts/torch_loader_scaling.py [--workers 1 2 4 8] [--dataset nuscenes carla]

For each dataset and worker count: ``prepare_dataloaders`` on the
PIL-free stand-in tree of tests/torch_fake_datasets.py, at the
configuration of chip_smoke.py's [nuscenes_data] path (tests/torch_fixtures.py:
the nuScenes Planning stage with LIFT.GT_DEPTH: 6 cameras at 1600x900 -> 224x480, 3
past and 6 future frames, the 200x200 BEV; 18 training windows) or its
[carla_data] path (CARLA's Planning stage: 4 cameras at 400x300, 18
windows), batch 2, ``WORKER_KIND process``. Two epochs: the first
starts the pool (the time to its first batch is printed), the second is
the loader's steady rate in samples/s (host wall clock). The trees are
written under build/loader_scaling/. It needs no card.
"""
from __future__ import annotations

import argparse
import os
import shutil
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def epoch(loader):
    """(samples, seconds to the first batch, seconds) of one epoch."""
    t0 = time.perf_counter()
    first, n = None, 0
    for batch in loader:
        if first is None:
            first = time.perf_counter() - t0
        n += int(batch['image'].shape[0])
    return n, first, time.perf_counter() - t0


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--workers', type=int, nargs='+', default=[1, 2, 4, 8])
    parser.add_argument('--dataset', nargs='+', default=['nuscenes', 'carla'],
                        choices=['nuscenes', 'carla'])
    args = parser.parse_args(argv)
    sys.path[:0] = [REPO, os.path.join(REPO, 'tests')]
    import torch_fake_datasets as fake
    import torch_fixtures as fixtures
    from stp3_tpu_torch.datas.dataloaders import prepare_dataloaders

    root = os.path.join(REPO, 'build', 'loader_scaling')
    shutil.rmtree(root, ignore_errors=True)
    fake.install(n_samples=26)                          # 18 windows of 3 + 6 frames
    fake.write_carla_route(root, n_frames=25, town='Town01_tiny')
    fake.write_carla_route(root, n_frames=9, town='Town05_short')
    configs = {
        'nuscenes': (fixtures.PLANNING_STAGE, fixtures.NUSCENES_DATA,
                     {'DATASET': {'VERSION': 'trainval', 'DATAROOT': root, 'MAP_FOLDER': root}}),
        'carla': (fixtures.CARLA_PLANNING, fixtures.CARLA_DATA, {'DATASET': {'DATAROOT': root}})}
    print(f'host: {os.cpu_count()} cores ({len(os.sched_getaffinity(0))} usable)', flush=True)
    for name in args.dataset:
        for workers in args.workers:
            cfg = fixtures.make_cfg(*configs[name], {'N_WORKERS': workers})
            train, val = prepare_dataloaders(cfg)
            try:
                n0, first, t0 = epoch(train)
                n1, _, t1 = epoch(train)
            finally:
                train.close()
                val.close()
            print(f'[{name}] {workers} process workers: the first epoch {n0} samples in '
                  f'{t0:.2f} s (its first batch after {first:.2f} s: the pool\'s start); the '
                  f'second {n1} samples in {t1:.2f} s, {n1 / t1:.2f} samples/s', flush=True)


if __name__ == '__main__':
    main()
