"""Checkpoint-import dress rehearsal of the port: one command that runs the
whole chain

    reference torch .ckpt -> stp3_tpu_torch.scripts.import_torch_checkpoint
                          -> a checkpoint of the port
                          -> stp3_tpu_torch.evaluate (the nuScenes dataset class)

end to end: the sequence to run once a real nuScenes tree and a real
reference Planning.ckpt are at hand (reference evaluate.py:28-44), as

    python -m stp3_tpu_torch.scripts.import_torch_checkpoint \\
        --checkpoint Planning.ckpt --output ./imported
    python -m stp3_tpu_torch.evaluate --checkpoint ./imported --dataroot /data/nuscenes

Without them it takes (a) a synthesised reference-format Lightning
checkpoint (``utils/torch_import.synthesize_state_dict``: the reference's
keys and shapes, seeded values) of a tiny Planning configuration and (b)
the stand-in nuScenes devkit and tree of tests/torch_fake_datasets.py
(its tables, CAN bus, map and lidar; camera JPEGs at 1600x900, here two
cameras, resized to 64x32).

    python -m stp3_tpu_torch.scripts.dress_rehearsal [--workdir DIR] \\
        [--keep-visualisations] [--device cpu]

(the card unless ``--device`` names another device). With
``--keep-visualisations`` the evaluation saves its figures under
``imgs_eval/<TAG>/`` (matplotlib needed).
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
from typing import Dict

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def tiny_cfg_opts(dataroot: str):
    """The KEY VALUE overrides of the tiny nuScenes Planning configuration
    on the stand-in tree (the JAX rehearsal's, with its images' 1600x900
    resized by 0.04 and cropped by 4 rows to 32x64)."""
    return [
        'DATASET.NAME', 'nuscenes', 'DATASET.VERSION', 'mini',
        'DATASET.DATAROOT', dataroot, 'DATASET.MAP_FOLDER', dataroot,
        'IMAGE.NAMES', "['CAM_FRONT','CAM_BACK']",
        'IMAGE.ORIGINAL_HEIGHT', '900', 'IMAGE.ORIGINAL_WIDTH', '1600',
        'IMAGE.RESIZE_SCALE', '0.04', 'IMAGE.TOP_CROP', '4',
        'IMAGE.FINAL_DIM', '(32, 64)',
        'LIFT.X_BOUND', '[-8.0, 8.0, 1.0]', 'LIFT.Y_BOUND', '[-8.0, 8.0, 1.0]',
        'LIFT.D_BOUND', '[2.0, 10.0, 1.0]',
        'MODEL.ENCODER.NAME', 'efficientnet-b0',
        'MODEL.ENCODER.OUT_CHANNELS', '16',
        'MODEL.TEMPORAL_MODEL.START_OUT_CHANNELS', '16',
        'TIME_RECEPTIVE_FIELD', '2', 'N_FUTURE_FRAMES', '2',
        'MODEL.DISTRIBUTION.LATENT_DIM', '4',
        'PLANNING.SAMPLE_NUM', '12', 'PLANNING.GRU_STATE_SIZE', '2',
        'N_WORKERS', '0', 'PRECISION', '32',
    ]


def main(workdir: str = '', keep_visualisations: bool = False, device=None,
         n_samples: int = 12) -> Dict[str, float]:
    """The rehearsal; returns the evaluation's results (each finite)."""
    tests = os.path.join(ROOT, 'tests')
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import torch_fake_datasets

    workdir = workdir or tempfile.mkdtemp(prefix='dress_rehearsal_')
    dataroot = os.path.join(workdir, 'data')
    os.makedirs(dataroot, exist_ok=True)

    # ---- 0. the stand-in devkit (for this call only) and the tiny config
    before = {k: v for k, v in sys.modules.items() if k.split('.')[0] == 'nuscenes'}
    fakes = torch_fake_datasets.install(n_samples=n_samples,
                                        cam_names=['CAM_FRONT', 'CAM_BACK'])
    try:
        return _rehearse(workdir, dataroot, keep_visualisations, device)
    finally:
        for name in fakes:
            if name in before:
                sys.modules[name] = before[name]
            else:
                sys.modules.pop(name, None)


def _rehearse(workdir: str, dataroot: str, keep_visualisations: bool, device):
    from stp3_tpu_torch.config import get_cfg
    from stp3_tpu_torch.evaluate import evaluate
    from stp3_tpu_torch.models.stp3 import STP3Config
    from stp3_tpu_torch.scripts import import_torch_checkpoint
    from stp3_tpu_torch.utils import torch_import as ti

    opts = tiny_cfg_opts(dataroot)
    cfg = get_cfg(argparse.Namespace(config_file='', opts=opts))
    cfg.MODEL.NORM = 'bn_frozen'

    # ---- 1. a reference-format Lightning checkpoint
    sd = ti.synthesize_state_dict(STP3Config.from_cfg(cfg), seed=0)
    torch_ckpt = os.path.join(workdir, 'reference_format.ckpt')
    torch.save({'state_dict': {k: torch.from_numpy(np.ascontiguousarray(v))
                               for k, v in sd.items()},
                'hyper_parameters': cfg.convert_to_dict()}, torch_ckpt)
    print(f'[1/3] synthesized reference-format ckpt: {torch_ckpt} ({len(sd)} tensors)')

    # ---- 2. its import through the CLI
    imported = import_torch_checkpoint.main(
        ['--checkpoint', torch_ckpt, '--output', os.path.join(workdir, 'imported')] + opts)
    print(f'[2/3] imported into a checkpoint of the port: {imported}')

    # ---- 3. the evaluation on the stand-in nuScenes tree
    results = evaluate(imported, device, dataroot=dataroot,
                       save_visualisations=keep_visualisations)
    if not results:
        raise RuntimeError('evaluate produced no metrics')
    bad = {k: v for k, v in results.items() if not np.isfinite(v)}
    if bad:
        raise RuntimeError(f'non-finite metrics: {bad}')
    if not any(k.startswith('plan_') for k in results):
        raise RuntimeError('planning metrics missing')
    print(f'[3/3] evaluate produced {len(results)} finite metrics: dress rehearsal OK')
    return results


if __name__ == '__main__':
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument('--workdir', default='', help='scratch directory (default: a new temp one)')
    p.add_argument('--keep-visualisations', action='store_true')
    p.add_argument('--device', default=None,
                   help="torch device, e.g. 'cpu' (default: the card; none raises)")
    a = p.parse_args()
    main(a.workdir, a.keep_visualisations, a.device)
