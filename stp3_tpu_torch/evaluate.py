"""Open-loop evaluation CLI of the port (counterpart of the JAX package's
evaluate.py; reference evaluate.py:28-169).

    python -m stp3_tpu_torch.evaluate --checkpoint <ckpt dir, step dir or pointer> \
        [--dataroot <path>] [--no-save] [--device cpu] [KEY VALUE ...]

Loads a checkpoint of the port (training/checkpoint.py) and the config
stored beside it, then runs the no-grad loop over the validation split
at batch 1: IoU of vehicles, pedestrians and each HD-map element, the
panoptic metrics through ``predict_instance_segmentation_and_trajectories``
(its per-frame decode on the device), and the planning metrics per
second of horizon (``PlanningMetric(cfg, 2 (i + 1))``, reference
evaluate.py:70-73,135-137). Planning runs on the PREDICTED occupancy and
HD map; the collisions are scored against the GT occupancy (reference
:121-137). ``--dataroot`` sets DATASET.DATAROOT and DATASET.MAP_FOLDER.
Unless ``--no-save``, every 100th sample's evaluation figure
(``utils/visualisation.save_eval_figure``, which needs matplotlib) is
saved under ``imgs_eval/<TAG>/``; ``evaluate()`` saves them only when
asked (``save_visualisations``).
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Any, Callable, Dict, Optional

import numpy as np

from stp3_tpu_torch.config import get_cfg
from stp3_tpu_torch.datas.dataloaders import prepare_dataloaders
from stp3_tpu_torch.metrics import PlanningMetric
from stp3_tpu_torch.training import checkpoint as ckpt_lib
from stp3_tpu_torch.training.trainer import Trainer, batch_to_device
from stp3_tpu_torch.utils.device import resolve_device


def eval_cfg(checkpoint_path: str, extra_opts=None, dataroot: str = ''):
    """The checkpoint's config with the evaluation-time changes (reference
    evaluate.py:40-44): batch 1, no GT depth, REMAT none (a train-time
    policy); ``dataroot``, if given, as DATASET.DATAROOT and MAP_FOLDER."""
    cfg_dict = ckpt_lib.load_config_dict(checkpoint_path)
    if cfg_dict is None:
        raise FileNotFoundError(f'no config.json beside checkpoint {checkpoint_path}')
    cfg = get_cfg(cfg_dict=cfg_dict)
    cfg.BATCHSIZE = 1
    cfg.LIFT.GT_DEPTH = False
    cfg.MODEL.REMAT = 'none'
    if dataroot:
        cfg.DATASET.DATAROOT = dataroot
        cfg.DATASET.MAP_FOLDER = dataroot
    if extra_opts:
        cfg.merge_from_list(extra_opts)
    return cfg


def evaluate(checkpoint_path: str, device=None, extra_opts=None,
             log: Callable[[str], None] = print,
             stats: Optional[Dict[str, Any]] = None, dataroot: str = '',
             save_visualisations: bool = False) -> Dict[str, float]:
    """The evaluation's results, {name: value}. Each batch is one replay
    of the trainer's compiled validation call (``Trainer.validate``: the
    forward, every metric's increment and the instance decode on the
    device) and one read back. ``stats``, if given, receives ``samples``,
    the loop's wall-clock ``seconds``, each sample's ``forward_ms``
    (``validate``, its read back included; wall clock), the validation
    graph's ``launches`` (a kernel's launches in it) and ``captures``. ``save_visualisations``:
    the figure of every 100th sample into ``imgs_eval/<TAG>/`` (a figure
    that fails is reported and the evaluation goes on)."""
    device = resolve_device(device)
    cfg = eval_cfg(checkpoint_path, extra_opts, dataroot)
    save_path = None
    if save_visualisations:
        save_path = os.path.join('imgs_eval', cfg.TAG)
        os.makedirs(save_path, exist_ok=True)
    _, valloader = prepare_dataloaders(cfg, split='val')
    try:
        trainer = Trainer(cfg, device=device)
        state = ckpt_lib.load_checkpoint(checkpoint_path, map_location=device)
        # the evaluation runs without LIFT.GT_DEPTH (as the JAX package's): a
        # checkpoint trained with it also holds the depth loss's weight
        weights = {k: v for k, v in state['model'].items() if k != 'depths_weight'}
        trainer.model.load_state_dict(weights)
        log(f'Loaded weights from {ckpt_lib.resolve_checkpoint_path(checkpoint_path)} '
            f'(step {state["step"]}) on {device}')

        rf = cfg.TIME_RECEPTIVE_FIELD
        hdmap_class = cfg.SEMANTIC_SEG.HDMAP.ELEMENTS
        # the trainer's validation metrics, and the planning metric per
        # second of horizon, fed the first 2 (i + 1) columns of its increments
        metric_planning = ([PlanningMetric(cfg, 2 * (i + 1))
                            for i in range(cfg.N_FUTURE_FRAMES // 2)]
                           if cfg.PLANNING.ENABLED else None)

        forward_ms, n_samples = [], 0
        t0 = time.perf_counter()
        for index, batch in enumerate(valloader):
            batch = batch_to_device(batch, device)
            # one process: the loader pads nothing, so every row must be valid
            valid = batch.pop('valid', None)
            if valid is not None and not np.asarray(valid).all():
                raise ValueError('padding rows in a one-process evaluation')
            t1 = time.perf_counter()
            output, labels, host = trainer.validate(batch)
            forward_ms.append((time.perf_counter() - t1) * 1e3)
            trainer.add_increments(host)
            for metric in metric_planning or ():
                metric.add(host['planning'], host['samples'])
            n_samples += host['samples']
            if save_path is not None and index % 100 == 0:
                try:          # a figure must never stop the evaluation
                    from stp3_tpu_torch.utils.visualisation import save_eval_figure
                    save_eval_figure(output, labels, batch, rf, index, save_path, cfg)
                except Exception as exc:
                    log(f'visualisation failed: {exc!r}')
        seconds = time.perf_counter() - t0
    finally:
        valloader.close()

    results: Dict[str, float] = {'vehicle_iou': float(trainer.metric_vehicle_val.compute()[1])}
    if trainer.metric_pedestrian_val is not None:
        results['pedestrian_iou'] = float(trainer.metric_pedestrian_val.compute()[1])
    if trainer.metric_hdmap_val is not None:
        for name, metric in zip(hdmap_class, trainer.metric_hdmap_val):
            results[f'{name}_iou'] = float(metric.compute()[1])
    if trainer.metric_panoptic_val is not None:
        for key, value in trainer.metric_panoptic_val.compute().items():
            results[f'vehicle_{key}'] = float(value[1])
    if metric_planning is not None:
        for i, metric in enumerate(metric_planning):
            for key, value in metric.compute().items():
                results[f'plan_{key}_{i + 1}s'] = float(np.asarray(value).mean())

    for key, value in results.items():
        log(f'{key} : {value:.6f}')
    log(f'{n_samples} samples in {seconds:.2f} s ({n_samples / seconds:.3f} samples/s)')
    if stats is not None:
        val = trainer.graphs['val']
        stats.update(samples=n_samples, seconds=seconds, forward_ms=forward_ms,
                     launches=val.launches_per_call, captures=val.captures)
    return results


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description='stp3_tpu_torch open-loop evaluation')
    parser.add_argument('--checkpoint', required=True,
                        help='checkpoint root, step directory or pointer file (last, best)')
    parser.add_argument('--dataroot', default='', help='dataset root override')
    parser.add_argument('--no-save', action='store_true', help='skip visualisations')
    parser.add_argument('--device', default=None,
                        help="torch device, e.g. 'cpu' (default: the card; none raises)")
    parser.add_argument('opts', nargs=argparse.REMAINDER, default=None)
    args = parser.parse_args(argv)
    evaluate(args.checkpoint, args.device, args.opts or None, dataroot=args.dataroot,
             save_visualisations=not args.no_save)


if __name__ == '__main__':
    main()
