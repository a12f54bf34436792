"""Open-loop evaluation CLI of the port (counterpart of the JAX package's
evaluate.py; reference evaluate.py:28-169).

    python -m stp3_tpu_torch.evaluate --checkpoint <ckpt dir, step dir or pointer> \
        [--device cpu] [KEY VALUE ...]

Loads a checkpoint of the port (training/checkpoint.py) and the config
stored beside it, then runs the no-grad loop over the validation split
at batch 1: IoU of vehicles, pedestrians and each HD-map element, the
panoptic metrics through ``predict_instance_segmentation_and_trajectories``
(its per-frame decode on the device), and the planning metrics per
second of horizon (``PlanningMetric(cfg, 2 (i + 1))``, reference
evaluate.py:70-73,135-137). Planning runs on the PREDICTED occupancy and
HD map; the collisions are scored against the GT occupancy (reference
:121-137).
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from stp3_tpu_torch.config import get_cfg
from stp3_tpu_torch.datas.dataloaders import prepare_dataloaders
from stp3_tpu_torch.metrics import IoUMetric, PanopticMetric, PlanningMetric
from stp3_tpu_torch.training import checkpoint as ckpt_lib
from stp3_tpu_torch.training.trainer import Trainer, batch_to_device
from stp3_tpu_torch.utils.device import resolve_device
from stp3_tpu_torch.utils.instance import predict_instance_segmentation_and_trajectories


def eval_cfg(checkpoint_path: str, extra_opts=None):
    """The checkpoint's config with the evaluation-time changes (reference
    evaluate.py:40-44): batch 1, no GT depth, REMAT none (a train-time
    policy)."""
    cfg_dict = ckpt_lib.load_config_dict(checkpoint_path)
    if cfg_dict is None:
        raise FileNotFoundError(f'no config.json beside checkpoint {checkpoint_path}')
    cfg = get_cfg(cfg_dict=cfg_dict)
    cfg.BATCHSIZE = 1
    cfg.LIFT.GT_DEPTH = False
    cfg.MODEL.REMAT = 'none'
    if extra_opts:
        cfg.merge_from_list(extra_opts)
    return cfg


def evaluate(checkpoint_path: str, device=None, extra_opts=None,
             log: Callable[[str], None] = print,
             stats: Optional[Dict[str, Any]] = None) -> Dict[str, float]:
    """The evaluation's results, {name: value}. ``stats``, if given,
    receives ``samples``, the loop's wall-clock ``seconds`` and each
    sample's ``forward_ms``: ``val_forward`` and the vehicle IoU update,
    which reads its result back (wall clock)."""
    device = resolve_device(device)
    cfg = eval_cfg(checkpoint_path, extra_opts)
    _, valloader = prepare_dataloaders(cfg, split='val')
    try:
        trainer = Trainer(cfg, device=device)
        state = ckpt_lib.load_checkpoint(checkpoint_path, map_location=device)
        trainer.model.load_state_dict(state['model'])
        log(f'Loaded weights from {ckpt_lib.resolve_checkpoint_path(checkpoint_path)} '
            f'(step {state["step"]}) on {device}')

        rf = cfg.TIME_RECEPTIVE_FIELD
        n_classes = len(cfg.SEMANTIC_SEG.VEHICLE.WEIGHTS)
        hdmap_class = cfg.SEMANTIC_SEG.HDMAP.ELEMENTS
        metric_vehicle = IoUMetric(n_classes)
        metric_pedestrian = (IoUMetric(n_classes)
                             if cfg.SEMANTIC_SEG.PEDESTRIAN.ENABLED else None)
        metric_hdmap = ([IoUMetric(2, absent_score=1.0) for _ in hdmap_class]
                        if cfg.SEMANTIC_SEG.HDMAP.ENABLED else None)
        metric_panoptic = PanopticMetric(n_classes) if cfg.INSTANCE_SEG.ENABLED else None
        metric_planning = ([PlanningMetric(cfg, 2 * (i + 1))
                            for i in range(cfg.N_FUTURE_FRAMES // 2)]
                           if cfg.PLANNING.ENABLED else None)

        forward_ms, n_samples = [], 0
        t0 = time.perf_counter()
        for batch in valloader:
            batch = batch_to_device(batch, device)
            # one process: the loader pads nothing, so every row must be valid
            valid = batch.pop('valid', None)
            if valid is not None and not np.asarray(valid).all():
                raise ValueError('padding rows in a one-process evaluation')
            t1 = time.perf_counter()
            output, labels = trainer.val_forward(batch)
            metric_vehicle.update(output['segmentation'].argmax(-1)[:, rf - 1:],
                                  labels['segmentation'][:, rf - 1:])
            forward_ms.append((time.perf_counter() - t1) * 1e3)
            if metric_pedestrian is not None:
                metric_pedestrian.update(output['pedestrian'].argmax(-1)[:, rf - 1:],
                                         labels['pedestrian'][:, rf - 1:])
            if metric_hdmap is not None:
                for i, metric in enumerate(metric_hdmap):
                    metric.update(output['hdmap'][..., 2 * i:2 * (i + 1)].argmax(-1),
                                  labels['hdmap'][..., i])
            if metric_panoptic is not None:
                consistent = predict_instance_segmentation_and_trajectories(output)
                metric_panoptic.update(consistent[:, rf - 1:], labels['instance'][:, rf - 1:])
            if metric_planning is not None:
                seg_lab = labels['segmentation'][:, rf:]
                ped_lab = (labels['pedestrian'][:, rf:] if 'pedestrian' in labels
                           else torch.zeros_like(seg_lab))
                occupancy = torch.logical_or(seg_lab, ped_lab)
                for i, metric in enumerate(metric_planning):
                    t = (i + 1) * 2
                    metric.update(output['final_traj'][:, :t],
                                  labels['gt_trajectory'][:, 1:t + 1], occupancy[:, :t])
            n_samples += int(batch['image'].shape[0])
        seconds = time.perf_counter() - t0
    finally:
        valloader.close()

    results: Dict[str, float] = {'vehicle_iou': float(metric_vehicle.compute()[1])}
    if metric_pedestrian is not None:
        results['pedestrian_iou'] = float(metric_pedestrian.compute()[1])
    if metric_hdmap is not None:
        for name, metric in zip(hdmap_class, metric_hdmap):
            results[f'{name}_iou'] = float(metric.compute()[1])
    if metric_panoptic is not None:
        for key, value in metric_panoptic.compute().items():
            results[f'vehicle_{key}'] = float(value[1])
    if metric_planning is not None:
        for i, metric in enumerate(metric_planning):
            for key, value in metric.compute().items():
                results[f'plan_{key}_{i + 1}s'] = float(np.asarray(value).mean())

    for key, value in results.items():
        log(f'{key} : {value:.6f}')
    log(f'{n_samples} samples in {seconds:.2f} s ({n_samples / seconds:.3f} samples/s)')
    if stats is not None:
        stats.update(samples=n_samples, seconds=seconds, forward_ms=forward_ms)
    return results


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description='stp3_tpu_torch open-loop evaluation')
    parser.add_argument('--checkpoint', required=True,
                        help='checkpoint root, step directory or pointer file (last, best)')
    parser.add_argument('--device', default=None,
                        help="torch device, e.g. 'cpu' (default: the card; none raises)")
    parser.add_argument('opts', nargs=argparse.REMAINDER, default=None)
    args = parser.parse_args(argv)
    evaluate(args.checkpoint, args.device, args.opts or None)


if __name__ == '__main__':
    main()
