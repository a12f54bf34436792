"""Training CLI of the port (counterpart of the JAX package's train.py;
reference train.py:14-61).

    python -m stp3_tpu_torch.train --config-file stp3_tpu/configs/nuscenes/Planning.yml \
        [--device cpu] [KEY VALUE ...]

(``--device`` before the KEY VALUE overrides.) Each epoch: train steps
(the loss logged every LOGGING_INTERVAL steps and at the first three),
validation with the trainer's metrics, and a checkpoint
(training/checkpoint.py) with a ``best`` pointer on the dynamic-class
vehicle IoU. ``CHECKPOINT.RESUME`` restores the weights, Adam, the
generator, the step and the monitor, and carries on where the run
stopped: at the epoch the step falls in, with that epoch's shuffle
order, up to EPOCHS in all (the reference Lightning trainer's
max_epochs; the JAX CLI runs EPOCHS more after a resume).
``PRETRAINED.LOAD_WEIGHTS`` with ``PRETRAINED.PATH`` warm-starts from a
checkpoint of the previous stage without its decoder heads.

``run(cfg, device)`` is the same run for a config built in code.
"""
from __future__ import annotations

import os
import socket
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from stp3_tpu_torch.config import get_cfg, get_parser
from stp3_tpu_torch.datas.dataloaders import prepare_dataloaders
from stp3_tpu_torch.training import checkpoint as ckpt_lib
from stp3_tpu_torch.training.trainer import Trainer, batch_to_device
from stp3_tpu_torch.utils.device import resolve_device


class StepTimer:
    """Per-call times of a loop without a host sync per call: CUDA events
    on the card (read once, at ``ms()``), wall time on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == 'cuda'
        self.spans: List[Any] = []

    def start(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.spans.append([ev, None])
        else:
            self.spans.append([time.perf_counter(), None])

    def stop(self) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.spans[-1][1] = ev
        else:
            self.spans[-1][1] = time.perf_counter()

    def last_ms(self) -> float:
        a, b = self.spans[-1]
        if self.cuda:
            b.synchronize()
            return a.elapsed_time(b)
        return (b - a) * 1e3

    def ms(self) -> List[float]:
        if self.cuda:
            torch.cuda.synchronize()
            return [a.elapsed_time(b) for a, b in self.spans]
        return [(b - a) * 1e3 for a, b in self.spans]


def format_metrics(metrics: Dict[str, Any]) -> List[str]:
    """'name: values' lines of ``Trainer.compute_metrics``' dict, every
    class and element (reference trainer.py:390-448)."""
    lines = []
    for k, v in metrics.items():
        for name, value in (v.items() if isinstance(v, dict) else [(None, v)]):
            lines.append(f'{k}/{name}: {np.asarray(value)}' if name else f'{k}: {np.asarray(value)}')
    return lines


def run(cfg, device=None, save_dir: Optional[str] = None,
        log: Callable[[str], None] = print) -> Dict[str, Any]:
    """Train ``cfg`` on ``device`` (the card unless named) up to
    cfg.EPOCHS epochs. Returns the run's record: ``save_dir``,
    ``ckpt_dir``, ``last`` (the newest checkpoint), ``start_step`` and
    ``start_best_iou`` (restored on resume, else 0 and -1), ``step``,
    ``best_iou``, the last epoch's ``metrics``, the last step's ``loss``,
    and ``train_ms`` / ``val_ms``, each train and val step's time."""
    device = resolve_device(device)
    if save_dir is None:
        save_dir = os.path.join(cfg.LOG_DIR, time.strftime('%d%B%Y_%H%M') + '_'
                                + socket.gethostname() + '_' + cfg.TAG)
    ckpt_dir = os.path.join(save_dir, cfg.CHECKPOINT.DIR)
    os.makedirs(ckpt_dir, exist_ok=True)

    trainloader, valloader = prepare_dataloaders(cfg)
    try:
        trainer = Trainer(cfg, device=device)
        n_params = sum(p.numel() for p in trainer.model.parameters())
        log(f'device {device}; {cfg.TAG}: {n_params / 1e6:.2f}M parameters, compute '
            f'{trainer.compute_dtype}; {len(trainloader)} train / {len(valloader)} val batches '
            f'an epoch')

        if cfg.PRETRAINED.LOAD_WEIGHTS and cfg.PRETRAINED.PATH:
            restored = ckpt_lib.load_checkpoint(cfg.PRETRAINED.PATH, map_location=device)
            merged, n = ckpt_lib.filter_warm_start_params(restored['model'],
                                                          trainer.model.state_dict())
            trainer.model.load_state_dict(merged)
            log(f'warm start: loaded {n} tensors from {cfg.PRETRAINED.PATH} (decoder heads '
                f'skipped)')

        # the best-by-val-IoU monitor, restored on resume (the reference keeps its
        # ModelCheckpoint monitor inside the checkpoint, train.py:36-42)
        best_iou = -1.0
        start_step = 0
        if cfg.CHECKPOINT.RESUME:
            start_step = ckpt_lib.restore_train_state(cfg.CHECKPOINT.RESUME, trainer)
            best_iou = float(ckpt_lib.load_meta(cfg.CHECKPOINT.RESUME)['metrics']
                             .get('best_iou', -1.0))
            log(f'resumed from {cfg.CHECKPOINT.RESUME} at step {trainer.step} (best val '
                f'vehicle IoU so far: {best_iou:.4f})')

        train_timer, val_timer = StepTimer(device), StepTimer(device)
        record: Dict[str, Any] = {'save_dir': save_dir, 'ckpt_dir': ckpt_dir, 'last': None,
                                  'metrics': None, 'loss': None, 'start_step': start_step,
                                  'start_best_iou': best_iou}
        log_every = max(int(cfg.LOGGING_INTERVAL), 1)
        loss = None
        for epoch in range(trainer.step // max(len(trainloader), 1), cfg.EPOCHS):
            trainloader.epoch = epoch             # this epoch's shuffle order
            for batch in trainloader:
                batch = batch_to_device(batch, device)
                train_timer.start()
                loss = trainer.train_step(batch)
                train_timer.stop()
                if trainer.step % log_every == 0 or trainer.step <= 3:
                    log(f'epoch {epoch} step {trainer.step} loss {loss["total"].item():.4f} '
                        f'({train_timer.last_ms():.0f} ms)')
            record['loss'] = loss

            trainer.reset_metrics()
            for batch in valloader:
                batch = batch_to_device(batch, device)
                val_timer.start()
                trainer.val_step(batch)
                val_timer.stop()
            metrics = trainer.compute_metrics()
            for line in format_metrics(metrics):
                log(f'epoch {epoch} val {line}')
            record['metrics'] = metrics

            if cfg.CHECKPOINT.SAVE_EVERY_EPOCH:
                # the reference's ModelCheckpoint monitors step_val_seg_iou_dynamic
                # (train.py:36-42) with mode='min', inert there under save_top_k=-1;
                # this monitor keeps the maximum, a deliberate divergence. Updated
                # before the save, so the checkpoint carries it for a resume.
                iou = np.asarray(metrics['iou_vehicle']).ravel()
                iou_dyn = float(iou[1]) if iou.size > 1 else float(iou[0])
                is_new_best = iou_dyn > best_iou
                best_iou = max(best_iou, iou_dyn)
                path = ckpt_lib.save_checkpoint(
                    ckpt_dir, trainer.step, trainer.model.state_dict(),
                    trainer.optimizer.state_dict(), cfg.convert_to_dict(),
                    trainer.generator.get_state(),
                    metrics={'best_iou': best_iou, 'monitor': 'iou_vehicle_dynamic'})
                record['last'] = path
                log(f'saved checkpoint {path}')
                if is_new_best:
                    with open(os.path.join(ckpt_dir, 'best'), 'w') as f:
                        f.write(path)
                    log(f'new best val vehicle IoU {iou_dyn:.4f} -> {path}')
        record.update(step=trainer.step, best_iou=best_iou, train_ms=train_timer.ms(),
                      val_ms=val_timer.ms())
        return record
    finally:
        trainloader.close()
        valloader.close()


def main(argv=None) -> None:
    parser = get_parser()
    parser.add_argument('--device', default=None,
                        help="torch device, e.g. 'cpu' (default: the card; none raises)")
    args = parser.parse_args(argv)
    record = run(get_cfg(args), args.device)
    print(f'done: step {record["step"]}, last checkpoint {record["last"]}')


if __name__ == '__main__':
    main()
