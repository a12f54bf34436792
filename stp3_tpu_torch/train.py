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
stopped, in its run directory: at the epoch the step falls in, with that
epoch's shuffle order, up to EPOCHS in all (the reference Lightning trainer's
max_epochs; the JAX CLI runs EPOCHS more after a resume).
``PRETRAINED.LOAD_WEIGHTS`` with ``PRETRAINED.PATH`` warm-starts from a
checkpoint of the previous stage without its decoder heads.

Data parallel, one process per card (``parallel/mesh.py``):

    torchrun --nproc_per_node N -m stp3_tpu_torch.train --config-file ... [KEY VALUE ...]

Each rank trains on ``cuda:LOCAL_RANK`` over NCCL (``--device cpu``:
gloo on the CPU) with its own rows of every global batch of N x
BATCHSIZE (``BATCHSIZE`` is per process, as in the JAX package); the
run directory is rank 0's, broadcast; only rank 0 logs, writes the
checkpoints and the ``best`` pointer, and every rank waits at a barrier
after each save. A resume loads on every rank, onto its own device;
rank 0 continues its generator's stream, the others reseed from (step,
rank).
The host batches reach the device through ``prefetch_to_device``.

Around the steps, as the JAX CLI (train.py:52-229):
  * a TensorBoard ``SummaryWriter`` on rank 0 in the run directory
    (without the tensorboard package: a message, and nothing written):
    ``step_train_loss_<k>`` at each logging step, ``epoch_val_<metric>``
    (``/<i>`` per element) and ``epoch_<name>_weight`` = 1 / (2 exp(w))
    of each uncertainty weight every epoch, and the GT-vs-prediction
    panel video (``utils/visualisation.visualise_output``) of the train
    batch every VIS_INTERVAL steps (``train_outputs``) and of the first
    val batch of each epoch (``val_outputs``; torch's ``add_video``
    needs moviepy and writes no frames without it);
  * ``PROFILE.ENABLED``: a ``torch.profiler`` trace on rank 0 of steps 2
    .. 1 + PROFILE.STEPS into PROFILE.DIR or ``<run dir>/profile``; each
    train step is a ``train_step_<n>`` range in it. At the window's end
    the log gives each stage's time a step (``utils/profiling``: on the
    card the device time of ``train.forward``, ``train.backward``,
    ``train.update`` and the model's ``stp3.*`` stages, replays included);
  * ``DEBUG.NAN_CHECK``: ``Trainer.train_step`` raises
    ``FloatingPointError`` at the first NaN loss term or gradient, before
    the update.

On the card the train steps, the validation and the panels' forwards
replay CUDA graphs (``Trainer``'s compiled calls): the first train steps
run eagerly, and the graphs are captured at the step after them, so after
the warm start and the resume, which load the weights, Adam's state and
the generator's state before any step. A gloo group trains
eagerly (its collectives cannot be captured); the log says which.

``run(cfg, device)`` is the same run for a config built in code; under
torchrun's environment it joins the process group first.
"""
from __future__ import annotations

import contextlib
import os
import socket
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from stp3_tpu_torch.config import get_cfg, get_parser
from stp3_tpu_torch.datas.dataloaders import prepare_dataloaders
from stp3_tpu_torch.training import checkpoint as ckpt_lib
from stp3_tpu_torch.parallel import mesh
from stp3_tpu_torch.training.trainer import Trainer
from stp3_tpu_torch.utils import graphs, profiling


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


def open_writer(save_dir: str, log: Callable[[str], None]):
    """A TensorBoard ``SummaryWriter`` into ``save_dir``, or None without
    the tensorboard package."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError as exc:
        log(f'no TensorBoard writer ({exc}): no scalars or panels are written')
        return None
    return SummaryWriter(save_dir)


def write_panels(writer, tag: str, output, labels, cfg, step: int) -> None:
    """The GT-vs-prediction panel video of a batch's first sample."""
    from stp3_tpu_torch.utils.visualisation import visualise_output
    panel = visualise_output(labels, output, cfg)                 # (T, H, W, 3)
    video = torch.from_numpy(np.ascontiguousarray(panel.transpose(0, 3, 1, 2))[None])
    writer.add_video(tag, video, global_step=step, fps=2)


def write_epoch_scalars(writer, metrics: Dict[str, Any], model, step: int) -> None:
    """Every validation metric, element by element, and each uncertainty
    weight w as 1 / (2 exp(w)) (reference trainer.py:390-448)."""
    for k, v in metrics.items():
        for name, value in (v.items() if isinstance(v, dict) else [(None, v)]):
            arr = np.asarray(value)
            prefix = f'{k}/{name}' if name else k
            if arr.size == 1:
                writer.add_scalar(f'epoch_val_{prefix}', float(arr.reshape(())), step)
            else:
                for i, x in enumerate(arr.ravel()):
                    writer.add_scalar(f'epoch_val_{prefix}/{i}', float(x), step)
    for name, w in model.named_parameters():
        if name.endswith('_weight') and w.ndim == 0:
            writer.add_scalar(f'epoch_{name.replace(".", "_")}',
                              1.0 / (2.0 * np.exp(float(w.detach()))), step)


def run(cfg, device=None, save_dir: Optional[str] = None,
        log: Callable[[str], None] = print) -> Dict[str, Any]:
    """Train ``cfg`` on ``device`` (the card unless named) up to
    cfg.EPOCHS epochs. Returns the run's record: ``save_dir``,
    ``ckpt_dir``, ``last`` (the newest checkpoint), ``start_step`` and
    ``start_best_iou`` (restored on resume, else 0 and -1), ``step``,
    ``best_iou``, the last epoch's ``metrics``, the last step's ``loss``,
    ``train_ms`` / ``val_ms``, each train and val step's time, whether the
    train steps were ``compiled`` and the trainer's compiled calls'
    ``graphs`` ({name: captures, and a kernel's launches in the last
    call}) (every rank returns the record; ``log`` is called on rank 0
    only)."""
    device = mesh.maybe_initialize_multihost(device)
    group = mesh.data_group()
    rank, world = mesh.process_index(group), mesh.process_count(group)
    main = rank == 0
    if not main:
        log = _quiet
    if save_dir is None:
        save_dir = _resumed_run_dir(cfg) or os.path.join(
            cfg.LOG_DIR, time.strftime('%d%B%Y_%H%M') + '_' + socket.gethostname() + '_'
            + cfg.TAG)
    save_dir = mesh.broadcast_string(save_dir, group)
    ckpt_dir = os.path.join(save_dir, cfg.CHECKPOINT.DIR)
    writer = profile_dir = None
    if main:
        os.makedirs(ckpt_dir, exist_ok=True)
        writer = open_writer(save_dir, log)
        if cfg.PROFILE.ENABLED:
            profile_dir = cfg.PROFILE.DIR or os.path.join(save_dir, 'profile')
            os.makedirs(profile_dir, exist_ok=True)
    # only rank 0 runs the train panels' forward: val_forward runs no collective
    # (eval mode: 'bn' on its running statistics), so the other ranks need not
    # know of the writer (the JAX CLI broadcasts it because its forward is one
    # program over every process)

    trainloader, valloader = prepare_dataloaders(cfg, rank=rank, world=world)
    profiler = contextlib.ExitStack()
    try:
        trainer = Trainer(cfg, device=device, group=group)
        n_params = sum(p.numel() for p in trainer.model.parameters())
        log(f'device {device}; {world} rank(s) of batch {cfg.BATCHSIZE}; {cfg.TAG}: '
            f'{n_params / 1e6:.2f}M parameters, compute {trainer.compute_dtype}; '
            f'{len(trainloader)} train / {len(valloader)} val batches an epoch')
        log(f'train steps: {_step_path(trainer, device)}')

        if cfg.PRETRAINED.LOAD_WEIGHTS and cfg.PRETRAINED.PATH:
            restored = ckpt_lib.load_checkpoint(cfg.PRETRAINED.PATH, map_location=device)
            merged, n = ckpt_lib.filter_warm_start_params(restored['model'],
                                                          trainer.model.state_dict())
            trainer.model.load_state_dict(merged)
            trainer.broadcast_state()
            log(f'warm start: loaded {n} tensors from {cfg.PRETRAINED.PATH} (decoder heads '
                f'skipped)')

        # the best-by-val-IoU monitor, restored on resume (the reference keeps its
        # ModelCheckpoint monitor inside the checkpoint, train.py:36-42)
        best_iou = -1.0
        start_step = 0
        if cfg.CHECKPOINT.RESUME:
            start_step = ckpt_lib.restore_train_state(cfg.CHECKPOINT.RESUME, trainer)
            trainer.broadcast_state()
            if rank:     # the checkpoint holds rank 0's generator; the others draw anew
                trainer.generator.manual_seed(mesh.rank_seed(start_step, rank))
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
            for batch in mesh.prefetch_to_device(trainloader, device):
                # the JAX CLI's window: the PROFILE.STEPS steps after the first
                if profile_dir is not None and trainer.step == 1:
                    profiler.enter_context(profiling.trace(profile_dir))
                train_timer.start()
                with torch.profiler.record_function(f'train_step_{trainer.step + 1}'):
                    loss = trainer.train_step(batch)
                train_timer.stop()
                if profile_dir is not None and trainer.step == 1 + cfg.PROFILE.STEPS:
                    profiler.close()
                    log(f'profiler trace written to {profile_dir}')
                    try:        # a window too long for the stamp ring must not stop the run
                        spans = profiling.window_spans()
                    except RuntimeError as exc:
                        spans = []
                        log(f'profiled stages unavailable: {exc}')
                    for name, ms in profiling.mean_ms(spans, cfg.PROFILE.STEPS).items():
                        log(f'profiled stage {name}: {ms:.3f} ms a step ({spans[0].device})')
                if trainer.step % log_every == 0 or trainer.step <= 3:
                    log(f'epoch {epoch} step {trainer.step} loss {loss["total"].item():.4f} '
                        f'({train_timer.last_ms():.0f} ms)')
                    if writer is not None:
                        for k, v in loss.items():
                            writer.add_scalar(f'step_train_loss_{k}', float(v), trainer.step)
                if writer is not None and cfg.VIS_INTERVAL > 0 and (
                        trainer.step % cfg.VIS_INTERVAL == 0):
                    try:          # the panels must never stop the training
                        output, labels = trainer.val_forward(batch)
                        write_panels(writer, 'train_outputs', output, labels, cfg,
                                     trainer.step)
                    except Exception as exc:
                        log(f'train visualisation failed: {exc!r}')
            record['loss'] = loss

            trainer.reset_metrics()
            for val_idx, batch in enumerate(mesh.prefetch_to_device(valloader, device)):
                val_timer.start()
                output, labels = trainer.val_step(batch)
                val_timer.stop()
                if val_idx == 0 and writer is not None:
                    try:
                        write_panels(writer, 'val_outputs', output, labels, cfg, trainer.step)
                    except Exception as exc:
                        log(f'visualisation failed: {exc!r}')
            metrics = trainer.compute_metrics()
            for line in format_metrics(metrics):
                log(f'epoch {epoch} val {line}')
            if writer is not None:
                write_epoch_scalars(writer, metrics, trainer.model, trainer.step)
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
                path = ckpt_lib.checkpoint_path(ckpt_dir, trainer.step)
                if main:
                    ckpt_lib.save_checkpoint(
                        ckpt_dir, trainer.step, trainer.model.state_dict(),
                        trainer.optimizer.state_dict(), cfg.convert_to_dict(),
                        trainer.generator.get_state(),
                        metrics={'best_iou': best_iou, 'monitor': 'iou_vehicle_dynamic'})
                    if is_new_best:
                        with open(os.path.join(ckpt_dir, 'best'), 'w') as f:
                            f.write(path)
                mesh.coordination_barrier(group)
                record['last'] = path
                log(f'saved checkpoint {path}')
                if is_new_best:
                    log(f'new best val vehicle IoU {iou_dyn:.4f} -> {path}')
        record.update(step=trainer.step, best_iou=best_iou, train_ms=train_timer.ms(),
                      val_ms=val_timer.ms(), compiled=trainer.compiled,
                      graphs={name: {'captures': call.captures,
                                     'launches': dict(call.launches_per_call)}
                              for name, call in trainer.graphs.items()})
        return record
    finally:
        profiler.close()
        if writer is not None:
            writer.close()
        trainloader.close()
        valloader.close()


def _resumed_run_dir(cfg) -> Optional[str]:
    """The run directory that CHECKPOINT.RESUME's checkpoint was saved in
    (``<run dir>/<CHECKPOINT.DIR>/step_<n>``), where a resumed run goes on
    writing; None without a resume or for a checkpoint saved elsewhere."""
    if not cfg.CHECKPOINT.RESUME:
        return None
    ckpt_dir = os.path.dirname(ckpt_lib.resolve_checkpoint_path(cfg.CHECKPOINT.RESUME))
    if os.path.basename(ckpt_dir) != cfg.CHECKPOINT.DIR:
        return None
    return os.path.dirname(ckpt_dir)


def _step_path(trainer: Trainer, device: torch.device) -> str:
    """Which path ``train_step`` takes, in words."""
    if not trainer.compiled:
        return (f'eager: the {torch.distributed.get_backend(trainer.group)} group\'s '
                'collectives cannot be captured in a CUDA graph')
    if device.type != 'cuda':
        return 'compiled calls, run eagerly on the CPU'
    return (f'compiled: CUDA graphs of the gradients and the update, captured after '
            f'{graphs.WARMUP_CALLS} eager steps (after any warm start or resume), then '
            'replayed; validation replays its own graph')


def _quiet(_: str) -> None:
    """The log of a rank other than 0."""


def main(argv=None) -> None:
    parser = get_parser()
    parser.add_argument('--device', default=None,
                        help="torch device, e.g. 'cpu' (default: the card; none raises)")
    args = parser.parse_args(argv)
    record = run(get_cfg(args), args.device)
    if mesh.is_main_process():
        print(f'done: step {record["step"]}, last checkpoint {record["last"]}')


if __name__ == '__main__':
    main()
