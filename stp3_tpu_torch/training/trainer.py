"""The training and validation steps (counterpart of
stp3_tpu/training/trainer.py, minus the device mesh).

``Trainer.train_step(batch)``: label prep (GT warped to the present
frame) -> forward with bf16 copies of the fp32 master parameters (under
``PRECISION 16``) -> fp32 losses with the homoscedastic-uncertainty
weighting -> the planner's loss on GT occupancy -> backward -> clip the
global gradient norm -> Adam with L2 weight decay.

Any stage YAML trains: the loss set follows the config (Perception:
segmentation, pedestrian and HD map; no instance, flow or planning
terms), and the labels are warped the same way at N_FUTURE_FRAMES 0.
Under MODEL.NORM 'bn' the model runs in training mode, so every 'bn'
site normalises with its batch's statistics and moves its running
statistics once a step: the forward's sites in the forward (not again in
REMAT's recomputation), the planner's in the planner's call.
``val_forward`` runs the model in eval mode, on the running statistics,
and returns the output in fp32 with the warped labels; ``val_step``
feeds them to the validation metrics (built from the config, as in the
JAX trainer), leaving out the rows the loader's ``valid`` mask marks;
``compute_metrics`` / ``reset_metrics`` read and clear them.
'bn_frozen''s statistics are buffers, which neither the optimizer, the
weight decay nor the clip sees (the JAX trainer's ``optax.masked``).

On the card the steps are compiled fixed-shape calls (``utils/graphs``,
the counterpart of the JAX trainer's jitted ``_train_step`` and
``_val_forward``): ``train_step`` replays two CUDA graphs, the gradients'
(``zero_grad`` in place, labels, forward, losses, backward) and the
update's (clip + Adam), with the host's work between them (the NaN check,
and with a group the gradient all-reduce); ``val_forward`` and
``val_step`` replay one graph of the eval forward and every metric's
increment (``validate``), read back once a batch. The parameters, Adam's
moments and step count and the 'bn' statistics are updated in place, at
the addresses the graphs read (the JAX step donates its state); each
batch is copied into the graph's buffers. The first ``WARMUP_CALLS``
train steps of a batch shape run eagerly, as real steps; a new batch
shape (a ragged last validation batch) is a new graph, as jit traces
again. The trainer's generator is registered with the graphs, so every
replay draws new masks and latents and leaves the generator where the
eager step would. A process group whose collectives cannot be captured
(gloo) trains eagerly: ``compiled`` says which path ``train_step`` takes.
On the CPU the same calls run eagerly. The step's stages
(``utils/profiling.stage``, traced inside the graphs' replays too):
``train.forward`` (labels, forward, losses; the planner's loss is its
``stp3.planner``), ``train.backward`` and ``train.update`` (clip + Adam).

The optimizer is ``torch.nn.utils.clip_grad_norm_`` followed by
``torch.optim.Adam(weight_decay=...)``: the decay is added to the
gradient before the moments, and Adam puts ``eps`` outside the square
root of the bias-corrected second moment, as the JAX package's
``optax.chain(clip_by_global_norm, add_decayed_weights, adam)`` does.
(torch's clip divides by ``norm + 1e-6`` where optax divides by
``norm``: a relative difference of 1e-6 / norm.)

Data parallel (``group``, a ``torch.distributed`` process group, one
process per card; ``parallel/mesh.py``): each rank steps on its own rows
of the global batch, and the step equals one step on the global batch,
as stp3_tpu's one jitted program over a batch-sharded mesh does. Rank 0's
parameters and buffers are broadcast at construction
(``broadcast_state`` again after a warm start or a resume); the gradients
are averaged over the ranks before the clip; ``spatial_regression_loss``
divides by the global mask count and 'bn' normalises with the global
batch's statistics; the returned loss terms are the ranks' mean, and
``compute_metrics`` sums the metric states over the ranks. Each rank's
generator is seeded from (seed, rank), so the dropout masks and latent
draws of a multi-rank run cannot equal stp3_tpu's, which draws one
global-shaped sample: a comparison passes ``noise=`` and
``dropout=False``.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.func import functional_call

from stp3_tpu_torch.layers.base import batch_norms, init_parameters
from stp3_tpu_torch.losses import (depth_loss, hdmap_loss, segmentation_loss,
                                   spatial_regression_loss)
from stp3_tpu_torch.metrics import IoUMetric, PanopticMetric, PlanningMetric, iou_counts
from stp3_tpu_torch.models.stp3 import STP3, STP3Config
from stp3_tpu_torch.ops.warp import cumulative_warp_features, cumulative_warp_features_reverse
from stp3_tpu_torch.parallel import mesh
from stp3_tpu_torch.utils import graphs, profiling
from stp3_tpu_torch.utils.device import resolve_device, rows_to_device, to_host
from stp3_tpu_torch.utils.instance import predict_instance_segmentation_and_trajectories
from stp3_tpu_torch.utils.instance_jit import decode_instances
from stp3_tpu_torch.utils.network import prepare_image
from stp3_tpu_torch.utils.precision import cast_parameters, policy_dtype


def make_optimizer(cfg, params) -> torch.optim.Adam:
    """Adam with L2 decay added to the gradient (the clip runs in
    ``Trainer.train_step``). On the card ``capturable``: its step count
    lives on the device, so a CUDA graph can take the step; torch has no
    capturable Adam on the CPU."""
    params = list(params)
    return torch.optim.Adam(params, lr=float(cfg.OPTIMIZER.LR),
                            weight_decay=float(cfg.OPTIMIZER.WEIGHT_DECAY),
                            capturable=bool(params) and params[0].is_cuda)


batch_to_device = mesh.batch_to_device


class Trainer:
    def __init__(self, cfg, device=None, seed: int = 0, model: Optional[STP3] = None,
                 group=None):
        """``model``: an STP3 with the weights to train (fp32); by default
        one from the seeded init. ``seed`` also seeds the generator of the
        training-time random numbers, on ``device`` (with ``group``: from
        (seed, rank)). ``group``: the process group to train over (see the
        module docstring); None trains alone."""
        self.cfg = cfg
        self.device = resolve_device(device)
        self.rf = cfg.TIME_RECEPTIVE_FIELD
        self.spatial_extent = (cfg.LIFT.X_BOUND[1], cfg.LIFT.Y_BOUND[1])
        self.compute_dtype = policy_dtype(cfg)
        # the losses in fp32 (log-softmax and friends are unstable in bf16),
        # or in float64 under PRECISION 64
        self.loss_dtype = torch.promote_types(self.compute_dtype, torch.float32)
        if model is None:
            model = init_parameters(STP3(STP3Config.from_cfg(cfg)),
                                    torch.Generator().manual_seed(seed))
        self.model = model.to(self.device).train()
        self.group = group
        if group is not None:
            for m in batch_norms(self.model):
                m.group = group
            self.broadcast_state()
        self.optimizer = make_optimizer(cfg, self.model.parameters())
        self.generator = torch.Generator(self.device).manual_seed(
            mesh.rank_seed(seed, mesh.process_index(group)))
        self.step = 0                 # optimizer steps taken (restored on resume)
        # the compiled calls; a gloo group's collectives cannot be captured
        self.compiled = group is None or dist.get_backend(group) == 'nccl'
        pool = graphs.Pool()
        self.graphs = {
            'gradients': graphs.compiled_step(
                self._gradients, self.model, optimizer=self.optimizer,
                generators=(self.generator,), device=self.device, pool=pool,
                name=f'Trainer gradients (MODEL.REMAT {cfg.MODEL.REMAT!r})'),
            'update': graphs.compiled_step(self._update, self.model, optimizer=self.optimizer,
                                           device=self.device, pool=pool,
                                           name='Trainer update (clip + Adam)'),
            'val': graphs.compiled(self._validate, self.model, pool=pool),
        }

        n_classes = len(cfg.SEMANTIC_SEG.VEHICLE.WEIGHTS)
        self.metric_vehicle_val = IoUMetric(n_classes)
        self.metric_pedestrian_val = (IoUMetric(n_classes)
                                      if cfg.SEMANTIC_SEG.PEDESTRIAN.ENABLED else None)
        self.metric_hdmap_val = ([IoUMetric(2, absent_score=1.0)
                                  for _ in cfg.SEMANTIC_SEG.HDMAP.ELEMENTS]
                                 if cfg.SEMANTIC_SEG.HDMAP.ENABLED else None)
        self.metric_panoptic_val = (PanopticMetric(n_classes)
                                    if cfg.INSTANCE_SEG.ENABLED else None)
        self.metric_planning_val = (PlanningMetric(cfg, cfg.N_FUTURE_FRAMES)
                                    if cfg.PLANNING.ENABLED else None)

    # ------------------------------------------------------------ labels
    def prepare_future_labels(self, batch) -> Dict[str, torch.Tensor]:
        """GT warped to the present frame, channels-last; integer labels
        warped as floats with nearest sampling."""
        cfg, rf = self.cfg, self.rf
        ego = batch['future_egomotion']
        labels = {'hdmap': batch['hdmap'][:, rf - 1].to(torch.int32),
                  'gt_trajectory': batch['gt_trajectory']}
        if cfg.LIFT.GT_DEPTH:
            # the depth bin of each feature pixel: every DOWNSAMPLE-th image
            # pixel of the past frames, clipped into D_BOUND
            down = cfg.MODEL.ENCODER.DOWNSAMPLE
            lo, hi = cfg.LIFT.D_BOUND[0], cfg.LIFT.D_BOUND[1]
            d = batch['depths'][:, :rf, :, ::down, ::down].clamp(lo, hi - 1)
            labels['depths'] = (d - lo).to(torch.int32)

        def warp_split(x):
            """past frames warped forward, future frames warped back"""
            past = cumulative_warp_features(x[:, :rf].float(), ego[:, :rf], 'nearest',
                                            self.spatial_extent)[:, :-1]
            future = cumulative_warp_features_reverse(x[:, rf - 1:].float(), ego[:, rf - 1:],
                                                      'nearest', self.spatial_extent)
            return torch.cat([past, future], 1)

        labels['segmentation'] = warp_split(batch['segmentation'][..., None])[..., 0].to(
            torch.int32)
        if cfg.SEMANTIC_SEG.PEDESTRIAN.ENABLED:
            labels['pedestrian'] = warp_split(batch['pedestrian'][..., None])[..., 0].to(
                torch.int32)
        if cfg.INSTANCE_SEG.ENABLED:
            labels['instance'] = warp_split(batch['instance'][..., None])[..., 0].to(
                torch.int32)
            labels['centerness'] = warp_split(batch['centerness'])
            labels['offset'] = warp_split(batch['offset'])
        if cfg.INSTANCE_FLOW.ENABLED:
            labels['flow'] = warp_split(batch['flow'])
        return labels

    # -------------------------------------------------------------- loss
    def _compute_losses(self, output, labels, batch, params_c) -> Dict[str, torch.Tensor]:
        cfg, rf, model = self.cfg, self.rf, self.model
        seg, ped, hd = cfg.SEMANTIC_SEG.VEHICLE, cfg.SEMANTIC_SEG.PEDESTRIAN, cfg.SEMANTIC_SEG.HDMAP
        loss: Dict[str, torch.Tensor] = {}

        def weighted(key, name, value):
            """1 / (2 exp(w)) * loss + 0.5 w, w the fp32 master log-variance"""
            w = getattr(model, f'{name}_weight')
            loss[key] = value / (2.0 * torch.exp(w))
            loss[f'{name}_uncertainty'] = 0.5 * w

        weighted('segmentation', 'segmentation', segmentation_loss(
            output['segmentation'], labels['segmentation'], seg.WEIGHTS, rf,
            cfg.FUTURE_DISCOUNT, seg.USE_TOP_K, seg.TOP_K_RATIO))
        if ped.ENABLED:
            weighted('pedestrian', 'pedestrian', segmentation_loss(
                output['pedestrian'], labels['pedestrian'], ped.WEIGHTS, rf,
                cfg.FUTURE_DISCOUNT, ped.USE_TOP_K, ped.TOP_K_RATIO))
        if hd.ENABLED:
            weighted('hdmap', 'hdmap', hdmap_loss(
                output['hdmap'], labels['hdmap'], hd.WEIGHTS, hd.TRAIN_WEIGHT, hd.USE_TOP_K,
                hd.TOP_K_RATIO))
        if cfg.INSTANCE_SEG.ENABLED:
            weighted('instance_center', 'centerness', spatial_regression_loss(
                output['instance_center'], labels['centerness'], 2, rf, cfg.FUTURE_DISCOUNT,
                group=self.group))
            weighted('instance_offset', 'offset', spatial_regression_loss(
                output['instance_offset'], labels['offset'], 1, rf, cfg.FUTURE_DISCOUNT,
                cfg.DATASET.IGNORE_INDEX, group=self.group))
        if cfg.LIFT.GT_DEPTH:
            weighted('depths', 'depths', depth_loss(output['depth_prediction'],
                                                    labels['depths']))
        if cfg.INSTANCE_FLOW.ENABLED:
            weighted('instance_flow', 'flow', spatial_regression_loss(
                output['instance_flow'], labels['flow'], 1, rf, cfg.FUTURE_DISCOUNT,
                cfg.DATASET.IGNORE_INDEX, group=self.group))
        if cfg.PLANNING.ENABLED:
            occ_ped = labels.get('pedestrian', torch.zeros_like(labels['segmentation']))
            occupancy = torch.logical_or(labels['segmentation'][:, rf:],
                                         occ_ped[:, rf:]).float()
            with profiling.stage('stp3.planner', occupancy):
                pl_loss, _ = functional_call(model.planner, _planner_params(params_c), (
                    output['cam_front'].detach().to(self.compute_dtype),
                    batch['sample_trajectory'][:, :, 1:],
                    labels['gt_trajectory'][:, 1:],
                    output['costvolume'][:, rf:],
                    occupancy,
                    labels['hdmap'].float(),
                    batch['command'],
                    batch['target_point']), {'train': True})
            weighted('planning', 'planning', pl_loss.to(self.loss_dtype))
        return loss

    def loss_fn(self, batch, noise=None, dropout: bool = True):
        """(total, loss dict) for a batch of device tensors. ``noise`` (of
        ``STP3.noise_shape``) replaces the latent draw and ``dropout=False``
        turns the masks off, for tests that hold this step to another
        implementation."""
        labels = self.prepare_future_labels(batch)
        params_c = cast_parameters(self.model, self.compute_dtype)
        image = prepare_image(batch['image'], self.compute_dtype)
        output = functional_call(
            self.model, params_c,
            (image, batch['intrinsics'], batch['extrinsics'], batch['future_egomotion']),
            {'train': True, 'generator': self.generator, 'noise': noise, 'dropout': dropout})
        output = {k: v.to(self.loss_dtype) if isinstance(v, torch.Tensor) and
                  v.is_floating_point() else v for k, v in output.items()}
        loss = self._compute_losses(output, labels, batch, params_c)
        return sum(loss.values()), loss

    def train_step(self, batch, noise=None, dropout: bool = True) -> Dict[str, torch.Tensor]:
        """One optimizer step; returns the detached loss dict with 'total'.
        ``compiled``: the gradients' call, the host's work, the update's
        call (each a CUDA graph on the card, after its warm-up steps);
        else ``compute_gradients`` and ``apply_gradients``. Nothing here
        waits for the device (but a gloo collective), unless
        DEBUG.NAN_CHECK: then ``check_nan`` reads the loss terms and the
        gradients back before the clip."""
        gradients, update = ((self.graphs['gradients'], self.graphs['update']) if self.compiled
                             else (self._gradients, self._update))
        out = self._reduce(gradients(batch, noise=noise, dropout=dropout))
        if self.cfg.DEBUG.NAN_CHECK:
            self.check_nan(out)
        update()
        self.step += 1
        return out

    def check_nan(self, loss: Mapping[str, torch.Tensor]) -> None:
        """Raise ``FloatingPointError`` at a NaN (not an inf, as
        ``jax_debug_nans``) in a loss term or a gradient of the step, naming
        the first (loss terms first, then the parameters in order). It runs
        before the clip and Adam, so the parameters, Adam's state and the
        step count are as they were; with a group the gradients are
        already the ranks' average, so every rank raises."""
        named = [(f'loss term {k!r}', v) for k, v in loss.items()]
        named += [(f'the gradient of {n}', p.grad) for n, p in self.model.named_parameters()
                  if p.grad is not None]
        flags = torch.stack([torch.isnan(t).any() for _, t in named]).cpu()
        if flags.any():
            bad = [name for (name, _), flag in zip(named, flags.tolist()) if flag]
            raise FloatingPointError(f'DEBUG.NAN_CHECK: NaN in {bad[0]} at step '
                                     f'{self.step + 1} ({len(bad)} NaN tensors in the step); '
                                     'no update was applied')

    def compute_gradients(self, batch, noise=None,
                          dropout: bool = True) -> Dict[str, torch.Tensor]:
        """The gradients of the step into ``.grad``, averaged over the
        ranks, eagerly; returns the detached loss dict with 'total' (the
        ranks' mean)."""
        return self._reduce(self._gradients(batch, noise, dropout))

    def apply_gradients(self) -> None:
        """Clip the (global) gradient norm, then Adam, eagerly."""
        self._update()
        self.step += 1

    def _gradients(self, batch, noise, dropout) -> Dict[str, torch.Tensor]:
        """The gradients' call: ``.grad`` zeroed in place (the graphs keep
        their addresses; a parameter without a gradient keeps none), the
        loss and backward; the detached loss terms with 'total'."""
        self.optimizer.zero_grad(set_to_none=False)
        with profiling.stage('train.forward', self.device):
            total, loss = self.loss_fn(batch, noise, dropout)
        with profiling.stage('train.backward', self.device):
            total.backward()
        out = {k: v.detach() for k, v in loss.items()}
        out['total'] = total.detach()
        return out

    def _reduce(self, out: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """With a group: the gradients and the loss terms averaged over the
        ranks (between the gradients' and the update's calls)."""
        if self.group is None:
            return out
        mesh.allreduce_gradients(self.model.parameters(), self.group)
        return mesh.allreduce_mean(out, self.group)

    def _update(self) -> None:
        """The update's call: clip the (global) gradient norm, then Adam."""
        with profiling.stage('train.update', self.device):
            torch.nn.utils.clip_grad_norm_(self.model.parameters(),
                                           float(self.cfg.GRAD_NORM_CLIP))
            self.optimizer.step()

    def broadcast_state(self) -> None:
        """Rank 0's parameters and buffers on every rank (at start, after
        a warm start or a resume); nothing without a group."""
        if self.group is not None:
            mesh.broadcast_module(self.model, self.group)

    def val_forward(self, batch) -> Tuple[Dict[str, Any], Dict[str, torch.Tensor]]:
        """(output, labels) of a batch: the model in eval mode (no masks, no
        noise, 'bn' on its running statistics) with the policy's parameter
        copies; with a planner also ``final_traj``, planned on the
        predicted occupancy. The output is cast to fp32 before anything
        takes an argmax of it (ties among bf16 logits break otherwise than
        among fp32 ones); the labels are ``prepare_future_labels``'. The
        compiled validation call (the graph ``validate`` replays)."""
        batch = {k: v for k, v in batch.items() if k != 'valid'}
        output, labels, _, _ = self.graphs['val'](batch, None)
        return output, labels

    @torch.no_grad()
    def _val_forward(self, batch) -> Tuple[Dict[str, Any], Dict[str, torch.Tensor]]:
        model, rf, dt = self.model, self.rf, self.compute_dtype
        labels = self.prepare_future_labels(batch)
        params_c = cast_parameters(model, dt)
        model.eval()
        try:
            output = functional_call(model, params_c, (
                prepare_image(batch['image'], dt), batch['intrinsics'], batch['extrinsics'],
                batch['future_egomotion']))
            if self.cfg.PLANNING.ENABLED:
                seg = output['segmentation'].argmax(-1)
                ped = (output['pedestrian'].argmax(-1)
                       if self.cfg.SEMANTIC_SEG.PEDESTRIAN.ENABLED else torch.zeros_like(seg))
                _, output['final_traj'] = functional_call(
                    model.planner, _planner_params(params_c), (
                        output['cam_front'], batch['sample_trajectory'][:, :, 1:].to(dt),
                        labels['gt_trajectory'][:, 1:].to(dt), output['costvolume'][:, rf:],
                        torch.logical_or(seg, ped)[:, rf:].to(dt), output['hdmap'],
                        batch['command'], batch['target_point'].to(dt)))
        finally:
            model.train()
        return _to_fp32(output), labels

    def metric_increments(self, output, labels, valid=None) -> Dict[str, torch.Tensor]:
        """Each validation metric's increment of a batch, on the device:
        the IoU counts of vehicles, pedestrians and each HD-map element, the
        planning metric's (3, N_FUTURE_FRAMES) increments; ``valid`` (B,)
        bool weights the padding rows out."""
        rf = self.rf
        inc = {'vehicle': iou_counts(output['segmentation'].argmax(-1)[:, rf - 1:],
                                     labels['segmentation'][:, rf - 1:],
                                     self.metric_vehicle_val.n_classes, valid)}
        if self.metric_pedestrian_val is not None:
            inc['pedestrian'] = iou_counts(output['pedestrian'].argmax(-1)[:, rf - 1:],
                                           labels['pedestrian'][:, rf - 1:],
                                           self.metric_pedestrian_val.n_classes, valid)
        for i, metric in enumerate(self.metric_hdmap_val or ()):
            inc[f'hdmap_{i}'] = iou_counts(output['hdmap'][..., 2 * i:2 * (i + 1)].argmax(-1),
                                           labels['hdmap'][..., i], metric.n_classes, valid)
        if self.metric_planning_val is not None:
            seg_lab = labels['segmentation'][:, rf:]
            ped_lab = labels['pedestrian'][:, rf:] if 'pedestrian' in labels else (
                torch.zeros_like(seg_lab))
            inc['planning'] = self.metric_planning_val.increments(
                output['final_traj'], labels['gt_trajectory'][:, 1:],
                torch.logical_or(seg_lab, ped_lab), valid)
        return inc

    def _validate(self, batch, valid):
        """The compiled validation call: (output, labels, the metric
        increments, and with INSTANCE_SEG the per-frame instance ids
        decoded on the device, else None)."""
        output, labels = self._val_forward(batch)
        ids = None
        if self.metric_panoptic_val is not None:
            ids = decode_instances(output['segmentation'], output['instance_center'],
                                   output['instance_offset'])
        return output, labels, self.metric_increments(output, labels, valid), ids

    def validate(self, batch) -> Tuple[Dict[str, Any], Dict[str, torch.Tensor], Dict[str, Any]]:
        """(output, labels, host) of a batch: the compiled validation call,
        then ONE wait for the device that brings ``host``: every metric
        increment (numpy), 'samples' (the rows the ``valid`` mask keeps),
        'valid' (that mask or None) and, with INSTANCE_SEG, the decoded
        'instance_ids', the 'instance_labels' from the present frame on
        and the 'instance_flow' (or None) for the host's linking."""
        batch = dict(batch)
        valid = batch.pop('valid', None)
        vmask = None if valid is None else np.asarray(valid, bool)
        # every row valid: nothing to weight out, and the signature of a batch
        # without a mask (the panels' forwards of train batches replay it too)
        rows = None if vmask is None or vmask.all() else rows_to_device(vmask, self.device)
        output, labels, increments, ids = self.graphs['val'](batch, rows)
        fetch = dict(increments)
        if ids is not None:
            fetch['instance_ids'] = ids
            fetch['instance_labels'] = labels['instance'][:, self.rf - 1:]
            if output.get('instance_flow') is not None:
                fetch['instance_flow'] = output['instance_flow']
        host: Dict[str, Any] = to_host(fetch)
        host['valid'] = vmask
        host['samples'] = int(batch['image'].shape[0]) if vmask is None else int(vmask.sum())
        return output, labels, host

    def add_increments(self, host: Mapping[str, Any]) -> None:
        """Add ``validate``'s host increments to the validation metrics; the
        panoptic metric links the decoded ids over time on the host
        (Hungarian), and takes the valid rows."""
        self.metric_vehicle_val.add(host['vehicle'])
        if self.metric_pedestrian_val is not None:
            self.metric_pedestrian_val.add(host['pedestrian'])
        for i, metric in enumerate(self.metric_hdmap_val or ()):
            metric.add(host[f'hdmap_{i}'])
        if self.metric_planning_val is not None:
            self.metric_planning_val.add(host['planning'], host['samples'])
        if self.metric_panoptic_val is not None and host['samples']:
            consistent = predict_instance_segmentation_and_trajectories(
                {'instance_flow': host.get('instance_flow')}, decoded=host['instance_ids'])
            rows = slice(None) if host['valid'] is None else host['valid']
            self.metric_panoptic_val.update(consistent[rows][:, self.rf - 1:],
                                            host['instance_labels'][rows])

    def val_step(self, batch) -> Tuple[Dict[str, Any], Dict[str, torch.Tensor]]:
        """``validate`` and the metric updates (reference
        trainer.py:199-250). A ``valid`` key (a per-row bool, the loader's
        ``with_valid_mask``) marks the wrap-around padding rows of a ragged
        multi-process validation tail: those rows enter no metric (a batch
        of padding only updates none), so the summed metrics equal a
        one-process run's."""
        output, labels, host = self.validate(batch)
        self.add_increments(host)
        return output, labels

    # ----------------------------------------------------------- metrics
    def _all_metrics(self):
        ms = [self.metric_vehicle_val, self.metric_pedestrian_val,
              self.metric_panoptic_val, self.metric_planning_val]
        if self.metric_hdmap_val is not None:
            ms.extend(self.metric_hdmap_val)
        return [m for m in ms if m is not None]

    def compute_metrics(self) -> Dict[str, Any]:
        """The validation metrics; with a group, of the states summed over
        the ranks (each rank's own states are left as they were)."""
        if self.group is None:
            return self._compute_metrics()
        metrics = self._all_metrics()
        local = [m.state for m in metrics]
        try:
            for m in metrics:
                m.state = mesh.allreduce_host_tree(m.state, self.group)
            return self._compute_metrics()
        finally:
            for m, state in zip(metrics, local):
                m.state = state

    def _compute_metrics(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {'iou_vehicle': self.metric_vehicle_val.compute()}
        if self.metric_pedestrian_val is not None:
            out['iou_pedestrian'] = self.metric_pedestrian_val.compute()
        if self.metric_hdmap_val is not None:
            for name, metric in zip(self.cfg.SEMANTIC_SEG.HDMAP.ELEMENTS, self.metric_hdmap_val):
                out[f'iou_hdmap_{name}'] = metric.compute()
        if self.metric_panoptic_val is not None:
            out['panoptic'] = self.metric_panoptic_val.compute()
        if self.metric_planning_val is not None:
            out['planning'] = self.metric_planning_val.compute()
        return out

    def reset_metrics(self):
        for m in self._all_metrics():
            m.reset()


def _to_fp32(output: Dict[str, Any]) -> Dict[str, Any]:
    """Every floating tensor of an output dict (and of its lists) in fp32."""
    def conv(v):
        if isinstance(v, (list, tuple)):
            return [conv(x) for x in v]
        if isinstance(v, torch.Tensor) and v.is_floating_point():
            return v.float()
        return v
    return {k: conv(v) for k, v in output.items()}


def _planner_params(params_c: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The planner's entries of a model's parameter dict, in its own names."""
    return {k[len('planner.'):]: v for k, v in params_c.items() if k.startswith('planner.')}
