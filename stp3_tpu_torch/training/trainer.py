"""The training step (counterpart of stp3_tpu/training/trainer.py:59-351,
minus metrics, validation, checkpoints and the device mesh).

``Trainer.train_step(batch)``: label prep (GT warped to the present
frame) -> forward with bf16 copies of the fp32 master parameters (under
``PRECISION 16``) -> fp32 losses with the homoscedastic-uncertainty
weighting -> the planner's loss on GT occupancy -> backward -> clip the
global gradient norm -> Adam with L2 weight decay.

The optimizer is ``torch.nn.utils.clip_grad_norm_`` followed by
``torch.optim.Adam(weight_decay=...)``: the decay is added to the
gradient before the moments, and Adam puts ``eps`` outside the square
root of the bias-corrected second moment, as the JAX package's
``optax.chain(clip_by_global_norm, add_decayed_weights, adam)`` does.
(torch's clip divides by ``norm + 1e-6`` where optax divides by
``norm``: a relative difference of 1e-6 / norm.)
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch.func import functional_call

from stp3_tpu_torch.layers.base import init_parameters
from stp3_tpu_torch.losses import hdmap_loss, segmentation_loss, spatial_regression_loss
from stp3_tpu_torch.models.stp3 import STP3, STP3Config
from stp3_tpu_torch.ops.warp import cumulative_warp_features, cumulative_warp_features_reverse
from stp3_tpu_torch.utils.device import resolve_device
from stp3_tpu_torch.utils.network import prepare_image
from stp3_tpu_torch.utils.precision import cast_parameters, policy_dtype


def make_optimizer(cfg, params) -> torch.optim.Adam:
    """Adam with L2 decay added to the gradient (the clip runs in
    ``Trainer.train_step``)."""
    return torch.optim.Adam(params, lr=float(cfg.OPTIMIZER.LR),
                            weight_decay=float(cfg.OPTIMIZER.WEIGHT_DECAY))


def batch_to_device(batch: Mapping[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.asarray(v)).to(device) for k, v in batch.items()}


class Trainer:
    def __init__(self, cfg, device=None, seed: int = 0, model: Optional[STP3] = None):
        """``model``: an STP3 with the weights to train (fp32); by default
        one from the seeded init. ``seed`` also seeds the generator of the
        training-time random numbers, on ``device``."""
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
        self.optimizer = make_optimizer(cfg, self.model.parameters())
        self.generator = torch.Generator(self.device).manual_seed(seed)

    # ------------------------------------------------------------ labels
    def prepare_future_labels(self, batch) -> Dict[str, torch.Tensor]:
        """GT warped to the present frame, channels-last; integer labels
        warped as floats with nearest sampling."""
        cfg, rf = self.cfg, self.rf
        ego = batch['future_egomotion']
        labels = {'hdmap': batch['hdmap'][:, rf - 1].to(torch.int32),
                  'gt_trajectory': batch['gt_trajectory']}

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
                output['instance_center'], labels['centerness'], 2, rf, cfg.FUTURE_DISCOUNT))
            weighted('instance_offset', 'offset', spatial_regression_loss(
                output['instance_offset'], labels['offset'], 1, rf, cfg.FUTURE_DISCOUNT,
                cfg.DATASET.IGNORE_INDEX))
        if cfg.INSTANCE_FLOW.ENABLED:
            weighted('instance_flow', 'flow', spatial_regression_loss(
                output['instance_flow'], labels['flow'], 1, rf, cfg.FUTURE_DISCOUNT,
                cfg.DATASET.IGNORE_INDEX))
        if cfg.PLANNING.ENABLED:
            occ_ped = labels.get('pedestrian', torch.zeros_like(labels['segmentation']))
            occupancy = torch.logical_or(labels['segmentation'][:, rf:],
                                         occ_ped[:, rf:]).float()
            planner_params = {k[len('planner.'):]: v for k, v in params_c.items()
                              if k.startswith('planner.')}
            pl_loss, _ = functional_call(model.planner, planner_params, (
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
        """(total, loss dict) for a batch of device tensors. ``noise`` (B, 1,
        L) replaces the GAUSSIAN draw and ``dropout=False`` turns the masks
        off, for tests that hold this step to another implementation."""
        labels = self.prepare_future_labels(batch)
        params_c = cast_parameters(self.model, self.compute_dtype)
        image = prepare_image(batch['image'], self.compute_dtype)
        output = functional_call(
            self.model, params_c,
            (image, batch['intrinsics'], batch['extrinsics'], batch['future_egomotion']),
            {'train': True, 'generator': self.generator, 'noise': noise, 'dropout': dropout})
        output = {k: v.to(self.loss_dtype) if v is not None and v.is_floating_point() else v
                  for k, v in output.items()}
        loss = self._compute_losses(output, labels, batch, params_c)
        return sum(loss.values()), loss

    def train_step(self, batch, noise=None, dropout: bool = True) -> Dict[str, torch.Tensor]:
        """One optimizer step; returns the detached loss dict with 'total'.
        Nothing here waits for the device."""
        self.optimizer.zero_grad(set_to_none=True)
        total, loss = self.loss_fn(batch, noise, dropout)
        total.backward()
        torch.nn.utils.clip_grad_norm_(self.model.parameters(), float(self.cfg.GRAD_NORM_CLIP))
        self.optimizer.step()
        out = {k: v.detach() for k, v in loss.items()}
        out['total'] = total.detach()
        return out
