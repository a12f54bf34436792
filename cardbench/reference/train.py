"""The Planning stage's training step in plain PyTorch, for the reference:
the labels warped to the present frame, the forward in training mode
(drop-connect, dropout and the latent drawn from the caller's generator
in the port's order), the uncertainty-weighted losses with the planner's
margin and smooth-L1 loss on the labels' occupancy, the backward, the
global-norm clip and Adam with L2 decay (ST-P3's ``trainer.py``)."""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from cardbench.reference.agent import normalise
from cardbench.reference.losses import hdmap_loss, segmentation_loss
from cardbench.reference.warp import cumulative_warp_features, cumulative_warp_features_reverse

BETA1 = 0.9                          # Adam's first-moment decay (torch's default)


def future_labels(batch: dict, rf: int, spatial_extent) -> Dict[str, torch.Tensor]:
    """GT warped to the present frame: the past frames forward, the future
    frames back, integer labels as floats with nearest sampling."""
    ego = batch['future_egomotion']

    def warp_split(x):
        past = cumulative_warp_features(x[:, :rf].float(), ego[:, :rf], 'nearest',
                                        spatial_extent)[:, :-1]
        future = cumulative_warp_features_reverse(x[:, rf - 1:].float(), ego[:, rf - 1:],
                                                  'nearest', spatial_extent)
        return torch.cat([past, future], 1)

    return {'hdmap': batch['hdmap'][:, rf - 1].to(torch.int32),
            'gt_trajectory': batch['gt_trajectory'],
            'segmentation': warp_split(batch['segmentation'][..., None])[..., 0].to(torch.int32),
            'pedestrian': warp_split(batch['pedestrian'][..., None])[..., 0].to(torch.int32)}


def losses(model, output: dict, labels: dict, batch: dict, t: dict) -> Dict[str, torch.Tensor]:
    """The loss terms: each task's loss / (2 exp(w)) and its 0.5 w."""
    rf = model.cfg.receptive_field
    out: Dict[str, torch.Tensor] = {}

    def weighted(key, value):
        w = getattr(model, f'{key}_weight')
        out[key] = value / (2.0 * torch.exp(w))
        out[f'{key}_uncertainty'] = 0.5 * w

    for key in ('segmentation', 'pedestrian'):
        weighted(key, segmentation_loss(output[key], labels[key], t[key]['WEIGHTS'], rf,
                                        t['FUTURE_DISCOUNT'], t[key]['USE_TOP_K'],
                                        t[key]['TOP_K_RATIO']))
    hd = t['hdmap']
    weighted('hdmap', hdmap_loss(output['hdmap'], labels['hdmap'], hd['WEIGHTS'],
                                 hd['TRAIN_WEIGHT'], hd['USE_TOP_K'], hd['TOP_K_RATIO']))
    occupancy = torch.logical_or(labels['segmentation'][:, rf:],
                                 labels['pedestrian'][:, rf:]).float()
    plan_loss, _ = model.planner(output['cam_front'].detach(),
                                 batch['sample_trajectory'][:, :, 1:].float(),
                                 labels['gt_trajectory'][:, 1:].float(),
                                 output['costvolume'][:, rf:], occupancy,
                                 labels['hdmap'].float(), batch['command'],
                                 batch['target_point'].float(), train=True)
    weighted('planning', plan_loss)
    return out


def loss(model, batch: dict, generator: torch.Generator, t: dict):
    """(total, terms) of one batch, every random number from ``generator``."""
    rf = model.cfg.receptive_field
    labels = future_labels(batch, rf, model.cfg.spatial_extent)
    output = model(normalise(batch['image']), batch['intrinsics'], batch['extrinsics'],
                   batch['future_egomotion'], train=True, generator=generator)
    terms = losses(model, output, labels, batch, t)
    return sum(terms.values()), terms


def train_steps(model, batches: List[dict], generator: torch.Generator, t: dict,
                adam: Optional[Dict[str, dict]] = None) -> dict:
    """``len(batches)`` optimizer steps: each step's total loss and loss
    terms, the first step's gradient as Adam took it (the clipped
    gradient plus the decay: the change of its first moment over
    1 - beta1), each leaf's change, and the leaves and Adam's state at
    the end. ``adam``: {leaf: Adam's state}
    to start from (its step count and moments); by default Adam's
    fresh state."""
    # a parametrised leaf (the control's fp8 kernels) under its own name
    params = {n.replace('parametrizations.', '').replace('.original', ''): p
              for n, p in model.named_parameters()}
    start = {n: p.detach().clone() for n, p in params.items()}
    opt = torch.optim.Adam(params.values(), lr=t['LR'], weight_decay=t['WEIGHT_DECAY'])
    moment = {n: torch.zeros_like(p) for n, p in params.items()}
    for n, state in (adam or {}).items():
        opt.state[params[n]] = {'step': torch.tensor(float(state['step'])),
                                'exp_avg': state['exp_avg'].float().clone(),
                                'exp_avg_sq': state['exp_avg_sq'].float().clone()}
        moment[n] = opt.state[params[n]]['exp_avg'].clone()
    totals, terms, first = [], [], None
    for batch in batches:
        opt.zero_grad(set_to_none=False)
        total, step_terms = loss(model, batch, generator, t)
        terms.append({**{k: float(v.detach()) for k, v in step_terms.items()},
                      'total': float(total.detach())})
        total.backward()
        torch.nn.utils.clip_grad_norm_(params.values(), t['GRAD_NORM_CLIP'])
        opt.step()
        totals.append(float(total.detach()))
        if first is None:
            first = {n: (opt.state[p]['exp_avg'] - BETA1 * moment[n]) / (1 - BETA1)
                     for n, p in params.items()}
    return {'losses': totals, 'terms': terms, 'grad': first,
            'change': {n: p.detach() - start[n] for n, p in params.items()},
            'params': {n: p.detach().clone() for n, p in params.items()},
            'adam': {n: dict(opt.state[p]) for n, p in params.items() if opt.state.get(p)}}
