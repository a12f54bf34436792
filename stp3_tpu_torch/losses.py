"""Loss functions (port of stp3_tpu/losses.py; reference stp3/losses.py).

Pure functions of (prediction, target), channels-last: seg (B, S, H, W,
C), hdmap (B, H, W, 2E), regression (B, S, H, W, C), depth (B, S, N, Hf,
Wf, D). Weighted cross-entropy with an ignore index, future-frame
discounting, top-k hardest pixels, masked L1/L2 regression, depth-bin
cross-entropy and the probabilistic KL terms. As in the reference, an
ignored pixel adds a zero to the mean's denominator.

Under data parallel (``parallel/mesh.py``) each rank computes its terms
on its own rows and the gradients are averaged over the ranks. That
equals the global batch's gradient wherever a term is a mean over a
per-rank tensor whose shape is the same on every rank, which holds for:
``segmentation_loss`` (a mean over (B, S, H*W), or over the top k of each
sample and frame, k fixed by the shape), ``hdmap_loss`` (a mean over (B,
H*W) or its per-sample top k, per element), ``depth_loss`` (a plain mean
over every pixel, ignored ones counting zero), ``gaussian_kl`` and
``bernoulli_kl`` (batch means), and the planner's loss (batch means,
``models/planning_model.py``). ``spatial_regression_loss`` divides by
the count of unmasked pixels, which differs between ranks, so it takes
the process ``group`` and divides by the global count.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F


def _future_discounts(s: int, n_present: int, discount: float, like: torch.Tensor
                      ) -> torch.Tensor:
    """[1] * n_present + [d^1 ... d^(s - n_present)]."""
    kw = dict(dtype=like.dtype, device=like.device)
    return torch.cat([torch.ones(n_present, **kw),
                      discount ** torch.arange(1, s - n_present + 1, **kw)])


def _weighted_ce(logits: torch.Tensor, target: torch.Tensor, class_weights,
                 ignore_index: int) -> torch.Tensor:
    """Per-pixel weighted cross-entropy, zero at ignored pixels (torch
    F.cross_entropy(weight=..., ignore_index=..., reduction='none')), as a
    one-hot contraction like the JAX function."""
    logp = F.log_softmax(logits, -1)
    valid = target != ignore_index
    oh = F.one_hot(torch.where(valid, target, 0).long(), logp.shape[-1]).to(logp.dtype)
    nll = -(logp * oh).sum(-1)
    w = oh @ torch.as_tensor(class_weights, dtype=logits.dtype, device=logits.device)
    return torch.where(valid, nll * w, torch.zeros((), dtype=nll.dtype, device=nll.device))


def segmentation_loss(prediction: torch.Tensor, target: torch.Tensor,
                      class_weights: Sequence[float], n_present: int = 3,
                      future_discount: float = 1.0, use_top_k: bool = False,
                      top_k_ratio: float = 1.0, ignore_index: int = 255) -> torch.Tensor:
    """prediction (B, S, H, W, C) logits; target (B, S, H, W) int."""
    b, s, h, w, _ = prediction.shape
    loss = _weighted_ce(prediction, target, class_weights, ignore_index)
    loss = loss * _future_discounts(s, n_present, future_discount, loss)[None, :, None, None]
    loss = loss.reshape(b, s, h * w)
    if use_top_k:
        loss = torch.topk(loss, int(top_k_ratio * h * w), -1).values
    return loss.mean()


def hdmap_loss(prediction: torch.Tensor, target: torch.Tensor,
               class_weights: Sequence[Sequence[float]], training_weights: Sequence[float],
               use_top_k: Sequence[bool], top_k_ratio: Sequence[float],
               ignore_index: int = 255) -> torch.Tensor:
    """prediction (B, H, W, 2E) logits; target (B, H, W, E) int, per element."""
    b, h, w, _ = prediction.shape
    total = torch.zeros((), dtype=prediction.dtype, device=prediction.device)
    for i in range(target.shape[-1]):
        cur = _weighted_ce(prediction[..., 2 * i:2 * (i + 1)], target[..., i],
                           class_weights[i], ignore_index).reshape(b, h * w)
        if use_top_k[i]:
            cur = torch.topk(cur, int(top_k_ratio[i] * h * w), -1).values
        total = total + cur.mean() * training_weights[i]
    return total


def spatial_regression_loss(prediction: torch.Tensor, target: torch.Tensor, norm: int,
                            n_present: int = 3, future_discount: float = 1.0,
                            ignore_index: int = 255, group=None) -> torch.Tensor:
    """prediction/target (B, S, H, W, C); L1 (norm=1) or MSE (norm=2),
    summed over channels, discounted, averaged over the pixels whose
    target[..., 0] is not ignored.

    ``group`` (data parallel): the count is summed over the ranks (it
    carries no gradient) and the result scaled by the world size, so the
    ranks' mean of it, and of its gradient, is the global batch's. Every
    rank joins the sum, a rank with no unmasked pixel too (its share is
    zero)."""
    if prediction.ndim != 5:
        raise ValueError('Must be a 5D tensor')
    mask = target[..., 0] != ignore_index
    if norm == 1:
        loss = (prediction - target).abs()
    elif norm == 2:
        loss = (prediction - target) ** 2
    else:
        raise ValueError(f'Expected norm 1 or 2, got {norm}')
    loss = loss.sum(-1)
    loss = loss * _future_discounts(loss.shape[1], n_present, future_discount,
                                    loss)[None, :, None, None]
    count = mask.sum()
    world = 1
    if group is not None:
        dist.all_reduce(count, group=group)
        world = dist.get_world_size(group)
    mean = (loss * mask).sum() / count.clamp_min(1) * world
    return torch.where(count > 0, mean, torch.zeros_like(mean))


def depth_loss(prediction: torch.Tensor, target: torch.Tensor,
               ignore_index: int = 255) -> torch.Tensor:
    """prediction (B, S, N, Hf, Wf, D) logits over depth bins; target int.
    Ignored pixels count zero in a plain mean over all pixels."""
    logp = F.log_softmax(prediction, -1)
    valid = target != ignore_index
    oh = F.one_hot(torch.where(valid, target, 0).long(), logp.shape[-1]).to(logp.dtype)
    nll = -(logp * oh).sum(-1)
    return torch.where(valid, nll, torch.zeros((), dtype=nll.dtype, device=nll.device)).mean()


def gaussian_kl(present_mu, present_log_sigma, future_mu, future_log_sigma):
    """KL(future || present), summed over the latent dim, batch-mean."""
    var_future = torch.exp(2 * future_log_sigma)
    var_present = torch.exp(2 * present_log_sigma)
    kl = (present_log_sigma - future_log_sigma - 0.5
          + (var_future + (future_mu - present_mu) ** 2) / (2 * var_present))
    return kl.sum(-1).mean()


def bernoulli_kl(present_log_prob, future_log_prob):
    """KL(future || present) with log targets, batch-mean."""
    kl = torch.exp(future_log_prob) * (future_log_prob - present_log_prob)
    return kl.sum() / present_log_prob.shape[0]


def probabilistic_loss(output: dict, method: str) -> torch.Tensor:
    """The reference's ProbabilisticLoss (defined there, never used by its
    trainer, nor by this package's)."""
    if method == 'GAUSSIAN':
        return gaussian_kl(output['present_mu'], output['present_log_sigma'],
                           output['future_mu'], output['future_log_sigma'])
    if method == 'MIXGAUSSIAN':
        return sum(gaussian_kl(output['present_mu'][i], output['present_log_sigma'][i],
                               output['future_mu'][i], output['future_log_sigma'][i])
                   for i in range(len(output['present_mu'])))
    if method == 'BERNOULLI':
        return bernoulli_kl(output['present_log_prob'], output['future_log_prob'])
    raise NotImplementedError(method)
