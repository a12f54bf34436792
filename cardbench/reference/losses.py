"""The losses of the Planning stage (ST-P3's ``losses.py``): the
segmentation terms (class-weighted cross-entropy over every frame, the
future ones discounted, top-k pixels) and the HD map term."""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from cardbench.reference.base import constant


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
    w = oh @ constant(tuple(float(c) for c in class_weights), logits.dtype, logits.device)
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


