"""Evaluation metrics: semantic IoU, panoptic quality, planning L2 and
collisions (the port's counterpart of stp3_tpu/metrics.py; reference
stp3/metrics.py).

  * ``IoUMetric``: per-class TP/FP/FN/support counts.
  * ``PlanningMetric``: per-horizon L2 and two collision counters
    (point-wise ``obj_col``, footprint ``obj_box_col``), vectorised over
    batch and time; frames where the GT trajectory itself collides are
    skipped.
  * ``PanopticMetric``: PQ/SQ/RQ with IoU > 0.5 matching and temporally
    consistent vehicle ids, on host numpy (dynamic shapes, per-sequence id
    maps), as in the JAX package.

The per-batch increments of the IoU and planning metrics are computed on
the tensors' device and come to the host as one small tensor per update;
the totals accumulate on the host in int64 / float64 (fp32 or int32
device sums lose counts over a nuScenes train-split evaluation). Each
``state`` is a dict of additive arrays, so the states of several
processes sum to the state of one run.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from stp3_tpu_torch.ops.geometry import (calculate_birds_eye_view_parameters,
                                         ego_footprint_grid_pts)
from stp3_tpu_torch.utils.device import as_numpy, as_tensor
from stp3_tpu_torch.utils.rasterize import polygon


# =====================================================================
# Semantic IoU
# =====================================================================
def iou_counts(prediction: torch.Tensor, target: torch.Tensor, n_classes: int) -> torch.Tensor:
    """(4, n_classes) int64 [tp, fp, fn, support] of one batch, on the
    tensors' device."""
    pred = prediction.reshape(-1)
    tgt = target.reshape(-1)
    cls = torch.arange(n_classes, device=pred.device)[:, None]
    is_p = pred[None, :] == cls
    is_t = tgt[None, :] == cls
    return torch.stack([(is_p & is_t).sum(1), (is_p & ~is_t).sum(1), (~is_p & is_t).sum(1),
                        is_t.sum(1)])


class IoUMetric:
    """Reference IntersectionOverUnion (metrics.py:15-71)."""

    KEYS = ('tp', 'fp', 'fn', 'support')

    def __init__(self, n_classes: int, ignore_index: Optional[int] = None,
                 absent_score: float = 0.0):
        self.n_classes = n_classes
        self.ignore_index = ignore_index
        self.absent_score = absent_score
        self.reset()

    def reset(self):
        self.state = {k: np.zeros((self.n_classes,), np.int64) for k in self.KEYS}

    def update(self, prediction, target):
        pred = as_tensor(prediction)
        counts = iou_counts(pred, as_tensor(target, pred.device), self.n_classes).cpu().numpy()
        for k, row in zip(self.KEYS, counts):
            self.state[k] = self.state[k] + row.astype(np.int64)

    def compute(self) -> np.ndarray:
        tp, fp, fn, sup = (np.asarray(self.state[k], np.float64) for k in self.KEYS)
        scores = np.zeros(self.n_classes)
        for c in range(self.n_classes):
            if c == self.ignore_index:
                continue
            if sup[c] + tp[c] + fp[c] == 0:
                scores[c] = self.absent_score
                continue
            scores[c] = tp[c] / (tp[c] + fp[c] + fn[c])
        if self.ignore_index is not None and 0 <= self.ignore_index < self.n_classes:
            scores = np.concatenate([scores[:self.ignore_index], scores[self.ignore_index + 1:]])
        return scores


# =====================================================================
# Planning metric
# =====================================================================
class PlanningMetric:
    """Reference PlanningMetric (metrics.py:263-396): per-horizon L2 plus
    point-wise and footprint-polygon collision counts, skipping frames
    where the GT trajectory itself collides."""

    def __init__(self, cfg, n_future: int = 4):
        dx, bx, dim = calculate_birds_eye_view_parameters(
            cfg.LIFT.X_BOUND, cfg.LIFT.Y_BOUND, cfg.LIFT.Z_BOUND)
        self.dx = np.asarray(dx[:2])
        self.bx = np.asarray(bx[:2])
        self.bev_dimension = np.asarray(dim)
        self.W = cfg.EGO.WIDTH
        self.H = cfg.EGO.HEIGHT
        self.n_future = n_future
        pts = ego_footprint_grid_pts(self.W, self.H, self.bx, self.dx)
        rr, cc = polygon(pts[:, 1], pts[:, 0])
        self.footprint = np.stack([rr, cc], -1).astype(np.int32)      # (K, 2)
        self._footprint_on = {}       # device -> the footprint cells there, copied once
        self.reset()

    def reset(self):
        t = self.n_future
        self.state = {'obj_col': np.zeros((t,), np.int64),
                      'obj_box_col': np.zeros((t,), np.int64),
                      'l2': np.zeros((t,), np.float64),
                      'total': 0}

    def _footprint(self, device) -> torch.Tensor:
        if device not in self._footprint_on:
            self._footprint_on[device] = torch.as_tensor(self.footprint, device=device)
        return self._footprint_on[device]

    def _box_collision(self, traj: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
        """traj (B, T, 2) in the flipped frame; seg (B, T, H, W) bool ->
        (B, T): any footprint cell occupied (reference evaluate_single_coll)."""
        nx, ny = int(self.bev_dimension[0]), int(self.bev_dimension[1])
        # the reference swaps (x, y) -> (y, x), then divides by dx
        swapped = torch.stack([traj[..., 1] / float(self.dx[0]),
                               traj[..., 0] / float(self.dx[1])], -1)
        cells = swapped[:, :, None, :] + self._footprint(traj.device).to(traj.dtype)
        # truncation toward zero, then the clip (the JAX order)
        r = cells[..., 0].to(torch.int32).clamp(0, nx - 1).long()
        c = cells[..., 1].to(torch.int32).clamp(0, ny - 1).long()
        b, t = traj.shape[:2]
        b_idx = torch.arange(b, device=traj.device)[:, None, None]
        t_idx = torch.arange(t, device=traj.device)[None, :, None]
        return seg[b_idx, t_idx, r, c].any(-1)

    def increments(self, trajs: torch.Tensor, gt_trajs: torch.Tensor,
                   segmentation: torch.Tensor) -> torch.Tensor:
        """(3, T) float64 [obj_col, obj_box_col, l2 summed over the batch]
        of one batch, on the tensors' device. trajs / gt_trajs (B, T, 3);
        segmentation (B, T, H, W) {0, 1}."""
        nx, ny = int(self.bev_dimension[0]), int(self.bev_dimension[1])
        l2 = ((trajs[..., :2] - gt_trajs[..., :2]) ** 2).sum(-1).sqrt()      # (B, T)
        # the reference's * [-1, 1] (a negation is exact)
        tr = torch.stack([-trajs[..., 0], trajs[..., 1]], -1)
        gt = torch.stack([-gt_trajs[..., 0], gt_trajs[..., 1]], -1)
        seg = segmentation.bool()
        gt_box_coll = self._box_collision(gt, seg)
        box_coll = self._box_collision(tr, seg)
        # point-wise collision (reference metrics.py:337-347)
        yi = ((tr[..., 1] - float(self.bx[0])) / float(self.dx[0])).to(torch.int32)
        xi = ((tr[..., 0] - float(self.bx[1])) / float(self.dx[1])).to(torch.int32)
        inb = (yi >= 0) & (yi < nx) & (xi >= 0) & (xi < ny)
        b, t = trajs.shape[:2]
        b_idx = torch.arange(b, device=trajs.device)[:, None]
        t_idx = torch.arange(t, device=trajs.device)[None, :]
        occ = seg[b_idx, t_idx, yi.clamp(0, nx - 1).long(), xi.clamp(0, ny - 1).long()]
        obj_col = (occ & inb & ~gt_box_coll).sum(0)
        obj_box_col = (box_coll & ~gt_box_coll).sum(0)
        return torch.stack([obj_col.double(), obj_box_col.double(), l2.sum(0).double()])

    def update(self, trajs, gt_trajs, segmentation):
        trajs = as_tensor(trajs)
        inc = self.increments(trajs, as_tensor(gt_trajs, trajs.device),
                              as_tensor(segmentation, trajs.device)).cpu().numpy()
        self.state['obj_col'] += inc[0].astype(np.int64)
        self.state['obj_box_col'] += inc[1].astype(np.int64)
        self.state['l2'] += inc[2]
        self.state['total'] += int(trajs.shape[0])

    def compute(self) -> Dict[str, np.ndarray]:
        total = float(max(self.state['total'], 1))
        return {'obj_col': np.asarray(self.state['obj_col']) / total,
                'obj_box_col': np.asarray(self.state['obj_box_col']) / total,
                'L2': np.asarray(self.state['l2']) / total}


# =====================================================================
# Panoptic metric (host numpy)
# =====================================================================
class PanopticMetric:
    """Reference PanopticMetric (metrics.py:74-261): PQ/SQ/RQ via a
    bincount confusion matrix, IoU > 0.5 matching, and a per-sequence
    instance-id map enforcing temporal consistency for vehicles."""

    def __init__(self, n_classes: int, temporally_consistent: bool = True,
                 vehicles_id: int = 1):
        self.n_classes = n_classes
        self.temporally_consistent = temporally_consistent
        self.vehicles_id = vehicles_id
        self.reset()

    def reset(self):
        z = np.zeros(self.n_classes)
        self.state = {'iou': z.copy(), 'true_positive': z.copy(),
                      'false_positive': z.copy(), 'false_negative': z.copy()}

    def update(self, pred_instance, gt_instance):
        """pred_instance / gt_instance: (B, T, H, W) int; 0 = background."""
        pred_instance = as_numpy(pred_instance)
        gt_instance = as_numpy(gt_instance)
        assert gt_instance.min() == 0, 'ID 0 of gt_instance must be background'
        b, t = gt_instance.shape[:2]
        pred_seg = (pred_instance > 0).astype(np.int64)
        gt_seg = (gt_instance > 0).astype(np.int64)
        for i in range(b):
            unique_id_mapping: Dict[int, int] = {}
            for j in range(t):
                res = self._panoptic_metrics(pred_seg[i, j], pred_instance[i, j],
                                             gt_seg[i, j], gt_instance[i, j], unique_id_mapping)
                for k in self.state:
                    self.state[k] += res[k]

    def compute(self) -> Dict[str, np.ndarray]:
        tp = self.state['true_positive']
        denom = np.maximum(tp + self.state['false_positive'] / 2
                           + self.state['false_negative'] / 2, 1.0)
        return {'pq': self.state['iou'] / denom,
                'sq': self.state['iou'] / np.maximum(tp, 1.0),
                'rq': tp / denom}

    def _combine_mask(self, segmentation, instance, n_classes, n_all_things):
        """Shift instance ids past class ids; void -> 0 (reference
        metrics.py:238-261)."""
        instance = instance.reshape(-1).astype(np.int64)
        instance_mask = instance > 0
        instance = instance - 1 + n_classes
        seg = segmentation.reshape(-1).astype(np.int64).copy()
        seg_mask = seg < n_classes
        keep = instance_mask & seg_mask
        id_to_cls = -np.ones(n_all_things, dtype=np.int64)
        id_to_cls[instance[keep]] = seg[keep]
        id_to_cls[:n_classes] = np.arange(n_classes)
        seg[instance_mask] = instance[instance_mask]
        seg += 1
        seg[~seg_mask] = 0
        return seg, id_to_cls

    def _panoptic_metrics(self, pred_segmentation, pred_instance, gt_segmentation,
                          gt_instance, unique_id_mapping):
        n_classes = self.n_classes
        result = {k: np.zeros(n_classes) for k in
                  ('iou', 'true_positive', 'false_positive', 'false_negative')}
        n_instances = int(max(pred_instance.max(), gt_instance.max()))
        n_all_things = n_instances + n_classes
        n_things_and_void = n_all_things + 1

        prediction, pred_to_cls = self._combine_mask(
            pred_segmentation, pred_instance, n_classes, n_all_things)
        target, target_to_cls = self._combine_mask(
            gt_segmentation, gt_instance, n_classes, n_all_things)

        x = prediction + n_things_and_void * target
        conf = np.bincount(x, minlength=n_things_and_void ** 2).reshape(
            n_things_and_void, n_things_and_void)[1:, 1:]
        union = conf.sum(0)[None] + conf.sum(1)[:, None] - conf
        iou = np.where(union > 0, (conf + 1e-9) / (union + 1e-9), 0.0)

        mapping = np.argwhere(iou > 0.5)                         # (M, 2): (target, pred)
        is_matching = pred_to_cls[mapping[:, 1]] == target_to_cls[mapping[:, 0]]
        mapping = mapping[is_matching]
        tp_mask = np.zeros_like(conf, dtype=bool)
        tp_mask[mapping[:, 0], mapping[:, 1]] = True

        for target_id, pred_id in mapping:
            cls_id = pred_to_cls[pred_id]
            if (self.temporally_consistent and cls_id == self.vehicles_id
                    and target_id in unique_id_mapping
                    and unique_id_mapping[target_id] != pred_id):
                result['false_negative'][target_to_cls[target_id]] += 1
                result['false_positive'][pred_to_cls[pred_id]] += 1
                unique_id_mapping[target_id] = pred_id
                continue
            result['true_positive'][cls_id] += 1
            result['iou'][cls_id] += iou[target_id, pred_id]
            unique_id_mapping[target_id] = pred_id

        for target_id in range(n_classes, n_all_things):
            if tp_mask[target_id, n_classes:].any():
                continue
            if target_to_cls[target_id] != -1:
                result['false_negative'][target_to_cls[target_id]] += 1
        for pred_id in range(n_classes, n_all_things):
            if tp_mask[n_classes:, pred_id].any():
                continue
            if pred_to_cls[pred_id] != -1 and (conf[:, pred_id] > 0).any():
                result['false_positive'][pred_to_cls[pred_id]] += 1
        return result
