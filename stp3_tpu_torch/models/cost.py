"""Planner cost terms over the BEV grid (port of stp3_tpu/models/cost.py).

Seven costs per candidate trajectory and future step: learned cost
volume, rule (off-drivable), safety, headway, lane-divider distance,
comfort and progress, summed into a per-step ``cost_fo`` and a
whole-trajectory ``cost_fc``. Footprint sums come from integral images
of an edge-padded grid (one gather per trajectory point); the lane
divider distance is a static-shape local distance field.
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from stp3_tpu.utils.rasterize import polygon
from stp3_tpu_torch.ops.geometry import calculate_birds_eye_view_parameters


@dataclasses.dataclass(frozen=True)
class CostConfig:
    x_bound: Tuple[float, float, float]
    y_bound: Tuple[float, float, float]
    z_bound: Tuple[float, float, float]
    ego_width: float
    ego_height: float
    n_future: int
    safety: float
    lambda_: float
    headway: float
    lrdivider: float
    comfort: float
    progress: float
    volume: float

    @classmethod
    def from_cfg(cls, cfg) -> "CostConfig":
        cf = cfg.COST_FUNCTION
        return cls(
            x_bound=tuple(cfg.LIFT.X_BOUND), y_bound=tuple(cfg.LIFT.Y_BOUND),
            z_bound=tuple(cfg.LIFT.Z_BOUND), ego_width=cfg.EGO.WIDTH,
            ego_height=cfg.EGO.HEIGHT, n_future=cfg.N_FUTURE_FRAMES,
            safety=cf.SAFETY, lambda_=cf.LAMBDA, headway=cf.HEADWAY,
            lrdivider=cf.LRDIVIDER, comfort=cf.COMFORT, progress=cf.PROGRESS,
            volume=cf.VOLUME)


@lru_cache(maxsize=8)
def ego_footprint_offsets(x_bound: Tuple, y_bound: Tuple, z_bound: Tuple,
                          ego_w: float, ego_h: float, lambda_pad: float = 0.0) -> np.ndarray:
    """Integer (row, col) cell offsets of the ego footprint polygon, dilated
    by ``lambda_pad`` METRES on every side (the reference passes
    int(LAMBDA / dx) here as metres; callers reproduce that)."""
    res, start, _ = calculate_birds_eye_view_parameters(list(x_bound), list(y_bound),
                                                        list(z_bound))
    dx, bx = res[:2], start[:2]
    lam = float(lambda_pad)
    pts = np.array([
        [-ego_h / 2.0 + 0.5 - lam, ego_w / 2.0 + lam],
        [ego_h / 2.0 + 0.5 + lam, ego_w / 2.0 + lam],
        [ego_h / 2.0 + 0.5 + lam, -ego_w / 2.0 - lam],
        [-ego_h / 2.0 + 0.5 - lam, -ego_w / 2.0 - lam],
    ])
    pts = (pts - bx) / dx
    pts[:, [0, 1]] = pts[:, [1, 0]]
    rr, cc = polygon(pts[:, 1], pts[:, 0])
    return np.stack([rr, cc], axis=-1).astype(np.int32)


class CostFunction:
    """``__call__(cost_volume, trajs, semantic_pred, lane_divider,
    drivable_area, target_points) -> (cost_fc (B, N), cost_fo (B, N, T))``.
    ``trajs`` are raw sampler outputs; the reference's ``* [-1, 1]`` flip
    is applied inside. Grids are (B, T, H, W); maps channels-last."""

    def __init__(self, cc: CostConfig):
        res, start, dim = calculate_birds_eye_view_parameters(
            list(cc.x_bound), list(cc.y_bound), list(cc.z_bound))
        self.dx, self.bx, self.bev_dimension = res[:2], start[:2], dim
        self.W, self.H = cc.ego_width, cc.ego_height
        self.f_safety, self.f_lambda = cc.safety, cc.lambda_
        self.f_headway, self.f_lrdivider = cc.headway, cc.lrdivider
        self.f_comfort, self.f_progress = cc.comfort, cc.progress
        self.f_volume = cc.volume
        xb, yb, zb = cc.x_bound, cc.y_bound, cc.z_bound
        self._fp0 = ego_footprint_offsets(xb, yb, zb, self.W, self.H, 0.0)
        lam_pad = float(int(self.f_lambda / float(self.dx[0])))
        self._fp_lam = ego_footprint_offsets(xb, yb, zb, self.W, self.H, lam_pad)

    def _dx(self, like: torch.Tensor) -> torch.Tensor:
        return torch.as_tensor(self.dx, device=like.device)

    # ---------------------------------------------------------------- utils
    def _footprint_map(self, grid: torch.Tensor, footprint: np.ndarray):
        """Per-centre-cell footprint sums on the extended domain (see the
        JAX docstring): returns (map, r0, c0) for ``_gather_map``."""
        h, w = grid.shape[-2:]
        fp = np.asarray(footprint)
        if fp.size == 0:
            return torch.zeros_like(grid), 0, 0
        rmin, rmax = int(fp[:, 0].min()), int(fp[:, 0].max())
        cmin, cmax = int(fp[:, 1].min()), int(fp[:, 1].max())
        lr, lc = rmax - rmin, cmax - cmin
        padded = F.pad(grid, (lc, lc, lr, lr), mode='replicate')
        hext, wext = h + lr, w + lc
        if fp.shape[0] == (lr + 1) * (lc + 1):
            # axis-aligned rectangle: a box filter via the integral image
            ii = torch.cumsum(torch.cumsum(padded.float(), -2), -1)
            ii = F.pad(ii, (1, 0, 1, 0))
            r1, c1 = lr + 1, lc + 1
            out = (ii[..., r1:r1 + hext, c1:c1 + wext] - ii[..., :hext, c1:c1 + wext]
                   - ii[..., r1:r1 + hext, :wext] + ii[..., :hext, :wext])
            return out.to(grid.dtype), rmax, cmax
        out = None
        for rr_k, cc_k in fp:
            r, c = int(rr_k) - rmin, int(cc_k) - cmin
            piece = padded[..., r:r + hext, c:c + wext]
            out = piece if out is None else out + piece
        return out, rmax, cmax

    def _gather_map(self, fmap_r0_c0, trajs: torch.Tensor, ego_velocity=None):
        """Gather a footprint-sum map at the trajectory's floor cells -> (B, N, T)."""
        fmap, r0, c0 = fmap_r0_c0
        cells = torch.floor(trajs.float() / self._dx(trajs)).flip(-1)
        ri = (cells[..., 0].to(torch.int64) + r0).clamp(0, fmap.shape[-2] - 1)
        ci = (cells[..., 1].to(torch.int64) + c0).clamp(0, fmap.shape[-1] - 1)
        bi = torch.arange(fmap.shape[0], device=fmap.device)[:, None, None]
        ti = torch.arange(trajs.shape[2], device=fmap.device)[None, None, :]
        sub = fmap[bi, ti, ri, ci]
        return sub * ego_velocity if ego_velocity is not None else sub

    def _discretize(self, trajs):
        """(B, N, T, 2) flipped-frame metres -> (row, col) cell indices."""
        xx, yy = trajs[..., 0].float(), trajs[..., 1].float()
        yi = ((yy - float(self.bx[0])) / float(self.dx[0])).to(torch.int64)
        xi = ((xx - float(self.bx[1])) / float(self.dx[1])).to(torch.int64)
        return (yi.clamp(0, int(self.bev_dimension[0]) - 1),
                xi.clamp(0, int(self.bev_dimension[1]) - 1))

    def _evaluate(self, trajs, grid):
        yi, xi = self._discretize(trajs)
        bi = torch.arange(grid.shape[0], device=grid.device)[:, None, None]
        ti = torch.arange(trajs.shape[2], device=grid.device)[None, None, :]
        return grid[bi, ti, yi, xi]

    @staticmethod
    def _binary_from_logits(x):
        """2-channel logits -> P(class 1), zeroed below 0.5; 1 channel passes."""
        if x.shape[-1] == 2:
            p = torch.softmax(x, -1)[..., 1]
            return torch.where(p < 0.5, torch.zeros_like(p), p)
        return x[..., 0]

    @staticmethod
    def _velocity(trajs):
        prev = torch.cat([torch.zeros_like(trajs[:, :, :1]), trajs[:, :, :-1]], 2)
        return torch.sqrt(((trajs - prev) ** 2).sum(-1)) / 0.5

    # ---------------------------------------------------------------- terms
    def cost_volume_term(self, trajs, cost_volume):
        return self._evaluate(trajs, cost_volume.clamp(0, 1000)) * self.f_volume

    def rule_term(self, trajs, drivable_area):
        da = self._binary_from_logits(drivable_area)
        dangerous = (da == 0).float()
        dangerous = dangerous[:, None].expand(-1, trajs.shape[2], -1, -1)
        return self._gather_map(self._footprint_map(dangerous, self._fp0), trajs) * 5.0

    def safety_term(self, trajs, semantic_pred):
        vel = self._velocity(trajs)
        sub1 = self._gather_map(self._footprint_map(semantic_pred, self._fp0), trajs)
        sub2 = self._gather_map(self._footprint_map(semantic_pred, self._fp_lam),
                                trajs, vel)
        return (sub1 + sub2) * self.f_safety

    def headway_term(self, trajs, semantic_pred, drivable_area):
        da = self._binary_from_logits(drivable_area)
        sem = semantic_pred * da[:, None]
        shifted = trajs.clone()
        shifted[..., 1] += 10.0            # 10 m longitudinal keep-out
        return self._gather_map(self._footprint_map(sem, self._fp0), shifted) * self.f_headway

    def lr_divider_term(self, trajs, lane_divider, radius_cells: int = 4):
        """Penalty (L - d)^2 for d < L = 1 m to the nearest divider pixel,
        exact within ``radius_cells``."""
        ld = self._binary_from_logits(lane_divider)
        mask = (ld > 0).float()                                   # (B, H, W)
        L, big = 1.0, 1e6
        dxr, dxc = float(self.dx[1]), float(self.dx[0])
        dists = []
        for di in range(-radius_cells, radius_cells + 1):
            for dj in range(-radius_cells, radius_cells + 1):
                d = float(np.sqrt((di * dxr) ** 2 + (dj * dxc) ** 2))
                if d - 1e-6 > L:
                    continue
                shifted = torch.roll(mask, (-di, -dj), (1, 2))
                if di > 0:
                    shifted[:, -di:, :] = 0
                elif di < 0:
                    shifted[:, :-di, :] = 0
                if dj > 0:
                    shifted[:, :, -dj:] = 0
                elif dj < 0:
                    shifted[:, :, :-dj] = 0
                dists.append(torch.where(shifted > 0, d, big))
        dist_field = torch.stack(dists, 0).amin(0)                # (B, H, W)
        has_any = mask.sum((1, 2)) > 0
        yi, xi = self._discretize(trajs)
        bi = torch.arange(trajs.shape[0], device=mask.device)[:, None, None]
        d_at = dist_field[bi, yi, xi]
        pen = torch.where(d_at <= L, (L - d_at) ** 2, torch.zeros_like(d_at))
        pen = torch.where(has_any[:, None, None], pen, torch.zeros_like(pen))
        return pen * self.f_lrdivider

    def comfort_term(self, trajs):
        """Lateral/longitudinal acceleration and jerk over thresholds."""
        prev = torch.cat([torch.zeros_like(trajs[:, :, :1]), trajs[:, :, :-1]], 2)
        vel_xy = (trajs - prev) / 0.5
        lat_v, lon_v = vel_xy[..., 0], vel_xy[..., 1]

        def accel(v):
            a = (v[:, :, 1:] - v[:, :, :-1]) / 0.5
            return torch.cat([torch.zeros_like(v[:, :, :1]), a], 2)

        lat_a = accel(lat_v).abs().amax(-1)
        lon_a = accel(lon_v).abs().amax(-1)
        acc = accel(self._velocity(trajs))
        jerk = torch.cat([torch.zeros_like(acc[:, :, :1]),
                          (acc[:, :, 1:] - acc[:, :, :-1]) / 0.5], 2)
        if jerk.shape[2] > 1:
            jerk = jerk.clone()
            jerk[:, :, 1] = 0.0            # the reference's loop starts at 2
        jerk = jerk.abs().amax(-1)
        sub = (lat_a - 3.0).clamp(0, 30) ** 2
        sub = sub + (lon_a - 3.0).clamp(0, 30) ** 2
        sub = sub + (jerk - 1.0).clamp(0, 20) ** 2
        return sub * self.f_comfort

    def progress_term(self, trajs, target_points):
        sub1 = trajs[..., 1].amax(-1)
        has_target = target_points.sum() >= 0.5
        sub2 = ((trajs[:, :, -1] - target_points[:, None, :]) ** 2).sum(-1)
        sub2 = torch.where(has_target, sub2, torch.zeros_like(sub2))
        return (sub2 - sub1) * self.f_progress

    # ------------------------------------------------------------ aggregate
    def __call__(self, cost_volume, trajs, semantic_pred, lane_divider,
                 drivable_area, target_points):
        trajs = trajs * torch.tensor([-1.0, 1.0], dtype=trajs.dtype, device=trajs.device)
        safety = self.safety_term(trajs, semantic_pred).clamp(0, 100)
        headway = self.headway_term(trajs, semantic_pred, drivable_area).clamp(0, 100)
        lrdiv = self.lr_divider_term(trajs, lane_divider).clamp(0, 100)
        comfort = self.comfort_term(trajs).clamp(0, 100)
        progress = self.progress_term(trajs, target_points).clamp(-100, 100)
        rule = self.rule_term(trajs, drivable_area).clamp(0, 100)
        volume = self.cost_volume_term(trajs, cost_volume).clamp(0, 100)
        cost_fo = safety + headway + lrdiv + volume + rule
        cost_fc = comfort + progress
        return cost_fc, cost_fo
