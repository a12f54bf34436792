"""SE(2) feature warping (port of stp3_tpu/ops/warp.py; the reference's
affine_grid + grid_sample, stp3/utils/geometry.py:196-296).

The index arithmetic is written out as the JAX package writes it, not
handed to ``F.grid_sample``: its nearest mode rounds half to even, where
the JAX function takes ``floor(ix + 0.5)``, and on label maps such a tie
flips an integer class. All tensors are channels-last: (B, H, W, C).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from cardbench.reference.geometry import (invert_pose_matrix, mat2pose_vec, matmul_fp32,
                                         pose_vec2mat)


def _base_grid(h: int, w: int, dtype, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """torch affine_grid(align_corners=False)'s base grid: x_j = (2j+1)/W - 1,
    y_i = (2i+1)/H - 1; each (H, W)."""
    xs = (2.0 * torch.arange(w, dtype=dtype, device=device) + 1.0) / w - 1.0
    ys = (2.0 * torch.arange(h, dtype=dtype, device=device) + 1.0) / h - 1.0
    gy, gx = torch.meshgrid(ys, xs, indexing='ij')
    return gx, gy


def grid_sample_2d(x: torch.Tensor, gx: torch.Tensor, gy: torch.Tensor,
                   mode: str = 'bilinear') -> torch.Tensor:
    """Sample x (B, H, W, C) at normalised coords gx, gy (B, H', W') in
    [-1, 1], as torch grid_sample(align_corners=False, padding_mode='zeros'):
    ix = ((gx + 1) W - 1) / 2; out-of-bounds reads contribute zero."""
    b, h, w = x.shape[:3]
    ix = ((gx + 1.0) * w - 1.0) / 2.0
    iy = ((gy + 1.0) * h - 1.0) / 2.0
    batch = torch.arange(b, device=x.device).reshape(b, 1, 1)

    def gather(yy, xx):
        valid = (xx >= 0) & (xx < w) & (yy >= 0) & (yy < h)
        v = x[batch, yy.clamp(0, h - 1), xx.clamp(0, w - 1)]
        return torch.where(valid[..., None], v, torch.zeros((), dtype=v.dtype, device=v.device))

    if mode == 'nearest':
        ix0 = torch.floor(ix + 0.5).to(torch.int64)
        iy0 = torch.floor(iy + 0.5).to(torch.int64)
        return gather(iy0, ix0).to(x.dtype)
    if mode != 'bilinear':
        raise ValueError(f'unknown mode {mode!r}')
    ix0 = torch.floor(ix)
    iy0 = torch.floor(iy)
    tx = (ix - ix0)[..., None]
    ty = (iy - iy0)[..., None]
    ix0 = ix0.to(torch.int64)
    iy0 = iy0.to(torch.int64)
    v00 = gather(iy0, ix0)
    v01 = gather(iy0, ix0 + 1)
    v10 = gather(iy0 + 1, ix0)
    v11 = gather(iy0 + 1, ix0 + 1)
    top = v00 * (1.0 - tx) + v01 * tx
    bot = v10 * (1.0 - tx) + v11 * tx
    return (top * (1.0 - ty) + bot * ty).to(x.dtype)


def affine_grid_sample(x: torch.Tensor, theta: torch.Tensor,
                       mode: str = 'bilinear') -> torch.Tensor:
    """Warp x (B, H, W, C) with per-batch 2x3 affine theta on normalised
    coords (affine_grid + grid_sample, align_corners=False, zero padding)."""
    h, w = x.shape[1:3]
    gx, gy = _base_grid(h, w, theta.dtype, x.device)
    th = theta[:, :, :, None, None]
    sx = th[:, 0, 0] * gx + th[:, 0, 1] * gy + th[:, 0, 2]
    sy = th[:, 1, 0] * gx + th[:, 1, 1] * gy + th[:, 1, 2]
    return grid_sample_2d(x, sx, sy, mode)


def warp_features(x: torch.Tensor, flow: Optional[torch.Tensor], mode: str = 'nearest',
                  spatial_extent: Optional[Tuple[float, float]] = None) -> torch.Tensor:
    """SE(2) (z-rotation + xy-translation) warp of BEV maps x (B, H, W, C)
    by the 6-DoF pose vectors flow (B, 6): translation normalised by the
    spatial extent, forward axis inverted, theta rows
    [cos, -sin, ty_n; sin, cos, -tx_n]."""
    if flow is None:
        return x
    angle = flow[:, 5]
    tx = -flow[:, 0] / spatial_extent[0]
    ty = flow[:, 1] / spatial_extent[1]
    cos_t, sin_t = torch.cos(angle), torch.sin(angle)
    theta = torch.stack([torch.stack([cos_t, -sin_t, ty], -1),
                         torch.stack([sin_t, cos_t, tx], -1)], -2)   # (B, 2, 3)
    return affine_grid_sample(x, theta.float(), mode=mode)


def cumulative_warp_features(x: torch.Tensor, flow: torch.Tensor, mode: str = 'nearest',
                             spatial_extent: Optional[Tuple[float, float]] = None
                             ) -> torch.Tensor:
    """Warp past frames into the present (last) one. x (B, T, H, W, C);
    flow (B, T, 6) motion from t to t+1. x[:, -1] is unchanged, x[:, t] is
    warped by flow[t] @ ... @ flow[T-2]."""
    t_len = x.shape[1]
    if t_len == 1:
        return x
    mats = pose_vec2mat(flow)
    out = [x[:, -1]]
    cum = mats[:, -2]
    for t in range(t_len - 2, -1, -1):
        out.append(warp_features(x[:, t], mat2pose_vec(cum), mode, spatial_extent))
        if t > 0:
            cum = matmul_fp32(mats[:, t - 1], cum)
    return torch.stack(out[::-1], 1)


def cumulative_warp_features_reverse(x: torch.Tensor, flow: torch.Tensor,
                                     mode: str = 'nearest',
                                     spatial_extent: Optional[Tuple[float, float]] = None
                                     ) -> torch.Tensor:
    """Warp future frames back into the first one: x[:, 0] is unchanged,
    x[:, i] is warped by flow[0]^-1 @ ... @ flow[i-1]^-1."""
    mats = pose_vec2mat(flow)
    out = [x[:, 0]]
    cum = None
    for i in range(1, x.shape[1]):
        inv = invert_pose_matrix(mats[:, i - 1])
        cum = inv if cum is None else matmul_fp32(cum, inv)
        out.append(warp_features(x[:, i], mat2pose_vec(cum), mode, spatial_extent))
    return torch.stack(out, 1)
