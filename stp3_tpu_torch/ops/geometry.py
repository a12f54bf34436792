"""Pose / camera / BEV-grid geometry (port of stp3_tpu/ops/geometry.py).

All of this is fp32 math whose rounding decides which voxel a point falls
in. The 3x3 / 4x4 products are therefore written as broadcast multiplies
and sums, never as matmuls: a matmul on the card may run in TF32, an
elementwise fp32 product cannot, so the results do not depend on
``torch.backends.cuda.matmul.allow_tf32``. (The JAX package pins
``precision='highest'`` for the same reason.)
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def calculate_birds_eye_view_parameters(x_bounds, y_bounds, z_bounds):
    """(resolution, start_position, dimension) numpy arrays: start =
    lower + res/2, dim = (upper - lower) / res."""
    rows = [x_bounds, y_bounds, z_bounds]
    resolution = np.array([r[2] for r in rows], dtype=np.float32)
    start_position = np.array([r[0] + r[2] / 2.0 for r in rows], dtype=np.float32)
    dimension = np.array([(r[1] - r[0]) / r[2] for r in rows], dtype=np.int64)
    return resolution, start_position, dimension


def ego_footprint_grid_pts(ego_width: float, ego_height: float, bx, dx) -> np.ndarray:
    """Ego-vehicle footprint corners in BEV grid coordinates, (4, 2)
    float64, axes swapped to (col, row) raster order: a +0.5 m
    longitudinal offset (rear axle to box centre) on the length axis,
    ``(pts - bx) / dx``, then the swap (reference metrics.py:298-307)."""
    bx = np.asarray(bx)[:2]
    dx = np.asarray(dx)[:2]
    h, w = float(ego_height), float(ego_width)
    pts = np.array([[-h / 2.0 + 0.5, w / 2.0], [h / 2.0 + 0.5, w / 2.0],
                    [h / 2.0 + 0.5, -w / 2.0], [-h / 2.0 + 0.5, -w / 2.0]])
    pts = (pts - bx) / dx
    pts[:, [0, 1]] = pts[:, [1, 0]]
    return pts


def create_frustum(final_dim: Sequence[int], downsample: int,
                   d_bound: Sequence[float]) -> np.ndarray:
    """Image-plane x depth grid -> (D, Hf, Wf, 3) numpy of (u, v, depth)."""
    h, w = final_dim
    hf, wf = h // downsample, w // downsample
    depth_grid = np.arange(*d_bound, dtype=np.float32)
    d = depth_grid.shape[0]
    x = np.linspace(0, w - 1, wf, dtype=np.float32)
    y = np.linspace(0, h - 1, hf, dtype=np.float32)
    return np.stack([np.broadcast_to(x[None, None, :], (d, hf, wf)),
                     np.broadcast_to(y[None, :, None], (d, hf, wf)),
                     np.broadcast_to(depth_grid[:, None, None], (d, hf, wf))],
                    axis=-1)


def matmul_fp32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., i, k) @ (..., k, j) as an elementwise fp32 product-sum."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def get_geometry(frustum: torch.Tensor, intrinsics: torch.Tensor,
                 extrinsics: torch.Tensor) -> torch.Tensor:
    """Un-project the frustum into the ego frame.

    frustum (D, Hf, Wf, 3); intrinsics (..., N, 3, 3); extrinsics
    (..., N, 4, 4) camera -> ego. Returns (..., N, D, Hf, Wf, 3):
    R @ K^-1 @ (u*d, v*d, d) + t.
    """
    rotation = extrinsics[..., :3, :3]
    translation = extrinsics[..., :3, 3]
    points = torch.cat([frustum[..., :2] * frustum[..., 2:3], frustum[..., 2:3]], -1)
    # inv_ex: no host sync for an error check (the rig's K are invertible)
    combined = matmul_fp32(rotation, torch.linalg.inv_ex(intrinsics).inverse)
    lead = combined.shape[:-2]
    combined = combined.reshape(*lead, 1, 1, 1, 3, 3)
    pts = (combined * points[..., None, :]).sum(-1)
    return pts + translation[..., None, None, None, :]


def euler2mat(angle: torch.Tensor) -> torch.Tensor:
    """Euler angles (..., 3) -> R = Rx @ Ry @ Rz (..., 3, 3), closed form."""
    x, y, z = angle[..., 0], angle[..., 1], angle[..., 2]
    cz, sz = torch.cos(z), torch.sin(z)
    cy, sy = torch.cos(y), torch.sin(y)
    cx, sx = torch.cos(x), torch.sin(x)
    return torch.stack([cy * cz, -cy * sz, sy,
                        cx * sz + sx * sy * cz, cx * cz - sx * sy * sz, -sx * cy,
                        sx * sz - cx * sy * cz, sx * cz + cx * sy * sz, cx * cy],
                       -1).reshape(*z.shape, 3, 3)


def pose_vec2mat(vec: torch.Tensor) -> torch.Tensor:
    """(..., 6) (tx, ty, tz, rx, ry, rz) -> (..., 4, 4)."""
    top = torch.cat([euler2mat(vec[..., 3:]), vec[..., :3, None]], -1)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], -2)


def mat2pose_vec(matrix: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) pose -> (..., 6) (tx, ty, tz, rx, ry, rz)."""
    rotx = torch.atan2(-matrix[..., 1, 2], matrix[..., 2, 2])
    cosy = torch.sqrt(matrix[..., 1, 2] ** 2 + matrix[..., 2, 2] ** 2)
    roty = torch.atan2(matrix[..., 0, 2], cosy)
    rotz = torch.atan2(-matrix[..., 0, 1], matrix[..., 0, 0])
    return torch.cat([matrix[..., :3, 3], torch.stack([rotx, roty, rotz], -1)], -1)


def invert_pose_matrix(x: torch.Tensor) -> torch.Tensor:
    """Inverse of a rigid (..., 4, 4) pose: [R^T, -R^T t]."""
    rot_t = x[..., :3, :3].transpose(-1, -2)
    top = torch.cat([rot_t, -matmul_fp32(rot_t, x[..., :3, 3:])], -1)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], -2)


def cumulative_prewarp_transforms(future_egomotion: torch.Tensor, s: int) -> torch.Tensor:
    """(B, S, 6) frame-to-next motions -> (B, S, 4, 4); entry t =
    M_{s-2} @ ... @ M_t (identity for t = s-1): the transform that brings
    frame t's geometry into the present frame."""
    mats = pose_vec2mat(future_egomotion)
    b = mats.shape[0]
    eye = torch.eye(4, dtype=mats.dtype, device=mats.device).expand(b, 4, 4)
    out = [eye]
    cum = eye
    for t in range(s - 2, -1, -1):
        cum = matmul_fp32(cum, mats[:, t])
        out.append(cum)
    return torch.stack(out[::-1], 1)
