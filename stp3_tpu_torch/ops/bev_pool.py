"""BEV splat (port of stp3_tpu/ops/bev_pool.py, the frame-batched path).

Pre-warp every past frame's geometry into the present frame, voxelise,
scatter-add all B*S frames in one K1 launch (``ops/kernels/bev_splat``),
then accumulate the frames at ``discount``.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from stp3_tpu_torch.ops.geometry import cumulative_prewarp_transforms
from stp3_tpu_torch.ops.kernels.bev_splat import bev_splat


def voxelize_coords(points: torch.Tensor, bev_resolution, bev_start_position,
                    bev_dimension) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ego-frame points -> int32 cell coords + validity mask.
    index = (p - (start - res/2)) / res, truncated toward zero."""
    kw = dict(dtype=points.dtype, device=points.device)
    res = torch.as_tensor(np.asarray(bev_resolution), **kw)
    start = torch.as_tensor(np.asarray(bev_start_position), **kw)
    dim = torch.as_tensor(np.asarray(bev_dimension, np.int32), device=points.device)
    coords = ((points - (start - res / 2.0)) / res).to(torch.int32)
    valid = ((coords >= 0) & (coords < dim)).all(-1)
    return coords, valid


def ranks_of(coords: torch.Tensor, valid: torch.Tensor, bev_dimension) -> torch.Tensor:
    """Flatten (x, y, z) cells into an int32 rank; invalid -> ncells."""
    nx, ny, nz = (int(v) for v in np.asarray(bev_dimension))
    r = coords[..., 0] * (ny * nz) + coords[..., 1] * nz + coords[..., 2]
    return torch.where(valid, r, torch.full_like(r, nx * ny * nz))


def prewarped_ranks(geometry: torch.Tensor, future_egomotion: torch.Tensor,
                    bev_resolution, bev_start_position, bev_dimension) -> torch.Tensor:
    """geometry (B, S, N, D, Hf, Wf, 3) fp32 ego-frame points of each frame,
    future_egomotion (B, S, 6) -> (B*S, P) int32 ranks in the PRESENT
    frame's grid (ncells = outside)."""
    b, s = geometry.shape[:2]
    tr = cumulative_prewarp_transforms(future_egomotion, s)
    rot = tr[..., :3, :3].reshape(b, s, 1, 1, 1, 1, 3, 3)
    t3 = tr[..., :3, 3].reshape(b, s, 1, 1, 1, 1, 3)
    geom = (rot * geometry[..., None, :]).sum(-1) + t3
    coords, valid = voxelize_coords(geom, bev_resolution, bev_start_position,
                                    bev_dimension)
    return ranks_of(coords, valid, bev_dimension).reshape(b * s, -1).contiguous()


def project_to_birds_eye_view(feats: torch.Tensor, geometry: torch.Tensor,
                              future_egomotion: torch.Tensor, bev_resolution,
                              bev_start_position, bev_dimension,
                              discount: float = 0.5) -> torch.Tensor:
    """feats (B, S, N, D, Hf, Wf, C) lifted features; geometry (B, S, N,
    D, Hf, Wf, 3) fp32 ego-frame points; future_egomotion (B, S, 6).
    Returns (B, S, nx, ny, nz*C) in feats' dtype."""
    b, s = feats.shape[:2]
    c = feats.shape[-1]
    nx, ny, nz = (int(v) for v in np.asarray(bev_dimension))
    ranks = prewarped_ranks(geometry, future_egomotion, bev_resolution,
                            bev_start_position, bev_dimension)
    splat = bev_splat(feats.reshape(b * s, -1, c).contiguous(), ranks,
                      nx * ny * nz).reshape(b, s, nx, ny, nz * c)

    out = []
    carry = torch.zeros_like(splat[:, 0])
    for t in range(s):
        carry = carry * discount + splat[:, t]
        out.append(carry)
    return torch.stack(out, 1)
