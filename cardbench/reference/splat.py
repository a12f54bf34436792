"""The BEV splat in plain PyTorch: pre-warp every past frame's geometry
into the present frame, voxelise, sum each frame's point rows onto its
cells with ``index_add_`` in fp32, then accumulate the frames at
``discount`` (ST-P3's ``VoxelsSumming`` and ``cumulative_warp`` order)."""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from cardbench.reference.geometry import cumulative_prewarp_transforms


def voxelize_coords(points: torch.Tensor, bev_resolution, bev_start_position,
                    bev_dimension) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ego-frame points -> int32 cell coords + validity mask.
    index = (p - (start - res/2)) / res, truncated toward zero."""
    res = torch.tensor(np.asarray(bev_resolution).tolist(), dtype=points.dtype,
                       device=points.device)
    start = torch.tensor(np.asarray(bev_start_position).tolist(), dtype=points.dtype,
                         device=points.device)
    dim = torch.tensor(np.asarray(bev_dimension).tolist(), dtype=torch.int32,
                       device=points.device)
    coords = ((points - (start - res / 2.0)) / res).to(torch.int32)
    valid = ((coords >= 0) & (coords < dim)).all(-1)
    return coords, valid


def ranks_of(coords: torch.Tensor, valid: torch.Tensor, bev_dimension) -> torch.Tensor:
    """Flatten (x, y, z) cells into one rank; invalid -> ncells."""
    nx, ny, nz = (int(v) for v in np.asarray(bev_dimension))
    r = coords[..., 0].long() * (ny * nz) + coords[..., 1].long() * nz + coords[..., 2].long()
    return torch.where(valid, r, torch.full_like(r, nx * ny * nz))


def prewarped_ranks(geometry: torch.Tensor, future_egomotion: torch.Tensor,
                    bev_resolution, bev_start_position, bev_dimension) -> torch.Tensor:
    """geometry (B, S, N, D, Hf, Wf, 3) fp32 points of each frame,
    future_egomotion (B, S, 6) -> (B*S, P) ranks in the present frame's
    grid (ncells = outside)."""
    b, s = geometry.shape[:2]
    tr = cumulative_prewarp_transforms(future_egomotion, s)
    rot = tr[..., :3, :3].reshape(b, s, 1, 1, 1, 1, 3, 3)
    t3 = tr[..., :3, 3].reshape(b, s, 1, 1, 1, 1, 3)
    geom = (rot * geometry[..., None, :]).sum(-1) + t3
    coords, valid = voxelize_coords(geom, bev_resolution, bev_start_position, bev_dimension)
    return ranks_of(coords, valid, bev_dimension).reshape(b * s, -1)


def splat_frames(feats: torch.Tensor, ranks: torch.Tensor, ncells: int) -> torch.Tensor:
    """(F, P, C) rows, (F, P) ranks -> (F, ncells, C) sums in fp32 (float64
    for float64 rows); a rank of ncells lands on a dropped overflow row."""
    f, _, c = feats.shape
    dt = torch.promote_types(feats.dtype, torch.float32)
    acc = torch.zeros(f * (ncells + 1), c, dtype=dt, device=feats.device)
    idx = ranks + torch.arange(f, device=feats.device)[:, None] * (ncells + 1)
    acc.index_add_(0, idx.reshape(-1), feats.reshape(-1, c).to(dt))
    return acc.reshape(f, ncells + 1, c)[:, :ncells]


def discounted_accumulate(splat: torch.Tensor, discount: float) -> torch.Tensor:
    """out_t = discount * out_{t-1} + splat_t over axis 1."""
    out = []
    carry = torch.zeros_like(splat[:, 0])
    for t in range(splat.shape[1]):
        carry = carry * discount + splat[:, t]
        out.append(carry)
    return torch.stack(out, 1)


def project_to_birds_eye_view(feats: torch.Tensor, geometry: torch.Tensor,
                              future_egomotion: torch.Tensor, bev_resolution,
                              bev_start_position, bev_dimension,
                              discount: float = 0.5) -> torch.Tensor:
    """feats (B, S, N, D, Hf, Wf, C) lifted features; geometry (B, S, N,
    D, Hf, Wf, 3) fp32 points; future_egomotion (B, S, 6). Returns (B, S,
    nx, ny, nz*C) in feats' dtype."""
    b, s = feats.shape[:2]
    c = feats.shape[-1]
    nx, ny, nz = (int(v) for v in np.asarray(bev_dimension))
    ranks = prewarped_ranks(geometry, future_egomotion, bev_resolution,
                            bev_start_position, bev_dimension)
    splat = splat_frames(feats.reshape(b * s, -1, c), ranks, nx * ny * nz).to(feats.dtype)
    return discounted_accumulate(splat.reshape(b, s, nx, ny, nz * c), discount)
