"""BEV splat (port of stp3_tpu/ops/bev_pool.py).

Pre-warp every past frame's geometry into the present frame, voxelise,
scatter-add each frame's points onto the grid, then accumulate the frames
at ``discount``. Every splat here is ``bev_splat`` (``ops/kernels/bev_splat``):
K1 on CUDA tensors, one launch for all B*S frames, and K1's plain version
on CPU tensors. The JAX package's other scatters (its ``method`` names:
the per-frame Pallas entries and the XLA segment sums) compute the same
function, so the port keeps one. ``project_lift_splat_fused`` is the fused
lift + splat: K4 (``ops/kernels/lift_splat``), one launch for all frames.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from stp3_tpu_torch.ops.geometry import cumulative_prewarp_transforms
from stp3_tpu_torch.ops.kernels.bev_splat import bev_splat
from stp3_tpu_torch.ops.kernels.lift_splat import lift_splat_frames
from stp3_tpu_torch.utils.device import constant


def voxelize_coords(points: torch.Tensor, bev_resolution, bev_start_position,
                    bev_dimension) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ego-frame points -> int32 cell coords + validity mask.
    index = (p - (start - res/2)) / res, truncated toward zero."""
    res, start = (constant(tuple(np.asarray(v).tolist()), points.dtype, points.device)
                  for v in (bev_resolution, bev_start_position))
    dim = constant(tuple(np.asarray(bev_dimension).tolist()), torch.int32, points.device)
    coords = ((points - (start - res / 2.0)) / res).to(torch.int32)
    valid = ((coords >= 0) & (coords < dim)).all(-1)
    return coords, valid


def ranks_of(coords: torch.Tensor, valid: torch.Tensor, bev_dimension) -> torch.Tensor:
    """Flatten (x, y, z) cells into an int32 rank; invalid -> ncells."""
    nx, ny, nz = (int(v) for v in np.asarray(bev_dimension))
    r = coords[..., 0] * (ny * nz) + coords[..., 1] * nz + coords[..., 2]
    return torch.where(valid, r, torch.full_like(r, nx * ny * nz))


def bev_pool(feats: torch.Tensor, coords: torch.Tensor, valid: torch.Tensor,
             bev_dimension) -> torch.Tensor:
    """Scatter-add one frame's point rows onto the BEV grid. feats (P, C);
    coords (P, 3) int; valid (P,) bool. Returns (nx, ny, nz*C): ``bev_splat``
    at F=1."""
    nx, ny, nz = (int(v) for v in np.asarray(bev_dimension))
    c = feats.shape[-1]
    ranks = ranks_of(coords.to(torch.int32), valid, bev_dimension).to(torch.int32)
    feats = torch.where(valid[:, None], feats, torch.zeros((), dtype=feats.dtype,
                                                          device=feats.device))
    out = bev_splat(feats[None].contiguous(), ranks[None].contiguous(), nx * ny * nz)[0]
    return out.reshape(nx, ny, nz * c)


def bev_pool_dense_reference(feats: np.ndarray, coords: np.ndarray, valid: np.ndarray,
                             bev_dimension) -> np.ndarray:
    """Numpy scatter-add oracle for tests."""
    nx, ny, nz = (int(v) for v in np.asarray(bev_dimension))
    out = np.zeros((nx, ny, nz, feats.shape[-1]), dtype=np.float64)
    for p in np.flatnonzero(valid):
        x, y, z = coords[p]
        out[x, y, z] += feats[p]
    return out.reshape(nx, ny, -1).astype(feats.dtype)


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
    D, Hf, Wf, 3) fp32 ego-frame points; future_egomotion (B, S, 6).
    Returns (B, S, nx, ny, nz*C) in feats' dtype."""
    b, s = feats.shape[:2]
    c = feats.shape[-1]
    nx, ny, nz = (int(v) for v in np.asarray(bev_dimension))
    ncells = nx * ny * nz
    ranks = prewarped_ranks(geometry, future_egomotion, bev_resolution,
                            bev_start_position, bev_dimension)
    splat = bev_splat(feats.reshape(b * s, -1, c).contiguous(), ranks, ncells)
    return discounted_accumulate(splat.reshape(b, s, nx, ny, nz * c), discount)


def lift_ray_ids(n: int, d: int, hf: int, wf: int, device=None) -> torch.Tensor:
    """(N*D*Hf*Wf,) int32: point (cam n, depth bin, pixel h, w) -> ray id
    n*Hf*Wf + h*Wf + w, in the lifted tensor's point order. Made on the
    device: a copy from the host would wait for the stream to drain."""
    rays = torch.arange(n * hf * wf, dtype=torch.int32, device=device).reshape(n, 1, hf * wf)
    return rays.expand(n, d, hf * wf).reshape(-1)


def project_lift_splat_fused(ctx: torch.Tensor, depth_logits: torch.Tensor,
                             geometry: torch.Tensor, future_egomotion: torch.Tensor,
                             bev_resolution, bev_start_position, bev_dimension,
                             discount: float = 0.5) -> torch.Tensor:
    """The fused lift + splat: the (B, S, N, D, Hf, Wf, C) lifted tensor
    never exists; K4 forms depth_prob x ctx row by row inside the scatter.

    ctx (B, S, N, Hf, Wf, C) camera context; depth_logits (B, S, N, Hf,
    Wf, D), or an int D for the uniform lift (USE_DEPTH_DISTRIBUTION
    False: every depth probability 1); geometry (B, S, N, D, Hf, Wf, 3)
    fp32. Returns (B, S, nx, ny, nz*C) in ctx's dtype, the contract of
    ``project_to_birds_eye_view``."""
    b, s, n, hf, wf, c = ctx.shape
    nx, ny, nz = (int(v) for v in np.asarray(bev_dimension))
    ranks = prewarped_ranks(geometry, future_egomotion, bev_resolution,
                            bev_start_position, bev_dimension)
    if isinstance(depth_logits, int):
        d = depth_logits
        dp = ctx.new_ones(b, s, n, d, hf, wf)
    else:
        d = depth_logits.shape[-1]
        dp = torch.softmax(depth_logits, -1).movedim(-1, 3)       # (B, S, N, D, Hf, Wf)
    ray_ids = lift_ray_ids(n, d, hf, wf, ctx.device)
    splat = lift_splat_frames(ctx.reshape(b * s, n * hf * wf, c).contiguous(),
                              dp.reshape(b * s, -1).contiguous(), ranks, ray_ids,
                              nx * ny * nz)
    return discounted_accumulate(splat.reshape(b, s, nx, ny, nz * c), discount)
