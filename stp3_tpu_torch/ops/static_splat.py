"""Static-geometry BEV splat for serving (port of stp3_tpu/ops/static_splat.py).

With a fixed camera rig (constant intrinsics and extrinsics: the CARLA
agent's rig, and any production vehicle) each frustum point's BEV cell is
a pure function of the rig, so it is computed once. Along a ray the depth
bins that fall in one cell are consecutive, so the summed depth
probability over a run [lo, hi) of bins is a difference of prefix sums,
and the (rays * D)-point splat shrinks to the distinct (ray, cell)
crossings.

The plan is the JAX package's ``ColumnSplatPlan``: per (image column,
distinct cell) a depth interval for every image row, so a column's cells
are one batched product over rows, and only ncols * rmax rows reach a
sorted segment sum (``index_add_``). (The JAX package's bucketed plan,
``StaticSplatPlan``, computes the same splat; the port keeps one.)

Plans are built on the host in fp32 by the same geometry functions as the
dynamic splat (``get_geometry``, ``voxelize_coords``, ``ranks_of``), so
static and dynamic splats agree to float tolerance. The runtime products
are plain ``torch.einsum``: the JAX package computes them outside any
Pallas kernel.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from stp3_tpu_torch.ops.bev_pool import ranks_of, voxelize_coords
from stp3_tpu_torch.ops.geometry import get_geometry


def _rig_runs(frustum, intrinsics, extrinsics, bev_resolution, bev_start_position,
              bev_dimension):
    """Voxelise one rig's frustum (on the CPU, fp32) and run-length-encode
    consecutive equal cells along each ray.

    Returns (run_cell, run_ray, run_lo, run_hi, (n, d, hf, wf)) where ray
    = n*Hf*Wf + h*Wf + w and [lo, hi) is the depth-bin interval."""
    frustum = torch.as_tensor(np.asarray(frustum, np.float32))
    k = torch.as_tensor(np.asarray(intrinsics, np.float32))[None, None]
    e = torch.as_tensor(np.asarray(extrinsics, np.float32))[None, None]
    geometry = get_geometry(frustum, k, e)                          # (1,1,N,D,Hf,Wf,3)
    coords, valid = voxelize_coords(geometry, bev_resolution, bev_start_position,
                                    bev_dimension)
    ranks = ranks_of(coords, valid, bev_dimension)[0, 0].numpy()
    valid = valid[0, 0].numpy()                                     # (N,D,Hf,Wf)

    n, d, hf, wf = valid.shape
    # ray-major layout: ray = n*Hf*Wf + h*Wf + w, bins along axis 1
    ranks_rd = np.moveaxis(ranks, 1, -1).reshape(n * hf * wf, d)
    valid_rd = np.moveaxis(valid, 1, -1).reshape(n * hf * wf, d)
    ranks_rd = np.where(valid_rd, ranks_rd, -1)

    # vectorised run-length encode of consecutive equal cells along each ray
    flat = ranks_rd.reshape(-1)
    total = flat.size
    is_start = np.ones(total, bool)
    is_start[1:] = flat[1:] != flat[:-1]
    is_start[::d] = True                                  # runs never span rays
    start_idx = np.flatnonzero(is_start)
    end_idx = np.append(start_idx[1:], total)
    # a run also ends at the end of its own ray
    end_idx = np.minimum(end_idx, (start_idx // d + 1) * d)
    keep = flat[start_idx] >= 0
    run_cell = flat[start_idx[keep]].astype(np.int64)
    run_ray = (start_idx[keep] // d).astype(np.int32)
    run_lo = (start_idx[keep] % d).astype(np.int32)
    run_hi = run_lo + (end_idx[keep] - start_idx[keep]).astype(np.int32)
    return run_cell, run_ray, run_lo, run_hi, (n, d, hf, wf)


@dataclasses.dataclass(frozen=True)
class ColumnSplatPlan:
    """Column-collapsed static splat plan (see column_splat).

    Per (column b, distinct cell slot r) a depth interval [lo, hi) for
    every row h (lo == hi where row h never crosses that cell), so

        val[b, r, :] = sum_h (S[b, h, hi] - S[b, h, lo]) * ctx[b, h, :]

    with S the depth-probability prefix sum: a batched (rmax x H) @ (H x C)
    product per column."""
    cells: np.ndarray        # (ncols, rmax) int32, pad slots -> ncells sentinel
    lo: np.ndarray           # (ncols, hf, rmax) int32 prefix-sum interval start
    hi: np.ndarray           # (ncols, hf, rmax) int32 prefix-sum interval end
    n_cams: int
    hf: int
    wf: int
    depth_bins: int
    bev_dimension: Tuple[int, int, int]

    @property
    def ncells(self) -> int:
        nx, ny, nz = self.bev_dimension
        return nx * ny * nz

    @property
    def meta(self):
        """column_splat's plan_meta: (n_cams, hf, wf, depth_bins, bev_dimension)."""
        return (self.n_cams, self.hf, self.wf, self.depth_bins, self.bev_dimension)

    def host_arrays(self) -> Dict[str, np.ndarray]:
        """The depth intervals as a dense (ncols, hf, rmax, D) 0/1 mask
        (contracted against dp in one product, instead of a gather per
        crossing), the slot order that sorts the cells, and the sorted
        cells."""
        bins = np.arange(self.depth_bins, dtype=np.int32)
        mask = (bins >= self.lo[..., None]) & (bins < self.hi[..., None])
        flat_cells = self.cells.reshape(-1)
        perm = np.argsort(flat_cells, kind='stable').astype(np.int32)
        return {'mask': mask, 'perm': perm, 'cells_sorted': flat_cells[perm]}

    def device_arrays(self, device) -> Dict[str, torch.Tensor]:
        """``host_arrays`` on ``device``: the mask as bool, the indices int64."""
        host = self.host_arrays()
        return {'mask': torch.as_tensor(host['mask'], device=device),
                'perm': torch.as_tensor(host['perm'], dtype=torch.int64, device=device),
                'cells_sorted': torch.as_tensor(host['cells_sorted'], dtype=torch.int64,
                                                device=device)}


def build_column_splat_plan(frustum, intrinsics, extrinsics, bev_resolution,
                            bev_start_position, bev_dimension) -> ColumnSplatPlan:
    """Precompute the column-collapsed crossing plan of ONE camera rig."""
    run_cell, run_ray, run_lo, run_hi, (n, d, hf, wf) = _rig_runs(
        frustum, intrinsics, extrinsics, bev_resolution, bev_start_position,
        bev_dimension)
    ncells = int(np.prod(np.asarray(bev_dimension)))

    col = (run_ray // (hf * wf)) * wf + run_ray % wf        # (n*wf) columns
    h = (run_ray // wf) % hf
    ncols = n * wf

    # distinct cells per column -> slot index r
    key = col.astype(np.int64) * ncells + run_cell
    order = np.argsort(key, kind='stable')
    key_s = key[order]
    new_pair = np.ones(key_s.size, bool)
    new_pair[1:] = key_s[1:] != key_s[:-1]
    pair_id = np.cumsum(new_pair) - 1                       # per sorted run
    pair_col = (key_s[new_pair] // ncells).astype(np.int64)
    pair_cell = (key_s[new_pair] % ncells).astype(np.int64)
    # slot r = rank of the pair within its column
    first_of_col = np.ones(pair_col.size, bool)
    first_of_col[1:] = pair_col[1:] != pair_col[:-1]
    col_start = np.cumsum(first_of_col) - 1
    col_start_idx = np.flatnonzero(first_of_col)
    r_of_pair = np.arange(pair_col.size) - col_start_idx[col_start]
    rmax = int(r_of_pair.max()) + 1 if r_of_pair.size else 1

    cells = np.full((ncols, rmax), ncells, np.int32)        # sentinel pad
    cells[pair_col, r_of_pair] = pair_cell.astype(np.int32)
    lo = np.zeros((ncols, hf, rmax), np.int32)
    hi = np.zeros((ncols, hf, rmax), np.int32)
    rr = r_of_pair[pair_id]                                 # slot per run
    cc = col[order]
    hh = h[order]
    if np.unique(np.stack([cc, hh, rr]), axis=1).shape[1] != cc.size:
        raise ValueError('duplicate (column, row, cell) runs: a ray path that is '
                         'not monotone should be impossible')
    lo[cc, hh, rr] = run_lo[order]
    hi[cc, hh, rr] = run_hi[order]
    return ColumnSplatPlan(cells, lo, hi, n_cams=n, hf=hf, wf=wf, depth_bins=d,
                           bev_dimension=tuple(int(v) for v in np.asarray(bev_dimension)))


def column_splat(ctx: torch.Tensor, dp: torch.Tensor, arrays: Dict[str, torch.Tensor],
                 plan_meta) -> torch.Tensor:
    """Splat frames with a ColumnSplatPlan.

    ctx (..., rays, C); dp (..., rays, D), ray-major (ray = n*Hf*Wf +
    h*Wf + w). arrays: ``ColumnSplatPlan.device_arrays``. plan_meta:
    ``ColumnSplatPlan.meta``. Returns (..., nx, ny, nz*C)."""
    n, hf, wf, d, bev_dimension = plan_meta
    nx, ny, nz = bev_dimension
    ncells = nx * ny * nz
    ncols = n * wf
    rmax = arrays['mask'].shape[2]
    lead = ctx.shape[:-2]
    c = ctx.shape[-1]
    # ray-major -> column-major (frames, ncols, hf, ...)
    ctx_c = ctx.reshape(-1, n, hf, wf, c).transpose(2, 3).reshape(-1, ncols, hf, c)
    dp_c = dp.reshape(-1, n, hf, wf, d).transpose(2, 3).reshape(-1, ncols, hf, d)
    w = torch.einsum('bhrd,fbhd->fbhr', arrays['mask'].to(dp_c.dtype), dp_c)
    vals = torch.einsum('fbhr,fbhc->fbrc', w.to(ctx_c.dtype), ctx_c)
    vals = vals.reshape(-1, ncols * rmax, c)[:, arrays['perm']]
    out = torch.zeros(vals.shape[0], ncells + 1, c, dtype=vals.dtype, device=vals.device)
    out.index_add_(1, arrays['cells_sorted'], vals)
    return out[:, :ncells].reshape(*lead, nx, ny, nz * c)

