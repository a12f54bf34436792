"""Camera-parallel serving (counterpart of stp3_tpu/parallel/serving.py).

The front of the network (per-camera encode, depth x context lift and
BEV splat) is parallel over the cameras. A group of k ranks (one process
per card, ``cam_mesh``) splits it:

  * each rank encodes and lifts its N/k cameras and splats them into a
    FULL (nx, ny, C) grid through the port's own splat (K1; K4 under
    ``fused_lift_splat`` in the full forward; the column plan of its own
    cameras in the static mode): the splat is linear over cameras, and the
    ego pre-warp and the discounted accumulate are per frame, so the
    partial grids sum to the one-process grid (up to the order of the
    sums);
  * one all-reduce (SUM) merges the partial grids;
  * the planner's front-camera feature goes through a masked all-reduce:
    the rank that holds camera ``cam_front_index`` contributes it, the
    others zeros (``_shard_cam_front``);
  * the depth logits, where the output has them, are all-gathered in
    camera order;
  * the tail (``STP3.forward_from_bev``, ``STP3._serve_tail``: temporal
    model, future prediction, decoder, planner) runs on every rank on the
    merged grid, unchanged.

Every rank returns the whole output. k must divide the camera count, or
the call raises on every rank before any collective. In eager PyTorch a
rank still issues the whole encoder's launches for its cameras, and the
serving step is bound by the host's issue time, so the split predicts no
speed-up until the step runs as a CUDA graph; it computes what the
one-process port computes.

``pad_column_plan`` (stp3_tpu/ops/static_splat.py:289) is not ported: it
pads the per-shard plans to one shape so that JAX can stack them into
one sharded operand, and here each rank keeps only its own plan.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from stp3_tpu_torch.models.stp3 import STP3, context_depth_rays
from stp3_tpu_torch.ops.static_splat import build_column_splat_plan, column_splat


def cam_mesh(n_shards: int):
    """The group of the first ``n_shards`` ranks of the default group (all
    of them when it has that many), to split the cameras over. Every rank
    of the default group must call it (``new_group`` is collective)."""
    if not dist.is_initialized():
        raise RuntimeError('camera-parallel serving needs a process group '
                           '(parallel.mesh.maybe_initialize_multihost)')
    world = dist.get_world_size()
    if n_shards > world:
        raise ValueError(f'need {n_shards} ranks, have {world}')
    return dist.group.WORLD if n_shards == world else dist.new_group(list(range(n_shards)))


def _cameras(n: int, group) -> slice:
    """This rank's cameras of ``n``; raises unless the group's size divides n."""
    k, r = dist.get_world_size(group), dist.get_rank(group)
    if n % k:
        raise ValueError(f'{n} cameras do not split over {k} shards')
    nl = n // k
    return slice(r * nl, (r + 1) * nl)


def _shard_cam_front(model: STP3, feat_present: torch.Tensor, cams: slice, group):
    """The planner's front-camera feature from this rank's present-frame
    features (B, nl, Hf, Wf, C): the rank holding camera
    ``cam_front_index`` contributes it, the others zeros, summed over the
    group. None without a planner."""
    c = model.cfg
    if not c.planning_enabled:
        return None
    i = c.cam_front_index - cams.start
    if 0 <= i < feat_present.shape[1]:
        front = feat_present[:, i].contiguous()
    else:
        front = torch.zeros_like(feat_present[:, 0])
    dist.all_reduce(front, group=group)
    return front


def _sum_grid(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()
    dist.all_reduce(x, group=group)
    return x


def _gather_cameras(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' camera blocks of ``x`` concatenated along ``dim``, in rank
    (so camera) order."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim)


def make_cam_parallel_forward(model: STP3, group) -> Callable:
    """``fn(image, K, E, ego) -> output dict`` equal to ``model(image, K,
    E, ego)`` (eval) with the encode, lift and splat split over the ranks
    of ``group``. image (B, S, N, H, W, 3), N divisible by the group's
    size."""
    c = model.cfg

    @torch.no_grad()
    def forward(image, intrinsics, extrinsics, ego):
        rf = c.receptive_field
        image, intrinsics = image[:, :rf], intrinsics[:, :rf]
        extrinsics, ego = extrinsics[:, :rf], ego[:, :rf]
        cams = _cameras(image.shape[2], group)
        feat, depth = model.encode_cameras(image[:, :, cams])          # (B,S,nl,Hf,Wf,C)
        cam_front = _shard_cam_front(model, feat[:, -1], cams, group)
        geometry = model.camera_geometry(intrinsics[:, :, cams], extrinsics[:, :, cams])
        x = _sum_grid(model.splat_frames(feat, depth, geometry, ego, c.fused_lift_splat),
                      group)
        if depth is not None:
            depth = _gather_cameras(depth, 2, group)
        return model.forward_from_bev(x, depth, cam_front, ego)

    return forward


def make_cam_parallel_serve_step(model: STP3, group) -> Callable:
    """``STP3.serve_step`` with the present frame's encode, lift and splat
    split over the ranks of ``group``: ``fn(image, K, E,
    future_egomotion, cached_bev, trajs, commands, target_points) ->
    (refined traj, output dict, new cache)``. image (B, N, H, W, 3) is the
    present frame; each rank splats its cameras into a full present-frame
    grid (K1, no pre-warp), one all-reduce merges them, and the tail
    (cache warp, accumulate, temporal, future, decode, plan) runs
    unchanged."""

    @torch.no_grad()
    def serve(image, intrinsics, extrinsics, future_egomotion, cached_bev, trajs,
              commands, target_points):
        cams = _cameras(image.shape[1], group)
        feat, depth = model.encode_cameras(image[:, cams])              # (B,nl,Hf,Wf,C)
        cam_front = _shard_cam_front(model, feat, cams, group)
        bev = _sum_grid(model.splat_present(feat, depth, intrinsics[:, cams],
                                            extrinsics[:, cams]), group)
        return model._serve_tail(bev, cam_front, cached_bev, future_egomotion, trajs,
                                 commands, target_points)

    return serve


def make_cam_parallel_serve_step_static(model: STP3, group, intrinsics,
                                        extrinsics) -> Callable:
    """``STP3.serve_step_static`` with the present frame's encode and
    column-plan splat split over the ranks of ``group``. intrinsics (N,
    3, 3) / extrinsics (N, 4, 4): the fixed rig (host arrays); each rank
    builds the column plan of its own N/k cameras, on the model's device,
    here. Returns ``fn(image, future_egomotion, cached_bev, trajs,
    commands, target_points) -> (refined traj, output dict, new cache)``,
    equal to ``model.serve_step_static(..., plan)`` with the whole rig's
    column plan."""
    intrinsics, extrinsics = np.asarray(intrinsics), np.asarray(extrinsics)
    n = intrinsics.shape[0]
    cams = _cameras(n, group)
    plan = build_column_splat_plan(model.frustum, intrinsics[cams], extrinsics[cams],
                                   model.bev_resolution, model.bev_start_position,
                                   model.bev_dimension)
    arrays = plan.device_arrays(next(model.parameters()).device)

    @torch.no_grad()
    def serve(image, future_egomotion, cached_bev, trajs, commands, target_points):
        if image.shape[1] != n:
            raise ValueError(f'{image.shape[1]} cameras, the plan is of {n}')
        feat, depth = model.encode_cameras(image[:, cams])              # (B,nl,Hf,Wf,C)
        cam_front = _shard_cam_front(model, feat, cams, group)
        ctx, dp = context_depth_rays(model.cfg, feat, depth)
        bev = _sum_grid(column_splat(ctx, dp, arrays, plan.meta), group)
        return model._serve_tail(bev, cam_front, cached_bev, future_egomotion, trajs,
                                 commands, target_points)

    return serve


def make_cam_parallel_plan_step(model: STP3, group) -> Callable:
    """bench.py's plan step (forward -> occupancy -> planner) on the
    camera-parallel forward: ``fn(image, K, E, ego, trajs, gt_trajs,
    commands, target_points) -> refined traj``."""
    c = model.cfg
    forward = make_cam_parallel_forward(model, group)

    @torch.no_grad()
    def plan_step(image, intrinsics, extrinsics, ego, trajs, gt_trajs, commands,
                  target_points):
        out = forward(image, intrinsics, extrinsics, ego)
        rf = c.receptive_field
        occupancy = out['segmentation'].argmax(-1)
        if c.predict_pedestrian:            # no head without it (the Perception stage)
            occupancy = torch.logical_or(occupancy, out['pedestrian'].argmax(-1))
        _, traj = model.plan(out['cam_front'], trajs, gt_trajs, out['costvolume'][:, rf:],
                             occupancy.float()[:, rf:], out['hdmap'], commands,
                             target_points)
        return traj

    return plan_step
