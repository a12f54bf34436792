"""The traffic generator: one function a traffic ``kind``, each reading its
parameters from ``traffic/<name>.json`` and the sizes from the cell's
configuration, and making everything from ``--seed`` (device tensors from
a ``torch.Generator`` on the card, host arrays from a NumPy generator).
The same seed gives the same traffic; every seed gives the same sizes.

- ``camera_sets``: a pool of input sets of one batch each, cycled by the
  timed steps: rf frames of every camera, the ring rig, ego-motion drawn
  per set, candidate trajectories, a command and a target point;
- ``carla_route``: a pool of uint8 4-camera frames at the simulator's size,
  cycled, and a route of GPS, compass, speed, command and target point for
  every tick;
- ``train_batches``: a pool of training batches in the loader's contract.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from cardbench.weights import generator

TRAFFIC = 1            # the generator stream of the traffic


def uniform(lo_hi, shape, gen, device) -> torch.Tensor:
    lo, hi = lo_hi
    return torch.rand(shape, generator=gen, device=device) * (hi - lo) + lo


def ring_rig(n: int, h: int, w: int, focal_share: float, radius: float, height: float):
    """(intrinsics (N, 3, 3), extrinsics (N, 4, 4)) of ``n`` cameras facing
    out of a ring at yaw 2 pi i / n, each at ``radius`` m and ``height`` m."""
    k = np.array([[focal_share * w, 0, w / 2], [0, focal_share * w, h / 2], [0, 0, 1]],
                 np.float32)
    e = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    rot = np.array([[0, 0, 1], [-1, 0, 0], [0, -1, 0]], np.float32)
    for i in range(n):
        yaw = 2 * np.pi * i / n
        yawm = np.array([[np.cos(yaw), -np.sin(yaw), 0], [np.sin(yaw), np.cos(yaw), 0],
                         [0, 0, 1]], np.float32)
        e[i, :3, :3] = yawm @ rot
        e[i, :3, 3] = [radius * np.cos(yaw), radius * np.sin(yaw), height]
    return np.tile(k, (n, 1, 1)), e


def arcs(speed, curvature, dt: float, steps: int) -> torch.Tensor:
    """(..., steps, 3) constant-curvature paths: (lateral, forward, heading)
    at t = dt, 2 dt, ..., for ``speed`` and ``curvature`` of shape (...)."""
    t = dt * torch.arange(1, steps + 1, device=speed.device, dtype=torch.float32)
    s = speed[..., None] * t                                     # arc length
    k = curvature[..., None]
    theta = k * s
    small = k.abs() < 1e-6
    safe = torch.where(small, torch.ones_like(k), k)
    forward = torch.where(small, s, torch.sin(theta) / safe)
    lateral = torch.where(small, 0.5 * k * s * s, (1 - torch.cos(theta)) / safe)
    return torch.stack([lateral, forward, theta], -1)


def camera_sets(p: dict, model: dict, seed: int, device, dtype) -> Dict[str, torch.Tensor]:
    """The pool of ``p['pool']`` input sets of batch 1 (a leading pool axis).
    Images are uniform in [0, 1) in ``dtype``; each set's ego-motion moves
    ``speed * frame_dt`` forward and turns by a yaw, per frame; its
    candidates are arcs sorted by their last lateral offset."""
    gen = generator(seed, device, TRAFFIC)
    n_pool, rf = int(p['pool']), int(model['receptive_field'])
    h, w = model['final_dim']
    cams, horizon = int(p['cameras']), int(model['n_future'])
    image = torch.rand((n_pool, 1, rf, cams, h, w, 3), generator=gen, device=device).to(dtype)
    k, e = ring_rig(cams, h, w, *p['rig'])
    intrinsics = torch.as_tensor(k, device=device).expand(n_pool, 1, rf, cams, 3, 3)
    extrinsics = torch.as_tensor(e, device=device).expand(n_pool, 1, rf, cams, 4, 4)
    ego = torch.zeros(n_pool, 1, rf, 6, device=device)
    ego[..., 0] = uniform(p['speed_mps'], (n_pool, 1, 1), gen, device) * p['frame_dt_s']
    ego[..., 5] = uniform(p['yaw_rad'], (n_pool, 1, rf), gen, device)
    n_cand = int(model['sample_num'])
    speed = uniform(p['candidate_speed_mps'], (n_pool, n_cand), gen, device)
    curvature = uniform(p['candidate_curvature'], (n_pool, n_cand), gen, device)
    trajs = arcs(speed, curvature, p['frame_dt_s'], horizon)
    order = trajs[..., -1, 0].argsort(-1)
    trajs = torch.gather(trajs, 1, order[..., None, None].expand_as(trajs))
    commands = torch.randint(0, int(p['commands']), (n_pool, 1), generator=gen, device=device)
    target = torch.stack([uniform(p['target_lateral_m'], (n_pool, 1), gen, device),
                          uniform(p['target_ahead_m'], (n_pool, 1), gen, device)], -1)
    return {'image': image, 'intrinsics': intrinsics.contiguous(),
            'extrinsics': extrinsics.contiguous(), 'ego': ego, 'trajs': trajs[:, None].to(dtype),
            'commands': commands, 'target': target.to(dtype)}


def carla_route(p: dict, model: dict, seed: int, device, n_ticks: int) -> dict:
    """``p['pool']`` ticks of uint8 frames {camera: (H, W, 3)} on the host at
    the simulator's size, and per tick for ``n_ticks`` ticks: GPS (m),
    compass (rad), speed (m/s), CARLA command and a target point in the
    ego frame, ``target_ticks_ahead`` ticks along the route."""
    gen = generator(seed, device, TRAFFIC)
    h, w = p['sensor_hw']
    cams = p['cameras']
    frames = torch.randint(0, 256, (int(p['pool']), len(cams), h, w, 3), generator=gen,
                           device=device, dtype=torch.uint8).cpu().numpy()
    pool = [{cam: frames[i, j] for j, cam in enumerate(cams)} for i in range(len(frames))]
    rng = np.random.default_rng([int(seed), TRAFFIC])
    ahead = int(p['target_ticks_ahead'])
    n = n_ticks + ahead
    step = rng.uniform(*p['gps_step_m'], n)
    turn = rng.uniform(*p['compass_turn_rad'], n)
    theta = np.cumsum(turn)
    x = np.cumsum(step * np.cos(theta))
    y = np.cumsum(step * np.sin(theta))
    speed = rng.uniform(*p['speed_mps'], n)
    commands = np.asarray(p['commands'])[np.arange(n) // int(p['command_ticks']) %
                                          len(p['commands'])]
    dx, dy = x[ahead:] - x[:-ahead], y[ahead:] - y[:-ahead]
    c, s = np.cos(theta[:-ahead]), np.sin(theta[:-ahead])
    # the target point in the ego frame: (lateral, forward)
    target = np.stack([-(-s * dx + c * dy), c * dx + s * dy], -1).astype(np.float32)
    return {'frames': pool, 'gps': np.stack([x, y], -1)[:n_ticks], 'compass': theta[:n_ticks],
            'speed': speed[:n_ticks], 'command': commands[:n_ticks], 'target': target}


def boxes(centre_x, centre_y, half_x: float, half_y: float, res, start, hw):
    """(..., H, W) int32 masks of axis-aligned boxes: centres (..., K) in
    metres (x forward, y side) on the BEV grid of cell size ``res`` whose
    first cell is centred on ``start``."""
    h, w = hw
    xs = start[0] + res[0] * torch.arange(h, device=centre_x.device)
    ys = start[1] + res[1] * torch.arange(w, device=centre_x.device)
    in_x = (xs - centre_x[..., None]).abs() <= half_x               # (..., K, H)
    in_y = (ys - centre_y[..., None]).abs() <= half_y               # (..., K, W)
    return (in_x[..., :, None] & in_y[..., None, :]).any(-3).to(torch.int32)


OFF_GRID_M = 1.0e4              # where an actor a row does not keep stands


def row_values(values: list, b: int, device) -> torch.Tensor:
    """(b,) row j's value, ``values[j % len(values)]``: the rows of a batch
    differ as scenes do (sparse and dense traffic, narrow and wide roads)."""
    return torch.tensor([float(values[j % len(values)]) for j in range(b)], device=device)


def train_batches(p: dict, model: dict, seed: int, device) -> list:
    """``p['pool']`` batches of ``p['batch']`` training samples in the
    loader's contract (uint8 images; labels over every frame, past and
    future): vehicles and pedestrians are boxes moving at constant
    velocity while the ego drives forward and turns slightly, the HD map
    a corridor with a lane divider, the GT trajectory and the candidates
    arcs, the command from the GT trajectory's last lateral offset. The
    actor counts and the corridor's half width are given a row each."""
    gen = generator(seed, device, TRAFFIC)
    b, rf, nf = int(p['batch']), int(model['receptive_field']), int(model['n_future'])
    s, dt = rf + nf, float(p['frame_dt_s'])
    h, w = model['final_dim']
    cams = int(p['cameras'])
    res = [model['x_bound'][2], model['y_bound'][2]]
    start = [model['x_bound'][0] + res[0] / 2, model['y_bound'][0] + res[1] / 2]
    hw = (int(round((model['x_bound'][1] - model['x_bound'][0]) / res[0])),
          int(round((model['y_bound'][1] - model['y_bound'][0]) / res[1])))
    k, e = ring_rig(cams, h, w, *p['rig'])
    t = (torch.arange(s, device=device) - (rf - 1)) * dt             # seconds from the present
    batches = []
    for _ in range(int(p['pool'])):
        speed = uniform(p['ego_speed_mps'], (b,), gen, device)
        yaw_rate = uniform(p['ego_yaw_rate'], (b,), gen, device)
        ego = torch.zeros(b, s, 6, device=device)
        ego[..., 0] = -(speed * dt)[:, None]
        ego[..., 5] = -(yaw_rate * dt)[:, None]
        labels = {}
        for kind, counts, half in (('segmentation', p['vehicles'], p['vehicle_half_m']),
                                   ('pedestrian', p['pedestrians'], p['pedestrian_half_m'])):
            count = max(counts)
            # row j keeps counts[j % len(counts)] actors; the others stand off the grid
            kept = torch.arange(count, device=device) < row_values(counts, b, device)[:, None]
            pos_x = uniform(p['actor_x_m'], (b, 1, count), gen, device)
            pos_x = torch.where(kept[:, None], pos_x, OFF_GRID_M)
            pos_y = uniform(p['actor_y_m'], (b, 1, count), gen, device)
            vel_x = uniform(p['actor_vx_mps'], (b, 1, count), gen, device)
            vel_y = uniform(p['actor_vy_mps'], (b, 1, count), gen, device)
            # in each frame's own ego frame: the ego has moved speed * t
            cx = pos_x + (vel_x - speed[:, None, None]) * t[None, :, None]
            cy = pos_y + vel_y * t[None, :, None]
            labels[kind] = boxes(cx, cy, half[0], half[1], res, start, hw)
        ys = start[1] + res[1] * torch.arange(hw[1], device=device).expand(b, *hw)
        corridor = row_values(p['corridor_half_m'], b, device)[:, None, None]
        hdmap = torch.stack([ys.abs() <= p['divider_half_m'], ys.abs() <= corridor],
                            -1).to(torch.int32)                              # (b, H, W, 2)
        tts = dt * torch.arange(nf + 1, device=device)
        gt = torch.stack([-torch.sin(yaw_rate[:, None] * tts) * speed[:, None] * tts * 0.5,
                          speed[:, None] * tts, yaw_rate[:, None] * tts], -1)
        command = torch.where(gt[:, -1, 0] >= 2, 2, torch.where(gt[:, -1, 0] <= -2, 0, 1))
        cand = arcs(uniform(p['candidate_speed_mps'], (b, int(model['sample_num'])), gen, device),
                    uniform(p['candidate_curvature'], (b, int(model['sample_num'])), gen, device),
                    dt, nf)
        cand = torch.gather(cand, 1, cand[..., -1, 0].argsort(-1)[..., None, None]
                            .expand_as(cand))
        cand = torch.cat([torch.zeros_like(cand[:, :, :1]), cand], 2)   # t = 0 first
        batches.append({
            'image': torch.randint(0, 256, (b, rf, cams, h, w, 3), generator=gen, device=device,
                                   dtype=torch.uint8),
            'intrinsics': torch.as_tensor(k, device=device).expand(b, rf, cams, 3, 3).contiguous(),
            'extrinsics': torch.as_tensor(e, device=device).expand(b, rf, cams, 4, 4).contiguous(),
            'future_egomotion': ego, **labels,
            'hdmap': hdmap[:, None].expand(b, s, *hdmap.shape[1:]).contiguous(),
            'gt_trajectory': gt, 'command': command.to(torch.int32),
            'sample_trajectory': cand,
            'target_point': torch.stack([gt[:, -1, 0], gt[:, -1, 1]], -1)})
    return batches
