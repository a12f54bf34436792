"""Simulator-independent closed-loop agent core (port of
stp3_tpu/deploy/agent_core.py).

The per-tick logic of the reference's CARLA agent minus the simulator
plumbing, so it runs against recorded ticks and real CARLA alike:
  * 3-deep rolling buffers of (4-camera frames, gps, heading);
  * the fixed CARLA camera rig;
  * per-tick egomotion from consecutive gps / compass readings;
  * candidate trajectories sampled from (speed, last steering) with the
    module-level ``np.random``;
  * one forward + plan per tick, eager, under ``torch.inference_mode()``;
  * PID steering and speed controllers on the refined waypoints.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, Tuple

import numpy as np
import torch

from stp3_tpu_torch.datas.carla_data import (CARLA_CMD_TO_CODE, CMD_LANE, carla_cam_rig,
                                             scale_and_crop_image)
from stp3_tpu_torch.deploy.control import PIDController, control_pid
from stp3_tpu_torch.models.stp3 import STP3, STP3Config
from stp3_tpu_torch.ops.geometry import calculate_birds_eye_view_parameters, create_frustum
from stp3_tpu_torch.ops.static_splat import build_column_splat_plan
from stp3_tpu_torch.utils import sampler as trajectory_sampler
from stp3_tpu_torch.utils.device import resolve_device
from stp3_tpu_torch.utils.network import prepare_image
from stp3_tpu_torch.utils.quaternion import se2_egomotion_vec


class AgentCore:
    """Three tick modes:
    - ``incremental=False``: the exact full forward over the rf buffered
      frames every tick;
    - ``incremental=True, static_geometry=False``: ``STP3.serve_step``,
      only the new frame is encoded and splatted (K1); the past frames' BEV
      grids come from a rolling cache, grid-warped to the present;
    - ``incremental=True, static_geometry=True`` (the default):
      ``STP3.serve_step_static``, the splat with a column plan built once
      from the fixed rig (``ops/static_splat.py``).

    ``model`` is the port's ``STP3`` holding its weights; it runs in the
    dtype of those weights, with images prepared in fp32 (as the JAX
    ``AgentCore`` does) and then cast to it. It runs on the card unless
    ``device`` names another; with no card and no device it raises."""

    def __init__(self, cfg, model: STP3, device=None, warmup: bool = True,
                 incremental: bool = True, static_geometry: bool = True):
        self.device = resolve_device(device)
        if dataclasses.replace(model.cfg, fused_lift_splat=False) != STP3Config.from_cfg(cfg):
            raise ValueError('the model was not built from this config')
        self.incremental = incremental
        self.static_geometry = static_geometry and incremental
        self.cfg = cfg
        self.model = model.to(self.device).eval()
        self.dtype = next(model.parameters()).dtype
        self.rf = cfg.TIME_RECEPTIVE_FIELD
        self.n_future = cfg.N_FUTURE_FRAMES
        self.n_samples = cfg.PLANNING.SAMPLE_NUM
        self.crop = cfg.IMAGE.FINAL_DIM[0]

        self.buffer_rgb = deque(maxlen=self.rf)
        self.buffer_gps = deque(maxlen=self.rf)
        self.buffer_theta = deque(maxlen=self.rf)
        self.last_steer = 0.0
        self.step_count = -1

        self.turn_controller = PIDController(k_p=1.25, k_i=0.75, k_d=0.3, n=40)
        self.speed_controller = PIDController(k_p=5.0, k_i=0.5, k_d=1.0, n=40)

        extr, intr = carla_cam_rig(cfg.IMAGE.FINAL_DIM)
        self._extr = torch.as_tensor(np.tile(extr, (1, self.rf, 1, 1, 1)), device=self.device)
        self._intr = torch.as_tensor(np.tile(intr, (1, self.rf, 1, 1, 1)), device=self.device)
        self._bev_cache = None
        self._plan = None
        if self.static_geometry:
            res, start, dim = calculate_birds_eye_view_parameters(
                cfg.LIFT.X_BOUND, cfg.LIFT.Y_BOUND, cfg.LIFT.Z_BOUND)
            frustum = create_frustum(tuple(cfg.IMAGE.FINAL_DIM), cfg.MODEL.ENCODER.DOWNSAMPLE,
                                     tuple(cfg.LIFT.D_BOUND))
            self._plan = build_column_splat_plan(frustum, intr, extr, res, start,
                                                 dim).device_arrays(self.device)
        if warmup:
            self._warmup()

    # ------------------------------------------------------------ device calls
    def _tensor(self, a: np.ndarray, dtype=None) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device, dtype=dtype)

    def _image(self, img: np.ndarray) -> torch.Tensor:
        """uint8 frames (wire format) -> the model's input on the device."""
        return prepare_image(self._tensor(img), torch.float32).to(self.dtype)

    def _splat_one(self, img: np.ndarray) -> torch.Tensor:
        """Splat one (1, N, H, W, 3) frame, with the static plan when enabled."""
        if self.static_geometry:
            bev, _ = self.model.splat_single_frame_static(self._image(img), self._plan)
        else:
            bev, _ = self.model.splat_single_frame(self._image(img), self._intr[:, 0],
                                                   self._extr[:, 0])
        return bev

    def _serve_one(self, img, ego, cache, trajs, cmd, tp):
        args = (self._tensor(ego), cache, self._tensor(trajs, self.dtype),
                self._tensor(cmd), self._tensor(tp, self.dtype))
        if self.static_geometry:
            return self.model.serve_step_static(self._image(img), *args, self._plan)
        return self.model.serve_step(self._image(img), self._intr[:, 0], self._extr[:, 0],
                                     *args)

    def _infer(self, images, ego, trajs, cmd, tp):
        """The full forward + occupancy + plan."""
        model, rf = self.model, self.rf
        out = model(self._image(images), self._intr, self._extr, self._tensor(ego))
        occupancy = torch.logical_or(out['segmentation'].argmax(-1),
                                     out['pedestrian'].argmax(-1)).to(self.dtype)
        gt_dummy = torch.zeros(1, self.n_future, 3, dtype=self.dtype, device=self.device)
        _, traj = model.plan(out['cam_front'], self._tensor(trajs, self.dtype), gt_dummy,
                             out['costvolume'][:, rf:], occupancy[:, rf:], out['hdmap'],
                             self._tensor(cmd), self._tensor(tp, self.dtype))
        return traj, out

    @torch.inference_mode()
    def _warmup(self):
        """Run the tick's calls once on zeros (first-call set-up off the
        first planned tick)."""
        h = self.crop
        ego = np.zeros((1, self.rf, 6), np.float32)
        trajs = np.zeros((1, self.n_samples, self.n_future, 3), np.float32)
        cmd = np.zeros((1,), np.int32)
        tp = np.zeros((1, 2), np.float32)
        if self.incremental:
            img1 = np.zeros((1, 4, h, h, 3), np.uint8)
            bev = self._splat_one(img1)
            cache = torch.zeros((1, self.rf - 1) + tuple(bev.shape[1:]), dtype=bev.dtype,
                                device=self.device)
            traj, _, _ = self._serve_one(img1, ego, cache, trajs, cmd, tp)
        else:
            imgs = np.zeros((1, self.rf, 4, h, h, 3), np.uint8)
            traj, _ = self._infer(imgs, ego, trajs, cmd, tp)
        traj.cpu()

    # ------------------------------------------------------------ per tick
    def push_frame(self, rgb_by_cam: Dict[str, np.ndarray], gps, theta):
        """rgb_by_cam: {'rgb', 'rgb_left', 'rgb_right', 'rgb_rear'} HxWx3
        uint8. Frames stay uint8 on the host (the wire format); the ImageNet
        normalisation runs on the device."""
        frames = [np.asarray(scale_and_crop_image(rgb_by_cam[key], scale=1.0, crop=self.crop),
                             np.uint8)
                  for key in ['rgb', 'rgb_left', 'rgb_right', 'rgb_rear']]
        self.buffer_rgb.append(np.stack(frames))                   # (4, H, W, 3)
        self.buffer_gps.append(np.asarray(gps, np.float64))
        self.buffer_theta.append(float(theta))
        self.step_count += 1

    @property
    def warmed_up(self) -> bool:
        return len(self.buffer_rgb) >= self.rf and self.step_count >= self.rf + 1

    def _egomotion(self) -> np.ndarray:
        xs = [g[0] for g in self.buffer_gps]
        ys = [g[1] for g in self.buffer_gps]
        return se2_egomotion_vec(xs, ys, list(self.buffer_theta))[None]  # (1, rf, 6)

    def plan_step(self, speed: float, command_value: int,
                  target_point: np.ndarray) -> Tuple[float, float, bool, Dict]:
        """One model tick -> (steer, throttle, brake, metadata)."""
        ego = self._egomotion()
        trajs = trajectory_sampler.sample_trajectories(
            speed, self.last_steer, self.n_future, self.n_samples).astype(np.float32)
        cmd = np.asarray([CARLA_CMD_TO_CODE.get(command_value, CMD_LANE)], np.int32)
        tp = np.asarray(target_point, np.float32)[None]

        with torch.inference_mode():
            if self.incremental:
                new_img = self.buffer_rgb[-1][None]                  # (1, 4, H, W, 3)
                if self._bev_cache is None:
                    # first planned tick: splat the buffered past frames once
                    self._bev_cache = torch.stack(
                        [self._splat_one(f[None]) for f in list(self.buffer_rgb)[:-1]], 1)
                traj, _, self._bev_cache = self._serve_one(
                    new_img, ego, self._bev_cache, trajs[None, :, 1:], cmd, tp)
            else:
                images = np.stack(list(self.buffer_rgb))[None]       # (1, rf, 4, H, W, 3)
                traj, _ = self._infer(images, ego, trajs[None, :, 1:], cmd, tp)
            waypoints = traj[0, :, :2].float().cpu().numpy()
        steer, throttle, brake, metadata = control_pid(
            waypoints, speed, self.turn_controller, self.speed_controller)
        metadata['command'] = int(command_value)
        self.last_steer = steer
        return steer, throttle, brake, metadata
