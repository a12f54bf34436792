"""CARLA leaderboard agent of the port (counterpart of carla_agent.py;
reference carla_agent.py:79-576).

The per-tick logic lives in the simulator-independent
``deploy.agent_core.AgentCore``; this module adds the leaderboard glue:
the sensor suite, the warm-up phase of zero control, the route planner,
the control it emits and the metadata dumps (every 10th tick under
``$SAVE_PATH``, when that is set).

``STP3Agent().setup(checkpoint)`` loads a checkpoint of this package
(training/checkpoint.py; an imported reference checkpoint is one:
``stp3_tpu_torch.scripts.import_torch_checkpoint``) and runs the model on
the card unless ``setup`` names another device; with no card and no
device it raises. With the ``leaderboard`` package installed, ``STP3Agent``
is a leaderboard ``AutonomousAgent`` whose ``run_step`` returns a
``carla.VehicleControl``; without it, the harness class below takes its
place: ``set_global_plan`` and ``run_step`` returning a control dict, so
recorded ticks drive it with no simulator. Importing this module needs
neither package.
"""
from __future__ import annotations

import datetime
import json
import os
import pathlib
import time

import numpy as np

from stp3_tpu_torch.config import get_cfg
from stp3_tpu_torch.deploy.agent_core import AgentCore
from stp3_tpu_torch.deploy.control import RoutePlanner
from stp3_tpu_torch.models.stp3 import STP3, STP3Config
from stp3_tpu_torch.training import checkpoint as ckpt_lib
from stp3_tpu_torch.utils.device import resolve_device

CAMS = ('rgb', 'rgb_left', 'rgb_right', 'rgb_rear')


def get_entry_point():
    return 'STP3Agent'


def _base_agent_class():
    from leaderboard.autoagents import autonomous_agent
    return autonomous_agent.AutonomousAgent


def _sensor_suite():
    """4 RGB cameras + imu + gnss + speedometer (reference :136-185)."""
    cams = [
        ('rgb', 1.3, 0.0, 0.0),
        ('rgb_left', 1.3, 0.0, -60.0),
        ('rgb_right', 1.3, 0.0, 60.0),
        ('rgb_rear', -1.3, 0.0, 180.0),
    ]
    sensors = [{
        'type': 'sensor.camera.rgb', 'x': x, 'y': y, 'z': 2.3,
        'roll': 0.0, 'pitch': 0.0, 'yaw': yaw,
        'width': 400, 'height': 300, 'fov': 100, 'id': cam_id,
    } for cam_id, x, y, yaw in cams]
    sensors += [
        {'type': 'sensor.other.imu', 'x': 0.0, 'y': 0.0, 'z': 0.0,
         'roll': 0.0, 'pitch': 0.0, 'yaw': 0.0, 'sensor_tick': 0.05, 'id': 'imu'},
        {'type': 'sensor.other.gnss', 'x': 0.0, 'y': 0.0, 'z': 0.0,
         'roll': 0.0, 'pitch': 0.0, 'yaw': 0.0, 'sensor_tick': 0.01, 'id': 'gps'},
        {'type': 'sensor.speedometer', 'reading_frequency': 20, 'id': 'speed'},
    ]
    return sensors


class _TickMixin:
    """The tick and control logic shared by the leaderboard agent and the
    harness."""

    def _setup_core(self, checkpoint_path: str, device=None):
        device = resolve_device(device)
        cfg_dict = ckpt_lib.load_config_dict(checkpoint_path)
        if cfg_dict is None:
            raise FileNotFoundError(f'no config.json beside checkpoint {checkpoint_path}')
        cfg = get_cfg(cfg_dict=cfg_dict)
        cfg.MODEL.REMAT = 'none'  # a train-time policy, as in evaluate.py
        model = STP3(STP3Config.from_cfg(cfg))
        model.load_state_dict(ckpt_lib.load_checkpoint(checkpoint_path)['model'])
        self.cfg = cfg
        self.core = AgentCore(cfg, model, device=device)
        self.save_path = None
        save_root = os.environ.get('SAVE_PATH')
        if save_root is not None:
            now = datetime.datetime.now()
            string = pathlib.Path(os.environ.get('ROUTES', 'route')).stem + '_'
            string += '_'.join(f'{x:02d}' for x in
                               (now.month, now.day, now.hour, now.minute, now.second))
            self.save_path = pathlib.Path(save_root) / string
            (self.save_path / 'meta').mkdir(parents=True, exist_ok=True)

    def _tick(self, input_data):
        # BGRA -> RGB: the first three channels, reversed
        rgb = {key: input_data[key][1][:, :, 2::-1] for key in CAMS}
        gps = input_data['gps'][1][:2]
        speed = input_data['speed'][1]['speed']
        compass = input_data['imu'][1][-1]

        pos = (gps - self._route_planner.mean) * self._route_planner.scale
        next_wp, next_cmd = self._route_planner.run_step(pos)

        theta = compass + np.pi / 2
        r = np.array([[np.cos(theta), -np.sin(theta)],
                      [np.sin(theta), np.cos(theta)]])
        local_command_point = r.T @ np.array([next_wp[0] - pos[0], next_wp[1] - pos[1]])
        local_command_point = local_command_point * [1.0, -1.0]

        self.core.push_frame(rgb, pos, compass)
        return {'speed': speed, 'next_command': next_cmd,
                'target_point': local_command_point}

    def _control(self, tick):
        if not self.core.warmed_up:
            return 0.0, 0.0, 0.0
        steer, throttle, brake, metadata = self.core.plan_step(
            tick['speed'], tick['next_command'], tick['target_point'])
        self.pid_metadata = metadata
        brake_f = float(brake)
        if brake_f < 0.05:
            brake_f = 0.0
        if throttle > brake_f:
            brake_f = 0.0
        if self.save_path is not None and self.core.step_count % 10 == 0:
            with open(self.save_path / 'meta' / f'{self.core.step_count:06d}.json', 'w') as f:
                json.dump(metadata, f, indent=2)
        return steer, throttle, brake_f


try:
    _Base = _base_agent_class()

    class STP3Agent(_Base, _TickMixin):  # type: ignore[misc]
        def setup(self, path_to_conf_file, device=None):
            from leaderboard.autoagents import autonomous_agent
            self.track = autonomous_agent.Track.SENSORS
            self.wall_start = time.time()
            self.initialized = False
            self._setup_core(path_to_conf_file, device)

        def _init(self):
            self._route_planner = RoutePlanner(1.0, 50.0)
            self._route_planner.set_route(self._global_plan, True)
            self.initialized = True

        def sensors(self):
            return _sensor_suite()

        def run_step(self, input_data, timestamp):
            import carla
            if not self.initialized:
                self._init()
            tick = self._tick(input_data)
            steer, throttle, brake = self._control(tick)
            control = carla.VehicleControl()
            control.steer = float(steer)
            control.throttle = float(throttle)
            control.brake = float(brake)
            return control

except ImportError:
    # no CARLA / leaderboard here: the harness, driven by recorded ticks
    class STP3Agent(_TickMixin):  # type: ignore[no-redef]
        def setup(self, path_to_conf_file, device=None):
            self.initialized = False
            self._setup_core(path_to_conf_file, device)

        def set_global_plan(self, global_plan):
            self._route_planner = RoutePlanner(1.0, 50.0)
            self._route_planner.set_route(global_plan, True)
            self.initialized = True

        def sensors(self):
            return _sensor_suite()

        def run_step(self, input_data, timestamp=None):
            tick = self._tick(input_data)
            steer, throttle, brake = self._control(tick)
            return {'steer': steer, 'throttle': throttle, 'brake': brake}
