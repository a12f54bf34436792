"""Closed-loop control of ST-P3's CARLA agent (carla_agent.py:54-76
PIDController, :278-321 control_pid), NumPy only."""
from __future__ import annotations

from collections import deque
from typing import Deque, Dict, Sequence, Tuple

import numpy as np


class PIDController:
    """Windowed PID (reference carla_agent.py:54-76)."""

    def __init__(self, k_p=1.0, k_i=0.0, k_d=0.0, n=20, window: Sequence[float] = ()):
        self.k_p, self.k_i, self.k_d = k_p, k_i, k_d
        self._window: Deque[float] = deque([0.0] * n, maxlen=n)
        self._window.extend(window)

    def step(self, error: float) -> float:
        self._window.append(error)
        if len(self._window) >= 2:
            integral = float(np.mean(self._window))
            derivative = self._window[-1] - self._window[-2]
        else:
            integral = derivative = 0.0
        return self.k_p * error + self.k_i * integral + self.k_d * derivative


def control_pid(waypoints: np.ndarray, speed: float, turn_controller: PIDController,
                speed_controller: PIDController) -> Tuple[float, float, bool, Dict]:
    """Refined waypoints (T, >=2) -> (steer, throttle, brake, metadata)
    (reference carla_agent.py:278-321): aim at the mean of the first two
    waypoints; desired speed from their spacing at 2 Hz."""
    waypoints = np.asarray(waypoints)
    aim = (waypoints[1] + waypoints[0]) / 2.0
    angle = float(np.degrees(np.pi / 2 - np.arctan2(aim[1], aim[0])) / 90)
    steer = float(np.clip(turn_controller.step(angle), -1.0, 1.0))

    desired_speed = float(np.linalg.norm(waypoints[0] - waypoints[1]) * 2.0)
    brake = (speed / max(desired_speed, 1e-6)) > 1.2
    delta = float(np.clip(desired_speed - speed, 0.0, 0.25))
    throttle = float(np.clip(speed_controller.step(delta), 0.0, 0.75))
    throttle = 0.0 if brake else throttle

    metadata = {
        'speed': float(speed), 'steer': steer, 'throttle': throttle,
        'brake': bool(brake), 'desired_speed': desired_speed,
        'angle': angle, 'aim': tuple(float(v) for v in aim),
        'wp_1': tuple(float(v) for v in waypoints[0]),
        'wp_2': tuple(float(v) for v in waypoints[1]),
    }
    return steer, throttle, bool(brake), metadata
