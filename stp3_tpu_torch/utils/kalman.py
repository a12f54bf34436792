"""Linear Kalman filter on tensors (port of stp3_tpu/utils/kalman.py; the
reference defines an unused ``KalmanFilter`` nn.Module,
stp3/utils/tools.py:392-437), for trajectory smoothing and tracking.

State-space model:
    x_{t+1} = F x_t + w,  w ~ N(0, Q)
    z_t     = H x_t + v,  v ~ N(0, R)
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


class KalmanState(NamedTuple):
    x: torch.Tensor   # (n,) state mean
    p: torch.Tensor   # (n, n) state covariance


class KalmanFilter:
    def __init__(self, f, h, q, r):
        self.f = torch.as_tensor(f)
        self.h = torch.as_tensor(h)
        self.q = torch.as_tensor(q)
        self.r = torch.as_tensor(r)

    def init(self, x0, p0) -> KalmanState:
        return KalmanState(torch.as_tensor(x0), torch.as_tensor(p0))

    def predict(self, s: KalmanState) -> KalmanState:
        return KalmanState(self.f @ s.x, self.f @ s.p @ self.f.T + self.q)

    def update(self, s: KalmanState, z) -> KalmanState:
        y = torch.as_tensor(z) - self.h @ s.x
        inn_cov = self.h @ s.p @ self.h.T + self.r
        k = s.p @ self.h.T @ torch.linalg.inv(inn_cov)
        x = s.x + k @ y
        p = (torch.eye(s.p.shape[0], dtype=s.p.dtype, device=s.p.device) - k @ self.h) @ s.p
        return KalmanState(x, p)

    def filter(self, s0: KalmanState, zs) -> Tuple[KalmanState, torch.Tensor]:
        """predict + update over a sequence zs (T, m): (the last state, the
        state means (T, n)), as the JAX filter's ``lax.scan`` returns them."""
        s, xs = s0, []
        for z in torch.as_tensor(zs):
            s = self.update(self.predict(s), z)
            xs.append(s.x)
        return s, torch.stack(xs)
