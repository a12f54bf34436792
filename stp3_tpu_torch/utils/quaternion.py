"""Planar pose helpers (the port's own copy of the part of
stp3_tpu/utils/quaternion.py the agent uses; numpy only)."""
from __future__ import annotations

import numpy as np


def mat2pose_vec_np(matrix: np.ndarray) -> np.ndarray:
    """4x4 pose -> (tx, ty, tz, rx, ry, rz) float32, on the host."""
    m = np.asarray(matrix)
    rotx = np.arctan2(-m[..., 1, 2], m[..., 2, 2])
    cosy = np.sqrt(m[..., 1, 2] ** 2 + m[..., 2, 2] ** 2)
    roty = np.arctan2(m[..., 0, 2], cosy)
    rotz = np.arctan2(-m[..., 0, 1], m[..., 0, 0])
    return np.concatenate([
        m[..., :3, 3],
        np.stack([rotx, roty, rotz], axis=-1)], axis=-1).astype(np.float32)


def se2_pose_matrix(x: float, y: float, theta: float) -> np.ndarray:
    """4x4 pose of a planar (x, y, yaw) state."""
    m = np.eye(4, dtype=np.float32)
    c, s = np.cos(theta), np.sin(theta)
    m[:2, :2] = [[c, -s], [s, c]]
    m[0, 3], m[1, 3] = x, y
    return m


def se2_egomotion_vec(xs, ys, thetas) -> np.ndarray:
    """Per-step 6-DoF egomotion vectors vec(inv(e_{t+1}) @ e_t) of a planar
    trajectory, zero-padded to the sequence length: (T, 6) float32."""
    out = []
    for i in range(len(xs) - 1):
        e0 = se2_pose_matrix(xs[i], ys[i], thetas[i])
        e1 = se2_pose_matrix(xs[i + 1], ys[i + 1], thetas[i + 1])
        fe = np.linalg.inv(e1) @ e0
        fe[3, :3] = 0.0
        fe[3, 3] = 1.0
        out.append(mat2pose_vec_np(fe))
    out.append(np.zeros(6, np.float32))
    return np.stack(out)
