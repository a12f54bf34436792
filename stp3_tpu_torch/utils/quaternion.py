"""Pose helpers (the port's own copy of stp3_tpu/utils/quaternion.py:
the planar ones the agent uses, the quaternion ones the datasets use;
numpy only, on the host)."""
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


# ---- quaternions (w, x, y, z), as in the nuScenes tables; the datasets'
# replacement of pyquaternion, as in stp3_tpu/utils/quaternion.py

def quat_to_rotation_matrix(q) -> np.ndarray:
    """3x3 rotation of a (not necessarily unit) quaternion."""
    w, x, y, z = np.asarray(q, dtype=np.float64)
    n = w * w + x * x + y * y + z * z
    if n < 1e-12:
        return np.eye(3)
    s = 2.0 / n
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return np.array([
        [1.0 - (yy + zz), xy - wz, xz + wy],
        [xy + wz, 1.0 - (xx + zz), yz - wx],
        [xz - wy, yz + wx, 1.0 - (xx + yy)],
    ])


def quat_inverse(q) -> np.ndarray:
    w, x, y, z = np.asarray(q, dtype=np.float64)
    n = w * w + x * x + y * y + z * z
    return np.array([w, -x, -y, -z]) / n


def quat_yaw(q) -> float:
    """Yaw about +z: the angle of the rotated x axis in the xy plane (the
    devkit's quaternion_yaw)."""
    v = quat_to_rotation_matrix(q) @ np.array([1.0, 0.0, 0.0])
    return float(np.arctan2(v[1], v[0]))


def yaw_quat(yaw: float) -> np.ndarray:
    return np.array([np.cos(yaw / 2.0), 0.0, 0.0, np.sin(yaw / 2.0)])


def yaw_from_matrix(mat: np.ndarray) -> float:
    """Yaw of a rotation (or 4x4 pose) matrix, xy-plane projection."""
    v = mat[:3, :3] @ np.array([1.0, 0.0, 0.0])
    return float(np.arctan2(v[1], v[0]))


def transform_matrix(translation, rotation_q, inverse: bool = False) -> np.ndarray:
    """4x4 rigid transform from a translation and a quaternion (the devkit's
    geometry_utils.transform_matrix)."""
    tm = np.eye(4)
    rot = quat_to_rotation_matrix(rotation_q)
    t = np.asarray(translation, dtype=np.float64)
    if inverse:
        tm[:3, :3] = rot.T
        tm[:3, 3] = -rot.T @ t
    else:
        tm[:3, :3] = rot
        tm[:3, 3] = t
    return tm
