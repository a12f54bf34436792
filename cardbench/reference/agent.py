"""The CARLA agent's host side in plain NumPy and PyTorch, for the
reference: the fixed 4-camera rig, the centre crop of a frame, the
ImageNet normalisation and the per-tick ego-motion from GPS and compass
(ST-P3's ``carla_agent.py``)."""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def carla_cam_rig(final_dim=(256, 256)):
    """extrinsics (4, 4, 4) cam -> ego and intrinsics (4, 3, 3) of the
    front, left, right and rear 400x300 FOV-100 cameras cropped to
    ``final_dim``."""
    def cam_to_ego(x, y, z, yaw_deg):
        yaw = np.deg2rad(yaw_deg)
        c, s = np.cos(yaw), np.sin(yaw)
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
        m[:3, 3] = [x, y, z]
        return m

    extrinsics = np.stack([cam_to_ego(1.3, 0.0, 2.3, 0.0), cam_to_ego(1.3, 0.0, 2.3, -60.0),
                           cam_to_ego(1.3, 0.0, 2.3, 60.0), cam_to_ego(-1.3, 0.0, 2.3, 180.0)])
    w, h, fov = 400, 300, 100
    f = w / (2 * np.tan(fov * np.pi / 360))
    k = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], np.float32)
    fh, fw = final_dim
    k[0, 2] -= (w - fw) / 2
    k[1, 2] -= (h - fh) / 2
    return extrinsics.astype(np.float32), np.tile(k, (4, 1, 1)).astype(np.float32)


def centre_crop(image: np.ndarray, crop: int) -> np.ndarray:
    """The centre ``crop`` x ``crop`` pixels of an (H, W, ...) image."""
    top = image.shape[0] // 2 - crop // 2
    left = image.shape[1] // 2 - crop // 2
    return image[top:top + crop, left:left + crop]


def normalise(image: torch.Tensor) -> torch.Tensor:
    """uint8 RGB -> ImageNet-normalised fp32."""
    mean = torch.tensor(IMAGENET_MEAN, device=image.device)
    std = torch.tensor(IMAGENET_STD, device=image.device)
    return (image.float() / 255.0 - mean) / std


def _pose(x: float, y: float, theta: float) -> np.ndarray:
    m = np.eye(4)
    c, s = np.cos(theta), np.sin(theta)
    m[:2, :2] = [[c, -s], [s, c]]
    m[0, 3], m[1, 3] = x, y
    return m


def egomotion(xs: Sequence[float], ys: Sequence[float], thetas: Sequence[float]) -> np.ndarray:
    """(T, 6) float32: the planar motion from each state to the next as
    (tx, ty, tz, rx, ry, rz) of inv(pose_{t+1}) @ pose_t, zeros last."""
    out = []
    for i in range(len(xs) - 1):
        m = np.linalg.inv(_pose(xs[i + 1], ys[i + 1], thetas[i + 1])) @ _pose(xs[i], ys[i],
                                                                            thetas[i])
        rotx = np.arctan2(-m[1, 2], m[2, 2])
        roty = np.arctan2(m[0, 2], np.sqrt(m[1, 2] ** 2 + m[2, 2] ** 2))
        rotz = np.arctan2(-m[0, 1], m[0, 0])
        out.append(np.array([m[0, 3], m[1, 3], m[2, 3], rotx, roty, rotz]))
    out.append(np.zeros(6))
    return np.stack(out).astype(np.float32)
