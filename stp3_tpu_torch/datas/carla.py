"""CARLA helpers the closed-loop agent needs (the port's own copies of
stp3_tpu/datas/carla_data.py:26-94): the fixed 4-camera rig, the
command codes and the centre crop.

Numpy only. The crop takes a numpy image; at scale 1.0, the only scale
the agent uses, a resize to the same size is a copy, so no image library
is needed. Other scales wait for the CARLA dataset loader.
"""
from __future__ import annotations

import numpy as np

# CARLA numeric command -> the planner's integer codes (0 LEFT / 1 FORWARD /
# 2 RIGHT / 3 LANE; LANE keeps all candidate trajectories)
CARLA_CMD_TO_CODE = {1: 0, 2: 2, 3: 1}
CMD_LANE = 3


def scale_and_crop_image(image, scale: float = 1.0, crop: int = 256) -> np.ndarray:
    """(H, W, ...) image -> its centre crop of crop x crop pixels."""
    if scale != 1.0:
        raise NotImplementedError(f'scale {scale}: only scale 1.0 is ported (the agent\'s)')
    arr = np.asarray(image)
    height, width = arr.shape[:2]
    sx = height // 2 - crop // 2
    sy = width // 2 - crop // 2
    return arr[sx:sx + crop, sy:sy + crop]


def carla_cam_rig(final_dim=(256, 256)):
    """4-camera rig (front, left, right, rear): extrinsics (4, 4, 4) cam ->
    ego and intrinsics (4, 3, 3) of a 400x300 FOV-100 camera cropped to
    ``final_dim``."""
    def cam_to_ego(x, y, z, yaw_deg):
        yaw = np.deg2rad(yaw_deg)
        c, s = np.cos(yaw), np.sin(yaw)
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
        m[:3, 3] = [x, y, z]
        return m

    extrinsics = np.stack([
        cam_to_ego(1.3, 0.0, 2.3, 0.0),     # front
        cam_to_ego(1.3, 0.0, 2.3, -60.0),   # left
        cam_to_ego(1.3, 0.0, 2.3, 60.0),    # right
        cam_to_ego(-1.3, 0.0, 2.3, 180.0),  # rear
    ])
    w, h, fov = 400, 300, 100
    f = w / (2 * np.tan(fov * np.pi / 360))
    k = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], np.float32)
    fh, fw = final_dim
    k[0, 2] -= (w - fw) / 2
    k[1, 2] -= (h - fh) / 2
    intrinsics = np.tile(k, (4, 1, 1))
    return extrinsics.astype(np.float32), intrinsics.astype(np.float32)
