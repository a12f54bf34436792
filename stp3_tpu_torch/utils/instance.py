"""Instance label generation — host-side numpy (the port's own copy of
``convert_instance_mask_to_center_and_offset_label`` and the helpers it
calls, stp3_tpu/utils/instance.py and stp3_tpu/utils/quaternion.py;
reference stp3/utils/instance.py:12-77).

Array layout is channels-last numpy: instance maps (T, H, W) int,
centerness (T, H, W, 1), offset/flow (T, H, W, 2).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def _euler2mat_np(angle: np.ndarray) -> np.ndarray:
    """Closed-form R = Rx @ Ry @ Rz of Euler angles (..., 3)."""
    x, y, z = angle[..., 0], angle[..., 1], angle[..., 2]
    cz, sz, cy, sy, cx, sx = np.cos(z), np.sin(z), np.cos(y), np.sin(y), np.cos(x), np.sin(x)
    r = np.stack([
        cy * cz, -cy * sz, sy,
        cx * sz + sx * sy * cz, cx * cz - sx * sy * sz, -sx * cy,
        sx * sz - cx * sy * cz, sx * cz + cx * sy * sz, cx * cy,
    ], axis=-1)
    return r.reshape(angle.shape[:-1] + (3, 3))


def _pose_vec2mat_np(vec: np.ndarray) -> np.ndarray:
    vec = np.asarray(vec)
    rot = _euler2mat_np(vec[..., 3:])
    out = np.zeros(vec.shape[:-1] + (4, 4), np.float32)
    out[..., :3, :3] = rot
    out[..., :3, 3] = vec[..., :3]
    out[..., 3, 3] = 1.0
    return out


def mat2pose_vec_np(matrix: np.ndarray) -> np.ndarray:
    """4x4 pose -> (tx, ty, tz, rx, ry, rz) float32."""
    m = np.asarray(matrix)
    rotx = np.arctan2(-m[..., 1, 2], m[..., 2, 2])
    cosy = np.sqrt(m[..., 1, 2] ** 2 + m[..., 2, 2] ** 2)
    roty = np.arctan2(m[..., 0, 2], cosy)
    rotz = np.arctan2(-m[..., 0, 1], m[..., 0, 0])
    return np.concatenate([
        m[..., :3, 3],
        np.stack([rotx, roty, rotz], axis=-1)], axis=-1).astype(np.float32)


def warp_features_np(x: np.ndarray, flow: np.ndarray, spatial_extent) -> np.ndarray:
    """Nearest-neighbour SE(2) warp of (H, W) or (H, W, C) by a 6-DoF pose
    vector (the numpy twin of ``ops/warp.py::warp_features``)."""
    squeeze = x.ndim == 2
    if squeeze:
        x = x[..., None]
    h, w, c = x.shape
    angle = flow[5]
    tx = -flow[0] / spatial_extent[0]
    ty = flow[1] / spatial_extent[1]
    cos_t, sin_t = np.cos(angle), np.sin(angle)
    # normalized base grid (align_corners=False)
    xs = (2.0 * np.arange(w) + 1.0) / w - 1.0
    ys = (2.0 * np.arange(h) + 1.0) / h - 1.0
    gx, gy = np.meshgrid(xs, ys)
    sx = cos_t * gx - sin_t * gy + ty
    sy = sin_t * gx + cos_t * gy + tx
    ix = np.floor(((sx + 1.0) * w - 1.0) / 2.0 + 0.5).astype(np.int64)
    iy = np.floor(((sy + 1.0) * h - 1.0) / 2.0 + 0.5).astype(np.int64)
    valid = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
    out = x[np.clip(iy, 0, h - 1), np.clip(ix, 0, w - 1)]
    out = np.where(valid[..., None], out, 0)
    return out[..., 0] if squeeze else out


def convert_instance_mask_to_center_and_offset_label(
        instance_img: np.ndarray, future_egomotion: np.ndarray,
        num_instances: int, ignore_index: int = 255,
        subtract_egomotion: bool = True, sigma: float = 3.0,
        spatial_extent: Optional[Tuple[float, float]] = None):
    """instance_img (T, H, W) int; future_egomotion (T, 6).

    Returns (centerness (T,H,W,1), offset (T,H,W,2), flow (T,H,W,2)).
    Offsets use (x=row, y=col) displacement to the instance centroid;
    flow is the ego-motion-compensated centroid displacement stamped on
    the *previous* frame's mask."""
    seq_len, h, w = instance_img.shape
    center_label = np.zeros((seq_len, h, w, 1), np.float32)
    offset_label = np.full((seq_len, h, w, 2), float(ignore_index), np.float32)
    flow_label = np.full((seq_len, h, w, 2), float(ignore_index), np.float32)
    x, y = np.meshgrid(np.arange(h, dtype=np.float32),
                       np.arange(w, dtype=np.float32), indexing='ij')

    if subtract_egomotion:
        mats = _pose_vec2mat_np(np.asarray(future_egomotion))
        inv = mat2pose_vec_np(np.linalg.inv(mats))

    warped_instance_seg = {}
    for t in range(1, seq_len):
        flow_vec = inv[t - 1] if subtract_egomotion else np.zeros(6)
        warped_instance_seg[t] = warp_features_np(
            instance_img[t].astype(np.float32), flow_vec, spatial_extent)

    for instance_id in range(1, num_instances + 1):
        prev_xc = prev_yc = prev_mask = None
        for t in range(seq_len):
            instance_mask = instance_img[t] == instance_id
            if instance_mask.sum() == 0:
                prev_xc = prev_yc = prev_mask = None
                continue
            xc = np.round(x[instance_mask].mean())
            yc = np.round(y[instance_mask].mean())
            off_x = xc - x
            off_y = yc - y
            g = np.exp(-(off_x ** 2 + off_y ** 2) / sigma ** 2)
            center_label[t, :, :, 0] = np.maximum(center_label[t, :, :, 0], g)
            offset_label[t, instance_mask, 0] = off_x[instance_mask]
            offset_label[t, instance_mask, 1] = off_y[instance_mask]

            if prev_xc is not None:
                warped_mask = warped_instance_seg[t] == instance_id
                if warped_mask.sum() > 0:
                    warped_xc = np.round(x[warped_mask].mean())
                    warped_yc = np.round(y[warped_mask].mean())
                    flow_label[t - 1, prev_mask, 0] = warped_xc - prev_xc
                    flow_label[t - 1, prev_mask, 1] = warped_yc - prev_yc
            prev_xc, prev_yc, prev_mask = xc, yc, instance_mask

    return center_label, offset_label, flow_label
