"""Instance labels and their decoding, on the host in numpy (the port's
own copy of stp3_tpu/utils/instance.py and of the helpers it calls from
stp3_tpu/utils/quaternion.py; reference stp3/utils/instance.py).

  * label generation (``convert_instance_mask_to_center_and_offset_label``),
    in the data pipeline;
  * center decoding, pixel grouping and temporally consistent ids by
    Hungarian matching (``predict_instance_segmentation_and_trajectories``),
    at evaluation. Its per-frame decode runs on the tensors' device by
    default (utils/instance_jit.py, id for id the same); the host loop
    stays as ``jit_decode=False``.

Array layout is channels-last: instance maps (T, H, W) int, centerness
(T, H, W, 1), offset/flow (T, H, W, 2).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
from scipy.optimize import linear_sum_assignment

from stp3_tpu_torch.utils.device import as_numpy, as_tensor
from stp3_tpu_torch.utils.instance_jit import decode_instances


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


# --------------------------------------------------------------------------
# Center decoding (reference instance.py:80-170)
# --------------------------------------------------------------------------
def find_instance_centers(center_prediction: np.ndarray, conf_threshold: float = 0.1,
                          nms_kernel_size: int = 3) -> np.ndarray:
    """center_prediction (H, W) -> (K, 2) int (row, col). Maxpool NMS."""
    h, w = center_prediction.shape
    cp = np.where(center_prediction > conf_threshold, center_prediction, -1.0)
    pad = (nms_kernel_size - 1) // 2
    padded = np.pad(cp, pad, constant_values=-np.inf)
    maxpooled = np.stack([padded[i:i + h, j:j + w] for i in range(nms_kernel_size)
                          for j in range(nms_kernel_size)]).max(axis=0)
    cp = np.where(cp != maxpooled, -1.0, cp)
    return np.argwhere(cp > 0)


def group_pixels(centers: np.ndarray, offset_predictions: np.ndarray) -> np.ndarray:
    """centers (K, 2); offsets (H, W, 2) -> instance ids (H, W) in [1, K]."""
    h, w = offset_predictions.shape[:2]
    gx, gy = np.meshgrid(np.arange(h, dtype=np.float32), np.arange(w, dtype=np.float32),
                         indexing='ij')
    loc = np.stack([gx, gy], -1) + offset_predictions
    d = np.linalg.norm(centers[:, None, None, :] - loc[None], axis=-1)   # (K, H, W)
    return d.argmin(axis=0) + 1


def make_instance_seg_consecutive(instance_seg: np.ndarray) -> np.ndarray:
    unique_ids = np.unique(instance_seg)
    lut = np.zeros(int(unique_ids.max()) + 1, np.int64)
    lut[unique_ids] = np.arange(len(unique_ids))
    return lut[instance_seg]


def update_instance_ids(instance_seg: np.ndarray, old_ids, new_ids) -> np.ndarray:
    indices = np.arange(int(np.max(old_ids)) + 1)
    for old_id, new_id in zip(old_ids, new_ids):
        indices[old_id] = new_id
    return indices[instance_seg]


def get_instance_segmentation_and_centers(
        center_predictions: np.ndarray, offset_predictions: np.ndarray,
        foreground_mask: np.ndarray, conf_threshold: float = 0.1,
        nms_kernel_size: int = 3, max_n_instance_centers: int = 100):
    """(H, W), (H, W, 2), (H, W) bool -> (instance_seg (H, W) int, centers (K, 2))."""
    centers = find_instance_centers(center_predictions, conf_threshold, nms_kernel_size)
    if len(centers) == 0:
        return np.zeros_like(center_predictions, dtype=np.int64), np.zeros((0, 2))
    centers = centers[:max_n_instance_centers]
    instance_ids = group_pixels(centers.astype(np.float32), offset_predictions)
    instance_seg = (instance_ids * foreground_mask).astype(np.int64)
    return make_instance_seg_consecutive(instance_seg), centers


# --------------------------------------------------------------------------
# Temporal consistency (reference instance.py:173-269)
# --------------------------------------------------------------------------
def make_instance_id_temporally_consistent(pred_inst: np.ndarray, future_flow: np.ndarray,
                                           matching_threshold: float = 3.0) -> np.ndarray:
    """pred_inst (T, H, W); future_flow (T, H, W, 2). Hungarian-matches
    flow-warped instance centers across consecutive frames."""
    seq_len, h, w = pred_inst.shape
    consistent = [pred_inst[0]]
    largest_instance_id = int(pred_inst[0].max())
    base_grid = np.stack(np.meshgrid(np.arange(h, dtype=np.float32),
                                     np.arange(w, dtype=np.float32), indexing='ij'))
    for t in range(seq_len - 1):
        grid = base_grid + np.moveaxis(future_flow[t], -1, 0)
        t_instance_ids = np.unique(consistent[-1])[1:]
        if len(t_instance_ids) == 0:
            consistent.append(pred_inst[t + 1])
            continue
        warped_centers = np.stack([grid[:, consistent[-1] == iid].mean(axis=1)
                                   for iid in t_instance_ids])

        n_instances = int(pred_inst[t + 1].max())
        if n_instances == 0:
            consistent.append(pred_inst[t + 1])
            continue
        centers = np.stack([base_grid[:, pred_inst[t + 1] == iid].mean(axis=1)
                            for iid in range(1, n_instances + 1)])

        distances = np.linalg.norm(centers[None] - warped_centers[:, None], axis=-1)
        ids_t, ids_t_one = linear_sum_assignment(distances)
        matching_distances = distances[ids_t, ids_t_one]
        ids_t = ids_t + 1
        ids_t_one = ids_t_one + 1
        id_mapping = dict(zip(np.arange(1, len(t_instance_ids) + 1), t_instance_ids))
        ids_t = np.array([id_mapping[i] for i in ids_t], np.int64)

        keep = matching_distances < matching_threshold
        ids_t, ids_t_one = ids_t[keep], ids_t_one[keep]

        remaining_ids = set(np.unique(pred_inst[t + 1])) - set(ids_t_one) - {0}
        for remaining_id in sorted(remaining_ids):
            largest_instance_id += 1
            ids_t = np.append(ids_t, largest_instance_id)
            ids_t_one = np.append(ids_t_one, remaining_id)

        if len(ids_t_one):
            consistent.append(update_instance_ids(pred_inst[t + 1], ids_t_one, ids_t))
        else:
            consistent.append(pred_inst[t + 1])
    return np.stack(consistent)


def predict_instance_segmentation_and_trajectories(
        output: Dict, compute_matched_centers: bool = False, make_consistent: bool = True,
        vehicles_id: int = 1, jit_decode: bool = True, decoded=None):
    """``output``: the model's channels-last heads, tensors or numpy:
    segmentation (B, S, H, W, C) logits (fp32), instance_center (B, S, H,
    W, 1), instance_offset (B, S, H, W, 2), instance_flow (B, S, H, W, 2)
    or None (reference instance.py:272-330). Returns the consistent
    instance ids (B, S, H, W) int64 numpy (and, with
    ``compute_matched_centers``, each id's center per frame).

    ``jit_decode``: the per-frame NMS and grouping on the tensors' device
    (utils/instance_jit.py), so only the id maps come to the host; False
    runs the host numpy loop. ``decoded``: the per-frame ids already
    decoded (``utils/instance_jit.decode_instances``' (B, S, H, W), a
    tensor or numpy), which are linked without a second decode; ``output``
    then needs only its instance_flow."""
    if decoded is not None:
        pred_inst = as_numpy(decoded).astype(np.int64, copy=False)
    elif jit_decode:
        seg = as_tensor(output['segmentation'])
        pred_inst = decode_instances(seg, as_tensor(output['instance_center'], seg.device),
                                     as_tensor(output['instance_offset'], seg.device),
                                     vehicles_id=vehicles_id).cpu().numpy()
    else:
        preds = as_numpy(output['segmentation']).argmax(axis=-1)
        foreground = preds == vehicles_id
        center = as_numpy(output['instance_center'])[..., 0]
        offset = as_numpy(output['instance_offset'])
        pred_inst = np.zeros_like(preds, dtype=np.int64)
        for b in range(preds.shape[0]):
            for t in range(preds.shape[1]):
                pred_inst[b, t], _ = get_instance_segmentation_and_centers(
                    center[b, t], offset[b, t], foreground[b, t])
    batch_size, seq_len = pred_inst.shape[:2]

    if make_consistent:
        flow = output.get('instance_flow')
        flow = (as_numpy(flow) if flow is not None
                else np.zeros(pred_inst.shape + (2,), np.float32))
        consistent = np.stack([make_instance_id_temporally_consistent(pred_inst[b], flow[b])
                               for b in range(batch_size)])
    else:
        consistent = pred_inst

    if compute_matched_centers:
        assert batch_size == 1
        matched_centers: Dict[int, np.ndarray] = {}
        h, w = consistent.shape[-2:]
        grid = np.stack(np.meshgrid(np.arange(h, dtype=np.float32),
                                    np.arange(w, dtype=np.float32), indexing='ij'))
        for instance_id in np.unique(consistent[0, 0])[1:]:
            pts = []
            for t in range(seq_len):
                mask = consistent[0, t] == instance_id
                if mask.sum() > 0:
                    pts.append(grid[:, mask].mean(axis=-1))
            matched_centers[int(instance_id)] = np.stack(pts)[:, ::-1]
        return consistent, matched_centers
    return consistent
