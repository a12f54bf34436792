"""The CARLA dataset (offline dumps): the port's counterpart of
stp3_tpu/datas/carla_data.py (reference stp3/datas/CarlaData.py), sample
for sample the same arrays, and the helpers the closed-loop agent shares
with it (the fixed 4-camera rig, the command codes, the centre crop).

Route folders are preloaded and cached (Town01-04, 06, 10 train, Town05
val); 4 cameras at fixed mounts with FOV-100 intrinsics cropped square;
depth PNGs decoded to metres; the topdown semantic PNG (resized NEAREST
at scale 1.1) gives the vehicle and pedestrian labels with the ego
region zeroed; the hdmap PNG the lane and drivable channels; the local
target point from the global command point; CARLA's numeric command the
planner's LEFT / FORWARD / RIGHT / LANE code.

PNGs are read and resized by the port's own image I/O
(``utils/image_io.py``, host C, Pillow's arithmetic): no PIL.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np

from stp3_tpu_torch.utils import image_io
from stp3_tpu_torch.utils import sampler as trajectory_sampler
from stp3_tpu_torch.utils.quaternion import se2_egomotion_vec

# CARLA numeric command -> the planner's integer codes (0 LEFT / 1 FORWARD /
# 2 RIGHT / 3 LANE; LANE keeps all candidate trajectories)
CARLA_CMD_TO_CODE = {1: 0, 2: 2, 3: 1}
CMD_LANE = 3


def _scale_and_crop(image, scale: float, crop: int, resample: str) -> np.ndarray:
    arr = np.asarray(image)
    height, width = arr.shape[:2]
    size = (int(width // scale), int(height // scale))
    if size != (width, height):
        arr = image_io.resample(arr, size, resample)
    sx = size[1] // 2 - crop // 2
    sy = size[0] // 2 - crop // 2
    return arr[sx:sx + crop, sy:sy + crop]


def scale_and_crop_image(image, scale: float = 1.0, crop: int = 256, mode: str = '') -> np.ndarray:
    """An (H, W, ...) uint8 image resized to 1 / ``scale`` of its size as
    Pillow's ``Image.resize`` with its default filter does (BICUBIC;
    NEAREST for a palette image, ``mode`` 'P'; at scale 1.0 a copy), then
    its centre crop of ``crop`` x ``crop`` pixels."""
    return _scale_and_crop(image, scale, crop, 'nearest' if mode == 'P' else 'bicubic')


def scale_and_crop_image_nearest(image, scale: float, crop: int) -> np.ndarray:
    """``scale_and_crop_image`` with NEAREST resampling (the labels)."""
    return _scale_and_crop(image, scale, crop, 'nearest')


def decode_depth(data: np.ndarray) -> np.ndarray:
    """CARLA 24-bit RGB depth PNG -> metres (reference :345-353)."""
    data = data.astype(np.float32)
    normalized = data @ np.array([65536.0, 256.0, 1.0], np.float32)
    return normalized / (256 ** 3 - 1) * 1000.0


def transform_2d_points(xyz, r1, t1_x, t1_y, r2, t2_x, t2_y):
    """SE(2) frame change (reference :467-489)."""
    xy1 = xyz.copy()
    xy1[:, 2] = 1
    c, s = np.cos(r1), np.sin(r1)
    r1_to_world = np.array([[c, s, t1_x], [-s, c, t1_y], [0, 0, 1]])
    world = r1_to_world @ xy1.T
    c, s = np.cos(r2), np.sin(r2)
    r2_to_world = np.array([[c, s, t2_x], [-s, c, t2_y], [0, 0, 1]])
    out = (np.linalg.inv(r2_to_world) @ world).T
    out[:, 2] = xyz[:, 2]
    return out


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


class CarlaDataset:
    SAMPLE_INTERVAL = 0.5  # seconds

    def __init__(self, root_dir: str, is_train: bool, cfg):
        image_io.load()            # built here, before a loader starts its workers
        self.root_dir = root_dir
        self.is_train = is_train
        self.cfg = cfg
        self.sequence_length = cfg.TIME_RECEPTIVE_FIELD + cfg.N_FUTURE_FRAMES
        self.receptive_field = cfg.TIME_RECEPTIVE_FIELD
        self.n_samples = cfg.PLANNING.SAMPLE_NUM
        self.seqs: List[Dict] = []
        self._preload()

    # ------------------------------------------------------------- preload
    def _towns(self):
        if self.is_train:
            towns = ['Town01', 'Town02', 'Town03', 'Town04', 'Town06', 'Town10']
            return [os.path.join(self.root_dir, t + suffix)
                    for t in towns for suffix in ('_tiny', '_short')]
        return [os.path.join(self.root_dir, 'Town05_short')]

    def _preload(self):
        """Each town's sequences, from its cache file (the JAX package's
        name and format) or scanned and cached."""
        for subroot in self._towns():
            if not os.path.isdir(subroot):
                continue
            cache = os.path.join(
                subroot,
                f'stp3tpu_preload_{self.receptive_field}_{self.sequence_length}.npy')
            if os.path.exists(cache):
                self.seqs += list(np.load(cache, allow_pickle=True))
                continue
            entries = self._scan_subroot(subroot)
            np.save(cache, np.asarray(entries, dtype=object), allow_pickle=True)
            self.seqs += entries
            print(f'Preloaded {len(entries)} sequences from {subroot}')

    def _scan_subroot(self, subroot):
        entries = []
        routes = [f for f in sorted(os.listdir(subroot))
                  if os.path.isdir(os.path.join(subroot, f))]
        for route in routes:
            rd = os.path.join(subroot, route)
            n_frames = len(os.listdir(os.path.join(rd, 'rgb_front')))
            for seq in range(n_frames - self.sequence_length):
                frames = [f'{seq + 1 + i:04d}' for i in range(self.sequence_length)]
                xs, ys, thetas = [], [], []
                meas_last = None
                for fid in frames:
                    with open(os.path.join(rd, 'measurements', fid + '.json')) as f:
                        m = json.load(f)
                    xs.append(m['x'])
                    ys.append(m['y'])
                    thetas.append(0.0 if np.isnan(m['theta']) else m['theta'])
                    if len(xs) == self.receptive_field:
                        meas_last = m
                entries.append({
                    'route_dir': rd, 'frames': frames,
                    'x': xs, 'y': ys, 'theta': thetas,
                    'x_command': meas_last['x_command'],
                    'y_command': meas_last['y_command'],
                    'steer': meas_last['steer'],
                    'throttle': meas_last['throttle'],
                    'brake': meas_last['brake'],
                    'command': meas_last['command'],
                    'velocity': meas_last['speed'],
                })
        return entries

    def __len__(self):
        return len(self.seqs)

    # -------------------------------------------------------------- labels
    def get_labels(self, path, scale: float = 1.1, crop: int = 200):
        """topdown semantic PNG -> (vehicle, pedestrian) binary (H, W)
        (reference :262-280); the ego region zeroed."""
        img = scale_and_crop_image_nearest(image_io.read_png(path), scale, crop)
        vehicle = (img == 10).astype(np.float64)
        vehicle[89:112, 96:105] = 0  # ego blob
        pedestrian = (img == 4).astype(np.float64)
        vehicle = vehicle[::-1, ::-1]
        pedestrian = pedestrian[::-1, ::-1]
        return vehicle.copy().astype(np.int32), pedestrian.copy().astype(np.int32)

    def get_hdmap(self, path, scale: float = 1.0, crop: int = 200):
        """hdmap PNG -> (H, W, 2) [lane, drivable] (reference :240-260)."""
        img, mode = image_io.decode_png(image_io.read_bytes(path), str(path))
        img = scale_and_crop_image(img, scale, crop, mode)
        lane = np.all(img == [255, 0, 255], axis=2).astype(np.float64)
        drivable = np.all(img == [54, 52, 46], axis=2).astype(np.float64)
        drivable = np.logical_or(drivable, lane)
        lane = lane[::-1, ::-1]
        drivable = drivable[::-1, ::-1]
        return np.stack([lane, drivable], -1).astype(np.int32)

    def get_future_egomotion(self, xs, ys, thetas) -> np.ndarray:
        return se2_egomotion_vec(xs, ys, thetas)

    # ------------------------------------------------------------ __getitem__
    def __getitem__(self, index) -> Dict[str, np.ndarray]:
        entry = self.seqs[index]
        rd, frames = entry['route_dir'], entry['frames']
        rf = self.receptive_field
        fh, fw = self.cfg.IMAGE.FINAL_DIM
        if fh != fw:
            raise ValueError(f'CARLA crops are square; IMAGE.FINAL_DIM is {(fh, fw)}')

        extrinsics, intrinsics = carla_cam_rig((fh, fw))
        cams = ['front', 'left', 'right', 'rear']
        images, depths, hdmaps = [], [], []
        for i in range(rf):
            frame_imgs, frame_depths = [], []
            for cam in cams:
                rgb = scale_and_crop_image(
                    image_io.read_png(os.path.join(rd, f'rgb_{cam}', frames[i] + '.png')),
                    1.0, fh)
                frame_imgs.append(np.asarray(rgb, np.uint8))   # uint8 on the wire
                d = scale_and_crop_image(
                    image_io.read_png(os.path.join(rd, f'depth_{cam}', frames[i] + '.png')),
                    1.0, fh)
                frame_depths.append(decode_depth(d))
            images.append(np.stack(frame_imgs))
            depths.append(np.stack(frame_depths))
            hdmaps.append(self.get_hdmap(os.path.join(rd, 'hdmap', frames[i] + '.png')))

        seg, ped, gt_traj = [], [], []
        ego_x, ego_y = entry['x'][rf - 1], entry['y'][rf - 1]
        ego_theta = entry['theta'][rf - 1]
        for i in range(self.sequence_length):
            if i >= rf - 1:
                wp = transform_2d_points(
                    np.zeros((1, 3)), np.pi / 2 - entry['theta'][i],
                    -entry['x'][i], -entry['y'][i],
                    np.pi / 2 - ego_theta, -ego_x, -ego_y)
                gt_traj.append((wp * [1.0, -1.0, 1.0])[0])
            s, p = self.get_labels(os.path.join(rd, 'topdown', frames[i] + '.png'))
            seg.append(s)
            ped.append(p)

        # the hdmap covers the past frames on disk; the present repeats for
        # the future frames so the (S_total, H, W, E) contract holds
        while len(hdmaps) < self.sequence_length:
            hdmaps.append(hdmaps[-1])

        r = np.array([[np.cos(np.pi / 2 + ego_theta), -np.sin(np.pi / 2 + ego_theta)],
                      [np.sin(np.pi / 2 + ego_theta), np.cos(np.pi / 2 + ego_theta)]])
        local_command = r.T @ np.array([entry['x_command'] - ego_x,
                                        entry['y_command'] - ego_y])
        local_command = local_command * [1.0, -1.0]

        trajs = trajectory_sampler.sample_trajectories(
            entry['velocity'], entry['steer'], self.cfg.N_FUTURE_FRAMES,
            self.n_samples, self.SAMPLE_INTERVAL)

        h, w = seg[0].shape
        zeros2 = np.zeros((self.sequence_length, h, w, 2), np.float32)
        return {
            'image': np.stack(images),
            'depths': np.stack(depths).astype(np.float32),
            'intrinsics': np.tile(intrinsics, (rf, 1, 1, 1)),
            'extrinsics': np.tile(extrinsics, (rf, 1, 1, 1)),
            'segmentation': np.stack(seg),
            'pedestrian': np.stack(ped),
            'instance': np.zeros((self.sequence_length, h, w), np.int32),
            'centerness': np.zeros((self.sequence_length, h, w, 1), np.float32),
            'offset': zeros2.copy(),
            'flow': zeros2.copy(),
            'hdmap': np.stack(hdmaps),
            'future_egomotion': self.get_future_egomotion(
                entry['x'], entry['y'], entry['theta']),
            'gt_trajectory': np.stack(gt_traj).astype(np.float32),
            'command': np.int32(CARLA_CMD_TO_CODE.get(entry['command'], CMD_LANE)),
            'sample_trajectory': trajs.astype(np.float32),
            'target_point': local_command.astype(np.float32),
            'steer': np.float32(entry['steer']),
            'throttle': np.float32(entry['throttle']),
            'brake': np.float32(entry['brake']),
            'velocity': np.float32(entry['velocity']),
        }
