"""PIL-free stand-in datasets at real sizes, for the machine with the card
(chip_smoke.py) and for the CPU tests: nothing here imports PIL, cv2,
jax or stp3_tpu.

* ``FakeNuScenes`` and ``install()``: a copy of tests/fake_nuscenes.py's
  devkit stand-in (the tables, CAN bus, map and lidar projection the
  nuScenes dataset reads) at nuScenes' 6 cameras and 1600x900, whose
  images are copies of the committed camera fixture
  (tests/data/camera_1600x900.jpg, written by Pillow: see
  tests/data/make_camera_fixture.py), with ``n_agents`` extra seeded
  vehicles and pedestrians around the ego (some across the BEV grid's
  edge) and a seeded lidar point cloud in every camera.
* ``write_png``: a numpy + zlib PNG writer of 'L', 'P', 'LA', 'RGB' and
  'RGBA' images that uses every row filter type (row y takes filter
  y % 5).
* ``write_carla_route``: a CARLA route dump as tests/test_carla_data.py
  writes one (4 cameras of RGB and depth PNGs at 400x300, the 256x256
  topdown semantic PNG, the hdmap PNG, the measurements), with seeded
  content.
"""
from __future__ import annotations

import json
import os
import shutil
import struct
import sys
import types
import zlib
from typing import Dict, List

import numpy as np

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'data')
CAMERA_JPEG = os.path.join(DATA, 'camera_1600x900.jpg')
CAMERA_META = os.path.join(DATA, 'camera_1600x900.json')
NUSCENES_CAMS = ('CAM_FRONT_LEFT', 'CAM_FRONT', 'CAM_FRONT_RIGHT',
                 'CAM_BACK_LEFT', 'CAM_BACK', 'CAM_BACK_RIGHT')


def camera_meta() -> dict:
    """Shape and SHA-256 of Pillow's decode (and resize + crop) of the
    camera fixture, stored beside it."""
    with open(CAMERA_META) as f:
        return json.load(f)


# ------------------------------------------------------------------ PNG

_COLOUR = {'L': (0, 1), 'RGB': (2, 3), 'P': (3, 1), 'LA': (4, 2), 'RGBA': (6, 4)}


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack('>I', len(body)) + kind + body
            + struct.pack('>I', zlib.crc32(kind + body) & 0xFFFFFFFF))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def png_bytes(arr: np.ndarray, mode: str, palette=None) -> bytes:
    """An 8-bit non-interlaced PNG of ``arr`` ((H, W) for 'L' / 'P', else
    (H, W, C)); row y is filtered with type y % 5."""
    colour, ch = _COLOUR[mode]
    arr = np.ascontiguousarray(arr, np.uint8)
    h, w = arr.shape[:2]
    rows = arr.reshape(h, w * ch).astype(np.int64)
    out = bytearray()
    for y in range(h):
        x = rows[y]
        up = rows[y - 1] if y else np.zeros_like(x)
        left = np.concatenate([np.zeros(ch, np.int64), x[:-ch]])
        upleft = np.concatenate([np.zeros(ch, np.int64), up[:-ch]])
        f = y % 5
        pred = (0, left, up, (left + up) >> 1, _paeth(left, up, upleft))[f]
        out.append(f)
        out += ((x - pred) & 255).astype(np.uint8).tobytes()
    body = b'\x89PNG\r\n\x1a\n' + _chunk(b'IHDR', struct.pack('>IIBBBBB', w, h, 8, colour, 0,
                                                              0, 0))
    if mode == 'P':
        pal = np.zeros((256, 3), np.uint8) if palette is None else np.asarray(palette, np.uint8)
        body += _chunk(b'PLTE', pal.tobytes())
    return body + _chunk(b'IDAT', zlib.compress(bytes(out), 6)) + _chunk(b'IEND', b'')


def write_png(path: str, arr: np.ndarray, mode: str, palette=None) -> None:
    with open(path, 'wb') as f:
        f.write(png_bytes(arr, mode, palette))


# ------------------------------------------------------------ nuScenes


def _quat_about_z(yaw: float) -> List[float]:
    return [float(np.cos(yaw / 2)), 0.0, 0.0, float(np.sin(yaw / 2))]


def _qmul(a, b):
    w1, x1, y1, z1 = a
    w2, x2, y2, z2 = b
    return [w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2, w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2, w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2]


class FakeNuScenes:
    """Table database of one straight-line scene (fake_nuscenes.py's) at
    nuScenes' camera rig; ``image`` is the JPEG every camera frame copies."""

    def __init__(self, version: str, dataroot: str, verbose: bool = False,
                 n_samples: int = 12, cam_names=NUSCENES_CAMS, img_hw=(900, 1600),
                 image: str = CAMERA_JPEG, n_agents: int = 40):
        self.version = version
        self.dataroot = dataroot
        self._tables: Dict[str, Dict[str, dict]] = {
            t: {} for t in ['scene', 'log', 'sample', 'sample_data', 'ego_pose',
                            'calibrated_sensor', 'sample_annotation', 'instance']}
        self.scene: List[dict] = []
        self.sample: List[dict] = []
        self._build(n_samples, cam_names, img_hw, image, n_agents)

    def get(self, table: str, token: str) -> dict:
        return self._tables[table][token]

    def _add(self, table: str, token: str, rec: dict) -> dict:
        rec = dict(rec, token=token)
        self._tables[table][token] = rec
        return rec

    def _build(self, n_samples, cam_names, img_hw, image, n_agents):
        h, w = img_hw
        os.makedirs(os.path.join(self.dataroot, 'samples'), exist_ok=True)
        self._add('log', 'log-1', {'location': 'boston-seaport'})
        self.scene.append(self._add('scene', 'scene-1',
                                    {'name': 'scene-0001', 'log_token': 'log-1'}))
        fx = 0.8 * w
        intr = [[fx, 0.0, w / 2.0], [0.0, fx, h / 2.0], [0.0, 0.0, 1.0]]
        cam_rot_fwd = [0.5, -0.5, 0.5, -0.5]        # camera z forward -> ego x forward
        for i, cam in enumerate(cam_names):
            yaw = 2 * np.pi * i / len(cam_names)
            self._add('calibrated_sensor', f'cs-{cam}', {
                'translation': [1.5 * np.cos(yaw), 1.5 * np.sin(yaw), 1.6],
                'rotation': _qmul(_quat_about_z(yaw), cam_rot_fwd), 'camera_intrinsic': intr})
        self._add('calibrated_sensor', 'cs-LIDAR', {
            'translation': [0.9, 0.0, 1.8], 'rotation': _quat_about_z(-np.pi / 2),
            'camera_intrinsic': None})

        rng = np.random.RandomState(0)
        # the two boxes of fake_nuscenes.py, then n_agents more that move
        # at constant velocity, some across the grid's +-50 m edge
        # (category, size, x, y at t = 0, velocity, yaw), in the world frame
        agents = [('vehicle.car', [2.0, 4.5, 1.6], 5.0, 0.0, 4.0, 0.0, 0.0),
                  ('human.pedestrian.adult', [0.7, 0.7, 1.8], 6.0, 2.0, 4.0, 0.0, 0.0)]
        for _ in range(n_agents):
            ped = rng.rand() < 0.3
            agents.append((
                'human.pedestrian.adult' if ped else 'vehicle.car',
                [0.7, 0.7, 1.8] if ped else [rng.uniform(1.7, 2.6), rng.uniform(3.8, 12.0),
                                             1.6],
                rng.uniform(-55, 55), rng.uniform(-55, 55), rng.uniform(-2, 8),
                rng.uniform(-1, 1), rng.uniform(-np.pi, np.pi)))
        prev = None
        for t in range(n_samples):
            ts = 1_000_000_000 + t * 500_000
            x_ego = 2.0 * t
            ep = self._add('ego_pose', f'ep-{t}', {
                'translation': [x_ego, 0.0, 0.0], 'rotation': _quat_about_z(0.0),
                'timestamp': ts})
            data = {}
            for cam in cam_names:
                name = f'samples/{cam}_{t}.jpg'
                shutil.copyfile(image, os.path.join(self.dataroot, name))
                sd = self._add('sample_data', f'sd-{cam}-{t}', {
                    'ego_pose_token': ep['token'], 'calibrated_sensor_token': f'cs-{cam}',
                    'filename': name, 'sample_token': f'sample-{t}'})
                data[cam] = sd['token']
            data['LIDAR_TOP'] = self._add('sample_data', f'sd-LIDAR-{t}', {
                'ego_pose_token': ep['token'], 'calibrated_sensor_token': 'cs-LIDAR',
                'filename': '', 'sample_token': f'sample-{t}'})['token']
            anns = []
            for j, (cat, size, x0, y0, vx, vy, yaw) in enumerate(agents):
                ann = self._add('sample_annotation', f'ann-{j}-{t}', {
                    'translation': [x0 + 0.5 * t * vx, y0 + 0.5 * t * vy, 0.8],
                    'size': size, 'rotation': _quat_about_z(yaw),
                    'category_name': cat, 'instance_token': f'inst-{j}',
                    'visibility_token': '1' if j % 9 == 8 else '4'})
                anns.append(ann['token'])
            sample = self._add('sample', f'sample-{t}', {
                'scene_token': 'scene-1', 'timestamp': ts, 'data': data, 'anns': anns,
                'prev': prev})
            self.sample.append(sample)
            prev = sample['token']


class FakeCanBus:
    can_blacklist: List[int] = []

    def __init__(self, dataroot: str):
        self.dataroot = dataroot

    def get_messages(self, scene_name: str, channel: str):
        times = [1_000_000_000 + t * 500_000 for t in range(32)]
        if channel == 'pose':
            return [{'utime': ts, 'vel': [4.0, 0.0, 0.0]} for ts in times]
        if channel == 'steeranglefeedback':
            return [{'utime': ts, 'value': 0.05} for ts in times]
        raise KeyError(channel)


class FakeMap:
    def __init__(self, dataroot: str, map_name: str):
        self.map_name = map_name

    def get_map_mask(self, box_coords, rot_deg, elements, canvas_size):
        h, w = canvas_size
        masks = np.zeros((len(elements), h, w), np.uint8)
        masks[:, h // 4: 3 * h // 4] = 1                # a straight road band
        return masks


class FakeExplorer:
    """Seeded lidar returns in the camera: 4,000 points over the image,
    2-60 m away."""

    def __init__(self, nusc):
        self.nusc = nusc

    def map_pointcloud_to_image(self, lidar_token, cam_token):
        k = self.nusc.get('calibrated_sensor', self.nusc.get('sample_data', cam_token)[
            'calibrated_sensor_token'])['camera_intrinsic']
        w, h = 2 * k[0][2], 2 * k[1][2]
        rng = np.random.RandomState(zlib.crc32(cam_token.encode()))
        n = 4000
        pts = np.stack([rng.uniform(0, w - 1, n), rng.uniform(h * 0.4, h - 1, n)])
        return np.vstack([pts, np.ones((1, n))]), rng.uniform(2.0, 60.0, n), None


def create_splits_scenes():
    return {'mini_train': ['scene-0001'], 'mini_val': ['scene-0001'],
            'train': ['scene-0001'], 'val': ['scene-0001']}


def install(monkeypatch=None, **table_options):
    """Inject the stand-in 'nuscenes' modules into sys.modules (through
    ``monkeypatch`` when given, so that a test undoes it); ``table_options``
    go to every ``FakeNuScenes`` the dataset builds (n_samples, cam_names,
    img_hw, image, n_agents)."""
    root = types.ModuleType('nuscenes')
    m_nusc = types.ModuleType('nuscenes.nuscenes')
    m_nusc.NuScenes = (lambda *a, **k: FakeNuScenes(*a, **{**table_options, **k}))
    m_nusc.NuScenesExplorer = FakeExplorer
    m_can_pkg = types.ModuleType('nuscenes.can_bus')
    m_can = types.ModuleType('nuscenes.can_bus.can_bus_api')
    m_can.NuScenesCanBus = FakeCanBus
    m_map_pkg = types.ModuleType('nuscenes.map_expansion')
    m_map = types.ModuleType('nuscenes.map_expansion.map_api')
    m_map.NuScenesMap = FakeMap
    m_utils_pkg = types.ModuleType('nuscenes.utils')
    m_splits = types.ModuleType('nuscenes.utils.splits')
    m_splits.create_splits_scenes = create_splits_scenes
    mods = {'nuscenes': root, 'nuscenes.nuscenes': m_nusc, 'nuscenes.can_bus': m_can_pkg,
            'nuscenes.can_bus.can_bus_api': m_can, 'nuscenes.map_expansion': m_map_pkg,
            'nuscenes.map_expansion.map_api': m_map, 'nuscenes.utils': m_utils_pkg,
            'nuscenes.utils.splits': m_splits}
    root.nuscenes = m_nusc
    for name, mod in mods.items():
        if monkeypatch is not None:
            monkeypatch.setitem(sys.modules, name, mod)
        else:
            sys.modules[name] = mod
    return mods


# --------------------------------------------------------------- CARLA


def write_carla_route(root: str, n_frames: int = 8, town: str = 'Town05_short',
                      route: str = 'route_00', seed: int = 0) -> str:
    """One route of a CARLA dump under ``root``/``town`` (the layout of
    tests/test_carla_data.py's writer, without PIL): RGB and depth PNGs of
    4 cameras at 400x300, the topdown semantic PNG ('L', 256x256; vehicles
    class 10, pedestrians 4), the hdmap PNG ('RGB', 220x220; drivable and
    lane colours) and the measurements, driving +1 m a frame."""
    rd = os.path.join(root, town, route)
    for sub in ['rgb_front', 'rgb_left', 'rgb_right', 'rgb_rear', 'depth_front', 'depth_left',
                'depth_right', 'depth_rear', 'topdown', 'hdmap', 'measurements']:
        os.makedirs(os.path.join(rd, sub), exist_ok=True)
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:300, 0:400]
    for i in range(1, n_frames + 1):
        name = f'{i:04d}'
        for k, cam in enumerate(['front', 'left', 'right', 'rear']):
            rgb = np.stack([(xx + 7 * i + 40 * k) % 256, (yy * 2 + 3 * i) % 256,
                            (xx + yy) % 256], -1).astype(np.uint8)
            rgb = np.clip(rgb + rng.randint(-8, 9, rgb.shape), 0, 255).astype(np.uint8)
            write_png(os.path.join(rd, f'rgb_{cam}', name + '.png'), rgb, 'RGB')
            metres = 2.0 + 60.0 * (yy / 300.0) + rng.uniform(0, 0.5, yy.shape)
            code = np.round(metres / 1000.0 * (256 ** 3 - 1)).astype(np.int64)
            depth = np.stack([code // 65536, (code // 256) % 256, code % 256], -1)
            write_png(os.path.join(rd, f'depth_{cam}', name + '.png'), depth.astype(np.uint8),
                      'RGB')
        td = np.zeros((256, 256), np.uint8)
        td[40 + i:60 + i, 100:120] = 10
        td[150:160, 60 + i:70 + i] = 4
        td[120:135, 125:131] = 10                       # the ego blob, zeroed by the labels
        write_png(os.path.join(rd, 'topdown', name + '.png'), td, 'L')
        hd = np.zeros((220, 220, 3), np.uint8)
        hd[:, 100:120] = [54, 52, 46]
        hd[:, 109:111] = [255, 0, 255]
        write_png(os.path.join(rd, 'hdmap', name + '.png'), hd, 'RGB')
        meas = {'x': float(i), 'y': 0.0, 'theta': 0.0, 'x_command': 50.0, 'y_command': 0.0,
                'steer': 0.1, 'throttle': 0.5, 'brake': False, 'command': 3, 'speed': 4.0}
        with open(os.path.join(rd, 'measurements', name + '.json'), 'w') as f:
            json.dump(meas, f)
    return rd


class FaultyDataset:
    """``n`` tiny samples; fetching ``fault_at`` kills the process that
    fetches it (``'exit'``) or blocks it for ``seconds`` (``'stall'``):
    a loader worker that dies, or hangs."""

    def __init__(self, n: int, fault_at: int, fault: str, seconds: float = 0.0):
        self.n, self.fault_at, self.fault, self.seconds = n, fault_at, fault, seconds

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        if i == self.fault_at:
            if self.fault == 'exit':
                os._exit(3)
            import time
            time.sleep(self.seconds)
        return {'x': np.full((2,), i, np.int64)}
