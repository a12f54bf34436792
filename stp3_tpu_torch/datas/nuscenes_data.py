"""The nuScenes dataset: the port's counterpart of
stp3_tpu/datas/nuscenes_data.py (reference stp3/datas/NuscenesData.py),
sample for sample the same arrays.

Scene split and CAN-bus blacklist, sliding same-scene windows, each
camera's image resized (Pillow-exact bilinear) and cropped with its
intrinsics updated, camera -> lidar-flat-egopose extrinsics, BEV labels
rasterised with persistent instance ids (cv2-exact polygon fill), the
6-DoF future egomotion, CAN-bus-seeded trajectory sampling with the
Singapore steering flip, the HD map, the GT trajectory and command, and
under ``LIFT.GT_DEPTH`` the per-pixel depth label (cv2-exact linear
resize). Images stay uint8 on the wire; the model normalises them.

Images come through the port's own decoder and resampler
(``utils/image_io.py``, host C), the polygons and the depth resize
through ``utils/resample.py``: no PIL, no OpenCV. The nuscenes-devkit is
needed, imported where the JAX package imports it.
"""
from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np

from stp3_tpu_torch.ops.geometry import calculate_birds_eye_view_parameters
from stp3_tpu_torch.utils import image_io
from stp3_tpu_torch.utils import sampler as trajectory_sampler
from stp3_tpu_torch.utils.instance import convert_instance_mask_to_center_and_offset_label
from stp3_tpu_torch.utils.quaternion import (mat2pose_vec_np, quat_inverse,
                                             quat_to_rotation_matrix, quat_yaw, transform_matrix,
                                             yaw_from_matrix, yaw_quat)
from stp3_tpu_torch.utils.resample import fill_poly, resize_linear_float

CMD_CODE = {'LEFT': 0, 'FORWARD': 1, 'RIGHT': 2}


def make_nusc(cfg):
    from nuscenes.nuscenes import NuScenes
    return NuScenes(version=f'v1.0-{cfg.DATASET.VERSION}',
                    dataroot=cfg.DATASET.DATAROOT, verbose=False)


def locate_message(utimes, utime):
    """Index of the CAN-bus message nearest in time to ``utime``."""
    i = np.searchsorted(utimes, utime)
    if i == len(utimes) or (i > 0 and utime - utimes[i - 1] < utimes[i] - utime):
        i -= 1
    return i


def _box_bottom_corners(translation, size, rotation_q) -> np.ndarray:
    """Bottom-face corners (3, 4) of a nuScenes box in the devkit's order
    (Box.corners()[:, [2, 3, 7, 6]])."""
    w, l, h = size
    x = l / 2.0 * np.array([1, 1, 1, 1, -1, -1, -1, -1])
    y = w / 2.0 * np.array([1, -1, -1, 1, 1, -1, -1, 1])
    z = h / 2.0 * np.array([1, 1, -1, -1, 1, 1, -1, -1])
    corners = quat_to_rotation_matrix(rotation_q) @ np.vstack([x, y, z])
    corners = corners + np.asarray(translation, np.float64)[:, None]
    return corners[:, [2, 3, 7, 6]]


def crop(arr: np.ndarray, box) -> np.ndarray:
    """Pillow's ``Image.crop(box)`` of an (H, W, ...) array: box (left,
    top, right, bottom); what falls outside the image is zero."""
    left, top, right, bottom = (int(v) for v in box)
    h, w = arr.shape[:2]
    out = np.zeros((bottom - top, right - left) + arr.shape[2:], arr.dtype)
    y0, y1, x0, x1 = max(top, 0), min(bottom, h), max(left, 0), min(right, w)
    if y0 < y1 and x0 < x1:
        out[y0 - top:y1 - top, x0 - left:x1 - left] = arr[y0:y1, x0:x1]
    return out


def resize_and_crop_image(img: np.ndarray, resize_dims, crop_box) -> np.ndarray:
    """Pillow's bilinear resize to ``resize_dims`` (w, h), then its crop
    (reference geometry.py:9-13)."""
    return crop(image_io.resample(img, resize_dims, 'bilinear'), crop_box)


class FuturePredictionDataset:
    SAMPLE_INTERVAL = 0.5  # seconds

    def __init__(self, nusc, is_train: int, cfg):
        from nuscenes.can_bus.can_bus_api import NuScenesCanBus
        from nuscenes.nuscenes import NuScenesExplorer

        image_io.load()            # built here, before a loader starts its workers
        self.nusc = nusc
        self.dataroot = nusc.dataroot
        self.nusc_exp = NuScenesExplorer(nusc)
        self.nusc_can = NuScenesCanBus(dataroot=self.dataroot)
        self.is_train = is_train
        self.cfg = cfg
        self.mode = {0: 'train', 1: 'val', 2: 'test'}[is_train]

        self.sequence_length = cfg.TIME_RECEPTIVE_FIELD + cfg.N_FUTURE_FRAMES
        self.receptive_field = cfg.TIME_RECEPTIVE_FIELD

        self.scenes = self._get_scenes()
        self.ixes = self._prepro()
        self.indices = self._get_indices()
        self.augmentation_parameters = self._resize_crop_parameters()

        res, start, dim = calculate_birds_eye_view_parameters(
            cfg.LIFT.X_BOUND, cfg.LIFT.Y_BOUND, cfg.LIFT.Z_BOUND)
        self.bev_resolution, self.bev_start_position, self.bev_dimension = (
            np.asarray(res), np.asarray(start), np.asarray(dim))
        self.spatial_extent = (cfg.LIFT.X_BOUND[1], cfg.LIFT.Y_BOUND[1])
        self.n_samples = cfg.PLANNING.SAMPLE_NUM

        from nuscenes.map_expansion.map_api import NuScenesMap
        map_folder = cfg.DATASET.MAP_FOLDER
        self.nusc_maps = {
            name: NuScenesMap(dataroot=map_folder, map_name=name)
            for name in ['singapore-hollandvillage', 'singapore-queenstown',
                         'boston-seaport', 'singapore-onenorth']}
        self.scene2map = {}
        for sce in nusc.scene:
            log = nusc.get('log', sce['log_token'])
            self.scene2map[sce['name']] = log['location']

    # ------------------------------------------------------------- indexing
    def _get_scenes(self):
        from nuscenes.utils.splits import create_splits_scenes
        split = {'v1.0-trainval': {0: 'train', 1: 'val', 2: 'test'},
                 'v1.0-mini': {0: 'mini_train', 1: 'mini_val'}}[
            self.nusc.version][self.is_train]
        # scene-0419 has no vehicle monitor data (reference :102)
        blacklist = [419] + self.nusc_can.can_blacklist
        blacklist = ['scene-' + str(n).zfill(4) for n in blacklist]
        scenes = create_splits_scenes()[split][:]
        return [s for s in scenes if s not in blacklist]

    def _prepro(self):
        samples = [s for s in self.nusc.sample
                   if self.nusc.get('scene', s['scene_token'])['name'] in self.scenes]
        samples.sort(key=lambda x: (x['scene_token'], x['timestamp']))
        return samples

    def _get_indices(self):
        indices = []
        for index in range(len(self.ixes)):
            current, prev, ok = [], None, True
            for t in range(self.sequence_length):
                it = index + t
                if it >= len(self.ixes):
                    ok = False
                    break
                rec = self.ixes[it]
                if prev is not None and rec['scene_token'] != prev['scene_token']:
                    ok = False
                    break
                current.append(it)
                prev = rec
            if ok:
                indices.append(current)
        return np.asarray(indices)

    def _resize_crop_parameters(self):
        oh, ow = self.cfg.IMAGE.ORIGINAL_HEIGHT, self.cfg.IMAGE.ORIGINAL_WIDTH
        fh, fw = self.cfg.IMAGE.FINAL_DIM
        scale = self.cfg.IMAGE.RESIZE_SCALE
        resize_dims = (int(ow * scale), int(oh * scale))
        rw, rh = resize_dims
        crop_h = self.cfg.IMAGE.TOP_CROP
        crop_w = int(max(0, (rw - fw) / 2))
        crop_box = (crop_w, crop_h, crop_w + fw, crop_h + fh)
        return {'scale_width': scale, 'scale_height': scale,
                'resize_dims': resize_dims, 'crop': crop_box}

    def __len__(self):
        return len(self.indices)

    # ---------------------------------------------------------- input data
    def _lidar_to_world(self, rec):
        lidar_sample = self.nusc.get('sample_data', rec['data']['LIDAR_TOP'])
        lidar_pose = self.nusc.get('ego_pose', lidar_sample['ego_pose_token'])
        yaw = quat_yaw(lidar_pose['rotation'])
        return transform_matrix(lidar_pose['translation'], yaw_quat(yaw))

    def get_input_data(self, rec):
        """-> images (N, H, W, 3) uint8, intrinsics (N, 3, 3), extrinsics
        (N, 4, 4) camera -> lidar-flat-egopose, depths (N, H, W) or None."""
        ap = self.augmentation_parameters
        lidar_to_world = self._lidar_to_world(rec)

        images, intrinsics, extrinsics, depths = [], [], [], []
        for cam in self.cfg.IMAGE.NAMES:
            camera_sample = self.nusc.get('sample_data', rec['data'][cam])
            car_egopose = self.nusc.get('ego_pose', camera_sample['ego_pose_token'])
            world_to_car = transform_matrix(car_egopose['translation'],
                                            car_egopose['rotation'], inverse=True)
            sensor_sample = self.nusc.get('calibrated_sensor',
                                          camera_sample['calibrated_sensor_token'])
            ego_to_sensor = transform_matrix(sensor_sample['translation'],
                                             sensor_sample['rotation'], inverse=True)
            lidar_to_sensor = ego_to_sensor @ world_to_car @ lidar_to_world
            sensor_to_lidar = np.linalg.inv(lidar_to_sensor).astype(np.float32)

            img = image_io.read_jpeg(os.path.join(self.dataroot, camera_sample['filename']))
            arr = resize_and_crop_image(img, ap['resize_dims'], ap['crop'])

            k = np.asarray(sensor_sample['camera_intrinsic'], np.float32).copy()
            k[0, 0] *= ap['scale_width']
            k[0, 2] = k[0, 2] * ap['scale_width'] - ap['crop'][0]
            k[1, 1] *= ap['scale_height']
            k[1, 2] = k[1, 2] * ap['scale_height'] - ap['crop'][1]

            if self.cfg.LIFT.GT_DEPTH:
                depths.append(self._load_depth(camera_sample, cam))

            images.append(arr)
            intrinsics.append(k)
            extrinsics.append(sensor_to_lidar)
        return (np.stack(images), np.stack(intrinsics), np.stack(extrinsics),
                np.stack(depths) if depths else None)

    def _load_depth(self, camera_sample, cam):
        """Precomputed per-pixel depth .npy (reference :255-267), else the
        lidar projected into the camera; resized and cropped as the image,
        rounded to whole metres."""
        ap = self.augmentation_parameters
        base = os.path.join(self.dataroot, 'depths', cam, 'npy')
        fname = os.path.basename(camera_sample['filename']).split('.')[0] + '.npy'
        path = os.path.join(base, fname)
        if os.path.exists(path):
            depth = np.load(path)
        else:
            depth = self._depth_from_lidar(camera_sample)
        depth = resize_linear_float(depth, ap['resize_dims'])
        c = ap['crop']
        depth = depth[c[1]:c[3], c[0]:c[2]]
        return np.round(depth).astype(np.float32)

    def _depth_from_lidar(self, cam_sample):
        rec = self.nusc.get('sample', cam_sample['sample_token'])
        points, coloring, _ = self.nusc_exp.map_pointcloud_to_image(
            rec['data']['LIDAR_TOP'], cam_sample['token'])
        out = np.zeros((self.cfg.IMAGE.ORIGINAL_HEIGHT,
                        self.cfg.IMAGE.ORIGINAL_WIDTH), np.float32)
        pts = points.astype(np.int64)
        out[pts[1], pts[0]] = coloring
        return out

    # -------------------------------------------------------------- labels
    def _top_lidar_pose(self, rec):
        egopose = self.nusc.get(
            'ego_pose', self.nusc.get('sample_data', rec['data']['LIDAR_TOP'])['ego_pose_token'])
        trans = -np.array(egopose['translation'])
        rot_inv = quat_inverse(yaw_quat(quat_yaw(egopose['rotation'])))
        return trans, rot_inv

    def _poly_region(self, annotation, ego_translation, ego_rotation_inv):
        corners = _box_bottom_corners(annotation['translation'],
                                      annotation['size'], annotation['rotation'])
        corners = corners + ego_translation[:, None]
        corners = quat_to_rotation_matrix(ego_rotation_inv) @ corners
        pts = corners[:2].T
        pts = np.round((pts - self.bev_start_position[:2]
                        + self.bev_resolution[:2] / 2.0) / self.bev_resolution[:2]).astype(np.int32)
        pts[:, [1, 0]] = pts[:, [0, 1]]
        return pts

    def get_label(self, rec, instance_map: Dict[str, int], in_pred: bool):
        """-> segmentation (H, W), instance (H, W), pedestrian (H, W),
        the instance map."""
        translation, rotation_inv = self._top_lidar_pose(rec)
        h, w = int(self.bev_dimension[0]), int(self.bev_dimension[1])
        segmentation = np.zeros((h, w), np.float64)
        pedestrian = np.zeros((h, w), np.float64)
        instance = np.zeros((h, w), np.float64)

        for token in rec['anns']:
            ann = self.nusc.get('sample_annotation', token)
            if (self.cfg.DATASET.FILTER_INVISIBLE_VEHICLES
                    and int(ann['visibility_token']) == 1 and not in_pred):
                continue
            # future frames only keep instances already seen in the past
            if in_pred and ann['instance_token'] not in instance_map:
                continue
            if 'vehicle' in ann['category_name']:
                if ann['instance_token'] not in instance_map:
                    instance_map[ann['instance_token']] = len(instance_map) + 1
                poly = self._poly_region(ann, translation, rotation_inv)
                fill_poly(instance, poly, instance_map[ann['instance_token']])
                fill_poly(segmentation, poly, 1.0)
            elif 'human' in ann['category_name']:
                if ann['instance_token'] not in instance_map:
                    instance_map[ann['instance_token']] = len(instance_map) + 1
                poly = self._poly_region(ann, translation, rotation_inv)
                fill_poly(pedestrian, poly, 1.0)
        return (segmentation.astype(np.int32), instance.astype(np.int32),
                pedestrian.astype(np.int32), instance_map)

    def get_future_egomotion(self, rec, index) -> np.ndarray:
        future_egomotion = np.eye(4, dtype=np.float32)
        if index < len(self.ixes) - 1:
            rec_t1 = self.ixes[index + 1]
            if rec['scene_token'] == rec_t1['scene_token']:
                def pose_mat(r):
                    ep = self.nusc.get(
                        'ego_pose',
                        self.nusc.get('sample_data', r['data']['LIDAR_TOP'])['ego_pose_token'])
                    return transform_matrix(ep['translation'], ep['rotation'])
                future_egomotion = (np.linalg.inv(pose_mat(rec_t1)) @ pose_mat(rec)).astype(
                    np.float32)
                future_egomotion[3, :3] = 0.0
                future_egomotion[3, 3] = 1.0
        return mat2pose_vec_np(future_egomotion)

    # ------------------------------------------------------------ planning
    def get_trajectory_sampling(self, rec) -> np.ndarray:
        ref_scene = self.nusc.get('scene', rec['scene_token'])
        pose_msgs = self.nusc_can.get_messages(ref_scene['name'], 'pose')
        pose_uts = [m['utime'] for m in pose_msgs]
        steer_msgs = self.nusc_can.get_messages(ref_scene['name'], 'steeranglefeedback')
        steer_uts = [m['utime'] for m in steer_msgs]
        ref_utime = rec['timestamp']
        pose_data = pose_msgs[locate_message(pose_uts, ref_utime)]
        steer_data = steer_msgs[locate_message(steer_uts, ref_utime)]
        location = self.scene2map[ref_scene['name']]
        flip = location.startswith('singapore')  # left-hand traffic
        return trajectory_sampler.sample_trajectories(
            pose_data['vel'][0], steer_data['value'], self.cfg.N_FUTURE_FRAMES, self.n_samples,
            self.SAMPLE_INTERVAL, flip_steering=flip).astype(np.float32)

    def get_gt_trajectory(self, rec, ref_index) -> Tuple[np.ndarray, int]:
        n_output = self.cfg.N_FUTURE_FRAMES
        gt = np.zeros((n_output + 1, 3), np.float64)
        egopose_cur_inv = self._global_pose(rec, inverse=True)
        for i in range(n_output + 1):
            index = ref_index + i
            if index < len(self.ixes):
                future = egopose_cur_inv @ self._global_pose(self.ixes[index])
                gt[i, :2] = future[:2, 3]
                gt[i, 2] = yaw_from_matrix(future)
        if gt[-1, 0] >= 2:
            command = CMD_CODE['RIGHT']
        elif gt[-1, 0] <= -2:
            command = CMD_CODE['LEFT']
        else:
            command = CMD_CODE['FORWARD']
        return gt.astype(np.float32), command

    def _global_pose(self, rec, inverse: bool = False) -> np.ndarray:
        sd = self.nusc.get('sample_data', rec['data']['LIDAR_TOP'])
        ep = self.nusc.get('ego_pose', sd['ego_pose_token'])
        cs = self.nusc.get('calibrated_sensor', sd['calibrated_sensor_token'])
        if not inverse:
            return (transform_matrix(ep['translation'], ep['rotation'])
                    @ transform_matrix(cs['translation'], cs['rotation']))
        return (transform_matrix(cs['translation'], cs['rotation'], inverse=True)
                @ transform_matrix(ep['translation'], ep['rotation'], inverse=True))

    # -------------------------------------------------------------- hd map
    def voxelize_hd_map(self, rec) -> np.ndarray:
        """-> (H, W, E) binary masks in the ego frame (reference :438-468)."""
        egopose = self.nusc.get(
            'ego_pose', self.nusc.get('sample_data', rec['data']['LIDAR_TOP'])['ego_pose_token'])
        map_name = self.scene2map[self.nusc.get('scene', rec['scene_token'])['name']]
        rotm = quat_to_rotation_matrix(egopose['rotation'])
        rot = np.arctan2(rotm[1, 0], rotm[0, 0])
        stretch = [self.cfg.LIFT.X_BOUND[1], self.cfg.LIFT.Y_BOUND[1]]
        box_coords = (egopose['translation'][0], egopose['translation'][1],
                      stretch[0] * 2, stretch[1] * 2)
        canvas_size = (
            int(self.cfg.LIFT.X_BOUND[1] * 2 / self.cfg.LIFT.X_BOUND[2]),
            int(self.cfg.LIFT.Y_BOUND[1] * 2 / self.cfg.LIFT.Y_BOUND[2]))
        elements = self.cfg.SEMANTIC_SEG.HDMAP.ELEMENTS
        masks = self.nusc_maps[map_name].get_map_mask(
            box_coords, rot * 180 / np.pi, elements, canvas_size=canvas_size)
        # swap (y, x): the reference transposes the last two dims (:466)
        masks = np.transpose(np.asarray(masks), (0, 2, 1))
        return np.moveaxis(masks, 0, -1).astype(np.int32)       # (H, W, E)

    # ------------------------------------------------------------ __getitem__
    def __getitem__(self, index) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        data: Dict[str, list] = {k: [] for k in [
            'image', 'intrinsics', 'extrinsics', 'depths', 'segmentation',
            'instance', 'pedestrian', 'future_egomotion', 'hdmap']}
        instance_map: Dict[str, int] = {}
        out: Dict[str, np.ndarray] = {}

        for i, index_t in enumerate(self.indices[index]):
            in_pred = i >= self.receptive_field
            rec = self.ixes[index_t]
            if not in_pred:
                images, intrinsics, extrinsics, depths = self.get_input_data(rec)
                data['image'].append(images)
                data['intrinsics'].append(intrinsics)
                data['extrinsics'].append(extrinsics)
                if depths is not None:
                    data['depths'].append(depths)
            seg, inst, ped, instance_map = self.get_label(rec, instance_map, in_pred)
            data['segmentation'].append(seg)
            data['instance'].append(inst)
            data['pedestrian'].append(ped)
            data['future_egomotion'].append(self.get_future_egomotion(rec, index_t))
            data['hdmap'].append(self.voxelize_hd_map(rec))

            if i == self.receptive_field - 1:
                gt, command = self.get_gt_trajectory(rec, index_t)
                out['gt_trajectory'] = gt
                out['command'] = np.int32(command)
                out['sample_trajectory'] = self.get_trajectory_sampling(rec)

        for key in ['image', 'intrinsics', 'extrinsics', 'segmentation',
                    'instance', 'pedestrian', 'future_egomotion', 'hdmap']:
            out[key] = np.stack(data[key])
        if cfg.LIFT.GT_DEPTH:
            out['depths'] = np.stack(data['depths'])
        out['target_point'] = np.zeros(2, np.float32)

        centerness, offset, flow = convert_instance_mask_to_center_and_offset_label(
            out['instance'], out['future_egomotion'],
            num_instances=len(instance_map),
            ignore_index=cfg.DATASET.IGNORE_INDEX, subtract_egomotion=True,
            spatial_extent=self.spatial_extent)
        out['centerness'] = centerness.astype(np.float32)
        out['offset'] = offset.astype(np.float32)
        out['flow'] = flow.astype(np.float32)
        return out
