"""The port's CARLA dataset (stp3_tpu_torch/datas/carla_data.py) against
the JAX package's, sample for sample, on the CPU:

  * on a route written as tests/test_carla_data.py writes one (Pillow's
    PNG writer; its writer copied here, the test module not imported) at
    the test config's widths, every sample;
  * on tests/torch_fake_datasets.py's PIL-free route at the CARLA Planning
    stage (4 cameras at 400x300 -> 256, rf 3, 4 future frames, 2,400
    candidates, the topdown labels at scale 1.1, the hdmap PNGs), every
    sample, and the preload cache read back;
  * ``scale_and_crop_image`` at scales other than 1.0 against the JAX
    package's Pillow path ('L', 'RGB', 'RGBA' bicubic, 'P' nearest) and
    ``scale_and_crop_image_nearest`` at the labels' 1.1;
  * ``prepare_dataloaders`` on 'carla', and the port trainer's labels of
    its batch (the train step at CARLA's 200x200 grid takes half a minute
    on the CPU; chip_smoke.py's [carla_data] runs it on the card).

Tolerances: images, labels, hdmap and command exactly; every float field
(depths in metres, egomotion, trajectories, target point) at rtol 1e-6.
Both sides draw the candidate trajectories from numpy's global generator,
seeded alike before each sample.
"""
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

import torch_fixtures
import torch_fake_datasets
from helpers import make_test_cfg
from stp3_tpu.config import get_cfg as jax_get_cfg
from stp3_tpu.datas import carla_data as jcd
from stp3_tpu_torch import config as tconfig
from stp3_tpu_torch.datas import carla_data as tcd

torch.set_num_threads(2)

EXACT = {'image', 'segmentation', 'pedestrian', 'instance', 'hdmap', 'command'}


def _write_pil_route(root, n_frames=8):
    """tests/test_carla_data.py's fake route writer (Pillow PNGs)."""
    rd = os.path.join(root, 'Town05_short', 'route_00')
    for sub in ['rgb_front', 'rgb_left', 'rgb_right', 'rgb_rear',
                'depth_front', 'depth_left', 'depth_right', 'depth_rear',
                'topdown', 'hdmap', 'measurements']:
        os.makedirs(os.path.join(rd, sub), exist_ok=True)
    rng = np.random.RandomState(0)
    for i in range(1, n_frames + 1):
        name = f'{i:04d}'
        rgb = rng.randint(0, 255, (300, 400, 3), np.uint8)
        for cam in ['front', 'left', 'right', 'rear']:
            Image.fromarray(rgb).save(os.path.join(rd, f'rgb_{cam}', name + '.png'))
            Image.fromarray(np.zeros((300, 400, 3), np.uint8)).save(
                os.path.join(rd, f'depth_{cam}', name + '.png'))
        td = np.zeros((256, 256), np.uint8)
        td[40:60, 100:120] = 10
        td[150:160, 60:70] = 4
        Image.fromarray(td).save(os.path.join(rd, 'topdown', name + '.png'))
        hd = np.zeros((220, 220, 3), np.uint8)
        hd[:, 100:120] = [54, 52, 46]
        hd[:, 109:111] = [255, 0, 255]
        Image.fromarray(hd).save(os.path.join(rd, 'hdmap', name + '.png'))
        meas = {'x': float(i), 'y': 0.0, 'theta': 0.0, 'x_command': 50.0,
                'y_command': 0.0, 'steer': 0.1, 'throttle': 0.5,
                'brake': False, 'command': 3, 'speed': 4.0}
        with open(os.path.join(rd, 'measurements', name + '.json'), 'w') as f:
            json.dump(meas, f)
    return rd


def _test_cfg():
    cfg = make_test_cfg()
    cfg.IMAGE.FINAL_DIM = (256, 256)
    cfg.TIME_RECEPTIVE_FIELD = 2
    cfg.N_FUTURE_FRAMES = 2
    cfg.PLANNING.SAMPLE_NUM = 12
    return cfg


def _port_cfg(jcfg):
    return tconfig.get_cfg(cfg_dict=jcfg.convert_to_dict())


def _compare_all(jds, tds):
    assert len(tds) == len(jds) > 0
    for i in range(len(jds)):
        np.random.seed(i)
        want = jds[i]
        np.random.seed(i)
        got = tds[i]
        assert set(got) == set(want)
        for key, w in want.items():
            g, w = np.asarray(got[key]), np.asarray(w)
            assert g.dtype == w.dtype and g.shape == w.shape, (i, key, g.shape, w.shape)
            if key in EXACT:
                np.testing.assert_array_equal(g, w, err_msg=f'{i} {key}')
            else:
                np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6, err_msg=f'{i} {key}')


def test_getitem_matches_jax_on_the_pil_route(tmp_path):
    _write_pil_route(str(tmp_path))
    jcfg = _test_cfg()
    jds = jcd.CarlaDataset(str(tmp_path), False, jcfg)
    tds = tcd.CarlaDataset(str(tmp_path), False, _port_cfg(jcfg))
    _compare_all(jds, tds)


def test_getitem_matches_jax_at_the_planning_stage_on_the_stand_in(tmp_path):
    torch_fake_datasets.write_carla_route(str(tmp_path), n_frames=9)
    tcfg = torch_fixtures.carla_planning_cfg()
    jcfg = jax_get_cfg(cfg_dict=tcfg.convert_to_dict())
    tds = tcd.CarlaDataset(str(tmp_path), False, tcfg)       # scans and writes the cache
    jds = jcd.CarlaDataset(str(tmp_path), False, jcfg)       # reads it
    assert [s['frames'] for s in tds.seqs] == [s['frames'] for s in jds.seqs]
    _compare_all(jds, tds)
    item = tds[0]
    assert item['image'].shape == (3, 4, 256, 256, 3)
    assert item['segmentation'].shape == (7, 200, 200) and item['segmentation'].any()
    assert item['pedestrian'].any() and item['hdmap'][..., 1].any()
    assert item['sample_trajectory'].shape == (2400, 5, 3)
    assert 2.0 <= item['depths'].min() and item['depths'].max() <= 63.0


@pytest.mark.parametrize('mode', ['L', 'RGB', 'RGBA', 'P'])
@pytest.mark.parametrize('scale', [0.9, 1.1, 1.5])
def test_scale_and_crop_image_matches_pillow(mode, scale):
    rng = np.random.RandomState(4)
    shape = {'L': (300, 400), 'P': (300, 400), 'RGB': (300, 400, 3), 'RGBA': (300, 400, 4)}[mode]
    arr = rng.randint(0, 256, shape, np.uint8)
    if mode == 'RGBA':
        arr[..., 3] = rng.choice([0, 255, 90], shape[:2])
    want = jcd.scale_and_crop_image(Image.fromarray(arr, mode), scale, 200)
    np.testing.assert_array_equal(tcd.scale_and_crop_image(arr, scale, 200, mode), want)
    if mode in ('L', 'P'):
        want = jcd.scale_and_crop_image_nearest(Image.fromarray(arr, mode), scale, 200)
        np.testing.assert_array_equal(tcd.scale_and_crop_image_nearest(arr, scale, 200), want)


def test_prepare_dataloaders_and_the_trainers_labels(tmp_path):
    from stp3_tpu_torch.datas.dataloaders import prepare_dataloaders
    from stp3_tpu_torch.training.trainer import Trainer, batch_to_device
    torch_fake_datasets.write_carla_route(str(tmp_path))
    cfg = _port_cfg(_test_cfg())
    cfg.DATASET.NAME = 'carla'
    cfg.DATASET.DATAROOT = str(tmp_path)
    cfg.IMAGE.NAMES = ['front', 'left', 'right', 'rear']
    cfg.IMAGE.FINAL_DIM = (64, 64)
    cfg.LIFT.X_BOUND = cfg.LIFT.Y_BOUND = [-20.0, 20.0, 0.2]
    trainloader, valloader, traindata, valdata = prepare_dataloaders(cfg, return_dataset=True)
    assert len(traindata) == 0 and len(valdata) == 8 - 4     # only Town05 is written
    batch = next(iter(valloader))
    assert batch['image'].shape == (2, 2, 4, 64, 64, 3) and batch['image'].dtype == np.uint8
    batch.pop('valid')
    labels = Trainer(cfg, device='cpu').prepare_future_labels(batch_to_device(batch, 'cpu'))
    assert labels['segmentation'].shape == (2, 4, 200, 200)
    assert labels['segmentation'].any() and labels['hdmap'].shape == (2, 200, 200, 2)
    trainloader.close()
    valloader.close()
