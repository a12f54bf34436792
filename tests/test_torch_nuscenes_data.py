"""The port's nuScenes dataset (stp3_tpu_torch/datas/nuscenes_data.py)
against the JAX package's, sample for sample, on the CPU:

  * on tests/fake_nuscenes.py's devkit stand-in (Pillow-written random
    noise JPEGs, resize 0.5, the test config's 16x16 BEV), every sample,
    with and without LIFT.GT_DEPTH;
  * on tests/torch_fake_datasets.py's stand-in at full width (6 cameras,
    1600x900 -> 224x480, 3 past and 6 future frames, the 200x200 BEV, 42
    agents, GT_DEPTH), the first and the last window;
  * ``prepare_dataloaders`` on 'nuscenes' (the 'mini' cut to 10 windows)
    and one tiny train step of the port on its batch, GT_DEPTH on: every
    loss term finite, 'depths' among them;
  * the train CLI's ``run`` for an epoch on that tree, then ``evaluate`` of
    its checkpoint (which runs without GT_DEPTH, as the JAX package's).

Tolerances: the images, labels (segmentation, instance, pedestrian),
hdmap, command and the rounded depth label exactly; every other float
field at rtol 1e-6 (atol 1e-6 for values near zero). Both sides draw the
candidate trajectories from numpy's global generator, seeded alike before
each sample.
"""
import numpy as np
import pytest
import torch

import fake_nuscenes
import torch_fake_datasets
from helpers import make_test_cfg
from stp3_tpu.config import get_cfg as jax_get_cfg
from stp3_tpu.datas import nuscenes_data as jnd
from stp3_tpu_torch import config as tconfig
from stp3_tpu_torch.datas import nuscenes_data as tnd

torch.set_num_threads(2)

EXACT = {'image', 'segmentation', 'instance', 'pedestrian', 'hdmap', 'command', 'depths'}


def _fake_cfg(tmp_path, gt_depth):
    """tests/test_nuscenes_data.py's config of the fake tree."""
    cfg = make_test_cfg()
    cfg.DATASET.NAME = 'nuscenes'
    cfg.DATASET.VERSION = 'mini'
    cfg.DATASET.DATAROOT = str(tmp_path)
    cfg.DATASET.MAP_FOLDER = str(tmp_path)
    cfg.IMAGE.NAMES = ['CAM_FRONT', 'CAM_BACK']
    cfg.IMAGE.ORIGINAL_HEIGHT = 128
    cfg.IMAGE.ORIGINAL_WIDTH = 224
    cfg.IMAGE.RESIZE_SCALE = 0.5
    cfg.IMAGE.TOP_CROP = 0
    cfg.LIFT.GT_DEPTH = gt_depth
    return cfg


def _port_cfg(jcfg):
    return tconfig.get_cfg(cfg_dict=jcfg.convert_to_dict())


def assert_samples_equal(got, want, where=''):
    assert set(got) == set(want), (sorted(got), sorted(want))
    for key, w in want.items():
        g = got[key]
        w, g = np.asarray(w), np.asarray(g)
        assert g.dtype == w.dtype and g.shape == w.shape, (where, key, g.dtype, g.shape,
                                                            w.dtype, w.shape)
        if key in EXACT:
            np.testing.assert_array_equal(g, w, err_msg=f'{where} {key}')
        else:
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6, err_msg=f'{where} {key}')


def _compare(jds, tds, indices):
    for i in indices:
        np.random.seed(i)
        want = jds[i]
        np.random.seed(i)
        got = tds[i]
        assert_samples_equal(got, want, f'sample {i}')


@pytest.mark.parametrize('gt_depth', [False, True], ids=['no_depth', 'gt_depth'])
def test_getitem_matches_jax_on_the_fake_tree(gt_depth, tmp_path, monkeypatch):
    fake_nuscenes.install(monkeypatch)
    jcfg = _fake_cfg(tmp_path, gt_depth)
    nusc = jnd.make_nusc(jcfg)
    jds = jnd.FuturePredictionDataset(nusc, 0, jcfg)
    tds = tnd.FuturePredictionDataset(nusc, 0, _port_cfg(jcfg))
    assert len(tds) == len(jds) > 0
    np.testing.assert_array_equal(tds.indices, jds.indices)
    assert tds.augmentation_parameters == jds.augmentation_parameters
    _compare(jds, tds, range(len(jds)))


def test_getitem_matches_jax_at_full_width_on_the_stand_in(tmp_path, monkeypatch):
    torch_fake_datasets.install(monkeypatch, n_samples=10)
    jcfg = jax_get_cfg()
    jcfg.DATASET.VERSION = 'mini'
    jcfg.DATASET.DATAROOT = jcfg.DATASET.MAP_FOLDER = str(tmp_path)
    jcfg.TIME_RECEPTIVE_FIELD, jcfg.N_FUTURE_FRAMES = 3, 6
    jcfg.LIFT.GT_DEPTH = True
    nusc = jnd.make_nusc(jcfg)
    jds = jnd.FuturePredictionDataset(nusc, 0, jcfg)
    tds = tnd.FuturePredictionDataset(nusc, 0, _port_cfg(jcfg))
    assert len(tds) == len(jds) == 10 - 9 + 1
    _compare(jds, tds, [0, len(jds) - 1])
    item = tds[0]
    assert item['image'].shape == (3, 6, 224, 480, 3)
    assert item['depths'].shape == (3, 6, 224, 480) and item['depths'].max() > 0
    assert item['segmentation'].shape == (9, 200, 200) and item['segmentation'].any()
    assert item['pedestrian'].any() and len(np.unique(item['instance'])) > 10


def test_prepare_dataloaders_and_one_train_step(tmp_path, monkeypatch):
    from stp3_tpu_torch.datas.dataloaders import prepare_dataloaders
    from stp3_tpu_torch.training.trainer import Trainer, batch_to_device
    fake_nuscenes.install(monkeypatch)
    cfg = _port_cfg(_fake_cfg(tmp_path, True))
    trainloader, valloader, traindata, valdata = prepare_dataloaders(cfg, return_dataset=True)
    assert isinstance(traindata, tnd.FuturePredictionDataset)
    assert 0 < len(traindata) <= 10 and len(valdata) > 0
    batch = next(iter(trainloader))
    assert batch['image'].shape[0] == cfg.BATCHSIZE and batch['image'].dtype == np.uint8
    trainer = Trainer(cfg, device='cpu')
    loss = trainer.train_step(batch_to_device(batch, 'cpu'))
    assert {'depths', 'depths_uncertainty', 'segmentation', 'planning'} <= set(loss)
    assert all(torch.isfinite(v).all() for v in loss.values())
    trainloader.close()
    valloader.close()


def test_train_and_evaluate_clis_on_nuscenes(tmp_path, monkeypatch):
    """``train.run`` for one epoch on the fake tree (GT_DEPTH on), then
    ``evaluate`` of its checkpoint: the dataset comes from the config the
    checkpoint carries, through ``prepare_dataloaders``."""
    from stp3_tpu_torch import evaluate as tevaluate
    from stp3_tpu_torch import train as ttrain
    fake_nuscenes.install(monkeypatch)
    cfg = _port_cfg(_fake_cfg(tmp_path / 'data', True))
    cfg.EPOCHS = 1
    record = ttrain.run(cfg, 'cpu', str(tmp_path / 'run'), log=lambda msg: None)
    assert record['step'] == len(record['train_ms']) > 0
    assert all(torch.isfinite(v).all() for v in record['loss'].values())
    stats = {}
    results = tevaluate.evaluate(record['last'], 'cpu', log=lambda msg: None, stats=stats)
    assert stats['samples'] > 0 and results and all(np.isfinite(v) for v in results.values())
