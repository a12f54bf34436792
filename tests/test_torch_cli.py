"""The port's training and evaluation CLIs (python -m stp3_tpu_torch.train /
stp3_tpu_torch.evaluate) and its loader, on the CPU at TINY's widths
(the Planning stage's switches, fp32) over synthetic 'mini' data:

  * one epoch through ``train.main(... --device cpu)``, then a resume to
    a second epoch, whose checkpoint equals a straight two-epoch run's to
    the bit (weights, Adam, generator, step, the best-IoU monitor);
  * ``evaluate.main`` on that checkpoint: the result keys of the JAX
    package's ``evaluate()`` for this config (tests/test_torch_eval.py
    holds the port's ``evaluate`` to JAX's, key for key and value for
    value), and its first figure under ``imgs_eval/<TAG>/``;
  * without ``--device`` and without a card each CLI raises;
  * the warm start takes every entry but the decoder's;
  * ``NumpyLoader``: its batches and ``valid`` masks equal the JAX
    package's for a ragged rank / world split, serially and through its
    thread and process pools; a process worker that dies, or a sample
    past the deadline, raises instead of hanging;
  * ``prepare_dataloaders`` refuses a dataset it does not know
    (tests/test_torch_nuscenes_data.py and tests/test_torch_carla_data.py
    drive its 'nuscenes' and 'carla' branches).
"""
import glob
import json
import os

import numpy as np
import pytest
import torch
import yaml

import torch_fixtures
from stp3_tpu.datas.synthetic import NumpyLoader as JNumpyLoader
from stp3_tpu.datas.synthetic import SyntheticDataset as JSyntheticDataset
from stp3_tpu.config import get_cfg as jax_get_cfg
from stp3_tpu_torch import evaluate as tevaluate
from stp3_tpu_torch import train as ttrain
from stp3_tpu_torch.datas.dataloaders import prepare_dataloaders
from stp3_tpu_torch.datas.synthetic import NumpyLoader, SyntheticDataset
from stp3_tpu_torch.training import checkpoint as ck

torch.set_num_threads(2)

DATA = {'DATASET': {'NAME': 'synthetic', 'VERSION': 'mini', 'VAL_SAMPLES': 3},
        'N_WORKERS': 2, 'EPOCHS': 1}
PLANNING_KEYS = {'vehicle_iou', 'pedestrian_iou', 'lane_divider_iou', 'drivable_area_iou',
                 'plan_obj_col_1s', 'plan_obj_box_col_1s', 'plan_L2_1s'}


def tiny_cfg():
    return torch_fixtures.make_cfg(torch_fixtures.PLANNING_STAGE, torch_fixtures.TINY,
                                   {'PRECISION': 32}, DATA)


def _config_file(tmp_path, cfg):
    path = os.path.join(str(tmp_path), 'tiny.yml')
    with open(path, 'w') as f:
        yaml.safe_dump(json.loads(json.dumps(cfg.convert_to_dict())), f)
    return path


def _last(log_dir):
    last, = glob.glob(os.path.join(log_dir, '*', 'checkpoints', 'last'))
    return ck.resolve_checkpoint_path(last)


def test_train_one_epoch_resume_and_evaluate_through_the_clis(tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)          # the evaluation figures go to ./imgs_eval
    cfg = tiny_cfg()
    config = _config_file(tmp_path, cfg)
    log_dir = os.path.join(str(tmp_path), 'runs')
    ttrain.main(['--config-file', config, '--device', 'cpu', 'LOG_DIR', log_dir])
    first = _last(log_dir)
    assert first.endswith('step_5') and ck.load_meta(first)['step'] == 5
    best = ck.load_meta(first)['metrics']['best_iou']
    ttrain.main(['--config-file', config, '--device', 'cpu', 'LOG_DIR', log_dir,
                 'EPOCHS', '2', 'CHECKPOINT.RESUME', first])
    resumed = ck.resolve_checkpoint_path(os.path.join(os.path.dirname(first), 'last'))
    assert resumed.endswith('step_10')
    assert f'resumed from {first} at step 5' in capsys.readouterr().out
    meta = ck.load_meta(resumed)
    assert meta['metrics']['best_iou'] >= best and meta['metrics']['monitor'] == \
        'iou_vehicle_dynamic'

    straight_cfg = cfg.clone()
    straight_cfg.EPOCHS = 2
    record = ttrain.run(straight_cfg, 'cpu', save_dir=os.path.join(str(tmp_path), 'straight'),
                        log=lambda msg: None)
    assert record['step'] == 10 and len(record['train_ms']) == 10 and len(record['val_ms']) == 4
    want, got = ck.load_checkpoint(record['last']), ck.load_checkpoint(resumed)
    assert got['step'] == want['step'] == 10
    for key in ('model', 'optimizer'):
        assert set(got[key]) == set(want[key])
    for name, tensor in want['model'].items():
        assert torch.equal(got['model'][name], tensor), name
    for pid, state in want['optimizer']['state'].items():
        for name, tensor in state.items():
            assert torch.equal(got['optimizer']['state'][pid][name], tensor), (pid, name)
    assert torch.equal(got['generator'], want['generator'])
    assert ck.load_meta(record['last'])['metrics'] == meta['metrics']

    capsys.readouterr()
    tevaluate.main(['--checkpoint', os.path.dirname(resumed), '--device', 'cpu'])
    out = capsys.readouterr().out
    printed = {line.split(' : ')[0] for line in out.splitlines() if ' : ' in line}
    assert printed == PLANNING_KEYS
    assert os.path.isfile(os.path.join(str(tmp_path), 'imgs_eval', cfg.TAG, '0000.png'))
    results = tevaluate.evaluate(resumed, 'cpu', log=lambda msg: None)
    assert set(results) == PLANNING_KEYS
    assert all(np.isfinite(v) for v in results.values())


def test_the_clis_need_a_device_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    config = _config_file(tmp_path, tiny_cfg())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrain.main(['--config-file', config, 'LOG_DIR', str(tmp_path)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tevaluate.main(['--checkpoint', str(tmp_path)])
    assert not glob.glob(os.path.join(str(tmp_path), '*', 'checkpoints'))


def test_warm_start_takes_every_entry_but_the_decoders(tmp_path):
    from stp3_tpu_torch.training.trainer import Trainer
    cfg = tiny_cfg()
    source = Trainer(cfg, device='cpu', seed=3)
    path = ck.save_checkpoint(str(tmp_path), 0, source.model.state_dict())
    warm = cfg.clone()
    warm.EPOCHS = 0
    warm.PRETRAINED.LOAD_WEIGHTS = True
    warm.PRETRAINED.PATH = path
    lines = []
    ttrain.run(warm, 'cpu', save_dir=os.path.join(str(tmp_path), 'warm'), log=lines.append)
    n = sum('decoder' not in k for k in source.model.state_dict())
    assert any(f'warm start: loaded {n} tensors' in line for line in lines), lines


def _stream(loader, epochs=2):
    out = []
    for _ in range(epochs):
        for batch in loader:
            out.append((batch['image'].tobytes(), batch['instance'].tobytes(),
                        batch['valid'].tolist()))
    return out


@pytest.mark.parametrize('kw', [dict(num_workers=0), dict(num_workers=2),
                                dict(num_workers=2, use_processes=True)],
                         ids=['serial', 'threads', 'processes'])
def test_numpy_loader_matches_jax_on_a_ragged_rank_world_split(kw):
    """7 samples, 3 processes of batch 2 (global batch 6): the second
    global batch holds one real row and five wrap-around duplicates;
    shuffled, two epochs, every rank."""
    cfg = torch_fixtures.planning_cfg(tiny=True)
    ds, jds = SyntheticDataset(cfg, 7, seed=2), JSyntheticDataset(
        jax_get_cfg(cfg_dict=cfg.convert_to_dict()), 7, seed=2)
    valid = []
    for rank in range(3):
        ours = NumpyLoader(ds, 2, shuffle=True, drop_last=False, rank=rank, world=3,
                           with_valid_mask=True, seed=4, **kw)
        ref = JNumpyLoader(jds, 2, shuffle=True, drop_last=False, rank=rank, world=3,
                           with_valid_mask=True, seed=4, num_workers=0)
        try:
            got, want = _stream(ours), _stream(ref)
            assert len(ours) == len(ref) == 2
        finally:
            ours.close()
        assert got == want
        valid += [v for _, _, v in got]
    assert sum(map(sum, valid)) == 2 * 7           # every sample once an epoch


def test_numpy_loader_raises_when_a_worker_dies_or_hangs(monkeypatch):
    """A process worker that dies ends the epoch with BrokenProcessPool; a
    sample that outlives the loader's deadline raises TimeoutError; the
    pool closes after either."""
    from concurrent.futures.process import BrokenProcessPool

    from stp3_tpu_torch.datas import synthetic
    from torch_fake_datasets import FaultyDataset
    loader = NumpyLoader(FaultyDataset(6, 3, 'exit'), 2, num_workers=2, use_processes=True)
    try:
        with pytest.raises(BrokenProcessPool):
            list(loader)
    finally:
        loader.close()
    monkeypatch.setattr(synthetic, 'SAMPLE_TIMEOUT_S', 0.5)
    loader = NumpyLoader(FaultyDataset(6, 1, 'stall', seconds=3.0), 2, num_workers=2)
    try:
        with pytest.raises(TimeoutError, match='no sample from a loader worker'):
            list(loader)
    finally:
        loader.close()


def test_prepare_dataloaders_sizes_and_refusals():
    cfg = tiny_cfg()
    cfg.N_WORKERS = 0
    train, val, traindata, valdata = prepare_dataloaders(cfg, return_dataset=True)
    assert len(traindata) == 10 and len(valdata) == 3 and len(train) == 5 and len(val) == 2
    batch = next(iter(val))
    assert batch['valid'].all() and batch['image'].shape[0] == 2
    cfg.DATASET.VAL_SAMPLES = 0
    assert prepare_dataloaders(cfg, split='val')[0] is None
    assert len(prepare_dataloaders(cfg, split='val')[1].dataset) == 4
    cfg.DATASET.NAME = 'kitti'
    with pytest.raises(NotImplementedError, match='kitti'):
        prepare_dataloaders(cfg)
