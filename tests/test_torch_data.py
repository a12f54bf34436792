"""The port's own config, data and input modules against their stp3_tpu
counterparts: the config tree (defaults, every shipped YAML, the dict
round trip, CLI overrides), tests/torch_fixtures.py's in-code configurations (the
flagship, the nuScenes and the CARLA Planning stages), the synthetic
batch (byte for byte), the trajectory sampler, the instance labels and
the image preparation."""
import argparse
import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_fixtures
from __graft_entry__ import _flagship_cfg
from stp3_tpu import config as jconfig
from stp3_tpu.datas import synthetic as jsyn
from stp3_tpu.utils import instance as jinst
from stp3_tpu.utils import network as jnet
from stp3_tpu.utils import sampler as jsampler
from stp3_tpu_torch import config as tconfig
from stp3_tpu_torch.datas import synthetic as tsyn
from stp3_tpu_torch.utils import instance as tinst
from stp3_tpu_torch.utils import network as tnet
from stp3_tpu_torch.utils import sampler as tsampler

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAMLS = sorted(glob.glob(os.path.join(REPO, 'stp3_tpu', 'configs', '**', '*.yml'),
                         recursive=True))


def _args(path='', opts=None):
    return argparse.Namespace(config_file=path, opts=opts or [])


def test_defaults_are_the_same_tree():
    assert tconfig.get_cfg().convert_to_dict() == jconfig.get_cfg().convert_to_dict()
    assert tconfig.TPU_ONLY_KEYS == jconfig.TPU_ONLY_KEYS


@pytest.mark.parametrize('path', YAMLS, ids=[os.path.relpath(p, REPO) for p in YAMLS])
def test_every_shipped_yaml_merges_to_the_same_tree(path):
    want = jconfig.get_cfg(_args(path)).convert_to_dict()
    assert tconfig.get_cfg(_args(path)).convert_to_dict() == want
    assert (tconfig.strip_tpu_only_keys(want) == jconfig.strip_tpu_only_keys(want))


def test_dict_round_trip_and_cli_overrides_match():
    opts = ['BATCHSIZE', '4', 'OPTIMIZER.LR', '1e-3', 'MODEL.REMAT', 'none',
            'SEMANTIC_SEG.PEDESTRIAN.ENABLED', 'false', 'IMAGE.FINAL_DIM', '(64, 96)']
    got, want = tconfig.get_cfg(_args(YAMLS[0], opts)), jconfig.get_cfg(_args(YAMLS[0], opts))
    assert got.convert_to_dict() == want.convert_to_dict()
    assert got.IMAGE.FINAL_DIM == (64, 96) and got.SEMANTIC_SEG.PEDESTRIAN.ENABLED is False
    d = want.convert_to_dict()
    assert tconfig.get_cfg(cfg_dict=d).convert_to_dict() == jconfig.get_cfg(
        cfg_dict=d).convert_to_dict()
    assert tconfig.get_parser().parse_args(['--config-file', 'x.yml', 'A', '1']).opts == [
        'A', '1']


@pytest.mark.parametrize('tiny', [False, True])
def test_torch_fixtures_flagship_cfg_is_the_graft_entry_one(tiny):
    assert (torch_fixtures.flagship_cfg(tiny).convert_to_dict()
            == _flagship_cfg(tiny).convert_to_dict())


def test_torch_fixtures_planning_cfg_is_planning_yml():
    """tests/torch_fixtures.py's Planning overrides, as code, against Planning.yml
    through the port's loader. YAML 1.1 reads '2e-4' (no dot) as a string;
    both trainers take float(OPTIMIZER.LR), so the LR compares as a float."""
    want = tconfig.get_cfg(_args(os.path.join(
        REPO, 'stp3_tpu', 'configs', 'nuscenes', 'Planning.yml'))).convert_to_dict()
    got = torch_fixtures.planning_cfg().convert_to_dict()
    assert want['OPTIMIZER']['LR'] == '2e-4'
    want['OPTIMIZER']['LR'] = float(want['OPTIMIZER']['LR'])
    assert got == want
    tiny = torch_fixtures.planning_cfg(tiny=True)
    assert tiny.PRECISION == 32 and tiny.MODEL.REMAT == 'encoder' and tiny.BATCHSIZE == 2


def test_torch_fixtures_carla_cfg_is_carla_planning_yml():
    """The agent's CARLA_PLANNING overrides, as code, against
    stp3_tpu/configs/carla/Planning.yml through the port's loader (the LR
    compares as a float, as in the Planning check above)."""
    want = tconfig.get_cfg(_args(os.path.join(
        REPO, 'stp3_tpu', 'configs', 'carla', 'Planning.yml'))).convert_to_dict()
    got = torch_fixtures.carla_planning_cfg().convert_to_dict()
    want['OPTIMIZER']['LR'] = float(want['OPTIMIZER']['LR'])
    assert got == want
    assert got['IMAGE']['FINAL_DIM'] == (256, 256) and got['PLANNING']['SAMPLE_NUM'] == 2400


def test_synthetic_batch_is_byte_equal():
    cfg = torch_fixtures.planning_cfg(tiny=True)
    jcfg = jconfig.get_cfg(cfg_dict=cfg.convert_to_dict())
    for seed, idx in ((0, (0, 1)), (3, (5, 2))):
        got = tsyn.collate([tsyn.SyntheticDataset(cfg, 8, seed)[i] for i in idx])
        want = jsyn.collate([jsyn.SyntheticDataset(jcfg, 8, seed)[i] for i in idx])
        assert set(got) == set(want)
        for k, v in want.items():
            assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
            assert got[k].tobytes() == v.tobytes(), k
    assert len(tsyn.SyntheticDataset(cfg, 8, 0)) == 8


# (n_future, n_samples, sample_interval): the CARLA and nuScenes candidate
# sets, an empty horizon, a small set, and two intervals whose 10x finer
# grid (62 and 32 points) does not end on a kept time
SAMPLER_SIZES = [(4, 2400, 0.5), (6, 1800, 0.5), (0, 12, 0.5), (8, 60, 0.5),
                 (6, 60, 0.1), (3, 60, 0.05)]
# -0.003 falls inside the circles' curvature clamp of 0.01
SAMPLER_STEERINGS = [-0.5, -0.05, -0.003, 0.0, 0.07, 0.2]
SAMPLER_CASES = pytest.mark.parametrize(
    'size,steering,v0,flip',
    [(size, steering, v0, flip) for size in SAMPLER_SIZES for steering in SAMPLER_STEERINGS
     for v0 in (0.0, 12.0) for flip in (False, True)])


@SAMPLER_CASES
def test_sampler_matches(size, steering, v0, flip):
    """The port evaluates only the kept times; stp3_tpu evaluates the fine
    grid and decimates. The arrays and the draws consumed are the same."""
    n_future, n_samples, interval = size
    seed = 2**31 + 977 * n_samples + n_future
    rng_t, rng_j = np.random.RandomState(seed), np.random.RandomState(seed)
    got = tsampler.sample_trajectories(v0, steering, n_future, n_samples, interval,
                                       flip_steering=flip, rng=rng_t)
    want = jsampler.sample_trajectories(v0, steering, n_future, n_samples, interval,
                                        flip_steering=flip, rng=rng_j)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(rng_t.rand(8), rng_j.rand(8))


@SAMPLER_CASES
def test_sampler_shape_and_dtype(size, steering, v0, flip):
    n_future, n_samples, interval = size
    got = tsampler.sample_trajectories(v0, steering, n_future, n_samples, interval,
                                       flip_steering=flip, rng=np.random.RandomState(5))
    assert got.shape == (n_samples, n_future + 1, 3)
    assert got.dtype == np.float64


def test_instance_labels_match():
    rng = np.random.RandomState(2)
    inst = np.zeros((4, 16, 16), np.int32)
    inst[:, 3:6, 4:8] = 1
    inst[1:, 9:12, 10:13] = 2
    ego = (rng.randn(4, 6) * [0.8, 0.2, 0, 0, 0, 0.05]).astype(np.float32)
    got = tinst.convert_instance_mask_to_center_and_offset_label(
        inst, ego, 2, spatial_extent=(8.0, 8.0))
    want = jinst.convert_instance_mask_to_center_and_offset_label(
        inst, ego, 2, spatial_extent=(8.0, 8.0))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_prepare_image_matches(dtype):
    img = np.random.RandomState(3).randint(0, 256, (2, 5, 7, 3), dtype=np.uint8)
    want = np.asarray(jnet.prepare_image(jnp.asarray(img), getattr(jnp, dtype)), np.float32)
    got = tnet.prepare_image(torch.from_numpy(img), getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(), want)
    floats = torch.rand(2, 3)
    assert torch.equal(tnet.prepare_image(floats, torch.float32), floats)
