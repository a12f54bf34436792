"""The port's CARLA agent entry point (stp3_tpu_torch/carla_agent.py)
against the JAX package's (carla_agent.py), on the CPU, without CARLA or
the leaderboard: the harness STP3Agent of each, set up from the same
seeded reference-format checkpoint (imported by each package's own
converter), driven through the same recorded ticks as 300x400 BGRA sensor
data with gps, speed and imu (torch_fixtures.bgra_tick; the set-up of
tests/test_agent.py:54-94 on the CARLA rig's camera names, so
CAM_FRONT_PARITY is set on import). Warm-up ticks give zero control;
planned ticks' steer and throttle agree at atol 1e-4 and brake is equal
(tests/test_agent.py:134-137's tolerance)."""
import numpy as np
import pytest
import torch

import torch_fixtures
from stp3_tpu.config import get_cfg as jax_get_cfg
from stp3_tpu.models.stp3 import STP3Config as JCfg
from stp3_tpu.training import checkpoint as jckpt
from stp3_tpu.utils import torch_import as jti
from stp3_tpu_torch import carla_agent as tagent
from stp3_tpu_torch.scripts.import_torch_checkpoint import import_checkpoint
from stp3_tpu_torch.training import checkpoint as ckpt_lib
from torch_jax_steps import jax_norm_defaults

torch.set_num_threads(2)
assert jax_norm_defaults            # the autouse fixture, imported to take effect here
ZERO = {'steer': 0.0, 'throttle': 0.0, 'brake': 0.0}


@pytest.fixture(scope='module')
def checkpoints(tmp_path_factory):
    """A reference .ckpt of the CARLA Planning stage at tiny widths (4
    cameras at 64x64), imported into the port's format by its CLI and into
    an stp3_tpu checkpoint by stp3_tpu's converter, with the same config."""
    root = tmp_path_factory.mktemp('carla')
    cfg = torch_fixtures.make_cfg(torch_fixtures.CARLA_PLANNING, torch_fixtures.TINY_WIDTHS,
                                  {'PRECISION': 32, 'IMAGE': {
                                      'FINAL_DIM': (64, 64),
                                      'NAMES': ['front', 'left', 'right', 'rear']}})
    torch_fixtures.write_reference_checkpoint(cfg, str(root / 'ref.ckpt'), seed=5)
    path, report = import_checkpoint(str(root / 'ref.ckpt'), str(root / 'port'),
                                     log=lambda msg: None)
    assert report.ok()
    cfg_dict = ckpt_lib.load_config_dict(path)
    assert cfg_dict['PLANNING']['CAM_FRONT_PARITY'] and cfg_dict['MODEL']['NORM'] == 'bn_frozen'
    jcfg = jax_get_cfg(cfg_dict=cfg_dict)
    params, jreport = jti.import_state_dict(jti.load_reference_checkpoint(str(root / 'ref.ckpt')),
                                            JCfg.from_cfg(jcfg))
    assert jreport.ok()
    jpath = jckpt.save_checkpoint(str(root / 'jax'), 0, params, cfg_dict=cfg_dict)
    return dict(port=path, jax=jpath, rf=cfg.TIME_RECEPTIVE_FIELD)


def test_sensor_suite_matches():
    import carla_agent as jagent
    assert tagent._sensor_suite() == jagent._sensor_suite()
    assert tagent.get_entry_point() == jagent.get_entry_point() == 'STP3Agent'


def test_harness_matches_the_jax_harness(checkpoints):
    import carla_agent as jagent
    agents = {'jax': jagent.STP3Agent(), 'port': tagent.STP3Agent()}
    agents['jax'].setup(checkpoints['jax'])
    agents['port'].setup(checkpoints['port'], device='cpu')
    assert agents['port'].core.model.cfg.cam_front_index == 1
    controls = {name: [] for name in agents}
    n_ticks = checkpoints['rf'] + 4
    for name, agent in agents.items():
        agent.set_global_plan(torch_fixtures.AGENT_ROUTE)
        for t, (frame, _, theta) in enumerate(torch_fixtures.recorded_ticks(n_ticks)):
            np.random.seed(torch_fixtures.SEED + t)        # the sampler's module RNG
            controls[name].append(agent.run_step(torch_fixtures.bgra_tick(t, frame, theta), t))
    n_warm = checkpoints['rf'] + 1
    for name, run in controls.items():
        assert run[:n_warm] == [ZERO] * n_warm, name
        assert len(run) - n_warm == 3
    for got, want in zip(controls['port'][n_warm:], controls['jax'][n_warm:]):
        np.testing.assert_allclose(got['steer'], want['steer'], atol=1e-4)
        np.testing.assert_allclose(got['throttle'], want['throttle'], atol=1e-4)
        assert got['brake'] == want['brake']
        assert -1.0 <= got['steer'] <= 1.0 and 0.0 <= got['throttle'] <= 0.75


def test_harness_runs_on_the_card_unless_told(checkpoints, monkeypatch, tmp_path):
    """With no card and no device named, setup raises; with the CPU named it
    runs, and under $SAVE_PATH it writes the metadata of every 10th tick."""
    if torch.cuda.is_available():
        pytest.skip('this machine has a card: the default device is taken')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        tagent.STP3Agent().setup(checkpoints['port'])
    monkeypatch.setenv('SAVE_PATH', str(tmp_path))
    agent = tagent.STP3Agent()
    agent.setup(checkpoints['port'], device='cpu')
    agent.set_global_plan(torch_fixtures.AGENT_ROUTE)
    for t, (frame, _, theta) in enumerate(torch_fixtures.recorded_ticks(11)):
        agent.run_step(torch_fixtures.bgra_tick(t, frame, theta))
    written = sorted(p.name for p in tmp_path.glob('*/meta/*.json'))
    assert written == ['000010.json']
