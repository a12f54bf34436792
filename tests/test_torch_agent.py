"""The port's closed-loop agent (stp3_tpu_torch/deploy) and its helpers
against stp3_tpu's, on the CPU: PID control, the route planner, the
egomotion from GPS and compass, the CARLA rig, the crop, and AgentCore
over recorded ticks with the same flax weights (4 cameras at 64x64, the
set-up of tests/test_agent.py:105-108). Steer and throttle at atol 1e-4,
brake equal (tests/test_agent.py:134-137)."""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from helpers import make_test_cfg
from stp3_tpu.datas import carla_data as jcarla
from stp3_tpu.deploy import control as jcontrol
from stp3_tpu.deploy.agent_core import AgentCore as JAgentCore
from stp3_tpu.models.stp3 import STP3 as JSTP3
from stp3_tpu.models.stp3 import STP3Config as JCfg
from stp3_tpu.utils import quaternion as jquat
from stp3_tpu_torch import config as tconfig
from stp3_tpu_torch.datas import carla_data as tcarla
from stp3_tpu_torch.deploy import control as tcontrol
from stp3_tpu_torch.deploy.agent_core import AgentCore
from stp3_tpu_torch.models.stp3 import STP3 as TSTP3
from stp3_tpu_torch.models.stp3 import STP3Config as TCfg
from stp3_tpu_torch.utils import quaternion as tquat
from stp3_tpu_torch.utils.from_flax import load_flax_params

torch.set_num_threads(2)
_ONE_SHOT = {'xla_backend_optimization_level': 0, 'xla_llvm_disable_expensive_passes': True}
CAMS = ['rgb', 'rgb_left', 'rgb_right', 'rgb_rear']


def test_pid_and_control_match():
    rng = np.random.RandomState(0)
    pids = [(mod.PIDController(1.25, 0.75, 0.3, 40), mod.PIDController(5.0, 0.5, 1.0, 40))
            for mod in (jcontrol, tcontrol)]
    for _ in range(6):
        wps = np.cumsum(rng.randn(4, 2) * [0.3, 1.0] + [0.0, 1.0], 0)
        speed = float(rng.uniform(0, 6))
        want = jcontrol.control_pid(wps, speed, *pids[0])
        got = tcontrol.control_pid(wps, speed, *pids[1])
        assert got == want


def test_route_planner_matches():
    plan = [({'lat': 0.0, 'lon': 0.0}, 4), ({'lat': 2e-5, 'lon': 0.0}, 4),
            ({'lat': 4e-5, 'lon': 0.0}, 3), ({'lat': 6e-5, 'lon': 0.0}, 2)]
    planners = [mod.RoutePlanner(min_distance=1.0) for mod in (jcontrol, tcontrol)]
    for rp in planners:
        rp.set_route(plan, gps=True)
    for lat in (0.0, 1e-5, 2e-5, 4.5e-5, 6e-5):
        gps = (np.array([lat, 0.0]) - planners[0].mean) * planners[0].scale
        (wp_j, cmd_j), (wp_t, cmd_t) = (rp.run_step(gps) for rp in planners)
        np.testing.assert_array_equal(wp_t, wp_j)
        assert cmd_t == cmd_j


def test_egomotion_matches():
    rng = np.random.RandomState(1)
    xs, ys = np.cumsum(rng.randn(2, 3) * 2, 1)
    thetas = rng.randn(3) * 0.2
    np.testing.assert_array_equal(tquat.se2_egomotion_vec(xs, ys, thetas),
                                  jquat.se2_egomotion_vec(xs, ys, thetas))


@pytest.mark.parametrize('final_dim', [(256, 256), (64, 64)])
def test_rig_matches(final_dim):
    for got, want in zip(tcarla.carla_cam_rig(final_dim), jcarla.carla_cam_rig(final_dim)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert (tcarla.CARLA_CMD_TO_CODE, tcarla.CMD_LANE) == (jcarla.CARLA_CMD_TO_CODE,
                                                           jcarla.CMD_LANE)


@pytest.mark.parametrize('crop', [256, 64])
def test_crop_matches_the_pil_path(crop):
    img = np.random.RandomState(2).randint(0, 256, (300, 400, 3), np.uint8)
    want = jcarla.scale_and_crop_image(Image.fromarray(img), scale=1.0, crop=crop)
    got = tcarla.scale_and_crop_image(img, scale=1.0, crop=crop)
    np.testing.assert_array_equal(got, want)
    # other scales resize as Pillow's default (bicubic) filter does
    want = jcarla.scale_and_crop_image(Image.fromarray(img), scale=1.1, crop=crop)
    np.testing.assert_array_equal(tcarla.scale_and_crop_image(img, scale=1.1, crop=crop), want)


def test_agent_core_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip('this machine has a card: the default device is taken')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        AgentCore(tconfig.get_cfg(), None)


@pytest.fixture(scope='module')
def agents():
    """The JAX test config with the agent's 4 cameras at 64x64, the JAX
    model's seeded init, and the same weights in the port."""
    cfg = make_test_cfg(BATCHSIZE=1)
    cfg.IMAGE.NAMES = ['A', 'B', 'C', 'D']
    cfg.IMAGE.FINAL_DIM = (64, 64)
    cfg.PLANNING.GRU_STATE_SIZE = 2
    rf, nf = cfg.TIME_RECEPTIVE_FIELD, cfg.N_FUTURE_FRAMES
    extr, intr = jcarla.carla_cam_rig((64, 64))
    rng = np.random.RandomState(0)
    inputs = (rng.rand(1, rf, 4, 64, 64, 3).astype(np.float32),
              np.tile(intr, (1, rf, 1, 1, 1)), np.tile(extr, (1, rf, 1, 1, 1)),
              np.zeros((1, rf, 6), np.float32))
    extras = {'trajs': rng.randn(1, cfg.PLANNING.SAMPLE_NUM, nf, 3).astype(np.float32),
              'gt_trajs': rng.randn(1, nf, 3).astype(np.float32),
              'commands': np.zeros((1,), np.int32), 'target_points': np.zeros((1, 2), np.float32)}
    jmodel = JSTP3(JCfg.from_cfg(cfg))
    init = jax.jit(lambda key, a, kw: jmodel.init(key, *a, **kw, method=JSTP3.init_full))
    args = (jax.random.PRNGKey(0), inputs, extras)
    params = jax.tree.map(np.asarray, init.lower(*args).compile(
        compiler_options=_ONE_SHOT)(*args)['params'])
    tcfg = tconfig.get_cfg(cfg_dict=cfg.convert_to_dict())

    def port_model():
        return load_flax_params(TSTP3(TCfg.from_cfg(tcfg)), params)

    return dict(cfg=cfg, tcfg=tcfg, params=params, port_model=port_model)


def _drive(core, n_ticks):
    """rf + 3 recorded ticks: seeded 300x400 frames, GPS 2 m further each
    tick, the sampler's module RNG seeded before every planned tick."""
    rng = np.random.RandomState(7)
    controls = []
    for t in range(n_ticks):
        core.push_frame({key: rng.randint(0, 255, (300, 400, 3), np.uint8) for key in CAMS},
                        gps=np.array([t * 2.0, 0.0]), theta=0.0)
        if core.warmed_up:
            np.random.seed(13)
            controls.append(core.plan_step(speed=3.0, command_value=4,
                                           target_point=np.array([0.0, 5.0]))[:3])
    return controls


def test_agent_core_default_mode_matches_jax(agents):
    """Incremental + static geometry (the default tick) over rf + 3 ticks:
    two planned ticks, the second on the rolled cache."""
    n_ticks = agents['cfg'].TIME_RECEPTIVE_FIELD + 3
    want = _drive(JAgentCore(agents['cfg'], {'params': agents['params']}, warmup=False),
                  n_ticks)
    got = _drive(AgentCore(agents['tcfg'], agents['port_model'](), device='cpu', warmup=False),
                 n_ticks)
    assert len(got) == len(want) == 2
    for (s_t, t_t, b_t), (s_j, t_j, b_j) in zip(got, want):
        np.testing.assert_allclose(s_t, s_j, atol=1e-4)
        np.testing.assert_allclose(t_t, t_j, atol=1e-4)
        assert b_t == b_j


def test_agent_core_tick_modes_agree(agents):
    """The three tick modes on the port, warm-up on: finite controls in
    range; the static and dynamic incremental ticks agree (the plan is
    exact for the fixed rig: tests/test_agent.py's slow check)."""
    n_ticks = agents['cfg'].TIME_RECEPTIVE_FIELD + 3
    runs = {}
    for mode, kw in (('full', dict(incremental=False)),
                     ('incremental', dict(static_geometry=False)), ('static', {})):
        core = AgentCore(agents['tcfg'], agents['port_model'](), device='cpu', **kw)
        runs[mode] = _drive(core, n_ticks)
        for steer, throttle, brake in runs[mode]:
            assert -1.0 <= steer <= 1.0 and 0.0 <= throttle <= 0.75 and isinstance(brake, bool)
    for (s0, t0, b0), (s1, t1, b1) in zip(runs['incremental'], runs['static']):
        np.testing.assert_allclose(s1, s0, atol=1e-4)
        np.testing.assert_allclose(t1, t0, atol=1e-4)
        assert b0 == b1
    other = TSTP3(dataclasses.replace(TCfg.from_cfg(agents['tcfg']), sample_num=6))
    with pytest.raises(ValueError, match='not built from this config'):
        AgentCore(agents['tcfg'], other, device='cpu')
