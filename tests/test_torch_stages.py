"""The stage configurations of the port against the JAX package's, on the
CPU: the Perception stages (nuScenes and CARLA: no future prediction, no
present distribution, no planner), Prediction_Ber (BERNOULLI), the
MIXGAUSSIAN and non-probabilistic Prediction stages, the identity
temporal model at a receptive field of 1 and the uniform lift
(USE_DEPTH_DISTRIBUTION False). Each at TINY's widths over the stage
YAML's own switches (torch_fixtures.stage_cfg(tiny=True)) at TINY's receptive
field of 2, fp32, with the
same seeded weights on both sides (numpy draws in the JAX model's
variable tree, loaded into the port through from_flax).

Tolerances: every output at atol 2e-3 and rtol 1e-3, the precedent of
tests/test_torch_model.py (reassociation through a ~60-conv stack); the
train-mode forwards the same, with the latent draws fixed (a numpy queue
in place of jax.random.normal, the same arrays handed to the port) and
dropout the identity on both sides. The Perception train step in
float64 on both sides (tests/torch_jax_steps.py says why): every loss
term at rtol 1e-5, every gradient at a relative L2 error below 1e-4.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

import torch_fixtures
from stp3_tpu.datas.synthetic import SyntheticDataset, collate
from stp3_tpu.models.stp3 import STP3 as JSTP3
from stp3_tpu.training.trainer import Trainer as JTrainer
from stp3_tpu_torch import config as tconfig
from stp3_tpu_torch.datas import synthetic as tsyn
from stp3_tpu_torch.models.stp3 import STP3, STP3Config
from torch_jax_steps import (assert_gradients_match, assert_outputs_close, inputs_of,
                             jax_forwards, jax_model, jax_norm_defaults, jax_train_step,
                             port_float64_step, port_grads, port_model, run_once,
                             seeded_variables, to_numpy)

torch.set_num_threads(2)
assert jax_norm_defaults            # the autouse fixture, imported to take effect here

CASES = {
    'perception': ('perception', {}),
    'carla_perception': ('carla_perception', {}),
    'prediction_ber': ('prediction_ber', {}),
    'mixgaussian': ('prediction_ber', {'PROBABILISTIC': {'METHOD': 'MIXGAUSSIAN'}}),
    'not_probabilistic': ('prediction_ber', {'PROBABILISTIC': {'ENABLED': False}}),
    'identity_rf1': ('perception', {'TIME_RECEPTIVE_FIELD': 1,
                                    'MODEL': {'TEMPORAL_MODEL': {'NAME': 'identity'}}}),
    'uniform_lift': ('perception', {'MODEL': {'ENCODER': {'USE_DEPTH_DISTRIBUTION': False}}}),
}


FORWARD_KEYS = ('image', 'intrinsics', 'extrinsics', 'future_egomotion')


def case_cfg(name):
    """A case's tiny config, at TINY's receptive field of 2 (a JAX program
    of the Perception train step compiles in half the time of rf 3's)."""
    stage, extra = CASES[name]
    return torch_fixtures.stage_cfg(stage, True, {'TIME_RECEPTIVE_FIELD': 2}, extra)


@functools.lru_cache(maxsize=None)
def jax_case(name):
    """(cfg, JAX model, its variables, eval output, train output on
    ``noise`` or None, noise or None) of a case: one JAX program. The
    train-mode forward runs for the cases with a latent draw to fix."""
    cfg = case_cfg(name)
    inputs = inputs_of(cfg)
    jm, _ = jax_model(cfg)
    noise = draws = None
    if name in ('prediction_ber', 'mixgaussian'):
        shape = STP3(STP3Config.from_cfg(cfg)).noise_shape(2)
        noise = np.random.RandomState(5).randn(*shape).astype(np.float32)
        draws = list(noise) if name == 'mixgaussian' else [noise]
    variables = seeded_variables(jm, inputs)
    out_eval, out_train = jax_forwards(jm, variables, inputs, draws)
    return cfg, jm, inputs, variables, out_eval, out_train, noise


@pytest.mark.parametrize('name', sorted(CASES))
def test_eval_forward_matches_jax(name):
    cfg, _, inputs, variables, out_j, _, _ = jax_case(name)
    model = port_model(cfg, variables).eval()
    with torch.no_grad():
        out_t = to_numpy(model(*[torch.from_numpy(a) for a in inputs]))
    assert_outputs_close(out_t, out_j)
    c = model.cfg
    assert hasattr(model, 'future_prediction') == (c.n_future > 0)
    assert hasattr(model, 'present_distribution') == (c.n_future > 0 and c.probabilistic)


@pytest.mark.parametrize('name', ['prediction_ber', 'mixgaussian'])
def test_train_mode_forward_with_fixed_draws_matches_jax(name):
    """BERNOULLI draws one (B, H, W, L) noise a cell; MIXGAUSSIAN three
    (B, 1, L) draws in order (the port's (3, B, 1, L))."""
    cfg, _, inputs, variables, out_eval, out_j, noise = jax_case(name)
    model = port_model(cfg, variables)
    with torch.no_grad():
        out_t = to_numpy(model(*[torch.from_numpy(a) for a in inputs], train=True,
                               noise=torch.from_numpy(noise), dropout=False))
    assert_outputs_close(out_t, out_j)
    # the draws moved the heads: the test sees the noise
    assert np.abs(out_j['segmentation'] - out_eval['segmentation']).max() > 1e-4


def test_uniform_lift_fused_equals_materialised():
    """USE_DEPTH_DISTRIBUTION False on the fused path: K4 (its plain
    version here) with every depth probability 1 against the materialised
    lift_uniform + K1, fp32, the same weights."""
    cfg = case_cfg('uniform_lift')
    model = STP3(STP3Config.from_cfg(cfg))
    from stp3_tpu_torch.layers.base import init_parameters
    init_parameters(model, torch.Generator().manual_seed(0)).eval()
    image, k, e, ego = (torch.from_numpy(a) for a in inputs_of(cfg))
    bevs = []
    with torch.no_grad():
        for fused in (False, True):
            model.cfg = dataclasses.replace(model.cfg, fused_lift_splat=fused)
            x, depth, _ = model.calculate_birds_eye_view_features(image, k, e, ego)
            assert depth is None
            bevs.append(x)
    assert bevs[0].abs().max() > 0
    torch.testing.assert_close(bevs[1], bevs[0], rtol=1e-5, atol=1e-5)


def test_perception_serve_step_matches_the_jax_tail():
    """serve_step on the Perception stage (no future prediction, no
    planner: the trajectory is None) against the JAX package's serving
    tail up to the plan: its grid warps of the cached frames, the
    discounted accumulate and forward_from_bev (the JAX _serve_tail itself
    plans unconditionally, so it needs a planner)."""
    from stp3_tpu.ops.warp import cumulative_warp_features
    cfg, jm, (image, k, e, ego), variables, _, _, _ = jax_case('perception')
    jax_model(cfg)                     # the JAX norm kind of this config, for the trace
    model = port_model(cfg, variables).eval()
    rf = cfg.TIME_RECEPTIVE_FIELD
    cached = np.random.RandomState(4).randn(2, rf - 1, 16, 16, 16).astype(np.float32)
    with torch.no_grad():
        traj, out_t, new_cache = model.serve_step(
            *(torch.from_numpy(a) for a in (image[:, -1], k[:, -1], e[:, -1], ego)),
            torch.from_numpy(cached), None, None, None)
    assert traj is None and tuple(new_cache.shape) == cached.shape

    def tail(v, bev_new, ego):
        frames = jax.numpy.concatenate([cached, bev_new[:, None]], 1)
        aligned = cumulative_warp_features(frames, ego, mode='bilinear',
                                           spatial_extent=(8.0, 8.0))
        acc, xs = 0.0, []
        for t in range(rf):
            acc = acc * cfg.LIFT.DISCOUNT + aligned[:, t]
            xs.append(acc)
        x = jax.numpy.stack(xs, 1)
        return jm.apply(v, x, None, None, ego, method=JSTP3.forward_from_bev)

    bev_new, _ = model.splat_single_frame(*(torch.from_numpy(a) for a in (
        image[:, -1], k[:, -1], e[:, -1])))
    out_j = to_numpy(run_once(tail, variables, bev_new.detach().numpy(), ego))
    out_t = to_numpy(out_t)
    for key in ('segmentation', 'pedestrian', 'hdmap'):
        np.testing.assert_allclose(out_t[key], out_j[key], atol=2e-3, rtol=1e-3, err_msg=key)


@pytest.mark.parametrize('stage,yaml', [('perception', 'nuscenes/Perception.yml'),
                                        ('carla_perception', 'carla/Perception.yml'),
                                        ('prediction_ber', 'nuscenes/Prediction_Ber.yml'),
                                        ('prediction', 'nuscenes/Prediction.yml')])
def test_torch_fixtures_stage_cfgs_are_their_yamls(stage, yaml):
    """tests/torch_fixtures.py's stage configs, as code, against their YAML through the
    port's loader (the LR compares as a float: YAML 1.1 reads '1e-3' as a
    string, and both trainers take float(OPTIMIZER.LR)); and the synthetic
    batch of the stage's tiny config byte for byte against the JAX
    package's generator."""
    import argparse
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(torch_fixtures.__file__)), 'stp3_tpu',
                        'configs', yaml)
    want = tconfig.get_cfg(argparse.Namespace(config_file=path, opts=[])).convert_to_dict()
    want['OPTIMIZER']['LR'] = float(want['OPTIMIZER']['LR'])
    assert torch_fixtures.stage_cfg(stage).convert_to_dict() == want
    cfg = torch_fixtures.stage_cfg(stage, True)
    from stp3_tpu.config import get_cfg as jget_cfg
    got = tsyn.collate([tsyn.SyntheticDataset(cfg, 4, 1)[i] for i in (0, 3)])
    jcfg = jget_cfg(cfg_dict=cfg.convert_to_dict())
    ref = collate([SyntheticDataset(jcfg, 4, 1)[i] for i in (0, 3)])
    assert set(got) == set(ref)
    for key, v in ref.items():
        assert got[key].shape == v.shape and got[key].tobytes() == v.tobytes(), key


@pytest.fixture(scope='module')
def perception_step():
    """The Perception stage's train step in float64, JAX and port, from the
    seeded weights, one synthetic batch of two, dropout off."""
    cfg = case_cfg('perception')
    jm, jcfg = jax_model(cfg)
    ds = SyntheticDataset(jcfg, n_samples=2, seed=0)
    batch = collate([ds[0], ds[1]])
    variables = seeded_variables(jm, [batch[k][:1] for k in FORWARD_KEYS])
    total_j, loss_j, grads_j, _ = jax_train_step(JTrainer(jcfg), variables['params'], batch)
    total_t, loss_t, grads_t, tr = port_float64_step(cfg, variables, batch)
    return dict(loss_j=loss_j, total_j=total_j, total_t=total_t, loss_t=loss_t,
                grads_t=grads_t, grads_j=port_grads(tr.model, grads_j))


def test_perception_loss_terms_match_jax(perception_step):
    s = perception_step
    assert set(s['loss_t']) == set(s['loss_j']) == {
        'segmentation', 'segmentation_uncertainty', 'pedestrian', 'pedestrian_uncertainty',
        'hdmap', 'hdmap_uncertainty'}
    for key, want in s['loss_j'].items():
        np.testing.assert_allclose(s['loss_t'][key], want, rtol=1e-5, atol=1e-9, err_msg=key)
    np.testing.assert_allclose(s['total_t'], s['total_j'], rtol=1e-5)


def test_perception_gradients_match_jax(perception_step):
    s = perception_step
    assert_gradients_match(s['grads_t'], s['grads_j'], 1e-4)


def test_refusals_of_what_stays_unported_and_of_what_jax_refuses():
    """The REMAT stage tags build (their steps: tests/test_torch_remat.py);
    a REMAT tag that does nothing at N_FUTURE_FRAMES 0, or 'temporal' with
    the identity temporal model, raises the JAX package's ValueError.
    GT_DEPTH, refused until its port, builds with its uncertainty weight
    (its train step: tests/test_torch_gt_depth.py)."""
    def build(*overrides):
        return STP3(STP3Config.from_cfg(torch_fixtures.stage_cfg('perception', True, *overrides)))
    assert float(build({'LIFT': {'GT_DEPTH': True}}).depths_weight.detach()) == 0.0
    assert build({'MODEL': {'REMAT': 'encoder+temporal+decoder'}}).remat_stages == {
        'encoder', 'temporal', 'decoder'}
    with pytest.raises(ValueError, match='no effect with N_FUTURE_FRAMES 0'):
        build({'MODEL': {'REMAT': 'encoder+gates'}})
    with pytest.raises(ValueError, match="'temporal' has no effect"):
        build({'MODEL': {'REMAT': 'temporal', 'TEMPORAL_MODEL': {'NAME': 'identity'}}})
    with pytest.raises(NotImplementedError, match='TIME_RECEPTIVE_FIELD'):
        build({'TIME_RECEPTIVE_FIELD': 1})
