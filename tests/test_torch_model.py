"""The whole serving slice: stp3_tpu_torch.models.stp3.STP3 against
stp3_tpu.models.stp3.STP3 on __graft_entry__._flagship_cfg(tiny=True),
fp32 on the CPU, with the flax params loaded through from_flax.

Tolerances: every head, cam_front and the depth logits at atol 2e-3 and
rtol 1e-3, the precedent of tests/test_full_model_parity.py:190-192
(reassociation through a ~60-conv stack); the seg/ped argmax occupancy
EQUAL; the planner's refined trajectory given the same occupancy at
atol 2e-3 (tests/test_full_model_parity.py:233-254).
"""
import jax
import numpy as np
import pytest
import torch

from __graft_entry__ import _example_inputs, _flagship_cfg, _planning_extras
from stp3_tpu.models.stp3 import STP3 as JSTP3
from stp3_tpu.models.stp3 import STP3Config as JCfg
from stp3_tpu_torch.layers.base import init_parameters
from stp3_tpu_torch.models.stp3 import STP3 as TSTP3
from stp3_tpu_torch.models.stp3 import STP3Config as TCfg
from stp3_tpu_torch.utils.from_flax import load_flax_params

torch.set_num_threads(2)
TOL = dict(atol=2e-3, rtol=1e-3)
HEADS = ['depth_prediction', 'cam_front', 'segmentation', 'pedestrian', 'hdmap',
         'costvolume', 'present_mu', 'present_log_sigma']


@pytest.fixture(scope='module')
def pair():
    cfg = _flagship_cfg(tiny=True)
    jmodel = JSTP3(JCfg.from_cfg(cfg))
    inputs = [np.array(a) for a in _example_inputs(cfg)]
    extras = {k: np.array(v) for k, v in
              _planning_extras(cfg, np.random.RandomState(0)).items()}
    variables = jax.jit(lambda key, a, kw: jmodel.init(key, *a, **kw,
                                                       method=JSTP3.init_full))(
        jax.random.PRNGKey(0), inputs, extras)
    params = jax.tree.map(np.asarray, variables['params'])
    out_j = jax.jit(lambda p, *a: jmodel.apply({'params': p}, *a, train=False))(
        params, *inputs)
    tmodel = load_flax_params(TSTP3(TCfg.from_cfg(cfg)), params).eval()
    with torch.no_grad():
        out_t = tmodel(*[torch.from_numpy(a) for a in inputs])
    return dict(cfg=cfg, jmodel=jmodel, params=params, tmodel=tmodel, inputs=inputs,
                extras=extras, out_j={k: (None if v is None else np.asarray(v))
                                      for k, v in out_j.items()}, out_t=out_t)


@pytest.mark.parametrize('key', HEADS)
def test_forward_output_matches_jax(pair, key):
    want, got = pair['out_j'][key], pair['out_t'][key]
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL, err_msg=key)


def test_disabled_heads_are_none_on_both_sides(pair):
    for key, v in pair['out_j'].items():
        assert (v is None) == (pair['out_t'][key] is None), key
    assert set(pair['out_j']) == set(pair['out_t'])


def _occupancy(seg, ped):
    return np.logical_or(seg.argmax(-1), ped.argmax(-1)).astype(np.float32)


def test_occupancy_equal(pair):
    oj, ot = pair['out_j'], pair['out_t']
    np.testing.assert_array_equal(ot['segmentation'].numpy().argmax(-1),
                                  oj['segmentation'].argmax(-1))
    np.testing.assert_array_equal(ot['pedestrian'].numpy().argmax(-1),
                                  oj['pedestrian'].argmax(-1))


@pytest.mark.parametrize('command', [1, 2])        # FORWARD, RIGHT
def test_plan_matches_jax_given_the_same_occupancy(pair, command):
    cfg, oj, ex = pair['cfg'], pair['out_j'], pair['extras']
    rf = cfg.TIME_RECEPTIVE_FIELD
    occ = _occupancy(oj['segmentation'], oj['pedestrian'])[:, rf:]
    args = [oj['cam_front'], ex['trajs'], ex['gt_trajs'], oj['costvolume'][:, rf:], occ,
            oj['hdmap'], np.array([command], np.int32), ex['target_points']]
    jmodel = pair['jmodel']
    loss_j, traj_j = jax.jit(lambda p, *a: jmodel.apply(
        {'params': p}, *a, train=False, method=JSTP3.plan))(pair['params'], *args)
    with torch.no_grad():
        loss_t, traj_t = pair['tmodel'].plan(*[torch.tensor(a) for a in args])
    assert float(loss_j) == float(loss_t) == 0.0
    assert tuple(traj_t.shape) == (1, cfg.N_FUTURE_FRAMES, 3)
    np.testing.assert_allclose(traj_t.numpy(), np.asarray(traj_j), atol=2e-3, rtol=1e-3)


def test_from_flax_is_strict(pair):
    cfg, params = pair['cfg'], pair['params']
    fresh = lambda: TSTP3(TCfg.from_cfg(cfg))    # noqa: E731
    missing = jax.tree.map(lambda a: a, params)
    del missing['decoder']['segmentation_head']['Conv_1']['bias']
    with pytest.raises(KeyError, match='without a flax leaf'):
        load_flax_params(fresh(), missing)
    extra = jax.tree.map(lambda a: a, params)
    extra['decoder']['unexpected'] = {'kernel': np.zeros((1, 1, 2, 2), np.float32)}
    with pytest.raises(KeyError, match='unused'):
        load_flax_params(fresh(), extra)
    wrong = jax.tree.map(lambda a: a, params)
    wrong['planner']['gru']['ir']['kernel'] = np.zeros((7, 2), np.float32)
    with pytest.raises(ValueError, match='planner/gru/ir/kernel'):
        load_flax_params(fresh(), wrong)


def test_seeded_init_is_deterministic_and_flax_like(pair):
    """The port builds its own weights on a machine without JAX: same seed,
    same weights; flax's init where it matters for a sane forward."""
    cfg = pair['cfg']
    a = init_parameters(TSTP3(TCfg.from_cfg(cfg)), torch.Generator().manual_seed(3))
    b = init_parameters(TSTP3(TCfg.from_cfg(cfg)), torch.Generator().manual_seed(3))
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb), name
    fp = a.future_prediction
    assert torch.all(fp.ConvNeXtBlock_0.gamma == 1e-6)
    gn = a.decoder.Norm_0.GroupNorm_0
    assert torch.all(gn.scale == 1) and torch.all(gn.bias == 0)
    assert a.segmentation_weight.item() == 0.0 and a.planning_weight.item() == 0.0
    k = a.encoder.EfficientNetFeatures_0.Conv_0.kernel          # fan_in 27
    assert abs(k.detach().std().item() - 27 ** -0.5) < 0.05


def test_bf16_policy_forward_and_plan_are_finite(pair):
    """The bench.py policy (bf16 params and image, fp32 geometry) end to end
    on the CPU; ConvNeXt blocks take the K2 route (its plain version here)."""
    cfg, ex = pair['cfg'], pair['extras']
    model = load_flax_params(TSTP3(TCfg.from_cfg(cfg)), pair['params']).to(torch.bfloat16)
    image, k, e, ego = (torch.from_numpy(a) for a in pair['inputs'])
    rf = cfg.TIME_RECEPTIVE_FIELD
    with torch.no_grad():
        out = model(image.bfloat16(), k, e, ego)
        occ = torch.logical_or(out['segmentation'].argmax(-1),
                               out['pedestrian'].argmax(-1)).float()
        _, traj = model.plan(out['cam_front'], torch.from_numpy(ex['trajs']).bfloat16(),
                             torch.from_numpy(ex['gt_trajs']).bfloat16(),
                             out['costvolume'][:, rf:], occ[:, rf:], out['hdmap'],
                             torch.from_numpy(ex['commands']),
                             torch.from_numpy(ex['target_points']).bfloat16())
    assert out['segmentation'].dtype == torch.bfloat16
    for key, v in out.items():
        assert v is None or torch.isfinite(v.float()).all(), key
    assert tuple(traj.shape) == (1, cfg.N_FUTURE_FRAMES, 3)
    assert torch.isfinite(traj.float()).all()
    # bf16 (8 mantissa bits) through ~60 convs against the fp32 JAX forward:
    # a sanity bound on the policy, not a parity claim
    np.testing.assert_allclose(out['costvolume'].float().numpy(), pair['out_j']['costvolume'],
                               atol=0.1, rtol=0.05)
