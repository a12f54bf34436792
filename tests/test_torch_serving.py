"""The port's serving modes against the JAX package's, on the CPU, fp32,
with the flax params loaded through from_flax: the fused lift + splat
model (STP3Config.fused_lift_splat), splat_single_frame, serve_step (with
ego-motion) and serve_step_static (column and bucket plans), each against
``model.apply(..., method=...)`` on __graft_entry__._flagship_cfg(tiny=True)
(b0, 2 cameras at 32x64, 16x16 BEV).

Tolerances: heads, caches and splats at atol 2e-3 / rtol 1e-3, the
precedent of tests/test_torch_model.py (reassociation through a ~60-conv
stack); the occupancies equal, and the refined trajectory at atol 2e-3.

Then a stream in the port alone (the check of the serving approximation):
rf + 4 frames through serve_step and serve_step_static, each step against
a full recompute over its window, on the rig and images of
tests/test_serving.py. At zero ego-motion every step to the tolerances of
tests/test_serving.py:69-73 (rtol = atol = 1e-4). Under motion to the
bounds of tests/test_serving.py:78-138: plan L2 <= 0.5 m at every step,
vehicle IoU >= 0.80 at the first step (that test's one step: 0.869 there
and here) and over the whole stream (0.831, pooled over its 5 steps). The
IoU of a single later step is not held to 0.80: with random weights it
spreads 0.78-0.87 from step to step and seed to seed (0.7995 at the third
step here), as the occupied share of a random decoder's map moves.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from __graft_entry__ import _example_inputs, _flagship_cfg, _planning_extras
from stp3_tpu.models.stp3 import STP3 as JSTP3
from stp3_tpu.models.stp3 import STP3Config as JCfg
from stp3_tpu.ops import static_splat as jss
from stp3_tpu_torch.models.stp3 import STP3 as TSTP3
from stp3_tpu_torch.models.stp3 import STP3Config as TCfg
from stp3_tpu_torch.ops import static_splat as tss
from stp3_tpu_torch.utils.from_flax import load_flax_params

torch.set_num_threads(2)
TOL = dict(atol=2e-3, rtol=1e-3)
HEADS = ['segmentation', 'pedestrian', 'hdmap', 'costvolume']
# XLA's backend optimisation off: each JAX program here runs a few times on
# a tiny model, so its compile time is what counts (tests/test_torch_train.py)
_ONE_SHOT = {'xla_backend_optimization_level': 0, 'xla_llvm_disable_expensive_passes': True}


def _run(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=_ONE_SHOT)(*args)


def _np(tree):
    return jax.tree.map(lambda a: None if a is None else np.asarray(a), tree)


@pytest.fixture(scope='module')
def pair():
    cfg = _flagship_cfg(tiny=True)
    jmodel = JSTP3(dataclasses.replace(JCfg.from_cfg(cfg), fused_lift_splat=True))
    image, k, e, ego = (np.array(a) for a in _example_inputs(cfg))
    extras = {key: np.array(v) for key, v in
              _planning_extras(cfg, np.random.RandomState(0)).items()}
    variables = _run(lambda key, a, kw: jmodel.init(key, *a, **kw, method=JSTP3.init_full),
                     jax.random.PRNGKey(0), (image, k, e, ego), extras)
    params = jax.tree.map(np.asarray, variables['params'])
    tcfg = TCfg.from_cfg(cfg)
    tmodel = load_flax_params(TSTP3(tcfg), params).eval()
    fused = load_flax_params(TSTP3(dataclasses.replace(tcfg, fused_lift_splat=True)),
                             params).eval()
    rig = (k[0, 0], e[0, 0])
    res, start, dim = tmodel.bev_resolution, tmodel.bev_start_position, tmodel.bev_dimension
    plans = {'column': (tss.build_column_splat_plan(tmodel.frustum, *rig, res, start, dim),
                        jss.build_column_splat_plan(tmodel.frustum, *rig, res, start, dim)),
             'buckets': (tss.build_static_splat_plan(tmodel.frustum, *rig, res, start, dim),
                         jss.build_static_splat_plan(tmodel.frustum, *rig, res, start, dim))}
    return dict(cfg=cfg, jmodel=jmodel, params=params, tmodel=tmodel, fused=fused,
                inputs=(image, k, e, ego), extras=extras, plans=plans)


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


@pytest.fixture(scope='module')
def fused_outputs(pair):
    jmodel = pair['jmodel']
    out_j = _np(_run(lambda p, *a: jmodel.apply({'params': p}, *a, train=False),
                     pair['params'], *pair['inputs']))
    with torch.no_grad():
        out_t = pair['fused'](*_t(*pair['inputs']))
    return out_j, out_t


@pytest.mark.parametrize('key', ['depth_prediction', 'cam_front', 'present_mu'] + HEADS)
def test_fused_model_matches_jax(fused_outputs, key):
    """The JAX package takes its fused branch on a TPU only; on the CPU its
    fused_lift_splat model runs the materialised path, the same function."""
    out_j, out_t = fused_outputs
    assert tuple(out_t[key].shape) == out_j[key].shape
    np.testing.assert_allclose(out_t[key].numpy(), out_j[key], **TOL, err_msg=key)


def _serve_args(pair, motion: bool):
    """Present frame, egomotion (1, rf, 6), a cache of rf-1 splats of the
    past frames (seeded, non-negative like a splat), candidates, command
    and target."""
    cfg = pair['cfg']
    image, k, e, _ = pair['inputs']
    rf = cfg.TIME_RECEPTIVE_FIELD
    ego = np.tile(np.array([1.0, 0, 0, 0, 0, 0.03] if motion else [0.0] * 6, np.float32),
                  (1, rf, 1))
    rng = np.random.RandomState(4)
    h, w = pair['tmodel'].cfg.bev_size
    cache = rng.rand(1, rf - 1, h, w, cfg.MODEL.ENCODER.OUT_CHANNELS).astype(np.float32)
    trajs = pair['extras']['trajs']
    return image[:, -1], k[:, -1], e[:, -1], ego, cache, trajs, np.array([1], np.int32), \
        np.zeros((1, 2), np.float32)


def _assert_serve_equal(cfg, got, want):
    traj_t, out_t, cache_t = got
    traj_j, out_j, cache_j = want
    assert set(out_t) == set(out_j)
    for key in HEADS + ['cam_front']:
        np.testing.assert_allclose(out_t[key].numpy(), out_j[key], **TOL, err_msg=key)
    np.testing.assert_allclose(cache_t.numpy(), cache_j, **TOL)
    rf = cfg.TIME_RECEPTIVE_FIELD
    occ = [np.logical_or(o['segmentation'].argmax(-1), o['pedestrian'].argmax(-1))[:, rf:]
           for o in (out_j, {k: np.asarray(v) for k, v in out_t.items() if v is not None})]
    assert tuple(traj_t.shape) == traj_j.shape == (1, cfg.N_FUTURE_FRAMES, 3)
    np.testing.assert_array_equal(*occ)
    np.testing.assert_allclose(traj_t.numpy(), traj_j, **TOL)


def test_splat_single_frame_matches_jax(pair):
    jmodel = pair['jmodel']
    image, k, e, _ = pair['inputs']
    args = (image[:, 0], k[:, 0], e[:, 0])
    bev_j, front_j = _np(_run(lambda p, *a: jmodel.apply(
        {'params': p}, *a, train=False, method=JSTP3.splat_single_frame), pair['params'], *args))
    with torch.no_grad():
        bev_t, front_t = pair['tmodel'].splat_single_frame(*_t(*args))
    assert tuple(bev_t.shape) == bev_j.shape == (1, 16, 16, 16)
    np.testing.assert_allclose(bev_t.numpy(), bev_j, **TOL)
    np.testing.assert_allclose(front_t.numpy(), front_j, **TOL)


def test_serve_step_with_motion_matches_jax(pair):
    jmodel = pair['jmodel']
    args = _serve_args(pair, motion=True)
    want = _np(_run(lambda p, *a: jmodel.apply({'params': p}, *a, train=False,
                                               method=JSTP3.serve_step), pair['params'], *args))
    with torch.no_grad():
        got = pair['tmodel'].serve_step(*_t(*args))
    _assert_serve_equal(pair['cfg'], got, want)


@pytest.mark.parametrize('kind', ['column', 'buckets'])
def test_serve_step_static_matches_jax(pair, kind):
    jmodel = pair['jmodel']
    image, _, _, ego, cache, trajs, cmd, tp = _serve_args(pair, motion=True)
    tplan, jplan = pair['plans'][kind]
    jarrays = (jplan.device_arrays() if kind == 'column'
               else jplan.device_buckets())
    tarrays = (tplan.device_arrays('cpu') if kind == 'column'
               else tplan.device_buckets('cpu'))
    args = (image, ego, cache, trajs, cmd, tp)
    want = _np(_run(lambda p, a, plan: jmodel.apply(
        {'params': p}, *a, plan, train=False, method=JSTP3.serve_step_static),
        pair['params'], args, jarrays))
    with torch.no_grad():
        got = pair['tmodel'].serve_step_static(*_t(*args), tarrays)
    _assert_serve_equal(pair['cfg'], got, want)


def _full_step(model, image, k, e, ego, trajs, cmd, tp):
    """The exact path: full forward over the window + occupancy + plan."""
    rf = model.cfg.receptive_field
    out = model(image, k, e, ego)
    occ = torch.logical_or(out['segmentation'].argmax(-1), out['pedestrian'].argmax(-1)).float()
    _, traj = model.plan(out['cam_front'], trajs, torch.zeros(1, model.cfg.n_future, 3),
                         out['costvolume'][:, rf:], occ[:, rf:], out['hdmap'], cmd, tp)
    return out, traj


@pytest.mark.parametrize('motion', [False, True], ids=['zero_ego', 'motion'])
@pytest.mark.parametrize('static', [False, True], ids=['serve_step', 'serve_step_static'])
def test_stream_matches_full_recompute(pair, static, motion):
    """rf + 4 frames of one fixed rig pushed through the serving path, its
    cache rolled from step to step, each step against the full forward of
    its window. Motion: 1 m forward and 0.03 rad of yaw per frame (the
    city turn of tests/test_serving.py)."""
    cfg, model = pair['cfg'], pair['tmodel']
    rf = cfg.TIME_RECEPTIVE_FIELD
    n_frames = rf + 4
    n, h, w = pair['inputs'][0].shape[2:5]
    # tests/test_serving.py's rig and images (its first rf frames are these)
    image = np.random.RandomState(0).rand(1, n_frames, n, h, w, 3).astype(np.float32)
    k1 = np.tile(np.array([[20.0, 0, w / 2], [0, 20.0, h / 2], [0, 0, 1]], np.float32),
                 (1, n_frames, n, 1, 1))
    e1 = np.tile(np.eye(4, dtype=np.float32), (1, n_frames, n, 1, 1))
    step = [1.0, 0, 0, 0, 0, 0.03] if motion else [0.0] * 6
    ego = np.tile(np.array(step, np.float32), (1, n_frames, 1))
    plan = tss.build_column_splat_plan(model.frustum, k1[0, 0], e1[0, 0], model.bev_resolution,
                                       model.bev_start_position,
                                       model.bev_dimension).device_arrays('cpu')
    image, k1, e1, ego = _t(image, k1, e1, ego)
    trajs, cmd, tp = _t(pair['extras']['trajs'], np.array([1], np.int32),
                        np.zeros((1, 2), np.float32))
    ious, l2s, inter, union = [], [], 0, 0
    with torch.no_grad():
        if static:
            cache = torch.stack([model.splat_single_frame_static(image[:, t], plan)[0]
                                 for t in range(rf - 1)], 1)
        else:
            cache = torch.stack([model.splat_single_frame(image[:, t], k1[:, t], e1[:, t])[0]
                                 for t in range(rf - 1)], 1)
        for t in range(rf - 1, n_frames):
            win = slice(t - rf + 1, t + 1)
            out_f, traj_f = _full_step(model, image[:, win], k1[:, win], e1[:, win],
                                       ego[:, win], trajs, cmd, tp)
            if static:
                traj_s, out_s, cache = model.serve_step_static(
                    image[:, t], ego[:, win], cache, trajs, cmd, tp, plan)
            else:
                traj_s, out_s, cache = model.serve_step(
                    image[:, t], k1[:, t], e1[:, t], ego[:, win], cache, trajs, cmd, tp)
            assert tuple(cache.shape) == (1, rf - 1, 16, 16, 16)
            if not motion:
                for key in ('segmentation', 'costvolume', 'hdmap'):
                    np.testing.assert_allclose(out_s[key].numpy(), out_f[key].numpy(),
                                               rtol=1e-4, atol=1e-4, err_msg=f'{key} step {t}')
                np.testing.assert_allclose(traj_s.numpy(), traj_f.numpy(), rtol=1e-4, atol=1e-4)
            seg_f = out_f['segmentation'].argmax(-1).numpy() == 1
            seg_s = out_s['segmentation'].argmax(-1).numpy() == 1
            inter += (seg_f & seg_s).sum()
            union += (seg_f | seg_s).sum()
            ious.append((seg_f & seg_s).sum() / max((seg_f | seg_s).sum(), 1))
            l2s.append(float(torch.linalg.norm(traj_f[..., :2] - traj_s[..., :2], dim=-1).mean()))
    assert len(ious) == 5
    assert ious[0] >= 0.80 and inter / union >= 0.80, (ious, inter / union)
    assert max(l2s) <= 0.5, l2s
