"""The port's static-geometry splat plan (stp3_tpu_torch/ops/static_splat.py)
against stp3_tpu/ops/static_splat.py, on the CPU: the column plan equals
the JAX column plan element for element on the test rigs (the port builds
it from its own fp32 geometry, so an equal plan means no point moved
across a cell border), and column_splat equals both JAX functions (the
column plan's and the bucketed plan's static_splat) and the port's
dynamic splat (rtol 1e-4, atol 1e-5: tests/test_static_splat.py's
tolerance; the plans reorder the sums)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stp3_tpu.ops import static_splat as jss
from stp3_tpu_torch.datas.carla_data import carla_cam_rig
from stp3_tpu_torch.ops import static_splat as tss
from stp3_tpu_torch.ops.bev_pool import project_to_birds_eye_view
from stp3_tpu_torch.ops.geometry import (calculate_birds_eye_view_parameters, create_frustum,
                                         get_geometry)

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-5)
# tests/helpers.py's grid: 16x16 at 1 m, 8 depth bins, 32x64 images
TINY_GRID = ([-8.0, 8.0, 1.0], [-8.0, 8.0, 1.0], [-10.0, 10.0, 20.0])


def _tiny_rig(tilted=False):
    """tests/test_static_splat.py's rig: two cameras, the second turned 90
    degrees to the left; ``tilted`` gives camera 0 20 deg pitch and 10 deg
    roll, which breaks the rows-share-a-cell structure of the column plan."""
    h, w = 32, 64
    k = np.tile(np.array([[20.0, 0, w / 2], [0, 20.0, h / 2], [0, 0, 1]], np.float32), (2, 1, 1))
    e = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    e[1, :3, :3] = np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1]], np.float32)
    if tilted:
        cp, sp, cr, sr = np.cos(0.35), np.sin(0.35), np.cos(0.17), np.sin(0.17)
        pitch = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]], np.float32)
        roll = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]], np.float32)
        e[0, :3, :3] = e[0, :3, :3] @ pitch @ roll
    frustum = create_frustum((h, w), 8, (2.0, 10.0, 1.0))
    return frustum, k, e, calculate_birds_eye_view_parameters(*TINY_GRID)


def _carla_rig():
    """The agent's 4-camera CARLA rig at 64x64 on a 16 m grid at 0.5 m."""
    extr, intr = carla_cam_rig((64, 64))
    frustum = create_frustum((64, 64), 8, (2.0, 10.0, 1.0))
    grid = calculate_birds_eye_view_parameters([-8.0, 8.0, 0.5], [-8.0, 8.0, 0.5],
                                               [-10.0, 10.0, 20.0])
    return frustum, intr, extr, grid


RIGS = {'tiny': lambda: _tiny_rig(), 'tilted': lambda: _tiny_rig(tilted=True),
        'carla': _carla_rig}


@pytest.mark.parametrize('rig', sorted(RIGS))
def test_plans_equal_the_jax_plans_element_for_element(rig):
    frustum, k, e, (res, start, dim) = RIGS[rig]()
    want_c = jss.build_column_splat_plan(frustum, k, e, res, start, dim)
    got_c = tss.build_column_splat_plan(frustum, k, e, res, start, dim)
    for name in ('cells', 'lo', 'hi'):
        np.testing.assert_array_equal(getattr(got_c, name), getattr(want_c, name), err_msg=name)
    assert got_c.meta == (want_c.n_cams, want_c.hf, want_c.wf, want_c.depth_bins,
                          want_c.bev_dimension)
    for key, value in want_c.host_arrays().items():
        np.testing.assert_array_equal(got_c.host_arrays()[key], value, err_msg=key)


@pytest.mark.parametrize('rig', sorted(RIGS))
def test_static_and_column_splat_match_jax_and_the_dynamic_splat(rig):
    frustum, k, e, (res, start, dim) = RIGS[rig]()
    n = k.shape[0]
    d, hf, wf = frustum.shape[:3]
    b, c = 2, 5
    rng = np.random.RandomState(0)
    ctx = rng.randn(b, n * hf * wf, c).astype(np.float32)
    dp = np.array(jax.nn.softmax(jnp.asarray(rng.randn(b, n * hf * wf, d), jnp.float32), -1))
    cplan = tss.build_column_splat_plan(frustum, k, e, res, start, dim)
    jplan = jss.build_static_splat_plan(frustum, k, e, res, start, dim)
    jcplan = jss.build_column_splat_plan(frustum, k, e, res, start, dim)
    bev_dim = tuple(int(v) for v in dim)

    want_s = np.asarray(jss.static_splat(jnp.asarray(ctx), jnp.asarray(dp),
                                         jplan.device_buckets(), bev_dim))
    want_c = np.asarray(jss.column_splat(jnp.asarray(ctx), jnp.asarray(dp),
                                         jcplan.device_arrays(),
                                         (jcplan.n_cams, jcplan.hf, jcplan.wf,
                                          jcplan.depth_bins, jcplan.bev_dimension)))
    got_c = tss.column_splat(torch.from_numpy(ctx), torch.from_numpy(dp),
                             cplan.device_arrays('cpu'), cplan.meta).numpy()
    assert got_c.shape == want_c.shape == want_s.shape == (b, *bev_dim[:2], c)
    np.testing.assert_allclose(got_c, want_s, **TOL)
    np.testing.assert_allclose(got_c, want_c, **TOL)

    # the port's dynamic path: lift, then the splat of one frame at zero ego-motion
    lifted = (torch.from_numpy(dp).reshape(b, n, hf, wf, d).movedim(-1, 2)[..., None]
              * torch.from_numpy(ctx).reshape(b, n, 1, hf, wf, c))
    geometry = get_geometry(torch.from_numpy(frustum), torch.from_numpy(k)[None, None],
                            torch.from_numpy(e)[None, None]).expand(b, 1, -1, -1, -1, -1, -1)
    dyn = project_to_birds_eye_view(lifted[:, None], geometry, torch.zeros(b, 1, 6), res,
                                    start, dim)[:, 0].numpy()
    np.testing.assert_allclose(got_c, dyn, **TOL)
    assert np.abs(dyn).sum() > 0
