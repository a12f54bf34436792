"""The port's geometry and BEV splat (stp3_tpu_torch/ops) against the JAX
package on the same numpy inputs, fp32 on the CPU: frustum, un-projection,
pose chain, voxelisation, and the full project_to_birds_eye_view (pre-warp,
frame-batched splat, discount) vs JAX's 'scatter' and 'pallas2b'
(interpret-mode Pallas) methods. Tolerance rtol=atol=1e-4 unless stated."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from stp3_tpu.ops import bev_pool as jbev
from stp3_tpu.ops import geometry as jgeo
from stp3_tpu_torch.ops import bev_pool as tbev
from stp3_tpu_torch.ops import geometry as tgeo

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-4)


def _rig(rng, b=1, s=3, n=2):
    k = np.tile(np.array([[20.0, 0, 31.5], [0, 20.0, 15.5], [0, 0, 1]], np.float32),
                (b, s, n, 1, 1))
    k[..., 0, 0] += rng.rand(b, s, n).astype(np.float32)
    e = np.tile(np.eye(4, dtype=np.float32), (b, s, n, 1, 1))
    for i in range(n):
        yaw = 2 * np.pi * i / n + 0.1
        rot = np.array([[0, 0, 1], [-1, 0, 0], [0, -1, 0]], np.float32)
        yawm = np.array([[np.cos(yaw), -np.sin(yaw), 0], [np.sin(yaw), np.cos(yaw), 0],
                         [0, 0, 1]], np.float32)
        e[:, :, i, :3, :3] = yawm @ rot
        e[:, :, i, :3, 3] = [1.2 * np.cos(yaw), 1.2 * np.sin(yaw), 1.5]
    ego = (rng.randn(b, s, 6) * [0.8, 0.3, 0.05, 0.02, 0.02, 0.1]).astype(np.float32)
    return k, e, ego


def test_frustum_and_bev_parameters_identical():
    np.testing.assert_array_equal(tgeo.create_frustum((32, 64), 8, (2.0, 10.0, 1.0)),
                                  jgeo.create_frustum((32, 64), 8, (2.0, 10.0, 1.0)))
    for a, b in zip(tgeo.calculate_birds_eye_view_parameters([-8, 8, 0.5], [-8, 8, 0.5],
                                                             [-10, 10, 20]),
                    jgeo.calculate_birds_eye_view_parameters([-8, 8, 0.5], [-8, 8, 0.5],
                                                             [-10, 10, 20])):
        np.testing.assert_array_equal(a, b)


def test_get_geometry_matches_jax():
    rng = np.random.RandomState(0)
    k, e, _ = _rig(rng)
    fr = jgeo.create_frustum((32, 64), 8, (2.0, 10.0, 1.0))
    want = np.asarray(jgeo.get_geometry(jnp.asarray(fr), jnp.asarray(k), jnp.asarray(e)))
    got = tgeo.get_geometry(torch.from_numpy(fr), torch.from_numpy(k), torch.from_numpy(e))
    assert tuple(got.shape) == want.shape == (1, 3, 2, 8, 4, 8, 3)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_pose_chain_matches_jax():
    rng = np.random.RandomState(1)
    _, _, ego = _rig(rng, b=2, s=4)
    np.testing.assert_allclose(tgeo.pose_vec2mat(torch.from_numpy(ego)).numpy(),
                               np.asarray(jgeo.pose_vec2mat(jnp.asarray(ego))), **TOL)
    np.testing.assert_allclose(
        tgeo.cumulative_prewarp_transforms(torch.from_numpy(ego), 4).numpy(),
        np.asarray(jgeo.cumulative_prewarp_transforms(jnp.asarray(ego), 4)), **TOL)


def test_voxelize_truncates_toward_zero_like_jax():
    """Points just below the grid origin have coords in (-1, 0): truncation
    maps them to 0 (valid), flooring would drop them."""
    res, start, dim = jgeo.calculate_birds_eye_view_parameters(
        [-8.0, 8.0, 1.0], [-8.0, 8.0, 1.0], [-10.0, 10.0, 20.0])
    pts = np.array([[-8.4, 0.2, 0.0], [-7.9, -8.3, 1.0], [7.99, 7.99, -9.9],
                    [8.01, 0.0, 0.0], [-9.2, 3.0, 0.0], [0.0, 0.0, 10.5]], np.float32)
    jc, jv = jbev.voxelize_coords(jnp.asarray(pts), res, start, dim)
    tc, tv = tbev.voxelize_coords(torch.from_numpy(pts), res, start, dim)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert tv.numpy().tolist() == [True, True, True, False, False, False]
    np.testing.assert_array_equal(tbev.ranks_of(tc, tv, dim).numpy(),
                                  np.asarray(jbev._ranks(jc, jv, dim)))


@pytest.mark.parametrize('method', ['scatter', 'pallas2b'])
def test_project_to_birds_eye_view_matches_jax(method):
    """Pre-warp by a real ego-motion chain, voxelise (a third of the points
    fall outside the grid or the height band), frame-batched splat, and the
    discount-0.5 accumulate over S=3 frames."""
    rng = np.random.RandomState(2)
    b, s, n, d, hf, wf, c = 1, 3, 2, 4, 3, 5, 8
    geom = np.concatenate([rng.uniform(-10, 10, (b, s, n, d, hf, wf, 2)),
                           rng.uniform(-13, 13, (b, s, n, d, hf, wf, 1))],
                          -1).astype(np.float32)
    feats = rng.randn(b, s, n, d, hf, wf, c).astype(np.float32)
    _, _, ego = _rig(rng, b, s)
    bounds = ([-8.0, 8.0, 1.0], [-8.0, 8.0, 1.0], [-10.0, 10.0, 20.0])
    res, start, dim = jgeo.calculate_birds_eye_view_parameters(*bounds)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jbev.project_to_birds_eye_view(
            jnp.asarray(feats), jnp.asarray(geom), jnp.asarray(ego), res, start, dim,
            discount=0.5, method=method))
    got = tbev.project_to_birds_eye_view(torch.from_numpy(feats), torch.from_numpy(geom),
                                         torch.from_numpy(ego), res, start, dim, 0.5)
    assert tuple(got.shape) == want.shape == (1, 3, 16, 16, 8)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert np.abs(want[:, 0]).sum() > 0 and np.abs(want[:, 2] - want[:, 1]).sum() > 0


# ------------------------------------------------------------------ warp
from stp3_tpu.ops import warp as jwarp  # noqa: E402
from stp3_tpu_torch.ops import warp as twarp  # noqa: E402


@pytest.mark.parametrize('mode', ['nearest', 'bilinear'])
def test_warp_features_matches_jax(mode):
    rng = np.random.RandomState(4)
    x = rng.randn(3, 12, 10, 5).astype(np.float32)
    flow = (rng.randn(3, 6) * [2.0, 2.0, 0, 0, 0, 0.3]).astype(np.float32)
    want = np.asarray(jwarp.warp_features(jnp.asarray(x), jnp.asarray(flow), mode, (8.0, 8.0)))
    got = twarp.warp_features(torch.from_numpy(x), torch.from_numpy(flow), mode, (8.0, 8.0))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_nearest_half_pixel_ties_round_up_like_jax():
    """A shift of exactly half a pixel (ty = 1/W on a 16-wide map, exact in
    binary) puts every sample on a tie: floor(ix + 0.5) rounds it up, where
    F.grid_sample's nearest mode would round half to even. Integer labels
    must come out equal."""
    x = np.arange(2 * 16 * 16, dtype=np.float32).reshape(2, 16, 16, 1)
    flow = np.zeros((2, 6), np.float32)
    flow[:, 1] = 8.0 / 16                       # ty = flow[1] / extent = 1/16
    flow[1, 0] = -8.0 / 16                      # and tx on the second map
    want = np.asarray(jwarp.warp_features(jnp.asarray(x), jnp.asarray(flow), 'nearest',
                                          (8.0, 8.0)))
    got = twarp.warp_features(torch.from_numpy(x), torch.from_numpy(flow), 'nearest',
                              (8.0, 8.0)).numpy()
    np.testing.assert_array_equal(got, want)
    # every column moved by one whole pixel (the tie rounded up), last one zero
    np.testing.assert_array_equal(got[0, :, :-1], x[0, :, 1:])
    np.testing.assert_array_equal(got[0, :, -1], 0)


@pytest.mark.parametrize('mode', ['nearest', 'bilinear'])
def test_cumulative_warps_match_jax(mode):
    """Past frames warped forward, future frames warped back, as the
    trainer's label preparation runs them (integer labels as floats)."""
    rng = np.random.RandomState(6)
    x = rng.randint(0, 3, (2, 4, 16, 16, 1)).astype(np.float32)
    flow = (rng.randn(2, 4, 6) * [1.5, 0.5, 0, 0, 0, 0.05]).astype(np.float32)
    for jfn, tfn in ((jwarp.cumulative_warp_features, twarp.cumulative_warp_features),
                     (jwarp.cumulative_warp_features_reverse,
                      twarp.cumulative_warp_features_reverse)):
        want = np.asarray(jfn(jnp.asarray(x), jnp.asarray(flow), mode, (8.0, 8.0)))
        got = tfn(torch.from_numpy(x), torch.from_numpy(flow), mode, (8.0, 8.0)).numpy()
        if mode == 'nearest':
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, **TOL)


def test_pose_inverse_and_matrix_to_vector_match_jax():
    rng = np.random.RandomState(8)
    vec = (rng.randn(5, 6) * [2, 2, 0.1, 0.05, 0.05, 0.5]).astype(np.float32)
    mats = jgeo.pose_vec2mat(jnp.asarray(vec))
    tm = tgeo.pose_vec2mat(torch.from_numpy(vec))
    np.testing.assert_allclose(tgeo.invert_pose_matrix(tm).numpy(),
                               np.asarray(jgeo.invert_pose_matrix(mats)), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tgeo.mat2pose_vec(tm).numpy(),
                               np.asarray(jgeo.mat2pose_vec(mats)), rtol=1e-5, atol=1e-6)
