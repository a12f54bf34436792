"""The port's metrics (stp3_tpu_torch/metrics.py) against the JAX
package's (stp3_tpu/metrics.py) on the same seeded numpy arrays, on the
CPU: IoU counts, collision counts and PQ / SQ / RQ equal exactly, L2 to
rtol 1e-6 (the same float32 operations, summed over the batch in another
order). The planning cases hold trajectories off the grid on every side
(negative cells truncate toward zero before the clip) and GT
trajectories that collide themselves (those frames are skipped).
"""
import numpy as np
import pytest
import torch

from stp3_tpu import metrics as jm
from stp3_tpu.config import get_cfg as jax_get_cfg
from stp3_tpu.ops.geometry import ego_footprint_grid_pts as jax_footprint
from stp3_tpu_torch import metrics as tm
from stp3_tpu_torch.config import get_cfg
from stp3_tpu_torch.ops.geometry import ego_footprint_grid_pts


def test_ego_footprint_grid_pts_matches_jax():
    for w, h, bx, dx in ((1.85, 4.084, (-49.75, -49.75), (0.5, 0.5)),
                         (2.12, 4.90, (-19.9, -19.9), (0.2, 0.2))):
        np.testing.assert_array_equal(ego_footprint_grid_pts(w, h, bx, dx),
                                      jax_footprint(w, h, bx, dx))


@pytest.mark.parametrize('n_classes,ignore_index,absent', [(2, None, 0.0), (3, 1, 0.0),
                                                           (2, None, 1.0)])
def test_iou_metric_matches_jax(n_classes, ignore_index, absent):
    """Three updates of (B, T, H, W) maps with values outside the classes
    too (255, the ignore label, and -1): every count equal, and the scores."""
    rng = np.random.RandomState(n_classes)
    ours = tm.IoUMetric(n_classes, ignore_index, absent)
    ref = jm.IoUMetric(n_classes, ignore_index, absent)
    for i in range(3):
        pred = rng.randint(-1, n_classes + 1, (2, 3, 17, 19))
        target = rng.randint(0, n_classes, (2, 3, 17, 19))
        target[0, 0, :4] = 255
        if i == 2:
            pred[pred == n_classes - 1] = 0          # a class never predicted
        ours.update(torch.from_numpy(pred), torch.from_numpy(target))
        ref.update(pred, target)
    for key in ref.state:
        assert ours.state[key].dtype == np.int64
        np.testing.assert_array_equal(ours.state[key], ref.state[key], err_msg=key)
    np.testing.assert_array_equal(ours.compute(), ref.compute())


def test_iou_metric_absent_class_scores_absent_score():
    for absent in (0.0, 1.0):
        ours = tm.IoUMetric(2, absent_score=absent)
        ours.update(np.zeros((1, 4, 4), np.int64), np.zeros((1, 4, 4), np.int64))
        np.testing.assert_array_equal(ours.compute(), [1.0, absent])


def _planning_case(seed, b=5, t=6, hw=200):
    """Trajectories (planner frame: x lateral, y forward, metres) and an
    occupancy with blocks, some on the GT path: column 0 of the batch
    drives off the grid ahead (y > 50 m), column 1 behind and to the side
    (negative cells), the rest inside."""
    rng = np.random.RandomState(seed)
    gt = np.zeros((b, t, 3), np.float32)
    gt[..., 0] = rng.uniform(-3, 3, (b, t))
    gt[..., 1] = np.cumsum(rng.uniform(0.5, 4.0, (b, t)), axis=1)
    gt[0, :, 1] += 52.0
    gt[1, :, :2] = rng.uniform(-60, -49, (t, 2))
    trajs = gt + rng.normal(0, 1.5, gt.shape).astype(np.float32)
    trajs[2, 3:, 0] = 55.0 + rng.rand(t - 3)                      # off the side
    seg = (rng.rand(b, t, hw, hw) > 0.995).astype(np.int64)
    # blocks on the GT path (the GT collides: frame skipped) and beside it
    for i in range(2, b):
        for j in range(0, t, 2):
            r = int(round(gt[i, j, 1] / 0.5 + 100))
            c = int(round(-gt[i, j, 0] / 0.5 + 100))
            seg[i, j, r - 2:r + 3, c - 1:c + 2] = 1
            seg[i, j + 1, r + 3:r + 8, c + 3:c + 9] = 1
            if i == b - 1:            # the trajectory's point in the second block
                trajs[i, j + 1, 1] = (r + 5 - 99.5) / 2 + 0.1
                trajs[i, j + 1, 0] = -((c + 6 - 99.5) / 2 + 0.1)
    return trajs, gt, seg


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_planning_metric_matches_jax(seed):
    cfg, jcfg = get_cfg(), jax_get_cfg()
    trajs, gt, seg = _planning_case(seed)
    ours, ref = tm.PlanningMetric(cfg, 6), jm.PlanningMetric(jcfg, 6)
    np.testing.assert_array_equal(ours.footprint, np.asarray(ref.footprint))
    for sl in (slice(0, 3), slice(3, 5)):
        ours.update(torch.from_numpy(trajs[sl]), torch.from_numpy(gt[sl]),
                    torch.from_numpy(seg[sl]))
        ref.update(trajs[sl], gt[sl], seg[sl])
    np.testing.assert_array_equal(ours.state['obj_col'], ref.state['obj_col'])
    np.testing.assert_array_equal(ours.state['obj_box_col'], ref.state['obj_box_col'])
    assert ours.state['total'] == ref.state['total'] == 5
    np.testing.assert_allclose(ours.state['l2'], ref.state['l2'], rtol=1e-6)
    # the case is not vacuous: collisions counted, GT collisions skipped
    assert ref.state['obj_box_col'].sum() > 0 and ref.state['obj_col'].sum() > 0
    out, want = ours.compute(), ref.compute()
    for key in want:
        np.testing.assert_allclose(out[key], want[key], rtol=1e-6, err_msg=key)


def test_planning_metric_skips_every_frame_where_the_gt_collides():
    """All occupied: every GT frame collides, so nothing counts."""
    cfg = get_cfg()
    trajs, gt, _ = _planning_case(3, b=3)
    m = tm.PlanningMetric(cfg, 6)
    m.update(trajs, gt, np.ones((3, 6, 200, 200), np.int64))
    assert not m.state['obj_col'].any() and not m.state['obj_box_col'].any()


def _instances(rng, t=4, hw=40, n=6):
    """(T, H, W) instance maps of ``n`` moving boxes with persistent ids."""
    out = np.zeros((t, hw, hw), np.int64)
    pos = rng.randint(2, hw - 10, (n, 2))
    vel = rng.randint(-2, 3, (n, 2))
    for j in range(t):
        for k in range(n):
            r, c = np.clip(pos[k] + j * vel[k], 0, hw - 6)
            out[j, r:r + 4 + k % 3, c:c + 5] = k + 1
    return out


def test_panoptic_metric_matches_jax():
    """GT against predictions with a dropped instance, a shifted one, an
    id swap in the middle of a sequence (the temporal-consistency penalty)
    and a spurious instance: every accumulator and PQ / SQ / RQ equal."""
    rng = np.random.RandomState(0)
    gt = np.stack([_instances(rng) for _ in range(3)])
    pred = gt.copy()
    pred[0][pred[0] == 2] = 0
    pred[1, 2:][pred[1, 2:] == 1] = 7
    pred[1, 2:][pred[1, 2:] == 3] = 1
    pred[2] = np.roll(pred[2], 2, axis=-1)
    pred[2, :, 30:34, 30:34] = 9
    for consistent in (True, False):
        ours, ref = tm.PanopticMetric(2, consistent), jm.PanopticMetric(2, consistent)
        for sl in (slice(0, 2), slice(2, 3)):
            ours.update(torch.from_numpy(pred[sl]), torch.from_numpy(gt[sl]))
            ref.update(pred[sl], gt[sl])
        for key in ref.state:
            np.testing.assert_array_equal(ours.state[key], ref.state[key], err_msg=key)
        out, want = ours.compute(), ref.compute()
        for key in want:
            np.testing.assert_array_equal(out[key], want[key], err_msg=key)
    assert 0 < want['pq'][1] < 1


def test_metric_states_are_additive():
    """The state of two metrics fed halves sums to the state of one fed all
    (what a multi-process evaluation sums)."""
    cfg = get_cfg()
    trajs, gt, seg = _planning_case(4)
    whole, halves = tm.PlanningMetric(cfg, 6), [tm.PlanningMetric(cfg, 6) for _ in range(2)]
    whole.update(trajs, gt, seg)
    halves[0].update(trajs[:2], gt[:2], seg[:2])
    halves[1].update(trajs[2:], gt[2:], seg[2:])
    for key in ('obj_col', 'obj_box_col', 'total'):
        np.testing.assert_array_equal(halves[0].state[key] + halves[1].state[key],
                                      whole.state[key])
    np.testing.assert_allclose(halves[0].state['l2'] + halves[1].state['l2'],
                               whole.state['l2'], rtol=1e-6)
