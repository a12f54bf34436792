"""The port's camera-parallel serving (stp3_tpu_torch/parallel/serving.py)
on the CPU: three gloo ranks (tests/torch_dist_worker.py, started once for
the module under a deadline of its own) split the 6 cameras of the tiny
flagship (fp32; the front camera fourth, so a rank other than 0 owns it)
over groups of 2 and of 3 ranks. The forward, the plan step,
``serve_step`` and ``serve_step_static`` (each rank with the column plan
of its own cameras) equal the one-process port on the same inputs, on
every rank of the group: outputs within atol 1e-5 / rtol 1e-5 (the
partial grids' sums reassociate in fp32), the refined trajectories and
the occupancy the same (tests/test_torch_serving.py and
tests/test_torch_model.py hold the one-process port to stp3_tpu). 4
cameras over 3 ranks raise on every rank before any collective.
"""
import os
import sys

import pytest
import torch

import chip_smoke
import torch_dist_worker as W
from stp3_tpu_torch.parallel.launch import run_ranks

torch.set_num_threads(2)
ATOL = RTOL = 1e-5


@pytest.fixture(scope='module')
def ranks(tmp_path_factory):
    out = str(tmp_path_factory.mktemp('cam_ranks'))
    env = dict(os.environ, PYTHONPATH=W.REPO)
    run_ranks([sys.executable, os.path.join(W.REPO, 'tests', 'torch_dist_worker.py'), 'cam',
               out], world=3, timeout_s=300, env=env)
    return [torch.load(os.path.join(out, f'rank{r}.pt'), weights_only=False)
            for r in range(3)]


@pytest.fixture(scope='module')
def want():
    cfg = W.cam_cfg()
    return W.cam_calls(chip_smoke.build_model(cfg), cfg, None)


def _assert_outputs(got: dict, ref: dict, what: str):
    assert got.keys() == ref.keys(), what
    for key, value in ref.items():
        if value is None:
            assert got[key] is None, (what, key)
            continue
        assert torch.allclose(got[key], value, atol=ATOL, rtol=RTOL), (
            what, key, (got[key] - value).abs().max().item())


def _occupancy(out):
    return torch.logical_or(out['segmentation'].argmax(-1), out['pedestrian'].argmax(-1))


@pytest.mark.parametrize('k', [2, 3])
def test_forward_and_plan_step_equal_one_process(ranks, want, k):
    for rank in range(k):
        got = ranks[rank][k]
        _assert_outputs(got['forward'], want['forward'], f'forward, rank {rank} of {k}')
        assert torch.equal(_occupancy(got['forward']), _occupancy(want['forward']))
        assert torch.allclose(got['plan'], want['plan'], atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize('mode', ['serve', 'static'])
@pytest.mark.parametrize('k', [2, 3])
def test_serve_steps_equal_one_process(ranks, want, k, mode):
    traj_w, out_w, cache_w = want[mode]
    for rank in range(k):
        traj, out, cache = ranks[rank][k][mode]
        assert torch.allclose(traj, traj_w, atol=ATOL, rtol=RTOL), (mode, rank, k)
        _assert_outputs(out, out_w, f'{mode}, rank {rank} of {k}')
        assert torch.equal(_occupancy(out), _occupancy(out_w))
        assert torch.allclose(cache, cache_w, atol=ATOL, rtol=RTOL)


def test_rank_outside_the_group_and_indivisible_splits(ranks):
    assert 2 not in ranks[2] and 3 in ranks[2]        # rank 2 sat out the group of 2
    for result in ranks:
        assert result['indivisible'] == ['4 cameras do not split over 3 shards'] * 2
