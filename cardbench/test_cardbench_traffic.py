"""Traffic and counts: the same seed gives the same traffic and every seed
the same sizes; the FLOP and byte counts against hand counts."""
import json
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cardbench import generate, harness
from cardbench.counts import flops, kernels
from cardbench.peaks import bound_s

HERE = os.path.dirname(os.path.abspath(__file__))
CPU = torch.device('cpu')
BIG = 2 ** 31 + 5


def small(cell: str):
    spec = harness.load_cell(cell)
    model = dict(spec['config']['model'], final_dim=[16, 32], sample_num=6)
    traffic = dict(spec['traffic'])
    if 'pool' in traffic and traffic['kind'] != 'carla_route':
        traffic.update(pool=2)
    return traffic, model


def same(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    return np.array_equal(np.asarray(a), np.asarray(b))


def shapes(a):
    if isinstance(a, dict):
        return {k: shapes(v) for k, v in a.items()}
    if isinstance(a, (list, tuple)):
        return [shapes(x) for x in a]
    return tuple(np.shape(a))


def make(kind_cell, seed):
    traffic, model = small(kind_cell)
    if traffic['kind'] == 'camera_sets':
        return generate.camera_sets(traffic, model, seed, CPU, torch.float32)
    if traffic['kind'] == 'carla_route':
        return generate.carla_route(dict(traffic, pool=2), model, seed, CPU, 50)
    return generate.train_batches(traffic, model, seed, CPU)


@pytest.mark.parametrize('cell', ['nusc_plan_serve_b1', 'carla_agent_tick', 'nusc_plan_train_b2'])
def test_traffic_is_a_function_of_the_seed(cell):
    a, b, c = make(cell, BIG), make(cell, BIG), make(cell, BIG + 1)
    assert same(a, b)
    assert not same(a, c)
    assert shapes(a) == shapes(c)


def test_candidates_are_sorted_for_the_command_thirds():
    traffic, model = small('nusc_plan_serve_b1')
    trajs = generate.camera_sets(traffic, model, 3, CPU, torch.float32)['trajs']
    last = trajs[:, 0, :, -1, 0]
    assert torch.all(last[:, 1:] >= last[:, :-1])


def test_k1_and_k3_byte_counts_by_hand():
    # 2 frames of 4 points in a grid of 5 cells, 8 channels; rank 5 drops
    ranks = torch.tensor([[0, 0, 3, 5], [1, 2, 2, 2]])
    n_bytes, ops = kernels.k1_splat(ranks, 5, 8, 2)
    landed, cells = 7, 2 + 2
    assert ops == landed * 8
    assert n_bytes == landed * 8 * 2 + 8 * 4 + cells * 8 * 4
    n_bytes, ops = kernels.k3_gather(ranks, 5, 8, 2)
    assert (n_bytes, ops) == ((cells + 8) * 8 * 2 + 8 * 4, 0.0)


def test_k2_counts_by_hand():
    n_bytes, ops = kernels.k2_mlp(100, 64, 2)
    assert ops == 2 * 2 * 100 * 64 * 256
    assert n_bytes == 3 * 100 * 64 * 2 + 2 * 64 * 256 * 2 + 8 * 64 * 4
    assert bound_s(n_bytes, ops, 'bf16') == max(n_bytes / 3.35e12, ops / 989e12)


def test_flops_of_the_reference_by_hand():
    """One 3x3 convolution of 16 to 32 channels over 8x8 counts 2 x 9 x 16
    x 32 x 64 (the counter the model counts use), and the train step is
    three forwards."""
    from torch.utils.flop_counter import FlopCounterMode
    x, w = torch.zeros(1, 16, 8, 8, device='meta'), torch.zeros(32, 16, 3, 3, device='meta')
    with FlopCounterMode(display=False) as counter:
        F.conv2d(x, w, padding=1)
    assert counter.get_total_flops() == 2 * 9 * 16 * 32 * 64
    model = json.load(open(os.path.join(HERE, 'configs', 'nuscenes_planning.json')))['model']
    model = dict(model, final_dim=[32, 64], encoder_name='efficientnet-b0', gru_state_size=8)
    serve = flops.serve_step(model, 2)
    assert serve > 0
    assert flops.train_step(model, 2, 2) == pytest.approx(3 * 2 * serve, rel=0.02)
