"""The port's data parallel (stp3_tpu_torch/parallel/mesh.py wired through
the trainer, the losses, BatchNorm, checkpoints and train.run) on the
CPU: two gloo ranks (tests/torch_dist_worker.py, started once for the
module under a deadline of its own) against one process on the global
batch, in float64 at TINY's widths of the Prediction stage (instance and
flow heads, so ``spatial_regression_loss`` with per-rank mask counts
that differ):

  * one train step under 'gn' and under 'bn' (REMAT 'encoder'): the loss
    terms within rtol 1e-9 of the one-process step (float64
    reassociation); every gradient after the all-reduce and the 'bn'
    running statistics within a relative L2 error of 1e-5 (and 1e-12
    absolute, for gradients that are zero but for rounding), because the
    masters, their gradients and the statistics are fp32 (PRECISION 64
    computes in float64 copies): each rank's gradient is rounded to fp32
    before the sum, and where the ranks' gradients nearly cancel (the
    uncertainty weights) only a few fp32 digits of the sum are left; each
    parameter's update within a relative L2 error of 1e-3 (Adam's first
    step moves an element by lr * g / (|g| + eps), so an element whose
    gradient is near eps = 1e-8, a cancellation of its samples' much
    larger gradients, shows that rounding in its update; 1e-6 of the
    learning rate absolute, where the gradient is zero but for rounding).
    Both ranks hold the same values, bit for bit;
  * ``spatial_regression_loss`` with a rank holding no unmasked pixel;
  * the summed validation metrics of a ragged set (5 samples over a
    global batch of 4) equal one process's: exactly where they come from
    counts (IoU), within rtol 1e-12 where from a float64 sum whose order
    of addition differs (the panoptic IoU sum);
  * ``broadcast_string``, ``coordination_barrier``, ``allreduce_host_tree``;
  * ``train.run`` on two ranks for an epoch, then a resume to a second:
    one checkpoint tree with one ``best`` pointer, the last step's losses
    within rtol 1e-5 (the fp32 masters of two steps) and the epoch metrics
    as above, against one process at the global batch (dropout off on
    both sides: the ranks' masks cannot equal one process's).

The JAX side: stp3_tpu's 'bn' under a batch-sharded jit normalises with
the global batch's statistics, which the port's ranks reproduce
(``test_jax_bn_statistics_are_global_under_a_sharded_batch``).
"""
import functools
import glob
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import torch_dist_worker as W
from stp3_tpu.layers import convolutions as jconv
from stp3_tpu_torch.parallel import mesh
from stp3_tpu_torch.parallel.launch import run_ranks
from stp3_tpu_torch.training import checkpoint as ck
from stp3_tpu_torch.training.trainer import Trainer

torch.set_num_threads(2)
RTOL = 1e-9            # float64 values
FP32_RTOL = 1e-5       # fp32 masters, gradients and statistics
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'torch_dist_worker.py')


@pytest.fixture(scope='module')
def ranks(tmp_path_factory):
    out = str(tmp_path_factory.mktemp('ranks'))
    env = dict(os.environ, PYTHONPATH=W.REPO)
    run_ranks([sys.executable, WORKER, 'train', out], world=2, timeout_s=300, env=env)
    return out, [torch.load(os.path.join(out, f'rank{r}.pt'), weights_only=False)
                 for r in range(2)]


def _close(got, want, rtol=FP32_RTOL, atol=1e-12) -> bool:
    """Relative L2 error within ``rtol``, or absolute within ``atol``."""
    got, want = got.double(), want.double()
    return (got - want).norm().item() <= rtol * want.norm().item() + atol


@pytest.mark.parametrize('norm', ['gn', 'bn'])
def test_two_ranks_take_the_global_batch_step(ranks, norm):
    _, results = ranks
    cfg = W.dp_cfg(norm)
    batch, _ = W.global_batch(cfg)
    counts = W.regression_counts(cfg, batch)
    assert counts[0] != counts[1] and min(counts) > 0     # unequal per-rank denominators
    want = W.dp_step(cfg)
    got, other = results[0][norm], results[1][norm]
    for key, value in want['loss'].items():
        assert got['loss'][key] == pytest.approx(value, rel=RTOL, abs=1e-12), key
        assert other['loss'][key] == got['loss'][key], key
    assert set(got['grads']) == set(want['grads'])
    init = dict(Trainer(cfg, device='cpu', seed=W.SEED).model.named_parameters())
    for kind in ('grads', 'params', 'stats'):
        assert set(got[kind]) == set(want[kind]), kind
        for name, tensor in want[kind].items():
            if kind == 'params':
                start = init[name].detach()
                assert _close(got[kind][name] - start, tensor - start, rtol=1e-3,
                              atol=1e-6 * float(cfg.OPTIMIZER.LR)), name
            else:
                assert _close(got[kind][name], tensor), (kind, name)
            assert torch.equal(other[kind][name], got[kind][name]), (kind, name)
    if norm == 'bn':
        assert want['stats'] and got['stats'].keys() == want['stats'].keys()


def test_regression_loss_with_a_rank_that_has_no_pixel(ranks):
    _, results = ranks
    loss, grad = W.regression_loss()
    pred, target = W.regression_case()
    assert (target[1, ..., 0] == 255).all() and (target[0, ..., 0] != 255).any()
    (l0, g0), (l1, g1) = results[0]['regression'], results[1]['regression']
    assert l1.item() == 0.0
    assert ((l0 + l1) / 2).item() == pytest.approx(loss.item(), rel=1e-12)
    # the ranks' mean loss: each rank's rows get 1/world of its own gradient
    got = torch.cat([g0, g1]) / 2
    assert torch.allclose(got, grad, rtol=1e-12, atol=0)


def _assert_metrics(got, want):
    """IoUs (of counts) equal; the panoptic and planning metrics (of float64
    sums) within rtol 1e-12."""
    assert got.keys() == want.keys()
    for key, value in want.items():
        if isinstance(value, dict):
            for k, v in value.items():
                np.testing.assert_allclose(got[key][k], v, rtol=1e-12, atol=0,
                                           err_msg=f'{key}/{k}')
        else:
            np.testing.assert_array_equal(got[key], value, err_msg=key)


def test_summed_metrics_equal_one_process(ranks):
    _, results = ranks
    want = W.val_metrics(W.dp_cfg('gn'), 4)
    for result in results:
        _assert_metrics(result['metrics'], want)


def test_broadcast_barrier_and_host_tree(ranks):
    _, results = ranks
    for result in results:
        assert result['string'] == 'from rank 0'
        tree = result['tree']
        np.testing.assert_array_equal(tree['count'], np.arange(3) * 3)
        assert tree['count'].dtype == np.int64
        assert tree['sum'] == 2.0 and tree['sum'].dtype == np.float64
        assert tree['total'] == 3


def test_train_run_on_two_ranks_writes_once_and_resumes(ranks, tmp_path, monkeypatch):
    out, results = ranks
    runs = glob.glob(os.path.join(out, 'runs', '*'))
    assert len(runs) == 1, runs                      # rank 0's directory, broadcast
    ckpt_dir = os.path.join(runs[0], 'checkpoints')
    assert sorted(os.listdir(ckpt_dir)) == ['best', 'last', 'step_2', 'step_4']
    first, second = results[0]['cli']
    assert first['last'] == ck.checkpoint_path(ckpt_dir, 2)
    assert second['start_step'] == 2 and second['step'] == 4
    assert ck.resolve_checkpoint_path(os.path.join(ckpt_dir, 'last')) == second['last']
    assert [r['step'] for r in results[1]['cli']] == [2, 4]

    monkeypatch.setattr(Trainer, 'train_step',
                        functools.partialmethod(Trainer.train_step, dropout=False))
    want = W.cli_runs(str(tmp_path), 4)
    for result in results:
        for got, ref in zip(result['cli'], want):
            assert got['step'] == ref['step']
            for key, value in ref['loss'].items():
                assert got['loss'][key] == pytest.approx(value, rel=FP32_RTOL, abs=1e-12), key
            assert got['best_iou'] == ref['best_iou']
            _assert_metrics(got['metrics'], ref['metrics'])


def test_single_process_helpers_are_identities():
    assert mesh.data_group() is None and mesh.is_main_process()
    assert mesh.broadcast_string('x') == 'x'
    mesh.coordination_barrier()
    tree = mesh.allreduce_host_tree({'a': np.arange(3)})
    np.testing.assert_array_equal(tree['a'], np.arange(3))
    assert mesh.rank_seed(7, 0) == 7 and mesh.rank_seed(7, 1) != mesh.rank_seed(7, 2)
    batch = {'x': np.arange(4), 'valid': np.ones(4, bool)}
    got = mesh.shard_batch(batch, 'cpu')
    assert torch.equal(got['x'], torch.arange(4)) and isinstance(got['valid'], np.ndarray)
    assert [b['x'].tolist() for b in mesh.prefetch_to_device([batch, batch], 'cpu')] == \
        [[0, 1, 2, 3]] * 2
    assert mesh.default_prefetch_size('cpu') == 0 and mesh.default_prefetch_size('cuda') == 2


def test_the_launcher_kills_a_group_past_its_deadline_or_after_a_failure():
    hang = [sys.executable, '-c', 'import time; time.sleep(60)']
    with pytest.raises(TimeoutError):
        run_ranks(hang, world=2, timeout_s=1)
    fail = [sys.executable, '-c', 'import os, sys, time\n'
            'if os.environ["RANK"] == "1": sys.exit(3)\ntime.sleep(60)']
    with pytest.raises(RuntimeError, match='rank 1 of 2 exited with 3'):
        run_ranks(fail, world=2, timeout_s=30)


def test_jax_bn_statistics_are_global_under_a_sharded_batch():
    """stp3_tpu's 'bn' Norm on a batch split over 2 CPU devices by a
    batch-sharded jit: its running statistics move toward the whole
    batch's statistics, not a shard's, which is what the port's ranks
    compute with their all-reduce."""
    norm = jconv.Norm(kind='bn')
    x = np.random.RandomState(0).randn(4, 3, 5, 8).astype(np.float32)
    x[2:] = x[2:] * 3.0 + 1.0                   # the two halves' statistics differ
    variables = norm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    devices = Mesh(np.asarray(jax.devices()[:2]), ('data',))
    sharded = jax.device_put(jnp.asarray(x), NamedSharding(devices, P('data')))
    assert len(sharded.sharding.device_set) == 2
    _, updates = jax.jit(lambda v, xb: norm.apply(v, xb, mutable=['batch_stats']))(
        variables, sharded)
    m = jconv._BN_MOMENTUM
    flat = x.reshape(-1, 8).astype(np.float64)
    n = flat.shape[0]
    np.testing.assert_allclose(updates['batch_stats']['mean'], m * flat.mean(0),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(updates['batch_stats']['var'],
                               (1 - m) + m * flat.var(0) * n / (n - 1), rtol=1e-5, atol=1e-6)
    half = x[:2].reshape(-1, 8).mean(0)
    assert not np.allclose(updates['batch_stats']['mean'], m * half, rtol=1e-2)
