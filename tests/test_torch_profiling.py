"""The port's training tooling on the CPU: the Kalman filter against the
JAX package's, ``timed``, and around a tiny ``train.run`` (TINY's widths,
the Planning stage's switches, fp32, synthetic 'mini' data, one epoch of
5 steps): the ``PROFILE.ENABLED`` trace of exactly the JAX CLI's window
(steps 2 .. 1 + PROFILE.STEPS), the TensorBoard event file's tags (the
JAX CLI's, with VIS_INTERVAL 1), and ``DEBUG.NAN_CHECK``'s stop before
the update."""
import glob
import json
import os
import re

import numpy as np
import pytest
import torch

import chip_smoke
from stp3_tpu.utils.kalman import KalmanFilter as JKalmanFilter
from stp3_tpu_torch import train as ttrain
from stp3_tpu_torch.training.trainer import Trainer
from stp3_tpu_torch.utils import profiling
from stp3_tpu_torch.utils.kalman import KalmanFilter, KalmanState

torch.set_num_threads(2)


def test_kalman_filter_equals_jax():
    """A constant-velocity 2-D track, 40 noisy position readings."""
    rng = np.random.RandomState(0)
    dt = 0.5
    f = np.eye(4, dtype=np.float32)
    f[0, 2] = f[1, 3] = dt
    h = np.eye(2, 4, dtype=np.float32)
    q = (0.01 * np.eye(4)).astype(np.float32)
    r = (0.25 * np.eye(2)).astype(np.float32)
    zs = (np.cumsum(np.full((40, 2), [1.0, 0.5]) * dt, 0)
          + 0.5 * rng.randn(40, 2)).astype(np.float32)
    x0, p0 = np.zeros(4, np.float32), np.eye(4, dtype=np.float32)
    kf, jkf = KalmanFilter(f, h, q, r), JKalmanFilter(f, h, q, r)
    (x, p), xs = kf.filter(kf.init(x0, p0), zs)
    (jx, jp), jxs = jkf.filter(jkf.init(x0, p0), zs)
    assert xs.shape == (40, 4)
    np.testing.assert_allclose(xs.numpy(), np.asarray(jxs), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(p.numpy(), np.asarray(jp), rtol=1e-6, atol=1e-6)
    one = kf.update(kf.predict(KalmanState(torch.from_numpy(x0), torch.from_numpy(p0))), zs[0])
    np.testing.assert_allclose(one.x.numpy(), xs[0].numpy(), rtol=0, atol=0)


def test_timed_nan_guard_and_no_server():
    calls = []
    ms, out = profiling.timed(lambda a, b=0: calls.append(a + b) or a + b, 2, b=3, n=5,
                              warmup=2)
    assert out == 5 and len(calls) == 7 and ms >= 0.0
    x = torch.zeros(3, requires_grad=True)
    with pytest.raises(RuntimeError, match='nan'):
        with profiling.nan_guard():
            torch.sqrt(x - 1.0).sum().backward()
    with pytest.raises(NotImplementedError, match='torch.profiler'):
        profiling.start_server()


def _cfg():
    return chip_smoke.make_cfg(chip_smoke.PLANNING_STAGE, chip_smoke.TINY, {'PRECISION': 32},
                               {'DATASET': {'NAME': 'synthetic', 'VERSION': 'mini',
                                            'VAL_SAMPLES': 3},
                                'N_WORKERS': 0, 'EPOCHS': 1})


@pytest.fixture(scope='module')
def profiled_run(tmp_path_factory):
    """One epoch (5 steps) with PROFILE.ENABLED (2 steps) and VIS_INTERVAL 1."""
    cfg = _cfg()
    cfg.PROFILE.ENABLED = True
    cfg.PROFILE.STEPS = 2
    cfg.VIS_INTERVAL = 1
    save_dir = str(tmp_path_factory.mktemp('run'))
    lines = []
    record = ttrain.run(cfg, 'cpu', save_dir, log=lines.append)
    return record, lines


def test_profile_traces_the_jax_window(profiled_run):
    record, lines = profiled_run
    trace, = glob.glob(os.path.join(record['save_dir'], 'profile', '*.pt.trace.json'))
    with open(trace) as f:
        names = {e.get('name', '') for e in json.load(f)['traceEvents']}
    steps = {int(m.group(1)) for n in names for m in [re.fullmatch(r'train_step_(\d+)', n)]
             if m}
    assert steps == {2, 3}
    assert any(n.startswith('aten::convolution') for n in names)
    assert record['step'] == 5
    assert f'profiler trace written to {os.path.dirname(trace)}' in lines


def test_event_file_holds_the_jax_cli_tags(profiled_run):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator
    record, _ = profiled_run
    events = EventAccumulator(record['save_dir'])
    events.Reload()
    scalars = set(events.Tags()['scalars'])
    want = {f'step_train_loss_{k}' for k in record['loss']}
    for k, v in record['metrics'].items():
        for name, value in (v.items() if isinstance(v, dict) else [(None, v)]):
            prefix = f'{k}/{name}' if name else k
            arr = np.asarray(value)
            want |= ({f'epoch_val_{prefix}'} if arr.size == 1 else
                     {f'epoch_val_{prefix}/{i}' for i in range(arr.size)})
    # the JAX model's scalar '*_weight' leaves for these switches
    want |= {f'epoch_{n}_weight' for n in ('segmentation', 'pedestrian', 'hdmap', 'planning')}
    assert {'step_train_loss_total', 'epoch_val_iou_vehicle/1'} <= want
    assert any(t.startswith('epoch_val_planning/') for t in want)
    assert scalars == want
    steps = {e.step for e in events.Scalars('step_train_loss_total')}
    assert steps == {1, 2, 3}
    weight = events.Scalars('epoch_planning_weight')[0]
    model_w = float(torch.load(os.path.join(record['last'], 'state.pt'),
                               weights_only=True)['model']['planning_weight'])
    assert weight.step == 5 and np.isclose(weight.value, 1 / (2 * np.exp(model_w)))


def test_nan_check_stops_before_the_update():
    """One clean step, then a batch with one NaN pixel: FloatingPointError
    naming a loss term, with the parameters, Adam's state and the step
    count as the clean step left them."""
    cfg = chip_smoke.planning_cfg(tiny=True)
    cfg.DEBUG.NAN_CHECK = True
    trainer = Trainer(cfg, device='cpu')
    batch, = chip_smoke.synthetic_batches(cfg, 1, 'cpu')
    trainer.train_step(batch)
    params = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
    adam = trainer.optimizer.state_dict()
    adam = {i: {k: v.clone() for k, v in s.items()} for i, s in adam['state'].items()}
    bad = dict(batch)
    bad['image'] = batch['image'].clone().float()
    bad['image'][0, 0, 0, 3, 5, 1] = float('nan')
    with pytest.raises(FloatingPointError, match="NaN in loss term '.*' at step 2"):
        trainer.train_step(bad)
    assert trainer.step == 1
    for n, p in trainer.model.named_parameters():
        assert torch.equal(p, params[n]), n
    after = trainer.optimizer.state_dict()['state']
    assert after.keys() == adam.keys()
    for i, s in adam.items():
        for k, v in s.items():
            assert torch.equal(after[i][k], v), (i, k)
    cfg.DEBUG.NAN_CHECK = False
    trainer.train_step(bad)          # without the check the NaN reaches the weights
    assert any(torch.isnan(p).any() for p in trainer.model.parameters())
