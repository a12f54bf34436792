"""Whole runs of each cell at tiny widths on the CPU (the harness's look
for a card skipped): the port against the reference, and the faults and
the control that must make ``correct`` false."""
import json

import pytest
import torch

from cardbench import harness, tiny

SEED = 2 ** 31 + 977                    # larger than 32 signed bits hold


def run(root, cell, capsys, seconds=0.5):
    rc = harness.run(cell, SEED, seconds, False, root, device='cpu')
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize('cell', ['nusc_plan_serve_b1', 'carla_agent_tick', 'nusc_plan_train_b2'])
def test_port_matches_reference_at_tiny_widths(tmp_path, capsys, cell):
    """fp32 on the CPU: the port's plain path is the reference's function."""
    result = run(tiny.tiny_root(str(tmp_path), cell), cell, capsys)
    assert result['correct'] and result['attempted'] > 0
    assert list(result)[-1] == 'checks'
    for name, check in result['checks'].items():
        assert check['value'] <= 1e-4, name
    assert set(result['metrics']) == {m['name'] for m in harness.load_cell(cell)['end_to_end']}


def shifted(fn, key, by=0.5):
    """``fn`` with its answer ``key`` (an index or a dict key) moved."""
    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        if isinstance(out, dict):
            return {**out, key: out[key] + by}
        out = list(out)
        out[key] = out[key] + by
        return tuple(out)
    return wrapper


@pytest.mark.parametrize('head', ['segmentation', 'pedestrian', 'hdmap', 'costvolume'])
def test_serve_head_altered_is_incorrect(tmp_path, capsys, monkeypatch, head):
    from stp3_tpu_torch.models.stp3 import STP3
    monkeypatch.setattr(STP3, 'forward', shifted(STP3.forward, head))
    result = run(tiny.tiny_root(str(tmp_path), 'nusc_plan_serve_b1'), 'nusc_plan_serve_b1',
                 capsys)
    assert not result['correct']


def test_serve_trajectory_altered_is_incorrect(tmp_path, capsys, monkeypatch):
    from stp3_tpu_torch.models.stp3 import STP3
    monkeypatch.setattr(STP3, 'plan', shifted(STP3.plan, 1))
    result = run(tiny.tiny_root(str(tmp_path), 'nusc_plan_serve_b1'), 'nusc_plan_serve_b1',
                 capsys)
    assert not result['correct']
    assert result['checks']['plan_m']['value'] >= 0.5


@pytest.mark.parametrize('fault', ['trajectory altered', 'head altered', 'control altered'])
def test_agent_fault_is_incorrect(tmp_path, capsys, monkeypatch, fault):
    from stp3_tpu_torch.deploy import agent_core
    from stp3_tpu_torch.models.stp3 import STP3
    if fault == 'trajectory altered':
        monkeypatch.setattr(STP3, 'serve_step_static', shifted(STP3.serve_step_static, 0))
    elif fault == 'head altered':
        def tail(self, *args, _tail=STP3._serve_tail):
            traj, out, cache = _tail(self, *args)
            return traj, {**out, 'costvolume': out['costvolume'] * 1.5}, cache
        monkeypatch.setattr(STP3, '_serve_tail', tail)
    else:
        monkeypatch.setattr(agent_core, 'control_pid', shifted(agent_core.control_pid, 0, 0.1))
    result = run(tiny.tiny_root(str(tmp_path), 'carla_agent_tick'), 'carla_agent_tick', capsys)
    assert not result['correct']


def test_train_step_leaving_state_unchanged_is_incorrect(tmp_path, capsys, monkeypatch):
    from stp3_tpu_torch.training.trainer import Trainer
    monkeypatch.setattr(Trainer, '_update', lambda self: None)
    result = run(tiny.tiny_root(str(tmp_path), 'nusc_plan_train_b2'), 'nusc_plan_train_b2',
                 capsys)
    assert not result['correct']
    assert result['checks']['change_gap']['value'] > 0.9       # nothing moved


def test_train_step_on_half_the_batch_is_incorrect(tmp_path, capsys, monkeypatch):
    from stp3_tpu_torch.training.trainer import Trainer
    loss_fn = Trainer.loss_fn

    def half(self, batch, *args, **kwargs):
        rows = {k: v[: v.shape[0] // 2] if torch.is_tensor(v) and v.ndim else v
                for k, v in batch.items()}
        return loss_fn(self, rows, *args, **kwargs)
    monkeypatch.setattr(Trainer, 'loss_fn', half)
    result = run(tiny.tiny_root(str(tmp_path), 'nusc_plan_train_b2'), 'nusc_plan_train_b2',
                 capsys)
    assert not result['correct']


def test_train_loss_term_altered_is_incorrect(tmp_path, capsys, monkeypatch):
    from stp3_tpu_torch.training.trainer import Trainer
    losses = Trainer._compute_losses

    def altered(self, *args, **kwargs):
        terms = losses(self, *args, **kwargs)
        return {**terms, 'segmentation': terms['segmentation'] * 1.1}
    monkeypatch.setattr(Trainer, '_compute_losses', altered)
    result = run(tiny.tiny_root(str(tmp_path), 'nusc_plan_train_b2'), 'nusc_plan_train_b2',
                 capsys)
    assert not result['correct']


def control_fails(root, cell, device, seed) -> bool:
    spec = harness.load_cell(cell, root)
    module = harness.entry_module(spec['workload']['entry'], root)
    numbers = module.control(spec, seed, device, [0, 1])
    checks = [(k, numbers[k], float(v)) for k, v in spec['workload']['limits'].items()]
    return not harness.checks_correct(checks)


def test_control_is_incorrect_at_tiny_widths(tmp_path):
    """The control (the reference in fp8 below the stated bf16) serving in
    the port's place fails the serving cell's limits, at tiny widths on
    the CPU."""
    root = tiny.tiny_root(str(tmp_path), 'nusc_plan_serve_b1', precision='bf16')
    assert control_fails(root, 'nusc_plan_serve_b1', torch.device('cpu'), SEED)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')
    return torch.device('cuda', 0)


@pytest.mark.gpu
@pytest.mark.parametrize('cell', ['nusc_plan_serve_b1', 'carla_agent_tick', 'nusc_plan_train_b2'])
def test_control_is_incorrect_at_the_cells_size(card, cell):
    """On the card, at the cell's own size: the control (fp8 below bf16,
    TF32 below fp32) in the port's place fails the cell's limits."""
    assert control_fails(harness.ROOT, cell, card, SEED)


@pytest.mark.gpu
@pytest.mark.parametrize('fault', ['state unchanged', 'half batch'])
def test_fault_in_the_replayed_train_step_is_incorrect(card, fault):
    """On the card, at the cell's own size: each fault planted in the port's
    trainer, so that the graphs the window replays hold it, fails the
    training cell's limits."""
    spec = harness.load_cell('nusc_plan_train_b2')
    module = harness.entry_module('train')
    with module.planted(fault):
        entry = module.Entry(spec, SEED, card)
        kept = entry.evidence({})
        entry.release()
        del entry
    assert not harness.checks_correct(module.judge(spec, SEED, card, kept))
