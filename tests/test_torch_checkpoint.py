"""The port's checkpoints (stp3_tpu_torch/training/checkpoint.py) on the
CPU, at TINY's widths: save -> load is bit-equal (weights, 'bn' running
statistics, Adam, generator, step); 2 steps + save + resume + 2 steps
equal 4 straight steps to the bit; an unstamped directory is refused;
the caller's metrics cannot overwrite the version stamp; the warm start
drops the decoder; split_frozen_bn / merge_bn_to_frozen round-trip a
'bn' model into 'bn_frozen' (and split the same entries as the JAX
package's split_frozen_bn splits in its tree).
"""
import json
import os

import numpy as np
import pytest
import torch

import torch_fixtures
from stp3_tpu_torch.models.stp3 import STP3, STP3Config
from stp3_tpu_torch.training import checkpoint as ck
from stp3_tpu_torch.training.trainer import Trainer
from torch_jax_steps import inputs_of, jax_model, jax_norm_defaults, seeded_variables

torch.set_num_threads(2)
assert jax_norm_defaults            # the autouse fixture, imported to take effect here

CASES = {
    # the latent draw and dropout come from the trainer's generator
    'planning': lambda: torch_fixtures.planning_cfg(tiny=True),
    # 'bn': running statistics move every step
    'perception_bn': lambda: torch_fixtures.stage_cfg('perception', True,
                                                      {'MODEL': {'NORM': 'bn'}}),
}


def _state_equal(a, b):
    """Nested state dicts (tensors, numbers, lists) equal to the bit."""
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b)
    if isinstance(a, dict):
        return set(a) == set(b) and all(_state_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_state_equal(x, y) for x, y in zip(a, b))
    return a == b


def _assert_same_training_state(t1, t2):
    assert t1.step == t2.step
    assert _state_equal(t1.model.state_dict(), t2.model.state_dict())
    assert _state_equal(t1.optimizer.state_dict(), t2.optimizer.state_dict())
    assert torch.equal(t1.generator.get_state(), t2.generator.get_state())


def _save(trainer, ckpt_dir, metrics=None):
    return ck.save_checkpoint(ckpt_dir, trainer.step, trainer.model.state_dict(),
                              trainer.optimizer.state_dict(), trainer.cfg.convert_to_dict(),
                              trainer.generator.get_state(), metrics)


@pytest.mark.parametrize('case', sorted(CASES))
def test_save_load_round_trip_is_bit_equal(case, tmp_path):
    cfg = CASES[case]()
    trainer = Trainer(cfg, device='cpu', seed=0)
    batch, = torch_fixtures.synthetic_batches(cfg, 1, 'cpu')
    trainer.train_step(batch)
    path = _save(trainer, str(tmp_path))
    state = ck.load_checkpoint(path)
    assert state['step'] == 1
    assert _state_equal(state['model'], trainer.model.state_dict())
    assert _state_equal(state['optimizer'], trainer.optimizer.state_dict())
    assert torch.equal(state['generator'], trainer.generator.get_state())
    if case == 'perception_bn':
        assert any(k.endswith('.mean') for k in state['model'])
    assert ck.load_config_dict(path) == json.loads(json.dumps(cfg.convert_to_dict()))
    # the same checkpoint through its root, its 'last' pointer and the step directory
    for ref in (str(tmp_path), os.path.join(str(tmp_path), 'last'), path):
        assert ck.resolve_checkpoint_path(ref) == path


@pytest.mark.parametrize('case', sorted(CASES))
def test_resume_equals_uninterrupted(case, tmp_path):
    """Dropout on: the generator's state decides the masks (and the
    Planning stage's latent draw) of the steps after the resume."""
    cfg = CASES[case]()
    batches = torch_fixtures.synthetic_batches(cfg, 4, 'cpu')
    straight = Trainer(cfg, device='cpu', seed=0)
    for batch in batches[:2]:
        straight.train_step(batch)
    path = _save(straight, str(tmp_path))
    for batch in batches[2:]:
        straight.train_step(batch)
    resumed = Trainer(cfg, device='cpu', seed=1)           # other weights, other generator
    assert ck.restore_train_state(path, resumed) == 2
    for batch in batches[2:]:
        resumed.train_step(batch)
    _assert_same_training_state(resumed, straight)


def test_unstamped_and_newer_checkpoints_are_refused(tmp_path):
    trainer = Trainer(torch_fixtures.planning_cfg(tiny=True), device='cpu', seed=0)
    path = _save(trainer, str(tmp_path))
    os.remove(os.path.join(path, 'meta.json'))
    with pytest.raises(ValueError, match='no meta.json format stamp'):
        ck.load_checkpoint(path)
    with pytest.raises(ValueError, match='no meta.json format stamp'):
        ck.restore_train_state(str(tmp_path), trainer)
    with open(os.path.join(path, 'meta.json'), 'w') as f:
        json.dump({'format_version': ck.FORMAT_VERSION + 1, 'step': 0}, f)
    with pytest.raises(ValueError, match='format_version'):
        ck.load_checkpoint(path)


def test_caller_metrics_cannot_overwrite_the_version_stamp(tmp_path):
    trainer = Trainer(torch_fixtures.planning_cfg(tiny=True), device='cpu', seed=0)
    trainer.step = 7
    path = _save(trainer, str(tmp_path), {'format_version': 99, 'step': -1, 'best_iou': 0.25,
                                          'per_class': np.array([0.5, 0.75])})
    meta = ck.load_meta(path)
    assert meta['format_version'] == ck.FORMAT_VERSION and meta['step'] == 7
    assert meta['metrics'] == {'format_version': 99, 'step': -1, 'best_iou': 0.25,
                               'per_class': [0.5, 0.75]}
    assert ck.load_checkpoint(path)['step'] == 7


def test_warm_start_drops_the_decoder_and_mismatched_entries():
    """A Planning-stage init warm-started from a Perception-stage model:
    every shared entry of the same shape but the decoder's comes from
    the Perception weights; the decoder, the entries Perception lacks and
    those of another shape (a wider temporal model here) keep their init."""
    plan_cfg = torch_fixtures.planning_cfg(tiny=True)
    perc_cfg = torch_fixtures.stage_cfg('perception', True,
                                        {'MODEL': {'TEMPORAL_MODEL': {'START_OUT_CHANNELS': 24}}})
    init = Trainer(plan_cfg, device='cpu', seed=0).model.state_dict()
    restored = Trainer(perc_cfg, device='cpu', seed=1).model.state_dict()
    merged, n = ck.filter_warm_start_params(restored, init)
    assert set(merged) == set(init)
    taken = {k for k in init if k in restored and 'decoder' not in k.lower()
             and restored[k].shape == init[k].shape}
    assert n == len(taken) > 0
    assert any(k.startswith('decoder.') for k in init)
    assert any(k in restored and restored[k].shape != init[k].shape for k in init)
    for k, v in merged.items():
        assert v is (restored[k] if k in taken else init[k]), k
    model = STP3(STP3Config.from_cfg(plan_cfg))
    model.load_state_dict(merged)


def test_split_and_merge_bn_round_trip_into_bn_frozen():
    """A 'bn' model after a train step (its running statistics moved):
    split into parameters and statistics, merged back and loaded strictly
    into a 'bn_frozen' model, whose eval forward equals the 'bn' model's
    on its running statistics."""
    cfg = CASES['perception_bn']()
    trainer = Trainer(cfg, device='cpu', seed=0)
    batch, = torch_fixtures.synthetic_batches(cfg, 1, 'cpu')
    trainer.train_step(batch)
    state = trainer.model.state_dict()
    params, stats = ck.split_frozen_bn(state)
    n_sites = sum(1 for m in trainer.model.modules() if getattr(m, 'kind', None) == 'bn')
    assert len(stats) == 2 * n_sites > 0 and not set(params) & set(stats)
    assert all(k.endswith(('.mean', '.var')) for k in stats)
    frozen_cfg = cfg.clone()
    frozen_cfg.MODEL.NORM = 'bn_frozen'
    frozen = STP3(STP3Config.from_cfg(frozen_cfg))
    frozen.load_state_dict(ck.merge_bn_to_frozen(params, stats))
    with pytest.raises(KeyError):
        ck.merge_bn_to_frozen(state, stats)
    inputs = [batch[k] for k in ('image', 'intrinsics', 'extrinsics', 'future_egomotion')]
    from stp3_tpu_torch.utils.network import prepare_image
    inputs[0] = prepare_image(inputs[0], torch.float32)
    trainer.model.eval()
    frozen.eval()
    with torch.no_grad():
        want, got = trainer.model(*inputs), frozen(*inputs)
    for key in ('segmentation', 'pedestrian', 'hdmap'):
        assert torch.equal(got[key], want[key]), key


def test_split_frozen_bn_splits_the_entries_jax_splits():
    """The port's split of a 'bn_frozen' state_dict against the JAX
    package's split of the same model's flax tree (names up to the
    separator)."""
    from stp3_tpu.training.checkpoint import split_frozen_bn as jax_split
    from stp3_tpu_torch.utils.from_flax import flatten_tree
    cfg = torch_fixtures.stage_cfg('perception', True, {'MODEL': {'NORM': 'bn_frozen'}})
    jm, _ = jax_model(cfg)
    variables = seeded_variables(jm, inputs_of(cfg))
    jparams, jstats = jax_split(variables['params'])
    params, stats = ck.split_frozen_bn(STP3(STP3Config.from_cfg(cfg)).state_dict())
    as_names = lambda tree: {k.replace('/', '.') for k in flatten_tree(tree)}  # noqa: E731
    assert set(stats) == as_names(jstats)
    assert set(params) == as_names(jparams)
