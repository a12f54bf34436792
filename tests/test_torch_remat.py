"""MODEL.REMAT in the port, on the CPU: every stage tag changes what the
backward stores, never what it computes.

The tiny Planning stage (chip_smoke.planning_cfg(tiny=True): fp32, a
GAUSSIAN latent, 2 future frames, a planner) under MODEL.NORM 'bn', one
synthetic batch, dropout on and the latent drawn from the trainer's
generator. From one seeded init, the step under each tag (and under
compositions of tags) must equal the step under REMAT 'none' bit for bit
on the CPU: every loss term, every gradient, every 'bn' running
statistic (updated once, not again in a recomputation) and the
generator's state after the step (the recomputation replays its draws
and leaves it where the forward did). The port's 'none' step itself is
held to the JAX package's by tests/test_torch_train.py.

The refusals are the JAX package's, with its exception types
(stp3_tpu/models/stp3.py:266-285; tests/test_model.py): each bad
configuration is built by both packages.
"""
import copy

import jax
import numpy as np
import pytest
import torch

from chip_smoke import planning_cfg, running_stats, stage_cfg, synthetic_batches
from stp3_tpu.config import get_cfg as jax_get_cfg
from stp3_tpu.models.stp3 import STP3 as JSTP3
from stp3_tpu.models.stp3 import STP3Config as JSTP3Config
from stp3_tpu_torch.layers.base import init_parameters
from stp3_tpu_torch.models import stp3 as stp3_module
from stp3_tpu_torch.models.stp3 import STP3, STP3Config
from stp3_tpu_torch.training.trainer import Trainer
from test_torch_stages import jax_norm_defaults

assert jax_norm_defaults            # the autouse fixture, imported to take effect here

torch.set_num_threads(2)

TAGS = ('encoder', 'temporal', 'future', 'decoder', 'cells', 'gates',
        'encoder+temporal+decoder+cells', 'future+cells')


def _cfg(remat: str):
    cfg = planning_cfg(tiny=True)
    cfg.MODEL.NORM = 'bn'
    cfg.MODEL.REMAT = remat
    return cfg


def _step(remat: str, weights, batch):
    """(loss terms, gradients, running statistics, generator state) of one
    step without the optimizer, from ``weights``."""
    model = STP3(STP3Config.from_cfg(_cfg(remat)))
    model.load_state_dict(weights)
    trainer = Trainer(_cfg(remat), device='cpu', model=model)
    loss = trainer.compute_gradients(batch)
    grads = {n: p.grad.clone() for n, p in trainer.model.named_parameters()}
    return loss, grads, running_stats(trainer.model), trainer.generator.get_state()


@pytest.fixture(scope='module')
def reference():
    cfg = _cfg('none')
    init = init_parameters(STP3(STP3Config.from_cfg(cfg)), torch.Generator().manual_seed(0))
    weights = copy.deepcopy(init.state_dict())
    batch, = synthetic_batches(cfg, 1, 'cpu')
    return weights, batch, running_stats(init), _step('none', weights, batch)


@pytest.mark.parametrize('remat', TAGS)
def test_remat_step_equals_the_step_without(reference, remat):
    weights, batch, start, (loss_n, grads_n, stats_n, gen_n) = reference
    loss, grads, stats, gen = _step(remat, weights, batch)
    assert loss.keys() == loss_n.keys()
    for k, v in loss_n.items():
        assert torch.equal(loss[k], v), (k, loss[k], v)
    assert grads.keys() == grads_n.keys()
    differ = [n for n, g in grads_n.items() if not torch.equal(grads[n], g)]
    assert not differ, differ
    moved = [n for n, b in stats_n.items() if not torch.equal(b, start[n])]
    assert len(moved) > len(start) // 2, 'the bn running statistics did not move in the step'
    differ = [n for n, b in stats_n.items() if not torch.equal(stats[n], b)]
    assert not differ, differ
    assert torch.equal(gen, gen_n)


def test_gates_saves_the_convolutions_and_matmuls_of_the_future_stage(reference, monkeypatch):
    """The 'gates' policy sees the future stage's convolutions and matmuls
    and marks them saved; everything else is recomputed."""
    seen, save_conv_dot = [], stp3_module._save_conv_dot

    def policy(ctx, op, *args, **kwargs):
        decision = save_conv_dot(ctx, op, *args, **kwargs)
        if not ctx.is_recompute:
            seen.append((op, decision))
        return decision

    monkeypatch.setattr(stp3_module, '_save_conv_dot', policy)
    weights, batch, *_ = reference
    _step('gates', weights, batch)
    saved = {str(op) for op, d in seen if d == torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE}
    assert 'aten.convolution.default' in saved, saved
    assert saved <= {str(op) for op in stp3_module._CONV_DOT}
    n_recomputed = sum(d != torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE for _, d in seen)
    assert n_recomputed > len(seen) // 2


# (overrides of the perception / planning stage, the exception, its message)
REFUSALS = (
    ('perception', {'MODEL': {'REMAT': 'encoder+future'}}, ValueError, 'N_FUTURE_FRAMES'),
    ('perception', {'MODEL': {'REMAT': 'temporal', 'TEMPORAL_MODEL': {'NAME': 'identity'}}},
     ValueError, "'temporal' has no effect"),
    ('planning', {'MODEL': {'REMAT': 'gates+cells'}}, ValueError, "'gates'"),
    ('planning', {'MODEL': {'REMAT': 'encoder+attention'}}, NotImplementedError,
     'MODEL.REMAT stages'),
)


@pytest.mark.parametrize('stage,override,exc,match', REFUSALS,
                         ids=['no-future', 'identity', 'gates+cells', 'unknown'])
def test_refusals_are_the_jax_packages(stage, override, exc, match):
    cfg = (stage_cfg('perception', True, override) if stage == 'perception'
           else planning_cfg(tiny=True))
    if stage == 'planning':
        cfg.MODEL.REMAT = override['MODEL']['REMAT']
    with pytest.raises(exc, match=match):
        STP3(STP3Config.from_cfg(cfg))
    jcfg = jax_get_cfg(cfg_dict=cfg.convert_to_dict())
    rf, n = jcfg.TIME_RECEPTIVE_FIELD, len(jcfg.IMAGE.NAMES)
    h, w = jcfg.IMAGE.FINAL_DIM
    zeros = np.zeros
    with pytest.raises(exc, match=match):
        JSTP3(JSTP3Config.from_cfg(jcfg)).lazy_init(
            jax.random.PRNGKey(0), zeros((1, rf, n, h, w, 3), np.float32),
            zeros((1, rf, n, 3, 3), np.float32), zeros((1, rf, n, 4, 4), np.float32),
            zeros((1, rf, 6), np.float32), train=False)
