"""LIFT.GT_DEPTH in the port against the JAX package, on the CPU: the
depth label (every DOWNSAMPLE-th pixel of the past frames' depth map,
clipped into D_BOUND, as a bin index), the depth loss on the encoder's
depth logits with its homoscedastic-uncertainty weight ``depths_weight``,
and that weight across both weight bridges.

The train step is the Perception stage's at TINY's widths and receptive
field of 2 with GT_DEPTH on, from seeded weights, on one synthetic batch
of two (its 'depths' from the JAX package's synthetic data), in float64
on both sides (tests/torch_jax_steps.py): every loss term at rtol 1e-5,
every gradient at a relative L2 error below 1e-4, as the stage steps of
tests/test_torch_stages.py.
"""
import numpy as np
import pytest
import torch

import chip_smoke
from stp3_tpu.datas.synthetic import SyntheticDataset, collate
from stp3_tpu.training.trainer import Trainer as JTrainer
from stp3_tpu.utils import torch_import as jti
from stp3_tpu_torch.models.stp3 import STP3, STP3Config
from stp3_tpu_torch.utils import torch_import as ti
from stp3_tpu_torch.utils.from_flax import load_flax_params, to_flax
from torch_jax_steps import (assert_gradients_match, jax_model, jax_norm_defaults,
                             jax_train_step, port_float64_step, port_grads, seeded_variables)

torch.set_num_threads(2)
assert jax_norm_defaults            # the autouse fixture, imported to take effect here

FORWARD_KEYS = ('image', 'intrinsics', 'extrinsics', 'future_egomotion')


def gt_depth_cfg():
    return chip_smoke.stage_cfg('perception', True, {'TIME_RECEPTIVE_FIELD': 2},
                                {'LIFT': {'GT_DEPTH': True}})


@pytest.fixture(scope='module')
def gt_depth_step():
    cfg = gt_depth_cfg()
    jm, jcfg = jax_model(cfg)
    ds = SyntheticDataset(jcfg, n_samples=2, seed=0)
    batch = collate([ds[0], ds[1]])
    assert batch['depths'].shape == (2, 2, 2, 32, 64)
    variables = seeded_variables(jm, [batch[k][:1] for k in FORWARD_KEYS])
    variables['params']['depths_weight'] = np.asarray(0.3, np.float32)   # off its zero init
    jtr = JTrainer(jcfg)
    total_j, loss_j, grads_j, _ = jax_train_step(jtr, variables['params'], batch)
    total_t, loss_t, grads_t, tr = port_float64_step(cfg, variables, batch)
    labels_j = jtr.prepare_future_labels({k: np.asarray(v) for k, v in batch.items()})
    labels_t = tr.prepare_future_labels({k: torch.as_tensor(v) for k, v in batch.items()})
    return dict(loss_j=loss_j, total_j=total_j, total_t=total_t, loss_t=loss_t,
                grads_t=grads_t, grads_j=port_grads(tr.model, grads_j),
                depths_j=np.asarray(labels_j['depths']), depths_t=labels_t['depths'].numpy())


def test_depth_label_matches_jax(gt_depth_step):
    s = gt_depth_step
    assert s['depths_t'].dtype == np.int32 and s['depths_t'].shape == (2, 2, 2, 4, 8)
    np.testing.assert_array_equal(s['depths_t'], s['depths_j'])


def test_gt_depth_loss_terms_match_jax(gt_depth_step):
    s = gt_depth_step
    assert set(s['loss_t']) == set(s['loss_j']) == {
        'segmentation', 'segmentation_uncertainty', 'pedestrian', 'pedestrian_uncertainty',
        'hdmap', 'hdmap_uncertainty', 'depths', 'depths_uncertainty'}
    assert s['loss_t']['depths'] > 0
    for key, want in s['loss_j'].items():
        np.testing.assert_allclose(s['loss_t'][key], want, rtol=1e-5, atol=1e-9, err_msg=key)
    np.testing.assert_allclose(s['total_t'], s['total_j'], rtol=1e-5)


def test_gt_depth_gradients_match_jax(gt_depth_step):
    s = gt_depth_step
    assert np.abs(s['grads_j']['depths_weight']) > 0
    assert_gradients_match(s['grads_t'], s['grads_j'], 1e-4)


def test_depths_weight_crosses_both_bridges():
    """The flax leaf ``depths_weight`` loads into the port's parameter and
    comes back out (from_flax / to_flax); the reference layout's
    ``model.depths_weight`` imports and exports as stp3_tpu's does."""
    mcfg = STP3Config.from_cfg(gt_depth_cfg())
    model = STP3(mcfg)
    params = to_flax(model)['params']
    assert 'depths_weight' in params
    params['depths_weight'] = np.asarray(-0.7, np.float32)
    load_flax_params(model, params)
    assert float(model.depths_weight.detach()) == pytest.approx(-0.7)
    assert float(to_flax(model)['params']['depths_weight']) == pytest.approx(-0.7)

    sd = ti.synthesize_state_dict(mcfg, seed=3)
    assert 'model.depths_weight' in sd
    sd['model.depths_weight'] = np.asarray(0.25, np.float32)
    imported, report = ti.import_state_dict(sd, mcfg)
    assert report.ok() and float(imported['depths_weight']) == pytest.approx(0.25)
    jmc = jax_model(gt_depth_cfg())[0].cfg
    jimported, _ = jti.import_state_dict(sd, jmc)
    assert float(jimported['depths_weight']) == float(imported['depths_weight'])
    exported = ti.export_state_dict(imported, mcfg)
    np.testing.assert_array_equal(exported['model.depths_weight'],
                                  jti.export_state_dict(jimported, jmc)['model.depths_weight'])
