"""Validation and evaluation of the port against the JAX package's, on the
CPU, at TINY's widths in fp32 with the same seeded weights (numpy draws
in the JAX model's variable tree, loaded into the port through
from_flax): the Planning stage (vehicle / pedestrian / HD-map IoU,
planning metrics) and the Prediction stage (IoU and the panoptic
metrics through the instance decode).

  * ``Trainer.val_step`` + ``compute_metrics``: the outputs held as
    ``assert_outputs_close`` holds them (atol 2e-3, rtol 1e-3, the
    precedent of tests/test_torch_model.py); the metrics must be equal,
    or differ only at the pixels where the argmax of the two packages'
    fp32 logits differs: at most 0.5% of a head's pixels, each with the
    two top logits within 2e-3 of each other in the JAX output (a
    rounding tie), and each moving an IoU count by at most one. The L2
    sums at rtol 1e-5.
  * ``evaluate``: the port's on its own checkpoint against the JAX
    package's ``evaluate()`` on the same weights: the same result keys,
    the same values as above.
  * the ``valid`` mask drops exactly the masked rows.

The JAX forward is one one-shot XLA program per stage at batch 1
(tests/torch_jax_steps.py), used by both its val_step and its evaluate.
"""
import functools

import jax
import numpy as np
import pytest
import torch

import torch_fixtures
from stp3_tpu.datas.synthetic import SyntheticDataset, collate
from stp3_tpu.training.trainer import Trainer as JTrainer
from stp3_tpu_torch.evaluate import evaluate
from stp3_tpu_torch.training import checkpoint as ck
from stp3_tpu_torch.training.trainer import Trainer, batch_to_device
from torch_jax_steps import (ONE_SHOT, assert_outputs_close, inputs_of, jax_model,
                             jax_norm_defaults, port_model, seeded_variables, to_numpy)

torch.set_num_threads(2)
assert jax_norm_defaults            # the autouse fixture, imported to take effect here

# three validation samples: the first has no vehicle in view, the others do
DATA = {'DATASET': {'NAME': 'synthetic', 'VERSION': 'mini', 'VAL_SAMPLES': 3},
        'N_WORKERS': 0, 'BATCHSIZE': 1, 'MODEL': {'REMAT': 'none'}}
STAGES = {'planning': lambda: torch_fixtures.make_cfg(torch_fixtures.PLANNING_STAGE,
                                                      torch_fixtures.TINY, {'PRECISION': 32},
                                                      DATA),
          'prediction': lambda: torch_fixtures.stage_cfg('prediction', True, DATA)}
# heads whose argmax feeds a metric: (key, channel slices)
HEADS = {'segmentation': [slice(0, 2)], 'pedestrian': [slice(0, 2)],
         'hdmap': [slice(0, 2), slice(2, 4)]}


@functools.lru_cache(maxsize=None)
def stage(name):
    """(cfg, JAX cfg, JAX variables, the port model, the JAX forward
    compiled at batch 1, the validation batches)."""
    cfg = STAGES[name]()
    jm, jcfg = jax_model(cfg)
    extras = None
    if cfg.PLANNING.ENABLED:
        extras = {k: np.asarray(v) for k, v in torch_fixtures.example_inputs(cfg)[1].items()}
    variables = seeded_variables(jm, inputs_of(cfg, b=1), extras=extras)
    ds = SyntheticDataset(jcfg, n_samples=3, seed=1)
    batches = [collate([ds[i]]) for i in range(3)]
    jtr = JTrainer(jcfg)
    compiled = jax.jit(jtr._val_forward_impl).lower(
        variables['params'], batches[0], None).compile(compiler_options=ONE_SHOT)
    return cfg, jcfg, variables, port_model(cfg, variables), compiled, batches


def _jax_trainer(name):
    _, jcfg, _, _, compiled, _ = stage(name)
    jtr = JTrainer(jcfg)
    jtr._val_forward_aot = compiled
    return jtr


def _flips(out_t, out_j):
    """(pixels whose argmax differs, pixels compared) over the heads that
    feed a metric; every differing pixel must be a rounding tie of the
    JAX logits."""
    n_diff = n_all = 0
    for key, slices in HEADS.items():
        if key not in out_j or out_j[key] is None:
            continue
        for sl in slices:
            lt, lj = out_t[key][..., sl], out_j[key][..., sl]
            diff = lt.argmax(-1) != lj.argmax(-1)
            top2 = np.sort(lj, -1)[..., -2:]
            assert (top2[..., 1] - top2[..., 0])[diff].max(initial=0.0) <= 2e-3, key
            n_diff += int(diff.sum())
            n_all += diff.size
    return n_diff, n_all


def _assert_metrics_match(got, want, n_flips):
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key]
        if isinstance(w, dict):
            assert set(g) == set(w), key
            for sub, wv in w.items():
                if key == 'planning' and sub == 'L2':
                    np.testing.assert_allclose(g[sub], wv, rtol=1e-5, err_msg=sub)
                elif n_flips == 0:
                    np.testing.assert_array_equal(g[sub], wv, err_msg=f'{key}/{sub}')
                else:
                    np.testing.assert_allclose(g[sub], wv, atol=0.05, err_msg=f'{key}/{sub}')
        elif n_flips == 0:
            np.testing.assert_array_equal(g, w, err_msg=key)
        else:
            np.testing.assert_allclose(g, w, atol=0.05, err_msg=key)


@pytest.mark.parametrize('name', sorted(STAGES))
def test_val_step_and_metrics_match_jax(name):
    cfg, _, variables, model, _, batches = stage(name)
    jtr = _jax_trainer(name)
    tr = Trainer(cfg, device='cpu', model=model)
    jtr.reset_metrics()
    tr.reset_metrics()
    n_diff = n_all = 0
    for batch in batches:
        out_j, labels_j = jtr.val_step(variables['params'], batch)
        out_t, labels_t = tr.val_step(batch_to_device(batch, 'cpu'))
        out_j, out_t = to_numpy(out_j), to_numpy(out_t)
        assert_outputs_close(out_t, out_j)
        for key, want in to_numpy(labels_j).items():
            np.testing.assert_array_equal(to_numpy(labels_t)[key], want, err_msg=key)
        d, a = _flips(out_t, out_j)
        n_diff, n_all = n_diff + d, n_all + a
    print(f'{name}: {n_diff} of {n_all} head pixels with another argmax')
    assert n_diff <= 0.005 * n_all
    got, want = tr.compute_metrics(), jtr.compute_metrics()
    _assert_metrics_match(got, want, n_diff)
    # the metrics are not vacuous
    assert jtr.metric_vehicle_val.state['support'][1] > 0
    assert jtr.metric_vehicle_val.state['tp'][1] + jtr.metric_vehicle_val.state['fp'][1] > 0
    if name == 'prediction':
        assert jtr.metric_panoptic_val.state['false_positive'][1] > 0
    else:
        assert (want['planning']['L2'] > 0).all()
    for m_t, m_j in zip(tr._all_metrics(), jtr._all_metrics()):
        for key, w in m_j.state.items():
            tol = 1e-5 if key == 'l2' else 0
            np.testing.assert_allclose(m_t.state[key], np.asarray(w), rtol=tol,
                                       atol=2 * n_diff, err_msg=key)


@pytest.mark.parametrize('name', sorted(STAGES))
def test_evaluate_matches_jax(name, tmp_path, monkeypatch):
    """The port's ``evaluate`` on its checkpoint of the stage's weights
    against the JAX package's ``evaluate()`` on the same weights (its
    checkpoint reads and its forward patched to the test's)."""
    import evaluate as jax_evaluate
    from stp3_tpu.training import checkpoint as jck
    cfg, jcfg, variables, model, compiled, _ = stage(name)
    path = ck.save_checkpoint(str(tmp_path), 3, model.state_dict(),
                              cfg_dict=cfg.convert_to_dict())
    got = evaluate(path, 'cpu')
    monkeypatch.setattr(jck, 'load_config_dict', lambda p: jcfg.convert_to_dict())
    monkeypatch.setattr(jck, 'load_checkpoint', lambda p: {'params': variables['params']})
    monkeypatch.setattr(JTrainer, 'val_forward', lambda self, p, b, s=None: compiled(p, b, s))
    want = {k: float(v) for k, v in jax_evaluate.evaluate(
        'unused', save_visualisations=False).items()}
    assert list(got) == list(want)
    keys = {'planning': {'vehicle_iou', 'pedestrian_iou', 'lane_divider_iou',
                         'drivable_area_iou', 'plan_obj_col_1s', 'plan_obj_box_col_1s',
                         'plan_L2_1s'},
            'prediction': {'vehicle_iou', 'vehicle_pq', 'vehicle_sq', 'vehicle_rq'}}[name]
    assert set(got) == keys
    for key, w in want.items():
        np.testing.assert_allclose(got[key], w, rtol=1e-5, atol=1e-7, err_msg=key)


def test_val_step_leaves_out_exactly_the_masked_rows():
    """The Prediction stage (IoU and panoptic): two samples, then the same
    two with the second repeated as a third row marked not valid: every
    metric state equal."""
    cfg, _, _, model, _, batches = stage('prediction')
    tr = Trainer(cfg, device='cpu', model=model)
    rows = [{k: v[0] for k, v in b.items()} for b in batches[1:]]
    pair, padded = collate(rows), collate(rows + rows[:1])
    padded['valid'] = np.array([True, True, False])
    states = []
    for batch in (pair, padded):
        tr.reset_metrics()
        tr.val_step(batch_to_device(batch, 'cpu'))
        states.append([{k: np.copy(v) for k, v in m.state.items()} for m in tr._all_metrics()])
    for want, got in zip(*states):
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert states[0][0]['support'].sum() == 2 * (cfg.N_FUTURE_FRAMES + 1) * 16 * 16
    assert states[0][0]['support'][1] > 0
