"""The BatchNorm kinds of the port ('bn', 'bn_frozen') and the transposed
conv variants against the JAX package's, on the CPU: the Norm site in
training and in eval, the strict weights-and-statistics bridge, the whole
model's eval forward on running statistics, and the Perception stage's
train step under MODEL.NORM 'bn' with REMAT 'encoder', whose running
statistics must move exactly once (the JAX package's nn.remat applies
them once; a second update in the port's recomputation would show as a
second momentum step).

Tolerances: fp32 sites at rtol 1e-5 (atol 1e-5), their running
statistics at rtol 1e-6; bf16 sites within one bf16 rounding (rtol 8e-3,
atol 1e-2); the transposed convs at atol 1e-5; the whole model at atol
2e-3, rtol 1e-3 (tests/test_torch_model.py's precedent); the train step
in float64 on both sides (tests/torch_jax_steps.py): loss terms at rtol
1e-5; every gradient at a relative L2 error below 1e-2 (plus 1e-6 of the
whole gradient's norm): the JAX step keeps 'bn''s batch statistics in
fp32 under x64, which resolves its gradients only to a median 2.4e-3
(measured: its fp32 step against its x64 step); the running statistics
after the step at rtol 1e-5, atol 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from stp3_tpu.datas.synthetic import SyntheticDataset, collate
from stp3_tpu.layers import convolutions as jconv
from stp3_tpu.training.trainer import Trainer as JTrainer
from stp3_tpu_torch.layers.base import Norm, to_first, to_last
from stp3_tpu_torch.layers.convolutions import Bottleneck, ConvBlock
from stp3_tpu_torch.models.stp3 import STP3, STP3Config
from stp3_tpu_torch.training.trainer import Trainer, batch_to_device
from stp3_tpu_torch.utils.from_flax import (flatten_tree, load_flax_params,
                                            load_flax_variables)
from torch_jax_steps import (assert_gradients_match, assert_outputs_close, inputs_of,
                             jax_forwards, jax_model, jax_norm_defaults, jax_train_step,
                             port_float64_step, port_grads, port_model, seeded_variables,
                             to_numpy)

torch.set_num_threads(2)
assert jax_norm_defaults            # the autouse fixture, imported to take effect here
FORWARD_KEYS = ('image', 'intrinsics', 'extrinsics', 'future_egomotion')


def _site_case(kind, ndim, dtype, seed=0):
    """A channels-last input with a per-channel offset and scale, and the
    site's flax variables (running statistics away from 0 and 1)."""
    rng = np.random.RandomState(seed)
    c = 8
    shape = (4, 6, 5, c) if ndim == 4 else (2, 3, 6, 5, c)
    x = (rng.randn(*shape) * rng.uniform(0.5, 2, c) + rng.randn(c)).astype(np.float32)
    stats = {'mean': (0.3 * rng.randn(c)).astype(np.float32),
             'var': rng.uniform(0.5, 2.0, c).astype(np.float32)}
    params = {'scale': (1 + 0.2 * rng.randn(c)).astype(np.float32),
              'bias': (0.3 * rng.randn(c)).astype(np.float32)}
    if kind == 'bn_frozen':
        params.update(stats)
        stats = None
    jx = jnp.asarray(x, jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    return x, jx, params, stats


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('ndim', [4, 5])
@pytest.mark.parametrize('kind,training', [('bn', True), ('bn', False),
                                           ('bn_frozen', True), ('bn_frozen', False)])
def test_norm_site_matches_jax(kind, training, ndim, dtype):
    """Train (batch statistics over every non-channel axis, the torch-
    convention running update with the unbiased variance, momentum 0.05,
    eps 1e-3 as at the EfficientNet sites) and eval (running statistics);
    bn_frozen always on its statistics. bf16 inputs take fp32 statistics
    and the JAX order: rsqrt(var + eps) * scale in fp32, then cast."""
    x, jx, params, stats = _site_case(kind, ndim, dtype)
    jconv.set_bn_momentum(0.05)
    site = jconv.Norm(kind=kind, eps=1e-3)
    variables = {'params': params} if stats is None else {'params': params,
                                                          'batch_stats': stats}
    mutable = ['batch_stats'] if kind == 'bn' and training else False
    out = site.apply(variables, jx, mutable=mutable)
    y_j, new_j = out if mutable else (out, None)

    port = load_flax_params(Norm(8, kind, eps=1e-3, momentum=0.05), params, stats)
    port.train(training)
    with torch.no_grad():
        y_t = to_last(port(to_first(torch.from_numpy(x).to(dtype))))
    assert y_t.dtype == dtype
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32 else dict(rtol=8e-3, atol=1e-2)
    np.testing.assert_allclose(y_t.float().numpy(), np.asarray(y_j, np.float32), **tol)
    if new_j is not None:
        for name in ('mean', 'var'):
            np.testing.assert_allclose(getattr(port, name).numpy(), new_j['batch_stats'][name],
                                       rtol=1e-6, atol=1e-7, err_msg=name)
    else:
        for name in ('mean', 'var'):          # nothing moved
            want = (stats or params)[name]
            np.testing.assert_array_equal(getattr(port, name).numpy(), want)


@pytest.mark.parametrize('k,s', [(3, 1), (3, 2), (4, 2), (5, 3)])
def test_conv_block_transpose_matches_jax(k, s):
    """ConvBlock(transpose=True): flax's ConvTranspose with 'SAME' padding
    (output = input x stride), then GroupNorm and ReLU."""
    rng = np.random.RandomState(k * 10 + s)
    x = rng.randn(2, 5, 7, 6).astype(np.float32)
    jm = jconv.ConvBlock(4, kernel_size=k, stride=s, transpose=True, use_bias=True)
    variables = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(s), x))
    variables['params']['ConvTranspose_0']['bias'] = rng.randn(4).astype(np.float32)
    y_j = np.asarray(jm.apply(variables, x))
    port = load_flax_params(ConvBlock(6, 4, k, s, use_bias=True, transpose=True),
                            variables['params'])
    with torch.no_grad():
        y_t = port(torch.from_numpy(x)).numpy()
    assert y_t.shape == y_j.shape == (2, 5 * s, 7 * s, 4)
    np.testing.assert_allclose(y_t, y_j, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize('hw', [(6, 8), (5, 7)])
def test_bottleneck_upsample_matches_jax(hw):
    """Bottleneck(upsample=True): a stride-2 transposed 3x3 with torch's
    ConvTranspose2d window (transpose_kernel), the bilinear 2x skip."""
    x = np.random.RandomState(hw[0]).randn(2, *hw, 8).astype(np.float32)
    jm = jconv.Bottleneck(out_channels=6, upsample=True)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(1), x)['params'])
    y_j = np.asarray(jm.apply({'params': params}, x))
    port = load_flax_params(Bottleneck(8, 6, upsample=True), params)
    with torch.no_grad():
        y_t = port(torch.from_numpy(x)).numpy()
    assert y_t.shape == y_j.shape == (2, 2 * hw[0], 2 * hw[1], 6)
    np.testing.assert_allclose(y_t, y_j, atol=1e-5, rtol=1e-5)


def _norm_cfg(kind, *overrides):
    return chip_smoke.stage_cfg('perception', True, {'TIME_RECEPTIVE_FIELD': 2},
                                {'MODEL': {'NORM': kind}}, *overrides)


def test_batch_stats_bridge_is_strict():
    """'bn' statistics come from 'batch_stats', 'bn_frozen''s from 'params',
    both into buffers that are not parameters; a missing or extra leaf of
    either tree, or an unknown collection, raises."""
    cfg = _norm_cfg('bn')
    jm, _ = jax_model(cfg)
    variables = seeded_variables(jm, inputs_of(cfg))
    assert set(variables) == {'params', 'batch_stats'}
    model = port_model(cfg, variables)
    site = model.encoder.EfficientNetFeatures_0.Norm_0
    np.testing.assert_array_equal(
        site.var.numpy(), variables['batch_stats']['encoder']['EfficientNetFeatures_0']['Norm_0']
        ['var'])
    names = {n for n, _ in model.named_parameters()}
    assert 'encoder.EfficientNetFeatures_0.Norm_0.scale' in names
    assert not any(n.endswith(('.mean', '.var')) for n in names)
    fresh = lambda: STP3(STP3Config.from_cfg(cfg))      # noqa: E731
    with pytest.raises(KeyError, match='batch_stats:'):
        load_flax_params(fresh(), variables['params'])
    extra = jax.tree.map(lambda a: a, variables['batch_stats'])
    extra['decoder']['unexpected'] = {'mean': np.zeros(3, np.float32)}
    with pytest.raises(KeyError, match='unused'):
        load_flax_params(fresh(), variables['params'], extra)
    with pytest.raises(KeyError, match='collections'):
        load_flax_variables(fresh(), {**variables, 'cache': {}})

    frozen_cfg = _norm_cfg('bn_frozen')
    jm, _ = jax_model(frozen_cfg)
    frozen = seeded_variables(jm, inputs_of(frozen_cfg))
    assert set(frozen) == {'params'}
    model = port_model(frozen_cfg, frozen)
    flat = flatten_tree(frozen['params'])
    n_stats = sum(p.endswith(('/mean', '/var')) for p in flat)
    assert n_stats == 2 * sum(m.kind == 'bn_frozen' for m in model.modules()
                              if isinstance(m, Norm)) > 0
    assert len(list(model.parameters())) == len(flat) - n_stats


@pytest.mark.parametrize('kind', ['bn', 'bn_frozen'])
def test_whole_model_eval_forward_on_running_statistics_matches_jax(kind):
    cfg = _norm_cfg(kind)
    inputs = inputs_of(cfg)
    jm, _ = jax_model(cfg)
    variables = seeded_variables(jm, inputs)
    out_j, _ = jax_forwards(jm, variables, inputs)
    model = port_model(cfg, variables).eval()
    with torch.no_grad():
        out_t = to_numpy(model(*[torch.from_numpy(a) for a in inputs]))
    assert_outputs_close(out_t, out_j)


@pytest.fixture(scope='module')
def bn_step():
    """The Perception stage's train step under 'bn' (REMAT 'encoder',
    momentum 0.05) in float64, JAX and port, from the same seeded weights
    and statistics, one synthetic batch of two, dropout off."""
    cfg = _norm_cfg('bn')
    jm, jcfg = jax_model(cfg)
    ds = SyntheticDataset(jcfg, n_samples=2, seed=0)
    batch = collate([ds[0], ds[1]])
    variables = seeded_variables(jm, [batch[k][:1] for k in FORWARD_KEYS])
    total_j, loss_j, grads_j, stats_j = jax_train_step(
        JTrainer(jcfg), variables['params'], batch, variables['batch_stats'])
    total_t, loss_t, grads_t, tr = port_float64_step(cfg, variables, batch)
    return dict(cfg=cfg, variables=variables, batch=batch, total_j=total_j, loss_j=loss_j,
                total_t=total_t, loss_t=loss_t, grads_t=grads_t, stats_j=stats_j, tr=tr,
                grads_j=port_grads(tr.model, grads_j, variables['batch_stats']))


def test_bn_step_loss_terms_and_gradients_match_jax(bn_step):
    s = bn_step
    assert s['tr'].model.cfg.remat == 'encoder' and s['tr'].model.cfg.norm == 'bn'
    assert set(s['loss_t']) == set(s['loss_j'])
    for key, want in s['loss_j'].items():
        np.testing.assert_allclose(s['loss_t'][key], want, rtol=1e-5, atol=1e-9, err_msg=key)
    np.testing.assert_allclose(s['total_t'], s['total_j'], rtol=1e-5)
    assert_gradients_match(s['grads_t'], s['grads_j'], 1e-2)


def test_bn_step_moves_running_statistics_once_as_jax(bn_step):
    """After the step (forward, then the backward with the encoder's
    recomputation) every running statistic equals the JAX trainer's, which
    updates each site once; an update in the recomputation as well would
    take a second momentum step, 5% of the way from the statistic to the
    batch's, far outside the tolerance."""
    s = bn_step
    model, want = s['tr'].model, flatten_tree(s['stats_j'])
    before = flatten_tree(s['variables']['batch_stats'])
    moved = 0
    for name, m in model.named_modules():
        if isinstance(m, Norm) and m.kind == 'bn':
            for stat in ('mean', 'var'):
                path = '/'.join(name.split('.') + [stat])
                got = getattr(m, stat).numpy()
                np.testing.assert_allclose(got, want[path], rtol=1e-5, atol=1e-6, err_msg=path)
                moved += int(np.abs(got - before[path]).max() > 1e-6)
    assert moved == len(want) == len(before)


def test_bn_step_is_remat_invariant_and_eval_uses_running_statistics(bn_step):
    """REMAT 'none' (no recomputation) gives the same running statistics as
    REMAT 'encoder', both in fp32 from the same weights (dropout off; to
    rtol 1e-6: only the two backward passes' rounding differs, and the
    statistics come from the forward). Then val_forward runs on the
    running statistics: finite heads that differ from the train-mode
    forward's on the same batch."""
    s = bn_step
    stats = {}
    for remat in ('encoder', 'none'):
        tr = Trainer(_norm_cfg('bn', {'MODEL': {'REMAT': remat}}), device='cpu',
                     model=None)
        load_flax_variables(tr.model, s['variables'])
        batch = batch_to_device(s['batch'], 'cpu')
        tr.train_step(batch, dropout=False)
        stats[remat] = {n: b.clone() for n, b in tr.model.named_buffers()
                        if n.endswith(('.mean', '.var'))}
    for name, want in stats['none'].items():
        torch.testing.assert_close(stats['encoder'][name], want, rtol=1e-6, atol=1e-7)
    evaluated, _ = tr.val_forward(batch)
    assert tr.model.training
    for name, b in tr.model.named_buffers():    # the eval forward moved nothing
        if name in stats['none']:
            assert torch.equal(b, stats['none'][name]), name
    with torch.no_grad():
        trained = tr.model(*[batch[k] for k in FORWARD_KEYS], train=True, dropout=False)
    for key in ('segmentation', 'pedestrian', 'hdmap'):
        assert torch.isfinite(evaluated[key]).all(), key
        assert not torch.allclose(evaluated[key], trained[key], atol=1e-3), key


def test_bn_frozen_statistics_stay_out_of_the_optimizer():
    """bn_frozen's statistics are buffers: Adam, the weight decay and the
    clip never see them, and a train step leaves them as they were."""
    cfg = _norm_cfg('bn_frozen')
    tr = Trainer(cfg, device='cpu', seed=0)
    optimised = {id(p) for group in tr.optimizer.param_groups for p in group['params']}
    stats = {n: b for n, b in tr.model.named_buffers() if n.endswith(('.mean', '.var'))}
    assert stats and not optimised & {id(b) for b in stats.values()}
    for b in stats.values():
        with torch.no_grad():
            b.add_(0.25)
    before = {n: b.clone() for n, b in stats.items()}
    from chip_smoke import synthetic_batches
    batch, = synthetic_batches(cfg, 1, 'cpu')
    tr.train_step(batch, dropout=False)
    for name, b in stats.items():
        assert torch.equal(b, before[name]), name
