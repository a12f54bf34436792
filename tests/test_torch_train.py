"""The port's training step against the JAX package's, on the CPU.

The tiny Planning-stage configuration (torch_fixtures.planning_cfg(tiny=True):
__graft_entry__._flagship_cfg(tiny=True)'s widths with Planning.yml's
switches, REMAT 'encoder', fp32), one synthetic batch of two samples,
the JAX trainer's seeded init loaded into the port through from_flax.
The randomness is made equal inside the test: dropout is the identity on
both sides (flax.linen.Dropout.__call__ patched; dropout=False in the
port) and the GAUSSIAN noise is one fixed numpy draw (jax.random.normal
patched; the same tensor handed to the port). Nothing in stp3_tpu changes.

Tolerances: every loss term at rtol 1e-4; every parameter's gradient at a
relative L2 error below 1e-3 (reassociation through ~60 convs, top-k and
the backward of both), or, for a parameter whose fp32 gradient the JAX
package itself resolves no better than that, below twice that resolution:
the relative L2 distance of its fp32 gradient from the same step run with
float64 parameters (a few temporal-model leaves of this tiny model, where
it is 2-4e-3). fp32 resolves this small ReLU network's gradients no
better, in either package: an element whose pre-activation lies within
rounding of zero can take the other side of a ReLU, which moves every
gradient upstream of it (chip_smoke.py's train-parity phase counts such
sign flips of each fp32 step against the port's float64 step).
The optimizer: the port's clip + Adam step lands within 2 fp32 ulps
(plus 1e-5 of the update) of the parameter plus optax's update of the
same (the port's) gradients; and against the JAX package's whole
step, fewer than 1e-3 of all update elements flip sign (Adam's first step
is nearly lr * sign(g): an element whose gradient is zero to within the
gradient error above may flip, which moves it by 2 lr), and over the
elements of the same sign each parameter's update is within a relative
L2 error of 1e-2, or of twice the JAX package's own fp32-vs-float64
update error where that is larger (the same rule as for the gradients).
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_fixtures import planning_cfg
from stp3_tpu.config import get_cfg as jax_get_cfg
from stp3_tpu.datas.synthetic import SyntheticDataset, collate
from stp3_tpu.training.trainer import Trainer as JTrainer
from stp3_tpu.training.trainer import make_optimizer as jax_make_optimizer
from stp3_tpu_torch.models.stp3 import STP3, STP3Config
from stp3_tpu_torch.training.trainer import Trainer, batch_to_device, resolve_device
from stp3_tpu_torch.utils.from_flax import load_flax_params

torch.set_num_threads(2)


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


# XLA's backend optimisation off: each JAX program here runs once on a
# tiny model, so its compile time is all that counts (about a quarter of
# the default's)
_ONE_SHOT = {'xla_backend_optimization_level': 0, 'xla_llvm_disable_expensive_passes': True}


def _run_once(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=_ONE_SHOT)(*args)


def _jax_init(jtr, batch):
    """The params of the JAX trainer's init_state (its jitted model.init on
    one sample), compiled as a one-shot program."""
    from stp3_tpu.models.stp3 import STP3 as JSTP3
    sample = jax.tree.map(lambda x: jnp.asarray(np.asarray(x)[:1]), batch)

    def init(key, s):
        return jtr.model.init(
            {'params': key, 'sample': key, 'dropout': key}, s['image'], s['intrinsics'],
            s['extrinsics'], s['future_egomotion'], trajs=s['sample_trajectory'][:, :, 1:],
            gt_trajs=s['gt_trajectory'][:, 1:], commands=s['command'],
            target_points=s['target_point'], method=JSTP3.init_full)
    return _run_once(init, jax.random.PRNGKey(0), sample)['params']


def _optax_updates(jcfg, grads, params):
    """The JAX trainer's optimizer's first updates, as one program (eager
    optax would compile each op for each leaf's shape)."""
    tx = jax_make_optimizer(jcfg)
    return _run_once(lambda g, p: tx.update(g, tx.init(p), p)[0], grads, params)


def _jax_step(jtr, jcfg, params, batch, noise, x64: bool):
    """(total, loss dict, grads, params after one optimizer step) of the
    JAX trainer, dropout the identity and the noise fixed; ``x64`` runs the
    step with float64 parameters (its loss_fn's cast to the compute dtype
    patched out)."""
    import flax.linen

    from stp3_tpu.training import trainer as jax_trainer
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen.Dropout, '__call__',
                   lambda self, inputs, *args, **kwargs: inputs)
        mp.setattr(jax.random, 'normal',
                   lambda key, shape=(), dtype=jnp.float32: jnp.asarray(noise, dtype).reshape(
                       shape))
        if x64:
            mp.setattr(jax_trainer, 'cast_floating', lambda tree, dtype: tree)
            params = jax.tree.map(lambda a: a.astype(np.float64), params)
        jax.config.update('jax_enable_x64', x64)
        try:
            (total, (loss, _)), grads = _run_once(jax.value_and_grad(
                jtr.loss_fn, has_aux=True), params, batch, jax.random.PRNGKey(1))
            new = optax.apply_updates(params, _optax_updates(jcfg, grads, params))
            return (float(total), {k: float(v) for k, v in loss.items()},
                    jax.tree.map(np.asarray, grads), jax.tree.map(np.asarray, new))
        finally:
            jax.config.update('jax_enable_x64', False)


@pytest.fixture(scope='module')
def step():
    cfg = planning_cfg(tiny=True)
    jcfg = jax_get_cfg(cfg_dict=cfg.convert_to_dict())
    ds = SyntheticDataset(jcfg, n_samples=2, seed=0)
    batch = collate([ds[0], ds[1]])
    jtr = JTrainer(jcfg)
    params = jax.tree.map(np.asarray, _jax_init(jtr, batch))
    noise = np.random.RandomState(7).randn(2, 1, cfg.MODEL.DISTRIBUTION.LATENT_DIM).astype(
        np.float32)
    total_j, loss_j, grads_j, new_j = _jax_step(jtr, jcfg, params, batch, noise, False)
    _, _, grads_64, new_64 = _jax_step(jtr, jcfg, params, batch, noise, True)

    model = load_flax_params(STP3(STP3Config.from_cfg(cfg)), params)
    tr = Trainer(cfg, device='cpu', model=model)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    grads_t = {}
    clip = torch.nn.utils.clip_grad_norm_

    def clip_and_keep(parameters, max_norm):
        parameters = list(parameters)
        grads_t.update({id(p): p.grad.clone() for p in parameters})
        return clip(parameters, max_norm)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.nn.utils, 'clip_grad_norm_', clip_and_keep)
        out_t = tr.train_step(batch_to_device(batch, 'cpu'), noise=torch.from_numpy(noise),
                              dropout=False)

    def as_model(tree):
        """a JAX tree in the port's names and layouts"""
        return dict(load_flax_params(STP3(STP3Config.from_cfg(cfg)).double(),
                                     tree).named_parameters())

    # optax's chain on the port's own (pre-clip) gradients
    names = [n for n, _ in model.named_parameters()]
    flat_p = {n: before[n].numpy() for n in names}
    flat_g = {n: grads_t[id(p)].numpy() for n, p in model.named_parameters()}
    optax_on_port = {n: np.asarray(u) for n, u in _optax_updates(jcfg, flat_g, flat_p).items()}

    return dict(loss_j=loss_j, total_j=total_j, out_t={k: float(v) for k, v in out_t.items()},
                optax_on_port=optax_on_port,
                grads_j=as_model(grads_j), grads_64=as_model(grads_64),
                new_j=as_model(new_j), new_64=as_model(new_64),
                grads_t={n: grads_t[id(p)] for n, p in model.named_parameters()},
                model=model, before=before)


def test_loss_terms_match_jax(step):
    loss_j, out_t = step['loss_j'], step['out_t']
    assert set(out_t) == set(loss_j) | {'total'}
    assert set(loss_j) == {'segmentation', 'segmentation_uncertainty', 'pedestrian',
                           'pedestrian_uncertainty', 'hdmap', 'hdmap_uncertainty',
                           'planning', 'planning_uncertainty'}
    for key, want in loss_j.items():
        np.testing.assert_allclose(out_t[key], want, rtol=1e-4, atol=1e-7, err_msg=key)
    np.testing.assert_allclose(out_t['total'], step['total_j'], rtol=1e-4)


def test_every_gradient_matches_jax(step):
    want, want_64 = step['grads_j'], step['grads_64']
    assert set(step['grads_t']) == set(want)
    bad, coarse = {}, {}
    for name, g in step['grads_t'].items():
        err = _rel_l2(g.numpy(), want[name].detach().numpy())
        resolution = _rel_l2(want[name].detach().numpy(), want_64[name].detach().numpy())
        if err >= max(1e-3, 2 * resolution):
            bad[name] = (err, resolution)
        elif err >= 1e-3:
            coarse[name] = (err, resolution)
    print(f'{len(coarse)} leaves held to the JAX fp32 resolution (error, resolution): {coarse}')
    assert not bad, f'{len(bad)} of {len(want)} gradients off: {sorted(bad.items())[:8]}'
    assert len(coarse) <= 16, coarse


def test_optimizer_equals_optax_on_the_same_gradients(step):
    for name, p in step['model'].named_parameters():
        got = p.detach().numpy().astype(np.float64)
        upd = step['optax_on_port'][name].astype(np.float64)
        want = step['before'][name].numpy().astype(np.float64) + upd
        ulp = np.spacing(np.abs(got).astype(np.float32)).astype(np.float64)
        assert np.all(np.abs(got - want) <= 2 * ulp + 1e-5 * np.abs(upd)), name


def test_one_optimizer_step_matches_optax(step):
    want, want_64 = step['new_j'], step['new_64']
    bad, coarse, flipped, total = {}, {}, 0, 0
    for name, p in step['model'].named_parameters():
        old = step['before'][name].double().numpy()
        upd_t = p.detach().double().numpy() - old
        upd_j = want[name].detach().numpy() - old
        upd_64 = want_64[name].detach().numpy() - old
        flipped += int((np.sign(upd_t) != np.sign(upd_j)).sum())
        total += upd_t.size
        same = (np.sign(upd_t) == np.sign(upd_j)) & (np.sign(upd_j) == np.sign(upd_64))
        err = _rel_l2(upd_t[same], upd_j[same])
        resolution = _rel_l2(upd_j[same], upd_64[same])
        if err >= max(1e-2, 2 * resolution):
            bad[name] = (err, resolution)
        elif err >= 1e-2:
            coarse[name] = (err, resolution)
    print(f'{flipped} of {total} update elements flipped sign; {len(coarse)} leaves held to '
          f'the JAX fp32 resolution: {coarse}')
    assert not bad, f'{len(bad)} of {len(want)} updates off: {sorted(bad.items())[:8]}'
    assert flipped < 1e-3 * total


def test_train_mode_draws_from_the_generator_and_remat_replays_it():
    """With dropout and noise on: the same seed gives the same step, the
    encoder's recomputation (REMAT 'encoder') replays the forward's masks
    (its gradients equal REMAT 'none''s), and the generator moves on."""
    cfg = planning_cfg(tiny=True)
    from stp3_tpu_torch.datas.synthetic import SyntheticDataset as TDataset
    from stp3_tpu_torch.datas.synthetic import collate as tcollate
    ds = TDataset(cfg, n_samples=2, seed=3)
    batch = batch_to_device(tcollate([ds[0], ds[1]]), 'cpu')
    grads = {}
    for remat in ('encoder', 'none', 'encoder'):
        cfg.MODEL.REMAT = remat
        tr = Trainer(cfg, device='cpu', seed=5)
        state = tr.generator.get_state()
        total, _ = tr.loss_fn(batch)
        total.backward()
        assert not torch.equal(tr.generator.get_state(), state)
        grads.setdefault(remat, []).append(
            {n: p.grad.clone() for n, p in tr.model.named_parameters()})
    for name, g in grads['none'][0].items():
        torch.testing.assert_close(grads['encoder'][0][name], g, rtol=1e-5, atol=1e-7)
        assert torch.equal(grads['encoder'][1][name], grads['encoder'][0][name]), name


def test_float64_reference_step_runs_on_the_cpu():
    """PRECISION 64 (the precision reference of chip_smoke.py's train-parity
    phase) runs the same step in float64: the same loss terms as the fp32
    step, and gradients that differ from its fp32 ones only by fp32's
    resolution (median over the parameters, which a ReLU flip cannot move
    far)."""
    from torch_fixtures import step_grads, synthetic_batches
    cfg = planning_cfg(tiny=True)
    tr = Trainer(cfg, device='cpu', seed=0)
    ref_cfg = cfg.clone()
    ref_cfg.PRECISION = 64
    ref = Trainer(ref_cfg, device='cpu', model=copy.deepcopy(tr.model))
    assert ref.compute_dtype == torch.float64 and ref.loss_dtype == torch.float64
    batch, = synthetic_batches(cfg, 1, 'cpu')
    noise = torch.from_numpy(np.random.RandomState(0).randn(2, 1, 4).astype(np.float32))
    loss, grads = step_grads(tr, batch, noise)
    loss_64, grads_64 = step_grads(ref, batch, noise)
    for key, want in loss_64.items():
        np.testing.assert_allclose(loss[key], want, rtol=1e-4, atol=1e-7, err_msg=key)
    errs = [_rel_l2(grads[n], g) for n, g in grads_64.items()]
    assert np.median(errs) < 1e-3, np.median(errs)


def test_trainer_refuses_what_is_not_ported_and_needs_a_device_or_a_card(monkeypatch):
    cfg = planning_cfg(tiny=True)
    cfg.MODEL.REMAT = 'encoder+gates'
    assert Trainer(cfg, device='cpu').model.remat_stages == {'encoder', 'gates'}
    cfg.MODEL.REMAT = 'gates+future'
    with pytest.raises(ValueError, match="'gates'"):
        Trainer(cfg, device='cpu')
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    model = STP3(STP3Config.from_cfg(planning_cfg(tiny=True)))
    with pytest.raises(ValueError, match='Generator'):
        model(*[torch.zeros(1)] * 4, train=True)
