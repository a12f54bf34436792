"""Shared by the port's stage and norm parity tests: the JAX package's
init, eval / train forwards and train step of a configuration, each
compiled as a one-shot XLA program, with the randomness made equal
inside the test (dropout and drop-connect the identity, the latent draws
a fixed numpy queue). Nothing in stp3_tpu changes.

The train steps compare in float64 on both sides (the JAX step with x64
on, the port's at PRECISION 64), one JAX program a step. The JAX norms
keep their statistics in fp32 under x64 (the port's go to float64), so
the two steps differ by what ~1e-7 in a normalisation moves: a few 1e-5
of a gradient under 'gn' on these seeded weights, but a median 2.4e-3
under 'bn', whose batch-statistics gradient cancels most of the direct
term (the JAX step's own fp32 step is as far from its x64 step, and the
port's fp32 step from its float64 one)."""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import example_inputs
from stp3_tpu.config import get_cfg as jax_get_cfg
from stp3_tpu.layers.convolutions import set_bn_momentum, set_default_norm
from stp3_tpu.models.stp3 import STP3 as JSTP3
from stp3_tpu.models.stp3 import STP3Config as JCfg
from stp3_tpu_torch.models.stp3 import STP3, STP3Config
from stp3_tpu_torch.utils.from_flax import load_flax_params, load_flax_variables

# XLA's backend optimisation off: each program runs once on a tiny model,
# so its compile time is all that counts
ONE_SHOT = {'xla_backend_optimization_level': 0, 'xla_llvm_disable_expensive_passes': True}


def run_once(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=ONE_SHOT)(*args)


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


@pytest.fixture(autouse=True)
def jax_norm_defaults():
    """The JAX STP3Config.from_cfg sets a process-wide norm kind and BN
    momentum: put the defaults back after each test."""
    yield
    set_default_norm('gn')
    set_bn_momentum(0.1)


@contextlib.contextmanager
def fixed_randomness(draws=()):
    """Within: flax's Dropout (so also the EfficientNet drop-connect) is the
    identity, and jax.random.normal returns the numpy ``draws`` in order."""
    import flax.linen
    queue = list(draws)

    def normal(key, shape=(), dtype=jnp.float32):
        return jnp.asarray(queue.pop(0), dtype).reshape(shape)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen.Dropout, '__call__', lambda self, inputs, *a, **k: inputs)
        mp.setattr(jax.random, 'normal', normal)
        yield
    assert not queue, f'{len(queue)} draws left unused'


def jax_model(cfg):
    """The JAX package's STP3 of the port's config ``cfg`` (and its config)."""
    jcfg = jax_get_cfg(cfg_dict=cfg.convert_to_dict())
    return JSTP3(JCfg.from_cfg(jcfg)), jcfg


def seeded_variables(jm, inputs, seed=0, extras=None):
    """Seeded numpy weights in the JAX model's variable tree (its shapes
    from a trace of its init, no compile): kernels normal over the square
    root of their fan-in, norm scales near 1, biases, running means and
    layer scales near 0, running variances in [0.5, 1.5]. Not flax's
    initialisers (compiling the init costs ~30 s a model), and a harder
    test: no bias, mean or layer scale sits at an exact zero. ``extras``:
    the planner's arguments of ``init_full`` (trajs, gt_trajs, commands,
    target_points), for a model with a planner."""
    shapes = jax.eval_shape(
        lambda key, *a: jm.init(key, *a, **(extras or {}), method=JSTP3.init_full),
        jax.random.PRNGKey(0), *inputs)
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name = str(getattr(path[-1], 'key', path[-1]))
        shape = leaf.shape
        if name == 'var':
            value = rng.uniform(0.5, 1.5, shape)
        elif name == 'scale':
            value = 1.0 + 0.1 * rng.randn(*shape)
        elif len(shape) < 2 or name in ('mean', 'gamma'):
            value = 0.1 * rng.randn(*shape)
        else:
            value = rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        return np.asarray(value, np.float32)

    return jax.tree_util.tree_map_with_path(draw, dict(shapes))


def jax_forwards(jm, variables, inputs, draws=None):
    """One program: the JAX model's eval forward and, given the latent
    ``draws``, its train-mode forward on them (dropout the identity).
    Returns (eval output, train output or None)."""
    def run(variables, key, *a):
        train = None if draws is None else jm.apply(
            variables, *a, train=True, rngs={'sample': key, 'dropout': key})
        return jm.apply(variables, *a, train=False), train

    with fixed_randomness(draws or ()):
        out, train = run_once(run, variables, jax.random.PRNGKey(0), *inputs)
    return to_numpy(out), None if train is None else to_numpy(train)


def port_model(cfg, variables):
    return load_flax_variables(STP3(STP3Config.from_cfg(cfg)), variables)


def inputs_of(cfg, b=2):
    """The example rig and images of chip_smoke.py at batch ``b``."""
    return [np.asarray(a) for a in example_inputs(cfg, b=b)[0]]


def to_numpy(out):
    """A JAX or port output dict as numpy (lists kept as lists)."""
    def conv(v):
        if v is None:
            return None
        if isinstance(v, (list, tuple)):
            return [conv(x) for x in v]
        if isinstance(v, torch.Tensor):
            return v.detach().float().numpy()
        return np.asarray(v)
    return {k: conv(v) for k, v in out.items()}


def assert_outputs_close(got, want, atol=2e-3, rtol=1e-3):
    """The same keys, None where the other is None, every array (and every
    array of a list) within the tolerance."""
    assert set(got) == set(want), (sorted(got), sorted(want))
    for key, w in want.items():
        g = got[key]
        assert (g is None) == (w is None), key
        if w is None:
            continue
        ws, gs = (w, g) if isinstance(w, list) else ([w], [g])
        assert len(gs) == len(ws), key
        for gi, wi in zip(gs, ws):
            assert gi.shape == wi.shape, (key, gi.shape, wi.shape)
            np.testing.assert_allclose(gi, wi, atol=atol, rtol=rtol, err_msg=key)


def jax_train_step(jtr, params, batch, batch_stats=None):
    """(total, loss dict, grads, new batch_stats) of the JAX trainer's
    loss_fn and its gradient in float64 (x64 on, float64 parameters, its
    cast to the compute dtype patched out), dropout the identity."""
    from stp3_tpu.training import trainer as jax_trainer
    with fixed_randomness(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_trainer, 'cast_floating', lambda tree, dtype: tree)
        params = jax.tree.map(lambda a: a.astype(np.float64), params)
        jax.config.update('jax_enable_x64', True)
        try:
            (total, (loss, stats)), grads = run_once(
                jax.value_and_grad(jtr.loss_fn, has_aux=True), params, batch,
                jax.random.PRNGKey(1), batch_stats)
            return (float(total), {k: float(v) for k, v in loss.items()},
                    jax.tree.map(np.asarray, grads),
                    None if stats is None else jax.tree.map(np.asarray, stats))
        finally:
            jax.config.update('jax_enable_x64', False)


def port_float64_step(cfg, variables, batch):
    """The port's train step at PRECISION 64 (float64 parameter copies and
    losses) on the given weights: (total, loss dict, {name: gradient}, trainer)."""
    from stp3_tpu_torch.training.trainer import Trainer, batch_to_device
    cfg = cfg.clone()
    cfg.PRECISION = 64
    tr = Trainer(cfg, device='cpu', model=port_model(cfg, variables))
    tr.optimizer.zero_grad(set_to_none=True)
    total, loss = tr.loss_fn(batch_to_device(batch, 'cpu'), dropout=False)
    total.backward()
    return (total.item(), {k: v.item() for k, v in loss.items()},
            {n: p.grad.double().numpy() for n, p in tr.model.named_parameters()}, tr)


def port_grads(model, tree, batch_stats=None):
    """A JAX gradient tree in the port's parameter names and layouts
    (``batch_stats``: any statistics tree of a 'bn' model, to fill its
    buffers)."""
    fresh = load_flax_params(STP3(model.cfg).double(), tree, batch_stats)
    return {n: p.detach().numpy() for n, p in fresh.named_parameters()}


def assert_gradients_match(grads_t, grads_j, limit):
    """Every parameter's float64 gradient within ``limit`` of the JAX
    package's float64 one: ||g - g_jax|| below ``limit`` ||g_jax|| plus
    1e-6 of the whole gradient's norm (a gradient that is zero in exact
    arithmetic, such as a 'bn' site's bias ahead of a linear map into
    another 'bn' site, is rounding noise of 1e-10 of it on both sides)."""
    assert set(grads_t) == set(grads_j)
    floor = 1e-6 * np.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                               for g in grads_j.values()))
    errs = {name: rel_l2(g, grads_j[name]) for name, g in grads_t.items()}
    bad = {name: errs[name] for name, g in grads_t.items()
           if not np.linalg.norm(np.asarray(g, np.float64) - grads_j[name])
           < limit * np.linalg.norm(grads_j[name]) + floor}
    print(f'{len(errs)} float64 gradients: median relative L2 error '
          f'{np.median(list(errs.values())):.2e}, worst {max(errs.values()):.2e}')
    assert not bad, f'{len(bad)} of {len(errs)} gradients off: {sorted(bad.items())[:8]}'
