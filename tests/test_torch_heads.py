"""Per-module parity of the port's BEV heads -- decoder, the planner's
seven-term cost function, and the planner (select + GRU refinement) --
against stp3_tpu with from_flax-loaded weights, fp32 on the CPU at
rtol=atol=1e-4. (The other modules: tests/test_torch_layers.py.)"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stp3_tpu.layers import convolutions as JC
from stp3_tpu.models import cost as JCOST
from stp3_tpu.models import decoder as JD
from stp3_tpu.models import planning_model as JP
from stp3_tpu_torch.models import cost as TCOST
from stp3_tpu_torch.models import decoder as TD
from stp3_tpu_torch.models import planning_model as TP
from stp3_tpu_torch.utils.from_flax import load_flax_params
from test_torch_layers import _rand, close, run_both

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _flax_default_norm_gn():
    """flax Norm() reads a process-wide default; pin it to the port's 'gn'."""
    prev = JC.default_norm()
    JC.set_default_norm('gn')
    yield
    JC.set_default_norm(prev)


def test_decoder_all_heads():
    x = _rand(1, 3, 16, 16, 8)
    got, want, _ = run_both(JD.Decoder(n_classes=2, n_present=2, n_hdmap=2),
                            TD.Decoder(8, 2, 2, 2), [x])
    for key, v in want.items():
        assert (got[key] is None) == (v is None), key
        if v is not None:
            close(got[key], v)


def _cost_cfg(cls, n_future=3):
    return cls(x_bound=(-8.0, 8.0, 0.5), y_bound=(-8.0, 8.0, 0.5),
               z_bound=(-10.0, 10.0, 20.0), ego_width=1.85, ego_height=4.084,
               n_future=n_future, safety=0.1, lambda_=1.0, headway=1.0, lrdivider=10.0,
               comfort=0.1, progress=0.5, volume=100.0)


def _planner_inputs(n=12, t=3, seed=5):
    rng = np.random.RandomState(seed)
    trajs = np.cumsum(rng.randn(1, n, t, 3) * [0.8, 2.0, 0.0], 2).astype(np.float32)
    cv = rng.uniform(-10, 1500, (1, t, 32, 32)).astype(np.float32)
    occ = (rng.rand(1, t, 32, 32) < 0.1).astype(np.float32)
    hd = rng.randn(1, 32, 32, 4).astype(np.float32)
    target = np.array([[1.5, 4.0]], np.float32)
    return trajs, cv, occ, hd, target


def test_cost_function_all_seven_terms():
    trajs, cv, occ, hd, target = _planner_inputs()
    jcf, tcf = JCOST.CostFunction(_cost_cfg(JCOST.CostConfig)), \
        TCOST.CostFunction(_cost_cfg(TCOST.CostConfig))
    np.testing.assert_array_equal(tcf._fp_lam, jcf._fp_lam)
    args = (cv, trajs[..., :2], occ, hd[..., :2], hd[..., 2:], target)
    jfc, jfo = jax.jit(jcf.__call__)(*[jnp.asarray(a) for a in args])
    tfc, tfo = tcf(*[torch.from_numpy(a) for a in args])
    close(tfc, jfc)
    close(tfo, jfo)
    assert np.abs(np.asarray(jfo)).sum() > 0


@pytest.fixture(scope='module')
def planner_pair():
    """One flax init and one compiled apply shared by both commands."""
    prev = JC.default_norm()
    JC.set_default_norm('gn')
    trajs, cv, occ, hd, target = _planner_inputs()
    inputs = [_rand(1, 4, 8, 16, seed=9), trajs, _rand(1, 3, 3, seed=10), cv, occ, hd,
              np.array([1], np.int32), target]
    jmod = JP.Planning(cost_cfg=_cost_cfg(JCOST.CostConfig), sample_num=12,
                       feature_channel=16, gru_state_size=2)
    params = jax.jit(lambda *a: jmod.init(jax.random.PRNGKey(0), *a))(
        *[jnp.asarray(a) for a in inputs])['params']
    apply = jax.jit(lambda p, *a: jmod.apply({'params': p}, *a))
    tmod = TP.Planning(_cost_cfg(TCOST.CostConfig), 12, 16, 2)
    load_flax_params(tmod, jax.tree.map(np.asarray, params))
    JC.set_default_norm(prev)
    return params, apply, tmod, inputs


@pytest.mark.parametrize('command', [1, 2])        # FORWARD, RIGHT
def test_planner_select_and_refine(planner_pair, command):
    params, apply, tmod, inputs = planner_pair
    inputs = inputs[:6] + [np.array([command], np.int32)] + inputs[7:]
    loss_j, traj_j = apply(params, *[jnp.asarray(a) for a in inputs])
    with torch.no_grad():
        loss_t, traj_t = tmod(*[torch.from_numpy(a) for a in inputs])
    assert float(loss_j) == 0.0 and float(loss_t) == 0.0
    close(traj_t, traj_j)
