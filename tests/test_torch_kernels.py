"""The port's kernel wrappers on the CPU: each plain version against the
Pallas kernel it replaces (interpret mode, as tests/test_bev_pool.py and
tests/test_convnext_kernel.py run them), CPU dispatch, argument checks,
and that the port itself never imports jax or flax.

The kernels themselves run only on a GPU: tests/test_torch_cuda.py.
"""
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from stp3_tpu.ops.pallas.bev_pool_kernel import bev_pool_pallas_v2_batched
from stp3_tpu.ops.pallas.convnext_mlp_kernel import convnext_mlp_pallas
from stp3_tpu_torch.ops.kernels import bev_splat as K1
from stp3_tpu_torch.ops.kernels import convnext_mlp as K2

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_DT = {'float32': (jnp.float32, torch.float32), 'bfloat16': (jnp.bfloat16, torch.bfloat16)}


def _splat_inputs(f=3, p=300, c=8, ncells=100, seed=13):
    """ranks span [0, ncells]: ncells is the overflow (invalid) id; P=300
    is not a multiple of the Pallas kernel's chunk."""
    rng = np.random.RandomState(seed)
    feats = rng.randn(f, p, c).astype(np.float32)
    ranks = rng.randint(0, ncells + 1, size=(f, p)).astype(np.int32)
    return feats, ranks, ncells


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_bev_splat_plain_matches_pallas(dtype):
    jdt, tdt = _DT[dtype]
    feats, ranks, ncells = _splat_inputs()
    with pltpu.force_tpu_interpret_mode():
        want = bev_pool_pallas_v2_batched(jnp.asarray(feats, jdt), jnp.asarray(ranks),
                                          ncells)
    got = K1.bev_splat(torch.from_numpy(feats).to(tdt), torch.from_numpy(ranks), ncells)
    assert got.dtype == tdt and tuple(got.shape) == (3, ncells, 8)
    # fp32: only the summation order differs; bf16: both round the same
    # fp32 sums, which may straddle a rounding boundary by 1 ULP (2^-8)
    tol = dict(atol=1e-4, rtol=0) if dtype == 'float32' else dict(atol=1e-2, rtol=1e-2)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)


def _mlp_inputs(n, c=16, seed=0):
    """The inputs of tests/test_convnext_kernel.py::_inputs."""
    rng = np.random.RandomState(seed)
    return (rng.randn(n, c), rng.randn(n, c), rng.rand(c) + 0.5, rng.randn(c) * 0.1,
            rng.randn(c, 4 * c) * 0.2, rng.randn(4 * c) * 0.1, rng.randn(4 * c, c) * 0.2,
            rng.randn(c) * 0.1, rng.rand(c) + 0.5)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('n', [500, 2049])
def test_convnext_mlp_plain_matches_pallas(dtype, n):
    jdt, tdt = _DT[dtype]
    args = _mlp_inputs(n)
    jargs = [jnp.asarray(a, jdt if i < 2 else jnp.float32) for i, a in enumerate(args)]
    targs = [torch.tensor(a, dtype=tdt if i < 2 else torch.float32)
             for i, a in enumerate(args)]
    with pltpu.force_tpu_interpret_mode():
        want = convnext_mlp_pallas(*jargs)
    got = K2.convnext_mlp(*targs)
    assert got.dtype == tdt
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    # tests/test_convnext_kernel.py:45-46: a bf16 output may differ by 1 ULP
    np.testing.assert_allclose(got, want, rtol=1e-2, atol=1e-2)
    if dtype == 'float32':
        # the fp32 tolerance of test_convnext_kernel.py (atol 1e-5) holds for
        # all but the rows where the two frameworks' LayerNorm outputs (same
        # math, another summation order) straddle a bf16 rounding boundary of
        # the matmul operand: one bf16 ULP there moves the row by ~2e-3
        assert np.mean(np.abs(got - want) > 1e-5) < 5e-3


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    feats, ranks, ncells = (torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                            for a in _splat_inputs())
    margs = [torch.tensor(a, dtype=torch.float32) for a in _mlp_inputs(64)]
    before = (K1.bev_splat_accumulate.launches, K2.convnext_mlp.launches)
    assert torch.equal(K1.bev_splat_accumulate(feats, ranks, ncells),
                       K1.bev_splat_accumulate_plain(feats, ranks, ncells))
    assert torch.equal(K2.convnext_mlp(*margs), K2.convnext_mlp_plain(*margs))
    assert (K1.bev_splat_accumulate.launches, K2.convnext_mlp.launches) == before


def test_wrappers_refuse_bad_arguments_and_non_cpu_non_cuda_devices():
    feats, ranks, ncells = (torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                            for a in _splat_inputs())
    with pytest.raises(TypeError):
        K1.bev_splat(feats.double(), ranks, ncells)
    with pytest.raises(TypeError):
        K1.bev_splat(feats, ranks.long(), ncells)
    with pytest.raises(ValueError):
        K1.bev_splat(feats, ranks[:, :-1], ncells)
    # a device that is neither CPU nor CUDA gets no silent plain fallback
    with pytest.raises(RuntimeError):
        K1.bev_splat(feats.to('meta'), ranks.to('meta'), ncells)
    margs = [torch.tensor(a, dtype=torch.float32) for a in _mlp_inputs(64)]
    with pytest.raises(ValueError):
        K2.convnext_mlp(margs[0], margs[1][:, :8], *margs[2:])
    with pytest.raises(RuntimeError):
        K2.convnext_mlp(*[a.to('meta') for a in margs])


def test_port_imports_no_jax_or_flax():
    """In a fresh interpreter (this one imported jax in conftest.py): the
    port, its model and its weight bridge pull in no jax/flax, and of the
    JAX package only the framework-free config and rasterizer."""
    code = (
        'import json, sys\n'
        'before = set(sys.modules)\n'
        'import stp3_tpu_torch, stp3_tpu_torch.models.stp3, stp3_tpu_torch.utils.from_flax\n'
        'import stp3_tpu_torch.ops.kernels.bev_splat, stp3_tpu_torch.ops.kernels.convnext_mlp\n'
        'new = set(sys.modules) - before\n'
        'print(json.dumps(sorted(m for m in new if m.split(".")[0] in\n'
        '                        ("jax", "jaxlib", "flax", "stp3_tpu"))))\n')
    out = subprocess.run([sys.executable, '-c', code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    imported = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert imported <= {'stp3_tpu', 'stp3_tpu.config', 'stp3_tpu.utils',
                        'stp3_tpu.utils.rasterize'}, imported
