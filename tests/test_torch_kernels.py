"""The port's kernel wrappers on the CPU: each plain version against the
Pallas kernel it replaces (interpret mode, as tests/test_bev_pool.py and
tests/test_convnext_kernel.py run them), the autograd wirings against
jax.vjp, CPU dispatch, argument checks, and that the port itself never
imports jax, flax, optax, stp3_tpu, __graft_entry__ or PIL.

The kernels themselves run only on a GPU: tests/test_torch_cuda.py.
"""
import ast
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from stp3_tpu.ops.pallas.bev_pool_kernel import (bev_pool_pallas, bev_pool_pallas_v2,
                                                 bev_pool_pallas_v2_batched, gather_rows_pallas,
                                                 lift_splat_pallas)
from stp3_tpu.ops.pallas.convnext_mlp_kernel import convnext_mlp_pallas
from stp3_tpu_torch.ops.kernels import bev_splat as K1
from stp3_tpu_torch.ops.kernels import convnext_mlp as K2
from stp3_tpu_torch.ops.kernels import lift_splat as K4

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


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_gather_rows_plain_matches_pallas_bit_for_bit(dtype):
    """K3's plain version against the JAX VJP's row gather (_bwd_v2b with
    the Pallas backward: per-frame gather_rows_pallas on the zero-padded
    cotangent); ranks == ncells (invalid) give zero rows."""
    jdt, tdt = _DT[dtype]
    _, ranks, ncells = _splat_inputs()
    assert (ranks == ncells).any()
    table = np.random.RandomState(5).randn(3, ncells, 8).astype(np.float32)
    g = jnp.asarray(table, jdt)
    g_ext = jnp.concatenate([g, jnp.zeros_like(g[:, :1])], axis=1)
    with pltpu.force_tpu_interpret_mode():
        want = np.stack([np.asarray(gather_rows_pallas(g_ext[f], jnp.asarray(ranks[f]),
                                                       chunk=256), np.float32)
                         for f in range(3)])
    got = K1.gather_rows(torch.from_numpy(table).to(tdt), torch.from_numpy(ranks))
    assert got.dtype == tdt and tuple(got.shape) == (3, 300, 8)
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert not got[torch.from_numpy(ranks == ncells)].any()


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_bev_splat_gradient_matches_jax_vjp(dtype, monkeypatch):
    """BevSplat's backward (K3's plain version on the CPU) equals jax.vjp of
    bev_pool_pallas_v2_batched through its Pallas backward, bit for bit
    (a gather: no arithmetic)."""
    jdt, tdt = _DT[dtype]
    feats, ranks, ncells = _splat_inputs()
    g = np.random.RandomState(3).randn(3, ncells, 8).astype(np.float32)
    monkeypatch.setenv('STP3_SPLAT_BWD', 'pallas')
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda f: bev_pool_pallas_v2_batched(f, jnp.asarray(ranks), ncells),
                         jnp.asarray(feats, jdt))
        want, = vjp(jnp.asarray(g, jdt))
    x = torch.from_numpy(feats).to(tdt).requires_grad_(True)
    out = K1.bev_splat(x, torch.from_numpy(ranks), ncells)
    out.backward(torch.from_numpy(g).to(tdt))
    assert x.grad.dtype == tdt
    np.testing.assert_array_equal(x.grad.float().numpy(), np.asarray(want, np.float32))


_PER_FRAME = {'v1': (bev_pool_pallas, K1.bev_pool_v1),
              'v2': (bev_pool_pallas_v2, K1.bev_pool_v2)}


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('version', ['v1', 'v2'])
def test_per_frame_entries_match_pallas(version, dtype):
    """K1's v1 / v2 entries (plain version on the CPU) against
    bev_pool_pallas / bev_pool_pallas_v2 in interpret mode: forward, and
    the gradient through each JAX VJP (v2's with its Pallas row gather)."""
    jfn, tfn = _PER_FRAME[version]
    jdt, tdt = _DT[dtype]
    feats, ranks, ncells = _splat_inputs(f=1)
    feats, ranks = feats[0], ranks[0]
    g = np.random.RandomState(7).randn(ncells, 8).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want, vjp = jax.vjp(lambda f: jfn(f, jnp.asarray(ranks), ncells), jnp.asarray(feats, jdt))
        want_grad, = vjp(jnp.asarray(g, jdt))
    x = torch.from_numpy(feats).to(tdt).requires_grad_(True)
    got = tfn(x, torch.from_numpy(ranks), ncells)
    got.backward(torch.from_numpy(g).to(tdt))
    assert got.dtype == x.grad.dtype == tdt and tuple(got.shape) == (ncells, 8)
    # fp32: only the summation order differs; bf16: both round the same fp32
    # sums, which may straddle a rounding boundary by 1 ULP (2^-8)
    tol = dict(rtol=1e-5, atol=1e-6) if dtype == 'float32' else dict(atol=1e-2, rtol=1e-2)
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32), **tol)
    np.testing.assert_allclose(x.grad.float().numpy(), np.asarray(want_grad, np.float32),
                               rtol=1e-4, atol=1e-5)


def _lift_inputs(f=1, r=20, p=300, c=8, ncells=100, seed=17):
    rng = np.random.RandomState(seed)
    ctx = rng.randn(f, r, c).astype(np.float32)
    dp = rng.rand(f, p).astype(np.float32)
    ranks = rng.randint(0, ncells + 1, size=(f, p)).astype(np.int32)
    rays = rng.randint(0, r, size=p).astype(np.int32)
    return ctx, dp, ranks, rays, ncells


def _jax_lift_splat(ctx, dp, ranks, rays, ncells, g):
    """lift_splat_pallas per frame in interpret mode: (out, d ctx, d dp)."""
    outs, dctx, ddp = [], [], []
    with pltpu.force_tpu_interpret_mode():
        for i in range(ctx.shape[0]):
            out, vjp = jax.vjp(lambda a, b: lift_splat_pallas(a, b, jnp.asarray(ranks[i]),
                                                              jnp.asarray(rays), ncells),
                               jnp.asarray(ctx[i]), jnp.asarray(dp[i]))
            gc, gd = vjp(jnp.asarray(g[i]))
            outs.append(np.asarray(out))
            dctx.append(np.asarray(gc))
            ddp.append(np.asarray(gd))
    return np.stack(outs), np.stack(dctx), np.stack(ddp)


@pytest.mark.parametrize('frames', [1, 3])
def test_lift_splat_plain_and_backward_match_pallas(frames):
    """K4's plain version and LiftSplat's backward (the row gather on the
    CPU, index_add_ over ray ids, row-wise dot) against lift_splat_pallas
    and its _ls_bwd, per frame in interpret mode; ``frames`` = 3 is the
    frame-batched form (one launch on CUDA)."""
    ctx, dp, ranks, rays, ncells = _lift_inputs(f=frames)
    g = np.random.RandomState(9).randn(frames, ncells, 8).astype(np.float32)
    want, want_dctx, want_ddp = _jax_lift_splat(ctx, dp, ranks, rays, ncells, g)
    c = torch.from_numpy(ctx).requires_grad_(True)
    d = torch.from_numpy(dp).requires_grad_(True)
    if frames == 1:
        got = K4.lift_splat(c[0], d[0], torch.from_numpy(ranks[0]), torch.from_numpy(rays),
                            ncells)[None]
    else:
        got = K4.lift_splat_frames(c, d, torch.from_numpy(ranks), torch.from_numpy(rays),
                                   ncells)
    got.backward(torch.from_numpy(g))
    assert tuple(got.shape) == (frames, ncells, 8) and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(c.grad.numpy(), want_dctx, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(d.grad.numpy(), want_ddp, rtol=1e-4, atol=1e-5)
    assert (ranks == ncells).any() and not d.grad.numpy()[ranks == ncells].any()


def test_lift_splat_bf16_casts_like_pallas():
    """bf16 ctx and dp: fp32 sums cast to ctx's dtype; d ctx in ctx's dtype
    and d dp in dp's (the casts of _ls_bwd)."""
    ctx, dp, ranks, rays, ncells = _lift_inputs()
    g = np.random.RandomState(9).randn(1, ncells, 8).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(lift_splat_pallas(jnp.asarray(ctx[0], jnp.bfloat16),
                                            jnp.asarray(dp[0], jnp.bfloat16),
                                            jnp.asarray(ranks[0]), jnp.asarray(rays), ncells),
                          np.float32)
    c = torch.from_numpy(ctx[0]).bfloat16().requires_grad_(True)
    d = torch.from_numpy(dp[0]).bfloat16().requires_grad_(True)
    got = K4.lift_splat(c, d, torch.from_numpy(ranks[0]), torch.from_numpy(rays), ncells)
    got.backward(torch.from_numpy(g[0]).bfloat16())
    assert got.dtype == c.grad.dtype == d.grad.dtype == torch.bfloat16
    np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=1e-2, atol=1e-2)


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


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_convnext_mlp_gradients_match_jax_vjp(dtype):
    """ConvNextMLP's backward (autograd through the plain version) against
    jax.vjp of convnext_mlp_pallas (its rematerialised _mlp_reference
    backward): the gradients of h, x and all seven parameters. Relative L2
    below 1e-3 in fp32 (the bf16-rounded matmul operands may straddle a
    rounding boundary, as in the forward test above) and 2e-2 for bf16
    rows (8-bit mantissas)."""
    jdt, tdt = _DT[dtype]
    args = _mlp_inputs(500)
    g = np.random.RandomState(11).randn(500, 16)
    jargs = [jnp.asarray(a, jdt if i < 2 else jnp.float32) for i, a in enumerate(args)]
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(convnext_mlp_pallas, *jargs)
        want = vjp(jnp.asarray(g, jdt))
    targs = [torch.tensor(a, dtype=tdt if i < 2 else torch.float32).requires_grad_(True)
             for i, a in enumerate(args)]
    K2.convnext_mlp(*targs).backward(torch.tensor(g, dtype=tdt))
    tol = 1e-3 if dtype == 'float32' else 2e-2
    for name, t, w in zip(('h', 'x', 'scale', 'bias', 'w1', 'b1', 'w2', 'b2', 'gamma'),
                          targs, want):
        assert t.grad.dtype == t.dtype, name
        got, w = t.grad.double().numpy(), np.asarray(w, np.float64)
        assert np.linalg.norm(got - w) / np.linalg.norm(w) < tol, name


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    feats, ranks, ncells = (torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                            for a in _splat_inputs())
    margs = [torch.tensor(a, dtype=torch.float32) for a in _mlp_inputs(64)]
    largs = [torch.from_numpy(a) for a in _lift_inputs(f=2)[:4]] + [100]
    counters = (K1.bev_splat_accumulate, K1.bev_pool_v1, K1.bev_pool_v2, K1.gather_rows,
                K2.convnext_mlp, K4.lift_splat_accumulate)
    before = [fn.launches for fn in counters]
    assert torch.equal(K1.bev_splat_accumulate(feats, ranks, ncells),
                       K1.bev_splat_accumulate_plain(feats, ranks, ncells))
    for entry in (K1.bev_pool_v1, K1.bev_pool_v2):
        assert torch.equal(entry(feats[0], ranks[0], ncells),
                           K1.bev_splat_plain(feats[:1], ranks[:1], ncells)[0])
    assert torch.equal(K2.convnext_mlp(*margs), K2.convnext_mlp_plain(*margs))
    assert torch.equal(K4.lift_splat_frames(*largs), K4.lift_splat_plain(*largs))
    assert [fn.launches for fn in counters] == before


def test_wrappers_refuse_bad_arguments_and_non_cpu_non_cuda_devices():
    feats, ranks, ncells = (torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                            for a in _splat_inputs())
    with pytest.raises(TypeError):
        K1.bev_splat(feats.half(), ranks, ncells)
    # float64 only on the CPU (the float64 reference step), summed in float64
    f64 = K1.bev_splat(feats.double(), ranks, ncells)
    assert f64.dtype == torch.float64
    np.testing.assert_allclose(f64.numpy(), K1.bev_splat(feats, ranks, ncells).numpy(),
                               rtol=1e-5, atol=1e-5)
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
    with pytest.raises(ValueError):
        K1.bev_pool_v1(feats, ranks, ncells)                 # (F, P, C): not one frame
    ctx, dp, lranks, rays = (torch.from_numpy(a) for a in _lift_inputs(f=2)[:4])
    with pytest.raises(TypeError):
        K4.lift_splat_frames(ctx, dp, lranks.long(), rays, 100)
    with pytest.raises(TypeError):
        K4.lift_splat_frames(ctx.half(), dp, lranks, rays, 100)
    with pytest.raises(ValueError):
        K4.lift_splat_frames(ctx, dp, lranks, rays[:-1], 100)
    with pytest.raises(RuntimeError):
        K4.lift_splat_frames(*(t.to('meta') for t in (ctx, dp, lranks, rays)), 100)


_FOREIGN = ('jax', 'jaxlib', 'flax', 'optax', 'stp3_tpu', '__graft_entry__', 'PIL')


def test_port_imports_no_jax_or_flax():
    """In a fresh interpreter (this one imported jax in conftest.py): the
    port's modules pull in nothing of jax, flax, optax, stp3_tpu or PIL
    (the card's machine has no PIL)."""
    code = (
        'import json, sys\n'
        'before = set(sys.modules)\n'
        'import stp3_tpu_torch, stp3_tpu_torch.models.stp3, stp3_tpu_torch.utils.from_flax\n'
        'import stp3_tpu_torch.ops.kernels.bev_splat, stp3_tpu_torch.ops.kernels.convnext_mlp\n'
        'import stp3_tpu_torch.training.trainer, stp3_tpu_torch.datas.synthetic\n'
        'import stp3_tpu_torch.config, chip_smoke\n'
        'import stp3_tpu_torch.deploy.agent_core, stp3_tpu_torch.ops.kernels.lift_splat\n'
        'import stp3_tpu_torch.ops.static_splat, stp3_tpu_torch.datas.carla\n'
        'new = set(sys.modules) - before\n'
        f'print(json.dumps(sorted(m for m in new if m.split(".")[0] in {_FOREIGN!r})))\n')
    out = subprocess.run([sys.executable, '-c', code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def _imports(path):
    """Every module name an ``import`` or ``from ... import`` of the file
    names, at any depth of the syntax tree."""
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_module_of_the_port_nor_chip_smoke_imports_the_jax_side():
    """Read with ast, so a lazy import inside a function counts too."""
    paths = [os.path.join(REPO, 'chip_smoke.py')]
    for root, _, files in os.walk(os.path.join(REPO, 'stp3_tpu_torch')):
        paths += [os.path.join(root, f) for f in files if f.endswith('.py')]
    assert len(paths) > 30
    bad = {os.path.relpath(p, REPO): name for p in paths for name in _imports(p)
           if name.split('.')[0] in _FOREIGN}
    assert not bad, bad
