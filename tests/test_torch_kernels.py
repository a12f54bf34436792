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
import re
import subprocess
import sys
from pathlib import Path

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


def _atomic_rows_numpy(ranks, ncells, tile):
    """Distinct ranks that land, counted tile by tile of each frame with
    np.unique, over the points that land."""
    runs = landed = 0
    for frame in ranks:
        for start in range(0, frame.shape[0], tile):
            r = frame[start:start + tile]
            r = r[(r >= 0) & (r < ncells)]
            runs += np.unique(r).size
            landed += r.size
    return runs / landed


@pytest.mark.parametrize('tile', [1024, 2048, 4096])
def test_atomic_rows_per_landed_point_counts_distinct_ranks_per_tile(tile):
    """Seeded ranks with dropped points on both sides of [0, ncells) and a
    ragged last tile (P = 2 x 4096 + 777); by default the helper counts at
    the kernel's own tile (kSplatThreads x kItems in csrc/bev_pool.cu)."""
    rng = np.random.RandomState(tile)
    ncells = 300
    ranks = rng.randint(-3, ncells + 4, size=(3, 2 * 4096 + 777)).astype(np.int32)
    got = K1.atomic_rows_per_landed_point(torch.from_numpy(ranks), ncells, tile)
    assert got == pytest.approx(_atomic_rows_numpy(ranks, ncells, tile), rel=1e-12)
    assert K1.atomic_rows_per_landed_point(torch.full((2, 10), ncells, dtype=torch.int32),
                                           ncells, tile) == 0.0
    src = (Path(K1.__file__).parents[2] / 'csrc' / 'bev_pool.cu').read_text()
    threads, items = (int(re.search(rf'constexpr int {name} = (\d+);', src).group(1))
                      for name in ('kSplatThreads', 'kItems'))
    assert threads * items == K1.TILE == 1024
    assert K1.atomic_rows_per_landed_point(torch.from_numpy(ranks), ncells) == pytest.approx(
        _atomic_rows_numpy(ranks, ncells, K1.TILE), rel=1e-12)


def test_atomic_rows_per_landed_point_on_the_flagship_rig():
    """The flagship rig's pre-warped serving ranks (F=3, 483,840 points,
    40,000 cells): a tile of 2,048 points holds ~0.068 distinct ranks per
    landed point (the figure K1's design rests on), ~0.91 runs of equal
    consecutive ranks."""
    import torch_fixtures
    ranks, ncells = torch_fixtures.splat_ranks(torch_fixtures.flagship_cfg(), 'cpu')
    assert tuple(ranks.shape) == (3, 483840) and ncells == 40000
    assert abs(K1.atomic_rows_per_landed_point(ranks, ncells, 2048) - 0.068) <= 0.005
    lands = ranks < ncells
    heads = torch.ones_like(lands)
    heads[:, 1:] = ranks[:, 1:] != ranks[:, :-1]
    assert abs((heads & lands).sum().item() / lands.sum().item() - 0.909) <= 0.005


def test_lift_splat_fold_rate_on_the_flagship_rig(monkeypatch):
    """K4's premise: at the flagship rig, project_lift_splat_fused hands K4
    the pre-warped ranks in the order project_to_birds_eye_view hands them
    to K1, with lift_ray_ids for the rays, so a tile of K4.TILE = 1,024
    consecutive points (kThreads x kItems in csrc/lift_splat.cu) holds at
    most 0.1 distinct ranks per landed point (0.093): one run, one vector
    atomic per 4 channels, per ~11 landed points."""
    import torch_fixtures
    from stp3_tpu_torch.ops import bev_pool
    geometry, ego, (res, start, dim) = torch_fixtures.rig_geometry(
        torch_fixtures.flagship_cfg(), 'cpu')
    b, s, n, d, hf, wf, _ = geometry.shape
    seen = {}

    def k4(ctx, dp, ranks, rays, ncells):
        seen['K4'] = ranks, rays, tuple(dp.shape), ncells
        return ctx.new_zeros(ranks.shape[0], ncells, ctx.shape[-1])

    def k1(feats, ranks, ncells):
        seen['K1'] = ranks, tuple(feats.shape[:2])
        return feats.new_zeros(ranks.shape[0], ncells, feats.shape[-1])

    monkeypatch.setattr(bev_pool, 'lift_splat_frames', k4)
    monkeypatch.setattr(bev_pool, 'bev_splat', k1)
    # one channel: the ranks and the point order do not depend on C
    bev_pool.project_lift_splat_fused(torch.zeros(b, s, n, hf, wf, 1),
                                      torch.zeros(b, s, n, hf, wf, d), geometry, ego, res,
                                      start, dim)
    bev_pool.project_to_birds_eye_view(torch.zeros(b, s, n, d, hf, wf, 1), geometry, ego, res,
                                       start, dim)
    ranks, rays, dp_shape, ncells = seen['K4']
    assert tuple(ranks.shape) == dp_shape == seen['K1'][1] == (3, 483840) and ncells == 40000
    assert torch.equal(ranks, seen['K1'][0])
    assert torch.equal(rays, bev_pool.lift_ray_ids(n, d, hf, wf))
    src = (Path(K4.__file__).parents[2] / 'csrc' / 'lift_splat.cu').read_text()
    threads, items = (int(re.search(rf'constexpr int {name} = (\d+);', src).group(1))
                      for name in ('kThreads', 'kItems'))
    assert threads * items == K4.TILE == 1024
    rate = K1.atomic_rows_per_landed_point(ranks, ncells, K4.TILE)
    assert rate <= 0.1 and abs(rate - 0.093) <= 0.005


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


def test_nvcc_build_rebuilds_on_an_edited_header_and_keeps_the_log(tmp_path, monkeypatch):
    """load_library keys a build on the sources and the csrc/ headers (K1
    and K4 include tile_runs.cuh), and a reused build reports nvcc's ptxas
    log too. A stand-in nvcc copies a shared library that exists and prints
    one ptxas line."""
    from stp3_tpu_torch.ops.kernels import nvcc_build as NB
    csrc = tmp_path / 'csrc'
    csrc.mkdir()
    (csrc / 'k.cu').write_text('#include "h.cuh"\n')
    (csrc / 'h.cuh').write_text('// one\n')
    real = Path(torch.__file__).parent / 'lib' / 'libtorch_global_deps.so'
    nvcc = tmp_path / 'nvcc'
    nvcc.write_text(f'#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\ncp {real} "$2"\n'
                    f'echo "ptxas info    : Used 8 registers, 16 bytes smem"\n')
    nvcc.chmod(0o755)
    monkeypatch.setattr(NB, 'CSRC', csrc)
    monkeypatch.setattr(NB, 'BUILD_DIR', tmp_path / 'build')
    monkeypatch.setattr(NB, '_nvcc', lambda: str(nvcc))
    infos = []
    for header in ('// one\n', '// one\n', '// two\n'):
        (csrc / 'h.cuh').write_text(header)
        monkeypatch.setattr(NB, '_LOADED', {})
        infos.append(NB.load_library('k', ['k.cu'])[1])
    assert [i['built'] for i in infos] == [True, False, True]
    assert infos[0]['path'] == infos[1]['path'] != infos[2]['path']
    assert all('Used 8 registers' in i['log'] for i in infos)


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


_FOREIGN = ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'stp3_tpu', '__graft_entry__', 'PIL',
            'cv2')


def test_port_imports_no_jax_or_flax():
    """In a fresh interpreter (this one imported jax in conftest.py): the
    port's modules, the weight-interchange CLIs and the CARLA agent among
    them, and the datasets with their image I/O, the PIL-free stand-in
    data of tests/torch_fake_datasets.py and the configurations of
    tests/torch_fixtures.py, the data-parallel and
    camera-parallel modules and their test ranks
    (tests/torch_dist_worker.py), the visualisation, profiling and Kalman
    utilities, the stage stamp and the benchmark's span readers and the
    dress rehearsal, pull in nothing of jax, flax,
    optax, orbax, stp3_tpu, PIL or cv2 (the card's machine has neither PIL
    nor cv2), nor PyYAML at import time (nor has it PyYAML: only
    ``CfgNode.merge_from_file`` imports it)."""
    code = (
        'import json, sys\n'
        'before = set(sys.modules)\n'
        'import stp3_tpu_torch, stp3_tpu_torch.models.stp3, stp3_tpu_torch.utils.from_flax\n'
        'import stp3_tpu_torch.ops.kernels.bev_splat, stp3_tpu_torch.ops.kernels.convnext_mlp\n'
        'import stp3_tpu_torch.training.trainer, stp3_tpu_torch.datas.synthetic\n'
        'import stp3_tpu_torch.config, chip_smoke, torch_fixtures\n'
        'import stp3_tpu_torch.deploy.agent_core, stp3_tpu_torch.ops.kernels.lift_splat\n'
        'import stp3_tpu_torch.ops.static_splat, stp3_tpu_torch.datas.carla_data\n'
        'import stp3_tpu_torch.datas.nuscenes_data, stp3_tpu_torch.utils.image_io\n'
        'import stp3_tpu_torch.utils.resample\n'
        'sys.path.insert(0, "tests")\n'
        'import torch_fake_datasets\n'
        'import stp3_tpu_torch.metrics, stp3_tpu_torch.utils.instance_jit\n'
        'import stp3_tpu_torch.training.checkpoint, stp3_tpu_torch.datas.dataloaders\n'
        'import stp3_tpu_torch.train, stp3_tpu_torch.evaluate\n'
        'import stp3_tpu_torch.utils.torch_import, stp3_tpu_torch.carla_agent\n'
        'import stp3_tpu_torch.scripts.import_torch_checkpoint\n'
        'import stp3_tpu_torch.scripts.export_torch_checkpoint\n'
        'import stp3_tpu_torch.scripts.import_backbone\n'
        'import stp3_tpu_torch.parallel.mesh, stp3_tpu_torch.parallel.serving\n'
        'import stp3_tpu_torch.parallel.launch, torch_dist_worker\n'
        'import stp3_tpu_torch.utils.visualisation, stp3_tpu_torch.utils.profiling\n'
        'import stp3_tpu_torch.utils.kalman, stp3_tpu_torch.scripts.dress_rehearsal\n'
        'import stp3_tpu_torch.ops.kernels.stage_stamp, cardbench.metrics._spans\n'
        'new = set(sys.modules) - before\n'
        f'print(json.dumps(sorted(m for m in new if m.split(".")[0] in {_FOREIGN + ("yaml",)!r})))\n')
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
    """Read with ast, so a lazy import inside a function counts too; the
    configurations and stand-in data that chip_smoke.py imports
    (tests/torch_fixtures.py, tests/torch_fake_datasets.py) and the test
    ranks of the multi-process tests (tests/torch_dist_worker.py) are held
    to the same ban."""
    paths = [os.path.join(REPO, 'chip_smoke.py'),
             os.path.join(REPO, 'tests', 'torch_fixtures.py'),
             os.path.join(REPO, 'tests', 'torch_fake_datasets.py'),
             os.path.join(REPO, 'tests', 'torch_dist_worker.py')]
    for root, _, files in os.walk(os.path.join(REPO, 'stp3_tpu_torch')):
        paths += [os.path.join(root, f) for f in files if f.endswith('.py')]
    assert len(paths) > 30
    bad = {os.path.relpath(p, REPO): name for p in paths for name in _imports(p)
           if name.split('.')[0] in _FOREIGN}
    assert not bad, bad


# ------------------------------------------------ out-of-range ranks
def _out_of_range_case(dtype=torch.float32):
    """F=2, ncells=3, C=4: frame 0 holds four points in range and three
    out of range (ranks -1, 3 and 5); frame 1 holds two in range. The
    expected sums count the in-range points only."""
    gen = torch.Generator().manual_seed(11)
    ranks = torch.tensor([[0, -1, 2, 3, 5, 2, 1], [1, 3, 3, 0, 3, 3, 2]], dtype=torch.int32)
    feats = torch.randn(2, 7, 4, generator=gen).to(dtype)
    want = torch.zeros(2, 3, 4, dtype=torch.float64)
    for f in range(2):
        for p in range(7):
            if 0 <= ranks[f, p] < 3:
                want[f, ranks[f, p]] += feats[f, p].double()
    return feats, ranks, want


def test_plain_splats_drop_out_of_range_ranks():
    """A rank outside [0, ncells) adds nothing anywhere, as the kernels and
    JAX's segment_sum drop it: K1 and its plain version. Frame 1 equals its
    own points' sums (nothing of frame 0 spills into it)."""
    feats, ranks, want = _out_of_range_case()
    for got in (K1.bev_splat_accumulate(feats, ranks, 3), K1.bev_splat_plain(feats, ranks, 3)):
        torch.testing.assert_close(got.double(), want, rtol=1e-6, atol=1e-6)
    # the per-frame entries (F=1) on frame 0 alone
    for entry in (K1.bev_pool_v1, K1.bev_pool_v2):
        torch.testing.assert_close(entry(feats[0], ranks[0], 3).double(), want[0],
                                   rtol=1e-6, atol=1e-6)


def test_plain_lift_splat_drops_out_of_range_ranks_and_ray_ids():
    """K4's plain version: a point whose rank is outside [0, ncells) or
    whose ray id is outside [0, R) is dropped (ray ids -1 and R here)."""
    gen = torch.Generator().manual_seed(12)
    f, r, c, ncells = 2, 4, 5, 3
    ctx = torch.randn(f, r, c, generator=gen)
    ranks = torch.tensor([[0, -1, 2, 3, 5, 2, 1, 1], [1, 3, 3, 0, 3, 2, 2, 0]], dtype=torch.int32)
    rays = torch.tensor([0, 1, 3, 2, 1, -1, 4, 2], dtype=torch.int32)
    dp = torch.rand(f, 8, generator=gen)
    want = torch.zeros(f, ncells, c, dtype=torch.float64)
    for fi in range(f):
        for p in range(8):
            if 0 <= ranks[fi, p] < ncells and 0 <= rays[p] < r:
                want[fi, ranks[fi, p]] += dp[fi, p].double() * ctx[fi, rays[p]].double()
    got = K4.lift_splat_accumulate(ctx, dp, ranks, rays, ncells)
    torch.testing.assert_close(got.double(), want, rtol=1e-6, atol=1e-6)
